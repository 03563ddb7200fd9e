"""Drive the PyTorch/CUDA port on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure propagates and the exit code is not 0):

1. Device: the card's name, and its name and power limit from nvidia-smi.
2. Kernels: build every CUDA kernel of the serving paths from
   ``langstream_tpu_torch/csrc`` (one nvcc per source, started together;
   every kernel's registers and spills from ``ptxas -v`` and its
   tensor-core instructions from ``cuobjdump -sass`` are printed, and the
   bf16-q bodies, the prefill ``wgmma`` body and the decode and paged
   ``mma.sync`` ones, must use HGMMA or HMMA and spill nothing),
   hold each against its plain PyTorch version at the paths' shapes
   (q bf16), and time kernel, plain version, the PyTorch library call
   (``scaled_dot_product_attention``, a yardstick only; over a dequantized
   bf16 view for the int8 kernels, SDPA takes no int8) and the least time
   the card could take (bound). Times are device times: the timed calls
   are enqueued while a sleep kernel holds the card, so the host's share
   is left out; each kernel's wall time per call with the host in the
   loop is printed beside it. B1 flash prefill and B2 flash decode carry
   the dense path (B1 and B4 also at the top prompt bucket, B 1 × T 1024,
   where the work is bound by operations: the kernels line's ``long_*``
   fields; B2 and B5 also at the same lengths over a T 4096 cache, a
   printed time beside the T 1024 one); B3 ragged paged attention the
   paged path, at a decode, a prefill-at-offset and a speculative verify
   shape (32 rows × Tq 5, launched as a verify block and counted by the
   card in its own class; all in the kernels line: the decode shape's
   fields, and ``prefill_*`` and ``verify_*`` fields and launches by
   shape beside them); B4, B5 and B6 are their int8-KV twins,
   at the same shapes over ``quantize_kv`` of the same activations. B7
   (and B8 over int8 pools), the token-ragged kernel of the mixed step,
   at its shape (32 rows of a 64-wide span: decode rows, two windows,
   idle rows), also with packed non-uniform ``q_offsets``; its rows must
   equal B3's (B6's) bit for bit and its dead tiles be exactly zero.
3. Reference: the model at Llama-3-8B width, depth cut to 2 layers, on the
   card (kernels) against the same weights on the CPU (plain path), for
   the dense layout and the paged one (cold prefill, prefill-at-offset
   onto another row's blocks, decode), with the bf16 cache and with the
   int8 one. On the card the paged logits are also held against the
   dense ones, the windowed prefill of a long prompt (both layouts)
   against a one-shot prefill, and the int8 logits against the bf16 ones.
   Then one mixed step (``paged_mixed_step``, both caches) on the card
   against the CPU and against the split calls on the card, and the
   model with int8 weights (dense, paged and mixed calls) on the card
   against the CPU. Then, per layout and cache type, one admission round
   of the engine (cold group, warm batch on the paged layout, a prompt in
   windows) replayed from prefill graphs against the same round run
   eagerly (``step_graphs=False``): bit for bit equal logits, equal first
   tokens. Then the MLP of a large prefill call in row slices
   (``model.MLP_ROWS``): the graph pool of the prefill lattice captured
   with the MLP in one pass and in slices, and one 32 × 1024 call sliced,
   replayed, equal bit for bit to its eager run and within the model
   tolerance of the one-pass MLP. Then, per layout and cache type, at 2
   layers: a session follow-up warm at an offset (paged: after a
   copy-on-write of its boundary block) and a prompt admitted onto
   another request's prefix (dense: a cross-slot copy; paged: a
   prefix-cache hit), their last-token logits against a cold prefill of
   the same prompt; a verify block of 1 + 4 tokens against five decode
   steps; top-K logprobs (K 5) on each engine path (dense, paged, mixed,
   the verify block dense and paged): an engine on the card against its
   twin on the CPU, three greedy requests, ids and logprobs compared
   while the streams agree (an id that differs must be a near-tie). And
   the graph pool of the 2-layer 32 × 1024 lattice without
   and with this slice's variants (dense prefill at an offset at every
   group, the prefix copies), and of a spec engine.
4. Dense serving: Llama-3-8B (bf16, random weights from seed 0) behind
   the port's OpenAI server, started as ``python -m langstream_tpu_torch
   serve --precompile`` starts it (pipelined decode, its default): every
   decode chunk, mixed step and prefill variant (the model call by kind,
   bucket and group; the first-token sampling by group and tier) is
   captured as a CUDA graph before traffic (the seconds and variants of
   each, and the graph pool, are printed), and every serving phase
   replays them, capturing nothing (checked per burst: every prefill
   model call is a replay; the graphs replayed by kind and captured are
   printed, and the prefill harvests that found their record ready, that
   waited, and that left it in flight). It answers 16 concurrent chat
   and text completions plus one SSE stream. Each kernel counts its own
   launches on the card, a replayed graph's included
   (``ops/launches.py``), and each wrapper the launches the host enqueued
   eagerly (none but in the eager control); both are zeroed just before
   the burst and read just after. B1 and B2 must have run once per layer
   per model call, the model calls counted by the engine at dispatch. Then 32 completions of 64
   tokens each, where decode chunks must have been chained (counted
   through a wrapper on the engine's ``_dispatch_decode``), and one bare
   decode step of that model, eager and as a CUDA graph: wall and host
   enqueue time of each, and the device time (again in phase 6, over the
   int8 cache). Then the in-turns controls, at 2 layers
   (``CONTROL_LAYERS``; 8 until phase 12 came), between two twins of the
   main path at that depth: the engine's ``join_prefills`` off (the JAX
   engine's harvest: join, JAX, ..., join), the engine built with
   ``step_graphs=False`` (the eager control: graphed, eager, ...,
   graphed; its host-enqueued launches must equal the card's), and
   ``--no-pipeline-decode`` (no chained chunk: pipelined, unpipelined,
   pipelined). Then ``--quantization int8`` at full depth (int8 weights
   drawn on the card; B1 and B2 as before), with a line holding the bf16
   and int8 bare steps side by side. The int8-weight controls (the JAX
   harvest, ``--admission-chunk 2`` and their int8 twin) were cut for
   the smoke's time when phase 14 came.
   Every server runs the engine supervisor and the decode-stall watchdog
   at ``serve``'s defaults (on). After the first dense phase's bursts,
   on its server, the crash phase (:func:`serve_crash_and_check`): the
   dense burst's 16 completions (every fourth seeded with presence and
   frequency penalties, four streamed) once uncrashed, then with
   ``engine_thread_crash@step=2`` armed and one request posted while the
   supervisor rebuilds; gated: one restart, every request 200 but that
   one (503 with Retry-After), each stream's deltas the tokens pushed to
   it once each, every live session resurrected, crash-replay tokens,
   B1 and B2 launched after the rebuilt engine's precompile by their
   card counters, no capture after it, the memory after within 0.5 GiB
   of that at the crash and the peak at most the served peak plus the
   dead engine's KV cache; printed: recovery seconds, memory, streams
   equal to the uncrashed run's.
5. Paged serving (at ``CUT_LAYERS``, 8, since phase 15 came): the same
   model with ``--kv-layout paged``, answering 16
   chats that share a ~512-byte system message, 8 text completions and
   one SSE stream, all arriving cold. The prefix cache must have served
   tokens, B3 must have been launched once per layer per model call, and
   no other kernel at all; B3's own card counter of its launches with
   more than one q token per slot (``ops/launches.py``'s ``SHAPES``) must
   read once per layer per prefill call, and the rest once per layer per
   decode step (the kernels line's ``prefill_launches`` and
   ``decode_launches``). Then the same burst with ``--prefill-mode
   mixed`` on a new server after one uncounted chat with that system
   message (its split twin was cut when phase 14 came):
   no prefill model call, B7 once per layer per mixed step, B3 once
   per layer per plain decode step, mixed steps chained (the carry's
   invalidations printed by reason); and one bare paged decode step and
   one mixed step of that model, eager and graphed, with their device
   time.
6. int8 serving (at ``CUT_LAYERS`` since phase 15 came): phases 4 and 5
   again, same traffic, with
   ``kv-quant: int8`` in the provider's engine config (``serve`` has no
   flag for it). Dense: B4 and B5 once per layer per model call; paged:
   B6 once per layer per model call; mixed: B8 per mixed step and B6 per
   decode step; no other kernel launched.
7. Sessions (at ``CUT_LAYERS``, 8, since phase 15 came; full depth
   before): 16 users × 3 chat turns sent with the OpenAI ``user`` field
   (a ~300-byte system message; turn n + 1 resends turn n's messages
   with the reply and a new message), then 8 sessionless chats sharing a
   ~530-byte system message, dense bf16, paged bf16 and paged int8 KV:
   tok/s, mean TTFT by turn, session and prefix hits, reused tokens,
   copy-on-write copies and copy replays. Gates: every request
   answered, no capture, each kernel once per layer per model call;
   dense 32 session hits (no eviction) and prefix hits; paged
   copy-on-write copies.
8. Speculative decoding (at ``CUT_LAYERS`` since phase 15 came):
   ``engine.spec-decode: ngram``, ``spec-k`` 4, 16
   greedy completions of 128 tokens on repeating prompts, dense and
   paged, and paged over the int8 cache (the spec-off twins were cut for
   the smoke's time when phase 14 came:
   speculation's gain is not measurable on random weights). Gates: drafts made and
   accepted; dense: no decode-kernel launch (verify attends in plain
   PyTorch); paged: B3 (B6) once per layer per model call, its verify
   launches by the card's own counter once per layer per verify step.
9. Checkpoint: the random weights of phase 4 (``init_params`` of
   Llama-3-8B, seed 0, drawn on the card) written as a HF Llama directory
   (``config.json``, safetensors shards and their index) under ``build/``
   by this script's own writer (so the script needs no ``safetensors``
   package), after checking the disk holds it; read back with
   ``weights.load_safetensors_checkpoint``: every leaf equal bit for bit,
   ``quantize_params`` equal; the write and load seconds and the loading
   peak printed. Then ``serve --checkpoint DIR --logprobs-top-k 5
   --precompile`` answers phase 4's dense burst with half the chats
   asking ``top_logprobs: 5`` and a text completion the legacy
   ``logprobs: 3``: every request answered, B1 and B2 once per layer per
   model call, every alternatives list sorted and at most 0 with the
   greedy token first and its own logprob; tok/s, TTFT, load seconds and
   peak beside phase 4's, and the streams equal to phase 4's (printed,
   not gated). The directory is removed at the end.

10. Recovery at ``RECOVERY_LAYERS``: the watchdog's escalation
   (:func:`serve_watchdog_and_check`: ``stuck_step`` wedges a decode
   dispatch for 14 s under thresholds cut short in the provider config;
   gated: the trips reach ``escalate-trips``, one restart, every session
   resurrected and answered, the condemned engine silent and its thread
   ended) and load shedding (:func:`serve_shedding_and_check`: 96
   completions on 32 slots at ``--queue-timeout-s 0.25``; gated: some
   shed, each 503 with Retry-After, the rest 200, ``/metrics``'
   ``requests_shed_total`` equal to the 503s).

11. Embeddings and vector search (no kernel of their own: the encoder is
   plain PyTorch in f32, the search one matrix-vector product and a
   top-k). MiniLM-L6 at full width (``EncoderConfig.minilm_l6``, random
   weights drawn on the card, seed 0) on the card against the CPU, within
   1e-4 on unit vectors, no NaN, padding rows zero, TF32 off; device and
   wall ms per call at (rows, bucket) (1, 16), (8, 256), (64, 256) beside
   the f32 bound. Those weights written as a HF BERT directory under
   ``build/`` and loaded back onto the card with ``weights.load_hf_bert``
   bit for bit. Then ``serve --precompile`` at ``RECOVERY_LAYERS`` with a
   ``TorchEmbeddingsService`` (``preset: minilm-l6``, byte tokenizer):
   16 chats fired with 512 texts in requests of 1-64 inputs (every
   request 200, 16 sampled vectors within 1e-4 of the CPU's, no capture),
   the one-text call's HTTP and embedder wall against its device time;
   then embeddings called while a fresh engine's ``precompile`` captures
   (answered, equal to the CPU's; every variant captured). Then the
   vector store at 262,144 x 384 f32 through ``upsert``: 256 cosine
   top-10 queries against the host's numpy ranking (near-tie swaps
   within 1e-5 allowed and counted), after 1,000 deletes and re-upserts
   again, and l2 on 65,536 rows; upsert seconds, the first search's
   upload, ms per search against the bound (the matrix read once).

12. Disaggregation and the host tier (no kernel of their own: B3, or B6
   over int8 pools, serves the imported and promoted chains). Llama-3-8B
   at full width with int8 weights drawn once on the card and shared by
   every engine of the phase, paged, buckets 128-2048, ``max_seq_len``
   4096, eager dispatch, pipelined. The handoff over bf16 and then int8
   pools (:func:`check_handoff`): a prefill engine A and a decode engine
   B (``kv_blocks`` 1025 each); two prompts, 2048 tokens greedy and 1500
   seeded (two more cut for the smoke's time when phase 18 came); A answers each whole (the oracle), then exports a
   2-token leg, which crosses ``fleet.handoff.handoff_records`` (256 KiB
   budget) and the ``HandoffAssembler`` to B's ``kv_import`` replay.
   Gates: B's stream A's (a first divergence only at a near-tie, within
   5e-2 nats: the replay prefills the row that A wrote in a decode step),
   B's imported rows the payload bit for bit, B's prefix hits every full
   block, B3 (B6) once per layer per model call by its card counter, no
   abort, the ``engines_snapshot`` deltas; a record set missing its last
   chunk and a ``block_size`` 99 payload replay cold with A's stream.
   Printed beside a plain pinned ``copy_``: export and import ms and
   GB/s, the host's wait before the export, records and encode /
   assemble s, the decode leg's TTFT with the import and cold. Then the
   host tier over int8 and then bf16 pools (:func:`check_host_tier`):
   ``kv_blocks`` 600, ``kv_host_blocks`` 1024 against a never-evicting
   oracle; a 2048-token prompt, six 2048-token strangers (one new token
   each; the oracle, which they cannot change, skips them), the prompt
   and 128 tokens more, greedy then seeded. Gates: streams equal, the
   promoted rows the oracle's bit for bit, demotions and promotions, no
   abort; with ``host_promote_torn@step=1`` the streams still the
   oracle's and an abort counted. Printed: pinned host bytes, the
   demotion's host ms per block, promotion ms and GB/s, prompt 2's TTFT
   promoted, cold and as an HBM hit.

13. Training (no kernel of its own: the differentiable forward keeps the
   plain attention, as the JAX package's does; serving the trained
   checkpoint runs B1 and B2). ``llama3_1b`` (Llama-3.2-1B's shape) at 2
   layers and full width, one loss and its gradients in bf16 on the card
   against the port in f32 on the CPU from the same weights (B 2 × T
   128): the loss within 1e-2 relative, each leaf's gradient at cosine
   0.99 or more. Then at full depth, B 4 × T 1024 with one row padded to
   half, ``Trainer`` with AdamW at lr 1e-3 and remat, 6 steps on one
   batch: every loss finite, the sixth below the first; printed: the
   losses, each step's ms and the median, tokens/s, the peak, the step's
   model FLOPs (and with the recompute) against 989 TFLOP/s; one step
   without remat beside it. ``save_checkpoint`` after step 3 into
   ``build/train-checkpoint`` with step 4 run at once: the ms until
   ``save`` returns and until the write is committed, and GB/s; the
   kernels of one remat step by device time (``torch.profiler``). A fresh
   ``Trainer`` (seed 1) restores step 3: every parameter and Adam moment
   bit for bit the step-3 state, its next loss within 1e-3 of step 4's.
   ``TorchCompletionsService`` over the directory (dense, pipelined,
   graphs): its params bit for bit the trainer's, four greedy text
   completions, one at a time, equal to an engine built over the
   trainer's step-3 tensors, and B1 and B2 launched by their card
   counters, zeroed before the service and read after it. The directory
   is removed at the end; the phase's wall time is printed.

14. Mixtral (mixture of experts; no kernel of its own: ``ops/moe.py`` is
   matrix products and a top-k, and the model's attention runs B1 and B2,
   or B3 paged). ``mixtral_8x7b`` at full width (8 experts of 4096 ×
   14336, top 2) and 2 layers, bf16, random from seed 0: two prompts (64
   and 41 tokens) and 8 decode steps on the card, dense and paged, each
   against one run of the port on the CPU in bf16 from the same weights.
   The paged run and the CPU's route each token to the experts the
   card's dense run chose (bf16 rounding flips a choice at a near-tie);
   every token that would have gone elsewhere must be a near-tie (the
   dense run's k-th and (k+1)-th router logits within
   ``ROUTER_NEAR_TIE``, the router logits within it of the dense run's;
   the flips are counted and printed). Then all 18 rows of each layout
   within 5e-2 of max |logit|; B1 and B2 (B3)
   once per layer per call by their card counters. That model written as
   a HF Mixtral directory by this script's writer and loaded back bit for
   bit (removed after). Then ``serve --model mixtral-8x7b --precompile``
   at ``MOE_SERVE_LAYERS`` (8 of 32; 16 until phase 15 came) layers
   answers phase 4's two
   bursts, gated as phase 4 is (every request answered, no capture, B1
   and B2 once per layer per model call, MFU, MBU and prefill MFU in (0,
   1.05]); tok/s, TTFT, precompile s, the graph pool, the peak, and the
   bare decode step's device ms and MBU printed.

15. Tensor parallelism (no kernel of its own: each rank launches B1, B2,
   B3 and their int8 twins on its own heads). Two tp ranks, each a
   process, share the card: they talk over gloo, which stages a card's
   tensors through the host (NCCL refuses two ranks on one device), so
   the step functions run eagerly; this process is rank 0 where one
   serves. First Llama-3-8B at full width and 2 layers (16 heads over 4
   of 128 a rank; both ranks started by ``parallel.launch`` with
   :func:`tp_model_rank`): a dense prefill and 2 decode steps, a paged
   prefill, a prefill at an offset, 2 decode steps and a mixed step,
   bf16 and int8 KV; both ranks' logits equal bit for bit and within
   5e-2 of the same calls at tp=1 on the card and on the CPU; each rank's
   card counters B1/B2 (B4/B5), B3 (B6) or B7 (B8) once per layer per
   call. Then what ``serve --tp`` takes on one host, at 2 layers, each
   against a one-card twin (:func:`serve_tp_features_and_check`): the
   mixed step with the host tier, a KV handoff each way and a crash the
   supervisor heals; spec decode over the paged verify; each rank's card
   counters B7 once per layer per mixed step and B3 at the verify shape.
   Then ``mesh: {tp: 2}`` Llama-3-8B at ``CUT_LAYERS`` layers (full depth
   until the features part came), random from seed 0, served through the
   provider and the OpenAI server (``cli.main.start_tp_server``,
   eager, pipelined, no precompile; 9 slots, one 256 bucket): the
   dense phase's first 8 greedy prompts and its SSE chat at once. Gates:
   every request answered; each stream equal to a one-card engine's over
   the same weights and prompts but for a near-tie (``same_stream``);
   the follower replayed every record published, its token digest the
   leader's; each rank's card counters B1 and B2 once per layer per
   model call. Printed: each rank's peak GiB, the backend, the step
   functions, tok/s and the bare eager step's wall, which measure two
   ranks time-sharing one card over host-staged gloo, not a tp speed.
   The ranks' output goes to ``build/tp/``.
16. Training on the mesh (no kernel of its own: the trainer
   differentiates the plain attention, as JAX's does; the ring's chunk is
   two einsums, Ulysses runs the plain attention on its heads). Two ranks
   share the card over gloo, started once by ``parallel.launch``
   (:func:`mesh_train_rank`): ``llama3_1b`` at full width and
   ``MESH_LAYERS`` layers, B 4 × T 256, ``MESH_STEPS`` AdamW steps at
   dp2, fsdp2, tp2 and pp2, then Mixtral-8x7B at full width and ``MESH_MOE_LAYERS``
   layer at ep2; ring and Ulysses attention at sp=2 on Llama-3-8B's
   attention shape; a checkpoint written at fsdp2 and restored at pp2.
   Gates and prints: :func:`check_mesh_training`. The ranks' output goes
   to ``build/mesh/``.

17. The LangStream app (no kernel of its own: B1 and B2 through the
   app's engine): ``python -m langstream_tpu_torch apps run`` on the
   shipped ``torch-completions`` app as a subprocess (Llama-3-8B at full
   width, ``APP_LAYERS`` of 32 layers, random bf16 weights, 4 slots ×
   512, decode chunk 8, ``precompile``), eight chat clients on the port's
   own WebSocket client asking two questions each under their own
   session. Gates and prints: :func:`serve_app_and_check`. The app's log
   goes to ``build/app/``.
18. The RAG app (no kernel of its own: B3 through the app's paged
   engine; the encoder and the vector search are plain PyTorch, as the
   JAX package's are plain ``jnp``): ``apps run`` on the shipped
   ``torch-rag`` app as a subprocess with ``--http-port`` (Llama-3-8B at
   full width, ``APP_LAYERS`` of 32 layers, random bf16 weights, paged
   KV in blocks of 16, 4 slots × 4096, prefill buckets up to 1024,
   decode chunk 8, ``precompile``; the ``minilm-l6`` encoder with random
   weights, byte tokenizer, max length 256; chunks of at most 400
   characters): ``RAG_DOCS`` seeded documents of 2–6 KB through the
   ``ingest`` gateway, then eight clients on the port's WebSocket client
   asking two questions each through ``ask`` and reading ``answers``
   under their own session. Gates and prints: :func:`serve_rag_and_check`.
   The app's log goes to ``build/app-rag/``.

Each phase's wall time is printed in one line before the kernels'.

The accounting plane rides the phases above, with no server of its own.
The flight recorder is on for the whole run (``build/flight``, as
``serve`` turns it on), and every burst's requests carry their own trace
ids. After each dense and paged burst, ``/metrics``' ``torch_engine_mfu``,
``torch_engine_mbu`` and ``torch_engine_prefill_mfu`` (the engine's cost
model over its busy decode and prefill time, against the H100's peaks;
a mixed burst makes no prefill call) are printed beside tok/s and TTFT,
each gated in (0, 1.05]; every dense burst raises the TTFT and request
histograms' ``_count`` by exactly its requests and TPOT's by those of
more than one token. Each bare step (the decode step of phases 4 and 6,
the paged decode and mixed steps of phase 5) prints the cost model's
bytes and FLOPs over its graph's device ms: its roofline share. In phase
4 at full depth the mixed-length burst's journeys must all be in the
flight artifact, each tiling its request, and render through
``python -m langstream_tpu_torch journey``. The shedding phase (10, run
before the watchdog's since this slice) runs with the SLO
``{ttft-ms-p95: 1, tpot-ms-p95: 1}``: ``torch_engine_slo_ttft_burn_rate_5m``
above 1 and blame booked, ``queue`` among its stages; its server,
started with ``--profile-kernels`` (the process's first profiler, which
leaves CUPTI attached to every later launch, so after every timed
serving phase), then answers an uncounted dense burst of 32 × 192 tokens
with one ``/debug/profile?seconds=1`` capture whose ``trace.json`` must
hold B1 or B2 kernel events (their shares of the window's kernel time
printed). In phase 12 the
handoff's decode legs' journeys start with ``handoff_transit`` and
``handoff_import`` (class ``handoff-import``), its prefill legs' end in
``handoff_export``, and the host tier's prompt 2 is admitted as
``host-promote``.

The line before the last holds the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import glob
import http.server
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

STARTED = time.perf_counter()  # the script's wall time is printed at its end

from langstream_tpu_torch.cli.main import build_parser, serve_config, start_flight, start_server
from langstream_tpu_torch.cli.main import main as cli_main
from langstream_tpu_torch.ops import _build
from langstream_tpu_torch.ops import launches as launches_lib
from langstream_tpu_torch.ops import moe as moe_lib
from langstream_tpu_torch.ops.attention import (
    chunk_attention_quant,
    decode_attention,
    decode_attention_quant,
    gather_blocks,
    paged_chunk_attention,
    paged_chunk_attention_quant,
    paged_decode_attention,
    paged_decode_attention_quant,
    paged_ragged_q_attention,
    paged_ragged_q_attention_quant,
    prefill_attention,
    quantize_kv,
)
from langstream_tpu_torch.ops.decode_kernel import (
    flash_decode_attention,
    flash_decode_attention_quant,
)
from langstream_tpu_torch.ops.flash_attention import (
    flash_prefill_attention,
    flash_prefill_attention_quant,
)
from langstream_tpu_torch.ops.paged_attention import (
    block_bounds,
    ragged_paged_attention,
    ragged_paged_attention_quant,
    ragged_q_paged_attention,
    ragged_q_paged_attention_quant,
)
from langstream_tpu_torch.providers.torch_local import engine as engine_lib
from langstream_tpu_torch.providers.torch_local import model
from langstream_tpu_torch.runtime import accounting, flight
from langstream_tpu_torch.runtime import journey as journey_lib
from langstream_tpu_torch.providers.torch_local.engine import long_prefill_windows
from langstream_tpu_torch.providers.torch_local.graphs import capture
from langstream_tpu_torch.providers.torch_local.weights import write_safetensors
from langstream_tpu_torch.providers.torch_local.quant import (
    QUANTIZED_PARAMS,
    QTensor,
    quantize_params,
)

# H100 SXM published peaks (dense bf16 tensor cores, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 inputs: p is rounded to bf16 before p·v (B1-B3) and the sums run
# in another order than the plain einsum; relative to max |reference|
KERNEL_TOLERANCE = 2e-2
# the 2-layer model on the card (bf16, kernels) vs the CPU (bf16, plain
# path): cuBLAS and the CPU's GEMMs round bf16 activations differently
MODEL_TOLERANCE = 5e-2
# int8 vs bf16 KV cache logits, relative to max |bf16 logit|: the bound
# of the JAX package's tests/test_kv_quant.py
INT8_TOLERANCE = 5e-2
# bytes of the int8 cache per live position and kv head beyond the values:
# one f32 k scale and one f32 v scale
SCALE_BYTES = 8
# depth of the in-turns control phases of earlier slices (the main paths
# run at Llama-3-8B's full 32 layers); cut from 8 to keep the smoke
# inside its time limit beside phase 12
CONTROL_LAYERS = 2
# depth of the watchdog, shedding and embeddings phases' engines
RECOVERY_LAYERS = 8
# depth of the paged, mixed, sessions, spec and int8-KV serving phases:
# full depth until the tensor-parallel phase came, cut then by their
# printed walls (each ~15-20 s of precompile at full depth); and of phase
# 15's served tp burst since its tp features part came (the smoke ran
# 1143.3 s on a slow host with it at full depth)
CUT_LAYERS = 8
# the shedding phase's SLO: targets every answered request breaks, so the
# burn rate and the blame by journey stage must show
SHEDDING_SLO = {"ttft-ms-p95": 1, "tpot-ms-p95": 1}
# H100 SXM FP32 peak outside the tensor cores: the encoder and the vector
# search run in f32, and nothing turns TF32 on
PEAK_FP32_FLOPS = 66.9e12
# the f32 encoder on the card against the CPU, on unit vectors: cuBLAS and
# the CPU's GEMMs sum in other orders
EMBED_TOLERANCE = 1e-4
# search scores on the card against the host's numpy scores (unit vectors)
SEARCH_TOLERANCE = 1e-5
# (name, source, TPU kernel) of each kernel, B1-B8
SOURCES = {
    "flash_prefill": ("flash_prefill.cu", "flash_attention.py:64"),
    "flash_decode": ("flash_decode.cu", "decode_kernel.py:198"),
    "paged_attention": ("paged_attention.cu", "paged_attention.py:245"),
    "flash_prefill_quant": ("flash_prefill.cu", "flash_attention.py:153"),
    "flash_decode_quant": ("flash_decode.cu", "decode_kernel.py:206"),
    "paged_attention_quant": ("paged_attention.cu", "paged_attention.py:254"),
    "paged_attention_ragged_q": ("paged_attention.cu", "paged_attention.py:263"),
    "paged_attention_ragged_q_quant": ("paged_attention.cu", "paged_attention.py:276"),
}


def log(message: str) -> None:
    print(message, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Device time per call: CUDA events around ``iters`` calls that were
    all enqueued while the card was held busy by a sleep kernel longer
    than their host time, so they run back to back and the host's
    enqueue time (Python checks, allocation, the launch) is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - started
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2.0e9) + 1_000_000)  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int = 20) -> float:
    """Wall time per call with the host in the loop (enqueue + device),
    what a caller that waits on each call pays."""
    fn()
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - started) / iters * 1e3


def bound(flops: float, nbytes: float):
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def errors(out: torch.Tensor, ref: torch.Tensor):
    diff = float((out.float() - ref.float()).abs().max())
    return diff, diff / float(ref.float().abs().max())


def dequantize(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """A bf16 view of an int8 cache, for the SDPA yardstick only."""
    return (values.float() * scales[..., None]).bfloat16()


def entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms) -> dict:
    source, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": f"langstream_tpu_torch/csrc/{source}",
        "replaces": f"langstream_tpu/ops/{replaces}", "max_abs_err": worst_abs, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


# ---------------------------------------------------------------------- #
# a HuggingFace checkpoint of the port's params, written by the port's
# own safetensors writer: the script needs only torch and numpy
# ---------------------------------------------------------------------- #
def hf_tensors(config, params):
    """(HF name, tensor) of the port's params in a HF Llama (Qwen-2 with
    biases, Mixtral with experts) checkpoint's layout: each layer's
    ``[in, out]`` matrix as the ``[out, in]`` view HF stores (Mixtral's
    router ``block_sparse_moe.gate`` ``[E, H]``, each expert's gate, up
    and down as ``experts.{e}.w1`` / ``w3`` / ``w2``), norms and biases as
    they are. Views only: nothing is copied until the writer writes it."""
    if config.post_norms:
        raise ValueError("the writer writes the Llama, Qwen-2 and Mixtral layouts only")
    yield "model.embed_tokens.weight", params["embedding"]
    for i in range(config.num_layers):
        p = f"model.layers.{i}."
        for leaf, name in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                           ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj")):
            yield p + name + ".weight", params[leaf][i].t()
        if config.num_experts:
            yield p + "block_sparse_moe.gate.weight", params["router"][i].t()
            for e in range(config.num_experts):
                for leaf, name in (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2")):
                    yield p + f"block_sparse_moe.experts.{e}.{name}.weight", params[leaf][i, e].t()
        else:
            for leaf, name in (("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                               ("w_down", "mlp.down_proj")):
                yield p + name + ".weight", params[leaf][i].t()
        if config.qkv_bias:
            for leaf, name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
                yield p + f"self_attn.{name}.bias", params[leaf][i]
        yield p + "input_layernorm.weight", params["attn_norm"][i]
        yield p + "post_attention_layernorm.weight", params["mlp_norm"][i]
    yield "model.norm.weight", params["final_norm"]
    if not config.tie_embeddings:
        yield "lm_head.weight", params["lm_head"].t()


def write_hf_checkpoint(path, config, params, max_shard_bytes: int = 5 * 10**9) -> int:
    """A HF Llama (Qwen-2, Mixtral) model directory of ``params``:
    ``config.json``, shards of at most ``max_shard_bytes`` of tensor data
    each, named as ``save_pretrained`` names them, and the index mapping
    every tensor to its shard. Returns the bytes of the shards."""
    os.makedirs(path, exist_ok=True)
    family = "mixtral" if config.num_experts else "qwen2" if config.qkv_bias else "llama"
    hf = {
        "architectures": [{"mixtral": "MixtralForCausalLM", "qwen2": "Qwen2ForCausalLM",
                           "llama": "LlamaForCausalLM"}[family]],
        "model_type": family,
        "vocab_size": config.vocab_size, "hidden_size": config.hidden_size,
        "intermediate_size": config.intermediate_size, "num_hidden_layers": config.num_layers,
        "num_attention_heads": config.num_heads, "num_key_value_heads": config.num_kv_heads,
        "rope_theta": config.rope_theta, "rms_norm_eps": config.norm_eps,
        "max_position_embeddings": config.max_seq_len,
        "tie_word_embeddings": config.tie_embeddings, "torch_dtype": str(config.dtype)[6:],
    }
    if config.head_dim:
        hf["head_dim"] = config.head_dim
    if config.num_experts:
        hf.update(num_local_experts=config.num_experts, num_experts_per_tok=config.num_experts_per_tok)
    if config.rope_scaling:
        kind, factor, low, high, original = config.rope_scaling
        hf["rope_scaling"] = {"rope_type": kind, "factor": factor, "low_freq_factor": low,
                              "high_freq_factor": high, "original_max_position_embeddings": original}
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh, indent=2)
    shards, size = [[]], 0
    for name, tensor in hf_tensors(config, params):
        nbytes = tensor.numel() * tensor.element_size()
        if shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, tensor))
        size += nbytes
    weight_map, written = {}, 0
    for number, shard in enumerate(shards, 1):
        fname = f"model-{number:05d}-of-{len(shards):05d}.safetensors"
        written += write_safetensors(os.path.join(path, fname), shard)
        weight_map.update(dict.fromkeys((name for name, _ in shard), fname))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as fh:
        json.dump({"metadata": {"total_size": written}, "weight_map": weight_map}, fh, indent=2)
    return written


def _demangle(symbols):
    try:
        out = subprocess.run(["c++filt"], input="\n".join(symbols), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {symbol: symbol for symbol in symbols}
    return dict(zip(symbols, out)) if len(out) == len(symbols) else {s: s for s in symbols}


def kernel_resources(source: str = "paged_attention") -> None:
    """Registers and spilled bytes of each kernel of ``csrc/<source>.cu``
    (``ptxas -v``, kept in the build's log) and its tensor-core
    instructions in the SASS (``cuobjdump -sass``: HMMA from ``mma.sync``,
    HGMMA from ``wgmma``; None where the toolkit has no cuobjdump). The
    bf16-q kernels (the paged and decode ``mma_kernel`` bodies, the
    prefill ``wgmma_kernel`` body) must use the tensor cores and spill
    nothing."""
    kernels, current = {}, None
    with open(_build.log_path(source)) as handle:
        for line in handle:
            if "Function properties for" in line:
                current = line.split("Function properties for", 1)[1].strip()
                kernels.setdefault(current, {"hmma": None, "hgmma": None})
            elif current and "spill stores" in line:
                found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                kernels[current]["spill_bytes"] = int(found[1]) + int(found[2])
            elif current and re.search(r"Used \d+ registers", line):
                kernels[current]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", _build.library_path(source)], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        current = None
        for line in sass.splitlines():
            if "Function :" in line:
                current = line.split("Function :", 1)[1].strip()
                kernels.setdefault(current, {}).update(hmma=0, hgmma=0)
            elif current:
                for op in ("HMMA", "HGMMA"):
                    if re.search(rf"\b{op}\b", line):
                        kernels[current][op.lower()] += 1
    names = _demangle(sorted(kernels))
    for symbol in sorted(kernels):
        info, name = kernels[symbol], names[symbol]
        log(f"{source}.cu kernel {name}: {info.get('registers')} registers, "
            f"{info.get('spill_bytes')} bytes spilled, {info.get('hmma')} HMMA and "
            f"{info.get('hgmma')} HGMMA in the SASS")
        if "mma_kernel" in name:  # the paged and decode mma_kernel, flash_prefill_wgmma_kernel
            assert info.get("spill_bytes") == 0, f"{name} spills"
            assert info.get("hmma") is None or info["hmma"] + info["hgmma"] > 0, (
                f"{name}: no tensor-core instruction in the SASS")


def _prefill_case(device, quant, lengths_host, seq):
    """B1 (B4 with ``quant``) at one shape, Llama-3-8B heads: errors and
    times against the plain version, SDPA and the bound."""
    batch, heads, kv_heads, dim = len(lengths_host), 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(1)
    q = torch.randn(batch, seq, heads, dim, device=device, generator=gen).bfloat16()
    k = torch.randn(batch, seq, kv_heads, dim, device=device, generator=gen).bfloat16()
    v = torch.randn(batch, seq, kv_heads, dim, device=device, generator=gen).bfloat16()
    lengths = torch.tensor(lengths_host, dtype=torch.int32, device=device)
    mask = torch.arange(seq, device=device)[None, :] < lengths[:, None]
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        starts = torch.zeros_like(lengths)

        def kernel():
            return flash_prefill_attention_quant(q, kq, ks, vq, vs, lengths=lengths)

        def plain():
            return chunk_attention_quant(q, kq, ks, vq, vs, starts, lengths)

        k, v = dequantize(kq, ks), dequantize(vq, vs)  # the SDPA yardstick's inputs
    else:
        def kernel():
            return flash_prefill_attention(q, k, v, lengths=lengths)

        def plain():
            return prefill_attention(q, k, v, mask=mask)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for b, n in enumerate(lengths_host):
        a, r = errors(out[b, :n], ref[b, :n])
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    name = "flash_prefill_quant" if quant else "flash_prefill"
    assert worst_rel < KERNEL_TOLERANCE, f"{name} [B={batch} T={seq}] disagrees: {worst_rel}"
    # SDPA yardstick: same function through one library call (bool mask)
    rows = torch.arange(seq, device=device)
    sdpa_mask = (rows[None, :] <= rows[:, None])[None, None] & mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    kernel_ms = time_ms(kernel)
    wall_ms = call_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
    live = lengths.long()
    pairs = float((live * (live + 1) // 2).sum())        # causal (row, col) pairs
    flops = 4.0 * heads * dim * pairs
    kv_rows = float(live.sum()) * kv_heads               # live (position, kv head) rows
    kv_bytes = kv_rows * (2 * dim + SCALE_BYTES) if quant else 2.0 * 2 * kv_rows * dim
    nbytes = 2.0 * 2 * q.numel() + kv_bytes + 4 * batch
    bound_ms, bound_by = bound(flops, nbytes)
    label = ("B4 flash_prefill_quant", "int8 k/v") if quant else ("B1 flash_prefill", "bf16")
    log(f"{label[0]} [B={batch} T={seq} H={heads} KVH={kv_heads} D={dim} q bf16, {label[1]}]: "
        f"max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} (tol {KERNEL_TOLERANCE}) "
        f"kernel_ms={kernel_ms:.4f} (call with host {wall_ms:.4f}) plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f}{' (SDPA on a dequantized bf16 view, untimed)' if quant else ''} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    return entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms)


def check_prefill_kernel(device, quant: bool = False) -> dict:
    """B1 at a prefill call of the serving path: B=4, T=256, Llama-3-8B
    heads, lengths 256/201/97/1; with ``quant``, B4 over ``quantize_kv``
    of the same k/v. Then the top prompt bucket, B=1, T=1024, where the
    work is bound by operations: its fields are the ``long_*`` ones."""
    result = _prefill_case(device, quant, [256, 201, 97, 1], 256)
    long = _prefill_case(device, quant, [1024], 1024)
    result.update({f"long_{key}": long[key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return result


def check_decode_kernel(device, quant: bool = False) -> dict:
    """B2 at a decode step of the serving path: 32 slots × 1024 context;
    with ``quant``, B5 over ``quantize_kv`` of the same cache."""
    slots, max_len, heads, kv_heads, dim = 32, 1024, 32, 8, 128
    gen = torch.Generator(device=device).manual_seed(2)
    q = torch.randn(slots, heads, dim, device=device, generator=gen).bfloat16()
    kc = torch.randn(slots, max_len, kv_heads, dim, device=device, generator=gen).bfloat16()
    vc = torch.randn(slots, max_len, kv_heads, dim, device=device, generator=gen).bfloat16()
    lengths_host = [0, 1, max_len] + torch.randint(
        2, max_len, (slots - 3,), generator=torch.Generator().manual_seed(3)).tolist()
    lengths = torch.tensor(lengths_host, dtype=torch.int32, device=device)
    long_len = 4 * max_len  # the same lengths over a 4x longer cache

    def padded(t):
        wide = torch.zeros((slots, long_len) + tuple(t.shape[2:]), dtype=t.dtype, device=device)
        wide[:, :max_len] = t
        return wide

    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
        long_cache = [padded(t) for t in (kq, ks, vq, vs)]

        def kernel():
            return flash_decode_attention_quant(q, kq, ks, vq, vs, lengths)

        def long_kernel():
            return flash_decode_attention_quant(q, *long_cache, lengths)

        def plain():
            return decode_attention_quant(q, kq, ks, vq, vs, lengths)

        kc, vc = dequantize(kq, ks), dequantize(vq, vs)  # the SDPA yardstick's inputs
    else:
        long_cache = [padded(t) for t in (kc, vc)]

        def kernel():
            return flash_decode_attention(q, kc, vc, lengths)

        def long_kernel():
            return flash_decode_attention(q, *long_cache, lengths)

        def plain():
            return decode_attention(q, kc, vc, lengths)

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    name = "flash_decode_quant" if quant else "flash_decode"
    assert float(out[0].float().abs().max()) == 0.0, f"{name}: an empty slot must decode to zeros"
    worst_abs = worst_rel = 0.0
    for s in range(1, slots):
        a, r = errors(out[s], ref[s])
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    assert worst_rel < KERNEL_TOLERANCE, f"{name} disagrees: {worst_rel}"
    sdpa_mask = (torch.arange(max_len, device=device)[None, :] < lengths[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    kernel_ms = time_ms(kernel)
    wall_ms = call_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
    live = float(sum(lengths_host))
    flops = 4.0 * heads * dim * live
    kv_bytes = live * kv_heads * (2 * dim + SCALE_BYTES) if quant else 2.0 * 2 * live * kv_heads * dim
    nbytes = 2.0 * 2 * q.numel() + kv_bytes + 4 * slots
    bound_ms, bound_by = bound(flops, nbytes)
    label = ("B5 flash_decode_quant", "int8 cache") if quant else ("B2 flash_decode", "bf16")
    log(f"{label[0]} [S={slots} T={max_len} H={heads} KVH={kv_heads} D={dim} q bf16, {label[1]}, "
        f"live rows {int(live)}]: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} "
        f"(tol {KERNEL_TOLERANCE}) kernel_ms={kernel_ms:.4f} (call with host {wall_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f}"
        f"{' (SDPA on a dequantized bf16 view, untimed)' if quant else ''} "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    # the reads follow the live context: the same lengths over T 4096
    # agree with the plain version and take about the same time (a printed
    # line, not a gate)
    long_out = long_kernel()
    torch.cuda.synchronize()
    long_rel = max(errors(long_out[s], ref[s])[1] for s in range(1, slots))
    assert long_rel < KERNEL_TOLERANCE, f"{name} at T={long_len} disagrees: {long_rel}"
    assert not bool(long_out[0].any()), f"{name} at T={long_len}: an empty slot must decode to zeros"
    long_ms = time_ms(long_kernel)
    log(f"{label[0]} at T={long_len}, the same lengths: kernel_ms={long_ms:.4f} "
        f"(T={max_len}: {kernel_ms:.4f}) max_rel_err={long_rel:.3e}")
    del long_cache
    return entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms)


def _paged_bound(seq, heads, kv_heads, dim, block_size, table_width, starts, lengths,
                 window=0, quant=False):
    """The least time B3 (B6 with ``quant``; B7, B8 over the same rows
    laid out flat) could take on these inputs (and its kind, and the live
    (query, key) pairs): the q rows of each row's new tokens once (the
    kernel reads no other), the whole out tile once, every live
    block-padded k/v block inside each row's [first, last] once (int8
    values and their f32 scales for B6), the tables; 4·H·D FLOPs per live
    pair."""
    batch = len(starts)
    pairs = blocks = q_rows = 0
    for start, total in zip(starts, lengths):
        new = min(seq, total - start)
        if total <= 0 or new <= 0:
            continue
        q_rows += new
        first, last = block_bounds(start, total, window, 0, new, block_size)
        blocks += last - first + 1
        for t in range(new):
            pos = start + t
            low = max(0, pos - window + 1) if window > 0 else 0
            pairs += min(pos + 1, total) - low
    flops = 4.0 * heads * dim * pairs
    kv_rows = float(blocks * block_size * kv_heads)
    kv_bytes = kv_rows * (2 * dim + SCALE_BYTES) if quant else 2.0 * 2 * kv_rows * dim
    nbytes = 2.0 * (q_rows + batch * seq) * heads * dim + kv_bytes + 4.0 * batch * (table_width + 2)
    return (*bound(flops, nbytes), pairs)


def check_paged_kernel(device, quant: bool = False) -> dict:
    """B3 at the paged path's three shapes, Llama-3-8B heads, bf16,
    16-token blocks, in one pool of 2049 blocks through seeded permuted
    tables (rows 0 and 1 share their prefix blocks): a decode step of 32
    rows over 1024 positions, a prefill-at-offset of 4 rows, and a
    speculative verify block of 32 rows × Tq 5 (1 + spec_k 4; live lengths
    up to 1024, 1 to 5 new tokens a row), launched as a verify block and
    counted by the card in its own class (``paged_attention/verify``).
    With ``quant``, B6 over ``quantize_kv`` of the same pools."""
    heads, kv_heads, dim, block_size, num_blocks, width = 32, 8, 128, 16, 2049, 64
    gen = torch.Generator(device=device).manual_seed(4)
    k_pool = torch.randn(num_blocks, block_size, kv_heads, dim, device=device, generator=gen).bfloat16()
    v_pool = torch.randn(num_blocks, block_size, kv_heads, dim, device=device, generator=gen).bfloat16()
    if quant:
        pools = (*quantize_kv(k_pool), *quantize_kv(v_pool))
        # the SDPA yardstick's inputs
        k_pool, v_pool = dequantize(*pools[:2]), dequantize(*pools[2:])
    else:
        pools = (k_pool, v_pool)
    name = "paged_attention_quant" if quant else "paged_attention"
    rng = np.random.default_rng(4)
    decode_lengths = [0, 1, 16, 17, 1024] + rng.integers(2, 1025, size=27).tolist()
    verify_lengths = [5, 16, 17, 1024] + rng.integers(6, 1025, size=28).tolist()
    verify_new = [5, 1, 5, 5] + rng.integers(1, 6, size=28).tolist()
    cases = [
        ("decode", 1, [max(n - 1, 0) for n in decode_lengths], decode_lengths),
        ("prefill-at-offset", 256, [0, 256, 512, 767], [256, 457, 609, 768]),
        ("verify", 5, [n - m for n, m in zip(verify_lengths, verify_new)], verify_lengths),
    ]
    result = None
    for label, seq, starts_host, lengths_host in cases:
        batch = len(starts_host)
        tables_host = (rng.permutation(num_blocks - 1) + 1)[: batch * width].reshape(batch, width)
        tables_host[1, : width // 2] = tables_host[0, : width // 2]
        tables = torch.from_numpy(tables_host.astype(np.int32)).to(device)
        starts = torch.tensor(starts_host, dtype=torch.int32, device=device)
        lengths = torch.tensor(lengths_host, dtype=torch.int32, device=device)
        q = torch.randn(batch, seq, heads, dim, device=device, generator=gen).bfloat16()

        def kernel():
            fn = ragged_paged_attention_quant if quant else ragged_paged_attention
            return fn(q, *pools, tables, starts, lengths, verify=label == "verify")

        def plain():
            if seq == 1:
                fn = paged_decode_attention_quant if quant else paged_decode_attention
                return fn(q[:, 0], *pools, tables, lengths)[:, None]
            fn = paged_chunk_attention_quant if quant else paged_chunk_attention
            return fn(q, *pools, tables, starts, lengths)

        with launches_lib.device_launches(shapes=True) as counted:
            out = kernel()
        ref = plain()
        torch.cuda.synchronize()
        shape = {"decode": None, "prefill-at-offset": "prefill", "verify": "verify"}[label]
        assert counted[name] == 1 and all(
            counted[f"{name}/{other}"] == (other == shape) for other in ("prefill", "verify")), (
            label, counted)
        worst_abs = worst_rel = 0.0
        for b, (start, total) in enumerate(zip(starts_host, lengths_host)):
            if total == 0:
                assert float(out[b].float().abs().max()) == 0.0, f"{name}: an empty row must yield zeros"
                continue
            a, r = errors(out[b, : total - start], ref[b, : total - start])
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
        assert worst_rel < KERNEL_TOLERANCE, f"{name} ({label}) disagrees: {worst_rel}"
        # SDPA yardstick on a contiguous copy gathered through the tables
        # beforehand (the gather, and for B6 the dequantization, untimed)
        kt = gather_blocks(k_pool, tables).transpose(1, 2)
        vt = gather_blocks(v_pool, tables).transpose(1, 2)
        pos_q = starts[:, None] + torch.arange(seq, device=device)[None, :]
        pos_s = torch.arange(kt.shape[2], device=device)
        sdpa_mask = ((pos_s[None, None, :] <= pos_q[:, :, None])
                     & (pos_s[None, None, :] < lengths[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        kernel_ms = time_ms(kernel)
        wall_ms = call_ms(kernel)
        plain_ms = time_ms(plain)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
        bound_ms, bound_by, pairs = _paged_bound(
            seq, heads, kv_heads, dim, block_size, width, starts_host, lengths_host, quant=quant)
        tag = ("B6", "int8 pools") if quant else ("B3", "bf16")
        log(f"{tag[0]} {name} {label} [B={batch} Tq={seq} H={heads} KVH={kv_heads} D={dim} "
            f"Bs={block_size} M={width} N={num_blocks} q bf16, {tag[1]}, {pairs} live (query, key) "
            f"pairs]: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e} (tol {KERNEL_TOLERANCE}) "
            f"kernel_ms={kernel_ms:.4f} (call with host {wall_ms:.4f}) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (SDPA on the pre-gathered{' dequantized' if quant else ''} "
            f"view, untimed) bound_ms={bound_ms:.5f} ({bound_by}); the card counted the launch "
            f"{ {key: n for key, n in counted.items() if key.startswith(name + '/') or key == name} }")
        if shape is None:  # the decode shape's fields, then each other shape's own
            result = entry(name, worst_abs, kernel_ms, plain_ms, bound_ms, bound_by, library_ms)
        else:
            result.update({f"{shape}_{key}": value for key, value in (
                ("max_abs_err", worst_abs), ("ms", kernel_ms), ("plain_ms", plain_ms),
                ("bound_ms", bound_ms), ("bound_by", bound_by), ("library_ms", library_ms))})
    return result


def check_ragged_q_kernel(device, quant: bool = False) -> dict:
    """B7 at the mixed step's shape: Llama-3-8B heads, 32 rows of a 64-wide
    span (block_q 8, q_offsets = b * 64), 16-token blocks, the 2049-block
    pool through seeded permuted tables. Rows: 28 decode rows at B3's
    decode contexts, a warm window of 40 at offset 512, a cold window of
    24 at offset 0, two idle rows. Held against the plain version (and
    again with the spans packed at non-uniform offsets), bitwise against
    B3's Tq = 1 and Tq = 64 launches row by row, and its dead tiles and
    idle rows exactly zero. With ``quant``, B8 over ``quantize_kv`` of the
    same pools, against B6."""
    heads, kv_heads, dim, block_size, num_blocks, table_width = 32, 8, 128, 16, 2049, 64
    slots, width, block_q = 32, 64, 8
    gen = torch.Generator(device=device).manual_seed(5)
    k_pool = torch.randn(num_blocks, block_size, kv_heads, dim, device=device, generator=gen).bfloat16()
    v_pool = torch.randn(num_blocks, block_size, kv_heads, dim, device=device, generator=gen).bfloat16()
    if quant:
        pools = (*quantize_kv(k_pool), *quantize_kv(v_pool))
        k_pool, v_pool = dequantize(*pools[:2]), dequantize(*pools[2:])  # the SDPA yardstick's
    else:
        pools = (k_pool, v_pool)
    name = "paged_attention_ragged_q_quant" if quant else "paged_attention_ragged_q"
    kernel_fn = ragged_q_paged_attention_quant if quant else ragged_q_paged_attention
    plain_fn = paged_ragged_q_attention_quant if quant else paged_ragged_q_attention
    fixed_fn = ragged_paged_attention_quant if quant else ragged_paged_attention
    rng = np.random.default_rng(4)
    decode_lengths = [0, 1, 16, 17, 1024] + rng.integers(2, 1025, size=27).tolist()  # B3's
    rows = [(n - 1, n) for n in decode_lengths[1:29]] + [(512, 552), (0, 24), (0, 0), (0, 0)]
    starts_host, lengths_host = (list(column) for column in zip(*rows))
    tables_host = (rng.permutation(num_blocks - 1) + 1)[: slots * table_width].reshape(slots, table_width)
    tables = torch.from_numpy(tables_host.astype(np.int32)).to(device)
    starts = torch.tensor(starts_host, dtype=torch.int32, device=device)
    lengths = torch.tensor(lengths_host, dtype=torch.int32, device=device)
    live = [total - start for start, total in rows]

    def held(q, q_offsets, offsets_host):
        """The kernel against the plain version on these spans; dead
        tiles, idle rows and uncovered positions exactly zero."""
        args = (q, *pools, tables, starts, lengths, q_offsets)
        out = kernel_fn(*args, max_q_len=width, block_q=block_q)
        ref = plain_fn(*args, max_q_len=width, block_q=block_q)
        torch.cuda.synchronize()
        worst_abs = worst_rel = 0.0
        covered = torch.zeros(q.shape[0], dtype=torch.bool, device=device)
        for b, offset in enumerate(offsets_host):
            covered[offset:offset + width] = True
            if live[b]:
                a, r = errors(out[offset:offset + live[b]], ref[offset:offset + live[b]])
                worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
            dead = offset + -(-live[b] // block_q) * block_q
            assert not bool(out[dead:offset + width].any()), f"{name}: row {b} dead tiles not zero"
        assert not bool(out[~covered].any()), f"{name}: positions outside every span not zero"
        assert worst_rel < KERNEL_TOLERANCE, f"{name} disagrees: {worst_rel}"
        return out, worst_abs, worst_rel

    # the mixed step's layout: row b's span at b * 64
    q = torch.randn(slots * width, heads, dim, device=device, generator=gen).bfloat16()
    uniform = [b * width for b in range(slots)]
    q_offsets = torch.tensor(uniform, dtype=torch.int32, device=device)
    out, worst_abs, worst_rel = held(q, q_offsets, uniform)
    # bitwise B3 (B6) row by row at window 0: decode rows against a Tq = 1
    # launch, the windows against a Tq = 64 launch over the same spans
    q4 = q.view(slots, width, heads, dim)
    decode = fixed_fn(q4[:, :1].contiguous(), *pools, tables, starts, lengths)
    windows = fixed_fn(q4, *pools, tables, starts, lengths)
    out4 = out.view(slots, width, heads, dim)
    torch.cuda.synchronize()
    for b, n in enumerate(live):
        if n == 1:
            assert torch.equal(out4[b, 0], decode[b, 0]), f"{name}: decode row {b} is not B3's"
        elif n:
            assert torch.equal(out4[b, :n], windows[b, :n]), f"{name}: window row {b} is not B3's"
    # the spans packed at non-uniform tile-aligned offsets, in another order
    order = rng.permutation(slots)
    gaps = rng.integers(0, 3, size=slots) * block_q
    packed_host = [0] * slots
    position = 0
    for b, gap in zip(order, gaps):
        position += int(gap)
        packed_host[b] = position
        position += width
    packed_q = torch.randn(position + block_q, heads, dim, device=device, generator=gen).bfloat16()
    packed = torch.tensor(packed_host, dtype=torch.int32, device=device)
    _, packed_abs, packed_rel = held(packed_q, packed, packed_host)

    def kernel():  # the offsets from the host, as the model passes them: no read from the card
        return kernel_fn(q, *pools, tables, starts, lengths, q_offsets, max_q_len=width,
                         block_q=block_q, q_offsets_host=uniform)

    def plain():
        return plain_fn(q, *pools, tables, starts, lengths, q_offsets, max_q_len=width, block_q=block_q)

    # SDPA yardstick on a contiguous copy gathered through the tables
    # beforehand (the gather, and for B8 the dequantization, untimed)
    kt = gather_blocks(k_pool, tables).transpose(1, 2)
    vt = gather_blocks(v_pool, tables).transpose(1, 2)
    pos_q = starts[:, None] + torch.arange(width, device=device)[None, :]
    pos_s = torch.arange(kt.shape[2], device=device)
    sdpa_mask = ((pos_s[None, None, :] <= pos_q[:, :, None])
                 & (pos_s[None, None, :] < lengths[:, None, None]))[:, None]
    qt = q4.transpose(1, 2)
    kernel_ms = time_ms(kernel)
    wall_ms = call_ms(kernel)
    plain_ms = time_ms(plain)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask, enable_gqa=True))
    bound_ms, bound_by, pairs = _paged_bound(
        width, heads, kv_heads, dim, block_size, table_width, starts_host, lengths_host, quant=quant)
    tag = ("B8", "int8 pools", "B6") if quant else ("B7", "bf16", "B3")
    log(f"{tag[0]} {name} mixed step [S={slots} W={width} block_q={block_q} H={heads} "
        f"KVH={kv_heads} D={dim} Bs={block_size} M={table_width} N={num_blocks} q bf16, {tag[1]}; "
        f"28 decode rows, windows of 40 at 512 and 24 at 0, 2 idle; {pairs} live (query, key) "
        f"pairs]: max_abs_err={worst_abs:.3e} max_rel_err={worst_rel:.3e}, packed q_offsets "
        f"max_abs_err={packed_abs:.3e} max_rel_err={packed_rel:.3e} (tol {KERNEL_TOLERANCE}); "
        f"rows bitwise {tag[2]}'s, dead tiles and idle rows zero; kernel_ms={kernel_ms:.4f} (call "
        f"with host {wall_ms:.4f}) plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA on "
        f"the pre-gathered{' dequantized' if quant else ''} view, untimed) "
        f"bound_ms={bound_ms:.5f} ({bound_by})")
    return entry(name, max(worst_abs, packed_abs), kernel_ms, plain_ms, bound_ms, bound_by,
                 library_ms)


def check_model_against_cpu(device, kv_quant: bool = False, feed=None):
    """Llama-3-8B width, 2 layers: prefill + 4 decode steps on the card
    (kernels) against the same bf16 weights on the CPU (plain path), over
    the bf16 cache or (``kv_quant``) the int8 one. Decode feeds the card's
    argmax, or the tokens ``feed`` gives; returns the card's logits of
    every stage and the tokens fed."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=128), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    cpu_params = {name: p.cpu() for name, p in params.items()}
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 48)))
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    slots = torch.tensor([0, 2])
    worst = 0.0
    caches, logits = {}, {}
    for where, p in (("cuda", params), ("cpu", cpu_params)):
        caches[where] = model.init_cache(config, 3, 128, kv_quant=kv_quant, device=where)
        logits[where] = model.prefill(
            config, p, caches[where], tokens.to(where), lengths.to(where),
            slots.to(where), model.model_freqs(config, device=where))
    active = torch.tensor([True, False, True])
    step_lengths = torch.tensor([49, 0, 31], dtype=torch.int32)
    step_tokens = torch.zeros(3, dtype=torch.long)
    card, fed = [], []
    for step in range(5):
        if step:
            step_tokens[active] = feed[step - 1] if feed else logits["cuda"].argmax(-1).cpu()
            fed.append(step_tokens[active].clone())
            for where, p in (("cuda", params), ("cpu", cpu_params)):
                logits[where] = model.decode_step(
                    config, p, caches[where], step_tokens.to(where), step_lengths.to(where),
                    model.model_freqs(config, device=where), active.to(where))[active.to(where)]
            step_lengths = torch.where(active, step_lengths + 1, step_lengths)
        out, ref = logits["cuda"].cpu(), logits["cpu"]
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        worst = max(worst, errors(out, ref)[1])
        card.append(out)
    assert worst < MODEL_TOLERANCE, f"model on the card disagrees with the CPU: {worst}"
    log(f"reference: Llama-3-8B width, 2 layers, {'int8' if kv_quant else 'bf16'} KV cache, prefill "
        f"+ 4 decode steps, card ({'B4/B5' if kv_quant else 'B1/B2'}) vs CPU max_rel_err={worst:.3e} "
        f"(tol {MODEL_TOLERANCE})")
    return card, fed


def check_int8_against_bf16(device) -> None:
    """The dense reference over the int8 cache, fed the bf16 run's tokens:
    its logits on the card within INT8_TOLERANCE of the bf16 cache's."""
    bf16, fed = check_model_against_cpu(device)
    int8, _ = check_model_against_cpu(device, kv_quant=True, feed=fed)
    worst = max(errors(out, ref)[1] for out, ref in zip(int8, bf16))
    agree = float(np.mean([float((o.argmax(-1) == r.argmax(-1)).float().mean())
                           for o, r in zip(int8, bf16)]))
    assert worst < INT8_TOLERANCE, f"int8 KV cache logits vs bf16: {worst}"
    log(f"int8 vs bf16 KV cache: Llama-3-8B width, 2 layers, prefill + 4 decode steps on the card, "
        f"max_rel_err={worst:.3e} (tol {INT8_TOLERANCE}), argmax agreement {agree:.2f}")


def check_int8_weights_against_cpu(device) -> None:
    """Llama-3-8B width, 2 layers, int8 weights (``quantize_params`` of
    the bf16 ones): dense prefill + 2 decode steps (B1, B2), paged prefill
    + 2 decode steps (B3), and paged prefill + two mixed steps (both rows
    decoding beside an idle row, then row 0 decoding beside a window of
    40 of row 1; B7), on the card against the same int8 weights on the
    CPU, fed the same tokens."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=128), num_layers=2)
    params = quantize_params(model.init_params(config, seed=7, device=device))
    cpu_params = {name: p.to("cpu") for name, p in params.items()}
    rng = np.random.default_rng(13)
    prompts = torch.from_numpy(rng.integers(0, config.vocab_size, size=(3, 48)))
    lengths = torch.tensor([48, 30, 0], dtype=torch.int32)
    fed = torch.from_numpy(rng.integers(0, config.vocab_size, size=(3, 40)))
    block, width = 16, 128 // 16
    tables = torch.zeros((3, width), dtype=torch.int32)
    tables[:2] = torch.from_numpy((rng.permutation(2 * width) + 1).reshape(2, width).astype(np.int32))
    active = torch.tensor([True, True, False])

    def run(where, p, call):
        freqs = model.model_freqs(config, device=where)
        step = (lengths + 1).to(where)
        w = active.to(where)
        if call == "dense":
            cache = model.init_cache(config, 3, 128, device=where)
            out = [model.prefill(config, p, cache, prompts[:2].to(where), lengths[:2].to(where),
                                 torch.tensor([0, 1], device=where), freqs)]
            for j in range(2):
                out.append(model.decode_step(config, p, cache, fed[:, j].to(where), step + j, freqs,
                                             w)[w])
            return out
        cache = model.init_paged_cache(config, 2 * width + 1, block, device=where)
        t = tables.to(where)
        out = [model.paged_prefill(config, p, cache, prompts[:2].to(where), lengths[:2].to(where),
                                   t[:2], freqs)]
        if call == "paged":
            for j in range(2):
                out.append(model.paged_decode_step(config, p, cache, fed[:, j].to(where), step + j,
                                                   t, freqs, w)[w])
            return out
        tokens = fed.clone()
        offsets = torch.tensor([48, 30, 0], dtype=torch.int32)
        num_tokens = torch.tensor([1, 1, 0], dtype=torch.int32)
        out.append(model.paged_mixed_step(config, p, cache, tokens.to(where), offsets.to(where),
                                          num_tokens.to(where), t, freqs)[w])
        num_tokens = torch.tensor([1, 40, 0], dtype=torch.int32)
        offsets = torch.tensor([49, 31, 0], dtype=torch.int32)
        out.append(model.paged_mixed_step(config, p, cache, tokens.to(where), offsets.to(where),
                                          num_tokens.to(where), t, freqs)[w])
        return out

    worst = {}
    for call in ("dense", "paged", "mixed"):
        card, cpu = run(device, params, call), run("cpu", cpu_params, call)
        worst[call] = 0.0
        for out, ref in zip(card, cpu):
            out = out.float().cpu()
            assert out.shape == ref.shape and bool(torch.isfinite(out).all()), call
            worst[call] = max(worst[call], errors(out, ref)[1])
        assert worst[call] < MODEL_TOLERANCE, f"int8-weight {call} calls on the card vs the CPU: {worst}"
    log(f"int8 weights: Llama-3-8B width, 2 layers, card vs CPU max_rel_err dense (prefill + 2 decode "
        f"steps, B1/B2) {worst['dense']:.3e}, paged (prefill + 2 decode steps, B3) "
        f"{worst['paged']:.3e}, mixed (prefill + 2 mixed steps, B7) {worst['mixed']:.3e} "
        f"(tol {MODEL_TOLERANCE})")


def check_paged_model(device, kv_quant: bool = False) -> None:
    """Llama-3-8B width, 2 layers, paged layout (16-token blocks): cold
    prefill of two prompts, prefill-at-offset of a third row whose table
    reuses the first prompt's first two blocks, then four decode steps (a
    fourth, empty row rides along), on the card (B3; B6 over int8 pools)
    against the CPU (plain), and on the card against the dense path
    (B1/B2; B4/B5). Then a 200-token prompt prefilled in the engine's
    long-prompt windows (buckets 64/128), dense and paged, against a
    one-shot prefill."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=256), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    cpu_params = {name: p.cpu() for name, p in params.items()}
    block, width = 16, 256 // 16
    num_blocks = 4 * width + 1
    rng = np.random.default_rng(9)
    tables = np.zeros((4, width), dtype=np.int32)
    tables[:3] = (rng.permutation(num_blocks - 1) + 1)[: 3 * width].reshape(3, width)
    tables[2, :2] = tables[0, :2]
    tables = torch.from_numpy(tables)
    prompts = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 48)))
    lengths = torch.tensor([48, 30], dtype=torch.int32)
    suffix = torch.from_numpy(rng.integers(0, config.vocab_size, size=(1, 16)))
    active = torch.tensor([True, True, True, False])

    def run(where, p, layout, step_tokens):
        """Logits of each stage; decode feeds ``step_tokens`` (or, when
        None, its own argmax, which it returns)."""
        i32 = dict(dtype=torch.int32, device=where)
        freqs = model.model_freqs(config, device=where)
        t = tables.to(where)
        if layout == "paged":
            cache = model.init_paged_cache(config, num_blocks, block, kv_quant=kv_quant, device=where)
            cold = model.paged_prefill(config, p, cache, prompts.to(where), lengths.to(where), t[:2], freqs)
            warm = model.paged_prefill_at_offset(
                config, p, cache, suffix.to(where), torch.tensor([16], **i32),
                torch.tensor([32], **i32), t[2:3], freqs)
        else:
            cache = model.init_cache(config, 4, 256, kv_quant=kv_quant, device=where)
            cold = model.prefill(config, p, cache, prompts.to(where), lengths.to(where),
                                 torch.tensor([0, 1], device=where), freqs)
            model.prefill(config, p, cache, prompts[:1, :32].to(where), torch.tensor([32], **i32),
                          torch.tensor([2], device=where), freqs)
            warm = model.prefill_at_offset(
                config, p, cache, suffix.to(where), torch.tensor([16], **i32),
                torch.tensor([32], **i32), torch.tensor([2], device=where), freqs)
        stages = [cold, warm]
        tokens = torch.zeros(4, dtype=torch.long)
        tokens[:2] = cold.argmax(-1).cpu()
        tokens[2] = warm[0].argmax().cpu()
        step_lengths = torch.tensor([49, 31, 49, 0], dtype=torch.int32)
        used = []
        for step in range(4):
            if step_tokens is not None:
                tokens = step_tokens[step]
            used.append(tokens.clone())
            args = (tokens.to(where), step_lengths.to(where))
            if layout == "paged":
                logits = model.paged_decode_step(config, p, cache, *args, t, freqs, active.to(where))
            else:
                logits = model.decode_step(config, p, cache, *args, freqs, active.to(where))
            stages.append(logits[active.to(where)])
            tokens = torch.where(active, logits.argmax(-1).cpu(), torch.zeros_like(tokens))
            step_lengths = torch.where(active, step_lengths + 1, step_lengths)
        return [x.float().cpu() for x in stages], used

    card, used = run(device, params, "paged", None)
    cpu, _ = run("cpu", cpu_params, "paged", used)
    dense, _ = run(device, params, "dense", used)
    worst = {"cpu": 0.0, "dense": 0.0}
    for name, other in (("cpu", cpu), ("dense", dense)):
        for out, ref in zip(card, other):
            assert out.shape == ref.shape and bool(torch.isfinite(out).all())
            worst[name] = max(worst[name], errors(out, ref)[1])
        assert worst[name] < MODEL_TOLERANCE, f"paged model on the card vs {name}: {worst[name]}"

    # the engine's long-prompt schedule, both layouts, against one shot
    long_prompt = torch.from_numpy(rng.integers(0, config.vocab_size, size=(1, 256)))
    total = 200
    freqs = model.model_freqs(config, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    dense_cache = model.init_cache(config, 2, 256, kv_quant=kv_quant, device=device)
    one_shot = model.prefill(config, params, dense_cache, long_prompt.to(device),
                             torch.tensor([total], **i32), torch.tensor([1], device=device), freqs)
    pool = model.init_paged_cache(config, num_blocks, block, kv_quant=kv_quant, device=device)
    windows = long_prefill_windows(total, 0, [64, 128])
    for offset, bucket in windows:
        chunk = torch.zeros((1, bucket), dtype=torch.long)
        piece = long_prompt[0, offset:min(offset + bucket, total)]
        chunk[0, : len(piece)] = piece
        args = (chunk.to(device), torch.tensor([len(piece)], **i32), torch.tensor([offset], **i32))
        dense_logits = model.prefill_at_offset(
            config, params, dense_cache, *args, torch.tensor([0], device=device), freqs)
        paged_logits = model.paged_prefill_at_offset(
            config, params, pool, *args, tables[:1].to(device), freqs)
    windowed = max(errors(dense_logits, one_shot)[1], errors(paged_logits, one_shot)[1])
    assert windowed < MODEL_TOLERANCE, f"windowed prefill disagrees with one shot: {windowed}"
    log(f"paged reference: Llama-3-8B width, 2 layers, {'int8' if kv_quant else 'bf16'} KV cache, "
        f"paged prefill + prefill-at-offset + 4 decode steps, card ({'B6' if kv_quant else 'B3'}) vs "
        f"CPU max_rel_err={worst['cpu']:.3e}, card paged vs card dense "
        f"max_rel_err={worst['dense']:.3e}; windowed prefill {windows} (dense and paged) vs one "
        f"shot max_rel_err={windowed:.3e} (tol {MODEL_TOLERANCE})")


def check_mixed_model(device, kv_quant: bool = False) -> None:
    """Llama-3-8B width, 2 layers, paged (16-token blocks): two prompts
    prefilled cold, then one mixed step of five rows (the two prompts
    decoding, a warm window of 40 at offset 32 over the first prompt's
    blocks, a cold window of 24, an idle row; W 64) on the card (B7; B8
    over int8 pools) against the CPU (plain), and on the card against the
    split calls on the same cache state: ``paged_decode_step`` for the
    decode rows, ``paged_prefill_at_offset`` for the windows (B3; B6)."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=256), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    cpu_params = {name: p.cpu() for name, p in params.items()}
    block, table_width, width = 16, 256 // 16, 64
    num_blocks = 5 * table_width + 1
    rng = np.random.default_rng(11)
    tables = np.zeros((5, table_width), dtype=np.int32)
    tables[:4] = (rng.permutation(num_blocks - 1) + 1)[: 4 * table_width].reshape(4, table_width)
    tables[2, :2] = tables[0, :2]  # the warm window resumes on the first prompt's blocks
    tables = torch.from_numpy(tables)
    prompts = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 48)))
    prompt_lengths = torch.tensor([48, 30], dtype=torch.int32)
    windows = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, width)))
    offsets = torch.tensor([48, 30, 32, 0, 0], dtype=torch.int32)
    num_tokens = torch.tensor([1, 1, 40, 24, 0], dtype=torch.int32)
    live = num_tokens > 0

    def prefilled(where, p):
        cache = model.init_paged_cache(config, num_blocks, block, kv_quant=kv_quant, device=where)
        logits = model.paged_prefill(config, p, cache, prompts.to(where), prompt_lengths.to(where),
                                     tables[:2].to(where), model.model_freqs(config, device=where))
        return cache, logits.argmax(-1).cpu()

    def mixed(where, p, cache, firsts):
        tokens = torch.zeros((5, width), dtype=torch.long)
        tokens[:2, 0] = firsts
        tokens[2:4] = windows
        args = [x.to(where) for x in (tokens, offsets, num_tokens, tables)]
        logits = model.paged_mixed_step(config, p, cache, *args, model.model_freqs(config, device=where))
        return logits.float().cpu(), tokens

    card_cache, firsts = prefilled(device, params)
    split_cache = {leaf: value.clone() for leaf, value in card_cache.items()}
    card, tokens = mixed(device, params, card_cache, firsts)
    cpu_cache, _ = prefilled("cpu", cpu_params)
    cpu, _ = mixed("cpu", cpu_params, cpu_cache, firsts)
    # the split paths on the card over the same cache state
    freqs = model.model_freqs(config, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    decode_rows = torch.tensor([True, True, False, False, False])
    decode = model.paged_decode_step(
        config, params, split_cache, tokens[:, 0].to(device), (offsets + 1).to(device),
        tables.to(device), freqs, decode_rows.to(device)).float().cpu()
    warm = model.paged_prefill_at_offset(
        config, params, split_cache, tokens[2:4].to(device), torch.tensor([40, 24], **i32),
        torch.tensor([32, 0], **i32), tables[2:4].to(device), freqs).float().cpu()
    split = torch.cat([decode[:2], warm])
    assert card.shape == cpu.shape and bool(torch.isfinite(card[live]).all())
    to_cpu = errors(card[live], cpu[live])[1]
    to_split = errors(card[:4], split)[1]
    assert to_cpu < MODEL_TOLERANCE, f"mixed step on the card vs the CPU: {to_cpu}"
    assert to_split < MODEL_TOLERANCE, f"mixed step vs the split calls on the card: {to_split}"
    log(f"mixed reference: Llama-3-8B width, 2 layers, {'int8' if kv_quant else 'bf16'} paged KV "
        f"cache, one mixed step (2 decode rows, windows of 40 at 32 and 24 at 0, an idle row; W "
        f"{width}): card ({'B8' if kv_quant else 'B7'}) vs CPU max_rel_err={to_cpu:.3e}, card "
        f"mixed vs card split ({'B6' if kv_quant else 'B3'} decode + prefill-at-offset) "
        f"max_rel_err={to_split:.3e} (tol {MODEL_TOLERANCE})")


def check_prefill_graphs(device, kv_quant: bool = False) -> None:
    """Llama-3-8B width, 2 layers, 4 slots, buckets 64/128/256, each
    layout: one admission round (two cold prompts in one group; a third,
    cold on the dense layout and warm onto the first's blocks on the paged
    one; a 300-token prompt in windows) through an engine whose prefill
    variants ``precompile`` captured as CUDA graphs, and through one built
    with ``step_graphs=False`` (the same bodies run eagerly). They run the
    same kernels on the same inputs: every prefill call's logits must be
    bit for bit equal, and so the first tokens and logprobs; the graphed
    round captures nothing."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=512), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    rng = np.random.default_rng(15)
    shared = rng.integers(0, config.vocab_size, size=80).tolist()
    sampling = engine_lib.SamplingParams
    requests = [
        (shared + rng.integers(0, config.vocab_size, size=20).tolist(), sampling(max_new_tokens=4)),
        (rng.integers(0, config.vocab_size, size=90).tolist(),
         sampling(max_new_tokens=4, temperature=0.8, top_p=0.9, seed=1)),
        (shared + rng.integers(0, config.vocab_size, size=27).tolist(),
         sampling(max_new_tokens=4, temperature=1.0, top_k=20, seed=2)),
        (rng.integers(0, config.vocab_size, size=300).tolist(), sampling(max_new_tokens=4)),
    ]
    cache = "int8" if kv_quant else "bf16"
    for layout in ("dense", "paged"):
        rounds = {}
        for graphs in (True, False):
            eng = engine_lib.DecodeEngine(
                config, params, device=device, max_slots=4, max_seq_len=512,
                prefill_buckets=[64, 128, 256], kv_layout=layout, kv_block_size=16,
                kv_quant="int8" if kv_quant else None, step_graphs=graphs)
            if graphs:
                eng.precompile()
            captured = eng.steps.stats["captured"]
            logits = []
            step = eng.steps.run

            def recorded(key, inputs, _step=step, _logits=logits):
                staged, outputs = _step(key, inputs)
                if key.kind in ("prefill", "prefill_offset"):
                    _logits.append((key, outputs["logits"].clone()))
                return staged, outputs

            eng.steps.run = recorded
            with torch.inference_mode():
                for prompt, params_ in requests:
                    eng._pending.append(engine_lib.GenerationRequest(prompt_tokens=prompt, sampling=params_))
                eng._admit()
                while eng._prefill_inflight:
                    eng._harvest_prefills(block=True)
            firsts = [(slot.generated[0], slot.logprobs[0]) for slot in eng.slots if slot.active]
            eng.stop()
            assert not graphs or eng.steps.stats["captured"] == captured, (
                "a prefill variant was captured while serving")
            rounds[graphs] = (firsts, logits, dict(eng.stats["model_dispatches"]), captured)
            del eng
        (firsts, logits, calls, captured), (eager_firsts, eager_logits, _, _) = rounds[True], rounds[False]
        assert [key for key, _ in logits] == [key for key, _ in eager_logits]
        assert all(bool(torch.isfinite(value).all()) for _, value in logits)
        pairs = list(zip(logits, eager_logits))
        worst = max(float((mine - theirs).abs().max()) for (_, mine), (_, theirs) in pairs)
        bitwise = all(torch.equal(mine, theirs) for (_, mine), (_, theirs) in pairs)
        assert bitwise, f"{layout} {cache}: prefill replay logits differ from eager by {worst}"
        assert firsts == eager_firsts and len(firsts) == 4, (firsts, eager_firsts)
        log(f"prefill graphs ({layout}, {cache} KV cache, Llama-3-8B width, 2 layers, {captured} variants "
            f"captured): {len(logits)} prefill calls {calls}, replayed, logits bit for bit equal to the "
            f"eager run (max |diff| {worst}), first tokens and logprobs equal")
        gc.collect()
        torch.cuda.empty_cache()


def check_mlp_slices(device) -> None:
    """Llama-3-8B width, 2 layers (the graph pool holds about one layer's
    activations at a time, so depth moves it little), 32 slots × 1024
    context, the dense bf16 cache: the prefill lattice captured with the
    MLP in one pass (``model.MLP_ROWS`` past every call) and in slices of
    ``MLP_ROWS`` rows (as served), each engine's graph pool printed; then
    one admission round of 32 prompts in the 1024 bucket (32768 rows, 8
    slices) through each, and through the sliced bodies run eagerly
    (``step_graphs=False``). The sliced replay must equal its eager run
    bit for bit (logits, first tokens and logprobs); against the one-pass
    MLP the logits may differ by the matrix products' rounding, and must
    stay within MODEL_TOLERANCE."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=1024), num_layers=2)
    params = model.init_params(config, seed=8, device=device)
    rng = np.random.default_rng(16)
    sampling = engine_lib.SamplingParams
    requests = [(rng.integers(0, config.vocab_size, size=int(n)).tolist(),
                 sampling(max_new_tokens=4, temperature=0.8, seed=i))
                for i, n in enumerate(rng.integers(600, 1000, size=32))]
    sliced_rows = model.MLP_ROWS
    rounds = {}
    try:
        for name, rows, graphs in (("one pass", 1 << 30, True), ("sliced", sliced_rows, True),
                                   ("sliced eager", sliced_rows, False)):
            model.MLP_ROWS = rows
            eng = engine_lib.DecodeEngine(config, params, device=device, max_slots=32,
                                          max_seq_len=1024, decode_chunk=8, step_graphs=graphs)
            eng.precompile()
            pool = graph_pool_gib(eng)
            logits = []
            step = eng.steps.run

            def recorded(key, inputs, _step=step, _logits=logits):
                staged, outputs = _step(key, inputs)
                if key.kind == "prefill":
                    _logits.append((key, outputs["logits"].clone()))
                return staged, outputs

            eng.steps.run = recorded
            with torch.inference_mode():
                for prompt, params_ in requests:
                    eng._pending.append(engine_lib.GenerationRequest(prompt_tokens=prompt, sampling=params_))
                eng._admit()
                eng._harvest_prefills(block=True, every=True)
            firsts = [(slot.generated[0], slot.logprobs[0]) for slot in eng.slots if slot.active]
            eng.stop()
            rounds[name] = (pool, logits, firsts, eng.precompile_s)
            del eng, step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        model.MLP_ROWS = sliced_rows
    (_, one, one_firsts, _), (_, sliced, firsts, _), (_, eager, eager_firsts, _) = (
        rounds["one pass"], rounds["sliced"], rounds["sliced eager"])
    assert [key for key, _ in sliced] == [engine_lib.Variant("prefill", 1024, "", 32)], sliced
    assert [key for key, _ in one] == [key for key, _ in eager] == [key for key, _ in sliced]
    assert torch.equal(sliced[0][1], eager[0][1]) and firsts == eager_firsts and len(firsts) == 32
    assert bool(torch.isfinite(sliced[0][1]).all())
    to_one = errors(one[0][1], sliced[0][1])[1]
    assert to_one < MODEL_TOLERANCE, f"sliced MLP vs one pass: {to_one}"
    same_firsts = sum(a[0] == b[0] for a, b in zip(firsts, one_firsts))
    bitwise = torch.equal(one[0][1], sliced[0][1])
    log(f"MLP in slices of {sliced_rows} rows (Llama-3-8B width, 2 layers, 32 slots x 1024, the "
        f"prefill lattice captured): graph pool {rounds['one pass'][0]:.3f} GiB with the MLP in one "
        f"pass, {rounds['sliced'][0]:.3f} GiB sliced (precompile {rounds['one pass'][3]:.2f} vs "
        f"{rounds['sliced'][3]:.2f} s); one 32 x 1024 prefill call: sliced replay == sliced eager "
        f"bit for bit (logits, first tokens, logprobs); sliced vs one pass max_rel_err={to_one:.3e} "
        f"(tol {MODEL_TOLERANCE}; bit for bit: {bitwise}), {same_firsts}/32 first tokens equal")


def _reuse_engine(config, params, device, layout, kv_quant, **kwargs):
    return engine_lib.DecodeEngine(
        config, params, device=device, max_slots=4, max_seq_len=512, prefill_buckets=[64, 128, 256],
        kv_layout=layout, kv_block_size=16, kv_quant="int8" if kv_quant else None, **kwargs)


def _recorded_rounds(eng, rounds):
    """Each round's (prompt, session) submitted while the engine thread is
    stopped, then run to its end (greedy, 4 tokens). Returns the results
    and the logits of each round's last prefill model call."""
    logits = []
    step = eng.steps.run

    def recorded(key, inputs):
        staged, outputs = step(key, inputs)
        if key.kind in ("prefill", "prefill_offset"):
            logits.append(outputs["logits"].float().cpu().clone())
        return staged, outputs

    eng.steps.run = recorded
    results, last = [], []
    try:
        for make in rounds:
            prompt, session = make(results)
            future = concurrent.futures.Future()
            eng.submit(engine_lib.GenerationRequest(
                prompt_tokens=prompt, sampling=engine_lib.SamplingParams(max_new_tokens=4),
                session_id=session, future=future))
            eng.start()
            results.append(future.result(timeout=600))
            eng.stop()
            last.append(logits[-1])
    finally:
        eng.stop()
        del eng.steps.run
    return results, last


def check_reuse_logits(device, kv_quant: bool = False) -> None:
    """Llama-3-8B width, 2 layers, 4 slots, buckets 64/128/256, graphed, per
    layout: a 100-token prompt A with a session; its follow-up B, A's
    prompt and answer cut at 90 tokens (inside a 16-token block) and 30
    more, warm at offset 90 on A's pinned slot (paged: a copy-on-write of
    A's published boundary block); then C, sessionless, A's first 80
    tokens and 25 more (dense: a cross-slot copy of 80 rows; paged: a
    prefix-cache hit). The last-token logits of B's and C's prefill at an
    offset within MODEL_TOLERANCE of a cold prefill of the same prompt on
    an engine with the prefix cache off."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=512), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    rng = np.random.default_rng(17)
    prompt_a = rng.integers(0, config.vocab_size, size=100).tolist()
    more_b = rng.integers(0, config.vocab_size, size=30).tolist()
    prompt_c = prompt_a[:80] + rng.integers(0, config.vocab_size, size=25).tolist()
    rounds = [lambda done: (prompt_a, "s"),
              lambda done: ((prompt_a + done[0].tokens)[:90] + more_b, "s"),
              lambda done: (prompt_c, None)]
    cache = "int8" if kv_quant else "bf16"
    for layout in ("dense", "paged"):
        eng = _reuse_engine(config, params, device, layout, kv_quant)
        results, warm = _recorded_rounds(eng, rounds)
        prompts = [(prompt_a + results[0].tokens)[:90] + more_b, prompt_c]
        cold_eng = _reuse_engine(config, params, device, layout, kv_quant, prefix_cache=False)
        _, cold = _recorded_rounds(cold_eng, [lambda done, p=p: (p, None) for p in prompts])
        stats = dict(eng.stats, cow_copies=eng.kv_manager.stats["cow_copies"] if eng.paged else 0,
                     copies=eng.steps.stats["kinds"].get("copy" if layout == "dense" else "block_copy",
                                                         {}).get("replayed", 0))
        assert stats["session_hits"] == 1 and stats["prefix_hits"] >= 1, stats
        assert stats["copies"] >= 1 and (layout == "dense" or stats["cow_copies"] == 1), stats
        worst = [errors(mine, theirs)[1] for mine, theirs in zip(warm[1:], cold)]
        assert all(bool(torch.isfinite(x).all()) for x in warm)
        assert max(worst) < MODEL_TOLERANCE, f"{layout} {cache}: warm / copied vs cold logits {worst}"
        log(f"reuse reference ({layout}, {cache} KV cache, Llama-3-8B width, 2 layers): session "
            f"follow-up warm at offset 90 max_rel_err={worst[0]:.3e}, {'copied' if layout == 'dense' else 'prefix-hit'} "
            f"prefix of 80 max_rel_err={worst[1]:.3e} against a cold prefill (tol {MODEL_TOLERANCE}); "
            f"session_hits {stats['session_hits']}, prefix_hits {stats['prefix_hits']}, reused "
            f"{stats['prefix_tokens_reused']}, cow_copies {stats['cow_copies']}, "
            f"{'copy' if layout == 'dense' else 'block_copy'} replays {stats['copies']}")
        del eng, cold_eng
        gc.collect()
        torch.cuda.empty_cache()


def check_verify_model(device, kv_quant: bool = False) -> None:
    """Llama-3-8B width, 2 layers: after a 48-token prefill, one verify
    block of 1 + 4 tokens (``verify_step``, dense; ``paged_verify_step``,
    B3/B6 launched as a verify block) against the same five tokens fed by
    five decode steps (B2/B5; B3/B6) on a twin cache: the logits at each
    of the five positions within MODEL_TOLERANCE; the card counts the
    paged verify's launches, one per layer, in their own class."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=128), num_layers=2)
    params = model.init_params(config, seed=7, device=device)
    freqs = model.model_freqs(config, device=device)
    rng = np.random.default_rng(19)
    prompt = torch.from_numpy(rng.integers(0, config.vocab_size, size=(1, 48))).to(device)
    block = torch.from_numpy(rng.integers(0, config.vocab_size, size=(1, 5))).to(device)
    i32 = dict(dtype=torch.int32, device=device)
    tables = torch.arange(1, 9, **i32)[None]
    cache = "int8" if kv_quant else "bf16"
    name = "paged_attention_quant" if kv_quant else "paged_attention"
    worst = {}
    for layout in ("dense", "paged"):
        caches = []
        for _ in range(2):
            if layout == "dense":
                c = model.init_cache(config, 1, 128, kv_quant=kv_quant, device=device)
                model.prefill(config, params, c, prompt, torch.tensor([48], **i32),
                              torch.tensor([0], device=device), freqs)
            else:
                c = model.init_paged_cache(config, 9, 16, kv_quant=kv_quant, device=device)
                model.paged_prefill(config, params, c, prompt, torch.tensor([48], **i32), tables, freqs)
            caches.append(c)
        args = (block, torch.tensor([49], **i32), torch.tensor([5], **i32))
        with launches_lib.device_launches(shapes=True) as counted:
            if layout == "dense":
                verified = model.verify_step(config, params, caches[0], *args, freqs)
            else:
                verified = model.paged_verify_step(config, params, caches[0], *args, tables, freqs)
        steps = []
        for t in range(5):
            step_args = (block[:, t], torch.tensor([49 + t], **i32))
            if layout == "dense":
                steps.append(model.decode_step(config, params, caches[1], *step_args, freqs))
            else:
                steps.append(model.paged_decode_step(config, params, caches[1], *step_args, tables, freqs))
        stepped = torch.stack(steps, dim=1)
        assert verified.shape == stepped.shape and bool(torch.isfinite(verified).all())
        worst[layout] = errors(verified.float().cpu(), stepped.float().cpu())[1]
        assert worst[layout] < MODEL_TOLERANCE, f"{layout} {cache} verify vs decode steps: {worst}"
        if layout == "paged":
            assert counted[name] == counted[f"{name}/verify"] == config.num_layers, counted
            assert counted[f"{name}/prefill"] == 0, counted
    log(f"verify reference ({cache} KV cache, Llama-3-8B width, 2 layers): a 1 + 4 block against 5 "
        f"decode steps, max_rel_err dense (verify_step, plain attention) {worst['dense']:.3e}, paged "
        f"(paged_verify_step, {'B6' if kv_quant else 'B3'} counted as verify launches) "
        f"{worst['paged']:.3e} (tol {MODEL_TOLERANCE})")


def check_graph_pool(device) -> None:
    """Llama-3-8B width, 2 layers, 32 slots × 1024, dense bf16: the graph
    pool of the variants captured before this slice's (decode chunks,
    cold prefill at every group, at an offset at group 1, first tokens),
    then with this slice's added (prefill at an offset at every group,
    the prefix copies); and a spec engine's pool (spec chunks in place of
    decode chunks)."""
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=1024), num_layers=2)
    params = model.init_params(config, seed=8, device=device)
    pools = {}
    for spec in ("off", "ngram"):
        eng = engine_lib.DecodeEngine(config, params, device=device, max_slots=32, max_seq_len=1024,
                                      decode_chunk=8, spec_decode=spec)
        keys = sorted(eng._variant_keys(), key=lambda key: key.group * key.size, reverse=True)
        earlier = [key for key in keys if key.kind not in ("copy", "spec")
                   and (key.kind != "prefill_offset" or key.group == 1)]
        with torch.inference_mode():
            if spec == "off":
                for key in earlier:
                    eng.steps.prepare(key)
                pools["earlier"] = graph_pool_gib(eng)
            started = time.perf_counter()
            for key in keys:
                eng.steps.prepare(key)
            pools[spec] = (graph_pool_gib(eng), len(keys), time.perf_counter() - started)
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    log(f"graph pool (Llama-3-8B width, 2 layers, 32 slots x 1024, dense bf16): {pools['earlier']:.3f} GiB "
        f"with the variants of before this slice, {pools['off'][0]:.3f} GiB with its dense prefill at an "
        f"offset at every group and the prefix copies ({pools['off'][1]} variants); spec engine "
        f"{pools['ngram'][0]:.3f} GiB ({pools['ngram'][1]} variants, captured in {pools['ngram'][2]:.1f} s)")


# the paths of the top-K check: engine keys of each
TOPK_PATHS = {
    "dense": {},
    "paged": dict(kv_layout="paged", kv_block_size=16),
    "mixed": dict(kv_layout="paged", kv_block_size=16, prefill_mode="mixed", prefill_chunk=32),
    "verify dense": dict(spec_decode="ngram", spec_k=4),
    "verify paged": dict(kv_layout="paged", kv_block_size=16, spec_decode="ngram", spec_k=4),
}


def _serve_engine(eng, requests):
    """Every (prompt, new tokens) request submitted with the engine
    thread stopped, greedy, then run to its end; the results."""
    futures = []
    for prompt, new_tokens in requests:
        future = concurrent.futures.Future()
        eng.submit(engine_lib.GenerationRequest(
            prompt_tokens=prompt, sampling=engine_lib.SamplingParams(max_new_tokens=new_tokens),
            future=future))
        futures.append(future)
    try:
        eng.start()
        return [future.result(timeout=600) for future in futures]
    finally:
        eng.stop()


def compare_tops(card, cpu, tolerance: float):
    """The card's greedy results against the CPU's, token by token while
    their streams agree (up to and including the first token where they
    part: a near-tie the two devices' bf16 sums break differently; every
    step up to there saw the same tokens). Logprobs by rank within
    ``tolerance`` of max |CPU logprob|; ids equal, or, where the two
    devices rank differently, a near-tie: the card's id scores within the
    tolerance of the CPU's value at that rank on the CPU too (below the
    CPU's K-th value when it is not in the CPU's list). On each device the
    sampled token ranks first with its own logprob. Returns (positions,
    ids equal, ids, worst relative logprob error, worst absolute)."""
    positions = equal = total = 0
    worst_rel = worst_abs = 0.0
    for mine, ref in zip(card, cpu):
        assert mine.top_logprobs is not None and len(mine.top_logprobs) == len(mine.tokens)
        for j, ((ids, lps), (ref_ids, ref_lps)) in enumerate(zip(mine.top_logprobs, ref.top_logprobs)):
            for result, k in ((mine, ids), (ref, ref_ids)):
                assert k[0] == result.tokens[j], (j, k, result.tokens[j])
            assert ids[0] == mine.tokens[j] and abs(lps[0] - mine.logprobs[j]) <= 1e-5, (j, ids, lps)
            assert lps == sorted(lps, reverse=True) and lps[0] <= 0 and len(set(ids)) == len(ids)
            a, b = np.asarray(lps), np.asarray(ref_lps)
            scale = float(np.abs(b).max())
            diff = float(np.abs(a - b).max())
            worst_abs, worst_rel = max(worst_abs, diff), max(worst_rel, diff / scale)
            bound = tolerance * scale
            for rank, (got, want) in enumerate(zip(ids, ref_ids)):
                total += 1
                if got == want:
                    equal += 1
                    continue
                if got in ref_ids:
                    assert abs(ref_lps[ref_ids.index(got)] - lps[rank]) <= bound, (j, ids, ref_ids)
                else:
                    assert ref_lps[-1] >= lps[rank] - bound, (j, ids, lps, ref_ids, ref_lps)
            positions += 1
            if mine.tokens[j] != ref.tokens[j]:
                break
    assert worst_rel < tolerance, f"top-K logprobs on the card vs the CPU: {worst_rel}"
    return positions, equal, total, worst_rel, worst_abs


def check_top_logprobs(device, kv_quant: bool = False, config=None, layers: int = 2) -> None:
    """Top-K logprobs on each engine path at Llama-3-8B width cut to 2
    layers, over the bf16 or the int8 cache: an engine with
    ``logprobs_topk=5`` on the card (graph replays of the decode chunk,
    the mixed step, the spec chunk and the first-token sampling; B1/B2,
    B3, B7/B3, the verify block, and their int8 twins) against its twin
    on the CPU over the same weights, three greedy requests (one of them
    repeating, so the drafter drafts): :func:`compare_tops`."""
    config = dataclasses.replace(config or model.LlamaConfig.llama3_8b(max_seq_len=256),
                                 num_layers=layers)
    params = model.init_params(config, seed=7, device=device)
    cpu_params = {name: p.cpu() for name, p in params.items()}
    rng = np.random.default_rng(23)
    vocab = config.vocab_size
    requests = [(rng.integers(0, vocab, size=20).tolist(), 6),
                (rng.integers(0, vocab, size=12).tolist(), 6),
                (rng.integers(0, vocab, size=6).tolist() * 5, 8)]
    args = dict(max_slots=4, max_seq_len=256, prefill_buckets=[32], decode_chunk=4,
                logprobs_topk=5, kv_quant="int8" if kv_quant else None, seed=0)
    lines, started = [], time.perf_counter()
    for path, keys in TOPK_PATHS.items():
        card = _serve_engine(engine_lib.DecodeEngine(config, params, device=device, **args, **keys),
                             requests)
        cpu = _serve_engine(engine_lib.DecodeEngine(config, cpu_params, device="cpu", **args, **keys),
                            requests)
        positions, equal, total, rel, worst = compare_tops(card, cpu, MODEL_TOLERANCE)
        same = sum(a.tokens == b.tokens for a, b in zip(card, cpu))
        # the engines hold reference cycles (their thread, the runner's
        # bodies): collect them so the serving phases find the card empty
        gc.collect()
        torch.cuda.empty_cache()
        lines.append(f"{path} {positions} positions, ids {equal}/{total} equal, max_rel_err {rel:.3e} "
                     f"(max abs {worst:.3e}), streams equal {same}/{len(requests)}")
    log(f"top-K logprobs (K 5, {'int8' if kv_quant else 'bf16'} KV, Llama-3-8B width, {layers} layers), "
        f"card engine vs CPU engine, greedy, compared while the streams agree: " + "; ".join(lines)
        + f" (tol {MODEL_TOLERANCE}; a differing id must be a near-tie within it); "
        f"{time.perf_counter() - started:.1f}s")


def _bare_step(step, iters: int = 5) -> dict:
    """Wall and host-enqueue ms of ``step`` eager and as a CUDA graph of
    it replayed, and the graph's device ms: replays timed as
    :func:`time_ms` times a kernel, enqueued behind a sleep kernel, the
    host's share left out. An eager step is over a thousand launches; a
    sleep kernel cannot hold them all back (the host blocks once the
    launch queue is full), so the device time comes from the graph."""

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        started = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueued = time.perf_counter()
        torch.cuda.synchronize()
        finished = time.perf_counter()
        return (finished - started) / iters * 1e3, (enqueued - started) / iters * 1e3

    wall_ms, enqueue_ms = timed(step)
    graph = torch.cuda.CUDAGraph()
    with capture(graph):
        step()
    graph_wall_ms, graph_enqueue_ms = timed(graph.replay)
    device_ms = time_ms(graph.replay, warmup=2, iters=10)
    del graph
    return {"wall_ms": wall_ms, "enqueue_ms": enqueue_ms, "graph_wall_ms": graph_wall_ms,
            "graph_enqueue_ms": graph_enqueue_ms, "device_ms": device_ms}


def _bare_line(label: str, timing: dict) -> str:
    return (f"{label}: eager wall {timing['wall_ms']:.2f} ms, host enqueue {timing['enqueue_ms']:.2f} "
            f"ms; graphed wall {timing['graph_wall_ms']:.3f} ms, host enqueue "
            f"{timing['graph_enqueue_ms']:.3f} ms; device {timing['device_ms']:.3f} ms (graph replay "
            f"behind a sleep kernel); card busy {timing['device_ms'] / timing['wall_ms']:.0%} of the "
            f"eager step, {timing['device_ms'] / timing['graph_wall_ms']:.0%} of the graphed one")


def roofline_share(label: str, cost_flops: float, cost_bytes: float, device_ms: float) -> str:
    """The cost model's FLOPs and bytes for one graphed step over its
    device ms, as shares of the card's peaks: the roofline share of the
    step with no host gap in it."""
    mbu = cost_bytes / (device_ms / 1e3) / PEAK_BYTES
    mfu = cost_flops / (device_ms / 1e3) / PEAK_BF16_FLOPS
    assert 0 < mbu <= 1.05 and 0 < mfu <= 1.05, (label, mbu, mfu)
    return (f"{label}: cost model {cost_bytes / 1e9:.3f} GB and {cost_flops / 1e12:.3f} TFLOP over the "
            f"graph's device {device_ms:.3f} ms = MBU {mbu:.3f}, MFU {mfu:.4f} of the H100's peaks")


def time_decode_step(engine, live: int = 512) -> dict:
    """One decode step of the stopped engine's model (all slots at
    ``live`` rows), eager and graphed (:func:`_bare_step`)."""
    slots = engine.max_slots
    tokens = torch.zeros(slots, dtype=torch.long, device=engine.device)
    lengths = torch.full((slots,), live, dtype=torch.int32, device=engine.device)

    def step():
        model.decode_step(engine.config, engine.params, engine.cache, tokens, lengths, engine.freqs)

    timing = _bare_step(step)
    # every weight is read once per step except the embedding (a gather);
    # int8 weights count their scales
    weight_bytes = sum(p.nbytes for name, p in engine.params.items() if name != "embedding")
    timing["weight_bytes"] = weight_bytes
    cache = "int8" if engine.kv_quant else "bf16"
    weights = "int8" if isinstance(engine.params["wq"], QTensor) else "bf16"
    log(_bare_line(f"decode step (model only, {engine.config.num_layers} layers, {weights} weights, "
                   f"{cache} KV cache, {slots} slots x "
                   f"{live} live rows)", timing)
        + f", weight-read bound {weight_bytes / PEAK_BYTES * 1e3:.2f} ms ({weight_bytes / 1e9:.2f} GB)")
    # the engine's own cost model for this step: every slot reads its live
    # rows and writes one
    cost = engine.cost_model
    kv_tokens = slots * cost.kv_read_tokens(live)
    timing["cost_bytes"] = cost.decode_chunk_bytes(1, slots, kv_tokens)
    timing["cost_flops"] = cost.decode_chunk_flops(1, slots, kv_tokens)
    timing["mbu"] = timing["cost_bytes"] / (timing["device_ms"] / 1e3) / PEAK_BYTES
    log(roofline_share(f"bare decode step roofline ({weights} weights, {cache} KV cache)",
                       timing["cost_flops"], timing["cost_bytes"], timing["device_ms"]))
    return timing


def time_paged_steps(engine, live: int = 512) -> dict:
    """One paged decode step and one mixed step (64 wide, one row a
    64-token window, the others decoding) of the stopped engine's model,
    every slot at ``live`` rows over its own blocks, eager and graphed
    (:func:`_bare_step`). The mixed step runs its whole [S, 64] grid
    through the projections, as the JAX step does."""
    slots, width = engine.max_slots, 64
    device = engine.device
    blocks_per_row = (engine.num_blocks - 1) // slots
    tables = (torch.arange(slots * blocks_per_row, dtype=torch.int32, device=device) + 1).view(
        slots, blocks_per_row)[:, : engine.max_blocks].contiguous()
    tokens = torch.zeros((slots, width), dtype=torch.long, device=device)
    offsets = torch.full((slots,), live, dtype=torch.int32, device=device)
    num_tokens = torch.ones(slots, dtype=torch.int32, device=device)
    num_tokens[0] = width

    def decode():
        model.paged_decode_step(engine.config, engine.params, engine.cache, tokens[:, 0],
                                offsets + 1, tables, engine.freqs)

    def mixed():
        model.paged_mixed_step(engine.config, engine.params, engine.cache, tokens, offsets,
                               num_tokens, tables, engine.freqs)

    cache = "int8" if engine.kv_quant else "bf16"
    cost = engine.cost_model
    row_kv = cost.kv_read_tokens(live + 1)
    # the mixed step: row 0 a 64-token window at offset ``live``, the
    # others one decode token each
    costs = {"paged decode step": (cost.decode_chunk_flops(1, slots, slots * row_kv),
                                   cost.decode_chunk_bytes(1, slots, slots * row_kv)),
             "mixed step (W 64)": (
                 cost.mixed_step_flops(slots - 1, (slots - 1) * row_kv, [(live, width)]),
                 cost.mixed_step_bytes((slots - 1) * row_kv + cost.kv_read_tokens(live + width),
                                       slots - 1 + width))}
    timings = {}
    for label, step in (("paged decode step", decode), ("mixed step (W 64)", mixed)):
        timings[label] = _bare_step(step)
        log(_bare_line(f"{label} (model only, {cache} paged KV cache, {slots} slots x {live} live "
                       f"rows)", timings[label]))
        log(roofline_share(f"bare {label} roofline ({cache} paged KV cache)", *costs[label],
                           timings[label]["device_ms"]))
    hidden, inter = engine.config.hidden_size, engine.config.intermediate_size
    layer = hidden * engine.config.dims_per_head * (
        2 * engine.config.num_heads + 2 * engine.config.num_kv_heads) + 3 * hidden * inter
    flops = 2.0 * slots * width * (engine.config.num_layers * layer + hidden * engine.config.vocab_size / width)
    log(f"mixed step matmul FLOPs {flops:.3e} (all {slots} x {width} rows through every "
        f"projection): {flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at the bf16 peak")
    return timings


# the served presets' names in the log
MODEL_NAMES = {"llama-3-8b": "Llama-3-8B", "mixtral-8x7b": "Mixtral-8x7B"}
WORDS = ["stream", "token", "kernel", "batch", "event", "topic", "agent", "model",
         "cache", "device", "latency", "record", "gateway", "prompt", "answer"]
KERNELS = {
    "flash_prefill": flash_prefill_attention,
    "flash_decode": flash_decode_attention,
    "paged_attention": ragged_paged_attention,
    "flash_prefill_quant": flash_prefill_attention_quant,
    "flash_decode_quant": flash_decode_attention_quant,
    "paged_attention_quant": ragged_paged_attention_quant,
    "paged_attention_ragged_q": ragged_q_paged_attention,
    "paged_attention_ragged_q_quant": ragged_q_paged_attention_quant,
}


def prompt_text(rng, n_bytes: int) -> str:
    text = ""
    while len(text) < n_bytes:
        text += rng.choice(WORDS) + " "
    return text.strip()


def graph_pool_gib(engine):
    """GiB of the device segments in the engine's shared graph pool (None
    when eager, or where the allocator's snapshot does not name pools)."""
    if engine.steps.pool is None:
        return None
    pool = tuple(engine.steps.pool)
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == pool) / 2**30


def start_llama_server(*extra: str, kv_quant: bool = False, graphs: bool = True, engine_config=None,
                       layers=None, embeddings=None, slo=None, model_name: str = "llama-3-8b"):
    """``serve --model MODEL_NAME --precompile`` with these flags; ``kv_quant`` adds
    ``kv-quant: int8`` to the provider's engine config, the way a
    deployment asks for it, and ``engine_config`` its other keys (``serve``
    has no flag for either); ``layers`` cuts the model's depth (the
    in-turns controls); ``graphs=False`` builds the engine with eager
    dispatch (the control; no flag or key reaches that); ``embeddings``
    serves ``/v1/embeddings`` from that service; ``slo`` is the provider
    config's ``slo`` key (its p95 targets). The decode chunk
    is 8, not ``bench.py``'s 32: a chunk is chained only while every rider
    has two chunks of budget left, and at 32 no request of these bursts
    (32-62 tokens) would ever chain."""
    args = build_parser().parse_args([
        "serve", "--model", model_name, "--max-slots", "32", "--max-seq-len", "1024",
        "--decode-chunk", "8", "--precompile", "--host", "127.0.0.1", "--port", "0", *extra,
    ])
    config = serve_config(args)
    if kv_quant:
        config["engine"]["kv-quant"] = "int8"
    config["engine"].update(engine_config or {})
    if layers:
        config["model"]["num_layers"] = layers
    if slo:
        config["slo"] = slo
    t0 = time.perf_counter()
    service, server = start_server(args, config, step_graphs=graphs, embeddings=embeddings)
    engine = service.engine
    pool = graph_pool_gib(engine)
    kinds = engine.steps.stats["kinds"]

    def graphs_of(names):
        return (sum(kinds.get(kind, {}).get("captured", 0) for kind in names),
                sum(kinds.get(kind, {}).get("capture_s", 0.0) for kind in names))

    steps, step_s = graphs_of(("decode", "spec", "mixed", "copy", "block_copy"))
    prefill, prefill_s = graphs_of(engine_lib.PREFILL_KINDS)
    how = "captured as CUDA graphs" if engine.steps.graphed else "warmed eagerly"
    log(f"serve {' '.join(extra) or '(dense)'}{' kv-quant: int8' if kv_quant else ''}"
        f"{''.join(f' {key}: {value}' for key, value in (engine_config or {}).items())}"
        f"{f' at {layers} layers' if layers else ''}"
        f"{'' if graphs else ' EAGER (step_graphs=False)'}: {MODEL_NAMES.get(model_name, model_name)} "
        f"{args.quantization or 'bf16'} {'checkpoint' if args.checkpoint else 'random'} weights up in "
        f"{time.perf_counter() - t0:.1f}s (weights {service.load_s:.1f}s), "
        f"precompile {engine.precompile_s:.2f}s ({steps} step variants {how} in {step_s:.2f}s; "
        f"{prefill} prefill variants {how} in {prefill_s:.2f}s, by kind "
        f"{ {kind: kinds[kind]['captured'] for kind in engine_lib.PREFILL_KINDS if kind in kinds} }; "
        f"graph pool {'n/a' if pool is None else f'{pool:.3f} GiB'}); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; pipelined decode "
        f"{engine.pipeline_decode}, mixed carry {engine.mixed_carry}")
    return service, server


def scrape(server) -> dict:
    """``/metrics`` as {series (with its labels): value}; a histogram's
    ``_count`` lines included."""
    return scrape_url(f"http://127.0.0.1:{server.port}/metrics")


def scrape_url(url: str) -> dict:
    """A ``/metrics`` URL's series as {series (with its labels): value}."""
    with urllib.request.urlopen(url, timeout=60) as response:
        text = response.read().decode()
    out = {}
    for row in text.splitlines():
        if row and not row.startswith("#"):
            name, _, value = row.rpartition(" ")
            out[name] = float(value)
    return out


# the latency histograms whose counts a burst must raise by its requests
LATENCY_FAMILIES = ("torch_engine_ttft_seconds", "torch_engine_tpot_seconds",
                    "torch_engine_request_seconds")
BURSTS = [0]  # bursts run so far: each burst's trace ids are unique


def run_burst(service, server, jobs, warmup=(), profile_s: float = 0.0):
    """All jobs at once against the server: the main path's run. Returns
    the kernels' launches on the card during the burst, from their device
    counters (a replayed graph's kernels included), and the wrappers'
    counts of launches the host enqueued (eager calls: a replay runs no
    wrapper), both zeroed just before and read just after. The ``warmup`` jobs
    are answered one by one before that, uncounted. A graphed engine must
    capture nothing during the burst: every decode chunk, mixed step and
    prefill call is a replay of a graph ``precompile`` captured. The
    engine's prefill harvests are counted through a wrapper on its
    ``_harvest_prefills``: records emitted that were done when their
    harvest came ("ready") or that it waited for ("waited"), and harvests
    that left the oldest record in flight ("left"). Each job carries its
    own trace id (``stats["trace_ids"]``, in job order); ``/metrics`` is
    scraped after the burst (``stats["gauges"]``: the engine's MFU, MBU
    and prefill MFU of this burst alone, its stats reset before it) and
    the latency histograms' counts before and after it
    (``stats["histogram_counts"]``). ``profile_s`` > 0: one
    ``/debug/profile`` capture of that many seconds while the burst runs
    (``stats["profile"]``, its directory)."""
    url = f"http://127.0.0.1:{server.port}"
    BURSTS[0] += 1
    trace_ids = [f"burst{BURSTS[0]}-{i}" for i in range(len(jobs))]

    def post(job, trace_id=None):
        path, body = job
        headers = {"Content-Type": "application/json"}
        if trace_id:
            headers["x-langstream-trace-id"] = trace_id
        request = urllib.request.Request(url + path, data=json.dumps(body).encode(), headers=headers)
        with urllib.request.urlopen(request, timeout=600) as response:
            assert not trace_id or response.headers["x-langstream-trace-id"] == trace_id
            return response.read().decode()

    def profile():
        # once the burst is under way
        time.sleep(0.05)
        with urllib.request.urlopen(f"{url}/debug/profile?seconds={profile_s}", timeout=600) as response:
            return json.loads(response.read())["path"]

    for job in warmup:
        post(job)
    before = scrape(server)
    engine = service.engine
    # decode chunks dispatched off the previous chunk's carry, counted
    # through a wrapper on the engine instance (the JAX engine has no
    # stats key for them)
    chained = [0]
    dispatch = engine._dispatch_decode

    def counted(*args, **kwargs):
        chained[0] += kwargs.get("carry") is not None
        return dispatch(*args, **kwargs)

    engine._dispatch_decode = counted
    harvests = {"ready": 0, "waited": 0, "left": 0}
    harvest = engine._harvest_prefills

    def harvest_counted(block=False, every=False):
        done = [record["out"][1] is None or record["out"][1].query()
                for record in engine._prefill_inflight]
        harvest(block=block, every=every)
        taken = len(done) - len(engine._prefill_inflight)
        for ready in done[:taken]:  # each record found done or waited for
            harvests["ready" if ready else "waited"] += 1
        if done and not taken:
            harvests["left"] += 1

    engine._harvest_prefills = harvest_counted
    engine.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    runner = dict(engine.steps.stats)
    replays = {kind: kind_stats["replayed"] for kind, kind_stats in runner["kinds"].items()}
    try:
        with launches_lib.device_launches(shapes=True) as launches:
            started = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
                captured = pool.submit(profile) if profile_s else None
                replies = list(pool.map(post, jobs, trace_ids))
                wall = time.perf_counter() - started
                profiled = captured.result() if captured else None
    finally:
        del engine._dispatch_decode  # the class's methods again
        del engine._harvest_prefills
    after = scrape(server)
    host = {name: wrapper.launches for name, wrapper in KERNELS.items()}
    by_kind = {kind: kind_stats["replayed"] - replays.get(kind, 0)
               for kind, kind_stats in engine.steps.stats["kinds"].items()}
    stats = dict(engine.stats, chained_decode_chunks=chained[0], graphed=engine.steps.graphed,
                 step_runs=engine.steps.stats["replayed"] - runner["replayed"],
                 step_captures=engine.steps.stats["captured"] - runner["captured"],
                 runs_by_kind={kind: n for kind, n in by_kind.items() if n}, harvests=harvests,
                 trace_ids=trace_ids, gauges=after, profile=profiled,
                 histogram_counts={family: after[f"{family}_count"] - before[f"{family}_count"]
                                   for family in LATENCY_FAMILIES})
    # every prefill model call went through the runner, a replay when graphed
    calls = engine.stats["model_dispatches"]
    prefill_calls = sum(n for name, n in calls.items() if "prefill" in name)
    assert by_kind.get("prefill", 0) + by_kind.get("prefill_offset", 0) == prefill_calls, (by_kind, calls)
    records = engine.stats["prefill_calls"] + engine.stats["warm_prefill_calls"]
    assert engine.mixed or by_kind.get("first_token", 0) == records, (by_kind, engine.stats)
    if engine.steps.graphed:
        assert stats["step_captures"] == 0, "a step variant was captured while serving"
        assert stats["step_runs"] > 0 and all(
            entry.graph is not None for entry in engine.steps._entries.values())
    return replies, wall, launches, host, stats, torch.cuda.max_memory_allocated() / 2**30


def completion_counts(jobs, replies):
    """Each reply's completion tokens (a stream's from its final frame)."""
    counts = []
    for (_, body), raw in zip(jobs, replies):
        if body.get("stream"):
            frames = [f[len("data: "):] for f in raw.split("\n\n") if f.startswith("data: ")]
            counts.append(json.loads(frames[-2])["usage"]["completion_tokens"])
        else:
            counts.append(json.loads(raw)["usage"]["completion_tokens"])
    return counts


def check_histograms(label, kind, jobs, replies, stats) -> None:
    """The burst raised the TTFT and request-seconds histograms' counts by
    exactly its requests, and TPOT's by those with more than one token
    (a one-token answer has no inter-token gap)."""
    counts = stats["histogram_counts"]
    multi = sum(n > 1 for n in completion_counts(jobs, replies))
    want = {"torch_engine_ttft_seconds": len(jobs), "torch_engine_request_seconds": len(jobs),
            "torch_engine_tpot_seconds": multi}
    assert counts == want, (counts, want)
    log(f"latency histograms [{label}] {kind}: _count rose by {counts} for {len(jobs)} requests answered "
        f"({multi} of more than one token)")


def check_roofline(label, kind, stats, tok_s, ttft_ms, prefill: bool = True) -> dict:
    """The burst's cumulative MFU, MBU and prefill MFU from ``/metrics``
    (the cost model's modeled work over busy decode time and prefill
    time, against the H100's peaks), printed beside its tok/s and TTFT,
    each in (0, 1.05]. ``prefill`` False: a mixed burst, whose prompts
    ride the mixed steps (their work is in MFU) and make no prefill call."""
    gauges = stats["gauges"]
    names = ["torch_engine_mfu", "torch_engine_mbu"] + (["torch_engine_prefill_mfu"] if prefill else [])
    shares = {name[len("torch_engine_"):]: gauges[name] for name in names}
    assert all(0 < value <= 1.05 for value in shares.values()), (kind, shares)
    # the serving engine's own counters, beside /metrics' sum over every
    # engine of the process (a stopped engine counts there until collected)
    own = (stats["decode_flops"] / stats["decode_time"] / PEAK_BF16_FLOPS,
           stats["decode_bytes"] / stats["decode_time"] / PEAK_BYTES)
    log(f"roofline [{label}] {kind}: " + ", ".join(f"{name} {value:.4f}" for name, value in shares.items())
        + f" (the engine's own: mfu {own[0]:.4f}, mbu {own[1]:.4f})"
        + ("" if prefill else ", prefill_mfu n/a (no prefill call: windows ride the mixed steps)")
        + f" of the H100's peaks ({PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {PEAK_BYTES / 1e12:.2f} TB/s); "
        f"goodput {gauges.get('torch_engine_goodput_ratio')}, slot occupancy "
        f"{gauges.get('torch_engine_slot_occupancy')}; {tok_s:.1f} tok/s, mean TTFT {ttft_ms:.1f} ms")
    return shares


def artifact_journeys(trace_ids) -> dict:
    """The flight artifact's ``journey`` records of these trace ids."""
    flight.flush()
    wanted = set(trace_ids)
    return {record["trace_id"]: record for record in flight.read_artifact(flight.RECORDER.path)
            if record.get("kind") == "journey" and record.get("trace_id") in wanted}


def check_journeys(label, kind, trace_ids, imported: bool = False) -> dict:
    """Every request's journey is in the flight artifact and tiles its
    request: no negative or overlapping stage, and the stages cover the
    wall from submit to finish (a leg with a handoff import, the JAX
    ledger's invariant: at least 95%, the import's end to the admission
    uncovered); the port's ``journey`` subcommand renders them."""
    records = artifact_journeys(trace_ids)
    assert set(records) == set(trace_ids), sorted(set(trace_ids) - set(records))
    for record in records.values():
        leg = journey_lib.Journey(record["trace_id"])
        leg.add(record)
        assert not leg.overlaps() and not leg.negatives() and not leg.missing_stages(), record
        assert leg.coverage() >= (0.95 if imported else 1 - 1e-6), (leg.coverage(), record)
    rendered = io.StringIO()
    with contextlib.redirect_stdout(rendered):
        cli_main(["journey", flight.RECORDER.path, "--trace-id", trace_ids[0]])
    lines = rendered.getvalue().splitlines()
    assert lines[0].startswith("1 journey(s)") and lines[1].startswith(trace_ids[0]), lines[:2]
    classes = {}
    for record in records.values():
        classes[record["admit_class"]] = classes.get(record["admit_class"], 0) + 1
    log(f"journeys [{label}] {kind}: {len(records)} in the flight artifact, each tiling its request; "
        f"admission classes {classes}; `journey --trace-id {trace_ids[0]}`: " + " | ".join(
            line.strip() for line in lines[1:]))
    return records


def profile_shares(label, directory: str) -> None:
    """The kernels' shares of the card's time in a ``/debug/profile``
    capture (shares, never counts: a busy trace can drop kernel records):
    the trace must hold B1 or B2 kernel events."""
    with open(os.path.join(directory, "trace.json")) as handle:
        events = json.load(handle)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    total = sum(e["dur"] for e in kernels)
    by_name = {}
    for e in kernels:
        name = e["name"]
        short = next((k for k in ("flash_prefill", "flash_decode") if k in name), name[:60])
        by_name[short] = by_name.get(short, 0.0) + e["dur"]
    categories = {}
    for e in events:
        categories[e.get("cat")] = categories.get(e.get("cat"), 0) + 1
    assert any(k in by_name for k in ("flash_prefill", "flash_decode")), (sorted(by_name)[:20], categories)
    with open(os.path.join(directory, "device_memory.json")) as handle:
        memory = json.load(handle)["devices"][0]["memory_stats"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"/debug/profile [{label}]: {len(kernels)} kernel events, {total / 1e3:.1f} ms of kernel time in the "
        f"window; B1 flash_prefill {by_name.get('flash_prefill', 0.0) / total:.1%}, B2 flash_decode "
        f"{by_name.get('flash_decode', 0.0) / total:.1%} of it; top: "
        + ", ".join(f"{name} {t / total:.1%}" for name, t in top)
        + f"; device memory at the capture {memory.get('allocated_bytes.all.current', 0) / 2**30:.2f} GiB "
        f"allocated, peak {memory.get('allocated_bytes.all.peak', 0) / 2**30:.2f} GiB")


def check_replies(jobs, replies) -> int:
    """Every reply complete (its max_tokens, or stopped) and the stream
    (the last job) ended by [DONE]; returns the completion tokens."""
    tokens = 0
    for (path, body), raw in zip(jobs[:-1], replies[:-1]):
        reply = json.loads(raw)
        choice = reply["choices"][0]
        got = reply["usage"]["completion_tokens"]
        assert got == body["max_tokens"] or choice["finish_reason"] == "stop", (path, got, choice)
        assert ("message" in choice) == path.endswith("chat/completions")
        tokens += got
    frames = [f[len("data: "):] for f in replies[-1].split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "[DONE]", "the SSE stream must end with [DONE]"
    final = json.loads(frames[-2])
    streamed = final["usage"]["completion_tokens"]
    assert streamed == jobs[-1][1]["max_tokens"] or final["choices"][0]["finish_reason"] == "stop"
    return tokens + streamed


def report(label, kind, jobs, wall, tokens, stats, launches, host, peak_gib) -> None:
    requests = stats["requests"]
    mixed, plain = stats["mixed_steps"], stats["decode_steps"] - stats["mixed_steps"]
    plain_time = stats["decode_time"] - stats["mixed_time"]
    log(f"serving {kind} [{label}]: {requests} requests, {tokens} completion tokens in {wall:.3f}s "
        f"= {tokens / wall:.1f} tok/s; mean TTFT {stats['ttft_time'] / requests * 1e3:.1f} ms "
        f"(engine submit → first token); prefill calls {stats['prefill_calls']} + warm "
        f"{stats['warm_prefill_calls']} ({stats['prefill_time']:.3f}s in prefill calls, "
        f"{stats['mixed_admit_time']:.3f}s summed admission → first token of mixed-step "
        f"prompts), decode steps "
        f"{stats['decode_steps']} ({stats['decode_time']:.3f}s): plain {plain} "
        f"({plain_time:.3f}s, {plain_time / max(plain, 1) * 1e3:.1f} ms/step), mixed {mixed} "
        f"({stats['mixed_time']:.3f}s, {stats['mixed_time'] / max(mixed, 1) * 1e3:.1f} ms/step); "
        f"prefix hits {stats['prefix_hits']}, "
        f"reused tokens {stats['prefix_tokens_reused']}; model calls {stats['model_dispatches']}; "
        f"chained decode chunks {stats['chained_decode_chunks']}, chained mixed steps "
        f"{stats['mixed_steps_chained']}, carry invalidations {stats['mixed_carry_invalidations']}; "
        f"step {'graphs replayed' if stats['graphed'] else 'bodies run eagerly'} {stats['step_runs']} "
        f"(by kind {stats['runs_by_kind']}), captured {stats['step_captures']}; prefill harvests "
        f"{stats['harvests']}; peak memory {peak_gib:.2f} GiB allocated (a replay "
        f"allocates nothing: the graph pool is apart); launches on the card {launches}, of them "
        f"enqueued eagerly {host}")
    assert requests == len(jobs), (requests, len(jobs))


def dense_jobs(rng):
    """The dense burst: 8 chats and 8 text completions of 32-62 tokens
    (every fourth sampled with a seed, the rest greedy), then one SSE
    chat."""
    jobs = []
    for i in range(16):
        body = {"max_tokens": int(32 + 2 * i)}
        if i % 4 == 3:
            body.update(temperature=0.8, top_p=0.9, seed=i)
        if i % 2 == 0:
            jobs.append(("/v1/chat/completions", dict(
                body, messages=[{"role": "user", "content": prompt_text(rng, 100 + 12 * i)}])))
        else:
            jobs.append(("/v1/completions", dict(body, prompt=prompt_text(rng, 100 + 12 * i))))
    jobs.append(("/v1/chat/completions", {
        "messages": [{"role": "user", "content": prompt_text(rng, 180)}],
        "max_tokens": 48, "stream": True}))
    return jobs


def serve_dense_and_check(label: str, kv_quant: bool = False, extra=(), graphs: bool = True,
                          join: bool = True, layers=None, crash: bool = False,
                          model_name: str = "llama-3-8b") -> dict:
    """The dense burst through ``serve`` with ``extra`` flags (pipelined
    unless ``--no-pipeline-decode``; ``--quantization int8`` for int8
    weights; ``graphs=False``: the eager control; ``join=False``: the
    engine's ``join_prefills`` off, the JAX engine's harvest; ``layers``:
    the model cut to that depth, for the in-turns controls): B1/B2
    (B4/B5 over the int8 cache) once per layer per model call, no other
    kernel, and chained decode chunks when pipelined. Returns the
    launches, tok/s and mean TTFT of both bursts, and the bare decode
    step's timing. ``crash``: then the crash phase on the same server
    (:func:`serve_crash_and_check`), its served peak from the server's
    start on. ``model_name``: the preset served (``--model``)."""
    torch.cuda.reset_peak_memory_stats()
    service, server = start_llama_server(*extra, kv_quant=kv_quant, graphs=graphs, layers=layers,
                                         model_name=model_name)
    start_peak = torch.cuda.max_memory_allocated() / 2**30
    service.engine.join_prefills = join  # before any request reaches the engine
    rng = np.random.default_rng(0)
    jobs = dense_jobs(rng)
    # then 31 text completions and one SSE chat, all of 64 tokens: with
    # equal budgets every rider keeps two chunks of budget long enough for
    # the pipelined engine to chain (the burst above, of 32-62 tokens,
    # mostly does not allow it)
    uniform = [("/v1/completions", {"prompt": prompt_text(rng, 150 + 4 * i), "max_tokens": 64})
               for i in range(31)]
    uniform.append(("/v1/chat/completions", {
        "messages": [{"role": "user", "content": prompt_text(rng, 180)}],
        "max_tokens": 64, "stream": True}))
    try:
        replies, wall, launches, host, stats, peak_gib = run_burst(service, server, jobs)
        (uniform_replies, uniform_wall, uniform_launches, uniform_host, uniform_stats,
         uniform_peak) = run_burst(service, server, uniform)
        if crash:
            # the main path's full-depth phase: the mixed-length burst's
            # journeys
            check_journeys(label, "dense", stats["trace_ids"])
            serve_crash_and_check(label, service, server, max(start_peak, peak_gib, uniform_peak))
    finally:
        server.stop()
        service.close()
    timing = time_decode_step(service.engine)
    tokens = check_replies(jobs, replies)
    layers = service.engine.config.num_layers
    calls = stats["model_dispatches"]
    prefill, decode = (
        ("flash_prefill_quant", "flash_decode_quant") if kv_quant else ("flash_prefill", "flash_decode"))
    assert launches[prefill] > 0 and launches[decode] > 0, launches
    assert launches[prefill] == layers * calls.get("prefill", 0), (launches, calls)
    assert launches[decode] == layers * calls.get("decode_step", 0), (launches, calls)
    others = [name for name in KERNELS if name not in (prefill, decode)]
    assert all(launches[name] == 0 for name in others), launches
    # every prefill call and decode chunk a replay; eagerly enqueued only
    # in the eager control
    assert host == ({name: launches[name] for name in KERNELS} if not graphs
                    else dict.fromkeys(KERNELS, 0)), (host, launches)
    assert not any(launches[name] for name in launches_lib.SHAPES), launches
    preset = model.LlamaConfig.from_dict({"preset": model_name})
    kind = " ".join(([] if model_name == "llama-3-8b" else [MODEL_NAMES.get(model_name, model_name)])
                    + ["dense"] + [flag.lstrip("-") for flag in extra] + (["int8 KV"] if kv_quant else [])
                    + ([] if graphs else ["EAGER"]) + ([] if join else ["JAX harvest"])
                    + ([f"{layers} layers"] if layers != preset.num_layers else []))
    report(label, kind, jobs, wall, tokens, stats, launches, host, peak_gib)
    check_histograms(label, kind, jobs, replies, stats)
    roofline = check_roofline(label, kind, stats, tokens / wall,
                              stats["ttft_time"] / stats["requests"] * 1e3)
    uniform_tokens = check_replies(uniform, uniform_replies)
    report(label, kind + ", uniform 64-token burst", uniform, uniform_wall, uniform_tokens,
           uniform_stats, uniform_launches, uniform_host, uniform_peak)
    uniform_roofline = check_roofline(label, kind + ", uniform 64-token burst", uniform_stats,
                                      uniform_tokens / uniform_wall,
                                      uniform_stats["ttft_time"] / uniform_stats["requests"] * 1e3)
    chained = stats["chained_decode_chunks"] + uniform_stats["chained_decode_chunks"]
    if service.engine.pipeline_decode:
        assert uniform_stats["chained_decode_chunks"] > 0, uniform_stats
    else:
        assert chained == 0, (stats, uniform_stats)
    return dict(launches, timing=timing, peak_gib=peak_gib, tok_s=tokens / wall,
                roofline=roofline, uniform_roofline=uniform_roofline,
                load_s=service.load_s, texts=_answered(jobs[:-1], replies[:-1])[1],
                uniform_tok_s=uniform_tokens / uniform_wall,
                ttft_ms=stats["ttft_time"] / stats["requests"] * 1e3,
                uniform_ttft_ms=uniform_stats["ttft_time"] / uniform_stats["requests"] * 1e3)


# the crash phase's fault: the engine thread dies after this many decode
# chunks of the burst are processed (every session admitted by then has
# emitted tokens: the 16 share the first chunk)
CRASH_STEP = 2


def crash_jobs(rng):
    """The dense burst's 16 completions for the crash phase: every fourth
    seeded at temperature 0.8 with presence and frequency penalties, and
    four of the chats streamed (SSE)."""
    jobs = dense_jobs(rng)[:-1]
    for i, (path, body) in enumerate(jobs):
        if i % 4 == 3:
            body.update(presence_penalty=0.5, frequency_penalty=0.3)
        if i % 4 == 0:
            body["stream"] = True
    return jobs


def _post_status(server, path, body):
    """(status, headers, body text) of one request, errors included."""
    request = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=600) as response:
            return response.status, dict(response.headers), response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, dict(error.headers), error.read().decode()


def _reply_text(raw: str, stream: bool):
    """A reply's text, completion tokens and finish reason; a stream's text
    is its deltas joined, and it must end with [DONE]."""
    if not stream:
        reply = json.loads(raw)
        choice = reply["choices"][0]
        return (choice["message"]["content"] if "message" in choice else choice["text"],
                reply["usage"]["completion_tokens"], choice["finish_reason"])
    frames = [f[len("data: "):] for f in raw.split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "[DONE]", "the SSE stream must end with [DONE]"
    text = ""
    for frame in frames[:-2]:
        choice = json.loads(frame)["choices"][0]
        text += choice.get("delta", {}).get("content", "") or choice.get("text", "")
    final = json.loads(frames[-2])
    return text, final["usage"]["completion_tokens"], final["choices"][0]["finish_reason"]


def serve_crash_and_check(label: str, service, server, served_peak_gib: float) -> None:
    """The crash phase, on the full-depth dense server (supervisor and
    watchdog at their defaults): :func:`crash_jobs` answered once
    uncrashed, then again with ``engine_thread_crash@step=CRASH_STEP``
    armed, and one request posted while the supervisor rebuilds (from
    inside the rebuild, so it lands in the window). Gates: one restart,
    serving again; every request 200 but the one in the window, 503 with
    Retry-After; each SSE stream's deltas the decode of exactly the token
    ids streamed to it, as many as its usage counts; every live session
    at the crash resurrected (at least 8 of them with emitted tokens);
    crash-replay tokens booked; B1 and B2 launched after the rebuilt
    engine's precompile, by their card counters; nothing captured after
    it; the allocated memory after within 0.5 GiB of that at the crash,
    and the peak from the crash on at most the served peak plus the dead
    engine's KV cache. Printed: recovery seconds, the memory, the streams
    equal to the uncrashed run's (not gated: a bf16 replay prefill writes
    rows a decode step wrote before)."""
    from langstream_tpu_torch.runtime import faults
    from langstream_tpu_torch.runtime import supervisor as supervisor_lib

    rng = np.random.default_rng(1)
    jobs = crash_jobs(rng)
    sup = service.supervisor
    first = service.engine
    assert sup is not None and sup.restarts == 0 and sup.watchdog is not None
    twin = _post_all(server, jobs)
    gc.collect()  # what is allocated at the crash is then the server's own
    # each stream's token ids as the server pushed them to its decoder
    pushed = []
    stream_decoder = service.tokenizer.stream_decoder

    def recording_decoder():
        decoder = stream_decoder()
        ids = []
        pushed.append(ids)
        push = decoder.push

        def record(token_id):
            ids.append(int(token_id))
            return push(token_id)

        decoder.push = record
        return decoder

    info = {}
    drain = first.drain_for_recovery

    def drained():
        requests = drain()
        info.update(live=len(requests), replayed=sum(1 for r in requests if r.replay_tokens),
                    before_gib=torch.cuda.memory_allocated() / 2**30,
                    kv_gib=sum(t.numel() * t.element_size() for t in first.cache.values()) / 2**30)
        torch.cuda.reset_peak_memory_stats()
        return requests

    factory = sup.factory

    def rebuild():
        info["window"] = _post_status(server, "/v1/completions", {"prompt": "in the window",
                                                                  "max_tokens": 4})
        started = time.perf_counter()
        engine = factory()
        info["factory_s"] = time.perf_counter() - started
        info["precompile_s"] = engine.precompile_s
        info["launches"] = launches_lib.read(shapes=True)
        info["captured"] = engine.steps.stats["captured"]
        return engine

    resurrected = supervisor_lib.SESSIONS_RESURRECTED.value()
    first.drain_for_recovery = drained
    sup.factory = rebuild
    service.tokenizer.stream_decoder = recording_decoder
    faults.configure(f"engine_thread_crash@step={CRASH_STEP}")
    try:
        with launches_lib.device_launches(shapes=True) as launches:
            started = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
                replies = list(pool.map(lambda job: _post_status(server, *job), jobs))
            wall = time.perf_counter() - started
    finally:
        faults.reset()
        sup.factory = factory
        del service.tokenizer.stream_decoder
    gc.collect()
    engine = service.engine
    after_gib = torch.cuda.memory_allocated() / 2**30
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    status, headers, raw = info["window"]
    same = tokens = 0
    for (path, body), (code, _, reply), twin_raw in zip(jobs, replies, twin):
        if code == 200:
            text, got, _ = _reply_text(reply, body.get("stream", False))
            tokens += got
            same += text == _reply_text(twin_raw, body.get("stream", False))[0]
    after = {name: launches[name] - info["launches"][name] for name in launches}
    log(f"crash [{label}]: engine_thread_crash@step={CRASH_STEP} with {info['live']} live sessions "
        f"({info['replayed']} with emitted tokens), recovered in {sup.last_recovery_s:.3f}s (the factory "
        f"{info['factory_s']:.3f}s, its precompile {info['precompile_s']:.3f}s; restarts {sup.restarts}, "
        f"state {sup.state}); {len(jobs)} requests answered {sorted(code for code, _, _ in replies)} in "
        f"{wall:.3f}s ({tokens} completion tokens), the one in the rebuild window {status} with "
        f"Retry-After {headers.get('Retry-After')}; crash-replay tokens "
        f"{engine.stats['tokens_wasted'].get('crash_replay')}; launches after the rebuilt engine's "
        f"precompile {after}; allocated {info['before_gib']:.2f} GiB at the crash, peak {peak_gib:.2f} GiB "
        f"during the rebuild (served peak {served_peak_gib:.2f}, dead engine's KV "
        f"{info['kv_gib']:.2f}), {after_gib:.2f} GiB after; {same}/{len(jobs)} streams equal to the "
        f"uncrashed run's (printed, not gated: bf16 replay prefill over decode-written KV)")
    assert sup.restarts == 1 and sup.state == "serving" and engine is not first, (sup.restarts, sup.state)
    assert status == 503 and int(headers["Retry-After"]) >= 1, (status, headers, raw)
    for (path, body), (code, _, reply) in zip(jobs, replies):
        assert code == 200, (path, code, reply)
        text, got, finish = _reply_text(reply, body.get("stream", False))
        assert got == body["max_tokens"] or finish == "stop", (path, got, finish)
        if body.get("stream"):
            matches = [ids for ids in pushed if service.tokenizer.decode(ids) == text]
            assert any(len(ids) == got for ids in matches), (text, got, [len(ids) for ids in pushed])
    assert len(pushed) == sum(bool(body.get("stream")) for _, body in jobs), len(pushed)
    assert supervisor_lib.SESSIONS_RESURRECTED.value() - resurrected == info["live"], info
    assert info["replayed"] >= 8, info
    assert engine.stats["tokens_wasted"].get("crash_replay", 0) > 0, engine.stats["tokens_wasted"]
    assert after["flash_prefill"] > 0 and after["flash_decode"] > 0, after
    assert engine.steps.stats["captured"] == info["captured"], "a variant was captured after the rebuild"
    assert abs(after_gib - info["before_gib"]) <= 0.5, (after_gib, info)
    assert peak_gib <= served_peak_gib + info["kv_gib"], (peak_gib, served_peak_gib, info)


def serve_watchdog_and_check(label: str) -> None:
    """Watchdog escalation at ``RECOVERY_LAYERS``: the watchdog's
    thresholds cut short through the provider config, and
    ``stuck_step@step=3;dur=14`` wedging the third decode dispatch of a
    16-request burst. The watchdog trips, escalates, and the supervisor
    condemns the engine; its thread outlives the 10 s join and wakes
    while the rebuilt engine captures its graphs. Gates: the trips reach
    ``escalate-trips``; one restart; every live session resurrected and
    every request answered 200; the condemned engine emits nothing after
    its drain and its thread ends."""
    from langstream_tpu_torch.runtime import faults

    settings = {"interval": 0.1, "no-progress-s": 1.0, "trip-cooldown-s": 0.3, "escalate-trips": 2,
                "escalate-window-s": 120, "capture-seconds": 1.0}
    service, server = start_llama_server(engine_config={"watchdog": settings}, layers=RECOVERY_LAYERS)
    captures = os.environ.get("LANGSTREAM_PROFILE_DIR", "")
    before = set(os.listdir(captures)) if os.path.isdir(captures) else set()
    sup = service.supervisor
    first, dog = service.engine, sup.watchdog
    rng = np.random.default_rng(2)
    jobs = [("/v1/completions", {"prompt": prompt_text(rng, 120 + 8 * i), "max_tokens": 48})
            for i in range(16)]
    info = {}
    drain = first.drain_for_recovery

    def drained():
        requests = drain()
        info.update(live=len(requests), generated=first.stats["tokens_generated"])
        return requests

    first.drain_for_recovery = drained
    faults.configure("stuck_step@step=3;dur=14")
    try:
        started = time.perf_counter()
        replies = _post_all(server, jobs)
        wall = time.perf_counter() - started
        zombie = first._thread
        if zombie is not None:
            zombie.join(timeout=60)
        assert zombie is None or not zombie.is_alive(), "the condemned engine thread did not end"
        assert first.stats["tokens_generated"] == info["generated"], "the condemned engine emitted"
        tokens, _ = _answered(jobs, replies)
        assert dog.trips >= settings["escalate-trips"], dog.trips
        assert sup.restarts == 1 and sup.state == "serving", (sup.restarts, sup.state)
        assert info["live"] == len(jobs), info
        # the trip's torch.profiler capture (printed, not gated)
        new = sorted(set(os.listdir(captures)) - before) if os.path.isdir(captures) else []
        traces = [os.path.join(captures, name, "trace.json") for name in new]
        sizes = [os.path.getsize(path) for path in traces if os.path.exists(path)]
        log(f"watchdog [{label}]: {RECOVERY_LAYERS} layers, stuck_step@step=3;dur=14, watchdog {settings}: "
            f"{dog.trips} trips, escalated, rebuilt in {sup.last_recovery_s:.3f}s; {info['live']} live "
            f"sessions resurrected, {len(jobs)} requests answered in {wall:.3f}s ({tokens} completion "
            f"tokens); the condemned engine emitted nothing after its drain and its thread ended; "
            f"the trip's profiler capture: {len(new)} directories, Chrome traces of {sizes} bytes")
    finally:
        faults.reset()
        server.stop()
        service.close()


def serve_shedding_and_check(label: str) -> None:
    """Load shedding at ``RECOVERY_LAYERS``: ``--queue-timeout-s 0.25``
    against 96 concurrent completions of 64 tokens on 32 slots, with the
    SLO ``SHEDDING_SLO`` (1 ms p95 TTFT and TPOT, which every answered
    request breaks). Gates: at least one request shed; each shed request
    answered 503 with Retry-After, every other 200;
    ``requests_shed_total{reason="queue_timeout"}`` on ``/metrics`` equal
    to the 503s; the TTFT burn rate over 5 minutes above 1, and blame
    booked by journey stage, ``queue`` among the stages. Then, on the same
    server (``--profile-kernels``: the first profiler of the process, so
    it runs before the watchdog's capture), one ``/debug/profile``
    capture during a dense burst (:func:`profile_shares`)."""
    service, server = start_llama_server("--queue-timeout-s", "0.25", "--profile-kernels",
                                         layers=RECOVERY_LAYERS, slo=SHEDDING_SLO)
    rng = np.random.default_rng(3)
    jobs = [("/v1/completions", {"prompt": prompt_text(rng, 100 + 2 * i), "max_tokens": 64})
            for i in range(96)]
    try:
        started = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            replies = list(pool.map(lambda job: _post_status(server, *job), jobs))
        wall = time.perf_counter() - started
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=60) as response:
            exposition = response.read().decode()
        # then, uncounted, a dense burst of 32 completions of 192 tokens
        # with one /debug/profile capture while it runs (the server primed
        # the profiler at start: --profile-kernels). The capture's start
        # stalls the engine for longer than the queue deadline, so the
        # deadline is lifted for this burst
        service.engine.queue_timeout_s = None
        busy = [("/v1/completions", {"prompt": prompt_text(rng, 120 + 2 * i), "max_tokens": 192})
                for i in range(32)]
        profiled = run_burst(service, server, busy, profile_s=1.0)[4]["profile"]
    finally:
        server.stop()
        service.close()
    profile_shares(label, profiled)
    shed = [reply for reply in replies if reply[0] == 503]
    served = [reply for reply in replies if reply[0] == 200]
    assert shed and len(shed) + len(served) == len(jobs), [reply[0] for reply in replies]
    assert all(int(headers["Retry-After"]) >= 1 and "queue timeout" in raw for _, headers, raw in shed)
    line = 'requests_shed_total{reason="queue_timeout"} '
    exposed = [float(row[len(line):]) for row in exposition.splitlines() if row.startswith(line)]
    assert exposed == [float(len(shed))], (exposed, len(shed))
    retry = sorted(int(headers["Retry-After"]) for _, headers, _ in shed)
    slo = {}
    for row in exposition.splitlines():
        if row.startswith("torch_engine_slo_"):
            name, _, value = row.rpartition(" ")
            slo[name] = float(value)
    blame = {name[len("torch_engine_slo_blame_total"):]: value for name, value in slo.items()
             if name.startswith("torch_engine_slo_blame_total")}
    assert slo["torch_engine_slo_ttft_burn_rate_5m"] > 1, slo
    assert sum(blame.values()) > 0 and any('stage="queue"' in name for name in blame), blame
    log(f"shedding [{label}]: {RECOVERY_LAYERS} layers, --queue-timeout-s 0.25, 96 requests on 32 slots in "
        f"{wall:.3f}s: {len(served)} answered 200, {len(shed)} shed with 503 (Retry-After "
        f"{retry[0]}-{retry[-1]} s), /metrics requests_shed_total{{reason=\"queue_timeout\"}} "
        f"{exposed[0]:.0f}; slo {SHEDDING_SLO}: " + ", ".join(
            f"{name[len('torch_engine_slo_'):]} {value:g}" for name, value in slo.items()
            if not name.startswith("torch_engine_slo_blame_total"))
        + f"; blame {blame}")


def serve_paged_and_check(label: str, kv_quant: bool = False, mixed: bool = False,
                          layers=None) -> dict:
    """The paged layout, split (bucketed prefill calls, B3/B6 for all) or
    ``mixed`` (``--prefill-mode mixed``: prompt windows ride the decode
    step, B7/B8 for mixed steps, B3/B6 for the plain decode steps
    between them). The split burst arrives cold: its duplicate system
    prompts share blocks the cold batch publishes at reserve and writes
    before a warm suffix reads them. The mixed engine publishes a cold
    prompt's blocks only when it finishes, so a burst that arrives at
    once would find nothing to share: with ``mixed`` one chat with the
    system message is answered first, uncounted. ``layers``: the model cut
    to that depth."""
    extra = ["--kv-layout", "paged", "--kv-block-size", "16"]
    if mixed:
        extra += ["--prefill-mode", "mixed"]
    service, server = start_llama_server(*extra, kv_quant=kv_quant, layers=layers)
    rng = np.random.default_rng(1)
    system = {"role": "system", "content": prompt_text(rng, 512)}
    jobs = []
    for i in range(16):
        body = {"max_tokens": int(24 + 2 * i), "messages": [
            system, {"role": "user", "content": f"question {i}: " + prompt_text(rng, 40 + 6 * i)}]}
        if i % 4 == 3:
            body.update(temperature=0.8, top_p=0.9, seed=i)
        jobs.append(("/v1/chat/completions", body))
    for i in range(8):
        jobs.append(("/v1/completions", {
            "prompt": prompt_text(rng, 120 + 20 * i), "max_tokens": int(32 + 3 * i)}))
    jobs.append(("/v1/chat/completions", {
        "messages": [system, {"role": "user", "content": prompt_text(rng, 60)}],
        "max_tokens": 40, "stream": True}))
    warmup = [("/v1/chat/completions", {
        "messages": [system, {"role": "user", "content": "warm up"}], "max_tokens": 8})]
    if not mixed:
        warmup = []
    try:
        replies, wall, launches, host, stats, peak_gib = run_burst(service, server, jobs, warmup)
    finally:
        server.stop()
        service.close()
    if mixed:
        time_paged_steps(service.engine)
    tokens = check_replies(jobs, replies)
    layers = service.engine.config.num_layers
    calls = stats["model_dispatches"]
    paged = "paged_attention_quant" if kv_quant else "paged_attention"
    ragged_q = "paged_attention_ragged_q_quant" if kv_quant else "paged_attention_ragged_q"
    assert stats["prefix_tokens_reused"] > 0, stats
    assert launches[paged] > 0, launches
    # pipelined (serve's default): the mixed burst chains mixed steps
    # while its prompt windows last (its decode chunks, like the split
    # burst's, chain only while every rider has two chunks of budget left)
    if mixed:
        assert not any(name.startswith("paged_prefill") for name in calls), calls
        assert stats["mixed_steps_chained"] > 0, stats
        assert launches[ragged_q] > 0, launches
        assert launches[ragged_q] == layers * calls.get("paged_mixed_step", 0), (launches, calls)
        assert launches[paged] == layers * calls.get("paged_decode_step", 0), (launches, calls)
        assert launches[f"{paged}/prefill"] == 0, launches
        used = (paged, ragged_q)
    else:
        assert launches[paged] == layers * sum(calls.values()), (launches, calls)
        used = (paged,)
        # B3/B6's launches by shape, from the card's own counter of its
        # launches with more than one q token per slot: every prefill call
        # (cold and onto a cached prefix) and every decode step a replay
        prefills = calls.get("paged_prefill", 0) + calls.get("paged_prefill_at_offset", 0)
        assert prefills > 0, calls
        assert launches[f"{paged}/prefill"] == layers * prefills, (launches, calls)
        launches = dict(launches, **{f"{paged}/decode": launches[paged] - launches[f"{paged}/prefill"]})
        assert launches[f"{paged}/decode"] == layers * calls.get("paged_decode_step", 0), (
            launches, calls)
    # nothing enqueued eagerly: every step and prefill call a replay
    assert not any(host.values()), host
    assert all(launches[name] == 0 for name in KERNELS if name not in used), launches
    other = "paged_attention/prefill" if kv_quant else "paged_attention_quant/prefill"
    assert launches[other] == 0, launches
    kind = (("mixed paged" if mixed else "paged") + (" int8 KV" if kv_quant else "")
            + (" warm" if warmup else " cold") + (f", {layers} layers" if layers != 32 else ""))
    report(label, kind, jobs, wall, tokens, stats, launches, host, peak_gib)
    check_roofline(label, kind, stats, tokens / wall, stats["ttft_time"] / stats["requests"] * 1e3,
                   prefill=not mixed)
    return launches


def _post_all(server, jobs):
    """All jobs at once, uncounted; returns the replies."""
    url = f"http://127.0.0.1:{server.port}"

    def post(job):
        path, body = job
        request = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=600) as response:
            return response.read().decode()

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(post, jobs))


def _answered(jobs, replies):
    """Every reply complete (its max_tokens, or stopped); returns the
    completion tokens and the replies' texts."""
    tokens, texts = 0, []
    for (path, body), raw in zip(jobs, replies):
        choice = json.loads(raw)["choices"][0]
        got = json.loads(raw)["usage"]["completion_tokens"]
        assert got == body["max_tokens"] or choice["finish_reason"] == "stop", (path, got, choice)
        tokens += got
        texts.append(choice["message"]["content"] if "message" in choice else choice["text"])
    return tokens, texts


def _kernel_gates(stats, launches, host, paged: bool, kv_quant: bool, layers: int = 32) -> None:
    """The kernels of the burst's path, each once per layer per model
    call by its card counter, and no other: dense B1 (B4) per cold
    prefill call and B2 (B5) per decode step (prefill at an offset and
    the verify block attend in plain PyTorch); paged B3 (B6) per call,
    split by its card counters into prefill calls, verify steps and
    decode steps; nothing enqueued eagerly (every step a replay).
    ``layers``: the served depth."""
    calls = stats["model_dispatches"]
    q = "_quant" if kv_quant else ""
    if paged:
        name = f"paged_attention{q}"
        prefills = calls.get("paged_prefill", 0) + calls.get("paged_prefill_at_offset", 0)
        expect = {name: layers * sum(calls.values()), f"{name}/prefill": layers * prefills,
                  f"{name}/verify": layers * calls.get("paged_verify_step", 0)}
    else:
        expect = {f"flash_prefill{q}": layers * calls.get("prefill", 0),
                  f"flash_decode{q}": layers * calls.get("decode_step", 0)}
    assert launches == {name: expect.get(name, 0) for name in launches}, (launches, calls)
    assert not any(host.values()), host


def serve_sessions_and_check(label: str, paged: bool = False, kv_quant: bool = False) -> dict:
    """Sessions through ``serve --precompile`` (pipelined) at
    :data:`CUT_LAYERS` layers: 16 users × 3
    turns of chat, each turn sent with the OpenAI ``user`` field and a
    ~300-byte system message, turn n + 1 the messages of turn n, its
    reply and a new user message; then 8 sessionless chats sharing a
    ~530-byte system message (dense: cross-slot copies). Each burst of 16
    (8) at once, counted as the main path's (:func:`run_burst`). Gates:
    every request answered, nothing captured while serving, each kernel
    once per layer per model call; dense: 32 session hits (32 slots, 16
    users: no eviction) and prefix hits; paged: copy-on-write copies."""
    extra = ["--kv-layout", "paged", "--kv-block-size", "16"] if paged else []
    service, server = start_llama_server(*extra, kv_quant=kv_quant, layers=CUT_LAYERS)
    rng = np.random.default_rng(5)
    system = {"role": "system", "content": prompt_text(rng, 300)}
    chats = [[system, {"role": "user", "content": f"user {u}: " + prompt_text(rng, 40 + 4 * u)}]
             for u in range(16)]
    shared = {"role": "system", "content": prompt_text(rng, 530)}
    turns, total = [], {"session_hits": 0, "prefix_hits": 0, "prefix_tokens_reused": 0}
    cow = service.engine.kv_manager.stats["cow_copies"] if paged else 0
    try:
        for turn in range(4):
            if turn < 3:
                jobs = [("/v1/chat/completions", {"messages": chats[u], "max_tokens": 24,
                                                  "user": f"user-{u}"}) for u in range(16)]
            else:
                jobs = [("/v1/chat/completions", {"max_tokens": 24, "messages": [
                    shared, {"role": "user", "content": f"question {i}: " + prompt_text(rng, 30)}]})
                    for i in range(8)]
            replies, wall, launches, host, stats, peak_gib = run_burst(service, server, jobs)
            tokens, texts = _answered(jobs, replies)
            _kernel_gates(stats, launches, host, paged, kv_quant, layers=CUT_LAYERS)
            for key in total:
                total[key] += stats[key]
            copies = {kind: n for kind, n in stats["runs_by_kind"].items() if kind in ("copy", "block_copy")}
            turns.append(dict(tok_s=tokens / wall, ttft_ms=stats["ttft_time"] / stats["requests"] * 1e3,
                              copies=copies, **{key: stats[key] for key in total}))
            if turn < 2:
                for u in range(16):
                    chats[u] = chats[u] + [{"role": "assistant", "content": texts[u]}, {
                        "role": "user", "content": f"turn {turn + 2}: " + prompt_text(rng, 30)}]
    finally:
        server.stop()
        service.close()
    cow = (service.engine.kv_manager.stats["cow_copies"] - cow) if paged else 0
    kind = ("paged" if paged else "dense") + (" int8 KV" if kv_quant else "") + f", {CUT_LAYERS} layers"
    log(f"sessions {kind} [{label}]: " + "; ".join(
        f"{'turn ' + str(n + 1) if n < 3 else 'sessionless shared prefix'} {t['tok_s']:.1f} tok/s, mean "
        f"TTFT {t['ttft_ms']:.1f} ms, session_hits {t['session_hits']}, prefix_hits {t['prefix_hits']}, "
        f"reused {t['prefix_tokens_reused']}, copy replays {t['copies']}" for n, t in enumerate(turns))
        + f"; in all session_hits {total['session_hits']}, prefix_hits {total['prefix_hits']}, "
        f"prefix_tokens_reused {total['prefix_tokens_reused']}, cow_copies {cow}")
    if paged:
        assert cow > 0, cow
    else:
        assert total["session_hits"] == 32 and total["prefix_hits"] > 0, total
    return dict(total, cow_copies=cow, turns=turns)


def serve_spec_and_check(label: str, paged: bool = False, kv_quant: bool = False) -> dict:
    """Speculative decoding through ``serve --precompile`` (pipelined) at
    :data:`CUT_LAYERS` layers with ``engine.spec-decode: ngram``, ``spec-k`` 4: 16 greedy text
    completions of 128 new tokens, each on
    a prompt whose text repeats, at once. Gates: every request answered,
    nothing captured, each kernel once per layer per model call (the
    verify steps attend in plain PyTorch on the dense layout; paged they
    are B3/B6's verify launches, by the card's own counter); drafts were
    made and accepted. Returns the launches, texts, tok/s and mean TTFT."""
    extra = ["--kv-layout", "paged", "--kv-block-size", "16"] if paged else []
    service, server = start_llama_server(*extra, kv_quant=kv_quant, layers=CUT_LAYERS,
                                         engine_config={"spec-decode": "ngram", "spec-k": 4})
    rng = np.random.default_rng(7)
    jobs = []
    for i in range(16):
        phrase = prompt_text(rng, 24 + 2 * i) + " "
        jobs.append(("/v1/completions", {"prompt": phrase * (6 + i % 4), "max_tokens": 128,
                                         "temperature": 0}))
    try:
        replies, wall, launches, host, stats, peak_gib = run_burst(service, server, jobs)
    finally:
        server.stop()
        service.close()
    tokens, texts = _answered(jobs, replies)
    _kernel_gates(stats, launches, host, paged, kv_quant, layers=CUT_LAYERS)
    calls = stats["model_dispatches"]
    assert calls.get("paged_verify_step" if paged else "verify_step", 0) > 0, calls
    assert stats["tokens_drafted"] > 0 and stats["tokens_draft_accepted"] > 0, stats
    kind = (("paged" if paged else "dense") + (" int8 KV" if kv_quant else "")
            + f" spec-decode ngram, {CUT_LAYERS} layers")
    log(f"spec {kind} [{label}]: {stats['requests']} requests, {tokens} completion tokens in {wall:.3f}s = "
        f"{tokens / wall:.1f} tok/s; mean TTFT {stats['ttft_time'] / stats['requests'] * 1e3:.1f} ms; "
        f"decode steps {stats['decode_steps']} ({stats['decode_time']:.3f}s), tokens drafted "
        f"{stats['tokens_drafted']}, accepted {stats['tokens_draft_accepted']}; model calls {calls}; chained "
        f"chunks {stats['chained_decode_chunks']}; graphs replayed by kind {stats['runs_by_kind']}, captured "
        f"{stats['step_captures']}; launches on the card {launches}")
    return dict(launches, texts=texts, tok_s=tokens / wall,
                ttft_ms=stats["ttft_time"] / stats["requests"] * 1e3)


CHECKPOINT_DIR = os.path.join("build", "llama3-8b-checkpoint")


def check_checkpoint(device, path: str = CHECKPOINT_DIR) -> dict:
    """The checkpoint gate: ``init_params(llama3_8b, seed=0)`` drawn on
    the card as the provider draws it, written as a HF Llama directory
    (``config.json``, 5 GB shards and their index) by
    :func:`write_hf_checkpoint`, loaded back with
    ``weights.load_safetensors_checkpoint``: its config equal to the
    drawn one, every leaf equal bit for bit, and ``quantize_params`` of
    each loaded matrix equal to that of the drawn one. Raises when the
    disk cannot hold the files. Returns the write and load seconds and
    the loading peak."""
    from langstream_tpu_torch.providers.torch_local import weights

    config = model.LlamaConfig.llama3_8b()
    needed = int(config.num_params() * 2 * 1.05)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    free = shutil.disk_usage(os.path.dirname(path)).free
    if free < needed:
        raise RuntimeError(f"the checkpoint gate needs {needed / 1e9:.1f} GB of disk under "
                           f"{os.path.dirname(path)}, {free / 1e9:.1f} GB are free")
    drawn = model.init_params(config, seed=0, device=device)
    started = time.perf_counter()
    written = write_hf_checkpoint(path, config, drawn)
    write_s = time.perf_counter() - started
    shards = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    started = time.perf_counter()
    loaded_config, loaded = weights.load_safetensors_checkpoint(path, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - started
    peak = torch.cuda.max_memory_allocated()
    assert loaded_config == config, (loaded_config, config)
    assert sorted(loaded) == sorted(drawn), (sorted(loaded), sorted(drawn))
    for name, leaf in drawn.items():
        assert loaded[name].dtype == leaf.dtype and torch.equal(loaded[name], leaf), name
    for name in QUANTIZED_PARAMS:  # one matrix at a time: the int8 twins of both
        mine = quantize_params({name: loaded[name]})[name]
        theirs = quantize_params({name: drawn[name]})[name]
        assert torch.equal(mine.q, theirs.q) and torch.equal(mine.scale, theirs.scale), name
        del mine, theirs
    gib = 2**30
    result = dict(write_s=write_s, load_s=load_s, bytes=written, shards=len(shards),
                  load_peak_gib=peak / gib, load_added_gib=(peak - held) / gib)
    log(f"checkpoint gate: Llama-3-8B bf16 (init_params seed 0 on the card) written as a HF Llama "
        f"directory of {len(shards)} safetensors shards, {written / 1e9:.2f} GB in {write_s:.1f}s "
        f"({written / write_s / 1e9:.2f} GB/s), loaded with weights.load_safetensors_checkpoint in "
        f"{load_s:.1f}s ({written / load_s / 1e9:.2f} GB/s): config equal, {len(drawn)} leaves equal "
        f"bit for bit, quantize_params equal; loading peak {peak / gib:.2f} GiB allocated "
        f"({held / gib:.2f} GiB of it the drawn params, {(peak - held) / gib:.2f} GiB the load)")
    del drawn, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return result


def serve_checkpoint_and_check(label: str, path: str, random_run: dict, gate: dict) -> None:
    """The checkpoint phase: ``serve --checkpoint DIR --logprobs-top-k 5
    --precompile`` (dense bf16, pipelined) over the gate's directory,
    answering the dense phase's burst, with half the chats asking
    ``logprobs: true, top_logprobs: 5`` and one text completion the
    legacy ``logprobs: 3``. Gates: every request answered, B1 and B2 once
    per layer per model call and no other kernel (:func:`_kernel_gates`);
    every alternatives list of the replies sorted, at most 0, its first
    the greedy token's own logprob; in the engine's results (read through
    a wrapper on its ``generate``) every greedy token ranked first, and
    each token's logprob equal to its own entry wherever it appears.
    Prints tok/s, mean TTFT, the weights' load seconds and the served
    peak beside the random-weight dense phase's, and (not gated: prefill
    groups depend on arrival timing, and cuBLAS may pick another kernel
    for another M) how many streams equal that phase's."""
    service, server = start_llama_server("--checkpoint", path, "--logprobs-top-k", "5")
    assert service.engine.logprobs_topk == 5 and service.top_logprobs_limit == 5
    rng = np.random.default_rng(0)
    jobs = dense_jobs(rng)  # the random-weight dense phase's jobs
    for i, (route, body) in enumerate(jobs[:-1]):
        if route.endswith("chat/completions") and i % 4 == 0:
            body.update(logprobs=True, top_logprobs=5)
    jobs[1][1]["logprobs"] = 3
    results = []
    generate = service.engine.generate

    async def recorded(prompt_tokens, sampling_params, **kwargs):
        result = await generate(prompt_tokens, sampling_params, **kwargs)
        results.append((sampling_params, result))
        return result

    service.engine.generate = recorded
    try:
        replies, wall, launches, host, stats, peak_gib = run_burst(service, server, jobs)
    finally:
        del service.engine.generate
        server.stop()
        service.close()
    tokens = check_replies(jobs, replies)
    _kernel_gates(stats, launches, host, paged=False, kv_quant=False)
    report(label, "dense checkpoint --logprobs-top-k 5", jobs, wall, tokens, stats, launches, host,
           peak_gib)
    lists = 0
    for (route, body), raw in zip(jobs[:-1], replies[:-1]):
        if not body.get("logprobs"):
            continue
        block = json.loads(raw)["choices"][0]["logprobs"]
        if route.endswith("chat/completions"):
            for entry in block["content"]:
                values = [top["logprob"] for top in entry["top_logprobs"]]
                assert len(values) == 5 and values == sorted(values, reverse=True) and values[0] <= 0
                assert abs(values[0] - entry["logprob"]) < 1e-4, entry  # greedy
                lists += 1
        else:
            for row, logprob in zip(block["top_logprobs"], block["token_logprobs"]):
                assert 0 < len(row) <= 3 and all(v <= 0 for v in row.values()), row
                assert abs(max(row.values()) - logprob) < 1e-4, (row, logprob)  # greedy
                lists += 1
    assert lists > 0
    ranked = 0
    for sampling_params, result in results:
        assert result.top_logprobs is not None and len(result.top_logprobs) == len(result.tokens)
        for token, logprob, (ids, lps) in zip(result.tokens, result.logprobs, result.top_logprobs):
            assert len(ids) == 5 and len(set(ids)) == 5 and lps == sorted(lps, reverse=True), (ids, lps)
            if token in ids:
                assert abs(lps[ids.index(token)] - logprob) <= 1e-5, (token, logprob, ids, lps)
            if not sampling_params.temperature:
                assert ids[0] == token, (token, ids, lps)  # argmax and top-K both take the lowest id
                ranked += 1
    _, texts = _answered(jobs[:-1], replies[:-1])
    same = sum(a == b for a, b in zip(texts, random_run["texts"]))
    log(f"checkpoint serving [{label}]: {tokens / wall:.1f} vs {random_run['tok_s']:.1f} tok/s (random-weight "
        f"dense phase), mean TTFT {stats['ttft_time'] / stats['requests'] * 1e3:.1f} vs "
        f"{random_run['ttft_ms']:.1f} ms, weights loaded in {service.load_s:.1f}s vs drawn in "
        f"{random_run['load_s']:.1f}s, served peak {peak_gib:.2f} vs {random_run['peak_gib']:.2f} GiB "
        f"(the gate's loading peak {gate['load_peak_gib']:.2f} GiB); {lists} alternatives lists in the "
        f"replies checked, {ranked} greedy tokens ranked first of their top 5; {same}/{len(texts)} "
        f"streams equal to the random-weight phase's (printed, not gated: the same weights, but "
        f"prefill groups follow arrival timing)")


# ---------------------------------------------------------------------- #
# embeddings and vector search (the encoder, its HF loader, the
# embeddings service beside the completions engine, the vector store)
# ---------------------------------------------------------------------- #
BERT_DIR = os.path.join("build", "minilm-checkpoint")
ENCODER_SHAPES = ((1, 16), (8, 256), (64, 256))  # (rows, bucket) timed


def encoder_bound(config, rows: int, bucket: int):
    """(ms, "bytes" or "operations"): the least time of one encoder call
    at (rows, bucket) in f32: every padded token through every layer
    (8 h² + 4 h f for the projections and the MLP, 4 T h for QKᵀ and
    P·V, a multiply-add two operations) over the FP32 peak, against the
    layer weights read once, the embedding and position rows gathered,
    the ids and mask in and the vectors out over the HBM rate."""
    h, f, layers = config.hidden_size, config.intermediate_size, config.num_layers
    tokens = rows * bucket
    flops = tokens * layers * (8 * h * h + 4 * h * f + 4 * bucket * h)
    weights = layers * (4 * h * h + 2 * h * f + 9 * h + f)
    nbytes = 4 * (weights + tokens * h + bucket * h + rows * h) + 5 * tokens
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def _cpu_twin(config, params):
    from langstream_tpu_torch.providers.torch_local.embeddings import TorchEmbedder
    from langstream_tpu_torch.providers.torch_local.tokenizer import ByteTokenizer

    return TorchEmbedder(config, {name: leaf.cpu() for name, leaf in params.items()},
                         ByteTokenizer(), device="cpu")


def check_encoder_against_cpu(device, label: str):
    """MiniLM-L6 at full width (all-MiniLM-L6-v2's shape, f32), random
    weights drawn on the card (``init_encoder_params`` seed 0, the
    provider's draw for ``preset: minilm-l6``): a batch of 8 texts of
    mixed lengths and one of 5 (three pow2 padding rows) on the card
    against the CPU run of the same weights, within ``EMBED_TOLERANCE``,
    no NaN, padding rows zero. TF32 must be off. Then device ms (CUDA
    events, the encoder alone) and wall ms per call (the embedder's
    ``encode_batch``: ids up, its own stream, vectors down) at
    ``ENCODER_SHAPES``, each beside its f32 bound, and its kernels by
    device time from a profiler trace. Returns (config,
    params, timings)."""
    from langstream_tpu_torch.providers.torch_local.embeddings import (
        EncoderConfig,
        TorchEmbedder,
        encode,
        init_encoder_params,
    )
    from langstream_tpu_torch.providers.torch_local.tokenizer import ByteTokenizer

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on"
    assert torch.get_float32_matmul_precision() == "highest", torch.get_float32_matmul_precision()
    config = EncoderConfig.minilm_l6()
    params = init_encoder_params(config, seed=0, device=device)
    card = TorchEmbedder(config, params, ByteTokenizer(), device=device)
    cpu = _cpu_twin(config, params)
    rng = np.random.default_rng(14)
    texts = [prompt_text(rng, n) for n in (12, 40, 90, 150, 230, 300, 600, 1000)]
    worst = 0.0
    for batch in (texts, texts[:5]):
        tokens, mask = card.batch(batch)
        got, want = card.encode_batch(tokens, mask), cpu.encode_batch(tokens, mask)
        assert not torch.isnan(got).any()
        worst = max(worst, float((got - want).abs().max()))
        assert worst <= EMBED_TOLERANCE, (tokens.shape, worst)
        assert torch.equal(got[len(batch):], torch.zeros_like(got[len(batch):]))
    log(f"encoder [{label}]: MiniLM-L6 f32 (h 384, 6 layers, 12 heads, f 1536) on the card against "
        f"the CPU, batches of 8 and 5 texts (rows 8, buckets {card.batch(texts)[0].shape[1]} and "
        f"{card.batch(texts[:5])[0].shape[1]}): max abs {worst:.3e} (tol {EMBED_TOLERANCE}), no NaN, "
        f"padding rows zero")
    timings = []
    with torch.inference_mode():
        for rows, bucket in ENCODER_SHAPES:
            tokens = rng.integers(0, config.vocab_size, (rows, bucket)).astype(np.int32)
            mask = np.ones((rows, bucket), dtype=bool)
            ids, keep = torch.from_numpy(tokens).to(device), torch.from_numpy(mask).to(device)
            device_ms = one_call_ms(lambda: encode(config, params, ids, keep))
            wall_ms = call_ms(lambda: card.encode_batch(tokens, mask), iters=10)
            bound_ms, bound_by = encoder_bound(config, rows, bucket)
            timings.append(dict(rows=rows, bucket=bucket, device_ms=device_ms, wall_ms=wall_ms,
                                bound_ms=bound_ms, bound_by=bound_by))
            log(f"encoder [{label}]: ({rows}, {bucket}) by kernel: "
                + top_kernels(lambda: encode(config, params, ids, keep)))
            log(f"encoder [{label}]: (rows, bucket) ({rows}, {bucket}): device {device_ms:.4f} ms, "
                f"wall {wall_ms:.4f} ms per call, f32 bound {bound_ms:.4f} ms ({bound_by}; "
                f"{rows * bucket / device_ms * 1e3:.0f} tokens/s, "
                f"{rows / wall_ms * 1e3:.1f} vectors/s)")
    return config, params, timings


def bert_tensors(config, params, token_types):
    """(HF name, tensor) of the encoder's params in a HF ``BertModel``
    checkpoint's layout: each layer's ``[in, out]`` matrix as the ``[out,
    in]`` view HF stores, with ``token_types`` (2 rows) and a pooler and
    the position-id buffer, which the loader must skip."""
    h, layers = config.hidden_size, config.num_layers
    out = [("embeddings.word_embeddings.weight", params["tok_emb"]),
           ("embeddings.position_embeddings.weight", params["pos_emb"]),
           ("embeddings.token_type_embeddings.weight", token_types),
           ("embeddings.LayerNorm.weight", params["emb_norm_w"]),
           ("embeddings.LayerNorm.bias", params["emb_norm_b"]),
           ("embeddings.position_ids", torch.arange(config.max_positions)[None])]
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for key, name in (("q", "attention.self.query"), ("k", "attention.self.key"),
                          ("v", "attention.self.value"), ("o", "attention.output.dense"),
                          ("_in", "intermediate.dense"), ("_out", "output.dense")):
            out.append((p + name + ".weight", params["w" + key][i].t()))
            out.append((p + name + ".bias", params["b" + key][i]))
        for key, name in (("attn_norm", "attention.output.LayerNorm"), ("mlp_norm", "output.LayerNorm")):
            out.append((p + name + ".weight", params[key + "_w"][i]))
            out.append((p + name + ".bias", params[key + "_b"][i]))
    out += [("pooler.dense.weight", torch.zeros(h, h)), ("pooler.dense.bias", torch.zeros(h))]
    return out


def check_bert_checkpoint(device, config, params, label: str, path: str = BERT_DIR) -> None:
    """The encoder's drawn weights written as a HF BERT directory
    (``config.json``, one safetensors file, random token-type rows) by
    this script's writer, loaded back onto the card with
    ``weights.load_hf_bert``: config equal, every leaf bit for bit, the
    token-type row 0 folded into ``tok_emb`` as the card adds it."""
    from langstream_tpu_torch.providers.torch_local import weights

    token_types = torch.randn(2, config.hidden_size, device=device,
                              generator=torch.Generator(device=device).manual_seed(1)) * 0.02
    os.makedirs(path, exist_ok=True)
    try:
        with open(os.path.join(path, "config.json"), "w") as fh:
            json.dump({"architectures": ["BertModel"], "model_type": "bert",
                       "vocab_size": config.vocab_size, "hidden_size": config.hidden_size,
                       "intermediate_size": config.intermediate_size,
                       "num_hidden_layers": config.num_layers,
                       "num_attention_heads": config.num_heads,
                       "max_position_embeddings": config.max_positions,
                       "layer_norm_eps": config.norm_eps, "hidden_act": "gelu",
                       "type_vocab_size": 2, "torch_dtype": "float32"}, fh, indent=2)
        started = time.perf_counter()
        written = write_safetensors(os.path.join(path, "model.safetensors"),
                                    bert_tensors(config, params, token_types))
        write_s = time.perf_counter() - started
        started = time.perf_counter()
        loaded_config, loaded = weights.load_hf_bert(path, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - started
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert loaded_config == config, (loaded_config, config)
    assert sorted(loaded) == sorted(params)
    want = dict(params, tok_emb=params["tok_emb"] + token_types[0][None, :])
    for name, leaf in want.items():
        assert loaded[name].device == leaf.device and loaded[name].dtype == leaf.dtype, name
        assert torch.equal(loaded[name], leaf), name
    log(f"BERT checkpoint [{label}]: MiniLM-L6 f32 written as a HF BERT directory "
        f"({written / 1e6:.1f} MB of safetensors) in {write_s:.2f}s, loaded onto the card with "
        f"weights.load_hf_bert in {load_s:.2f}s: config equal, {len(want)} leaves equal bit for "
        f"bit (token-type row 0 folded into tok_emb)")


def one_call_ms(fn, repeats: int = 5) -> float:
    """Device time of one call of ``fn`` that launches hundreds of small
    kernels (the eager encoder: about 290 a call): :func:`time_ms` over a
    single call behind the sleep kernel, the median of ``repeats``. Ten
    calls' launches overflow the card's queue of pending work, and the
    host then paces the card again inside the timed window."""
    return float(np.median([time_ms(fn, warmup=1, iters=1) for _ in range(repeats)]))


# kernel kinds by name: cuBLAS GEMMs (nvjet, xmma, cutlass), PyTorch's
# elementwise and reduce kernels; the rest is "other"
KERNEL_KINDS = (("gemm", ("gemm", "nvjet", "xmma", "cutlass")), ("elementwise", ("elementwise",)),
                ("reduce", ("reduce",)))


def top_kernels(fn, top: int = 5) -> str:
    """The kernels of one call of ``fn`` from a ``torch.profiler`` trace:
    their count, the sum of their durations (gaps between them left
    out), that sum by kind (:data:`KERNEL_KINDS`), and the ``top`` by
    device time (name, calls, µs); or why there is none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def device_us(event):
        return getattr(event, "self_device_time_total", None) or getattr(
            event, "self_cuda_time_total", 0.0)

    # a record_function range on the card (AdamW's step) spans kernels
    # already counted
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=device_us, reverse=True)
    if not kernels:
        return "no kernel in the trace (not measured)"
    kinds = dict.fromkeys([kind for kind, _ in KERNEL_KINDS] + ["other"], 0.0)
    for event in kernels:
        name = event.key.lower()
        kind = next((kind for kind, marks in KERNEL_KINDS if any(m in name for m in marks)), "other")
        kinds[kind] += device_us(event)
    return (f"{sum(e.count for e in kernels)} kernels, {sum(device_us(e) for e in kernels):.0f} µs "
            f"summed (" + ", ".join(f"{kind} {us:.0f}" for kind, us in kinds.items())
            + "); top: " + "; ".join(f"{e.key[:48]} x{e.count} {device_us(e):.0f} µs"
                                         for e in kernels[:top]))


def _post_timed(server, path, body):
    """(status, body text, seconds to the answer) of one request."""
    started = time.perf_counter()
    status, _, raw = _post_status(server, path, body)
    return status, raw, time.perf_counter() - started


def serve_embeddings_and_check(label: str, device, config, params) -> dict:
    """Embeddings beside the completions engine, as the JAX ``serve`` runs
    both in one process: ``serve --precompile`` with Llama-3-8B at
    ``RECOVERY_LAYERS`` and a ``TorchEmbeddingsService`` over
    ``embeddings-model: {preset: minilm-l6}`` and the byte tokenizer (its
    weights the encoder check's draw). 16 chat completions fired together
    with an embeddings burst of 512 texts (40-1200 bytes) in requests of
    1-64 inputs, after each half alone (the controls). Gates: every
    request 200, every vector 384 floats in order, 16 sampled vectors
    within ``EMBED_TOLERANCE`` of the CPU's and every vector within it of
    the embeddings-alone burst's, no capture while serving. Then the one-text call (the query path of RAG)
    by HTTP and by the embedder, against its device time. Then a fresh
    engine's ``precompile`` with embeddings calls running through it:
    calls inside the capture window answered and equal to the CPU's, and
    every variant captured."""
    from langstream_tpu_torch.providers.torch_local.embeddings import encode
    from langstream_tpu_torch.providers.torch_local.provider import TorchEmbeddingsService

    embeddings = TorchEmbeddingsService({"embeddings-model": {"preset": "minilm-l6"}}, device=device)
    assert all(torch.equal(embeddings.embedder.params[name], leaf) for name, leaf in params.items())
    cpu = _cpu_twin(config, params)
    rng = np.random.default_rng(15)
    chats = [("/v1/chat/completions", {"max_tokens": 32 + 2 * i, "messages": [
        {"role": "user", "content": prompt_text(rng, 100 + 12 * i)}]}) for i in range(16)]
    texts, requests = [], []
    while len(texts) < 512:
        size = min(int(rng.integers(1, 65)), 512 - len(texts))
        batch = [prompt_text(rng, int(rng.integers(40, 1201))) for _ in range(size)]
        requests.append(("/v1/embeddings", {"input": batch if size > 1 else batch[0]}))
        texts += batch
    jobs = chats + requests
    order = rng.permutation(len(jobs))
    def fire(batch, order):
        """All of ``batch`` at once, in ``order``; every reply 200."""
        started = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(batch)) as pool:
            futures = {int(i): pool.submit(_post_timed, server, *batch[i]) for i in order}
            replies = [futures[i].result() for i in range(len(batch))]
        assert all(status == 200 for status, _, _ in replies), [r[:2] for r in replies if r[0] != 200]
        return replies, time.perf_counter() - started

    def vectors_of(replies):
        vectors = []
        for (_, body), (_, raw, _) in zip(requests, replies):
            data = json.loads(raw)["data"]
            want = body["input"] if isinstance(body["input"], list) else [body["input"]]
            assert [d["index"] for d in data] == list(range(len(want)))
            assert all(len(d["embedding"]) == config.hidden_size for d in data)
            vectors += [d["embedding"] for d in data]
        assert len(vectors) == len(texts) == 512
        return vectors

    service, server = start_llama_server(layers=RECOVERY_LAYERS, embeddings=embeddings)
    try:
        engine = service.engine
        captured = engine.steps.stats["captured"]
        # each half alone first (the controls), then both at once
        alone, _ = fire(requests, range(len(requests)))
        alone_vectors = vectors_of(alone)
        embed_alone = max(seconds for _, _, seconds in alone)
        chats_alone, _ = fire(chats, range(len(chats)))
        chat_alone = max(seconds for _, _, seconds in chats_alone)
        chat_alone_tokens, _ = _answered(chats, [raw for _, raw, _ in chats_alone])
        replies, wall = fire(jobs, order)
        assert engine.steps.stats["captured"] == captured, "a step variant was captured while serving"
        tokens, _ = _answered(chats, [raw for _, raw, _ in replies[:16]])
        vectors = vectors_of(replies[16:])
        drift = float((torch.tensor(vectors) - torch.tensor(alone_vectors)).abs().max())
        assert drift <= EMBED_TOLERANCE, drift
        embed_wall = max(seconds for _, _, seconds in replies[16:])
        chat_wall = max(seconds for _, _, seconds in replies[:16])
        sample = rng.choice(len(texts), 16, replace=False)
        reference = torch.tensor(cpu.embed([texts[i] for i in sample]))
        worst = float((torch.tensor([vectors[i] for i in sample]) - reference).abs().max())
        assert worst <= EMBED_TOLERANCE, worst
        # the query path: one short text, by HTTP and by the embedder
        query = "which stream processor batches the tokens on the card?"
        http_ms, nodelay_ms = [], []
        for _ in range(20):
            status, _, seconds = _post_timed(server, "/v1/embeddings", {"input": query})
            assert status == 200
            http_ms.append(seconds * 1e3)
        # the same with TCP_NODELAY on the server's connections (a probe of
        # the headers-then-body writes against delayed ACKs; not served so)
        http.server.BaseHTTPRequestHandler.disable_nagle_algorithm = True
        try:
            for _ in range(20):
                status, _, seconds = _post_timed(server, "/v1/embeddings", {"input": query})
                assert status == 200
                nodelay_ms.append(seconds * 1e3)
        finally:
            http.server.BaseHTTPRequestHandler.disable_nagle_algorithm = False
        embedder = embeddings.embedder
        embed_ms = call_ms(lambda: embedder.embed([query]), iters=20)
        tokens_np, mask_np = embedder.batch([query])
        ids, keep = torch.from_numpy(tokens_np).to(device), torch.from_numpy(mask_np).to(device)
        with torch.inference_mode():
            device_ms = one_call_ms(lambda: encode(config, params, ids, keep))
    finally:
        server.stop()
        service.close()
    result = dict(vectors_s=512 / embed_wall, embed_wall=embed_wall, chat_tok_s=tokens / chat_wall,
                  vectors_s_alone=512 / embed_alone, chat_tok_s_alone=chat_alone_tokens / chat_alone,
                  http_ms=float(np.median(http_ms)), nodelay_ms=float(np.median(nodelay_ms)),
                  embed_ms=embed_ms, device_ms=device_ms,
                  bucket=tokens_np.shape[1])
    log(f"embeddings serving [{label}]: {len(requests)} embeddings requests (512 texts, 40-1200 bytes, "
        f"1-64 a request) beside 16 chats on Llama-3-8B at {RECOVERY_LAYERS} layers, all 200 in "
        f"{wall:.3f}s: {result['vectors_s']:.1f} vectors/s (the last vector at {embed_wall:.3f}s; "
        f"alone {result['vectors_s_alone']:.1f}), chats {tokens} tokens at "
        f"{result['chat_tok_s']:.1f} tok/s (the last at {chat_wall:.3f}s; alone "
        f"{result['chat_tok_s_alone']:.1f}); vectors equal to the embeddings-alone burst's within "
        f"{drift:.3e}; "
        f"16 sampled vectors within {worst:.3e} of the CPU's (tol {EMBED_TOLERANCE}); no capture while "
        f"serving; one-text call (rows 1, bucket {result['bucket']}): HTTP wall "
        f"{result['http_ms']:.3f} ms (median of 20; {result['nodelay_ms']:.3f} with TCP_NODELAY on the "
        f"server's sockets), embed() wall {embed_ms:.3f} ms, device "
        f"{device_ms:.4f} ms, wall / device {embed_ms / device_ms:.1f}x")
    gc.collect()
    torch.cuda.empty_cache()
    result.update(embeddings_during_capture(label, embeddings, cpu, rng))
    return result


def embeddings_during_capture(label: str, embeddings, cpu, rng) -> dict:
    """A fresh ``serve --precompile`` engine (Llama-3-8B at
    ``RECOVERY_LAYERS``) built on one thread while two threads keep calling
    ``embeddings.compute_embeddings``: the calls that overlap the engine's
    ``precompile`` (timed through a wrapper on it) must be answered and
    equal the CPU's, and the capture must complete: every variant
    captured, then a chat answered."""
    batches = [[prompt_text(rng, int(n)) for n in rng.integers(40, 1201, size)]
               for size in (1, 3, 8, 17)]
    references = [torch.tensor(cpu.embed(batch)) for batch in batches]
    window = {}
    precompile = engine_lib.DecodeEngine.precompile

    def timed(engine):
        window["start"] = time.perf_counter()
        try:
            precompile(engine)
        finally:
            window["end"] = time.perf_counter()

    calls = []  # (start, end, max abs error) of each call
    built = concurrent.futures.Future()

    def embed_until_built(offset):
        i = offset
        while not built.done():
            batch, reference = batches[i % len(batches)], references[i % len(batches)]
            started = time.perf_counter()
            got = torch.tensor(asyncio.run(embeddings.compute_embeddings(batch)))
            calls.append((started, time.perf_counter(), float((got - reference).abs().max())))
            i += 1

    engine_lib.DecodeEngine.precompile = timed
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            callers = [pool.submit(embed_until_built, offset) for offset in (0, 2)]
            try:
                built.set_result(start_llama_server(layers=RECOVERY_LAYERS))
            except BaseException as error:
                built.set_exception(error)
            for caller in callers:
                caller.result()
    finally:
        engine_lib.DecodeEngine.precompile = precompile
    service, server = built.result()
    try:
        engine = service.engine
        assert engine.steps.graphed and all(entry.graph is not None
                                            for entry in engine.steps._entries.values())
        assert engine.steps.stats["captured"] == len(engine._variant_keys()), engine.steps.stats
        status, raw, _ = _post_timed(server, "/v1/chat/completions", {
            "max_tokens": 16, "messages": [{"role": "user", "content": "after the capture"}]})
        assert status == 200, raw
    finally:
        server.stop()
        service.close()
    inside = [call for call in calls if call[0] < window["end"] and call[1] > window["start"]]
    assert inside, (window, calls[:3])
    worst = max(error for _, _, error in calls)
    assert worst <= EMBED_TOLERANCE, worst
    log(f"embeddings during a capture [{label}]: {len(calls)} calls (1-17 texts) while a fresh "
        f"engine was built, {len(inside)} of them inside its precompile "
        f"({window['end'] - window['start']:.2f}s, {engine.steps.stats['captured']} variants "
        f"captured, all of them), all answered within {worst:.3e} of the CPU's; a chat "
        f"answered after")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(capture_calls=len(inside), capture_s=window["end"] - window["start"])


def _rank_reference(scores: np.ndarray, k: int) -> np.ndarray:
    """The numpy path's ranking of one column of host scores: the ``k``
    largest, ties to the lower row."""
    top = np.argpartition(-scores, k)[:k]
    return top[np.lexsort((top, -scores[top]))]


def _check_ranking(got, want, scores, label) -> int:
    """The card's ids against the host's: equal, except where two rows'
    host scores differ by at most ``SEARCH_TOLERANCE`` (a near-tie that
    f32 sums in another order may swap). Returns the near-tie swaps."""
    swaps = 0
    for position, (mine, theirs) in enumerate(zip(got, want)):
        if mine != theirs:
            assert abs(scores[mine] - scores[theirs]) <= SEARCH_TOLERANCE, (
                label, position, mine, theirs, scores[mine], scores[theirs])
            swaps += 1
    return swaps


def check_vector_search(device, label: str, rows: int = 262144, l2_rows: int = 65536) -> dict:
    """The vector store at ``rows`` (262,144) x 384 f32 (384 MiB on the card):
    unit vectors from a seeded rng, each through ``upsert`` as a sink
    writes them; 256 cosine queries with top-10 against the host's numpy
    scores (ids equal but for near-ties, scores within
    ``SEARCH_TOLERANCE``), the numpy path itself for 8 of them; 1,000
    deletes and 1,000 re-upserts, then 64 queries again (a partial
    upload); 16 l2 queries on an ``l2_rows`` (65,536) store against its
    numpy path.
    Prints the upsert seconds, the first search (with the upload), the
    wall and device ms per search against the bound: the matrix read once
    at the HBM rate."""
    from langstream_tpu_torch.agents.vectorstore import VectorStore
    from langstream_tpu_torch.providers.torch_local.sampling import lax_top_k

    dims, k = 384, 10
    rng = np.random.default_rng(16)
    data = rng.standard_normal((rows, dims), dtype=np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    store = VectorStore(dims, metric="cosine", device=device)
    started = time.perf_counter()
    for i in range(rows):
        store.upsert(f"doc-{i}", data[i], {"n": i})
    upsert_s = time.perf_counter() - started
    queries = rng.standard_normal((256, dims), dtype=np.float32)
    queries = np.stack([q / (float(np.linalg.norm(q)) or 1.0) for q in queries])  # as search does

    def compare(count, label_):
        host = store._matrix[:rows]
        scores = host @ queries[:count].T
        swaps = 0
        for j in range(count):
            got = store.search(queries[j], k)
            ids = [store._index[r["id"]] for r in got]
            for row, record in zip(ids, got):
                assert abs(record["similarity"] - scores[row, j]) <= SEARCH_TOLERANCE, (j, row)
            swaps += _check_ranking(ids, _rank_reference(scores[:, j], k), scores[:, j],
                                    f"{label_} query {j}")
        return swaps

    torch.cuda.synchronize()
    started = time.perf_counter()
    store.search(queries[0], k)
    first_ms = (time.perf_counter() - started) * 1e3
    started = time.perf_counter()
    for q in queries:
        store.search(q, k)
    search_ms = (time.perf_counter() - started) / len(queries) * 1e3
    swaps = compare(256, "cosine")
    for j in range(8):  # the numpy path itself
        _check_ranking([store._index[r["id"]] for r in store.search(queries[j], k)],
                       store._search_numpy(queries[j], k, rows)[1], store._matrix[:rows] @ queries[j],
                       f"numpy path query {j}")
    matrix = store._resident
    q = torch.from_numpy(queries[1]).to(device)
    padding = torch.arange(matrix.shape[0], device=device) >= rows
    device_ms = time_ms(lambda: lax_top_k((matrix @ q).masked_fill(padding, float("-inf")), k))
    gemv_ms = time_ms(lambda: matrix @ q)
    bound_ms = rows * dims * 4 / PEAK_BYTES * 1e3
    # deletes and re-upserts: ~3000 dirty rows, uploaded at the next search
    victims = rng.choice(rows, 1000, replace=False)
    for i in victims:
        assert store.delete(f"doc-{i}")
    fresh = rng.standard_normal((1000, dims), dtype=np.float32)
    for i, vector in zip(victims, fresh):
        store.upsert(f"doc-{i}", vector / np.linalg.norm(vector))
    dirty = len(store._dirty)
    started = time.perf_counter()
    store.search(queries[0], k)
    partial_ms = (time.perf_counter() - started) * 1e3
    swaps += compare(64, "after deletes")
    del store, matrix
    gc.collect()
    torch.cuda.empty_cache()
    l2 = VectorStore(dims, metric="l2", device=device)
    for i in range(l2_rows):
        l2.upsert(f"doc-{i}", data[i])
    for j in range(16):
        got = l2.search(queries[j], k)
        _, rows_np = l2._search_numpy(queries[j], k, l2_rows)
        host = -np.linalg.norm(l2._matrix[:l2_rows] - queries[j], axis=1)
        swaps += _check_ranking([l2._index[r["id"]] for r in got], rows_np, host, f"l2 query {j}")
        for record in got:
            row = l2._index[record["id"]]
            assert abs(record["similarity"] + host[row] ** 2) <= SEARCH_TOLERANCE, (j, row)
    del l2, data
    gc.collect()
    torch.cuda.empty_cache()
    result = dict(upsert_s=upsert_s, first_ms=first_ms, search_ms=search_ms, device_ms=device_ms,
                  gemv_ms=gemv_ms, bound_ms=bound_ms, partial_ms=partial_ms, swaps=swaps)
    log(f"vector search [{label}]: {rows} x {dims} f32 ({rows * dims * 4 / 2**20:.0f} MiB on the card), "
        f"{rows} upserts in {upsert_s:.2f}s; first search (with the whole upload) {first_ms:.2f} ms; "
        f"cosine top-{k}: wall {search_ms:.4f} ms per search (256 queries), device {device_ms:.4f} ms "
        f"(the product alone {gemv_ms:.4f} ms) against the bound {bound_ms:.4f} ms (bytes: the matrix "
        f"read once); ids of 256 + 64 cosine and 16 l2 ({l2_rows} rows) queries equal the host's "
        f"numpy ranking, {swaps} near-tie swaps within {SEARCH_TOLERANCE}; after 1000 deletes + "
        f"1000 re-upserts "
        f"({dirty} dirty rows) the next search {partial_ms:.2f} ms")
    return result


# ---------------------------------------------------------------------- #
# disaggregation and the host tier: the KV handoff between a prefill and
# a decode engine, demotion and promotion through pinned host memory
# ---------------------------------------------------------------------- #
DISAGG_BUCKETS = [128, 256, 512, 1024, 2048]
DISAGG_SEQ = 4096
# top-K each phase-12 engine keeps: the stream gate reads the oracle's
# alternatives where two bf16 runs part
DISAGG_TOPK = 8
# two bf16 runs of the same state may part only at a near-tie: until the
# first differing token the chosen tokens' logprobs agree within this, and
# there the other run's token is in the oracle's top-K with a logprob
# within this of its own (greedy: also within this of the oracle's pick)
NEAR_TIE = 5e-2
DISAGG_SAMPLINGS = {
    "greedy": dict(max_new_tokens=12),
    # the seeded sampling of the JAX package's tests/test_disagg.py
    "seeded": dict(max_new_tokens=12, temperature=0.9, top_k=8, top_p=0.9, seed=1234,
                   presence_penalty=0.4, frequency_penalty=0.25),
}


def _disagg_engine(config, params, kv_quant: bool, **kwargs):
    """A paged engine of phase 12 at Llama-3-8B width over the shared int8
    weights (the supervisor's factory shares them the same way), started;
    eager dispatch (no graph to capture per engine) and the pipelined
    decode, ``serve``'s default."""
    eng = engine_lib.DecodeEngine(
        config, params, device="cuda", max_slots=8, max_seq_len=DISAGG_SEQ,
        prefill_buckets=DISAGG_BUCKETS, decode_chunk=4, kv_layout="paged", kv_block_size=16,
        kv_quant="int8" if kv_quant else None, logprobs_topk=DISAGG_TOPK, step_graphs=False,
        pipeline_decode=True, **kwargs)
    eng.start()
    return eng


def _generate(eng, prompt, sampling, **fields):
    """One request through ``submit``; returns the result and its TTFT
    (ms, the engine's submit to first token; a replay's first token is
    the first its resumed span emits)."""
    future = concurrent.futures.Future()
    request = engine_lib.GenerationRequest(
        prompt_tokens=list(prompt), sampling=engine_lib.SamplingParams(**sampling), future=future)
    for name, value in fields.items():
        setattr(request, name, value)
    before = eng.stats["ttft_time"]
    eng.submit(request)
    result = future.result(timeout=600)
    return result, (eng.stats["ttft_time"] - before) * 1e3


def same_stream(got, want, greedy: bool, label: str, tolerance: float = NEAR_TIE) -> bool:
    """True when ``got`` equals the oracle ``want`` token for token; False
    when they part at a near-tie (within ``tolerance``, :data:`NEAR_TIE`
    unless the caller states another): a replay prefills the row of the
    prompt's last sampled token that the oracle wrote in a decode step,
    and bf16 GEMMs of other shapes round it otherwise. Raises on any other
    difference."""
    if got.tokens == want.tokens:
        return True
    assert len(got.tokens) == len(want.tokens), (label, got.tokens, want.tokens)
    first = next(j for j, (a, b) in enumerate(zip(got.tokens, want.tokens)) if a != b)
    for j in range(first):
        assert abs(got.logprobs[j] - want.logprobs[j]) <= tolerance, (label, j, got.logprobs, want.logprobs)
    ids, lps = want.top_logprobs[first]
    token = got.tokens[first]
    assert token in ids, (label, first, token, ids)
    other = lps[ids.index(token)]
    assert abs(got.logprobs[first] - other) <= tolerance, (label, first, got.logprobs[first], other)
    if greedy:
        assert want.logprobs[first] - other <= tolerance, (label, first, want.logprobs[first], other)
    return False


def _clear_prefix_cache(eng) -> None:
    """Unpublish every cached chain of an idle engine's pool (no slot
    holds a block between requests), so the next request runs cold."""
    eng.kv_manager._evict(eng.num_blocks)
    assert eng.kv_manager.blocks_in_use == 0, eng.kv_manager.blocks_in_use


def _pool_rows(eng, blocks) -> dict:
    index = torch.tensor(blocks, dtype=torch.long, device=eng.device)
    return {leaf: value.index_select(1, index).cpu() for leaf, value in eng.cache.items()}


def plain_copy_ms(nbytes: int):
    """A plain pinned ``copy_`` of ``nbytes``: device to host and host to
    device (ms each)."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d2h = call_ms(lambda: host.copy_(dev, non_blocking=True), iters=5)
    h2d = call_ms(lambda: dev.copy_(host, non_blocking=True), iters=5)
    del dev, host
    return d2h, h2d


def _kv_kernel_gate(eng, calls_before, entries_before, counts, kv_quant: bool) -> Tuple[int, int]:
    """B3 (B6) once per layer per model call of the engine in the window,
    by the card's counters (prefill calls by their own), and no other
    kernel. A variant first met in the window runs its body once more to
    warm up (eager: to make its outputs): ``size`` decode steps for a
    decode chunk, one call for a prefill; those count too. Returns the
    window's model calls and warm-up calls."""
    layers = eng.config.num_layers
    calls = {k: n - calls_before.get(k, 0) for k, n in eng.stats["model_dispatches"].items()}
    new = [key for key in eng.steps._entries if key not in entries_before]
    warm_decode = sum(key.size for key in new if key.kind == "decode")
    warm_prefill = sum(1 for key in new if key.kind in ("prefill", "prefill_offset"))
    name = f"paged_attention{'_quant' if kv_quant else ''}"
    prefills = calls.get("paged_prefill", 0) + calls.get("paged_prefill_at_offset", 0) + warm_prefill
    expect = {name: layers * (sum(calls.values()) + warm_decode + warm_prefill),
              f"{name}/prefill": layers * prefills}
    assert counts == {k: expect.get(k, 0) for k in counts}, (counts, calls, new)
    assert expect[name] > 0 and expect[f"{name}/prefill"] > 0, expect
    return sum(calls.values()), warm_decode + warm_prefill


def check_handoff(label: str, config, params, kv_quant: bool) -> dict:
    """The KV handoff at Llama-3-8B width: engine A the prefill leg, B the
    decode leg (``kv_blocks`` 1025 each). Two prompts (seed 12), 2048
    tokens greedy and 1500 seeded (two more of 1501-2047 tokens were cut
    for the smoke's time when phase 18 came): A answers each whole (the
    oracle, 12 tokens), then a 2-token leg with ``export_handoff``; its
    payload goes through ``fleet.handoff.handoff_records`` (256 KiB
    chunks) and the ``HandoffAssembler`` to B, which replays the manifest
    with ``kv_import``. Gates: B's stream A's (:func:`same_stream`); B's
    pool rows of the imported chain equal to the payload bit for bit; B's
    ``hit_tokens`` grown by every full block of the prompt; B3 (B6) once
    per layer per model call of the replay; no ``handoff_aborted``; the
    ``engines_snapshot`` deltas equal the engines' counts. Then a record
    set missing its last chunk and a torn payload (``block_size`` 99)
    both replay cold with A's stream. Printed beside a plain pinned
    ``copy_`` of the same bytes: export ms and GB/s (gather and D2H) with
    the host's wait for the work queued before it, records and their
    encode / assemble seconds, import ms and GB/s (H2D and scatter), and
    the decode leg's TTFT with the import against the same replay cold on
    B."""
    from langstream_tpu_torch.fleet.handoff import (
        HandoffAssembler,
        handoff_records,
        manifest_for_request,
        payload_nbytes,
    )

    gc.collect()
    base = engine_lib.engines_snapshot()
    a = _disagg_engine(config, params, kv_quant, kv_blocks=1025)
    b = _disagg_engine(config, params, kv_quant, kv_blocks=1025)
    exports, imports = [], []
    export_fn, import_fn = a._export_handoff, b._import_handoff

    def timed_export(slot, history):
        started = time.perf_counter()
        torch.cuda.synchronize()  # the host's wait for work queued before the export
        waited = time.perf_counter()
        payload = export_fn(slot, history)
        exports.append((waited - started, time.perf_counter() - waited, payload_nbytes(payload)))
        return payload

    def timed_import(payload, **kwargs):
        torch.cuda.synchronize()
        started = time.perf_counter()
        ok = import_fn(payload, **kwargs)
        torch.cuda.synchronize()
        imports.append((time.perf_counter() - started, payload_nbytes(payload), ok))
        return ok

    # one uncounted round first, greedy and seeded: a variant's first use
    # runs its body once more (eager: to make its outputs), which would
    # land in the first prompt's times
    warm_prompt = [int(t) for t in np.random.default_rng(11).integers(1, config.vocab_size, size=2048)]
    for sampling in DISAGG_SAMPLINGS.values():
        leg, _ = _generate(a, warm_prompt, dict(sampling, max_new_tokens=2), export_handoff=True)
        replay = dict(replay_tokens=leg.tokens, prompt_len=len(warm_prompt))
        _generate(b, warm_prompt + leg.tokens[:1], sampling, kv_import=leg.kv_handoff, **replay)
        _clear_prefix_cache(b)
        _generate(b, warm_prompt + leg.tokens[:1], sampling, **replay)
        _clear_prefix_cache(b)
        _clear_prefix_cache(a)
    warm_handoffs = len(DISAGG_SAMPLINGS)
    a._export_handoff, b._import_handoff = timed_export, timed_import
    rng = np.random.default_rng(12)
    lengths = [2048, 1500]
    # the lengths of two more prompts, cut for the smoke's time when phase
    # 18 came: still drawn, so that these two prompts' tokens stay as they were
    rng.integers(1501, 2048, size=2)
    prompts = [[int(t) for t in rng.integers(1, config.vocab_size, size=n)] for n in lengths]
    kind = "int8 KV" if kv_quant else "bf16 KV"
    pool = "int8" if kv_quant else "bf16"
    rows, first = [], None
    legs, replays = [], []  # the trace ids of the prefill legs and the decode legs
    try:
        for i, prompt in enumerate(prompts):
            name = ("greedy", "seeded")[i % 2]
            sampling = DISAGG_SAMPLINGS[name]
            want, _ = _generate(a, prompt, sampling)
            # the leg runs cold, as the oracle did: its rows and first two
            # tokens are the oracle's bit for bit
            _clear_prefix_cache(a)
            legs.append(f"handoff-{pool}-{i}-prefill")
            leg, _ = _generate(a, prompt, dict(sampling, max_new_tokens=2), export_handoff=True,
                               trace_id=legs[-1])
            assert leg.tokens == want.tokens[:2], (leg.tokens, want.tokens)
            payload = leg.kv_handoff
            full = len(prompt) // 16
            assert len(payload["tokens"]) == 16 * ((len(prompt) + 1) // 16), len(payload["tokens"])
            started = time.perf_counter()
            records = handoff_records(payload, manifest_for_request(prompt, leg.tokens, sampling,
                                                                    export_ts=payload["export_ts"]))
            encode_s = time.perf_counter() - started
            # a record holds whole blocks, at least one: at this width one
            # block outgrows the 256 KiB budget, so each record is a block
            itemsize = {"bfloat16": 2, "int8": 1, "float32": 4}
            largest = max(sum(int(np.prod(spec["shape"])) * itemsize[spec["dtype"]]
                              for spec in r["arrays"].values()) for r in records)
            per_block = payload_nbytes(payload) // len(payload["arrays"]["k"][0])
            assert largest <= max(256 * 1024, per_block), (largest, per_block)
            started = time.perf_counter()
            asm = HandoffAssembler()
            assembled = None
            for record in records:
                assembled = asm.offer(record, now=0.0) or assembled
            assemble_s = time.perf_counter() - started
            manifest = assembled["manifest"]
            replay = list(manifest["generated"])
            fields = dict(replay_tokens=replay, replay_logprobs=list(leg.logprobs),
                          replay_tops=list(leg.top_logprobs), prompt_len=len(prompt))
            hits = b.kv_manager.stats["hit_tokens"]
            calls, entries = dict(b.stats["model_dispatches"]), set(b.steps._entries)
            replays.append(f"handoff-{pool}-{i}-decode")
            with launches_lib.device_launches(shapes=True) as counts:
                got, ttft = _generate(b, manifest["prompt_tokens"] + replay[:-1], manifest["sampling"],
                                      kv_import=assembled["payload"], trace_id=replays[-1],
                                      handoff_export_ts=manifest["export_ts"], **fields)
            model_calls, warm_calls = _kv_kernel_gate(b, calls, entries, counts, kv_quant)
            assert b.kv_manager.stats["hit_tokens"] - hits >= full * 16, (
                b.kv_manager.stats["hit_tokens"] - hits, full)
            chain, matched = b.kv_manager.match(payload["tokens"])
            assert matched == len(payload["tokens"]), (matched, len(payload["tokens"]))
            for leaf, value in _pool_rows(b, chain).items():
                assert torch.equal(value, assembled["payload"]["arrays"][leaf]), leaf
            exact = same_stream(got, want, name == "greedy", f"handoff {kind} prompt {i}")
            _clear_prefix_cache(b)
            cold, cold_ttft = _generate(b, prompt + replay[:-1], sampling, **fields)
            cold_exact = same_stream(cold, want, name == "greedy", f"cold replay {kind} prompt {i}")
            _clear_prefix_cache(b)
            rows.append(dict(len=len(prompt), sampling=name, records=len(records), largest=largest,
                             launches=counts[f"paged_attention{'_quant' if kv_quant else ''}"],
                             model_calls=model_calls, warm_calls=warm_calls,
                             encode_s=encode_s,
                             assemble_s=assemble_s, ttft=ttft, cold_ttft=cold_ttft, exact=exact,
                             cold_exact=cold_exact))
            if first is None:
                first = (prompt, want, leg, records, fields)
        # a prefill replica that died mid-handoff, and a torn payload
        prompt, want, leg, records, fields = first
        torn = HandoffAssembler(orphan_timeout_s=1.0)
        assert all(torn.offer(record, now=0.0) is None for record in records[:-1])
        assert torn.gc(now=2.0), torn.pending_ids()
        missing, _ = _generate(b, prompt + leg.tokens[:1], DISAGG_SAMPLINGS["greedy"], **fields)
        torn_exact = same_stream(missing, want, True, f"missing last chunk {kind}")
        _clear_prefix_cache(b)
        aborted = b.stats["tokens_wasted"].get("handoff_aborted", 0)
        imported = b.stats["handoff_imports"]
        bad = dict(leg.kv_handoff, block_size=99)
        broken, _ = _generate(b, prompt + leg.tokens[:1], DISAGG_SAMPLINGS["greedy"], kv_import=bad,
                              **fields)
        bad_exact = same_stream(broken, want, True, f"block_size 99 {kind}")
        assert b.stats["tokens_wasted"]["handoff_aborted"] - aborted == len(leg.kv_handoff["tokens"])
        assert b.stats["handoff_imports"] == imported
        gc.collect()
        snap = engine_lib.engines_snapshot()
        delta = {key: snap[key] - base.get(key, 0.0) for key in (
            "kv_handoff_exports_total", "kv_handoff_exported_bytes_total", "kv_handoff_imports_total",
            "kv_handoff_imported_bytes_total", "kv_handoff_imported_tokens_total")}
        assert delta == {
            "kv_handoff_exports_total": a.stats["handoff_exports"],
            "kv_handoff_exported_bytes_total": a.stats["handoff_export_bytes"],
            "kv_handoff_imports_total": b.stats["handoff_imports"],
            "kv_handoff_imported_bytes_total": b.stats["handoff_import_bytes"],
            "kv_handoff_imported_tokens_total": b.stats["handoff_import_tokens"],
        }, (delta, a.stats, b.stats)
        assert a.stats["handoff_exports"] == b.stats["handoff_imports"] == len(prompts) + warm_handoffs
        assert a.stats["tokens_wasted"].get("handoff_aborted", 0) == 0
        # the legs' journeys: the prefill leg ends in its export, the
        # decode leg starts with the transit and the import
        exported = check_journeys(label, f"handoff prefill legs, {kind}", legs)
        assert all("handoff_export" in [st["stage"] for st in r["stages"]] for r in exported.values())
        imported = check_journeys(label, f"handoff decode legs, {kind}", replays, imported=True)
        for record in imported.values():
            stages = [st["stage"] for st in record["stages"]]
            assert record["admit_class"] == "handoff-import", record
            assert stages[:3] == ["handoff_transit", "queue", "handoff_import"], stages
    finally:
        a.stop()
        b.stop()
    nbytes = max(n for _, _, n in exports)
    d2h_ms, h2d_ms = plain_copy_ms(nbytes)
    ok_imports = [(s, n) for s, n, ok in imports if ok]
    log(f"handoff {kind} [{label}]: Llama-3-8B int8 weights, eager, pipelined; " + "; ".join(
        f"prompt {r['len']} {r['sampling']}: {r['records']} records of at most {r['largest']} B, encode {r['encode_s']:.3f} s, "
        f"assemble {r['assemble_s']:.3f} s, B3/B6 {r['launches']} launches on the card for {r['model_calls']} model calls and {r['warm_calls']} warm-up calls, decode-leg TTFT with the import {r['ttft']:.1f} ms vs cold "
        f"{r['cold_ttft']:.1f} ms, stream {'equal' if r['exact'] else 'parted at a near-tie'} "
        f"(cold {'equal' if r['cold_exact'] else 'parted at a near-tie'})" for r in rows)
        + "; export (gather + D2H) " + ", ".join(
            f"{e * 1e3:.2f} ms = {n / e / 1e9:.2f} GB/s after a {w * 1e3:.3f} ms wait" for w, e, n in exports)
        + "; import (H2D + scatter) " + ", ".join(
            f"{s * 1e3:.2f} ms = {n / s / 1e9:.2f} GB/s" for s, n in ok_imports)
        + f"; plain pinned copy_ of {nbytes / 2**20:.1f} MiB: D2H {d2h_ms:.2f} ms = "
        f"{nbytes / d2h_ms / 1e6:.2f} GB/s, H2D {h2d_ms:.2f} ms = {nbytes / h2d_ms / 1e6:.2f} GB/s; "
        f"torn: missing last chunk {'equal' if torn_exact else 'parted at a near-tie'}, block_size 99 "
        f"{'equal' if bad_exact else 'parted at a near-tie'} ({len(leg.kv_handoff['tokens'])} tokens "
        f"billed handoff_aborted); engines_snapshot deltas {delta}")
    return dict(rows=rows, exports=exports, imports=imports, plain=(nbytes, d2h_ms, h2d_ms))


def _tier_scenario(eng, prompt1, prompt2, thrash, sampling, trace_id=None):
    """Prompt 1, the thrash prompts, prompt 2 (prompt 1 and 128 tokens
    more, with ``trace_id``); returns prompt 1's and 2's results, and
    prompt 2's TTFT. A thrash prompt only fills the pool: it is answered
    with one token, from its prefill, and its answer is not read."""
    first, _ = _generate(eng, prompt1, sampling)
    for prompt in thrash:
        _generate(eng, prompt, dict(sampling, max_new_tokens=1))
    second, ttft = _generate(eng, prompt2, sampling, trace_id=trace_id)
    return [first, second], ttft


def check_host_tier(label: str, config, params, kv_quant: bool) -> dict:
    """The host-DRAM tier at Llama-3-8B width (``tests/test_kv_tiers.py``'s
    scenario, scaled): an engine with ``kv_blocks`` 600 and
    ``kv_host_blocks`` 1024, and an oracle with the default pool (8 slots
    x 256 blocks + 1), which never evicts. Prompt 1 is 2048 tokens, six
    thrash prompts of 2048 tokens (one new token each) demote its chain,
    and prompt 2, prompt 1 and 128 tokens more, promotes it; greedy then
    seeded, 8 new tokens, on the same engine pair. The oracle answers
    prompts 1 and 2 alone: it never evicts, so the thrash prompts change
    nothing it computes (cut for the smoke's time when phase 18 came). Gates: the streams the oracle's, token for
    token (the promoted rows are the demoted ones, and both engines
    prefill the same suffix at the same offset); the tiered engine's pool
    rows of prompt 2's chain equal to the oracle's bit for bit;
    demotions, promotions, no promote aborts, no arena eviction. Then a
    fresh tiered engine under ``LANGSTREAM_FAULTS=host_promote_torn@step=1``
    (set and cleared here): the streams the oracle's
    (:func:`same_stream`: the torn promotion falls back to a cold prefill
    in windows) and promote aborts. Printed: the pinned host bytes held,
    ms per demoted block in admission (the host's time in the hook: it
    only enqueues), promote ms and GB/s (synchronized around the call),
    prompt 2's TTFT promoted, cold (the torn run) and an HBM hit (the
    oracle)."""
    from langstream_tpu_torch.runtime import faults

    rng = np.random.default_rng(13)
    prompt1 = [int(t) for t in rng.integers(1, config.vocab_size, size=2048)]
    prompt2 = prompt1 + [int(t) for t in rng.integers(1, config.vocab_size, size=128)]
    thrash = [[int(t) for t in rng.integers(1, config.vocab_size, size=2048)] for _ in range(6)]
    samplings = (dict(max_new_tokens=8), dict(max_new_tokens=8, temperature=0.8, seed=7))
    kind = "int8 KV" if kv_quant else "bf16 KV"
    started = time.perf_counter()
    tiered = _disagg_engine(config, params, kv_quant, kv_blocks=600, kv_host_blocks=1024)
    build_s = time.perf_counter() - started  # with the arena's memory pinned
    oracle = _disagg_engine(config, params, kv_quant)
    demotes, promotes = [], []
    demote_fn, promote_fn = tiered.kv_manager._demote_data, tiered._promote_host_chain

    def timed_demote(block):
        started = time.perf_counter()
        out = demote_fn(block)
        demotes.append(time.perf_counter() - started)
        return out

    def timed_promote(prompt, matched, matched_tokens, entries, fresh):
        torch.cuda.synchronize()
        started = time.perf_counter()
        count = promote_fn(prompt, matched, matched_tokens, entries, fresh)
        torch.cuda.synchronize()
        promotes.append((time.perf_counter() - started, sum(e.nbytes for e in entries[:count])))
        return count

    tiered.kv_manager._demote_data = timed_demote
    tiered._promote_host_chain = timed_promote
    try:
        ttfts, promoted = [], []
        for n, sampling in enumerate(samplings):
            promoted.append(f"host-tier-{'int8' if kv_quant else 'bf16'}-{n}")
            got, ttft = _tier_scenario(tiered, prompt1, prompt2, thrash, sampling, promoted[-1])
            want, hbm_ttft = _tier_scenario(oracle, prompt1, prompt2, (), sampling)
            assert [r.tokens for r in got] == [r.tokens for r in want], (n, got, want)
            ttfts.append((ttft, hbm_ttft))
            if n == 0:
                oracle_first = want
                chain_t, matched_t = tiered.kv_manager.match(prompt2)
                chain_o, matched_o = oracle.kv_manager.match(prompt2)
                assert matched_t == matched_o >= 2048, (matched_t, matched_o)
                rows_t, rows_o = _pool_rows(tiered, chain_t[:128]), _pool_rows(oracle, chain_o[:128])
                for leaf in rows_t:
                    assert torch.equal(rows_t[leaf], rows_o[leaf]), leaf
        stats = {key: tiered.stats[key] for key in (
            "host_demotions", "host_demote_bytes", "host_promotions", "host_promote_bytes",
            "kv_host_hit_tokens", "host_promote_aborts")}
        arena = tiered.kv_host_arena.snapshot_stats()
        entry = next(iter(tiered.kv_host_arena._entries.values()))
        pinned = all(rows.is_pinned() for rows in entry.data.values())
        held = arena["blocks_in_use"] * entry.nbytes
        assert stats["host_demotions"] > 0 and stats["host_promotions"] > 0, stats
        assert stats["host_promote_aborts"] == 0, stats
        assert oracle.kv_manager.stats["evictions"] == 0, oracle.kv_manager.stats
        assert pinned
        # prompt 2's admissions were served by the host tier
        journeys = check_journeys(label, f"host tier prompt 2, {kind}", promoted)
        assert all(r["admit_class"] == "host-promote" for r in journeys.values()), journeys
    finally:
        tiered.stop()
    faults.reset()
    os.environ["LANGSTREAM_FAULTS"] = "host_promote_torn@step=1"
    try:
        torn = _disagg_engine(config, params, kv_quant, kv_blocks=600, kv_host_blocks=1024)
    finally:
        del os.environ["LANGSTREAM_FAULTS"]
    try:
        # first use of the long path's variants, uncounted (prompt 2's
        # cold fallback runs the 2048-token window at an offset)
        _generate(torn, [int(t) for t in rng.integers(1, config.vocab_size, size=2100)], samplings[0])
        got, cold_ttft = _tier_scenario(torn, prompt1, prompt2, thrash, samplings[0])
        torn_exact = [same_stream(g, w, True, f"torn promotion {kind}") for g, w in zip(got, oracle_first)]
        assert torn.stats["host_promote_aborts"] >= 1 and torn.stats["host_promotions"] == 0, torn.stats
    finally:
        torn.stop()
        oracle.stop()
        faults.reset()
    per_block = sum(demotes) / len(demotes) * 1e3
    log(f"host tier {kind} [{label}]: Llama-3-8B int8 weights, eager, pipelined; the tiered engine "
        f"built in {build_s:.2f} s, its arena's memory pinned; {stats}; arena "
        f"{arena}; {held / 2**30:.3f} GiB of {'pinned' if pinned else 'pageable'} host memory held "
        f"({entry.nbytes} B a block); demote {per_block:.4f} ms of host time per block in admission "
        f"({len(demotes)} blocks); promote (H2D + scatter, synchronized) {len(promotes)} calls, "
        f"{sum(n for _, n in promotes) / 2**20:.1f} MiB in {sum(s for s, _ in promotes) * 1e3:.2f} ms = "
        f"{sum(n for _, n in promotes) / sum(s for s, _ in promotes) / 1e9:.2f} GB/s, the largest "
        f"{max(n for _, n in promotes) / 2**20:.1f} MiB in {max(promotes, key=lambda p: p[1])[0] * 1e3:.2f} ms"
        + f"; prompt 2's TTFT promoted {ttfts[0][0]:.1f} ms (greedy) / {ttfts[1][0]:.1f} ms (seeded), "
        f"cold (torn promotion) {cold_ttft:.1f} ms, HBM hit (oracle) {ttfts[0][1]:.1f} ms; torn run "
        f"{torn.stats['host_promote_aborts']} promote aborts, streams "
        f"{['equal' if e else 'parted at a near-tie' for e in torn_exact]}")
    return dict(stats=stats, demote_ms=per_block, promotes=promotes, ttfts=ttfts, cold_ttft=cold_ttft)


def check_disagg_and_tiers(label: str) -> None:
    """Phase 12 at Llama-3-8B width: int8 weights drawn once on the card
    (seed 0) and shared by every engine of the phase; the handoff over
    bf16 and int8 pools, then the host tier over int8 and bf16 pools."""
    from langstream_tpu_torch.providers.torch_local.quant import init_quantized_params

    started = time.perf_counter()
    config = model.LlamaConfig.llama3_8b()
    params = init_quantized_params(config, seed=0, device="cuda")
    parts = []
    for check, kv_quant in ((check_handoff, False), (check_handoff, True),
                            (check_host_tier, True), (check_host_tier, False)):
        part = time.perf_counter()
        check(label, config, params, kv_quant)
        gc.collect()
        torch.cuda.empty_cache()
        parts.append(f"{check.__name__} {'int8' if kv_quant else 'bf16'} KV {time.perf_counter() - part:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 12 (disaggregation and the host tier) [{label}]: {time.perf_counter() - started:.1f} s "
        f"({', '.join(parts)}; {threading.active_count()} threads in the process)")


# ---------------------------------------------------------------------- #
# training on the card: the differentiable forward, the CE loss, AdamW,
# step-directory checkpoints, resume, and the checkpoint served back
# ---------------------------------------------------------------------- #
TRAIN_DIR = os.path.join("build", "train-checkpoint")
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, SAVE_AFTER = 4, 1024, 6, 3
# the 2-layer train step on the card (bf16) against the CPU (f32) from the
# same weights: the loss, relative, and each leaf's gradient by cosine
TRAIN_LOSS_TOLERANCE = 1e-2
TRAIN_GRAD_COSINE = 0.99
# a resumed step's loss against the original's: the embedding and gather
# backward on CUDA accumulate with atomics, so not bit for bit
RESUME_TOLERANCE = 1e-3


def train_flops(config, batch: int, seq: int, remat: bool) -> Tuple[float, float]:
    """(model FLOPs, executed FLOPs) of one train step, from the code's
    shapes: each matmul 2·m·n·k, the plain attention's two products over
    the whole T×T grid per head (padding included: the plain version
    computes it), the backward twice the forward; ``remat`` runs the
    layers' forward once more."""
    tokens = batch * seq
    h, f, hd = config.hidden_size, config.intermediate_size, config.dims_per_head
    nh, nkv = config.num_heads, config.num_kv_heads
    layer = (2 * tokens * (h * (nh + 2 * nkv) * hd + nh * hd * h + 3 * h * f)
             + 4 * batch * nh * seq * seq * hd)
    forward = config.num_layers * layer + 2 * tokens * h * config.vocab_size
    return 3 * forward, 3 * forward + (config.num_layers * layer if remat else 0)


def _train_batch(config, batch: int, seq: int, seed: int):
    """Random tokens [B, T] from ``seed`` with the last row right-padded
    to half its length."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, config.vocab_size, size=(batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), dtype=bool)
    mask[-1, seq // 2:] = False
    return tokens, mask


def check_training_against_cpu(device, layers: int = 2, batch: int = 2, seq: int = 128,
                               config=None) -> dict:
    """``llama3_1b`` (or the bf16 ``config`` given) at full width and
    ``layers`` deep: one loss and its gradients (``trainer.loss_fn``, the
    plain attention, remat on; a MoE config adds the router's aux loss,
    its MLP in the capacity regime) in bf16 on the card against the port
    in f32 on the CPU from the same weights. Gates: the loss within
    ``TRAIN_LOSS_TOLERANCE`` relative, every leaf's gradient at cosine
    ``TRAIN_GRAD_COSINE`` or more. A MoE config's CPU run routes each
    token to the experts the card chose (:func:`routed_as`): bf16
    activations flip a router's choice at a near-tie, which moves that
    token's output by a whole expert; every token the CPU would have
    routed otherwise must be such a near-tie on the card (its k-th and
    (k+1)-th router logits within ``ROUTER_NEAR_TIE``, and within it of
    the CPU's), and is counted."""
    from langstream_tpu_torch.training.trainer import loss_fn

    config = dataclasses.replace(config or model.LlamaConfig.llama3_1b(), num_layers=layers)
    cpu_config = dataclasses.replace(config, dtype=torch.float32)
    params = model.init_params(config, seed=0, device=device)
    tokens, mask = _train_batch(config, batch, seq, seed=1)
    grads, losses, choices = {}, {}, {}
    for side, where, cfg in (("card", device, config), ("cpu", torch.device("cpu"), cpu_config)):
        leaves = {name: leaf.detach().to(where, cfg.dtype if leaf.dtype == config.dtype else leaf.dtype)
                  .requires_grad_() for name, leaf in params.items()}
        with routed_as(choices.get("card") if side == "cpu" else None) as choices[side]:
            loss = loss_fn(cfg, leaves, torch.from_numpy(tokens).to(where),
                           torch.from_numpy(mask).to(where), model.model_freqs(cfg, device=where),
                           remat=True)
            loss.backward()
        losses[side] = float(loss.detach())
        grads[side] = {name: leaf.grad.float().cpu() for name, leaf in leaves.items()}
    cosines = {name: float(F.cosine_similarity(grads["card"][name].flatten(), grad.flatten(), dim=0))
               for name, grad in grads["cpu"].items()}
    loss_err = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    worst = min(cosines, key=cosines.get)
    assert loss_err <= TRAIN_LOSS_TOLERANCE, (losses, loss_err)
    assert all(math.isfinite(c) and c >= TRAIN_GRAD_COSINE for c in cosines.values()), cosines
    flips = tokens_routed = 0
    for (card_ids, card_logits), (cpu_ids, cpu_logits) in zip(choices["card"], choices["cpu"]):
        k = card_ids.shape[-1]
        differ = (card_ids.sort(-1).values != cpu_ids.sort(-1).values).any(-1)
        top = card_logits.sort(-1, descending=True).values
        gaps = (top[..., k - 1] - top[..., k])[differ]
        noise = (card_logits - cpu_logits)[differ].abs()
        assert not bool(differ.any()) or (float(gaps.max()) <= ROUTER_NEAR_TIE
                                          and float(noise.max()) <= ROUTER_NEAR_TIE), (gaps, noise)
        flips += int(differ.sum())
        tokens_routed += differ.numel()
    return {"loss_card": losses["card"], "loss_cpu": losses["cpu"], "loss_err": loss_err,
            "worst_leaf": worst, "worst_cosine": cosines[worst], "router_flips": flips,
            "tokens_routed": tokens_routed}


@contextlib.contextmanager
def routed_as(choices=None):
    """Yields a list of (expert ids, f32 router logits) of every routing
    ``ops/moe.py`` makes in the block, on the host, in call order (a
    remat recompute routes again). With ``choices``, such a list from a
    run of the same calls, each routing takes the experts recorded there
    instead of its own top-k (the gates renormalized over those
    experts' probabilities); its own choice is what the yielded list
    records."""
    original = moe_lib._top_gates
    taken = []

    def top_gates(logits, k):
        probs, gate_vals, gate_idx, onehot = original(logits, k)
        taken.append((gate_idx.detach().cpu(), logits.detach().float().cpu()))
        if choices is None:
            return probs, gate_vals, gate_idx, onehot
        ids = choices[len(taken) - 1][0].to(logits.device)
        gate_vals = torch.gather(probs, -1, ids)
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
        return probs, gate_vals, ids, moe_lib._one_hot(ids, logits.shape[-1])

    moe_lib._top_gates = top_gates
    try:
        yield taken
    finally:
        moe_lib._top_gates = original


def _timed_step(trainer, tokens, mask) -> Tuple[float, float]:
    torch.cuda.synchronize()
    started = time.perf_counter()
    loss = trainer.train_step(tokens, mask)  # a float: the step has ended
    return loss, (time.perf_counter() - started) * 1e3


def _state_tensors(trainer) -> dict:
    state = trainer.opt_state
    out = {f"params/{name}": leaf.detach() for name, leaf in trainer.params.items()}
    out.update({f"mu/{name}": leaf for name, leaf in state["mu"].items()})
    out.update({f"nu/{name}": leaf for name, leaf in state["nu"].items()})
    return out


def check_training(device, label: str) -> None:
    """Phase 13: ``llama3_1b`` (Llama-3.2-1B's shape) trained on the card
    at full depth, checkpointed, resumed and served back; see the module's
    docstring. Writes under ``build/`` and removes its checkpoint."""
    from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService
    from langstream_tpu_torch.training.checkpoint import CheckpointManager
    from langstream_tpu_torch.training.trainer import TrainConfig, Trainer

    started = time.perf_counter()
    small = check_training_against_cpu(device)
    log(f"training, 2 layers, card (bf16) vs CPU (f32) [{label}]: loss {small['loss_card']:.6f} vs "
        f"{small['loss_cpu']:.6f} (rel {small['loss_err']:.2e}, tol {TRAIN_LOSS_TOLERANCE}), worst "
        f"gradient cosine {small['worst_cosine']:.5f} ({small['worst_leaf']}; gate >= {TRAIN_GRAD_COSINE}), "
        f"{time.perf_counter() - started:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    config = model.LlamaConfig.llama3_1b()
    tokens, mask = _train_batch(config, TRAIN_BATCH, TRAIN_SEQ, seed=2)
    # a save is the params and both Adam moments, in the params' dtypes
    save_bytes = 3 * config.num_params() * 2
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    free = shutil.disk_usage(TRAIN_DIR).free
    if free < 1.05 * save_bytes:
        raise RuntimeError(f"the training phase needs {save_bytes / 1e9:.1f} GB of disk under "
                           f"{TRAIN_DIR}, {free / 1e9:.1f} GB are free")
    try:
        drawn = model.init_params(config, seed=0, device=device)
        trainer = Trainer(config, drawn, train_config=TrainConfig(learning_rate=1e-3, remat=True),
                          device=device)
        del drawn
        manager = CheckpointManager(TRAIN_DIR)
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for step in range(1, TRAIN_STEPS + 1):
            if step == SAVE_AFTER + 1:
                # the step-3 state, kept on the card for the restore's gate
                torch.cuda.synchronize()
                train_peak = torch.cuda.max_memory_allocated() / 2**30
                snapshot = {name: leaf.clone() for name, leaf in _state_tensors(trainer).items()}
                torch.cuda.synchronize()
                save_started = time.perf_counter()
                trainer.save_checkpoint(manager)
                save_ms = (time.perf_counter() - save_started) * 1e3
            loss, ms = _timed_step(trainer, tokens, mask)  # step 4 runs beside the write
            losses.append(loss)
            step_ms.append(ms)
            if step == SAVE_AFTER + 1:
                manager.wait()
                wait_ms = (time.perf_counter() - save_started) * 1e3
        assert all(math.isfinite(loss) for loss in losses) and losses[-1] < losses[0], losses
        written = sum(os.path.getsize(os.path.join(root, name))
                      for root, _, names in os.walk(TRAIN_DIR) for name in names)
        median_ms = float(np.median(step_ms[1:]))
        model_flops, executed = train_flops(config, TRAIN_BATCH, TRAIN_SEQ, remat=True)
        log(f"training llama3_1b ({config.num_params() / 1e9:.3f} B params, {config.num_layers} layers, bf16, AdamW, "
            f"remat) B {TRAIN_BATCH} x T {TRAIN_SEQ}, one row padded to {TRAIN_SEQ // 2} [{label}]: losses "
            + ", ".join(f"{loss:.4f}" for loss in losses)
            + f"; step ms " + ", ".join(f"{ms:.1f}" for ms in step_ms)
            + f" (median of steps 2-{TRAIN_STEPS} {median_ms:.1f}); "
            f"{TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3:.0f} tokens/s; peak {train_peak:.2f} GiB; "
            f"model FLOPs {model_flops:.3e} a step (MFU {model_flops / (median_ms / 1e3) / PEAK_BF16_FLOPS:.4f} "
            f"of 989 TFLOP/s), executed with the recompute {executed:.3e} "
            f"({executed / (median_ms / 1e3) / PEAK_BF16_FLOPS:.4f}; at the peak {executed / PEAK_BF16_FLOPS * 1e3:.1f} ms)")
        log(f"checkpoint of step {SAVE_AFTER} [{label}]: save() returned in {save_ms:.0f} ms "
            f"({written / save_ms / 1e6:.2f} GB/s to host memory), committed after {wait_ms:.0f} ms "
            f"({written / wait_ms / 1e6:.2f} GB/s end to end), {written / 1e9:.2f} GB on disk; step "
            f"{SAVE_AFTER + 1} beside the write {step_ms[SAVE_AFTER]:.1f} ms")

        # one step without remat, after one that grows the allocator
        trainer.train_config.remat = False
        _timed_step(trainer, tokens, mask)
        torch.cuda.reset_peak_memory_stats()
        _, plain_ms = _timed_step(trainer, tokens, mask)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        model_flops, executed = train_flops(config, TRAIN_BATCH, TRAIN_SEQ, remat=False)
        log(f"training without remat [{label}]: {plain_ms:.1f} ms a step (remat {median_ms:.1f}), peak "
            f"{plain_peak:.2f} GiB (remat {train_peak:.2f}), MFU "
            f"{model_flops / (plain_ms / 1e3) / PEAK_BF16_FLOPS:.4f}")
        # where a remat step's device time goes (two more steps)
        trainer.train_config.remat = True
        log(f"remat step's kernels [{label}]: "
            + top_kernels(lambda: trainer.train_step(tokens, mask), top=8))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # resume: a fresh trainer from another seed takes step 3 back
        restore_started = time.perf_counter()
        fresh = Trainer(config, model.init_params(config, seed=1, device=device),
                        train_config=TrainConfig(learning_rate=1e-3, remat=True), device=device)
        assert fresh.restore_checkpoint(CheckpointManager(TRAIN_DIR)) == SAVE_AFTER
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - restore_started
        restored = _state_tensors(fresh)
        assert restored.keys() == snapshot.keys()
        for name, leaf in restored.items():
            assert leaf.dtype == snapshot[name].dtype and torch.equal(leaf, snapshot[name]), name
        resumed = fresh.train_step(tokens, mask)
        resume_err = abs(resumed - losses[SAVE_AFTER]) / abs(losses[SAVE_AFTER])
        assert resume_err <= RESUME_TOLERANCE, (resumed, losses[SAVE_AFTER])
        log(f"resume [{label}]: a fresh trainer (seed 1) restored step {SAVE_AFTER} in {restore_s:.1f} s, "
            f"{len(restored)} tensors bit for bit the step-{SAVE_AFTER} state; its next loss {resumed:.6f} "
            f"vs {losses[SAVE_AFTER]:.6f} (rel {resume_err:.2e}, tol {RESUME_TOLERANCE})")
        del fresh, restored
        gc.collect()
        torch.cuda.empty_cache()

        # served back: the provider loads the step directory (the latest
        # step, 3), against an engine over the trainer's own step-3 tensors
        served = time.perf_counter()
        engine_config = {"max-seq-len": 1024, "pipeline-decode": True, "sampling-seed": 0}
        with launches_lib.device_launches() as counts:
            service = TorchCompletionsService({
                "checkpoint": TRAIN_DIR, "tokenizer": {"type": "byte"}, "engine": engine_config,
            }, device=device)
            try:
                load_s = service.load_s
                eng = service.engine
                for name, leaf in eng.params.items():
                    assert torch.equal(leaf, snapshot[f"params/{name}"]), name
                calls = []  # (prompt tokens, sampling, stop tokens, result) of each request
                generate = eng.generate

                async def record(prompt_tokens, sampling_params, **kwargs):
                    result = await generate(prompt_tokens, sampling_params, **kwargs)
                    calls.append((prompt_tokens, sampling_params, kwargs.get("stop_tokens"), result))
                    return result

                eng.generate = record
                rng = np.random.default_rng(3)

                async def complete():
                    # one request at a time: the same schedule on both
                    # engines (a prefill group of one, then its decode)
                    for n_bytes in (40, 90, 150, 220):
                        await service.get_text_completions([prompt_text(rng, n_bytes)],
                                                           {"max-tokens": 24})

                asyncio.run(complete())
            finally:
                service.close()
        assert counts["flash_prefill"] > 0 and counts["flash_decode"] > 0, counts
        assert len(calls) == 4 and all(len(call[3].tokens) > 0 for call in calls), calls
        twin = engine_lib.DecodeEngine(
            config, {name[len("params/"):]: leaf for name, leaf in snapshot.items()
                     if name.startswith("params/")},
            device=device, max_slots=eng.max_slots, max_seq_len=eng.max_seq_len,
            prefill_buckets=eng.prefill_buckets, decode_chunk=eng.decode_chunk,
            pipeline_decode=eng.pipeline_decode)
        twin.start()

        async def replay():
            return [(await twin.generate(prompt, sampling, stop_tokens=stop)).tokens
                    for prompt, sampling, stop, _ in calls]

        try:
            twin_streams = asyncio.run(replay())
        finally:
            twin.stop()
        served_streams = [list(call[3].tokens) for call in calls]
        assert served_streams == [list(tokens) for tokens in twin_streams], (served_streams, twin_streams)
        log(f"served back [{label}]: TorchCompletionsService over {TRAIN_DIR} (step {SAVE_AFTER}) loaded "
            f"in {load_s:.1f} s, its params bit for bit the trainer's; 4 greedy text completions "
            f"({sum(map(len, served_streams))} tokens) equal to an in-process engine's over the trainer's tensors; B1 {counts['flash_prefill']} "
            f"and B2 {counts['flash_decode']} launches by their card counters; "
            f"{time.perf_counter() - served:.1f} s")
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    log(f"phase 13 (training) [{label}]: {time.perf_counter() - started:.1f} s (budget 90 s)")

# ---------------------------------------------------------------------- #
# phase 14: the Mixtral mixture-of-experts family
# ---------------------------------------------------------------------- #
MOE_CHECKPOINT_DIR = os.path.join("build", "mixtral-checkpoint")
# depth of the served Mixtral-8x7B: its 32 layers are 93.4 GB of bf16
# weights (the experts stay bf16 under int8 weights), more than one card
# holds; 16 layers were served until the tensor-parallel phase came, cut
# to 8 (23.74 GB) then by the phase's printed wall (its precompile)
MOE_SERVE_LAYERS = 8
MOE_DECODE_STEPS = 8
# the paged run and the CPU's take the dense card run's experts; where a
# token's own top-k differs, the dense run's k-th and (k+1)-th router
# logits must lie within this of each other, and the run's router logits
# within this of the dense run's: a near-tie that rounding flipped.
# Router logits of the random model are about N(0, 1) (normed
# activations against N(0, 1/H) weights), so this is a tenth of their
# scale; a flip needs a gap below the two runs' difference, printed (it
# was 2.5e-2 to 3.0e-2 card against CPU). An expert routed wrongly parts
# at the typical gap instead (about 0.4 between the 2nd and 3rd of 8)
ROUTER_NEAR_TIE = 1e-1


def _moe_run(config, params, where, layout: str, feed=None, choices=None):
    """Two prompts (64 and 41 tokens) prefilled, then ``MOE_DECODE_STEPS``
    decode steps of both rows, on ``layout`` (``paged``: 16-token
    blocks). Decode feeds ``feed``, or its own argmax; each token goes
    to the experts ``choices`` gave it, or to its own (:func:`routed_as`).
    Returns the logits of each stage (f32, host), the routings (each MoE
    MLP call's own expert ids and f32 router logits, on the host, in call
    order: stage by stage, layer by layer), the tokens fed, the kernels'
    launches on the card (by their device counters; empty off the card)
    and the prompts' lengths."""
    rng = np.random.default_rng(29)
    prompts = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 64)))
    lengths = torch.tensor([64, 41], dtype=torch.int32)
    freqs = model.model_freqs(config, device=where)
    block, width = 16, 128 // 16
    tables = (torch.from_numpy(rng.permutation(2 * width) + 1).view(2, width)
              .to(torch.int32).to(where))
    if layout == "paged":
        cache = model.init_paged_cache(config, 2 * width + 1, block, device=where)
    else:
        cache = model.init_cache(config, 2, 128, device=where)
    on_card = torch.device(where).type == "cuda"
    stages, fed = [], []
    with contextlib.ExitStack() as stack:
        routings = stack.enter_context(routed_as(choices))
        launches = stack.enter_context(launches_lib.device_launches(shapes=True)) if on_card else {}
        if layout == "paged":
            logits = model.paged_prefill(config, params, cache, prompts.to(where), lengths.to(where),
                                         tables, freqs)
        else:
            logits = model.prefill(config, params, cache, prompts.to(where), lengths.to(where),
                                   torch.arange(2, device=where), freqs)
        stages.append(logits.float().cpu())
        step_lengths = lengths + 1
        for step in range(MOE_DECODE_STEPS):
            tokens = feed[step] if feed is not None else stages[-1].argmax(-1)
            fed.append(tokens)
            args = (tokens.to(where), step_lengths.to(where))
            if layout == "paged":
                logits = model.paged_decode_step(config, params, cache, *args, tables, freqs)
            else:
                logits = model.decode_step(config, params, cache, *args, freqs)
            stages.append(logits.float().cpu())
            step_lengths = step_lengths + 1
    assert len(routings) == config.num_layers * len(stages), (len(routings), len(stages))
    return stages, routings, fed, dict(launches), lengths


def _row_tokens(stage: int, row: int, lengths) -> slice:
    """A routing's rows of ``row``'s real tokens: a prefill's [2, 64]
    grid flattened, a decode step's one token a row."""
    return slice(row * 64, row * 64 + int(lengths[row])) if stage == 0 else slice(row, row + 1)


def routed_flips(run, reference, config, label: str) -> dict:
    """For ``run``, routed as ``reference`` (the dense card run): every
    real token whose own top-k experts differ from those it was given
    must be a near-tie, the reference's k-th and (k+1)-th router logits
    within ``ROUTER_NEAR_TIE`` and the run's router logits within it of
    the reference's. Returns the flips, the tokens routed, the largest
    gap of a flip and the largest router-logit difference."""
    k, lengths = config.num_experts_per_tok, run[4]
    flips = routed = 0
    worst_gap = router_diff = 0.0
    for call, ((ids, logits), (ref_ids, ref_logits)) in enumerate(zip(run[1], reference[1])):
        for row in range(2):
            tokens = _row_tokens(call // config.num_layers, row, lengths)
            noise = (logits[tokens] - ref_logits[tokens]).abs().max(-1).values
            differ = (ids[tokens].sort(-1).values != ref_ids[tokens].sort(-1).values).any(-1)
            router_diff = max(router_diff, float(noise.max()))
            routed += differ.numel()
            if bool(differ.any()):
                top = ref_logits[tokens].sort(-1, descending=True).values
                gaps = (top[:, k - 1] - top[:, k])[differ]
                assert float(gaps.max()) <= ROUTER_NEAR_TIE and float(noise[differ].max()) <= ROUTER_NEAR_TIE, (
                    f"{label}: call {call}, row {row} would choose other experts than the card's dense run, "
                    f"with router gaps {gaps.tolist()} and router logits {noise[differ].tolist()} off "
                    f"(no near-tie)")
                flips += int(differ.sum())
                worst_gap = max(worst_gap, float(gaps.max()))
    return dict(flips=flips, routed=routed, worst_gap=worst_gap, router_diff=router_diff)


def check_moe_against_cpu(device, label: str):
    """``mixtral_8x7b`` at full width, 2 layers, bf16, random from seed 0:
    two prompts and 8 decode steps on the card, dense (B1, B2) and paged
    (B3), each against one run of the port on the CPU in bf16 from the
    same weights (dense, plain path, fed the card's dense tokens). The
    paged run and the CPU's route every token to the experts the card's
    dense run chose (:func:`routed_as`; bf16 rounding flips a choice at a
    near-tie, which moves that token's output by a whole expert), each
    token that would have gone elsewhere held to a near-tie
    (:func:`routed_flips`); then every row of every stage of each layout
    within ``MODEL_TOLERANCE`` of the stage's max |CPU logit|. B1 and B2
    (B3) once per layer per call by their card counters. Returns the
    config and the card's params."""
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on: the router must run in f32"
    started = time.perf_counter()
    config = dataclasses.replace(model.LlamaConfig.mixtral_8x7b(max_seq_len=128), num_layers=2)
    params = model.init_params(config, seed=0, device=device)
    dense = _moe_run(config, params, device, "dense")
    paged = _moe_run(config, params, device, "paged", feed=dense[2], choices=dense[1])
    cpu_started = time.perf_counter()
    cpu = _moe_run(config, {name: p.cpu() for name, p in params.items()}, "cpu", "dense", feed=dense[2],
                   choices=dense[1])
    cpu_s = time.perf_counter() - cpu_started
    calls = 1 + MOE_DECODE_STEPS
    layers = config.num_layers
    launches = dense[3], paged[3]
    assert launches[0]["flash_prefill"] == layers and launches[0]["flash_decode"] == layers * MOE_DECODE_STEPS, launches
    assert launches[1]["paged_attention"] == layers * calls, launches
    assert launches[1]["paged_attention/prefill"] == layers, launches
    assert all(n == 0 for name, n in launches[0].items() if name not in ("flash_prefill", "flash_decode"))
    assert all(n == 0 for name, n in launches[1].items()
               if name not in ("paged_attention", "paged_attention/prefill"))
    flips = {side: routed_flips(run, dense, config, f"MoE {side}") for side, run in (("paged", paged), ("CPU", cpu))}
    errors = {}
    for layout, run in (("dense", dense), ("paged", paged)):
        worst, compared = 0.0, 0
        for stage, (out, ref) in enumerate(zip(run[0], cpu[0])):
            assert out.shape == ref.shape and bool(torch.isfinite(out).all()), (layout, stage)
            worst = max(worst, float((out - ref).abs().max()) / float(ref.abs().max()))
            compared += out.shape[0]
        assert compared == 2 * calls, (layout, compared)
        assert worst < MODEL_TOLERANCE, f"MoE {layout} model on the card disagrees with the CPU: {worst}"
        errors[layout] = worst
    log(f"MoE reference [{label}]: Mixtral-8x7B width (8 experts, top 2), 2 layers, bf16, seed 0; two "
        f"prompts (64, 41 tokens) + {MOE_DECODE_STEPS} decode steps, card vs one CPU run (dense, plain, "
        f"bf16; {cpu_s:.1f}s), the paged run and the CPU routed as the card's dense run: " + "; ".join(
            f"{layout} ({'B1/B2' if layout == 'dense' else 'B3'}: {dict((n, c) for n, c in run[3].items() if c)}) "
            f"max_rel_err {errors[layout]:.3e} over all {2 * calls} rows (tol {MODEL_TOLERANCE})"
            for layout, run in (("dense", dense), ("paged", paged))) + "; " + "; ".join(
            f"{side}: {f['flips']} of {f['routed']} token routings would have parted from the card's dense "
            f"run, each at a near-tie (largest gap {f['worst_gap']:.3e} <= {ROUTER_NEAR_TIE}), router logits "
            f"max |diff| {f['router_diff']:.3e}" for side, f in flips.items())
        + f"; {time.perf_counter() - started:.1f}s")
    return config, params, {layout: dict(run[3]) for layout, run in (("dense", dense), ("paged", paged))}


def check_moe_checkpoint(device, config, params, label: str, path: str = MOE_CHECKPOINT_DIR) -> None:
    """The 2-layer Mixtral's weights written as a HF Mixtral directory
    (``block_sparse_moe`` experts and router) by
    :func:`write_hf_checkpoint`, after checking the disk holds it, and
    loaded back onto the card with ``weights.load_safetensors_checkpoint``:
    its config equal, every leaf bit for bit. The directory is removed."""
    from langstream_tpu_torch.providers.torch_local import weights

    needed = int(config.num_params() * 2 * 1.05)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    free = shutil.disk_usage(os.path.dirname(path)).free
    if free < needed:
        raise RuntimeError(f"the MoE checkpoint gate needs {needed / 1e9:.1f} GB of disk under "
                           f"{os.path.dirname(path)}, {free / 1e9:.1f} GB are free")
    try:
        started = time.perf_counter()
        written = write_hf_checkpoint(path, config, params)
        write_s = time.perf_counter() - started
        started = time.perf_counter()
        loaded_config, loaded = weights.load_safetensors_checkpoint(path, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - started
        assert loaded_config == config, (loaded_config, config)
        assert sorted(loaded) == sorted(params), (sorted(loaded), sorted(params))
        for name, leaf in params.items():
            assert loaded[name].dtype == leaf.dtype and torch.equal(loaded[name], leaf), name
        with open(os.path.join(path, "model.safetensors.index.json")) as fh:
            names = json.load(fh)["weight_map"]
        experts = sum(".experts." in name for name in names)
        log(f"MoE checkpoint [{label}]: the 2-layer Mixtral-8x7B written as a HF Mixtral directory "
            f"({len(names)} tensors, {experts} of them experts' w1/w2/w3, the router as "
            f"block_sparse_moe.gate), {written / 1e9:.2f} GB in {write_s:.1f}s, loaded with "
            f"weights.load_safetensors_checkpoint in {load_s:.1f}s: config equal (num_experts "
            f"{loaded_config.num_experts}, top {loaded_config.num_experts_per_tok}), {len(params)} leaves "
            f"equal bit for bit (w_gate {list(loaded['w_gate'].shape)}, router {list(loaded['router'].shape)})")
        del loaded
    finally:
        shutil.rmtree(path, ignore_errors=True)


def check_moe(device, label: str) -> dict:
    """Phase 14: the Mixtral family on the card. The 2-layer full-width
    model against the CPU (:func:`check_moe_against_cpu`), its HF
    checkpoint (:func:`check_moe_checkpoint`), then ``serve --model
    mixtral-8x7b --precompile`` at ``MOE_SERVE_LAYERS`` layers answering
    the dense phase's bursts (:func:`serve_dense_and_check`: every
    request answered, no capture while serving, B1 and B2 once per layer
    per model call by their card counters, MFU, MBU and prefill MFU in
    (0, 1.05], the bare decode step's device ms and MBU). Returns the
    served phase's counts."""
    started = time.perf_counter()
    config, params, _ = check_moe_against_cpu(device, label)
    check_moe_checkpoint(device, config, params, label)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    served = serve_dense_and_check(label, model_name="mixtral-8x7b", layers=MOE_SERVE_LAYERS)
    log(f"MoE phase [{label}]: Mixtral-8x7B at {MOE_SERVE_LAYERS} layers served: "
        f"{served['tok_s']:.1f} / {served['uniform_tok_s']:.1f} tok/s (mixed-length / uniform burst), "
        f"mean TTFT {served['ttft_ms']:.1f} / {served['uniform_ttft_ms']:.1f} ms, peak "
        f"{served['peak_gib']:.2f} GiB, bare decode step {served['timing']['device_ms']:.3f} device ms "
        f"(MBU {served['timing']['mbu']:.3f}); B1 {served['flash_prefill']}, B2 {served['flash_decode']} "
        f"launches; the phase {time.perf_counter() - started:.1f}s")
    return served


# ---------------------------------------------------------------------- #
# phase 15: tensor parallelism, two ranks sharing the card over gloo
# ---------------------------------------------------------------------- #
TP = 2
# seconds a rank waits for the other (the rendezvous, every collective,
# the mirror's join and the ranks' exits): a rank that dies fails the phase
TP_TIMEOUT_S = 240
TP_SEED = 7
TP_LOGS = os.path.join("build", "tp")
# the served tp phase: 9 slots, prompts in one 256 bucket (each eager
# warm-up of a larger one stages 2 × 32 activations of its every token
# through the host), the dense phase's first greedy prompts and its SSE
# chat
TP_REQUESTS = 8
TP_SLOTS = TP_REQUESTS + 1  # the completions and the SSE chat at once
TP_BUCKET = 256
TP_TOPK = 5
# the served tp streams against one card's: two bf16 steps of a logit at
# the magnitudes these logits reach (8-16, where bf16 keeps 1/16). Every
# rank's column products (q, k, v, the MLP's gate and up, the head) run
# at half one card's width, where cuBLAS may sum in another order, so
# the last bit of a hidden value, and with it a logit's bf16 step, can
# differ from one card's (on the H100: a logprob 0.0622 apart at a token
# both runs chose)
TP_NEAR_TIE = 0.125


def _tp_config(layers: int = 2):
    return dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=256), num_layers=layers)


def tp_sequence(config, params, where, kv_quant: bool, count: bool = False):
    """The 2-layer tp check's model calls on ``where``: dense, a cold
    prefill of two prompts and two decode steps; paged (16-token blocks),
    a cold prefill, a prefill at an offset of a third row onto the first
    prompt's first two blocks, two decode steps (a fourth, empty row
    rides along) and a mixed step (``paged_mixed_step``). Inputs from
    :data:`TP_SEED`. Returns the logits by call
    (f32, on the host) and, with ``count``, each call's kernel launches
    by the card's counters."""
    rng = np.random.default_rng(TP_SEED)
    prompts = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 48)))
    suffix = torch.from_numpy(rng.integers(0, config.vocab_size, size=(1, 16)))
    steps = torch.from_numpy(rng.integers(0, config.vocab_size, size=(2, 4)))
    window = torch.from_numpy(rng.integers(0, config.vocab_size, size=(4, 16)))
    width, block = 16, 16
    tables = np.zeros((4, width), dtype=np.int32)
    tables[:3] = (rng.permutation(4 * width) + 1)[: 3 * width].reshape(3, width)
    tables[2, :2] = tables[0, :2]
    tables = torch.from_numpy(tables).to(where)
    i32 = dict(dtype=torch.int32, device=where)
    lengths = torch.tensor([48, 30], **i32)
    freqs = model.model_freqs(config, device=where)
    active = torch.tensor([True, True, True, False], device=where)
    logits, launches = {}, {}

    def call(name, fn):
        if count:
            with launches_lib.device_launches(shapes=True) as counted:
                out = fn()
            launches[name] = {kernel: n for kernel, n in counted.items() if n}
        else:
            out = fn()
        logits[name] = out.float().cpu()
        return out

    dense = model.init_cache(config, 3, 256, kv_quant=kv_quant, device=where)
    call("prefill", lambda: model.prefill(config, params, dense, prompts.to(where), lengths,
                                          torch.tensor([0, 2], device=where), freqs))
    # slot 1 is empty: it rides along masked
    dense_active = torch.tensor([True, False, True], device=where)
    step_lengths = torch.tensor([49, 0, 31], **i32)
    for step in range(2):
        call(f"decode{step}", lambda: model.decode_step(
            config, params, dense, steps[step, :3].to(where), step_lengths, freqs,
            dense_active)[dense_active])
        step_lengths = torch.where(dense_active, step_lengths + 1, step_lengths)
    pool = model.init_paged_cache(config, 4 * width + 1, block, kv_quant=kv_quant, device=where)
    call("paged_prefill", lambda: model.paged_prefill(config, params, pool, prompts.to(where), lengths,
                                                      tables[:2], freqs))
    call("paged_offset", lambda: model.paged_prefill_at_offset(
        config, params, pool, suffix.to(where), torch.tensor([16], **i32), torch.tensor([32], **i32),
        tables[2:3], freqs))
    step_lengths = torch.tensor([49, 31, 49, 0], **i32)
    for step in range(2):
        call(f"paged_decode{step}", lambda: model.paged_decode_step(
            config, params, pool, steps[step].to(where), step_lengths, tables, freqs, active)[active])
        step_lengths = torch.where(active, step_lengths + 1, step_lengths)
    # one mixed step of 16-token spans (B7, B8 over int8 KV): a decode row,
    # windows of 16 and 5 tokens, the empty row idle
    counts = torch.tensor([1, 16, 5, 0], **i32)
    call("paged_mixed", lambda: model.paged_mixed_step(
        config, params, pool, window.to(where), torch.where(active, step_lengths - 1, 0), counts,
        tables, freqs)[active])
    return logits, launches


def tp_model_rank(rank: int, world: int, device: str, payload: dict) -> None:
    """One rank of the 2-layer tp check (started by ``parallel.launch``):
    its shard of the same weights, drawn on the card from
    :data:`TP_SEED` and cut leaf by leaf as drawn, its rank config, and
    :func:`tp_sequence` over the bf16 and the int8 cache; the logits and
    the launches of each call saved under ``payload["out"]``."""
    from langstream_tpu_torch.parallel.mesh import MeshConfig, build_group

    mesh = MeshConfig(tp=world)
    group = build_group(mesh, device)
    config = _tp_config()
    params = model.init_params(config, seed=TP_SEED, device=device,
                               keep=lambda name, leaf: model.shard_leaf(config, name, leaf, mesh, rank))
    ranked = model.rank_config(config, group)
    account = {"backend": group.backend,
               "heads": [ranked.num_heads, ranked.num_kv_heads, ranked.dims_per_head]}
    saved = {}
    for kv_quant in (False, True):
        logits, launches = tp_sequence(ranked, params, device, kv_quant, count=True)
        saved.update({f"{int(kv_quant)}/{name}": value.numpy() for name, value in logits.items()})
        account[f"launches{int(kv_quant)}"] = launches
    np.savez(f"{payload['out']}.{rank}.npz", **saved)
    with open(f"{payload['out']}.{rank}.json", "w") as out:
        json.dump(account, out)


def _ranks_log(name: str):
    """A log file under :data:`TP_LOGS` for a rank process's output (the
    smoke's own standard output stays its own)."""
    os.makedirs(TP_LOGS, exist_ok=True)
    return open(os.path.join(TP_LOGS, name), "w")


def check_tp_model(device, label: str) -> None:
    """Llama-3-8B width, 2 layers, two tp ranks sharing the card over gloo
    (:func:`tp_model_rank`, two processes): each rank's logits (gathered
    whole, so equal on both, bit for bit) within the model tolerance of
    the same calls at tp=1 on the card and on the CPU, bf16 and int8 KV;
    each rank's card counters show B1/B2 (B4/B5), B3 (B6) or, for the
    mixed step, B7 (B8) once per layer per call, on 16 heads over 4 of
    128."""
    from langstream_tpu_torch.parallel import launch
    from langstream_tpu_torch.runtime.multihost import free_port

    started = time.perf_counter()
    out = os.path.join(TP_LOGS, "model")
    with _ranks_log("model-ranks.log") as ranks_log:
        children = launch.spawn_ranks(
            "chip_smoke:tp_model_rank", {"out": out}, [str(device)] * TP,
            f"127.0.0.1:{free_port()}", timeout_s=TP_TIMEOUT_S, ranks=range(TP),
            stdout=ranks_log, stderr=subprocess.STDOUT)
        try:
            config = _tp_config()
            params = model.init_params(config, seed=TP_SEED, device=device)
            cpu_params = {name: p.cpu() for name, p in params.items()}
            refs = {kv_quant: (tp_sequence(config, params, device, kv_quant)[0],
                               tp_sequence(config, cpu_params, "cpu", kv_quant)[0])
                    for kv_quant in (False, True)}
            del params, cpu_params
            codes = launch.stop_ranks(children, timeout_s=TP_TIMEOUT_S)
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
    assert codes == [0] * TP, (codes, open(os.path.join(TP_LOGS, "model-ranks.log")).read()[-4000:])
    ranks = [dict(np.load(f"{out}.{rank}.npz")) for rank in range(TP)]
    accounts = [json.load(open(f"{out}.{rank}.json")) for rank in range(TP)]
    worst = {"tp=1 card": 0.0, "CPU": 0.0}
    layers = config.num_layers
    for kv_quant, (card, cpu) in refs.items():
        q = "_quant" if kv_quant else ""
        for name in card:
            got = torch.from_numpy(ranks[0][f"{int(kv_quant)}/{name}"])
            assert torch.equal(got, torch.from_numpy(ranks[1][f"{int(kv_quant)}/{name}"])), name
            assert bool(torch.isfinite(got).all()), name
            for where, ref in (("tp=1 card", card[name]), ("CPU", cpu[name])):
                worst[where] = max(worst[where], errors(got, ref)[1])
            if name == "paged_mixed":
                want = {f"paged_attention_ragged_q{q}": layers}
            elif name.startswith("paged_"):
                kernel = f"paged_attention{q}"
                want = {kernel: layers}
                if "decode" not in name:
                    want[f"{kernel}/prefill"] = layers
            else:
                want = {f"flash_{'prefill' if name == 'prefill' else 'decode'}{q}": layers}
            for account in accounts:
                assert account[f"launches{int(kv_quant)}"][name] == want, (name, account)
    for account in accounts:
        assert account["heads"] == [16, 4, 128] and account["backend"] == "gloo", account
    assert max(worst.values()) < MODEL_TOLERANCE, worst
    log(f"tp reference [{label}]: Llama-3-8B width, 2 layers, tp={TP} (two ranks sharing the card over "
        f"gloo, 16 heads over 4 of 128 a rank), dense prefill + 2 decode steps and paged prefill, "
        f"prefill at an offset + 2 decode steps + a mixed step, bf16 and int8 KV: both ranks' logits "
        f"equal bit for bit; "
        + ", ".join(f"vs {where} max_rel_err={value:.3e}" for where, value in worst.items())
        + f" (tol {MODEL_TOLERANCE}); each rank B1/B2, B3, B7 (B4/B5, B6, B8) {layers} a call by its "
        f"card counters; {time.perf_counter() - started:.1f} s")


def _tp_jobs():
    """The dense phase's prompts (``dense_jobs``, seed 0): its first
    :data:`TP_REQUESTS` greedy completions and its SSE chat."""
    jobs = dense_jobs(np.random.default_rng(0))
    greedy = [job for job in jobs[:-1] if "temperature" not in job[1]][:TP_REQUESTS]
    return greedy + jobs[-1:]


def _warm_launches(variants) -> dict:
    """The model calls that warming ``variants`` (kind, size) up ran, by
    the kernel's call: a cold prefill's one call (B1; a dense prefill at
    an offset launches no kernel), a decode chunk's steps (B2)."""
    pairs = [(variant[0], variant[1]) for variant in variants]  # (kind, size)
    return {"prefill": sum(kind == "prefill" for kind, _ in pairs),
            "decode": sum(size for kind, size in pairs if kind == "decode")}


def time_tp_step(engine, live: int = 512, iters: int = 5) -> float:
    """The bare eager decode step of a tp leader, every slot at ``live``
    rows: one step dispatched through the engine's runner, so the record
    reaches the followers, which run it too; the median wall in ms, the
    host clock around the step and a synchronize."""
    key = engine_lib.Variant("decode", 1, "greedy")
    inputs = engine._step_dummy(key)
    slots = engine.max_slots
    inputs.update(tokens=np.arange(1, slots + 1, dtype=np.int64),
                  lengths=np.full((slots,), live, dtype=np.int32), active=np.ones((slots,), dtype=bool))
    walls = []
    with torch.inference_mode():  # as the engine thread runs its steps
        for _ in range(iters + 1):
            started = time.perf_counter()
            engine._run_step(key, inputs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - started) * 1e3)
    return float(np.median(walls[1:]))


def serve_tp_and_check(label: str, device) -> dict:
    """``mesh: {tp: 2}`` Llama-3-8B at full width and :data:`CUT_LAYERS`
    layers (full depth until the tp features part came: the smoke's
    time), random from seed 0, served through the provider and the OpenAI server
    (``cli.main.start_tp_server``, eager, pipelined; no precompile, so a
    variant's first use runs its body once more, which the launch gates
    count):
    this process is rank 0 and serves; rank 1, a process of its own on
    the same card, replays its dispatches. The dense phase's greedy
    prompts and its SSE chat at once. Gates: every request answered;
    each stream equal to a one-card engine's over the same weights and
    prompts (the dense phase's path, eager) but for a near-tie
    (:func:`same_stream`); the follower replayed every record published
    and its token digest is the leader's; each rank's card counters B1
    and B2 once per layer per model call. Prints each rank's peak GiB,
    the backend, the step functions, tok/s and the bare eager step's
    wall: two ranks time-sharing one card over host-staged gloo, not a
    tp speed."""
    import torch.distributed as dist

    from langstream_tpu_torch.cli.main import start_tp_server
    from langstream_tpu_torch.parallel import launch

    started = time.perf_counter()
    args = build_parser().parse_args([
        "serve", "--model", "llama-3-8b", "--tp", str(TP), "--max-slots", str(TP_SLOTS),
        "--max-seq-len", "1024", "--decode-chunk", "8", "--logprobs-top-k",
        str(TP_TOPK), "--host", "127.0.0.1", "--port", "0", "--mirror-port", "0"])
    config = serve_config(args)
    config["engine"]["prefill-buckets"] = [TP_BUCKET]
    config["model"]["num_layers"] = CUT_LAYERS
    report_path = os.path.join(TP_LOGS, "follower")
    torch.cuda.reset_peak_memory_stats()
    jobs = _tp_jobs()
    results = {}
    with _ranks_log("follower.log") as follower_log:
        service, server, followers = start_tp_server(
            args, config, devices=[str(device)] * TP, timeout_s=TP_TIMEOUT_S, report=report_path,
            stdout=follower_log, stderr=subprocess.STDOUT)
        up_s = time.perf_counter() - started
        up_peak = torch.cuda.max_memory_allocated() / 2**30  # the burst resets it
        engine = service.engine
        post = engine._post_future

        def captured(request, result):
            results[tuple(request.prompt_tokens)] = (request, result)
            post(request, result)

        engine._post_future = captured
        try:
            replies, wall, launches, host, stats, peak_gib = run_burst(service, server, jobs)
            # no precompile: each variant's first use during the burst ran its
            # body once more (a cold prefill: its call again; a decode chunk:
            # its steps on idle rows), every kernel launched as in a call
            warm = _warm_launches(engine.steps.variants)
            step_ms = time_tp_step(engine)
        finally:
            del engine._post_future
            server.stop()
            service.close()  # the stop record: the follower reports and exits
            codes = launch.stop_ranks(followers, timeout_s=TP_TIMEOUT_S)
            dist.destroy_process_group()
    assert codes == [0], (codes, open(os.path.join(TP_LOGS, "follower.log")).read()[-4000:])
    leader_peak = torch.cuda.max_memory_allocated() / 2**30
    follower = json.load(open(f"{report_path}.1"))
    mirror = engine.mirror
    tokens = check_replies(jobs, replies)
    calls = stats["model_dispatches"]
    layers = engine.config.num_layers
    want = {"flash_prefill": layers * (calls.get("prefill", 0) + warm["prefill"]),
            "flash_decode": layers * (calls.get("decode_step", 0) + warm["decode"])}
    assert launches == {name: want.get(name, 0) for name in launches}, (launches, calls, warm)
    assert host == {name: want.get(name, 0) for name in KERNELS}, host  # eager: each enqueued
    replayed = follower["model_calls"]
    follower_warm = _warm_launches(follower["variants"])
    assert follower["launches"]["flash_prefill"] == layers * (
        replayed.get("prefill", 0) + follower_warm["prefill"]) > 0, follower
    assert follower["launches"]["flash_decode"] == layers * (
        replayed.get("decode", 0) + follower_warm["decode"]) > 0, follower
    assert sum(follower["launches"].values()) == (follower["launches"]["flash_prefill"]
                                                   + follower["launches"]["flash_decode"]), follower
    assert follower["records"] == mirror.published - 1, (follower["records"], mirror.published)
    assert follower["digest"] == mirror.digest.hexdigest(), (follower["digest"], mirror.digest.hexdigest())
    assert engine.stats["step_functions"] == "eager" and engine.group.backend == "gloo"
    assert (engine.config.num_heads, engine.config.num_kv_heads) == (16, 4)
    assert len(results) == len(jobs), len(results)
    served_ms = stats["decode_time"] / max(stats["decode_steps"], 1) * 1e3
    log(f"tp serving [{label}]: Llama-3-8B bf16 random weights, {CUT_LAYERS} layers, mesh {{tp: {TP}}}: two ranks "
        f"time-sharing one card over host-staged gloo (backend {engine.group.backend}), NOT a tp speed; "
        f"step functions {stats['step_functions']}; up in {up_s:.1f} s (both ranks' weights; no "
        f"precompile); {stats['requests']} requests, {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s, mean TTFT {stats['ttft_time'] / stats['requests'] * 1e3:.1f} ms, "
        f"served decode step {served_ms:.1f} ms ({stats['decode_steps']} steps), bare eager step "
        f"{step_ms:.2f} ms ({TP_SLOTS} slots x 512 rows); first uses warmed {warm}; peak GiB rank 0 "
        f"{up_peak:.2f} up to serving, {leader_peak:.2f} serving, rank 1 {follower['peak_gib']:.2f} over "
        f"its life (each allocator's own); model calls {calls}; rank 0 launches {launches}, rank 1 "
        f"{dict((k, v) for k, v in follower['launches'].items() if v)} for {replayed}; records published "
        f"{mirror.published} (stop included), replayed {follower['records']} {follower['kinds']}; token "
        f"digest {mirror.digest.hexdigest()} both ranks; {time.perf_counter() - started:.1f} s")
    # the one-card reference: the same weights (seed 0) and prompts, eager
    engine.release()
    del service, engine
    gc.collect()
    torch.cuda.empty_cache()
    compared = time.perf_counter()
    full = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=1024), num_layers=CUT_LAYERS)
    reference = engine_lib.DecodeEngine(
        full, model.init_params(full, seed=0, device=device), device=device, max_slots=TP_SLOTS,
        max_seq_len=1024, prefill_buckets=[TP_BUCKET], decode_chunk=8, logprobs_topk=TP_TOPK,
        step_graphs=False, pipeline_decode=True)
    reference.start()
    try:
        with concurrent.futures.ThreadPoolExecutor(len(results)) as pool:
            wants = list(pool.map(lambda item: _generate(
                reference, item[0].prompt_tokens, dataclasses.asdict(item[0].sampling),
                stop_tokens=set(item[0].stop_tokens))[0], results.values()))
    finally:
        reference.stop()
        reference.release()
    equal = sum(same_stream(got, want, True, "tp=2 vs one card", tolerance=TP_NEAR_TIE)
                for (_, got), want in zip(results.values(), wants))
    first = [next((j for j, (a, b) in enumerate(zip(got.tokens, want.tokens)) if a != b), None)
             for (_, got), want in zip(results.values(), wants)]
    log(f"tp streams [{label}]: {equal} of {len(wants)} equal to a one-card engine's over the same weights "
        f"and prompts (eager), the rest parting at near-ties within {TP_NEAR_TIE} nats (first differing "
        f"token of each: {first}); {time.perf_counter() - compared:.1f} s")
    return dict(tok_s=tokens / wall, step_ms=step_ms, leader_peak=leader_peak,
                follower_peak=follower["peak_gib"], equal=equal)


# the tp features part: Llama-3-8B at full width cut to this depth for the
# smoke's time; the crash fires after the start's 4th processed step
TP_FEATURE_LAYERS = 2
TP_CRASH_STEP = 4
TP_FEATURE_SEQ = 512


def _feature_prompt(seed: int, length: int = 128) -> list:
    return [int(t) for t in np.random.default_rng(seed).integers(1, 4000, size=length)]


def _start_tp_features(device, flags, faults_spec=None):
    """``serve --tp 2`` of Llama-3-8B at :data:`TP_FEATURE_LAYERS` layers
    (random from seed 0) with ``flags``, the supervisor on (its default),
    both ranks on the card; ``faults_spec`` arms the fault points for this
    start only (``LANGSTREAM_FAULTS``, which the follower inherits and
    never reaches). Returns (service, server, followers, report path)."""
    from langstream_tpu_torch.cli.main import start_tp_server
    from langstream_tpu_torch.runtime import faults

    args = build_parser().parse_args([
        "serve", "--model", "llama-3-8b", "--tp", str(TP), "--max-slots", "4",
        "--max-seq-len", str(TP_FEATURE_SEQ), "--decode-chunk", "8", "--logprobs-top-k",
        str(TP_TOPK), "--host", "127.0.0.1", "--port", "0", "--mirror-port", "0", *flags])
    config = serve_config(args)
    config["model"]["num_layers"] = TP_FEATURE_LAYERS
    config["engine"]["prefill-buckets"] = [128, 256]
    assert config["engine"]["supervisor"]
    name = "features-" + ("spec" if "--spec-decode" in flags else "mixed")
    report = os.path.join(TP_LOGS, name)
    if faults_spec:
        os.environ[faults.ENV_VAR] = faults_spec
    try:
        with _ranks_log(f"{name}.log") as ranks_log:
            service, server, followers = start_tp_server(
                args, config, devices=[str(device)] * TP, timeout_s=TP_TIMEOUT_S, report=report,
                stdout=ranks_log, stderr=subprocess.STDOUT)
    finally:
        os.environ.pop(faults.ENV_VAR, None)
    return service, server, followers, report


def _stop_tp_features(service, server, followers, report) -> dict:
    """Stop a features start (the stop record: the follower reports and
    exits); the follower's account, held to the leader's mirror: every
    record published replayed, the same token digest."""
    import torch.distributed as dist

    from langstream_tpu_torch.parallel import launch

    mirror = service.mirror
    try:
        server.stop()
        service.close()
        codes = launch.stop_ranks(followers, timeout_s=TP_TIMEOUT_S)
    finally:
        dist.destroy_process_group()
    assert codes == [0], (codes, report)
    follower = json.load(open(f"{report}.1"))
    assert follower["records"] == mirror.published - 1, (follower["records"], mirror.published)
    assert follower["digest"] == mirror.digest.hexdigest(), (follower["digest"], mirror.digest.hexdigest())
    return dict(follower, published=mirror.published)


def serve_tp_features_and_check(label: str, device) -> dict:
    """What ``serve --tp 2`` on one host takes beyond split serving, each
    held against a one-card twin at the same depth (Llama-3-8B at
    :data:`TP_FEATURE_LAYERS` layers, the same seed-0 weights, paged,
    split, a pool that never evicts; streams equal but for a near-tie of
    :data:`TP_NEAR_TIE`), in two starts of two ranks sharing the card:

    (a) ``--kv-layout paged --prefill-mode mixed`` (pipelined, its carry
    on), the prefix cache, a 48-block pool under a 64-block host tier,
    the supervisor on and ``engine_thread_crash@step=`` :data:`TP_CRASH_STEP`:
    two 128-token requests at once (the crash: one heal, the sessions
    resurrected, their streams the uncrashed twin's), six more evicting
    the first prompt's chain to the host tier, its continuation promoted
    back (the never-evicted twin's stream), a session exported (the ranks'
    kv heads gathered to one card's layout) and imported by a one-card
    engine, and a one-card engine's export imported at tp=2, both decode
    legs the twin's un-handed-off stream; each rank's card counters B7
    once per layer per mixed step, the same on both ranks.
    (b) ``--spec-decode ngram --kv-layout paged``: four repetitive greedy
    prompts at once, equal to the twin's spec-off streams; each rank's
    card counters B3 at the verify shape, the same on both ranks.

    Both: the follower replayed every record published, its token digest
    the leader's. Prints the part's wall time."""
    from langstream_tpu_torch.runtime import faults

    started = time.perf_counter()
    config = dataclasses.replace(model.LlamaConfig.llama3_8b(max_seq_len=TP_FEATURE_SEQ),
                                 num_layers=TP_FEATURE_LAYERS)
    layers = config.num_layers
    params = model.init_params(config, seed=0, device=device)

    def one_card():
        return engine_lib.DecodeEngine(
            config, params, device=device, max_slots=4, max_seq_len=TP_FEATURE_SEQ,
            prefill_buckets=[128, 256], decode_chunk=8, logprobs_topk=TP_TOPK, kv_layout="paged",
            step_graphs=False, pipeline_decode=True)

    greedy, seeded = dict(max_new_tokens=24), dict(max_new_tokens=24, temperature=0.8, seed=5)
    crash_jobs = [(_feature_prompt(1), greedy), (_feature_prompt(2), seeded)]
    thrash = [_feature_prompt(10 + i) for i in range(6)]
    promoted = crash_jobs[0][0] + _feature_prompt(3, 16)
    exported, imported = _feature_prompt(4), _feature_prompt(5)
    leg = dict(seeded, max_new_tokens=2)
    # the one-card export the tp start imports, before any fault is armed
    twin = one_card()
    twin.start()
    y_leg, _ = _generate(twin, imported, leg, export_handoff=True)
    assert y_leg.kv_handoff is not None

    # (a) mixed, the host tier, the handoff and the crash
    from langstream_tpu_torch.runtime import supervisor as supervisor_lib

    resurrected = supervisor_lib.SESSIONS_RESURRECTED.value()
    service, server, followers, report = _start_tp_features(device, [
        "--kv-layout", "paged", "--prefill-mode", "mixed", "--kv-blocks", "48",
        "--kv-host-blocks", "64"], faults_spec=f"engine_thread_crash@step={TP_CRASH_STEP}")
    launches_lib.read(reset=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(crash_jobs)) as pool:
            crashed = list(pool.map(lambda job: _generate(service.engine, *job)[0], crash_jobs))
        restarts = service.supervisor.restarts
        for prompt in thrash:
            _generate(service.engine, prompt, dict(max_new_tokens=8))
        got_promoted, _ = _generate(service.engine, promoted, greedy)
        x_leg, _ = _generate(service.engine, exported, leg, export_handoff=True)
        got_y, _ = _generate(service.engine, imported + y_leg.tokens[:-1], seeded,
                             replay_tokens=list(y_leg.tokens), prompt_len=len(imported),
                             kv_import=y_leg.kv_handoff)
        leader_launches = launches_lib.read(shapes=True)
        stats = dict(service.engine.stats)
    finally:
        faults.reset()
        account = _stop_tp_features(service, server, followers, report)
    resurrected = supervisor_lib.SESSIONS_RESURRECTED.value() - resurrected
    assert restarts == 1 and resurrected >= 1, (restarts, resurrected)
    assert stats["tokens_wasted"].get("crash_replay", 0) > 0, stats["tokens_wasted"]
    assert account["kinds"].get("release") == 1 and account["kinds"].get("rebuild") == 1, account
    assert stats["host_demotions"] > 0 and stats["host_promotions"] > 0, stats
    assert stats["handoff_exports"] == 1 and stats["handoff_imports"] == 1, stats
    assert x_leg.kv_handoff is not None
    for leaf, rows in x_leg.kv_handoff["arrays"].items():
        assert rows.shape[3] == config.num_kv_heads, (leaf, rows.shape)  # one card's layout
    mixed_steps = stats["model_dispatches"].get("paged_mixed_step", 0)
    b7 = leader_launches["paged_attention_ragged_q"]
    assert b7 == account["launches"]["paged_attention_ragged_q"], (leader_launches, account)
    assert b7 % layers == 0 and b7 >= layers * mixed_steps > 0, (b7, mixed_steps)
    # the twin: the uncrashed, never-evicted and un-handed-off streams
    wants = [_generate(twin, *job)[0] for job in crash_jobs]
    want_promoted, _ = _generate(twin, promoted, greedy)
    want_x, _ = _generate(twin, exported, seeded)
    want_y, _ = _generate(twin, imported, seeded)
    importer = one_card()
    importer.start()
    try:
        got_x, _ = _generate(importer, exported + x_leg.tokens[:-1], seeded,
                             replay_tokens=list(x_leg.tokens), prompt_len=len(exported),
                             kv_import=x_leg.kv_handoff)
        assert importer.stats["handoff_imports"] == 1, importer.stats
    finally:
        importer.stop()
        importer.release()
    pairs = [("crash resumed greedy", crashed[0], wants[0], True),
             ("crash resumed seeded", crashed[1], wants[1], False),
             ("promoted", got_promoted, want_promoted, True),
             ("tp=2 export -> one card", got_x, want_x, False),
             ("one card export -> tp=2", got_y, want_y, False)]
    equal = {name: same_stream(got, want, greedy_, name, tolerance=TP_NEAR_TIE)
             for name, got, want, greedy_ in pairs}
    mixed_s = time.perf_counter() - started

    # (b) spec decode, the paged verify
    spec_jobs = [([(j % 7) + 11 * (i + 1) for j in range(96)], dict(max_new_tokens=64))
                 for i in range(4)]
    service, server, followers, report = _start_tp_features(
        device, ["--kv-layout", "paged", "--spec-decode", "ngram"])
    launches_lib.read(reset=True)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(spec_jobs)) as pool:
            spec_got = list(pool.map(lambda job: _generate(service.engine, *job)[0], spec_jobs))
        spec_launches = launches_lib.read(shapes=True)
        spec_stats = dict(service.engine.stats)
    finally:
        spec_account = _stop_tp_features(service, server, followers, report)
    verify_steps = spec_stats["model_dispatches"].get("paged_verify_step", 0)
    verify = spec_launches["paged_attention/verify"]
    assert verify == spec_account["launches"]["paged_attention/verify"], (spec_launches, spec_account)
    assert verify % layers == 0 and verify >= layers * verify_steps > 0, (verify, verify_steps)
    assert spec_stats["tokens_draft_accepted"] > 0, spec_stats
    spec_want = [_generate(twin, *job)[0] for job in spec_jobs]
    twin.stop()
    twin.release()
    spec_equal = sum(same_stream(got, want, True, "tp=2 spec vs one card spec off",
                                 tolerance=TP_NEAR_TIE) for got, want in zip(spec_got, spec_want))
    del params
    log(f"tp features [{label}]: Llama-3-8B width, {layers} layers, two ranks sharing the card over "
        f"gloo, the supervisor on; (a) mixed (pipelined carry: {stats['mixed_steps_chained']} of "
        f"{stats['mixed_steps']} steps chained), engine_thread_crash@step={TP_CRASH_STEP} healed "
        f"({restarts} restart, {resurrected} sessions resurrected), host tier {stats['host_demotions']} demotions / {stats['host_promotions']} "
        f"promotions, handoff export + import across tp; streams equal to the one-card twin (else a "
        f"near-tie within {TP_NEAR_TIE}): {equal}; B7 {b7} launches a rank for {mixed_steps} mixed "
        f"steps ({layers} a step, first uses' warm-ups included), equal on both ranks; records "
        f"published {account['published']} {account['kinds']}; (b) spec ngram paged: "
        f"{spec_stats['tokens_draft_accepted']} of {spec_stats['tokens_drafted']} drafts accepted, "
        f"{spec_equal} of {len(spec_jobs)} streams equal to the twin's spec off (the rest near-ties), "
        f"B3 verify {verify} launches a rank for {verify_steps} verify steps, equal on both ranks; "
        f"records {spec_account['published']} {spec_account['kinds']}; both starts' follower digests "
        f"the leader's; mixed part {mixed_s:.1f} s, {time.perf_counter() - started:.1f} s in all")
    return dict(equal=equal, spec_equal=spec_equal, seconds=time.perf_counter() - started)


def check_tp(device, label: str) -> None:
    """Phase 15: :func:`check_tp_model`, :func:`serve_tp_features_and_check`,
    then :func:`serve_tp_and_check`."""
    started = time.perf_counter()
    check_tp_model(device, label)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp_features_and_check(label, device)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp_and_check(label, device)
    log(f"phase 15 (tensor parallelism) [{label}]: {time.perf_counter() - started:.1f} s")


# ---------------------------------------------------------------------- #
# phase 16: training on the mesh
# ---------------------------------------------------------------------- #
# two ranks share the card over host-staged gloo (NCCL refuses two ranks
# on one device): every collective, shard, pipeline tick and ring turn
# runs at full width, none of it at NCCL's speed
MESH_RANKS = 2
MESH_TIMEOUT_S = 300
MESH_LOGS = os.path.join("build", "mesh")
MESH_CHECKPOINT_DIR = os.path.join("build", "mesh-checkpoint")
# llama3_1b at full width, cut to MESH_LAYERS (at 4 the smoke ran past
# its 1000 s on a slower host); Mixtral at MESH_MOE_LAYERS (one: no later
# router sees the shares' rounding, so the card's ep2 run routes as its
# one-card run does); MESH_STEPS cut from 3 when the smoke ran 1177.5 s
# of its 1200 on a slower host (phase 12's engines at 8 layers broke its
# near-tie gate: random weights that shallow sample off the top ids)
MESH_LAYERS, MESH_MOE_LAYERS = 2, 1
MESH_BATCH, MESH_SEQ, MESH_STEPS = 4, 256, 2
MESHES = (("dp2", {"dp": 2}), ("fsdp2", {"fsdp": 2}), ("tp2", {"tp": 2}), ("pp2", {"pp": 2}),
          ("ep2", {"ep": 2}))
# ring and Ulysses at sp=2 on Llama-3-8B's attention: B, T, H, KVH, D
SP_SHAPE = (1, 4096, 32, 8, 128)
SP_TOLERANCE = 2e-2
SP_GRAD_COSINE = 0.99


def _digests(tensors) -> dict:
    """Each tensor's bytes by SHA-1, on the host."""
    import hashlib

    return {name: hashlib.sha1(t.detach().to("cpu").contiguous().view(torch.uint8).numpy()).hexdigest()
            for name, t in tensors.items()}


def _mesh_run(rank, device, label, config, mesh, saved) -> dict:
    """One mesh of phase 16 on this rank: the one-card Trainer's first
    step from the same weights and batch on rank 0 (its loss and
    gradients, the reference; once a config, kept in ``saved``), then
    the mesh's Trainer for
    :data:`MESH_STEPS` timed steps (its first step's gradients gathered to
    rank 0), the replicas' digests, and at fsdp2 a checkpoint written, at
    pp2 restored. Returns rank 0's account (the other ranks' peaks and
    digests gathered into it)."""
    import torch.distributed as dist

    from langstream_tpu_torch.parallel import collectives
    from langstream_tpu_torch.parallel.mesh import MeshConfig, mesh_coords
    from langstream_tpu_torch.training.checkpoint import CheckpointManager
    from langstream_tpu_torch.training.trainer import TrainConfig, Trainer

    walls = {"start": time.perf_counter()}
    tokens, mask = _train_batch(config, MESH_BATCH, MESH_SEQ, seed=3)
    train = TrainConfig(learning_rate=1e-3, remat=True)
    params = model.init_params(config, seed=0, device=device)
    account = {"mesh": label}
    if rank == 0:
        if saved.get("config") != config:
            saved.pop("reference", None)
            reference = Trainer(config, params, train_config=train, device=device)
            loss = reference.train_step(tokens, mask)
            saved.update(config=config, reference=(loss, {name: p.grad for name, p in
                                                          reference.params.items()}))
            del reference
        account["reference_loss"], ref_grads = saved["reference"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls["reference"] = time.perf_counter()
    mesh_config = MeshConfig(**mesh)
    trainer = Trainer(config, params, mesh_config=mesh_config, train_config=train, device=device)
    del params
    losses, step_ms, moved = [], [], []
    for step in range(MESH_STEPS):
        collectives.reset_bytes()
        torch.cuda.synchronize()
        started = time.perf_counter()
        losses.append(trainer.train_step(tokens, mask))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - started) * 1e3)
        moved.append(dict(collectives.BYTES_MOVED))
        if step == 0:
            gather_started = time.perf_counter()
            grads = trainer.gathered({name: p.grad for name, p in trainer.params.items()})
            walls["gather"] = time.perf_counter() - gather_started
    walls["steps"] = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # every leaf bit for bit the same on the ranks that hold the same slice
    found: list = [None] * MESH_RANKS
    dist.all_gather_object(found, _digests(trainer.params))
    replicas_differ = []
    for name, splits in trainer._splits.items():
        held = {}
        for other, digests in enumerate(found):
            coords = mesh_coords(mesh_config, other)
            key = tuple(coords[axis] for _, axis in splits)
            if held.setdefault(key, digests[name]) != digests[name]:
                replicas_differ.append(name)
    account.update(losses=losses, step_ms=step_ms, moved=moved, backend=trainer.group.backend,
                   replicas_differ=replicas_differ)
    if label == "fsdp2":
        shutil.rmtree(MESH_CHECKPOINT_DIR, ignore_errors=True)
        trainer.save_checkpoint(CheckpointManager(MESH_CHECKPOINT_DIR), wait=True)
        written = trainer.gathered({name: p.detach() for name, p in trainer.params.items()})
        if rank == 0:
            saved["written"] = _digests(written)
        del written
    if label == "pp2":
        account["restored_step"] = trainer.restore_checkpoint(CheckpointManager(MESH_CHECKPOINT_DIR))
        restored = trainer.gathered({name: p.detach() for name, p in trainer.params.items()})
        if rank == 0:
            account["restored_equal"] = _digests(restored) == saved["written"]
        del restored
    walls["checks"] = time.perf_counter()
    peaks: list = [None] * MESH_RANKS
    dist.all_gather_object(peaks, peak)
    account["peak_gib"] = peaks
    if rank == 0:
        cosines = {name: float(F.cosine_similarity(grad.to(device).float().flatten(),
                                                   ref_grads[name].float().flatten(), dim=0))
                   for name, grad in grads.items()}
        worst = min(cosines, key=cosines.get)
        account.update(worst_leaf=worst, worst_cosine=cosines[worst], leaves=len(cosines),
                       all_finite=all(math.isfinite(c) for c in cosines.values()))
        del ref_grads
    # seconds: the reference and the draw, the trainer and its steps (the
    # first step's gathered gradients apart), the digests and checkpoint
    account["walls"] = {
        "reference": walls["reference"] - walls["start"],
        "steps": walls["steps"] - walls["reference"] - walls["gather"],
        "gather": walls["gather"], "checks": walls["checks"] - walls["steps"],
        "all": time.perf_counter() - walls["start"]}
    del trainer, grads
    gc.collect()
    torch.cuda.empty_cache()
    return account


def _sp_run(rank, device) -> list:
    """Ring and Ulysses attention at sp=2 on :data:`SP_SHAPE` in bf16,
    each rank holding the whole inputs: the output gathered whole and the
    input gradients of ``sum(out * cotangent)``; rank 0 holds them against
    the plain ``prefill_attention`` on the card."""
    from langstream_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from langstream_tpu_torch.parallel.ring import ring_attention_sharded
    from langstream_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    group = build_mesh(MeshConfig(sp=MESH_RANKS), device).axis("sp")
    batch, seq, heads, kv_heads, dim = SP_SHAPE
    gen = torch.Generator(device=device).manual_seed(5)
    shapes = ((batch, seq, heads, dim), (batch, seq, kv_heads, dim), (batch, seq, kv_heads, dim))
    inputs = [torch.randn(shape, generator=gen, device=device, dtype=torch.bfloat16) for shape in shapes]
    cotangent = torch.randn(shapes[0], generator=gen, device=device, dtype=torch.bfloat16)
    plain = None
    if rank == 0:
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = prefill_attention(*leaves)
        (out.float() * cotangent.float()).sum().backward()
        plain = (out.detach(), [leaf.grad for leaf in leaves])
    accounts = []
    for name, fn in (("ring", ring_attention_sharded), ("ulysses", ulysses_attention_sharded)):
        leaves = [t.clone().requires_grad_() for t in inputs]
        torch.cuda.synchronize()
        started = time.perf_counter()
        out = fn(*leaves, group)
        (out.float() * cotangent.float()).sum().backward()
        torch.cuda.synchronize()
        account = {"kind": name, "ms": (time.perf_counter() - started) * 1e3}
        if rank == 0:
            ref, ref_grads = plain
            account["rel_err"] = float((out.detach().float() - ref.float()).abs().max()
                                       / ref.float().abs().max())
            account["grad_cosines"] = [float(F.cosine_similarity(leaf.grad.float().flatten(),
                                                                 want.float().flatten(), dim=0))
                                       for leaf, want in zip(leaves, ref_grads)]
        accounts.append(account)
    return accounts


def mesh_train_rank(rank: int, world: int, device: str, payload: dict) -> None:
    """One rank of phase 16 (started by ``parallel.launch``): each mesh of
    :data:`MESHES` in turn (llama3_1b at :data:`MESH_LAYERS`, Mixtral at
    :data:`MESH_MOE_LAYERS` for ep2), then ring and Ulysses; rank 0 writes
    the accounts to ``payload["out"]``."""
    llama = dataclasses.replace(model.LlamaConfig.llama3_1b(max_seq_len=MESH_SEQ),
                                num_layers=MESH_LAYERS)
    mixtral = dataclasses.replace(model.LlamaConfig.mixtral_8x7b(max_seq_len=MESH_SEQ),
                                  num_layers=MESH_MOE_LAYERS)
    saved, accounts = {}, []
    for label, mesh in MESHES:
        accounts.append(_mesh_run(rank, device, label, mixtral if label == "ep2" else llama, mesh,
                                  saved))
    sp = _sp_run(rank, device)
    if rank == 0:
        with open(payload["out"], "w") as out:
            json.dump({"meshes": accounts, "sp": sp}, out)


def check_mesh_training(device, label: str) -> None:
    """Phase 16: two ranks sharing the card over gloo, started once
    (:func:`mesh_train_rank`, two processes): llama3_1b (Meta's
    Llama-3.2-1B config) at full width and :data:`MESH_LAYERS` layers, B
    :data:`MESH_BATCH` × T :data:`MESH_SEQ`, at dp2, fsdp2, tp2 and pp2,
    and Mixtral-8x7B at full width and :data:`MESH_MOE_LAYERS` layer at
    ep2. Gates per mesh: the first loss within ``TRAIN_LOSS_TOLERANCE``
    of the one-card Trainer's on the card from the same weights and batch,
    every gathered gradient leaf at cosine ``TRAIN_GRAD_COSINE`` or more,
    :data:`MESH_STEPS` finite losses with the last below the first, every
    replicated leaf bit for bit the same on both ranks; the fsdp2
    checkpoint restored at pp2 bit for bit; ring and Ulysses at sp=2 on
    :data:`SP_SHAPE` within :data:`SP_TOLERANCE` of the plain attention's
    max |out|, input gradients at cosine :data:`SP_GRAD_COSINE` or more.
    Prints each mesh's step ms, its collectives' bytes a step, each
    rank's peak and the backend, and the phase's wall."""
    from langstream_tpu_torch.parallel import launch
    from langstream_tpu_torch.runtime.multihost import free_port

    started = time.perf_counter()
    out = os.path.join(MESH_LOGS, "accounts.json")
    os.makedirs(MESH_LOGS, exist_ok=True)
    try:
        with open(os.path.join(MESH_LOGS, "ranks.log"), "w") as ranks_log:
            children = launch.spawn_ranks(
                "chip_smoke:mesh_train_rank", {"out": out}, [str(device)] * MESH_RANKS,
                f"127.0.0.1:{free_port()}", timeout_s=MESH_TIMEOUT_S, ranks=range(MESH_RANKS),
                stdout=ranks_log, stderr=subprocess.STDOUT)
            try:
                codes = launch.stop_ranks(children, timeout_s=4 * MESH_TIMEOUT_S)
            finally:
                for child in children:
                    if child.poll() is None:
                        child.kill()
        assert codes == [0] * MESH_RANKS, (
            codes, open(os.path.join(MESH_LOGS, "ranks.log")).read()[-4000:])
        with open(out) as fh:
            result = json.load(fh)
    finally:
        shutil.rmtree(MESH_CHECKPOINT_DIR, ignore_errors=True)
    where = "two ranks time-sharing one card over host-staged gloo"
    for account in result["meshes"]:
        losses = account["losses"]
        loss_err = abs(losses[0] - account["reference_loss"]) / abs(account["reference_loss"])
        assert loss_err <= TRAIN_LOSS_TOLERANCE, account
        assert account["all_finite"] and account["worst_cosine"] >= TRAIN_GRAD_COSINE, account
        assert all(math.isfinite(loss) for loss in losses) and losses[-1] < losses[0], account
        assert not account["replicas_differ"], account
        assert account["backend"] == "gloo", account
        if account["mesh"] == "pp2":
            assert account["restored_step"] == MESH_STEPS and account["restored_equal"], account
        per_step = [sum(moved.values()) for moved in account["moved"]]
        log(f"mesh training {account['mesh']} [{label}; {where}]: "
            f"{'Mixtral-8x7B width, ' + str(MESH_MOE_LAYERS) + ' layer' if account['mesh'] == 'ep2' else 'llama3_1b width, ' + str(MESH_LAYERS) + ' layers'}, "
            f"B {MESH_BATCH} x T {MESH_SEQ}: losses {', '.join(f'{x:.5f}' for x in losses)} vs "
            f"one card {account['reference_loss']:.5f} (rel {loss_err:.2e}, tol {TRAIN_LOSS_TOLERANCE}); "
            f"worst gradient cosine {account['worst_cosine']:.5f} ({account['worst_leaf']}, "
            f"{account['leaves']} leaves; gate >= {TRAIN_GRAD_COSINE}); replicas equal; step ms "
            f"{', '.join(f'{x:.1f}' for x in account['step_ms'])}; collectives sent by rank 0 a step "
            f"{', '.join(f'{x / 1e6:.1f}' for x in per_step)} MB "
            f"({', '.join(f'{k} {v / 1e6:.1f}' for k, v in sorted(account['moved'][-1].items()))} MB "
            f"in the last); peak GiB by rank {', '.join(f'{x:.2f}' for x in account['peak_gib'])}; "
            f"backend {account['backend']}; wall "
            + ", ".join(f"{k} {v:.1f}" for k, v in account["walls"].items()) + " s"
            + (f"; the fsdp2 checkpoint restored at step {account['restored_step']} bit for bit"
               if account["mesh"] == "pp2" else ""))
    for account in result["sp"]:
        assert account["rel_err"] <= SP_TOLERANCE, account
        assert all(c >= SP_GRAD_COSINE for c in account["grad_cosines"]), account
        log(f"sequence parallel {account['kind']} at sp=2 [{label}; {where}]: B, T, H, KVH, D "
            f"{SP_SHAPE} bf16, forward + backward {account['ms']:.1f} ms; max err "
            f"{account['rel_err']:.2e} of max |plain| (tol {SP_TOLERANCE}); input gradient cosines "
            f"{', '.join(f'{c:.5f}' for c in account['grad_cosines'])} (gate >= {SP_GRAD_COSINE})")
    log(f"phase 16 (training on the mesh) [{label}]: {time.perf_counter() - started:.1f} s")


# ---------------------------------------------------------------------- #
# 17. the LangStream app: `apps run` on the shipped torch-completions app
# ---------------------------------------------------------------------- #
APP_DIR = os.path.join("langstream_tpu_torch", "examples", "applications", "torch-completions")
APP_LOGS = os.path.join("build", "app")
APP_LAYERS = 2  # Llama-3-8B at full width, 2 of 32 layers: the phase's time
APP_CLIENTS = 8
APP_MAX_TOKENS = 48
# the served answers against the direct service's: a stream may part at a
# near-tie of the direct run (top-2 logprobs within this) where batching
# rounds bf16 otherwise
APP_NEAR_TIE = 0.125
APP_INSTANCE = f"""\
instance:
  streamingCluster:
    type: memory
  computeCluster:
    type: local
  globals:
    model: "llama-3-8b"
    num-layers: {APP_LAYERS}
    tp: 1
    max-slots: 4
    max-seq-len: 512
    max-tokens: {APP_MAX_TOKENS}
    decode-chunk: 8
    precompile: true
"""


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=120) as response:
        return json.loads(response.read().decode())


async def _chat_client(base: str, client: int, questions) -> dict:
    """One chat client on the port's WebSocket client: its questions one
    after another, each answer's chunk frames until the last."""
    from langstream_tpu_torch.gateway import websocket

    session = f"app-client-{client}"
    ws = await websocket.connect(f"{base}/v1/chat/default/torch-completions/chat"
                                 f"?param:session-id={session}")
    answers = []
    try:
        for question in questions:
            sent = time.perf_counter()
            await ws.send_json({"value": question})
            frames, first = [], None
            while True:
                message = await asyncio.wait_for(ws.receive(), 300)
                assert message.type == "text", (session, message)
                record = message.json()["record"]
                first = first or time.perf_counter()
                frames.append(record)
                if record["headers"].get("stream-last-message") == "true":
                    break
            answers.append({"question": question, "frames": frames, "ttft_s": first - sent,
                            "done": time.perf_counter()})
    finally:
        await ws.close()
    return {"session": session, "answers": answers}


async def _history(base: str, session: str, count: int) -> list:
    """The session's whole answers, from the app's history gateway."""
    from langstream_tpu_torch.gateway import websocket

    ws = await websocket.connect(f"{base}/v1/consume/default/torch-completions/consume-history"
                                 f"?param:sessionId={session}&option:position=earliest")
    try:
        out = []
        while len(out) < count:
            message = await asyncio.wait_for(ws.receive(), 120)
            out.append(message.json()["record"])
        return out
    finally:
        await ws.close()


def _app_env(logs: str) -> dict:
    """The environment of an ``apps run`` subprocess: the flight recorder
    on, into ``<logs>/flight`` (emptied first), so that
    :func:`_served_tokens` reads each answer's token ids."""
    directory = os.path.join(logs, "flight")
    shutil.rmtree(directory, ignore_errors=True)
    return dict(os.environ, **{flight.ENV_VAR: directory})


def _served_tokens(logs: str) -> dict:
    """The token ids of every request the app process's engine answered,
    by trace id, from the ``request`` records of its flight artifact
    (flushed when the engine stops)."""
    out = {}
    for path in glob.glob(os.path.join(logs, "flight", "*.jsonl")):
        for entry in flight.read_artifact(path):
            if entry["kind"] == "request" and entry.get("trace_id"):
                assert entry["trace_id"] not in out, entry
                out[entry["trace_id"]] = entry["token_ids"]
    return out


def _tokens_part_at_a_near_tie(served: list, direct, label: str) -> bool:
    """True when the ``served`` token ids are those of the direct run (a
    ``GenerationResult`` with top-K logprobs); False when they part at a
    token where the direct run had a near-tie (its top two logprobs within
    :data:`APP_NEAR_TIE`). Raises on any other difference. The ids are
    compared, not the answers' text: at Llama-3-8B's vocabulary the byte
    tokenizer decodes almost every id to no text at all."""
    if list(served) == list(direct.tokens):
        return True
    part = next((k for k, (a, b) in enumerate(zip(served, direct.tokens)) if a != b),
                min(len(served), len(direct.tokens)))
    assert part < len(direct.top_logprobs), (label, part, served, direct.tokens)
    gap = float(direct.top_logprobs[part][1][0] - direct.top_logprobs[part][1][1])
    assert gap <= APP_NEAR_TIE, (label, part, gap, served, direct.tokens)
    return False


def _app_questions(client: int):
    rng = np.random.default_rng(1000 + client)
    return [f"question {turn} of client {client}: what is a "
            + " ".join(rng.choice(WORDS, size=4 + turn)) + "?" for turn in range(2)]


def serve_app_and_check(label: str) -> dict:
    """Phase 17: ``python -m langstream_tpu_torch apps run`` on the shipped
    ``torch-completions`` app, as a subprocess (its log in
    ``build/app/``), with an instance of Llama-3-8B at full width cut to
    :data:`APP_LAYERS` layers (random bf16 weights drawn on the card from
    the provider's seed), 4 slots × 512, decode chunk 8, ``precompile``
    on. :data:`APP_CLIENTS` chat clients on the port's own WebSocket
    client, each under its own session id, ask two questions each, all
    clients at once. Gates: every question answered; each client sees
    only its own session's chunks, each answer's ending with
    ``stream-last-message: true``, and they concatenate to the answer the
    app's ``consume-history`` gateway serves; the gateway's ``/metrics``
    shows the engine's counters (16 requests, the tokens); its
    ``/debug/launches`` deltas over the burst: B1 once per layer per
    prefill call and B2 once per layer per decode step (the engine's
    model calls), no other kernel, no CUDA graph captured; SIGTERM stops
    the app (exit 0). Then the port's ``TorchCompletionsService`` over
    the same resolved configuration, in this process, answers the same
    rendered messages under the same sessions (each client's two in
    turn, the clients at once), with top-5 logprobs: each served answer's
    token ids (the app's flight ``request`` record under the answer's
    trace id, :func:`_served_tokens`) equal its ids but for a near-tie
    (:func:`_tokens_part_at_a_near_tie`). Printed with no claim: the
    phase's wall, the output tok/s and mean TTFT the clients saw, the
    direct run's, and how many answers have any text."""
    from langstream_tpu_torch.compiler import build_application
    from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService

    started = time.perf_counter()
    os.makedirs(APP_LOGS, exist_ok=True)
    instance = os.path.join(APP_LOGS, "instance.yaml")
    with open(instance, "w") as fh:
        fh.write(APP_INSTANCE)
    log_path = os.path.join(APP_LOGS, "apps_run.log")
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch", "apps", "run", APP_DIR,
         "--instance", instance, "--gateway-port", "0"],
        stdout=subprocess.PIPE, stderr=log_file, text=True, env=_app_env(APP_LOGS))
    lines, base = [], None
    try:
        deadline = time.perf_counter() + 300
        while base is None:
            line = proc.stdout.readline()
            assert line and time.perf_counter() < deadline, (
                f"apps run exited before its gateway listened (see {log_path})", proc.poll(), lines)
            lines.append(line.rstrip())
            found = re.match(r"gateway on (ws://[^/]+)/v1/", line)
            if found:
                base = found.group(1)
        up_s = time.perf_counter() - started
        http_base = base.replace("ws://", "http://")
        before = _get_json(f"{http_base}/debug/launches")
        metrics_before = scrape_url(f"{http_base}/metrics")

        async def burst():
            t0 = time.perf_counter()
            clients = await asyncio.gather(*[
                _chat_client(base, c, _app_questions(c)) for c in range(APP_CLIENTS)])
            wall = time.perf_counter() - t0
            histories = await asyncio.gather(*[
                _history(base, client["session"], 2) for client in clients])
            return clients, histories, wall

        clients, histories, wall = asyncio.run(burst())
        after = _get_json(f"{http_base}/debug/launches")
        metrics = scrape_url(f"{http_base}/metrics")
    finally:
        proc.terminate()
        try:
            stdout, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, _ = proc.communicate()
        log_file.close()
    lines += stdout.splitlines()
    assert proc.returncode == 0 and "application stopped" in lines, (proc.returncode, lines[-5:])
    # the answers: each client its own session's chunks, whole answers
    answered = 0
    messages = {}
    for client, history in zip(clients, histories):
        session = client["session"]
        assert [h["value"]["question"] for h in history] == [a["question"] for a in client["answers"]]
        for answer, record in zip(client["answers"], history):
            frames = answer["frames"]
            assert all(f["headers"]["langstream-client-session-id"] == session for f in frames)
            assert len({f["headers"]["stream-id"] for f in frames}) == 1, frames
            assert [f["headers"]["stream-last-message"] for f in frames] == (
                ["false"] * (len(frames) - 1) + ["true"])
            assert [int(f["headers"]["stream-index"]) for f in frames] == list(range(len(frames)))
            assert "".join(f["value"] for f in frames) == record["value"]["answer"], session
            assert record["headers"]["langstream-client-session-id"] == session
            prompt = json.loads(record["value"]["prompt"])
            messages[(session, answer["question"])] = (prompt["messages"],
                                                       record["headers"]["langstream-trace-id"])
            answered += 1
    assert answered == APP_CLIENTS * 2, answered
    served_tokens = _served_tokens(APP_LOGS)
    assert len(served_tokens) == answered, sorted(served_tokens)
    # the engine's counters on the gateway's /metrics
    requests = metrics["torch_engine_requests"] - metrics_before.get("torch_engine_requests", 0)
    tokens = (metrics["torch_engine_tokens_generated"]
              - metrics_before.get("torch_engine_tokens_generated", 0))
    assert requests == answered and tokens > 0, (requests, tokens)
    # the kernels through the app, by the card's counters
    delta = {name: after["launches"][name] - before["launches"][name] for name in after["launches"]}
    calls = {name: after["model_calls"].get(name, 0) - before["model_calls"].get(name, 0)
             for name in after["model_calls"]}
    captured = {kind: n - before["graphs_captured"].get(kind, 0)
                for kind, n in after["graphs_captured"].items()}
    expect = {"flash_prefill": APP_LAYERS * calls.get("prefill", 0),
              "flash_decode": APP_LAYERS * calls.get("decode_step", 0)}
    assert delta == {name: expect.get(name, 0) for name in delta}, (delta, calls)
    assert expect["flash_prefill"] > 0 and expect["flash_decode"] > 0, (delta, calls)
    assert not any(captured.values()), captured
    served = time.perf_counter() - started
    # the direct service over the same resolved configuration
    application = build_application(APP_DIR, instance_file=instance)
    config = json.loads(json.dumps(application.resources["gpu-llm"]["configuration"]))
    config["engine"]["logprobs-top-k"] = 5
    direct_started = time.perf_counter()
    service = TorchCompletionsService(config, device="cuda")
    tokenizer = service.tokenizer
    try:
        async def direct():
            async def one_client(client):
                out = []
                for answer in client["answers"]:
                    rendered, trace_id = messages[(client["session"], answer["question"])]
                    prompt = tokenizer.apply_chat_template(rendered)
                    result = await service.engine.generate(
                        prompt, engine_lib.SamplingParams(max_new_tokens=APP_MAX_TOKENS),
                        stop_tokens=set(tokenizer.eos_ids), session_id=client["session"])
                    out.append((served_tokens[trace_id], result))
                return out

            t0 = time.perf_counter()
            runs = await asyncio.gather(*[one_client(client) for client in clients])
            return runs, time.perf_counter() - t0

        runs, direct_wall = asyncio.run(direct())
    finally:
        service.close()
    equal = sum(_tokens_part_at_a_near_tie(served, result, label)
                for run in runs for served, result in run)
    texts = sum(bool(record["value"]["answer"]) for history in histories for record in history)
    direct_tokens = sum(len(result.tokens) for run in runs for _, result in run)
    ttfts = [a["ttft_s"] for client in clients for a in client["answers"]]
    wall_s = time.perf_counter() - started
    log(f"phase 17 (LangStream app) [{label}]: `apps run` torch-completions, Llama-3-8B at "
        f"{APP_LAYERS} of 32 layers (random bf16 weights), 4 slots x 512, {APP_CLIENTS} chat clients "
        f"x 2 questions through the gateway: up in {up_s:.1f} s, {answered} answers in {wall:.2f} s, "
        f"{tokens:.0f} tokens, {tokens / wall:.1f} tok/s and mean TTFT "
        f"{1e3 * sum(ttfts) / len(ttfts):.1f} ms as the clients saw them; the direct service "
        f"{direct_tokens} tokens in {direct_wall:.2f} s ({direct_tokens / direct_wall:.1f} tok/s); "
        f"{equal} of {answered} answers' token ids equal to the direct service's, "
        f"{answered - equal} parted at near-ties (within {APP_NEAR_TIE}), {texts} of {answered} "
        f"answers with any text; launches on the card B1 {delta['flash_prefill']}, B2 "
        f"{delta['flash_decode']} for {calls.get('prefill', 0)} prefill calls and "
        f"{calls.get('decode_step', 0)} decode steps (model calls {calls}), no graph captured; "
        f"served part {served:.1f} s, direct part {time.perf_counter() - direct_started:.1f} s, "
        f"phase {wall_s:.1f} s")
    return {"tok_s": tokens / wall, "wall_s": wall_s}


# ---------------------------------------------------------------------- #
# 18. the RAG app: `apps run` on the shipped torch-rag app
# ---------------------------------------------------------------------- #
RAG_DIR = os.path.join("langstream_tpu_torch", "examples", "applications", "torch-rag")
RAG_LOGS = os.path.join("build", "app-rag")
RAG_DOCS = 128
RAG_CLIENTS = 8
RAG_TOP_K = 4
RAG_CHUNK, RAG_OVERLAP = 400, 50  # the app's text-splitter, in characters here
RAG_INSTANCE = f"""\
instance:
  streamingCluster:
    type: memory
  computeCluster:
    type: local
  globals:
    model: "llama-3-8b"
    num-layers: {APP_LAYERS}
    max-slots: 4
    max-seq-len: 4096
    max-tokens: {APP_MAX_TOKENS}
    decode-chunk: 8
    precompile: true
    kv-layout: paged
    kv-block-size: 16
    prefill-buckets: "64,128,256,512,1024"
    embeddings-model: minilm-l6
    embeddings-max-length: 256
    embedding-dimensions: 384
    chunk-length-function: length
"""


def rag_documents() -> list:
    """``RAG_DOCS`` documents of 2–6 KB: one to three paragraphs of
    sentences of seeded :data:`WORDS`, each paragraph longer than a
    chunk, so that most chunks come near :data:`RAG_CHUNK` characters."""
    rng = np.random.default_rng(1800)
    docs = []
    for _ in range(RAG_DOCS):
        size, count = int(rng.integers(2048, 6144)), int(rng.integers(1, 4))
        paragraphs = []
        for _ in range(count):
            paragraph = ""
            while len(paragraph) < size // count:
                paragraph += " ".join(rng.choice(WORDS, size=int(rng.integers(4, 14)))).capitalize()
                paragraph += ". "
            paragraphs.append(paragraph.strip())
        docs.append("\n\n".join(paragraphs))
    return docs


def _rag_questions(chunks, client: int) -> list:
    """Two questions of ``client``, each drawn from the words of a seeded
    chunk: a run of 40 of them, as long as most chunks' first 256 bytes
    (the random encoder pools its tokens' states, so a short question
    sits nearest the short chunks, and the prompts stay short)."""
    rng = np.random.default_rng(1900 + client)
    out = []
    for turn in range(2):
        words = chunks[int(rng.integers(len(chunks)))].replace(".", "").lower().split()
        start = int(rng.integers(0, max(1, len(words) - 40)))
        out.append(f"question {turn} of client {client}: what about "
                   + " ".join(words[start:start + 40]) + "?")
    return out


async def _rag_client(base: str, client: int, questions) -> dict:
    """One client: its session's ``answers`` consumer, then its questions
    through ``ask`` one after another, each answer awaited."""
    from langstream_tpu_torch.gateway import websocket

    session = f"rag-client-{client}"
    consume = await websocket.connect(f"{base}/v1/consume/default/torch-rag/answers"
                                      f"?param:sessionId={session}&option:position=earliest")
    produce = await websocket.connect(f"{base}/v1/produce/default/torch-rag/ask"
                                      f"?param:sessionId={session}")
    answers = []
    try:
        for question in questions:
            sent = time.perf_counter()
            await produce.send_json({"value": question})
            ack = await asyncio.wait_for(produce.receive(), 60)
            assert ack.json()["status"] == "OK", ack.json()
            message = await asyncio.wait_for(consume.receive(), 300)
            assert message.type == "text", (session, message)
            answers.append({"question": question, "record": message.json()["record"],
                            "latency_s": time.perf_counter() - sent})
    finally:
        await produce.close()
        await consume.close()
    return {"session": session, "answers": answers}


def _post_json(url: str, body) -> dict:
    request = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=60) as response:
        return json.loads(response.read().decode())


def _direct_scores(store, vector) -> Tuple[dict, list]:
    """Every stored chunk's score against ``vector`` in the direct store,
    by text, and its top :data:`RAG_TOP_K` texts."""
    query = np.asarray(vector, dtype=np.float32)
    query = query / (float(np.linalg.norm(query)) or 1.0)
    matrix = store._matrix[: len(store)]
    scores = (torch.from_numpy(matrix).cuda() @ torch.from_numpy(query).cuda()).cpu().numpy()
    texts = [store._meta[doc_id]["text"] for doc_id in store._ids]
    by_text = {text: float(score) for text, score in zip(texts, scores)}
    top = [hit["text"] for hit in store.search(vector, RAG_TOP_K)]
    return by_text, top


def serve_rag_and_check(label: str) -> dict:
    """Phase 18: ``python -m langstream_tpu_torch apps run`` on the
    shipped ``torch-rag`` app as a subprocess with ``--http-port`` (its
    log in ``build/app-rag/``), at :data:`RAG_INSTANCE`.

    Ingest: :func:`rag_documents` through the ``ingest`` gateway's HTTP
    produce, one by one; the phase waits until the ingest node's
    ``records_out`` on ``--http-port``'s ``/metrics`` (the records its
    ``index-chunk`` sink wrote) equals the chunk count of the port's own
    splitter over the same documents. Query: :data:`RAG_CLIENTS` clients,
    all at once, each asking two questions (:func:`_rag_questions`) under
    its own ``sessionId``. Gates: 16 answers, each to its own session,
    each with a ``context`` of :data:`RAG_TOP_K` rows whose similarities
    descend; the app's card counters over the burst (``/debug/launches``):
    B3 once per layer per model call, its prefill-shape launches once per
    layer per prefill call (cold and at an offset) and the rest once per
    layer per decode step, no other kernel, no CUDA graph captured. SIGTERM
    stops the app (exit 0). Then, in this process: a direct
    ``TorchEmbeddingsService`` of the same preset and seed embeds the
    same chunks into a direct store on the card; each answer's
    ``question_embeddings`` is within :data:`EMBED_TOLERANCE` of the
    direct service's vector for its question, and its ``context`` equals
    the direct store's top-4 for that vector (a swap allowed, and
    counted, where the two rows' direct scores are within
    :data:`SEARCH_TOLERANCE`; each similarity within
    :data:`EMBED_TOLERANCE` of its direct score). A direct
    ``TorchCompletionsService`` over the same resolved configuration
    answers the prompt the app's step renders from each answer's
    ``context`` and question (each client's two in turn under its
    session, the clients at once), with top-5 logprobs: each served
    answer's token ids (:func:`_served_tokens`, by the answer's trace id;
    its text their decoding) equal the direct run's but for a near-tie
    (:func:`_tokens_part_at_a_near_tie`).
    Printed with no claim: start-up, ingest seconds, chunks/s and the
    encoder's calls, the burst's tok/s, the answers' mean latency at the
    clients and the engine's mean TTFT, the direct service's tok/s, B3's
    launches by shape, the phase's wall."""
    from langstream_tpu_torch.agents.el import render_template
    from langstream_tpu_torch.agents.text import RecursiveCharacterTextSplitter
    from langstream_tpu_torch.agents.transform import TransformContext
    from langstream_tpu_torch.agents.vectorstore import VectorStore
    from langstream_tpu_torch.api.records import Record
    from langstream_tpu_torch.compiler import build_application, build_execution_plan
    from langstream_tpu_torch.providers.torch_local.provider import (
        TorchCompletionsService,
        TorchEmbeddingsService,
    )

    started = time.perf_counter()
    documents = rag_documents()
    splitter = RecursiveCharacterTextSplitter(chunk_size=RAG_CHUNK, chunk_overlap=RAG_OVERLAP,
                                              length_function=len)
    chunks = [chunk for doc in documents for chunk in splitter.split_text(doc)]
    assert max(len(chunk) for chunk in chunks) <= RAG_CHUNK, max(map(len, chunks))
    os.makedirs(RAG_LOGS, exist_ok=True)
    instance = os.path.join(RAG_LOGS, "instance.yaml")
    with open(instance, "w") as fh:
        fh.write(RAG_INSTANCE)
    log_path = os.path.join(RAG_LOGS, "apps_run.log")
    log_file = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "langstream_tpu_torch", "apps", "run", RAG_DIR,
         "--instance", instance, "--gateway-port", "0", "--http-port", "0"],
        stdout=subprocess.PIPE, stderr=log_file, text=True, env=_app_env(RAG_LOGS))
    lines, base, metrics_url = [], None, None
    ingest_metric = "agent_split_document_records_out_total"
    try:
        deadline = time.perf_counter() + 300
        while base is None:
            line = proc.stdout.readline()
            assert line and time.perf_counter() < deadline, (
                f"apps run exited before its gateway listened (see {log_path})", proc.poll(), lines)
            lines.append(line.rstrip())
            found = re.match(r"metrics on (http://\S+)/metrics", line)
            metrics_url = found.group(1) if found else metrics_url
            found = re.match(r"gateway on (ws://[^/]+)/v1/", line)
            if found:
                base = found.group(1)
        assert metrics_url is not None, lines
        up_s = time.perf_counter() - started
        http_base = base.replace("ws://", "http://")
        # ingest: every document through the gateway, then the sink's count
        t0 = time.perf_counter()
        for document in documents:
            reply = _post_json(f"{http_base}/api/gateways/produce/default/torch-rag/ingest",
                               {"value": document})
            assert reply["status"] == "OK", reply
        written, deadline = 0.0, time.perf_counter() + 300
        while written < len(chunks):
            assert time.perf_counter() < deadline and proc.poll() is None, (written, len(chunks))
            time.sleep(0.05)
            agent_metrics = scrape_url(f"{metrics_url}/metrics")
            written = agent_metrics.get(ingest_metric, 0.0)
        ingest_s = time.perf_counter() - t0
        assert written == len(chunks), (written, len(chunks))
        encoder_calls = agent_metrics["agent_split_document_embeddings_calls_total"]
        assert agent_metrics["agent_split_document_embeddings_texts_total"] == len(chunks)
        # the query burst
        before = _get_json(f"{http_base}/debug/launches")
        metrics_before = scrape_url(f"{metrics_url}/metrics")

        async def burst():
            t1 = time.perf_counter()
            clients = await asyncio.gather(*[
                _rag_client(base, c, _rag_questions(chunks, c)) for c in range(RAG_CLIENTS)])
            return clients, time.perf_counter() - t1

        clients, wall = asyncio.run(burst())
        after = _get_json(f"{http_base}/debug/launches")
        metrics = scrape_url(f"{metrics_url}/metrics")
    finally:
        proc.terminate()
        try:
            stdout, _ = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, _ = proc.communicate()
        log_file.close()
    lines += stdout.splitlines()
    assert proc.returncode == 0 and "application stopped" in lines, (proc.returncode, lines[-5:])
    answers = [(client["session"], answer) for client in clients for answer in client["answers"]]
    assert len(answers) == RAG_CLIENTS * 2, len(answers)
    served_tokens = _served_tokens(RAG_LOGS)
    assert len(served_tokens) == len(answers), sorted(served_tokens)
    for session, answer in answers:
        record = answer["record"]
        assert record["headers"]["langstream-client-session-id"] == session, record["headers"]
        value = record["value"]
        # random weights over the byte tokenizer: most of the vocabulary
        # decodes to no text, so an answer may be empty; its token ids are
        # what the direct run is held to below
        assert value["question"] == answer["question"] and isinstance(value["answer"], str), value
        answer["token_ids"] = served_tokens[record["headers"]["langstream-trace-id"]]
        similarities = [row["similarity"] for row in value["context"]]
        assert len(similarities) == RAG_TOP_K and similarities == sorted(similarities, reverse=True)
    # the engine's counters on the agent's /metrics
    requests = metrics["torch_engine_requests"] - metrics_before.get("torch_engine_requests", 0)
    tokens = (metrics["torch_engine_tokens_generated"]
              - metrics_before.get("torch_engine_tokens_generated", 0))
    assert requests == len(answers) and tokens > 0, (requests, tokens)
    ttft = "torch_engine_ttft_seconds"
    ttft_ms = 1e3 * ((metrics[f"{ttft}_sum"] - metrics_before.get(f"{ttft}_sum", 0.0))
                     / (metrics[f"{ttft}_count"] - metrics_before.get(f"{ttft}_count", 0.0)))
    # B3 through the app, by its card counters
    delta = {name: after["launches"][name] - before["launches"][name] for name in after["launches"]}
    calls = {name: after["model_calls"].get(name, 0) - before["model_calls"].get(name, 0)
             for name in after["model_calls"]}
    captured = {kind: n - before["graphs_captured"].get(kind, 0)
                for kind, n in after["graphs_captured"].items()}
    prefills = calls.get("paged_prefill", 0) + calls.get("paged_prefill_at_offset", 0)
    expect = {"paged_attention": APP_LAYERS * sum(calls.values()),
              "paged_attention/prefill": APP_LAYERS * prefills}
    assert delta == {name: expect.get(name, 0) for name in delta}, (delta, calls)
    decode = delta["paged_attention"] - delta["paged_attention/prefill"]
    assert decode == APP_LAYERS * calls.get("paged_decode_step", 0), (delta, calls)
    assert calls.get("paged_prefill_at_offset", 0) > 0 and decode > 0, calls
    assert not any(captured.values()), captured
    served = time.perf_counter() - started
    # the direct encoder and store
    application = build_application(RAG_DIR, instance_file=instance)
    config = json.loads(json.dumps(application.resources["gpu-llm"]["configuration"]))
    direct_started = time.perf_counter()
    encoder = TorchEmbeddingsService(config, device="cuda")
    # in the app's batches of up to 16 (its embed-chunk's batch-size)
    chunk_vectors = [vector for i in range(0, len(chunks), 16)
                     for vector in encoder.embedder.embed(chunks[i:i + 16])]
    question_vectors = encoder.embedder.embed([answer["question"] for _, answer in answers])
    encoder.close()
    store = VectorStore(len(chunk_vectors[0]), device="cuda")
    for i, (chunk, vector) in enumerate(zip(chunks, chunk_vectors)):
        store.upsert(f"chunk-{i}", vector, {"text": chunk})
    swaps = 0
    for (session, answer), direct_q in zip(answers, question_vectors):
        value = answer["record"]["value"]
        served_q = np.asarray(value["question_embeddings"], dtype=np.float32)
        assert float(np.abs(served_q - np.asarray(direct_q)).max()) <= EMBED_TOLERANCE, session
        scores, top = _direct_scores(store, value["question_embeddings"])
        context = [row["text"] for row in value["context"]]
        for position, (mine, theirs) in enumerate(zip(context, top)):
            if mine != theirs:
                assert abs(scores[mine] - scores[theirs]) <= SEARCH_TOLERANCE, (
                    label, session, position, scores[mine], scores[theirs])
                swaps += 1
        for row in value["context"]:
            assert abs(row["similarity"] - scores[row["text"]]) <= EMBED_TOLERANCE, (
                session, row["similarity"], scores[row["text"]])
    # the direct completions over the prompts the app's step rendered
    plan = build_execution_plan(application)
    steps = [step for node in plan.agents for spec in node.processors
             for step in spec.configuration.get("steps", [])
             if step.get("type") == "ai-chat-completions"]
    (template,) = [message["content"] for message in steps[0]["messages"]]
    config["engine"]["logprobs-top-k"] = 5
    service = TorchCompletionsService(config, device="cuda")
    tokenizer = service.tokenizer
    try:
        async def direct():
            async def one_client(client):
                out = []
                for answer in client["answers"]:
                    value = dict(answer["record"]["value"])
                    served_answer = value.pop("answer")
                    assert served_answer == tokenizer.decode(answer["token_ids"]), value
                    ctx = TransformContext(Record(value=value))
                    rendered = render_template(template, ctx.el_context())
                    prompt = tokenizer.apply_chat_template([{"role": "user", "content": rendered}])
                    result = await service.engine.generate(
                        prompt, engine_lib.SamplingParams(max_new_tokens=APP_MAX_TOKENS),
                        stop_tokens=set(tokenizer.eos_ids), session_id=client["session"])
                    out.append((answer["token_ids"], result, len(prompt)))
                return out

            t2 = time.perf_counter()
            runs = await asyncio.gather(*[one_client(client) for client in clients])
            return runs, time.perf_counter() - t2

        runs, direct_wall = asyncio.run(direct())
    finally:
        service.close()
    equal = sum(_tokens_part_at_a_near_tie(served, result, label)
                for run in runs for served, result, _ in run)
    texts = sum(bool(answer["record"]["value"]["answer"]) for _, answer in answers)
    direct_tokens = sum(len(result.tokens) for run in runs for _, result, _ in run)
    prompt_tokens = [n for run in runs for _, _, n in run]
    latency = [answer["latency_s"] for _, answer in answers]
    wall_s = time.perf_counter() - started
    log(f"phase 18 (RAG app) [{label}]: `apps run` torch-rag, Llama-3-8B at {APP_LAYERS} of 32 "
        f"layers (random bf16 weights), paged KV (blocks of 16), 4 slots x 4096, MiniLM-L6 encoder "
        f"(random, byte tokenizer, max length 256): up in {up_s:.1f} s; ingest {len(documents)} "
        f"documents ({sum(map(len, documents)) / 1e6:.2f} MB) -> {len(chunks)} chunks in "
        f"{ingest_s:.2f} s ({len(chunks) / ingest_s:.1f} chunks/s, {encoder_calls:.0f} encoder "
        f"calls); {RAG_CLIENTS} clients x 2 questions (prompts {min(prompt_tokens)}-"
        f"{max(prompt_tokens)} tokens): {len(answers)} answers in {wall:.2f} s, {tokens:.0f} "
        f"tokens, {tokens / wall:.1f} tok/s, mean answer latency at the clients "
        f"{1e3 * sum(latency) / len(latency):.1f} ms, engine mean TTFT {ttft_ms:.1f} ms; the "
        f"direct service {direct_tokens} tokens in {direct_wall:.2f} s "
        f"({direct_tokens / direct_wall:.1f} tok/s); contexts equal to the direct store's top-"
        f"{RAG_TOP_K} with {swaps} near-tie swaps (within {SEARCH_TOLERANCE}); {equal} of "
        f"{len(answers)} answers' token ids equal to the direct service's, "
        f"{len(answers) - equal} parted at near-ties (within {APP_NEAR_TIE}), {texts} of "
        f"{len(answers)} answers with any text; B3 launches on the card {delta['paged_attention']}: "
        f"prefill shape {delta['paged_attention/prefill']} for {prefills} prefill calls "
        f"({calls.get('paged_prefill_at_offset', 0)} at an offset), decode shape {decode} for "
        f"{calls.get('paged_decode_step', 0)} decode steps (model calls {calls}), no graph "
        f"captured; served part {served:.1f} s, direct part "
        f"{time.perf_counter() - direct_started:.1f} s, phase {wall_s:.1f} s")
    return {"tok_s": tokens / wall, "wall_s": wall_s, "launches": delta}


def main() -> None:
    # the watchdog's trip captures and /debug/profile's go under build/,
    # which git ignores; so does the flight artifact, on as in `serve`
    # (every journey, decode chunk and prefill record of the run)
    os.environ.setdefault("LANGSTREAM_PROFILE_DIR", os.path.join("build", "profiles"))
    os.environ.setdefault(flight.ENV_VAR, os.path.join("build", "flight"))
    log(f"flight recorder -> {start_flight('chip_smoke')}")
    # the engines' cost model divides by the peaks this script's bounds use
    assert accounting.PeakSpecs.from_env() == accounting.PeakSpecs(PEAK_BF16_FLOPS, PEAK_BYTES)
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    label = card_label()
    log(f"device: {name} ({torch.cuda.device_count()} visible); torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    walls = []  # each phase's wall time, printed at the end
    _build.build_all()
    log(f"built {sorted(_build.SIGNATURES)} in {time.perf_counter() - t0:.1f}s -> {_build.BUILD_DIR}")
    for source in ("flash_prefill", "flash_decode", "paged_attention"):
        kernel_resources(source)
    kernels = [check(device, quant) for quant in (False, True)
               for check in (check_prefill_kernel, check_decode_kernel, check_paged_kernel)]
    kernels += [check_ragged_q_kernel(device, quant) for quant in (False, True)]
    check_int8_against_bf16(device)
    check_int8_weights_against_cpu(device)
    for kv_quant in (False, True):
        check_paged_model(device, kv_quant=kv_quant)
        check_mixed_model(device, kv_quant=kv_quant)
        check_prefill_graphs(device, kv_quant=kv_quant)
        check_reuse_logits(device, kv_quant=kv_quant)
        check_verify_model(device, kv_quant=kv_quant)
        check_top_logprobs(device, kv_quant=kv_quant)
    check_mlp_slices(device)
    check_graph_pool(device)
    walls.append(("kernels and 2-layer references", time.perf_counter() - t0))
    # each kernel's launches come from the serving phase of its own path;
    # every phase runs serve's default, the pipelined decode, except the
    # dense control, which runs in turns with it (pipelined, control,
    # control, pipelined): the host's pace drifts within a run
    launches, runs = {}, {}
    # the in-turns controls of earlier slices (graphed against eager, the
    # decode carry, the harvest) run at CONTROL_LAYERS between two twins
    # of the main path at that depth; the main paths at full depth. Cut
    # for the smoke's time when phase 14 came: int8 weights with the JAX
    # harvest and with ``--admission-chunk 2`` (and their int8 twin), the
    # mixed run's warm split twins and the spec-off twins
    small = dict(layers=CONTROL_LAYERS)
    cut = dict(layers=CUT_LAYERS)
    paged_cut = functools.partial(serve_paged_and_check, **cut)
    mixed_cut = functools.partial(serve_paged_and_check, mixed=True, **cut)
    dense_int8_kv = functools.partial(serve_dense_and_check, **cut)
    paged_int8_kv = functools.partial(serve_paged_and_check, **cut)
    mixed_int8_kv = functools.partial(serve_paged_and_check, mixed=True, **cut)
    dense_crash = functools.partial(serve_dense_and_check, crash=True)  # then the crash phase
    ctl_pipelined = functools.partial(serve_dense_and_check, **small)
    eager = functools.partial(serve_dense_and_check, graphs=False, **small)
    unpipelined = functools.partial(serve_dense_and_check, extra=("--no-pipeline-decode",), **small)
    jax_harvest = functools.partial(serve_dense_and_check, join=False, **small)
    int8_weights = functools.partial(serve_dense_and_check, extra=("--quantization", "int8"))
    sessions = serve_sessions_and_check
    paged_sessions = functools.partial(serve_sessions_and_check, paged=True)
    paged_spec = functools.partial(serve_spec_and_check, paged=True)
    for phase, serve, kv_quant, names in (
        ("dense and crash", dense_crash, False, ("flash_prefill", "flash_decode")),
        ("control: pipelined", ctl_pipelined, False, ()),
        ("control: JAX harvest", jax_harvest, False, ()),
        ("control: eager", eager, False, ()),
        ("control: unpipelined", unpipelined, False, ()),
        ("control: pipelined", ctl_pipelined, False, ()),
        ("dense int8 weights", int8_weights, False, ()),
        ("paged", paged_cut, False,
         ("paged_attention", "paged_attention/decode", "paged_attention/prefill")),
        ("mixed", mixed_cut, False, ("paged_attention_ragged_q",)),
        ("dense int8 KV", dense_int8_kv, True, ("flash_prefill_quant", "flash_decode_quant")),
        ("paged int8 KV", paged_int8_kv, True, ("paged_attention_quant", "paged_attention_quant/decode",
                                                "paged_attention_quant/prefill")),
        ("mixed int8 KV", mixed_int8_kv, True, ("paged_attention_ragged_q_quant",)),
        ("sessions", sessions, False, ()),
        ("paged sessions", paged_sessions, False, ()),
        ("paged sessions int8 KV", paged_sessions, True, ()),
        ("spec", serve_spec_and_check, False, ()),
        ("paged spec", paged_spec, False, ("paged_attention/verify",)),
        ("paged spec int8 KV", paged_spec, True, ("paged_attention_quant/verify",)),
    ):
        started = time.perf_counter()
        counts = serve(label, kv_quant=kv_quant)
        walls.append((phase, time.perf_counter() - started))
        launches.update({name: counts[name] for name in names})
        runs.setdefault((serve, kv_quant), []).append(counts)
        gc.collect()
        torch.cuda.empty_cache()

    def turns(kinds, phases):
        return ", ".join(
            f"{kind} {run['tok_s']:.1f} / {run['uniform_tok_s']:.1f} tok/s, TTFT "
            f"{run['ttft_ms']:.1f} / {run['uniform_ttft_ms']:.1f} ms"
            for kind, run in zip(kinds, phases))

    graphed_runs = runs[ctl_pipelined, False]
    depth = f" ({CONTROL_LAYERS} layers)"
    log(f"dense bf16 in turns{depth}, graphed against eager (both pipelined), mixed-length / uniform "
        "64-token burst: " + turns(("graphed", "eager", "graphed"),
                                   (graphed_runs[0], runs[eager, False][0], graphed_runs[1])))
    log(f"dense bf16 in turns{depth}, the carry (both graphed), mixed-length / uniform 64-token burst: "
        + turns(("pipelined", "unpipelined", "pipelined"),
                (graphed_runs[0], *runs[unpipelined, False], graphed_runs[1])))
    log(f"dense bf16 in turns{depth}, the harvest (both graphed and pipelined): join_prefills against the "
        "JAX engine's harvest, mixed-length / uniform 64-token burst: "
        + turns(("join", "JAX", "join"),
                (graphed_runs[0], *runs[jax_harvest, False], graphed_runs[1])))
    bare = [run["timing"] for run in (graphed_runs[0], runs[jax_harvest, False][0], runs[eager, False][0],
                                      *runs[unpipelined, False], graphed_runs[1])]
    log(f"bare bf16 decode step in the five dense bf16 control phases{depth}, pipelined, JAX harvest, "
        "eager, unpipelined, pipelined (eager wall / graphed wall / device ms): " + ", ".join(
            f"{t['wall_ms']:.2f} / {t['graph_wall_ms']:.3f} / {t['device_ms']:.3f}" for t in bare))
    # the int8-weight phase beside the bf16 one, both at full depth
    bf16, int8 = runs[dense_crash, False][0], runs[int8_weights, False][0]
    log(f"bare decode step, bf16 vs int8 weights (32 slots x 512 rows): eager wall "
        f"{bf16['timing']['wall_ms']:.2f} vs {int8['timing']['wall_ms']:.2f} ms, graphed wall "
        f"{bf16['timing']['graph_wall_ms']:.3f} vs {int8['timing']['graph_wall_ms']:.3f} ms, device "
        f"{bf16['timing']['device_ms']:.3f} vs {int8['timing']['device_ms']:.3f} ms, weights read "
        f"{bf16['timing']['weight_bytes'] / 1e9:.2f} vs {int8['timing']['weight_bytes'] / 1e9:.2f} GB; "
        f"serving peak {bf16['peak_gib']:.2f} vs {int8['peak_gib']:.2f} GiB; uniform burst "
        f"{bf16['uniform_tok_s']:.1f} vs {int8['uniform_tok_s']:.1f} tok/s")
    # a real checkpoint's path: the provider's own weights written as a HF
    # directory and read back, then served with top-K logprobs
    started = time.perf_counter()
    try:
        gate = check_checkpoint(device)
        serve_checkpoint_and_check(label, CHECKPOINT_DIR, runs[dense_crash, False][0], gate)
    finally:
        shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    walls.append(("checkpoint", time.perf_counter() - started))
    # load shedding (and the profile capture) and the watchdog's
    # escalation, at RECOVERY_LAYERS: the server of the shedding phase
    # brings the profiler up in this thread, before the watchdog's capture
    # would in its own (CUPTI stays attached from the first capture on)
    for phase in (serve_shedding_and_check, serve_watchdog_and_check):
        gc.collect()
        torch.cuda.empty_cache()
        started = time.perf_counter()
        phase(label)
        walls.append((phase.__name__, time.perf_counter() - started))
    # embeddings and vector search: the encoder against the CPU, its HF
    # loader, the embeddings service beside the engine, the store
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    encoder_config, encoder_params, _ = check_encoder_against_cpu(device, label)
    check_bert_checkpoint(device, encoder_config, encoder_params, label)
    serve_embeddings_and_check(label, device, encoder_config, encoder_params)
    del encoder_params
    check_vector_search(device, label)
    walls.append(("embeddings and search", time.perf_counter() - started))
    # disaggregation and the host tier: the handoff between two engines,
    # demote and promote
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    check_disagg_and_tiers(label)
    walls.append(("disaggregation and host tier", time.perf_counter() - started))
    # training: Llama-3.2-1B's shape at full depth with AdamW, its
    # checkpoint, the resume, and the checkpoint served back (B1, B2)
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    check_training(device, label)
    walls.append(("training", time.perf_counter() - started))
    # the Mixtral family: the 2-layer model against the CPU, its HF
    # checkpoint, and MOE_SERVE_LAYERS served (B1, B2; B3 at 2 layers)
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    check_moe(device, label)
    walls.append(("mixtral (MoE)", time.perf_counter() - started))
    # tensor parallelism: two ranks sharing the card over gloo, the
    # 2-layer check, the tp features at 2 layers (B3, B7) and Llama-3-8B
    # served at CUT_LAYERS (B1, B2)
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    check_tp(device, label)
    walls.append(("tensor parallelism", time.perf_counter() - started))
    # training on the mesh: two ranks sharing the card over gloo, dp2,
    # fsdp2, tp2, pp2 and Mixtral at ep2, ring and Ulysses, a checkpoint
    # across meshes
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    check_mesh_training(device, label)
    walls.append(("training on the mesh", time.perf_counter() - started))
    # the LangStream app: `apps run` as a subprocess, chat clients through
    # its gateway (B1, B2 by the app's card counters)
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    serve_app_and_check(label)
    walls.append(("LangStream app", time.perf_counter() - started))
    # the RAG app: `apps run` with --http-port, ingest through its gateway,
    # clients asking through it (B3 by the app's card counters)
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    serve_rag_and_check(label)
    walls.append(("RAG app", time.perf_counter() - started))
    log("phase wall times, longest first: " + ", ".join(
        f"{name} {seconds:.1f}s" for name, seconds in sorted(walls, key=lambda item: -item[1]))
        + f"; {sum(seconds for _, seconds in walls):.1f}s in all")
    for item in kernels:
        item["launches"] = launches[item["name"]]
        assert item["launches"] > 0, item
        for shape in ("decode", "prefill", "verify"):
            if f"{item['name']}/{shape}" in launches:
                item[f"{shape}_launches"] = launches[f"{item['name']}/{shape}"]
    log(f"chip_smoke: {time.perf_counter() - STARTED:.1f}s of wall time since torch was imported")
    log(label)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    main()
