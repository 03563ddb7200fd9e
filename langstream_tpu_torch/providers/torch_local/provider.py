"""The ``torch-local`` service provider: chat and text completions, and
embeddings, on one GPU.

Port of ``JaxCompletionsService``, ``JaxEmbeddingsService`` and
``JaxLocalServiceProvider`` (``providers/jax_local/provider.py``).
Completions configuration, with the JAX provider's keys::

    model: {preset: "llama-3-8b"}      # or explicit dims; default "tiny"
    checkpoint: "/models/llama-3-8b"   # HF dir; omit = random weights
    tokenizer: {type: "hf", path: "/models/llama-3-8b"}
    seed: 0                            # random-init weight seed
    quantization: int8                 # weight-only int8 weights
    engine: {max-slots: 16, max-seq-len: 4096, decode-chunk: 8,
             prefill-buckets: [64, 128], sampling-seed: 7,
             kv-layout: paged, kv-block-size: 16, kv-blocks: 4097,
             kv-host-blocks: 8192,
             paged-kernel: fused, prefix-cache: true, kv-quant: int8,
             prefill-mode: mixed, prefill-chunk: 64, mixed-carry: on,
             pipeline-decode: true, admission-chunk: 4, precompile: true,
             spec-decode: ngram, spec-k: 4, spec-ngram: 2, logprobs-top-k: 5,
             supervisor: true, max-restarts: 3, restart-window-s: 600,
             watchdog: on, queue-timeout-s: 30}

``checkpoint`` names a HuggingFace model directory, loaded in bf16 onto
the device as the JAX provider dispatches (``weights.load_checkpoint``):
safetensors files, else ``pytorch_model.bin``; or a directory of step
directories that the port's ``training.checkpoint`` wrote (a trainer's
saves or a ``save_model`` export), whose latest step loads in its own
dtypes; an orbax directory of the JAX package and a mixture-of-experts
model raise. Its ``config.json`` (or the step's meta) gives the model,
and ``model`` is ignored; with ``quantization: int8`` the engine quantizes
the loaded weights (``quant.quantize_params``) and the bf16 ones are
freed. With no ``checkpoint`` the weights are random, drawn from
``seed`` on the device; with ``quantization: int8`` they are drawn
directly in int8 on the device (``quant.init_quantized_params``), so the
model-dtype weights are never made; with ``$LS_WEIGHTS_CACHE_DIR`` set,
a later start loads that draw from the directory instead
(``quant.init_quantized_params_cached``; off by default). ``tokenizer: {type: hf, path}``
serves the checkpoint's own tokenizer (it needs the ``transformers``
package); the default is the byte tokenizer. ``logprobs-top-k`` K keeps
the K most likely alternatives of every token, which a request asks for
with the OpenAI ``top_logprobs`` (up to K). ``kv-quant: int8`` stores the KV cache as int8 with per-(position,
kv head) scales on either layout. ``kv-host-blocks`` N (paged only)
keeps up to N evicted prefix blocks in pinned host memory and promotes
them back when a prompt continues their chain. ``prefill-mode: mixed`` (paged only)
carries prompt windows of up to ``prefill-chunk`` tokens in the decode
step instead of separate prefill calls. ``pipeline-decode`` dispatches
each decode chunk off the previous one's device outputs before the host
processes them (off unless set, as in the JAX provider; ``serve`` sets
it), and ``mixed-carry`` (on unless set off) chains mixed steps the same
way on top of it. ``admission-chunk`` caps a decode chunk at that many
steps while requests wait for a slot, and ``precompile`` captures every
step variant's CUDA graph and runs every prefill variant once before the
engine starts (the JAX engine's ``precompile``). ``spec-decode: ngram``
drafts ``spec-k`` tokens a decode step from each slot's own history
(matching its trailing ``spec-ngram`` tokens) and verifies them in one
model call. A request's ``session-id`` option (the OpenAI ``session_id``
or ``user`` field) pins its KV rows for the session's next turn, and its
``trace-id`` option (the server's ``x-langstream-trace-id``) tags its
spans and journey. ``slo: {ttft-ms-p95: 200, tpot-ms-p95: 30}`` (either
target optional; a zero one is dropped) exports the SLO's burn rates over
5 minutes and an hour and the violating requests' blame by journey stage
on ``/metrics`` (``runtime/accounting.py``).

The engine supervisor (``runtime/supervisor.py``) is on by default, as in
the JAX provider: a crash of the engine thread, or a watchdog
escalation, snapshots every live session, releases the dead engine's
device state, rebuilds the engine through a factory that holds the
weights already on the card (and precompiles when the config asks), and
resumes each stream bitwise; new requests meanwhile get 503 with
``Retry-After``. ``max-restarts`` rebuilds within ``restart-window-s``
are allowed, then it gives up and fails the waiters. ``supervisor:
false`` (or ``LANGSTREAM_SUPERVISOR=0``) serves unsupervised: a crash
fails every waiter. The supervisor heals Python-level crashes and wedged
steps; a sticky CUDA error (an illegal address, say) poisons the
process's CUDA context, and no rebuild in the process survives it.
``watchdog`` (off unless set, as in the JAX provider; ``serve`` sets it
on) runs the decode-stall watchdog; it also takes a mapping of
:class:`~langstream_tpu_torch.runtime.watchdog.EngineWatchdog` settings
(``interval``, ``no-progress-s``, ``trip-cooldown-s``,
``escalate-trips``, ``escalate-window-s``, ``capture-profile``, ...),
which turns it on with them. ``queue-timeout-s`` sheds a request that
waited longer for admission with a 503 and ``Retry-After``.

``mesh: {tp: N}`` serves the model over N tensor-parallel ranks, one
process each (``torch.distributed`` must be up, one rank per process:
``serve --tp N`` starts them, ``runtime.multihost`` joins them across
hosts). Every rank builds this service from the same config: it loads or
draws the same full weights and keeps its shard (a checkpoint is read on
the host and sliced before it reaches the card; random weights are sliced
leaf by leaf as they are drawn), and its engine holds its own kv heads.
Rank 0 serves; the others replay its dispatches (``serving/mirror.py``,
attached with :meth:`TorchCompletionsService.attach_mirror`). The step
functions run eagerly under tp. The supervisor stays on: a heal publishes
``release`` from the dead engine and ``rebuild`` from the factory, and the
followers rebuild beside rank 0 (``serve --followers`` turns it off, as the
JAX serve does across hosts). The heal covers what the fault points model,
which fire before a step publishes: a crash of rank 0 after it published a
step and before it entered that step's collectives would leave the
followers waiting in the group until its time limit. Axes other than
``tp`` raise (ROADMAP.md, A10).

Embeddings configuration (:class:`TorchEmbeddingsService`)::

    embeddings-model: {checkpoint: "/models/all-MiniLM-L6-v2"}  # HF BERT dir
    embeddings-model: {preset: minilm-l6, max-length: 256}      # random weights
    tokenizer: {type: "byte"}          # without a checkpoint

A ``checkpoint`` (or a ``model`` name holding ``/``) is loaded with
``weights.load_hf_bert`` and served with its directory's own HF
tokenizer; otherwise the encoder is ``EncoderConfig.from_dict`` of the
mapping (the random ``tiny`` preset when it is empty), over the
``tokenizer`` key's tokenizer.
"""

from __future__ import annotations

import asyncio
import logging
import os
import secrets
import time
import uuid
from typing import Any, Dict, List, Optional

from langstream_tpu_torch.api import errors as api_errors
from langstream_tpu_torch.api.service import (
    ChatChunk,
    ChatCompletionResult,
    ChatMessage,
    CompletionsService,
    EmbeddingsService,
    ServiceProvider,
)
from langstream_tpu_torch.device import resolve_device
from langstream_tpu_torch.parallel.mesh import MeshConfig, tp_rank
from langstream_tpu_torch.providers.torch_local import model as model_lib
from langstream_tpu_torch.providers.torch_local.embeddings import (
    EncoderConfig,
    TorchEmbedder,
    init_encoder_params,
)
from langstream_tpu_torch.providers.torch_local.engine import (
    DecodeEngine,
    SamplingParams,
)
from langstream_tpu_torch.providers.torch_local.quant import init_quantized_params_cached, quantize_params
from langstream_tpu_torch.providers.torch_local.tokenizer import HFTokenizer, get_tokenizer
from langstream_tpu_torch.providers.torch_local.weights import load_checkpoint, load_hf_bert

logger = logging.getLogger(__name__)


def _on(value: Any) -> bool:
    return str(value).lower() in ("1", "true", "yes")


def mirror_fingerprint(config: Dict[str, Any]) -> bytes:
    """The leader's and followers' config digest over the keys that shape
    the model calls (the JAX ``serve``'s ``_mirror_fingerprint``): the SLO
    targets and the watchdog are left out, since a follower serves no
    HTTP surface."""
    from langstream_tpu_torch.serving.mirror import config_fingerprint

    scrubbed = {key: value for key, value in config.items() if key != "slo"}
    scrubbed["engine"] = {key: value for key, value in (config.get("engine") or {}).items()
                          if key != "watchdog"}
    return config_fingerprint(scrubbed)


def _watchdog_settings(value: Any) -> Optional[Dict[str, Any]]:
    """The watchdog's settings from the ``watchdog`` key: None (off) for
    an unset or false flag; ``{}`` (the defaults) for a true one; a
    mapping of :class:`EngineWatchdog` keyword arguments, dashes or
    underscores, for a mapping."""
    if isinstance(value, dict):
        return {str(key).replace("-", "_"): setting for key, setting in value.items()}
    return {} if str(value).lower() in ("1", "true", "yes", "on") else None


def _buckets(value: Any) -> Optional[List[int]]:
    """Prefill buckets from config: a list, an int, or "128,256"."""
    if isinstance(value, str):
        return [int(b) for b in value.replace(",", " ").split()] or None
    if isinstance(value, int):
        return [value]
    if value:
        return [int(b) for b in value]
    return None


class TorchCompletionsService(CompletionsService):
    """Completions over a :class:`DecodeEngine`; the surface the port's
    OpenAI server calls (``get_chat_completions`` /
    ``get_text_completions``). A ``stream_consumer`` is any object with
    ``consume_chunk(answer_id, index, chunk, last)``; it is called on the
    caller's event loop as deltas decode."""

    def __init__(self, config: Dict[str, Any], device: Any = "cuda", *,
                 step_graphs: bool = True) -> None:
        """``step_graphs=False`` builds the engine with eager dispatch, a
        control for measurements; no config key reaches it."""
        self.device = resolve_device(device)
        quantization = config.get("quantization") or None
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantization!r}")
        engine_config = config.get("engine", {}) or {}
        mesh = MeshConfig.from_config(config.get("mesh"))
        # a tp rank keeps its shard of every leaf (rank 0 of 1 keeps all)
        rank = tp_rank(mesh)
        # the tokenizer first: a missing `transformers` fails before the
        # weights load
        self.tokenizer = get_tokenizer(config.get("tokenizer"))
        checkpoint = config.get("checkpoint")
        started = time.perf_counter()
        if checkpoint:
            # the checkpoint's config.json gives the model; `model` is
            # ignored, as in the JAX provider
            if mesh.tp > 1:
                # read on the host, quantized whole (a row-sharded weight's
                # scale is the whole row's), and only the rank's shard
                # goes to the card
                model_config, params = load_checkpoint(str(checkpoint), device="cpu")
                if quantization == "int8":
                    params = quantize_params(params, model_config.num_experts)
                params = {name: leaf.to(self.device) for name, leaf in model_lib.rank_params(
                    model_config, params, mesh, rank).items()}
            else:
                model_config, params = load_checkpoint(str(checkpoint), device=self.device)
            logger.info("loaded checkpoint %s (%.2fB params)", checkpoint,
                        model_config.num_params() / 1e9)
        else:
            model_config = model_lib.LlamaConfig.from_dict(config.get("model", {"preset": "tiny"}))
            seed = int(config.get("seed", 0))
            keep = None
            if mesh.tp > 1:
                def keep(name, leaf):
                    return model_lib.shard_leaf(model_config, name, leaf, mesh, rank)
            if quantization == "int8":
                # drawn directly in int8 on the device: Llama-3-8B never
                # holds its bf16 weights; loaded from $LS_WEIGHTS_CACHE_DIR
                # instead when that names a directory
                params = init_quantized_params_cached(model_config, seed=seed,
                                                      device=self.device, keep=keep)
            else:
                params = model_lib.init_params(model_config, seed=seed, device=self.device,
                                               keep=keep)
            logger.warning(
                "torch-local: no checkpoint configured — RANDOM %sweights "
                "(%.2fB params, benchmarking only)", "int8 " if quantization else "",
                model_config.num_params() / 1e9,
            )
        # seconds to load (or draw) the weights
        self.load_s = time.perf_counter() - started
        if engine_config.get("sampling-seed") is not None:
            sampling_seed = int(engine_config["sampling-seed"])
        else:
            # real entropy by default, so unseeded requests differ across
            # processes
            sampling_seed = secrets.randbits(32)
        engine_kwargs = dict(
            device=self.device,
            max_slots=int(engine_config.get("max-slots", 8)),
            max_seq_len=(
                int(engine_config["max-seq-len"])
                if engine_config.get("max-seq-len") is not None else None
            ),
            prefill_buckets=_buckets(engine_config.get("prefill-buckets")),
            decode_chunk=int(engine_config.get("decode-chunk", 8)),
            seed=sampling_seed,
            # paged KV cache + persistent prefix-block pool (dense stays the
            # default); values may arrive as strings, like every engine knob
            kv_layout=str(engine_config.get("kv-layout") or "dense").lower(),
            kv_block_size=int(engine_config.get("kv-block-size") or 16),
            kv_blocks=(
                int(engine_config["kv-blocks"]) if engine_config.get("kv-blocks") else None
            ),
            # host-DRAM demotion tier below the block pool (0 = off)
            kv_host_blocks=int(engine_config.get("kv-host-blocks") or 0),
            paged_kernel=str(engine_config.get("paged-kernel") or "fused").lower(),
            prefix_cache=str(engine_config.get("prefix-cache", "true")).lower()
            not in ("0", "false", "no"),
            kv_quant=engine_config.get("kv-quant") or None,
            prefill_mode=str(engine_config.get("prefill-mode") or "split").lower(),
            prefill_chunk=int(engine_config.get("prefill-chunk") or 64),
            mixed_carry=str(engine_config.get("mixed-carry", "on")).lower()
            not in ("0", "false", "no", "off"),
            pipeline_decode=_on(engine_config.get("pipeline-decode", "")),
            quantize=quantization,
            admission_chunk=(
                int(engine_config["admission-chunk"])
                if engine_config.get("admission-chunk") else None
            ),
            step_graphs=step_graphs,
            # speculative decoding: off | ngram (a value the engine does
            # not know raises there, as in the JAX engine)
            spec_decode=str(engine_config.get("spec-decode") or "off").lower(),
            spec_k=int(engine_config.get("spec-k") or 4),
            spec_ngram=int(engine_config.get("spec-ngram") or 2),
            # OpenAI `top_logprobs`: static K per engine (it shapes every
            # step's outputs); requests may ask for any n <= K
            logprobs_topk=int(engine_config.get("logprobs-top-k", 0) or 0),
            # admission deadline: a request pending longer is shed with a
            # typed 503 instead of starving in the queue
            queue_timeout_s=(
                float(engine_config["queue-timeout-s"])
                if engine_config.get("queue-timeout-s") else None
            ),
            # SLO targets (`slo: {ttft-ms-p95: 200, tpot-ms-p95: 30}`, a
            # zero target dropped, as in the JAX provider): burn rates and
            # per-stage blame on /metrics
            slo={str(key).replace("-", "_"): float(value)
                 for key, value in (config.get("slo") or {}).items() if value} or None,
            mesh_config=mesh,
        )
        precompile = _on(engine_config.get("precompile", ""))
        weights = {"params": params}
        del params

        # the dispatch mirror of rank 0 under tp (attach_mirror)
        self.mirror = None

        def build_engine() -> DecodeEngine:
            # the supervisor's rebuild runs this closure: the weights on
            # the card are reused, never reloaded or drawn again
            if self.mirror is not None:
                # a heal under tp: the followers build theirs beside this
                # one (the group is built collectively)
                self.mirror.publish("rebuild", {}, [])
            engine = DecodeEngine(model_config, weights["params"], **engine_kwargs)
            engine.mirror = self.mirror
            # the engine holds the weights it serves (quantized, if asked):
            # a rebuild takes those, and a loaded bf16 copy is freed
            weights["params"] = engine.params
            if precompile:
                # every step variant captured and every prefill variant
                # run before the first request, so none stalls traffic
                engine.precompile()
            return engine

        watchdog = _watchdog_settings(engine_config.get(
            "watchdog", os.environ.get("LANGSTREAM_WATCHDOG", "")))

        def build_watchdog(engine: DecodeEngine):
            from langstream_tpu_torch.runtime.watchdog import EngineWatchdog

            return EngineWatchdog(engine, **watchdog)

        # the engine supervisor: on by default, as in the JAX provider
        self._supervisor = None
        self._engine: Optional[DecodeEngine] = None
        self._watchdog = None
        # a follower rank's engine factory (serving/mirror.py, rebuild)
        self.build_engine = build_engine
        supervised = str(engine_config.get(
            "supervisor", os.environ.get("LANGSTREAM_SUPERVISOR", "1"))).lower() not in (
            "0", "false", "no", "off")
        if supervised:
            from langstream_tpu_torch.runtime.supervisor import EngineSupervisor

            self._supervisor = EngineSupervisor(
                build_engine,
                max_restarts=int(engine_config.get("max-restarts") or 3),
                restart_window_s=float(engine_config.get("restart-window-s") or 600.0),
                watchdog_factory=build_watchdog if watchdog is not None else None,
            )
        else:
            self._engine = build_engine()
            self._engine.start()
            if watchdog is not None:
                self._watchdog = build_watchdog(self._engine)
                self._watchdog.start()
        # the most top_logprobs alternatives a token (0 = none): the
        # server validates requests against it
        self.top_logprobs_limit = self.engine.logprobs_topk

    @property
    def engine(self) -> DecodeEngine:
        """The current engine: the supervisor swaps it on a rebuild, so
        callers read it here each time instead of keeping it."""
        if self._supervisor is not None:
            return self._supervisor.engine
        return self._engine

    def attach_mirror(self, mirror) -> None:
        """Rank 0 under tp: publish every dispatch of this engine, and of
        each engine the supervisor rebuilds, to ``mirror``."""
        self.mirror = mirror
        self.engine.mirror = mirror

    @property
    def supervisor(self):
        """The engine supervisor, or None when serving unsupervised."""
        return self._supervisor

    @property
    def watchdog(self):
        """The current engine's watchdog, or None (the supervisor builds a
        new one with every rebuilt engine)."""
        if self._supervisor is not None:
            return self._supervisor.watchdog
        return self._watchdog

    def available(self) -> Optional[float]:
        """None while accepting work; else the seconds a caller should
        wait (the supervisor is rebuilding a crashed engine). A supervisor
        past its restart budget is ``failed``: its callers get a 500."""
        supervisor = self._supervisor
        if supervisor is not None and supervisor.state == "rebuilding":
            return supervisor.retry_after()
        return None

    def close(self) -> None:
        """Stop the watchdog and the engine (the supervisor owns both)."""
        if self._supervisor is not None:
            self._supervisor.stop()
            return
        if self.watchdog is not None:
            self.watchdog.stop()
        self.engine.stop()

    async def get_chat_completions(
        self,
        messages: List[ChatMessage],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        prompt_tokens = self.tokenizer.apply_chat_template(
            [{"role": m.role, "content": m.content} for m in messages]
        )
        return await self._generate(prompt_tokens, options, stream_consumer)

    async def get_text_completions(
        self,
        prompt: List[str],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        """Legacy text completions continue the prompt verbatim — no chat
        template."""
        prompt_tokens = self.tokenizer.encode("".join(prompt))
        return await self._generate(prompt_tokens, options, stream_consumer)

    async def _generate(
        self,
        prompt_tokens: List[int],
        options: Dict[str, Any],
        stream_consumer: Optional[Any] = None,
    ) -> ChatCompletionResult:
        wait = self.available()
        if wait is not None:
            # the supervisor is rebuilding: new work bounces with the typed
            # retryable error before any engine work (the engine's submit
            # backstops the race)
            raise api_errors.EngineRebuildingError(
                "engine is rebuilding after a crash; retry shortly", retry_after_s=wait)
        sampling = SamplingParams(
            temperature=float(options.get("temperature") or 0.0),
            top_k=int(options.get("top-k") or 0),
            top_p=float(options.get("top-p") or 0.0),
            max_new_tokens=int(options.get("max-tokens") or 256),
            presence_penalty=float(options.get("presence-penalty") or 0.0),
            frequency_penalty=float(options.get("frequency-penalty") or 0.0),
            seed=int(options["seed"]) if options.get("seed") is not None else None,
            logit_bias=(
                {int(k): float(v) for k, v in options["logit-bias"].items()}
                if options.get("logit-bias") else None
            ),
        )
        # OpenAI-style stop STRINGS: generation is cancelled at the next
        # token boundary once one appears in the decoded text, and the
        # result is trimmed at the match
        stop = options.get("stop") or []
        if isinstance(stop, str):
            stop_strings = [stop]
        elif isinstance(stop, (list, tuple)):
            stop_strings = [str(s) for s in stop if s is not None and s != ""]
        else:
            stop_strings = [str(stop)]
        handle: list = []
        released_parts: list = []
        retained = [""]
        stop_cut: list = []
        holdback = max((len(s) for s in stop_strings), default=1) - 1

        def watch_stop(delta: str, final: bool = False) -> str:
            """On a stop match, cancel the request and release only the
            text BEFORE the match; withhold the last ``len(longest stop) -
            1`` chars until cleared so a stop split across two deltas never
            partially leaks into the stream."""
            if not stop_strings:
                return delta
            if stop_cut:
                return ""
            window = retained[0] + delta
            hits = [p for p in (window.find(s) for s in stop_strings) if p != -1]
            if hits:
                release = window[: min(hits)]
                retained[0] = ""
                stop_cut.append(True)
                if handle:
                    handle[0].cancel()
            elif final:
                release = window
                retained[0] = ""
            else:
                keep = min(holdback, len(window))
                release = window[: len(window) - keep]
                retained[0] = window[len(window) - keep:]
            if release:
                released_parts.append(release)
            return release

        answer_id = uuid.uuid4().hex
        on_token = None
        decoder = None
        index_box = [0]
        last_sent = [False]
        if stream_consumer is not None:
            decoder = self.tokenizer.stream_decoder()

            def on_token(token_id: int, is_last: bool) -> None:
                text = decoder.push(token_id)
                if is_last:
                    text += decoder.flush()
                text = watch_stop(text, final=is_last)
                if text or is_last:
                    index = index_box[0]
                    index_box[0] += 1
                    if is_last:
                        last_sent[0] = True
                    stream_consumer.consume_chunk(
                        answer_id, index, ChatChunk(content=text, index=index),
                        last=is_last,
                    )

        elif stop_strings:
            plain_decoder = self.tokenizer.stream_decoder()

            def on_token(token_id: int, is_last: bool) -> None:
                watch_stop(plain_decoder.push(token_id))

        result = await self.engine.generate(
            prompt_tokens, sampling,
            stop_tokens=set(self.tokenizer.eos_ids),
            on_token=on_token,
            session_id=options.get("session-id"),
            handle=handle,
            trace_id=str(options["trace-id"]) if options.get("trace-id") else None,
        )
        if stop_cut:
            text = "".join(released_parts)
        else:
            text = self.tokenizer.decode(result.tokens)
        stop_trimmed = False
        if stop_strings and not stop_cut:
            for s in stop_strings:
                cut = text.find(s)
                if cut != -1:
                    text = text[:cut]
                    stop_trimmed = True
        kept_tokens, kept_logprobs, kept_tops = result.tokens, result.logprobs, result.top_logprobs
        if stop_cut or stop_trimmed:
            # drop the tokens past the stop so per-token data aligns with
            # the trimmed content
            walker = self.tokenizer.stream_decoder()
            length = kept = 0
            for token in result.tokens:
                length += len(walker.push(token))
                if length > len(text):
                    break
                kept += 1
            kept_tokens = result.tokens[:kept]
            kept_logprobs = result.logprobs[:kept]
            if kept_tops is not None:
                kept_tops = kept_tops[:kept]
        if stream_consumer is not None and not last_sent[0]:
            # terminal marker when the stop token arrived without a
            # trailing streamed delta
            tail = watch_stop(decoder.flush(), final=True)
            stream_consumer.consume_chunk(
                answer_id, index_box[0],
                ChatChunk(content=tail, index=index_box[0]), last=True,
            )
        want_logprobs = bool(options.get("logprobs"))
        finish_reason = "stop" if (stop_cut or stop_trimmed) else result.finish_reason
        return ChatCompletionResult(
            content=text,
            finish_reason=finish_reason,
            prompt_tokens=result.prompt_tokens,
            completion_tokens=len(kept_tokens),
            tokens=(
                [self.tokenizer.decode([t]) for t in kept_tokens]
                if want_logprobs else None
            ),
            logprobs=list(kept_logprobs) if want_logprobs else None,
            # K single-token decodes a token: only when the request asked
            # for alternatives (top-logprobs > 0)
            top_logprobs=(
                [[(self.tokenizer.decode([int(tid)]), float(tlp)) for tid, tlp in zip(ids, lps)]
                 for ids, lps in kept_tops]
                if want_logprobs and kept_tops is not None
                and int(options.get("top-logprobs") or 0) > 0 else None
            ),
        )


class TorchEmbeddingsService(EmbeddingsService):
    """Embeddings from the encoder of ``embeddings.py`` on ``device`` (the
    card unless the caller asks for the CPU); ``JaxEmbeddingsService``'s
    keys (module docstring)."""

    def __init__(self, config: Dict[str, Any], model: Optional[str] = None,
                 device: Any = "cuda") -> None:
        device = resolve_device(device)
        embeddings_config = config.get("embeddings-model", {}) or {}
        checkpoint = embeddings_config.get("checkpoint") or (
            model if model and "/" in str(model) else None
        )
        if checkpoint:
            encoder_config, params = load_hf_bert(checkpoint, device=device)
            tokenizer = HFTokenizer(checkpoint)
        else:
            encoder_config = EncoderConfig.from_dict(
                embeddings_config if embeddings_config else {"preset": "tiny"}
            )
            params = init_encoder_params(encoder_config, device=device)
            tokenizer = get_tokenizer(config.get("tokenizer"))
            if not embeddings_config:
                logger.warning("torch-local embeddings: no checkpoint — random tiny encoder")
        self.embedder = TorchEmbedder(
            encoder_config, params, tokenizer,
            max_length=int(embeddings_config.get("max-length", 256)), device=device,
        )

    async def compute_embeddings(self, texts: List[str]) -> List[List[float]]:
        # the device call runs off the event loop
        return await asyncio.get_running_loop().run_in_executor(
            None, self.embedder.embed, texts
        )


class TorchLocalServiceProvider(ServiceProvider):
    """The ``torch-local`` provider: owns a ``resources:`` entry of
    ``type: torch-local`` (or ``torch``), or one holding a ``torch-local``
    key, and hands out its completions and embeddings services on
    ``device``. Callers cache the services per resource entry: each call
    builds a new one (a completions service is a whole engine)."""

    name = "torch-local"

    def __init__(self, device: Any = "cuda") -> None:
        self.device = device

    def supports(self, resource_config: Dict[str, Any]) -> bool:
        return (
            resource_config.get("type") in ("torch-local", "torch")
            or "torch-local" in resource_config
        )

    def get_completions_service(self, resource_config: Dict[str, Any]) -> TorchCompletionsService:
        return TorchCompletionsService(resource_config, device=self.device)

    def get_embeddings_service(
        self, resource_config: Dict[str, Any], model: Optional[str] = None
    ) -> TorchEmbeddingsService:
        return TorchEmbeddingsService(resource_config, model, device=self.device)
