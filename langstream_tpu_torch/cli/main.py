"""``python -m langstream_tpu_torch serve``: the OpenAI-compatible server
over the port's engine, mirroring ``langstream-tpu serve``; and
``python -m langstream_tpu_torch journey``: request journeys joined from
flight artifacts, mirroring ``langstream-tpu journey``.

``serve`` turns the flight recorder on, as the JAX ``serve`` does: into
``$LANGSTREAM_FLIGHT_DIR`` (an empty value turns it off), by default
``bench_artifacts/flight`` beside the checkout, stamped with this
replica's identity (``$HOSTNAME``, else the host name; role ``unified``)."""

from __future__ import annotations

import argparse
import logging
import os
import socket
from typing import Any, Dict, List, Optional, Tuple

from langstream_tpu_torch.providers.torch_local.engine import engines_histograms, engines_snapshot
from langstream_tpu_torch.providers.torch_local.model import LlamaConfig
from langstream_tpu_torch.providers.torch_local.provider import (
    TorchCompletionsService,
    TorchEmbeddingsService,
)
from langstream_tpu_torch.runtime import flight, tracing
from langstream_tpu_torch.runtime.journey import run_journey
from langstream_tpu_torch.serving.openai_api import OpenAIApiServer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m langstream_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="OpenAI-compatible HTTP server on the GPU")
    serve.add_argument("--model", default="tiny",
                       help="model preset, or the served model's name with --checkpoint")
    serve.add_argument("--checkpoint", default=None,
                       help="HuggingFace model directory (safetensors or pytorch_model.bin); "
                            "omit for random weights")
    serve.add_argument("--tokenizer", default=None,
                       help="HuggingFace tokenizer directory (needs the transformers package)")
    serve.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    serve.add_argument("--quantization", default=None, choices=["int8"],
                       help="weight-only int8 weights (the checkpoint's, quantized on the "
                            "device; without one, random, drawn in int8 on the device)")
    serve.add_argument("--max-slots", type=int, default=8)
    serve.add_argument("--max-seq-len", type=int, default=2048)
    serve.add_argument("--decode-chunk", type=int, default=16)
    serve.add_argument(
        "--admission-chunk", type=int, default=0,
        help="cap the decode chunk at this many steps while admissions "
             "wait, so new requests join the batch sooner (TTFT lever; "
             "0 = off)",
    )
    serve.add_argument(
        "--precompile", action="store_true",
        help="capture every decode and mixed step variant's CUDA graph and run "
             "every prefill variant once before serving",
    )
    serve.add_argument(
        "--kv-layout", default="dense", choices=["dense", "paged"],
        help="KV cache layout: dense per-slot regions, or a paged block pool "
             "with a persistent refcounted prefix cache",
    )
    serve.add_argument("--kv-block-size", type=int, default=16,
                       help="paged layout: tokens per pool block")
    serve.add_argument(
        "--kv-blocks", type=int, default=0,
        help="paged layout: pool size in blocks (0 = the dense-equivalent "
             "worst case, slots x ceil(max_seq/block) + 1)",
    )
    serve.add_argument(
        "--kv-host-blocks", type=int, default=0,
        help="paged layout: host-DRAM demotion tier capacity in blocks (0 = off): evicted "
             "prefix blocks are copied to pinned host memory and promoted back when a prompt "
             "continues their chain, instead of being prefilled again",
    )
    serve.add_argument(
        "--paged-kernel", default="fused", choices=["fused", "reference"],
        help="paged attention: the ragged CUDA kernel over the block tables "
             "(default) or the gather composition in plain PyTorch",
    )
    serve.add_argument(
        "--prefill-mode", default="split", choices=["split", "mixed"],
        help="paged prefill scheduling: split (bucketed prefill calls) or mixed "
             "(prompt windows ride the decode step through the token-ragged kernel)",
    )
    serve.add_argument("--prefill-chunk", type=int, default=64,
                       help="mixed prefill mode: most prompt tokens one step carries")
    serve.add_argument(
        "--mixed-carry", default="on", choices=["on", "off"],
        help="mixed prefill mode: chain steps off the previous step's device "
             "outputs (with the pipelined decode)",
    )
    serve.add_argument(
        "--no-pipeline-decode", action="store_true",
        help="disable pipelined decode dispatch (on by default): each chunk is "
             "processed on the host before the next is dispatched",
    )
    serve.add_argument("--no-prefix-cache", action="store_true",
                       help="disable prompt-prefix KV reuse (on by default)")
    serve.add_argument(
        "--logprobs-top-k", type=int, default=0,
        help="enable OpenAI top_logprobs up to K alternatives per token (static: "
             "every step computes the top K; 0 = off)",
    )
    serve.add_argument(
        "--no-watchdog", action="store_true",
        help="disable the decode-stall watchdog (on by default for serve: step-latency "
             "degradation, no-progress and KV-pool livelock detection, with evidence capture "
             "and, after repeated trips, an engine restart)",
    )
    serve.add_argument(
        "--no-supervisor", action="store_true",
        help="disable the engine supervisor (on by default: an engine crash or a watchdog "
             "escalation snapshots every live session, rebuilds the engine and resumes each "
             "stream bitwise)",
    )
    serve.add_argument(
        "--max-restarts", type=int, default=3,
        help="supervisor: engine rebuilds allowed inside the restart window before giving up",
    )
    serve.add_argument(
        "--queue-timeout-s", type=float, default=0,
        help="admission deadline: a request pending longer is shed with 503 and Retry-After "
             "(0 = off)",
    )
    serve.add_argument(
        "--embeddings-checkpoint", default=None,
        help="HuggingFace BERT directory (MiniLM and its kin, with its tokenizer): serve "
             "POST /v1/embeddings from it on --device",
    )
    serve.add_argument(
        "--profile-kernels", action="store_true",
        help="bring the profiler's device tracing up at start, so that GET /debug/profile "
             "records the card's kernels; CUPTI then stays attached and every launch of the "
             "process pays for it (off: a capture records host operators only)",
    )
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8000)
    journey = sub.add_parser(
        "journey", help="join flight artifacts ($LANGSTREAM_FLIGHT_DIR) by trace id into "
                        "per-request waterfalls, per-stage p50/p95 and SLO blame")
    journey.add_argument("paths", nargs="+",
                         help="flight_*.jsonl artifacts and/or directories of them")
    journey.add_argument("--trace-id", default=None,
                         help="render the full stage waterfall of one request")
    journey.add_argument("--slo-ttft-ms", type=float, default=0.0,
                         help="TTFT SLO for blame attribution (0 = no TTFT blame)")
    journey.add_argument("--slo-tpot-ms", type=float, default=0.0,
                         help="per-token TPOT SLO for blame attribution (0 = no TPOT blame)")
    journey.add_argument("--top", type=int, default=3,
                         help="how many of the slowest requests' waterfalls to render")
    journey.add_argument("--json", action="store_true",
                         help="emit the joined journeys as JSON instead of tables")
    return parser


def default_flight_dir() -> str:
    """``bench_artifacts/flight`` beside the checkout when the package runs
    from one (where ``tools/ab_analyze.py`` looks), else under the working
    directory."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if os.path.isdir(os.path.join(repo_root, "bench_artifacts")):
        return os.path.join(repo_root, "bench_artifacts", "flight")
    return os.path.join("bench_artifacts", "flight")


def start_flight(run_id: str) -> Optional[str]:
    """Stamp this replica's identity and turn the flight recorder on
    (``$LANGSTREAM_FLIGHT_DIR``, empty = off, default
    :func:`default_flight_dir`); returns the artifact's path or None."""
    flight.set_identity(os.environ.get("HOSTNAME") or socket.gethostname(), "unified")
    directory = os.environ.get(flight.ENV_VAR, default_flight_dir())
    return flight.configure(directory, run_id=run_id) if directory else None


def serve_config(args: argparse.Namespace) -> Dict[str, Any]:
    """The provider config ``serve`` builds from its flags, as the JAX
    ``serve`` builds it. Engine keys without a flag (``kv-quant``, as in
    the JAX ``serve``) reach the engine through this config, as they do
    from a deployment's. With ``--checkpoint`` the checkpoint's config
    gives the model, and a ``--model`` that is no preset is only the
    served name."""
    config: Dict[str, Any] = {
        "model": {"preset": args.model, "max_seq_len": args.max_seq_len},
        "engine": {
            "max-slots": args.max_slots,
            "max-seq-len": args.max_seq_len,
            "decode-chunk": args.decode_chunk,
            "kv-layout": args.kv_layout,
            "kv-block-size": args.kv_block_size,
            "kv-blocks": args.kv_blocks,
            "kv-host-blocks": args.kv_host_blocks or "",
            "paged-kernel": args.paged_kernel,
            "prefix-cache": not args.no_prefix_cache,
            "prefill-mode": args.prefill_mode,
            "prefill-chunk": args.prefill_chunk,
            "mixed-carry": args.mixed_carry,
            "pipeline-decode": not args.no_pipeline_decode,
            "admission-chunk": args.admission_chunk or "",
            "precompile": bool(args.precompile),
            "logprobs-top-k": args.logprobs_top_k,
            # the decode-stall watchdog: on by default for serve
            "watchdog": not args.no_watchdog,
            # the engine supervisor: crash → snapshot → rebuild → resume
            "supervisor": not args.no_supervisor,
            "max-restarts": args.max_restarts,
            "queue-timeout-s": args.queue_timeout_s or "",
        },
    }
    try:
        LlamaConfig.from_dict({"preset": args.model})
        known_preset = True
    except KeyError:
        known_preset = False
    if args.checkpoint:
        config["checkpoint"] = args.checkpoint
        if not known_preset:
            config["model"] = {}
    elif not known_preset:
        raise SystemExit(
            f"unknown model preset {args.model!r} and no --checkpoint given; pass a preset "
            "(tiny, llama-3-1b, llama-3-8b, llama-3-70b) or point --checkpoint at a model directory")
    if args.tokenizer:
        config["tokenizer"] = {"type": "hf", "path": args.tokenizer}
    if args.quantization:
        config["quantization"] = args.quantization
    return config


def start_server(
    args: argparse.Namespace, config: Optional[Dict[str, Any]] = None, *,
    step_graphs: bool = True, embeddings: Optional[TorchEmbeddingsService] = None,
) -> Tuple[TorchCompletionsService, OpenAIApiServer]:
    """Build the service (the checkpoint's weights, or random ones from
    seed 0) from ``config`` (default: :func:`serve_config` of ``args``)
    and start the server thread; the caller owns stopping both (``server.stop()``,
    ``service.close()``, and ``server.embeddings.close()`` when set). The server
    answers ``/v1/embeddings`` from ``embeddings``, else from a
    :class:`TorchEmbeddingsService` over ``--embeddings-checkpoint`` when it is
    given. ``step_graphs=False`` serves with eager dispatch, a control for
    measurements."""
    if embeddings is None and args.embeddings_checkpoint:
        embeddings = TorchEmbeddingsService(
            {"embeddings-model": {"checkpoint": args.embeddings_checkpoint}}, device=args.device)
    if args.profile_kernels:
        # /debug/profile captures from a handler thread: the profiler's
        # device tracing must first come up in this one
        tracing.prime_profiler()
    service = TorchCompletionsService(
        config or serve_config(args), device=args.device, step_graphs=step_graphs)
    server = OpenAIApiServer(service, embeddings, model=args.model, host=args.host,
                             port=args.port, gauges=engines_snapshot,
                             histograms=engines_histograms)
    server.start()
    return service, server


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.command == "journey":
        for line in run_journey(args.paths, trace_id=args.trace_id, slo_ttft_ms=args.slo_ttft_ms,
                                slo_tpot_ms=args.slo_tpot_ms, as_json=args.json,
                                waterfalls=args.top):
            print(line)
        return
    path = start_flight(f"serve-{args.model}")
    if path:
        print(f"flight recorder -> {path}", flush=True)
    service, server = start_server(args)
    print(f"serving {args.model} on http://{args.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        service.close()
        if server.embeddings is not None:
            server.embeddings.close()
