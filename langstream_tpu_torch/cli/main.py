"""``python -m langstream_tpu_torch serve``: the OpenAI-compatible server
over the port's engine, mirroring ``langstream-tpu serve``; and
``python -m langstream_tpu_torch journey``: request journeys joined from
flight artifacts, mirroring ``langstream-tpu journey``.

``serve`` turns the flight recorder on, as the JAX ``serve`` does: into
``$LANGSTREAM_FLIGHT_DIR`` (an empty value turns it off), by default
``bench_artifacts/flight`` beside the checkout, stamped with this
replica's identity (``$HOSTNAME``, else the host name; role ``unified``).

``serve --tp N`` serves the model over N tensor-parallel ranks, one
process each (:func:`start_tp_server`): this process is rank 0, joins a
gloo group with the N−1 follower ranks it starts itself
(``parallel/launch.py``), rank r on card r (it refuses when the host has
fewer cards; on ``--device cpu`` every rank runs on the CPU), builds the
service and the HTTP surface, and publishes every dispatch to the
followers through the dispatch mirror (``serving/mirror.py``), which
replay it (:func:`follow`). Across hosts, the leader runs ``serve --tp N
--followers N-1`` and each other host ``serve --tp N --follower-of
HOST:PORT`` with the same flags, every process joining the group from
its StatefulSet identity (``runtime.multihost``).

``python -m langstream_tpu_torch apps run <dir> --instance ...`` runs a
LangStream application in this process, as ``langstream-tpu apps run``
does (``langstream_tpu/cli/main.py``): the app is parsed and planned,
every agent runs on the broker its instance names (``memory``, ``tpulog``
or ``kafka``), its ``torch-local`` resources
serve on the card (``--device cpu`` for the CPU), and its gateways listen
on ``--gateway-port`` (0 picks a free one; the line ``gateway on
ws://HOST:PORT/v1/...`` names it). ``--http-port PORT`` (off unless
given; 0 picks a free one, named by the line ``metrics on
http://HOST:PORT/metrics``) serves the runner's HTTP surface
(``runtime/pod.py``): ``/info``, ``/metrics`` with each agent node's
record counters and the engine's series, ``/ready``, ``/ok`` and
``/debug/profile``. SIGINT or SIGTERM drains the agents, stops the
gateway and the HTTP surface and closes the engines. The gateway's
``/metrics`` serves the engine's series too.

Across processes, as LangStream deploys an app (one pod a plan node):
``python -m langstream_tpu_torch broker DIR [--host H] [--port P]`` serves
a durable ``tpulog`` broker over ``DIR`` (it prints ``tpulog broker
serving DIR on HOST:PORT (native log store LIB)``); ``application-setup
[--delete] [--device cpu]`` creates the
topics of the Application document in ``$LANGSTREAM_APPLICATION`` on the
broker its instance names; and ``agent-runner --config
pod-configuration.json [--http-port P] [--device cpu]`` runs one plan
node (``runtime/pod.py``; ``pod_configuration(plan, node)`` writes the
file) until SIGTERM, serving ``/info``, ``/metrics``, ``/ready``,
``/debug/profile`` and ``/debug/launches``.

``python -m langstream_tpu_torch docs [TYPE] [--json]`` prints the typed
agent-configuration table the planner checks (``model/docs.py``), and
``plugins package DIR [-o ZIP]`` / ``plugins list`` package and list
agent plugins (``runtime/plugins.py``), as ``langstream-tpu``'s do."""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import socket
from typing import Any, Dict, List, Optional, Tuple

import torch

from langstream_tpu_torch.parallel import launch
from langstream_tpu_torch.parallel.mesh import MeshConfig
from langstream_tpu_torch.providers.torch_local.engine import engines_histograms, engines_snapshot
from langstream_tpu_torch.providers.torch_local.model import LlamaConfig
from langstream_tpu_torch.providers.torch_local.provider import (
    TorchCompletionsService,
    TorchEmbeddingsService,
    mirror_fingerprint,
)
from langstream_tpu_torch.runtime import flight, multihost, tracing
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
    serve.add_argument("--tp", type=int, default=1, help="tensor parallelism")
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
        "--spec-decode", default="off", choices=["off", "ngram"],
        help="speculative decoding: self-drafting prompt-lookup drafts spec-k tokens per "
             "decode step, one batched forward verifies them",
    )
    serve.add_argument("--spec-k", type=int, default=4,
                       help="drafted tokens verified per decode step (spec-decode)")
    serve.add_argument("--spec-ngram", type=int, default=2,
                       help="suffix n-gram length the prompt-lookup drafter matches")
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
    # tensor parallelism across processes: rank 0 serves HTTP and mirrors
    # every dispatch; followers replay the stream on their shard. On one
    # host --tp N starts the followers itself
    serve.add_argument(
        "--followers", type=int, default=0,
        help="leader: number of follower hosts to wait for",
    )
    serve.add_argument(
        "--mirror-port", type=int, default=8477,
        help="leader: port the dispatch mirror listens on",
    )
    serve.add_argument(
        "--follower-of", default=None, metavar="HOST:PORT",
        help="run as a follower replaying the leader's dispatch stream",
    )
    apps = sub.add_parser("apps", help="LangStream application commands")
    apps_sub = apps.add_subparsers(dest="apps_command", required=True)
    run = apps_sub.add_parser("run", help="run an application in this process, with its gateways")
    run.add_argument("app_dir")
    run.add_argument("-i", "--instance", default=None)
    run.add_argument("-s", "--secrets", default=None)
    run.add_argument("--gateway-port", type=int, default=8091)
    run.add_argument("--tenant", default="default")
    run.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run.add_argument("--http-port", type=int, default=-1,
                     help="serve the runner's /info, /metrics, /ready and /debug/profile on this "
                          "port (0 picks a free one; off unless given)")
    broker = sub.add_parser("broker", help="serve a durable tpulog broker")
    broker.add_argument("directory", help="broker data directory")
    broker.add_argument("--host", default="127.0.0.1")
    broker.add_argument("--port", type=int, default=4551, help="0 picks a free one")
    # pod entry points (reference: AgentRunnerStarter.java:39,
    # ApplicationSetupRunner.java:40)
    runner = sub.add_parser("agent-runner", help="run one plan node from a mounted pod config")
    runner.add_argument("--config", required=True, help="path to pod-configuration.json")
    runner.add_argument("--http-port", type=int, default=8080,
                        help="/info, /metrics, /ready, /debug/* port (0 picks a free one)")
    runner.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    setup = sub.add_parser("application-setup",
                           help="create the topics and assets of $LANGSTREAM_APPLICATION")
    setup.add_argument("--delete", action="store_true",
                       help="delete the topics whose deletion-mode is delete instead")
    setup.add_argument("--device", default="cuda", help="the assets' device: cuda or cpu")
    docs = sub.add_parser("docs", help="agent-type documentation")
    docs.add_argument("agent_type", nargs="?", help="show one agent's docs")
    docs.add_argument("--json", action="store_true", help="emit the JSON doc model")
    plugins = sub.add_parser("plugins", help="agent plugin packaging")
    plugins_sub = plugins.add_subparsers(dest="plugins_command", required=True)
    pkg = plugins_sub.add_parser("package", help="zip a plugin dir (the NAR-build equivalent)")
    pkg.add_argument("plugin_dir")
    pkg.add_argument("-o", "--output", default=None)
    plugins_sub.add_parser("list", help="show loaded plugins")
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
            "spec-decode": args.spec_decode,
            "spec-k": args.spec_k,
            "spec-ngram": args.spec_ngram,
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
    if args.tp > 1:
        config["mesh"] = {"tp": args.tp}
    if args.followers or args.follower_of:
        # across hosts the JAX serve turns the supervisor off under the
        # mirror; on one host (--tp) the followers rebuild beside rank 0
        config["engine"]["supervisor"] = False
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


def tp_devices(device: str, world: int) -> List[str]:
    """The device of each rank on this host: card r for rank r (refused
    when the host has fewer cards), or the CPU for every rank."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * world
    cards = torch.cuda.device_count()
    if cards < world:
        raise SystemExit(f"--tp {world} needs {world} cards on this host, it has {cards}")
    return [f"cuda:{rank}" for rank in range(world)]


def _refuse_spec_under_mirror(config: Dict[str, Any]) -> None:
    """The JAX serve's configuration-time guard across hosts: its
    multi-host mirror has no speculative record (the engine's check
    backstops it). On one host (``--tp``) spec decode replays."""
    if str(config.get("engine", {}).get("spec-decode") or "off").lower() != "off":
        raise SystemExit("--spec-decode is not supported with multi-host serving "
                         "(--followers/--follower-of)")


def start_tp_server(
    args: argparse.Namespace, config: Optional[Dict[str, Any]] = None, *,
    devices: Optional[List[str]] = None, timeout_s: float = multihost.DEFAULT_TIMEOUT_S,
    report: Optional[str] = None, **popen,
):
    """``serve --tp N`` on one host: start ranks 1 .. N−1 as followers
    (``devices[r]``, default :func:`tp_devices`), join the group as rank
    0 on ``devices[0]``, build the service from ``config`` (default:
    :func:`serve_config`), wait for the followers to connect to the
    mirror and start the server. Returns (service, server, followers);
    the caller stops the server, then closes the service (which sends the
    followers their ``stop``), then waits for the followers
    (``launch.stop_ranks``). ``report``: a path each follower writes its
    account to at the end, suffixed with its rank."""
    config = config or serve_config(args)
    world = MeshConfig.from_config(config.get("mesh")).tp
    devices = devices or tp_devices(args.device, world)
    if len(devices) != world:
        raise ValueError(f"tp={world} needs {world} devices, got {devices}")
    from langstream_tpu_torch.serving.mirror import DispatchMirror

    mirror = DispatchMirror(host="127.0.0.1", port=args.mirror_port,
                            fingerprint=mirror_fingerprint(config), local=True)
    address = f"127.0.0.1:{multihost.free_port()}"
    payload = {"config": config, "mirror": f"127.0.0.1:{mirror.port}", "report": report}
    followers = launch.spawn_ranks(f"{__name__}:follow", payload, devices, address,
                                   timeout_s=timeout_s, **popen)
    try:
        os.environ.setdefault(launch.GLOO_IFNAME, "lo")  # one host: the loopback
        multihost.initialize_distributed(0, world, address, timeout_s)
        service = TorchCompletionsService(config, device=devices[0])
        mirror.wait_for_followers(world - 1, timeout=timeout_s)
        service.attach_mirror(mirror)
    except BaseException:
        mirror.close()
        for child in followers:
            child.kill()
        raise
    server = OpenAIApiServer(service, None, model=args.model, host=args.host, port=args.port,
                             gauges=engines_snapshot, histograms=engines_histograms)
    server.start()
    return service, server, followers


def follow(rank: int, world: int, device: str, payload: Dict[str, Any]) -> Dict[str, Any]:
    """A follower rank: build the service from the leader's ``config`` on
    ``device`` (this rank's shard), stop its engine thread (the replay
    owns the dispatches), connect to the leader's mirror and replay the
    stream until ``stop``. Prints its account (records, model calls, the
    token digest, its kernels' launches and peak memory) as one JSON line,
    and writes it to ``payload["report"]`` suffixed with the rank."""
    from langstream_tpu_torch.serving.mirror import FollowerExecutor

    config = payload["config"]
    service = TorchCompletionsService(config, device=device)
    service.close()
    # a heal on rank 0 (the supervisor) rebuilds this rank's engine too
    executor = FollowerExecutor(service.engine, rebuild=service.build_engine)
    host, _, port = payload["mirror"].rpartition(":")
    executor.connect(host or "127.0.0.1", int(port), fingerprint=mirror_fingerprint(config))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        from langstream_tpu_torch.ops import launches

        launches.read(reset=True)  # the replay's launches only
    print(f"follower {rank}/{world}: replaying the dispatch stream from {payload['mirror']}",
          flush=True)
    executor.run()
    account = dict(executor.report(), rank=rank,
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30 if cuda else 0.0)
    print(json.dumps({"follower": account}), flush=True)
    if payload.get("report"):
        with open(f"{payload['report']}.{rank}", "w") as out:
            json.dump(account, out)
    return account


def _serve_multihost(args: argparse.Namespace) -> Optional[Tuple[Any, Any]]:
    """Across hosts: join the group from the StatefulSet identity, then
    follow (``--follower-of``; returns None) or lead (``--followers``:
    the service with the mirror attached, and the server)."""
    import torch.distributed as dist

    config = serve_config(args)
    _refuse_spec_under_mirror(config)
    multihost.initialize_multihost()
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.follower_of:
        follow(rank, world, args.device, {"config": config, "mirror": args.follower_of})
        return None
    from langstream_tpu_torch.serving.mirror import DispatchMirror

    mirror = DispatchMirror(host=args.host, port=args.mirror_port,
                            fingerprint=mirror_fingerprint(config))
    service, server = start_server(args, config)
    print(f"mirror: waiting for {args.followers} follower(s) on :{mirror.port}", flush=True)
    mirror.wait_for_followers(args.followers)
    service.attach_mirror(mirror)
    return service, server


async def apps_run(args: argparse.Namespace) -> None:
    """``apps run``: the app and its gateways until SIGINT or SIGTERM, or
    until an agent runner fails (its error propagates)."""
    import signal

    from langstream_tpu_torch.gateway import GatewayServer
    from langstream_tpu_torch.runtime.local import run_application

    runner = await run_application(args.app_dir, instance_file=args.instance,
                                   secrets_file=args.secrets, device=args.device)
    gateway = http = None
    try:
        print(f"application {runner.application.application_id} running on {runner.device}:",
              flush=True)
        for node in runner.plan.agents:
            print(f"  agent {node.id}: {node.input_topic or '(source)'} -> "
                  f"{node.output_topic or '(sink)'}", flush=True)
        if args.http_port >= 0:
            from langstream_tpu_torch.runtime.pod import AgentHttpServer

            http = AgentHttpServer(info=runner.info, metrics=runner.metrics,
                                   gauges=engines_snapshot, histograms=engines_histograms,
                                   port=args.http_port, host="127.0.0.1")
            await http.start()
            http.ready = True
            print(f"metrics on http://{http.host}:{http.port}/metrics", flush=True)
        if runner.application.gateways:
            gateway = GatewayServer(port=args.gateway_port)
            gateway.register_local_runner(runner, tenant=args.tenant)
            await gateway.start()
            print(f"gateway on ws://{gateway.host}:{gateway.port}/v1/...", flush=True)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for signum in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(signum, stop.set)
        join = asyncio.ensure_future(runner.join())
        stopped = asyncio.ensure_future(stop.wait())
        await asyncio.wait([join, stopped], return_when=asyncio.FIRST_COMPLETED)
        stopped.cancel()
        if join.done():
            join.result()
        else:
            join.cancel()
    finally:
        if gateway is not None:
            await gateway.stop()
        if http is not None:
            await http.stop()
        await runner.stop()
        print("application stopped", flush=True)


async def broker_serve(args: argparse.Namespace) -> None:
    """``broker DIR``: the tpulog broker over ``DIR`` until SIGINT or
    SIGTERM; it prints its address and the native log store's library
    (built first, if needed) once it listens."""
    import signal

    from langstream_tpu_torch import native
    from langstream_tpu_torch.topics.log.server import serve

    native.load("logstore")
    server = await serve(args.directory, host=args.host, port=args.port)
    print(f"tpulog broker serving {args.directory} on {server.address} (native log store "
          f"{native.LOADED['logstore']})", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for signum in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(signum, stop.set)
    try:
        await stop.wait()
    finally:
        await server.close()
        server.broker.close()


def docs_command(args: argparse.Namespace) -> None:
    """``docs``: the table of every agent type, one type's properties, or
    the JSON doc model."""
    from langstream_tpu_torch.model.docs import all_docs, generate_docs_model, get_doc

    if args.agent_type:
        doc = get_doc(args.agent_type)
        if doc is None:
            raise SystemExit(f"no documentation for agent type {args.agent_type!r}")
        if args.json:
            print(json.dumps(doc.to_dict(), indent=2))
            return
        print(f"{doc.agent_type} ({doc.category})")
        print(f"  {doc.description}")
        for prop in doc.properties:
            req = " (required)" if prop.required else ""
            default = f" [default: {prop.default}]" if prop.default is not None else ""
            print(f"  - {prop.name}: {prop.type}{req}{default}")
            if prop.description:
                print(f"      {prop.description}")
            if prop.choices:
                print(f"      choices: {', '.join(prop.choices)}")
        return
    if args.json:
        print(json.dumps(generate_docs_model(), indent=2))
        return
    print("agent types (docs <type> for details):")
    for name, doc in sorted(all_docs().items()):
        print(f"  {name:28s} {doc.category:10s} {doc.description}")


def plugins_command(args: argparse.Namespace) -> None:
    """``plugins package``: validate a plugin directory and zip it;
    ``plugins list``: the plugins of ``$LANGSTREAM_PLUGINS_DIR``."""
    import zipfile

    from langstream_tpu_torch.runtime.plugins import load_plugin, load_plugins, loaded_plugins

    if args.plugins_command == "package":
        plugin_dir = args.plugin_dir.rstrip("/")
        load_plugin(plugin_dir)  # a bad manifest fails at build time
        output = args.output or f"{os.path.basename(plugin_dir)}.zip"
        with zipfile.ZipFile(output, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _dirs, files in os.walk(plugin_dir):
                for name in files:
                    if not name.endswith(".pyc"):
                        full = os.path.join(root, name)
                        zf.write(full, os.path.relpath(full, plugin_dir))
        print(f"packaged {plugin_dir} -> {output}")
        return
    if os.environ.get("LANGSTREAM_PLUGINS_DIR"):
        load_plugins(os.environ["LANGSTREAM_PLUGINS_DIR"])
    print(json.dumps(loaded_plugins(), indent=2))


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    if args.command == "apps":
        asyncio.run(apps_run(args))
        return
    if args.command == "broker":
        asyncio.run(broker_serve(args))
        return
    if args.command == "agent-runner":
        from langstream_tpu_torch.runtime.pod import agent_runner_main

        asyncio.run(agent_runner_main(args.config, http_port=args.http_port, device=args.device))
        return
    if args.command == "application-setup":
        from langstream_tpu_torch.runtime.pod import application_setup_main

        asyncio.run(application_setup_main(delete=args.delete, device=args.device))
        return
    if args.command == "docs":
        docs_command(args)
        return
    if args.command == "plugins":
        plugins_command(args)
        return
    if args.command == "journey":
        for line in run_journey(args.paths, trace_id=args.trace_id, slo_ttft_ms=args.slo_ttft_ms,
                                slo_tpot_ms=args.slo_tpot_ms, as_json=args.json,
                                waterfalls=args.top):
            print(line)
        return
    path = start_flight(f"serve-{args.model}")
    if path:
        print(f"flight recorder -> {path}", flush=True)
    followers: List[Any] = []
    if args.followers or args.follower_of:
        started = _serve_multihost(args)
        if started is None:
            return
        service, server = started
    elif args.tp > 1:
        service, server, followers = start_tp_server(args)
    else:
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
        mirror = service.mirror
        if mirror is not None:
            # what the followers' accounts are held against
            print(json.dumps({"mirror": {"published": mirror.published,
                                         "digest": mirror.digest.hexdigest()}}), flush=True)
        launch.stop_ranks(followers)
