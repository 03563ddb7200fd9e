"""``python -m langstream_tpu_torch serve``: the OpenAI-compatible server
over the port's engine, mirroring ``langstream-tpu serve``."""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, List, Optional, Tuple

from langstream_tpu_torch.providers.torch_local.provider import TorchCompletionsService
from langstream_tpu_torch.serving.openai_api import OpenAIApiServer


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m langstream_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    serve = sub.add_parser("serve", help="OpenAI-compatible HTTP server on the GPU")
    serve.add_argument("--model", default="tiny", help="model preset")
    serve.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    serve.add_argument("--max-slots", type=int, default=8)
    serve.add_argument("--max-seq-len", type=int, default=2048)
    serve.add_argument("--decode-chunk", type=int, default=16)
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
        "--paged-kernel", default="fused", choices=["fused", "reference"],
        help="paged attention: the ragged CUDA kernel over the block tables "
             "(default) or the gather composition in plain PyTorch",
    )
    serve.add_argument("--no-prefix-cache", action="store_true",
                       help="disable prompt-prefix KV reuse (on by default)")
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8000)
    return parser


def serve_config(args: argparse.Namespace) -> Dict[str, Any]:
    """The provider config ``serve`` builds from its flags. Engine keys
    without a flag (``kv-quant``, as in the JAX ``serve``) reach the
    engine through this config, as they do from a deployment's."""
    return {
        "model": {"preset": args.model, "max_seq_len": args.max_seq_len},
        "engine": {
            "max-slots": args.max_slots,
            "max-seq-len": args.max_seq_len,
            "decode-chunk": args.decode_chunk,
            "kv-layout": args.kv_layout,
            "kv-block-size": args.kv_block_size,
            "kv-blocks": args.kv_blocks,
            "paged-kernel": args.paged_kernel,
            "prefix-cache": not args.no_prefix_cache,
        },
    }


def start_server(
    args: argparse.Namespace, config: Optional[Dict[str, Any]] = None
) -> Tuple[TorchCompletionsService, OpenAIApiServer]:
    """Build the service (random weights from seed 0) from ``config``
    (default: :func:`serve_config` of ``args``) and start the server
    thread; the caller owns stopping both."""
    service = TorchCompletionsService(config or serve_config(args), device=args.device)
    server = OpenAIApiServer(service, model=args.model, host=args.host, port=args.port)
    server.start()
    return service, server


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    service, server = start_server(args)
    print(f"serving {args.model} on http://{args.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        service.engine.stop()
