"""``python -m langstream_tpu_torch serve``: the OpenAI-compatible server
over the port's engine, mirroring ``langstream-tpu serve``."""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional, Tuple

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
    serve.add_argument("--host", default="0.0.0.0")
    serve.add_argument("--port", type=int, default=8000)
    return parser


def start_server(args: argparse.Namespace) -> Tuple[TorchCompletionsService, OpenAIApiServer]:
    """Build the service (random weights from seed 0) and start the
    server thread; the caller owns stopping both."""
    config = {
        "model": {"preset": args.model, "max_seq_len": args.max_seq_len},
        "engine": {
            "max-slots": args.max_slots,
            "max-seq-len": args.max_seq_len,
            "decode-chunk": args.decode_chunk,
        },
    }
    service = TorchCompletionsService(config, device=args.device)
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
