"""The WebSocket/HTTP gateway of the port — the user-facing ingress to an
app's topics (``server.py``), on the port's own RFC 6455 code
(``websocket.py``)."""

from langstream_tpu_torch.gateway.server import GatewayServer

__all__ = ["GatewayServer"]
