"""Streaming HTTP front door for the port's ``serve.Engine``.

``python -m repro_torch.serve.api`` starts the server; the pieces compose
as in the JAX package (``repro/serve/api``)::

    Engine (scheduler.py, its own thread)
      ^ commands / v stream_callback
    Gateway (gateway.py: admission control, cancellation, metrics)
      ^ asyncio queues
    ServeAPI (server.py: /v1/completions SSE + /status, stdlib asyncio)

Every module here is the port's own copy; the wire protocol is the same.
"""

from .gateway import Gateway, QueueFull, StreamHandle
from .server import BackgroundServer, ServeAPI, build_engine

__all__ = [
    "Gateway",
    "QueueFull",
    "StreamHandle",
    "ServeAPI",
    "BackgroundServer",
    "build_engine",
]
