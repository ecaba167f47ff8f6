"""Minimal blocking HTTP client for the serve API (stdlib sockets).

The port's own copy of ``repro/serve/api/client.py``.

Tests, benchmarks, and the example drive the server through this module
so there is exactly one client-side implementation of the wire protocol
(and no ``requests``/``httpx`` dependency in tier-1).  Thread-per-client
concurrency is the intended usage — the server side is async, the client
side stays simple.
"""

from __future__ import annotations

import json
import socket
from typing import Iterator, Optional, Tuple

from . import sse


class RetryLater(Exception):
    """Server answered 429: back off ``retry_after`` seconds."""

    def __init__(self, retry_after: float, message: str = ""):
        self.retry_after = retry_after
        super().__init__(message or f"429: retry after {retry_after}s")


class APIError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(f"HTTP {status}: {message}")


def _connect(host: str, port: int, timeout: float) -> socket.socket:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(timeout)
    return sock


def _send(sock: socket.socket, method: str, path: str,
          payload: Optional[dict]) -> None:
    body = json.dumps(payload).encode() if payload is not None else b""
    head = (f"{method} {path} HTTP/1.1\r\n"
            f"Host: serve\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n")
    sock.sendall(head.encode() + body)


def _read_head(rfile) -> Tuple[int, dict]:
    status_line = rfile.readline().decode("latin-1")
    if not status_line:
        raise ConnectionError("empty response")
    status = int(status_line.split()[1])
    headers = {}
    while True:
        line = rfile.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers


def _raise_for_status(status: int, headers: dict, body: bytes) -> None:
    if status == 429:
        raise RetryLater(float(headers.get("retry-after", 1)),
                         body.decode("utf-8", "replace"))
    if status != 200:
        raise APIError(status, body.decode("utf-8", "replace"))


def request_json(host: str, port: int, method: str, path: str,
                 payload: Optional[dict] = None,
                 timeout: float = 60.0) -> dict:
    """One non-streaming exchange; parsed JSON body (raises on non-200)."""
    sock = _connect(host, port, timeout)
    try:
        _send(sock, method, path, payload)
        rfile = sock.makefile("rb")
        status, headers = _read_head(rfile)
        body = rfile.read(int(headers.get("content-length", 0) or 0))
        _raise_for_status(status, headers, body)
        return json.loads(body)
    finally:
        sock.close()


def get_status(host: str, port: int, timeout: float = 10.0) -> dict:
    return request_json(host, port, "GET", "/status", timeout=timeout)


def completion(host: str, port: int, payload: dict,
               timeout: float = 300.0) -> dict:
    """Non-streaming ``/v1/completions`` call."""
    payload = dict(payload, stream=False)
    return request_json(host, port, "POST", "/v1/completions", payload,
                        timeout=timeout)


def stream_completion(host: str, port: int, payload: dict,
                      timeout: float = 300.0) -> Iterator[dict]:
    """Streaming ``/v1/completions``: yields one parsed event dict per
    SSE chunk until ``[DONE]``.

    Closing the generator mid-stream (``gen.close()``) closes the socket
    — the client-disconnect path the server must answer with slot
    eviction.
    """
    sock = _connect(host, port, timeout)
    try:
        _send(sock, "POST", "/v1/completions", dict(payload, stream=True))
        rfile = sock.makefile("rb")
        status, headers = _read_head(rfile)
        if status != 200:
            body = rfile.read(int(headers.get("content-length", 0) or 0))
            _raise_for_status(status, headers, body)
        dec = sse.SSEDecoder()
        while True:
            data = rfile.read1(65536)
            if not data:
                return
            for payload_str in dec.feed(data):
                if payload_str == sse.DONE_PAYLOAD:
                    return
                yield json.loads(payload_str)
    finally:
        sock.close()
