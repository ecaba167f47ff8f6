"""Asyncio HTTP front door for the continuous-batching Engine.

The port's own copy of ``repro/serve/api/server.py``; ``build_engine``
builds the port's model on ``device`` (the card unless told otherwise).

Stdlib only (``asyncio.start_server`` + hand-rolled HTTP/1.1): tier-1
carries no web-framework dependency.  Endpoints:

* ``POST /v1/completions`` — OpenAI-completions shaped.  Body fields:
  ``prompt`` (list of token ids — the repo has no tokenizer),
  ``max_tokens``, ``stream`` (SSE token-by-token when true), ``eos_id``,
  ``deadline_ms``.  Backpressure: 429 + ``Retry-After`` once the
  gateway's waiting queue passes its watermark.
* ``GET /status`` — engine gauges (slot occupancy, queue depth) +
  ``ServeMetrics`` counters/latency percentiles as JSON.
* ``GET /healthz`` — liveness.

Every connection is ``Connection: close`` (one exchange per socket):
serving correctness here hinges on the *scheduler's* lifecycle, not on
connection reuse, and close-delimited SSE streams need no chunked
framing.  Mid-stream disconnects are detected by an EOF watchdog on the
request socket and cancel the request — the gateway applies the cancel
before the engine's next step, so the slot frees within one step.
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Optional, Tuple

from . import sse
from .gateway import Gateway, QueueFull, StreamHandle

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 408: "Request Timeout",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error",
}
_MAX_BODY = 1 << 20          # 1 MiB: far above any real token-id prompt
_MAX_HEADER_LINES = 100

SSE_HEADERS = (b"HTTP/1.1 200 OK\r\n"
               b"Content-Type: text/event-stream\r\n"
               b"Cache-Control: no-cache\r\n"
               b"Connection: close\r\n\r\n")


def _response(status: int, payload, *, extra_headers=()) -> bytes:
    body = json.dumps(payload).encode() if not isinstance(payload, bytes) \
        else payload
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
             "Content-Type: application/json",
             f"Content-Length: {len(body)}",
             "Connection: close"]
    lines += [f"{k}: {v}" for k, v in extra_headers]
    return ("\r\n".join(lines) + "\r\n\r\n").encode() + body


def _error(status: int, message: str, *, extra_headers=()) -> bytes:
    return _response(status, {"error": {"message": message,
                                        "code": status}},
                     extra_headers=extra_headers)


async def _read_request(reader) -> Optional[Tuple[str, str, dict, bytes]]:
    """Parse one request; None on EOF/garbage, ValueError on oversize."""
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3:
        return None
    method, path, _ = parts
    headers = {}
    for _ in range(_MAX_HEADER_LINES):
        hline = await reader.readline()
        if hline in (b"\r\n", b"\n", b""):
            break
        name, _, value = hline.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    length = int(headers.get("content-length", 0) or 0)
    if length > _MAX_BODY:
        raise ValueError(f"body of {length} bytes exceeds {_MAX_BODY}")
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


class ServeAPI:
    """The HTTP server; one instance fronts one ``Gateway``/``Engine``."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0):
        self.gateway = gateway
        self.host = host
        self.port = port          # 0 -> ephemeral; real port set by start()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "ServeAPI":
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    # -- connection handling -------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                parsed = await _read_request(reader)
            except ValueError as e:
                writer.write(_error(413, str(e)))
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if parsed is None:
                return
            method, path, headers, body = parsed
            if path == "/v1/completions":
                if method != "POST":
                    writer.write(_error(405, "use POST"))
                    return
                await self._completions(body, reader, writer)
            elif path == "/status":
                if method != "GET":
                    writer.write(_error(405, "use GET"))
                    return
                writer.write(_response(200, self.status()))
            elif path == "/healthz":
                writer.write(_response(200, {"ok": True}))
            else:
                writer.write(_error(404, f"no route {path}"))
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                await writer.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, asyncio.CancelledError):
                pass

    def status(self) -> dict:
        eng = self.gateway.engine
        snap = self.gateway.metrics.snapshot()
        # live read, like the engine gauges below: the metrics copy is
        # synced after each step, which can lag the terminal stream event
        # a fast client reacts to (pure-python counters; GIL-safe)
        snap["prefix_cache"] = eng.prefix_stats()
        snap["decode"] = eng.decode_stats()
        snap["engine"] = {
            "max_slots": eng.max_slots,
            "n_active": eng.n_active,
            "n_waiting": eng.n_waiting,
            "slot_occupancy": eng.n_active / max(1, eng.max_slots),
            "queue_depth": self.gateway.queue_depth(),
            "queue_limit": self.gateway.max_queue,
            "page_len": eng.page_len,
            "page_size": eng.page_size,
            "prefix_reuse": eng.prefix_reuse,
        }
        return snap

    # -- /v1/completions -----------------------------------------------------
    async def _completions(self, body: bytes, reader, writer) -> None:
        try:
            req = json.loads(body.decode("utf-8"))
            prompt = [int(t) for t in req["prompt"]]
            max_tokens = int(req.get("max_tokens", 16))
            stream = bool(req.get("stream", False))
            eos_id = req.get("eos_id")
            eos_id = int(eos_id) if eos_id is not None else None
            deadline_ms = req.get("deadline_ms")
            deadline_ms = float(deadline_ms) if deadline_ms is not None \
                else None
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            writer.write(_error(400, f"malformed request: {e}"))
            return
        try:
            handle = await self.gateway.submit(
                prompt=prompt, max_new_tokens=max_tokens, eos_id=eos_id,
                deadline_ms=deadline_ms)
        except QueueFull as e:
            writer.write(_error(
                429, str(e),
                extra_headers=[("Retry-After", str(e.retry_after))]))
            return
        except ValueError as e:
            writer.write(_error(400, str(e)))
            return
        if stream:
            await self._stream_sse(handle, reader, writer)
        else:
            toks, reason = await handle.collect()
            writer.write(_response(200, {
                "id": handle.uid,
                "object": "text_completion",
                "choices": [{
                    "index": 0,
                    "tokens": toks,
                    "text": " ".join(str(t) for t in toks),
                    "finish_reason": reason,
                }],
                "usage": {"prompt_tokens": len(prompt),
                          "completion_tokens": len(toks),
                          "total_tokens": len(prompt) + len(toks)},
            }))

    async def _stream_sse(self, handle: StreamHandle, reader,
                          writer) -> None:
        writer.write(SSE_HEADERS)
        await writer.drain()
        # EOF watchdog: nothing more arrives on a well-formed completions
        # socket, so any read completion means the client hung up
        watchdog = asyncio.create_task(reader.read(1 << 16))
        batch = asyncio.create_task(handle.next_batch())
        idx = 0
        try:
            while True:
                done, _ = await asyncio.wait(
                    {batch, watchdog},
                    return_when=asyncio.FIRST_COMPLETED)
                if watchdog in done and batch not in done:
                    handle.cancel()   # applied before the engine's next step
                    batch.cancel()
                    return
                toks, reason = batch.result()
                for i, tok in enumerate(toks):
                    fin = reason if i == len(toks) - 1 else None
                    writer.write(sse.encode_event(sse.completion_chunk(
                        handle.uid, tok, idx, fin)))
                    idx += 1
                if reason is not None and not toks:
                    writer.write(sse.encode_event(sse.completion_chunk(
                        handle.uid, None, idx, reason)))
                try:
                    await writer.drain()
                except ConnectionError:
                    handle.cancel()
                    return
                if reason is not None:
                    writer.write(sse.DONE_EVENT)
                    return
                batch = asyncio.create_task(handle.next_batch())
        finally:
            watchdog.cancel()
            if not batch.done():
                batch.cancel()


class BackgroundServer:
    """Gateway + ServeAPI on a daemon thread with its own event loop.

    The in-process deployment used by tests, benchmarks, and the example
    client: ``BackgroundServer(gateway).start()`` binds an ephemeral
    port (``.port``), ``stop()`` tears down the loop and the engine
    thread.  Production entry is ``python -m repro.serve.api`` instead.
    """

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0):
        self.gateway = gateway
        self.host = host
        self.port = port
        self.api: Optional[ServeAPI] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._ready = threading.Event()
        self._stopper: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "BackgroundServer":
        self.gateway.start()
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._main()),
            name="serve-api", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=30):
            raise RuntimeError("server failed to start within 30s")
        return self

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stopper = asyncio.Event()
        self.api = ServeAPI(self.gateway, self.host, self.port)
        await self.api.start()
        self.port = self.api.port
        self._ready.set()
        await self._stopper.wait()
        await self.api.stop()

    def stop(self) -> None:
        if self._loop is not None and self._stopper is not None:
            self._loop.call_soon_threadsafe(self._stopper.set)
        if self._thread is not None:
            self._thread.join(timeout=30)
        self.gateway.stop()


def build_engine(arch: str = "goom-rnn-124m", *, smoke: bool = True,
                 max_slots: int = 4, page_len: int = 128, chunk: int = 16,
                 backend: str = "auto", seed: int = 0,
                 prefix_reuse: bool = True, device=None, **engine_kw):
    """Construct a model with seeded random weights and an Engine for it.

    The demo and test entry; a deployment hands its own ``Engine`` to
    ``Gateway``.  ``device`` defaults to ``cuda`` (the port's entry points
    run on the card unless the caller asks for the CPU).  ``arch`` is any
    registered architecture (``configs.list_archs()``); the default is
    goom-rnn-124m, the paper's model."""
    import torch

    from ...configs import get_config
    from ...kernels.dispatch import resolve_device
    from ...models.model import DecoderLM
    from ..scheduler import Engine

    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = DecoderLM(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    eng = Engine(model, max_slots=max_slots, page_len=page_len, chunk=chunk,
                 backend=backend, prefix_reuse=prefix_reuse, **engine_kw)
    return eng, cfg
