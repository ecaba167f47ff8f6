"""Request gateway: async HTTP handlers <-> the synchronous Engine loop.

The port's own copy of ``repro/serve/api/gateway.py``.  The engine thread
is the only thread that touches the card: it captures and replays the
engine's CUDA graphs.

The ``Engine`` is single-threaded by design (one hot decode graph,
host-side slot bookkeeping).  The gateway gives it a production face:

* a dedicated **engine thread** runs the step loop and is the *only*
  thread that touches the engine.  Handlers talk to it through a
  command queue (``submit`` / ``cancel``) that is drained before every
  step — so a client disconnect evicts its slot within one step;
* per-request **token streams**: the engine's ``stream_callback`` fires
  on the engine thread and forwards ``(tokens, finish_reason)`` batches
  into an ``asyncio.Queue`` on the handler's loop
  (``call_soon_threadsafe`` — the only cross-thread hop per flush);
* **admission control**: a bounded waiting-queue watermark.  Past it,
  ``submit`` raises ``QueueFull`` carrying a ``retry_after`` estimate
  (queue depth x recent request latency / slots) and the server answers
  429 + ``Retry-After`` without the engine ever seeing the request.
"""

from __future__ import annotations

import asyncio
import itertools
import queue
import threading
import time
import traceback
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from ..metrics import ServeMetrics
from ..scheduler import Engine, Request


class QueueFull(Exception):
    """Admission rejected: the waiting queue is past the watermark."""

    def __init__(self, depth: int, retry_after: float):
        self.depth = depth
        self.retry_after = max(1, int(round(retry_after)))
        super().__init__(
            f"admission queue full ({depth} waiting); "
            f"retry after ~{self.retry_after}s")


class _StreamState:
    __slots__ = ("queue", "loop", "submitted_at", "first_token_at")

    def __init__(self, q: asyncio.Queue, loop: asyncio.AbstractEventLoop,
                 submitted_at: float):
        self.queue = q
        self.loop = loop
        self.submitted_at = submitted_at
        self.first_token_at: Optional[float] = None


class StreamHandle:
    """Consumer end of one request's token stream."""

    def __init__(self, uid, gateway: "Gateway", q: asyncio.Queue):
        self.uid = uid
        self._gateway = gateway
        self._queue = q
        self.finish_reason: Optional[str] = None

    async def events(self) -> AsyncIterator[Tuple[List[int], Optional[str]]]:
        """Yield ``(new_tokens, finish_reason)`` batches; the terminal
        batch (and only it) carries a non-None reason."""
        while True:
            toks, reason = await self._queue.get()
            yield toks, reason
            if reason is not None:
                self.finish_reason = reason
                return

    async def next_batch(self) -> Tuple[List[int], Optional[str]]:
        """One ``(new_tokens, finish_reason)`` batch (server hot path —
        awaitable alongside a disconnect watchdog)."""
        toks, reason = await self._queue.get()
        if reason is not None:
            self.finish_reason = reason
        return toks, reason

    async def collect(self) -> Tuple[List[int], str]:
        """Drain the stream into ``(all_tokens, finish_reason)``."""
        out: List[int] = []
        async for toks, reason in self.events():
            out.extend(toks)
        return out, self.finish_reason

    def cancel(self) -> None:
        self._gateway.cancel(self.uid)


class Gateway:
    """Bridge between async request handlers and one ``Engine``.

    ``max_queue`` is the admission watermark over ``engine.n_waiting``
    plus not-yet-drained submit commands.  ``max_slots`` requests decode
    concurrently regardless; the watermark only bounds *waiting* work.
    """

    def __init__(self, engine: Engine, *, max_queue: int = 32,
                 metrics: Optional[ServeMetrics] = None,
                 idle_poll_s: float = 0.02):
        self.engine = engine
        self.max_queue = max_queue
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._idle_poll_s = idle_poll_s
        self._cmds: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        self._pending_submits = 0  # submit cmds not yet applied (lock-free: GIL int ops)
        self._streams: Dict[Any, _StreamState] = {}
        self._lock = threading.Lock()
        self._uids = itertools.count()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        engine.stream_callback = self._on_stream
        # seed the prefix-cache and decode gauges so /status has them
        # before the first step (and when prefix reuse is disabled)
        self.metrics.record_prefix_stats(engine.prefix_stats())
        self.metrics.record_decode_stats(engine.decode_stats())

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Gateway":
        self._thread = threading.Thread(target=self._run,
                                        name="serve-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._cmds.put(("wake", None))
        if self._thread is not None:
            self._thread.join(timeout=30)
        self._fail_all("cancelled")

    # -- admission (handler side) -------------------------------------------
    def queue_depth(self) -> int:
        return self._pending_submits + self.engine.n_waiting

    def _retry_after(self, depth: int) -> float:
        p50_ms = self.metrics.snapshot()["latency_ms"]["request"]["p50"]
        per_req = (p50_ms / 1e3) if p50_ms > 0 else 1.0
        waves = max(1.0, depth / max(1, self.engine.max_slots))
        return min(30.0, max(1.0, waves * per_req))

    async def submit(self, *, prompt, max_new_tokens: int,
                     eos_id: Optional[int] = None,
                     deadline_ms: Optional[float] = None) -> StreamHandle:
        """Validate, admission-check, and hand a request to the engine
        thread.  Raises ValueError (bad request) or QueueFull (429)."""
        uid = f"cmpl-{next(self._uids)}"
        req = Request(uid=uid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      deadline_ms=deadline_ms, stream=True)
        self.engine.validate(req)  # ValueError -> 400, engine never sees it
        depth = self.queue_depth()
        if depth >= self.max_queue:
            self.metrics.record_rejected()
            raise QueueFull(depth, self._retry_after(depth))
        q: asyncio.Queue = asyncio.Queue()
        state = _StreamState(q, asyncio.get_running_loop(), time.monotonic())
        with self._lock:
            self._streams[uid] = state
        self.metrics.record_submitted()
        self._pending_submits += 1
        self._cmds.put(("submit", req))
        return StreamHandle(uid, self, q)

    def cancel(self, uid) -> None:
        """Thread-safe: enqueue a cancel, applied before the next step."""
        self._cmds.put(("cancel", uid))

    # -- engine thread --------------------------------------------------------
    def _run(self) -> None:
        eng = self.engine
        while not self._stop.is_set():
            self._drain_cmds(block=not eng.has_work)
            if self._stop.is_set():
                return
            if not eng.has_work:
                continue
            try:
                # one step() is one fused decode dispatch (an adaptive
                # horizon of up to eos_scan_every tokens): commands were
                # drained above, so a submit that arrives now waits at
                # most one horizon before the engine sees its queue
                # non-empty and drops back to k=1 dispatches
                t0 = time.perf_counter()
                eng.step()
                self.metrics.record_step(time.perf_counter() - t0,
                                         eng.n_active)
                # engine-thread-only counters, synced as gauges for /status
                self.metrics.record_prefix_stats(eng.prefix_stats())
                self.metrics.record_decode_stats(eng.decode_stats())
            except Exception:
                traceback.print_exc()
                self._fail_all("error")
                return

    def _drain_cmds(self, block: bool) -> None:
        first = True
        while True:
            try:
                kind, payload = self._cmds.get(
                    block=block and first, timeout=self._idle_poll_s)
            except queue.Empty:
                return
            first = False
            if kind == "submit":
                self._pending_submits -= 1
                try:
                    self.engine.submit(payload)
                except Exception:  # validated already; belt and braces
                    traceback.print_exc()
                    self._push(payload.uid, [], "error")
            elif kind == "cancel":
                self.engine.cancel(payload)  # emits the terminal callback

    # -- stream plumbing (engine thread -> handler loops) ---------------------
    def _on_stream(self, uid, toks: List[int],
                   reason: Optional[str]) -> None:
        now = time.monotonic()
        with self._lock:
            state = self._streams.get(uid)
            if state is not None and reason is not None:
                del self._streams[uid]
        if toks:
            self.metrics.record_tokens(len(toks))
        if state is None:
            return
        if toks and state.first_token_at is None:
            state.first_token_at = now
            self.metrics.record_first_token(now - state.submitted_at)
        if reason is not None:
            self.metrics.record_finished(reason, len(toks),
                                         now - state.submitted_at)
            try:
                self.engine.pop_result(uid)  # keep the engine's maps bounded
            except KeyError:
                pass  # "error" terminal: the engine never owned this uid
        try:
            state.loop.call_soon_threadsafe(
                state.queue.put_nowait, (list(toks), reason))
        except RuntimeError:
            pass  # handler's loop is gone (client vanished mid-teardown)

    def _push(self, uid, toks, reason) -> None:
        self._on_stream(uid, toks, reason)

    def _fail_all(self, reason: str) -> None:
        with self._lock:
            uids = list(self._streams)
        for uid in uids:
            state = None
            with self._lock:
                state = self._streams.pop(uid, None)
            if state is None:
                continue
            try:
                state.loop.call_soon_threadsafe(
                    state.queue.put_nowait, ([], reason))
            except RuntimeError:
                pass
