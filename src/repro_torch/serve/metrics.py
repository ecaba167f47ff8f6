"""Serving metrics: counters, gauges, and latency percentiles.

The port's own copy of ``repro/serve/metrics.py`` (which imports no JAX):
the port imports nothing of the JAX package.

``ServeMetrics`` is the one mutable stats object the serving stack
shares: the gateway's engine thread records step/admission timings, the
async HTTP handlers record rejections and time-to-first-token, and the
``/status`` endpoint serializes a consistent ``snapshot()``.  Everything
is windowed host-side state — bounded deques and integer counters under
one lock — so recording never touches the device or allocates per event.

Latency percentiles are computed over sliding windows (last ``window``
events) rather than reservoir samples: serving dashboards care about
*recent* tail latency, and the windows are small enough to sort on every
snapshot.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


def percentiles(values, pcts=(50, 90, 99)) -> Dict[str, float]:
    """``{"p50": ..., ...}`` in the values' own unit (empty -> zeros)."""
    out = {}
    vals = sorted(values)
    for p in pcts:
        if not vals:
            out[f"p{p}"] = 0.0
        else:
            idx = min(len(vals) - 1, int(len(vals) * p / 100))
            out[f"p{p}"] = float(vals[idx])
    return out


class ServeMetrics:
    """Thread-safe serving stats: counters + windowed latency percentiles.

    Recorded events:

    * ``record_submitted / record_rejected`` — admission outcomes (a
      rejection is the 429 backpressure path, never seen by the engine);
    * ``record_step(seconds, n_active)`` — one engine decode step;
    * ``record_first_token(seconds)`` — per-request time-to-first-token
      (submit -> first streamed token);
    * ``record_finished(reason, n_tokens, seconds)`` — terminal event
      with the request's total latency; ``reason`` is the engine's
      ``finish_reason`` (length/stop/timeout/cancelled);
    * ``record_prefix_stats(stats)`` — gauge sync of the engine's
      prefix-cache counters (``Engine.prefix_stats()``): hit rate,
      prefill tokens saved, page-pool occupancy;
    * ``record_decode_stats(stats)`` — gauge sync of the engine's
      multi-step decode counters (``Engine.decode_stats()``): dispatches,
      tokens-per-dispatch, host syncs per token.
    """

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self.n_submitted = 0
        self.n_rejected = 0
        self.n_steps = 0
        self.n_tokens = 0
        self.finish_reasons: Dict[str, int] = {}
        self._step_s: deque = deque(maxlen=window)
        self._ttft_s: deque = deque(maxlen=window)
        self._request_s: deque = deque(maxlen=window)
        self._busy_slots = 0  # n_active at the last recorded step
        self._prefix: Optional[dict] = None  # last prefix-cache gauge sync
        self._decode: Optional[dict] = None  # last decode-counters gauge sync

    # -- recording (any thread) --------------------------------------------
    def record_submitted(self) -> None:
        with self._lock:
            self.n_submitted += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.n_rejected += 1

    def record_step(self, seconds: float, n_active: int) -> None:
        with self._lock:
            self.n_steps += 1
            self._step_s.append(seconds)
            self._busy_slots = n_active

    def record_first_token(self, seconds: float) -> None:
        with self._lock:
            self._ttft_s.append(seconds)

    def record_tokens(self, n: int) -> None:
        with self._lock:
            self.n_tokens += n

    def record_finished(self, reason: str, n_tokens: int,
                        seconds: Optional[float] = None) -> None:
        with self._lock:
            self.finish_reasons[reason] = self.finish_reasons.get(reason,
                                                                  0) + 1
            if seconds is not None:
                self._request_s.append(seconds)

    def record_prefix_stats(self, stats: dict) -> None:
        """Sync the engine's prefix-cache counters (gauge overwrite —
        the engine thread pushes its own monotonic totals)."""
        with self._lock:
            self._prefix = dict(stats)

    def record_decode_stats(self, stats: dict) -> None:
        """Sync the engine's multi-step decode counters
        (``Engine.decode_stats()``; gauge overwrite, same pattern as
        :meth:`record_prefix_stats`)."""
        with self._lock:
            self._decode = dict(stats)

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> dict:
        """One consistent stats dict (the ``/status`` payload core)."""
        with self._lock:
            uptime = max(time.monotonic() - self._started, 1e-9)
            n_finished = sum(self.finish_reasons.values())
            prefix = dict(self._prefix) if self._prefix is not None else {
                "enabled": False, "lookups": 0, "hits": 0, "hit_rate": 0.0,
                "hit_tokens": 0, "prefill_tokens_saved": 0, "nodes": 0,
                "evicted": 0, "page_size": 0,
                "pages": {"total": 0, "used": 0, "free": 0, "occupancy": 0.0},
            }
            decode = dict(self._decode) if self._decode is not None else {
                "dispatches": 0, "decode_steps": 0,
                "tokens_per_dispatch": 0.0, "host_syncs": 0,
                "syncs_per_token": 0.0, "horizon_max": 0, "last_horizon": 0,
            }
            return {
                "uptime_s": uptime,
                "requests": {
                    "submitted": self.n_submitted,
                    "finished": n_finished,
                    "rejected": self.n_rejected,
                    "by_finish_reason": dict(self.finish_reasons),
                },
                "throughput": {
                    "tokens_total": self.n_tokens,
                    "tokens_per_s": self.n_tokens / uptime,
                    "requests_per_s": n_finished / uptime,
                    "steps_total": self.n_steps,
                },
                "latency_ms": {
                    "decode_step": percentiles(
                        [s * 1e3 for s in self._step_s]),
                    "ttft": percentiles([s * 1e3 for s in self._ttft_s]),
                    "request": percentiles(
                        [s * 1e3 for s in self._request_s]),
                },
                "busy_slots": self._busy_slots,
                "prefix_cache": prefix,
                "decode": decode,
            }
