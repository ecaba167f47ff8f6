"""Continuous-batching serve engine over the port's ``DecoderLM``.

Counterpart of ``repro/serve/scheduler.py``, step for step.  The ``Engine``
owns a fixed set of steps over static tensors: the chunked-prefill steps
(``prefill.py``), two fused admission finishers (the prompt's final piece,
the first token's argmax, the copy into the slot caches and the slot's
token, position and termination row), and the fused k-step decode over all
slots (``steps.make_decode_multi``, at k=1 and k=``eos_scan_every``).  On
the card each is captured once as a CUDA graph at its first use and then
replayed (``graphs.StepGraphs``, the counterpart of ``jax.jit``); on the
CPU each runs eagerly.

One ``step()``:

  1. *admit*  — while a slot is free and requests wait: match the prompt
     against the prefix index, restore a hit's carry checkpoint and pages
     into the batch-1 cache (or reset it), chunk-prefill the rest of the
     head, then run the fused finisher, which arms the slot's on-device
     termination row (active, EOS id, remaining budget);
  2. *decode* — one fused dispatch advances every slot by a horizon of k
     steps (``_pick_horizon``: k=1 while admissions wait or a deadline is
     near, ``eos_scan_every`` otherwise).  Slots that hit EOS or their
     budget mid-horizon freeze on the device, so outputs are bit-identical
     to k=1.  The (k, max_slots) token block goes into the ``_TokenFlight``
     lane, an async device-to-host copy, and is read only at a finish event,
     an EOS scan or a streaming flush;
  3. *evict*  — finished sequences release their slot and page refs.

Global-attention KV lives in a page pool with per-slot page tables
(``state_cache.PagePool``); admission consults a radix index of cached
prompt prefixes (``state_cache.PrefixIndex``) and on a hit resumes chunked
prefill at the divergence point, so prefill costs O(suffix).

Terminal ``finish_reason``s: ``"length"``, ``"stop"`` (EOS), ``"timeout"``
(``deadline_ms`` passed; partial output kept) and ``"cancelled"``
(``cancel``; ``result`` returns the ``CANCELLED`` sentinel, while an
unknown uid raises ``KeyError``).  ``stream=True`` requests get their first
token at admission, then completed transfer blocks, through
``stream_callback``.  Greedy sampling; token prompts only.

Under a ``mesh`` (``seq_shards``, ``blocks``: JAX's arguments) every step
runs in that engine scope.  Every rank of the mesh's seq group runs the same
Engine on the same requests; a step whose scans are time-sharded (a prefill
chunk of T >= P tokens) holds collectives and runs eagerly, while the steps
whose scans stay local (decode, the tail, T = 1 < P) are CUDA graphs
(``graphs.StepGraphs.captured()`` says which ran which way).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.model import DecoderLM
from . import state_cache
from .graphs import StepGraphs
from .prefill import ChunkedPrefill, upload
from .steps import make_decode_multi


class _Cancelled:
    """Singleton terminal result of a cancelled request."""

    def __repr__(self):
        return "CANCELLED"

    def __bool__(self):
        return False


#: ``Engine.result`` of a cancelled uid: distinct from "never submitted"
#: (``KeyError``) and from an empty generation
CANCELLED = _Cancelled()


@dataclasses.dataclass
class Request:
    """One generation request.

    ``max_new_tokens`` counts every generated token (the first comes from
    the prompt's last logits); ``prompt + max_new_tokens`` must fit the
    engine's ``page_len``.  ``deadline_ms`` bounds the latency from
    ``submit`` (queue wait included): past it the request ends with its
    partial output and ``finish_reason == "timeout"``.  ``stream=True`` opts
    into token flushes through the engine's ``stream_callback``."""

    uid: Any
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    deadline_ms: Optional[float] = None
    stream: bool = False


def _deadline_clock() -> float:
    """The scheduler's only clock read (``time.monotonic``), made only while
    a request with a deadline is live.  Resolves ``time`` from the module's
    globals at call time, so tests can monkeypatch ``scheduler.time``."""
    return time.monotonic()


@dataclasses.dataclass
class _Active:
    request: Request
    slot: int
    first: Any            # first generated token: a device tensor until read
    out: List[int]        # tokens read back to the host
    start_step: int       # engine step index of this request's first decode
    n_decoded: int = 0    # decode tokens produced (incl. not yet in `out`)
    deadline: Optional[float] = None
    n_streamed: int = 0   # tokens already pushed through stream_callback


class _TokenFlight:
    """Double-buffered async device-to-host lane for decode-token blocks.

    ``push`` starts a non-blocking copy of a ``(k, max_slots)`` block into
    pinned host memory and records a CUDA event behind it, so block i
    transfers while block i+1 computes.  ``take(complete_only=True)``, the
    streaming path, reads every block but the newest, and of those only the
    leading ones whose events have completed (it polls ``event.query()``
    and never waits); ``take()``, at finish events, waits for everything in
    flight.  Every device-to-host read of the scheduler goes through here;
    ``n_syncs`` counts the reads (block takes and admission-token scalars).
    On the CPU a block is a copy and is complete at once."""

    def __init__(self):
        self._blocks: List[Any] = []
        self.n_syncs = 0

    def push(self, block: torch.Tensor) -> None:
        if block.is_cuda:
            host = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
            host.copy_(block, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = block.clone(), None
        self._blocks.append((host, event))

    def take(self, complete_only: bool = False) -> Optional[np.ndarray]:
        """Buffered blocks as one ``(rows, max_slots)`` array, oldest first;
        None when nothing qualifies.  One host sync per call."""
        n = len(self._blocks) - (1 if complete_only else 0)
        if complete_only:
            done = 0
            while done < n and (self._blocks[done][1] is None
                                or self._blocks[done][1].query()):
                done += 1
            n = done
        if n <= 0:
            return None
        blocks, self._blocks = self._blocks[:n], self._blocks[n:]
        self.n_syncs += 1
        if blocks[-1][1] is not None:
            blocks[-1][1].synchronize()
        return np.concatenate([h.numpy() for h, _ in blocks], axis=0)

    def scalar(self, x: torch.Tensor) -> int:
        """Read one device scalar (the admission-time first token)."""
        self.n_syncs += 1
        return int(x.item())


class Engine:
    """Continuous-batching engine over a ``DecoderLM``.

    >>> eng = Engine(model, max_slots=4, page_len=128, chunk=16)
    >>> eng.submit(Request(uid="a", prompt=[3, 1, 4], max_new_tokens=8))
    >>> results = eng.run()          # {"a": [8 generated token ids]}

    Arguments are JAX's ``Engine``'s, less ``params`` (the model holds its
    weights).  ``backend``, ``mesh``, ``seq_shards`` and ``blocks`` scope
    every step (``steps._engine_scope``).  Prompts are tokens only: a model
    with a frontend (``cfg.frontend``) raises ``NotImplementedError``, as in
    JAX; ``steps.generate`` serves it with its prefix embeddings."""

    def __init__(
        self,
        model: DecoderLM,
        *,
        max_slots: int = 8,
        page_len: int = 512,
        chunk: int = 64,
        backend: str = "auto",
        mesh=None,
        seq_shards="auto",
        blocks=None,
        eos_scan_every: int = 8,
        stream_callback: Optional[Callable[[Any, List[int], Optional[str]], None]] = None,
        page_size: Optional[int] = None,
        cache_pages: Optional[int] = None,
        prefix_reuse: bool = True,
    ):
        if model.cfg.frontend is not None:
            raise NotImplementedError(
                "serve.Engine handles token prompts only (no frontend "
                "prefix embeddings)")
        if chunk > page_len:
            raise ValueError(f"chunk {chunk} exceeds page_len {page_len}")
        self.model = model
        self.max_slots = max_slots
        self.page_len = page_len
        # page_size defaults to the chunk, so chunk boundaries land on page
        # boundaries: a checkpoint exists at every page edge and a resumed
        # prefill replays the from-scratch chunk schedule bit for bit
        self.page_size = int(page_size if page_size is not None else chunk)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self._max_blocks = -(-page_len // self.page_size)
        self._kv_len = self._max_blocks * self.page_size
        if cache_pages is None:
            # room for ~2 slots' worth of finished prefixes to outlive
            # their slots before LRU eviction starts
            cache_pages = 2 * self._max_blocks
        self._n_pages = max_slots * self._max_blocks + int(cache_pages)
        self.prefix_reuse = bool(prefix_reuse)
        # the largest decode horizon: EOS requests need their tokens on the
        # host at this cadence anyway; k=1 is the single-step engine
        self.eos_scan_every = max(1, eos_scan_every)
        # stream_callback(uid, new_tokens, finish_reason): finish_reason is
        # None mid-stream and set exactly once, on the terminal event
        self.stream_callback = stream_callback

        dev = model.device
        self.graphs = StepGraphs(backend, mesh=mesh, seq_shards=seq_shards, blocks=blocks)
        self._prefill = ChunkedPrefill(model, chunk, graphs=self.graphs)
        self._decode_multi: Dict[int, Callable] = {}
        self._caches = model.init_slot_caches(
            max_slots, page_len, page_size=self.page_size, cache_pages=int(cache_pages))
        self._meta = state_cache.paged_meta(self._caches)
        # the one batch-1 prefill cache the prefill and admission steps run
        # over, reset from a pristine copy (or filled by gather_prefix) at
        # each admission
        self._b1 = model.init_caches(1, self._kv_len)
        self._b1_init = model.init_caches(1, self._kv_len)
        self._alloc = state_cache.SlotAllocator(max_slots)
        self._pool = state_cache.PagePool(self._n_pages)
        self._index = state_cache.PrefixIndex(self._pool, self.page_size)
        self._slot_pages: Dict[int, List[int]] = {}
        self._tokens_saved = 0
        # carry checkpoints taken during the current admission's prefill
        self._captures: Dict[int, Any] = {}
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, _Active] = {}
        # next input token and its absolute position per slot, and the
        # termination state: all on the device, the decode feeds itself
        self._tokens = torch.zeros(max_slots, dtype=torch.long, device=dev)
        self._pos = torch.zeros(max_slots, dtype=torch.long, device=dev)
        self._term = state_cache.init_term_state(max_slots, device=dev)
        # admission finisher inputs: [slot, eos, budget, write pages (mb),
        # table row (mb)], and the final piece (a chunk or the last token),
        # its tokens over its positions
        mb = self._max_blocks
        self._admit_meta = torch.zeros(3 + 2 * mb, dtype=torch.long, device=dev)
        self._piece_chunk = torch.zeros(2, chunk, dtype=torch.long, device=dev)
        self._piece_tail = torch.zeros(2, 1, dtype=torch.long, device=dev)
        self._first = torch.zeros(1, dtype=torch.long, device=dev)
        self._blocks: Dict[int, torch.Tensor] = {}
        self._results: Dict[Any, List[int]] = {}
        self._finish_reason: Dict[Any, str] = {}
        self._cancelled: set = set()
        # live (queued or active) requests with a deadline: the step loop
        # reads the clock only while this is nonzero
        self._n_deadlines = 0
        self._deadline_at: Dict[Any, float] = {}  # queued uids only
        # last sweep-to-sweep step time, kept only while deadlines are live;
        # it feeds the "deadline near" horizon clamp without clock reads
        self._step_est: Optional[float] = None
        self._last_sweep: Optional[float] = None
        # token blocks not yet read, covering engine steps
        # [_pending_base, _step_id)
        self._step_id = 0
        self._flight = _TokenFlight()
        self._pending_base = 0
        self.n_dispatches = 0
        self.n_decode_steps = 0
        self._last_horizon = 0

    # -- bookkeeping --------------------------------------------------------
    @property
    def chunk(self) -> int:
        return self._prefill.chunk

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_waiting(self) -> int:
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._active or self._queue)

    def prefix_stats(self) -> Dict[str, Any]:
        """Prefix-cache and page-pool counters (host-side)."""
        idx, pool = self._index, self._pool
        return {
            "enabled": self.prefix_reuse,
            "lookups": idx.n_lookups,
            "hits": idx.n_hits,
            "hit_rate": idx.n_hits / max(idx.n_lookups, 1),
            "hit_tokens": idx.n_hit_tokens,
            "prefill_tokens_saved": self._tokens_saved,
            "nodes": idx.n_nodes,
            "evicted": idx.n_evicted,
            "page_size": self.page_size,
            "pages": {"total": pool.n_pages, "used": pool.n_used,
                      "free": pool.n_free, "occupancy": pool.n_used / pool.n_pages},
        }

    def decode_stats(self) -> Dict[str, Any]:
        """Fused-decode counters (host-side): dispatches, the token steps
        they covered, and host syncs (block takes and admission scalars)."""
        d, s = self.n_dispatches, self.n_decode_steps
        syncs = self._flight.n_syncs
        return {
            "dispatches": d,
            "decode_steps": s,
            "tokens_per_dispatch": s / max(d, 1),
            "host_syncs": syncs,
            "syncs_per_token": syncs / max(s, 1),
            "horizon_max": self.eos_scan_every,
            "last_horizon": self._last_horizon,
        }

    def result(self, uid) -> List[int]:
        """Generated tokens of a finished request (partial for a timeout),
        ``CANCELLED`` for a cancelled one, ``KeyError`` for an unknown uid."""
        if uid in self._cancelled:
            return CANCELLED
        return self._results[uid]

    def finish_reason(self, uid) -> str:
        """Why a request ended: length | stop | timeout | cancelled
        (``KeyError`` while queued or active, or never submitted)."""
        return self._finish_reason[uid]

    def pop_result(self, uid):
        """``result(uid)`` that also forgets the request."""
        out = self.result(uid)
        self._cancelled.discard(uid)
        self._results.pop(uid, None)
        self._finish_reason.pop(uid, None)
        return out

    # -- request lifecycle ---------------------------------------------------
    def validate(self, request: Request) -> None:
        """Raise ValueError for a request the engine would reject."""
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(request.prompt) < 1:
            raise ValueError("empty prompt: need at least one token")
        total = len(request.prompt) + request.max_new_tokens
        if total > self.page_len:
            raise ValueError(
                f"request {request.uid!r}: prompt + max_new_tokens = {total} "
                f"exceeds page_len {self.page_len}")
        if request.deadline_ms is not None and request.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0 when set")
        uid = request.uid
        if (uid in self._results or uid in self._cancelled
                or any(r.uid == uid for r in self._queue)
                or any(a.request.uid == uid for a in self._active.values())):
            raise ValueError(f"duplicate request uid {uid!r}")

    def submit(self, request: Request) -> None:
        self.validate(request)
        if request.deadline_ms is not None:
            # the bound is stamped at arrival: queue wait counts
            request.deadline_ms = float(request.deadline_ms)
            self._deadline_at[request.uid] = (
                _deadline_clock() + request.deadline_ms / 1e3)
            self._n_deadlines += 1
        self._queue.append(request)

    def cancel(self, uid) -> bool:
        """Cancel a queued or active request; an active one frees its slot at
        once and keeps no output.  False for an unknown or finished uid."""
        for req in self._queue:
            if req.uid == uid:
                self._queue.remove(req)
                self._terminal_deadline(req.uid, req.deadline_ms is not None)
                self._mark_cancelled(req)
                return True
        for slot, act in list(self._active.items()):
            if act.request.uid == uid:
                del self._active[slot]
                self._release_slot(slot)
                self._terminal_deadline(uid, act.deadline is not None)
                self._mark_cancelled(act.request)
                return True
        return False

    def _release_slot(self, slot: int) -> None:
        """Return a slot and its page refs.  The slot's tables go to the
        sentinel first: the dead row keeps decoding, and a stale table would
        write KV into pages the pool may hand to another slot.  Its
        termination row needs no reset: a released slot is frozen already
        (it finished on the device) or is reset by its next admission, and a
        cancelled slot's live row writes only to the trash page."""
        state_cache.clear_slot_pages(self._caches, slot)
        for pg in self._slot_pages.pop(slot, []):
            self._pool.unref(pg)
        self._alloc.release(slot)

    def _mark_cancelled(self, request: Request) -> None:
        self._cancelled.add(request.uid)
        self._finish_reason[request.uid] = "cancelled"
        self._emit(request, [], "cancelled")

    def _terminal_deadline(self, uid, had_deadline: bool) -> None:
        self._deadline_at.pop(uid, None)
        if had_deadline:
            self._n_deadlines -= 1
            if not self._n_deadlines:
                self._last_sweep = self._step_est = None

    def _emit(self, request: Request, toks: List[int], reason: Optional[str]) -> None:
        if self.stream_callback is not None and request.stream:
            self.stream_callback(request.uid, toks, reason)

    def _finish(self, act: _Active, reason: str = "length") -> Any:
        self._results[act.request.uid] = act.out
        self._finish_reason[act.request.uid] = reason
        del self._active[act.slot]
        self._release_slot(act.slot)
        self._terminal_deadline(act.request.uid, act.deadline is not None)
        return act.request.uid

    def _consume(self, arr: np.ndarray) -> None:
        """Fold a ``(rows, max_slots)`` token block read back from the device
        into every active ``out``; rows cover steps ``_pending_base ..``."""
        rows = arr.shape[0]
        for act in self._active.values():
            if not act.out:  # first generated token still on the device
                act.out.append(self._flight.scalar(act.first))
            # a slot frozen on the device repeats its last token past EOS or
            # its budget: `hi` (the budget edge) and the EOS trim in step()
            # drop exactly that overrun
            lo = act.start_step + (len(act.out) - 1) - self._pending_base
            hi = min(act.start_step + act.n_decoded - self._pending_base, rows)
            if hi > lo:
                act.out.extend(int(t) for t in arr[lo:hi, act.slot])
        self._pending_base += rows

    def _flush(self) -> None:
        """Read ALL pending decode outputs into every active ``out``."""
        arr = self._flight.take()
        if arr is None:
            for act in self._active.values():
                if not act.out:
                    act.out.append(self._flight.scalar(act.first))
            return
        self._consume(arr)

    def _flush_stream(self) -> None:
        """Streaming flush: completed transfer blocks only, never waiting."""
        arr = self._flight.take(complete_only=True)
        if arr is not None:
            self._consume(arr)

    # -- admission -----------------------------------------------------------
    def _admit_step(self, inputs: torch.Tensor, b1, slot_caches, meta: torch.Tensor,
                    tokens: torch.Tensor, pos: torch.Tensor, term, first_out) -> None:
        """The fused admission finisher: the prompt's final piece (``inputs``,
        its tokens over its positions, (2, n)) on the batch-1 cache ``b1``,
        the first token's argmax, the copy into the slot caches, and the
        slot's token, position and termination row.  ``meta`` holds [slot,
        eos, budget, write pages, table row]."""
        mb = self._max_blocks
        slot, eos, budget = meta[0:1], meta[1:2], meta[2:3]
        write_pages, table_row = meta[3:3 + mb], meta[3 + mb:]
        if inputs.shape[1] > 1:
            logits, caches = self.model.prefill(inputs[:1], b1, positions=inputs[1:])
        else:
            logits, caches = self.model.decode_step(inputs[:1], b1, inputs[1])
        first = torch.argmax(logits[:, -1, :], dim=-1)
        state_cache.write_slot_paged(slot_caches, caches, slot, write_pages, table_row)
        alive = (budget > 0) & (first != eos)
        term["active"].index_copy_(0, slot, alive)
        term["eos"].index_copy_(0, slot, eos)
        term["remaining"].index_copy_(0, slot, budget)
        tokens.index_copy_(0, slot, first)
        pos.index_copy_(0, slot, inputs[1, -1:] + 1)
        first_out.copy_(first)

    def _snapshot(self, pos: int, caches) -> None:
        self._captures[pos] = state_cache.strip_checkpoint(self._meta, caches)

    def _admit(self) -> List[Any]:
        finished = []
        while self._queue and self._alloc.n_free:
            req = self._queue.popleft()
            deadline = self._deadline_at.pop(req.uid, None)
            if deadline is not None and _deadline_clock() >= deadline:
                # expired while waiting: never admitted, empty output
                self._results[req.uid] = []
                self._finish_reason[req.uid] = "timeout"
                self._n_deadlines -= 1
                self._emit(req, [], "timeout")
                finished.append(req.uid)
                continue
            prompt = np.asarray(req.prompt, np.int64).reshape(-1)
            p = int(prompt.shape[0])
            c = self.chunk
            r = p % c
            ps, mb = self.page_size, self._max_blocks
            sent = self._pool.sentinel
            slot = self._alloc.allocate()
            # the finisher reprocesses the final piece (a full chunk when
            # the length divides, the last token otherwise): a prefix hit
            # stops short of it so its logits are real
            fused_start = p - (1 if r else c)
            hit_blocks, hit_pages, ckpt = 0, [], None
            if self.prefix_reuse:
                hit_blocks, hit_pages, ckpt = self._index.match(
                    prompt.tolist(), fused_start // ps)
                # resume only on chunk-aligned boundaries: the suffix then
                # replays the from-scratch chunk schedule bit for bit
                while hit_blocks and (hit_blocks * ps) % c:
                    hit_blocks -= 1
                hit_pages = hit_pages[:hit_blocks]
            # take the slot's page refs before reserve() can evict the very
            # index nodes this admission hit
            for pg in hit_pages:
                self._pool.ref(pg)
            self._index.reserve(mb - hit_blocks)
            fresh = self._pool.alloc(mb - hit_blocks)
            if fresh is None:  # the pool's sizing makes this unreachable
                raise RuntimeError("page pool exhausted at admission")
            table_row = hit_pages + fresh
            write_row = [sent] * hit_blocks + fresh
            hit_len = hit_blocks * ps
            if hit_len:
                rows = upload(torch.empty(mb, dtype=torch.long, device=self._tokens.device),
                              hit_pages + [sent] * (mb - hit_blocks))
                state_cache.gather_prefix(self._caches, ckpt, rows, out=self._b1)
                self._tokens_saved += hit_len
            else:
                state_cache.assign_caches(self._b1, self._b1_init)
            head = prompt[hit_len:fused_start]
            if head.size:
                self._prefill(head, self._b1, start=hit_len, capture_every=ps,
                              capture=self._snapshot if self.prefix_reuse else None)
            eos = -1 if req.eos_id is None else req.eos_id
            upload(self._admit_meta, [slot, eos, req.max_new_tokens - 1]
                   + write_row + table_row)
            piece = prompt[fused_start:]
            name, inputs = (("admit_tail", self._piece_tail) if r
                            else ("admit_chunk", self._piece_chunk))
            upload(inputs, [piece, np.arange(fused_start, p)])
            self.graphs.run(name, self._admit_step, inputs, self._b1, self._caches,
                            self._admit_meta, self._tokens, self._pos, self._term,
                            self._first)
            first = self._first.clone()
            self._slot_pages[slot] = list(table_row)
            if self.prefix_reuse:
                # publish only blocks covered by full-chunk calls (captured
                # checkpoints): future hits replay the same chunk schedule
                pub_blocks = (hit_len + (head.size // c) * c) // ps
                ckpts = [None] * hit_blocks + [self._captures.get((b + 1) * ps)
                                               for b in range(hit_blocks, pub_blocks)]
                self._index.publish(prompt.tolist(), table_row[:pub_blocks], ckpts)
            self._captures = {}
            act = _Active(request=req, slot=slot, first=first, out=[],
                          start_step=self._step_id, deadline=deadline)
            self._active[slot] = act
            if req.max_new_tokens == 1 or req.eos_id is not None or req.stream:
                # the value is needed now: the request may finish before any
                # decode step, and a stream gets its first token at admission
                act.out.append(self._flight.scalar(first))
                reason = None
                if req.eos_id is not None and act.out[0] == req.eos_id:
                    reason = "stop"
                elif req.max_new_tokens == 1:
                    reason = "length"
                act.n_streamed = len(act.out)
                if req.stream or reason is not None:
                    self._emit(req, list(act.out), reason)
                if reason is not None:
                    finished.append(self._finish(act, reason))
        return finished

    # -- the hot loop --------------------------------------------------------
    def _decode_fn(self, k: int) -> Callable:
        """The fused k-step decode, made once per horizon (the policy only
        ever uses 1 and ``eos_scan_every``) with its static token block."""
        fn = self._decode_multi.get(k)
        if fn is None:
            fn = make_decode_multi(self.model, k)
            self._decode_multi[k] = fn
            self._blocks[k] = torch.zeros(k, self.max_slots, dtype=torch.long,
                                          device=self._tokens.device)
        return fn

    def _pick_horizon(self) -> int:
        """Decode steps to fuse into the next dispatch: 1 while admissions
        wait or a live deadline is within ~2 horizons of the last sweep's
        clock, ``eos_scan_every`` otherwise.  Reads no clock."""
        k_max = self.eos_scan_every
        if k_max == 1 or self._queue:
            return 1
        if self._n_deadlines:
            live = [act.deadline for act in self._active.values()
                    if act.deadline is not None]
            if live:
                if self._step_est is None or self._last_sweep is None:
                    return 1
                slack = min(live) - self._last_sweep
                if slack < 2.0 * k_max * self._step_est:
                    return 1
        return k_max

    @torch.no_grad()
    def step(self) -> List[Any]:
        """Admit waiting requests, advance every slot one decode horizon (k
        fused steps, one dispatch), evict finished sequences.  Returns the
        uids that finished this step."""
        finished = self._admit()
        if not self._active:
            return finished
        k = self._pick_horizon()
        fn = self._decode_fn(k)
        block = self._blocks[k]
        self.graphs.run(f"decode_k{k}", fn, self._tokens, self._caches, self._pos,
                        self._term, block)
        self._flight.push(block)
        self._step_id += k
        self._last_horizon = k
        self.n_dispatches += 1
        self.n_decode_steps += k
        # deadline sweep: the clock is read only while a deadline is live;
        # expiry granularity is one dispatch, and the horizon drops to 1
        # when a deadline gets near
        expired = set()
        if self._n_deadlines:
            now = _deadline_clock()
            if self._last_sweep is not None:
                self._step_est = (now - self._last_sweep) / k
            self._last_sweep = now
            expired = {slot for slot, act in self._active.items()
                       if act.deadline is not None and now >= act.deadline}
        streaming = self.stream_callback is not None and any(
            act.request.stream for act in self._active.values())
        need_full = bool(expired)
        for act in self._active.values():
            # the device freezes a slot at its budget edge: cap the count
            act.n_decoded = min(act.n_decoded + k, act.request.max_new_tokens - 1)
            if 1 + act.n_decoded >= act.request.max_new_tokens:
                need_full = True
            elif (act.request.eos_id is not None
                    and self._step_id - self._pending_base >= self.eos_scan_every):
                need_full = True
        if not (need_full or streaming):
            return finished
        # only tokens this flush reads need EOS scanning (out[0] was checked
        # at admission)
        pre = {slot: len(act.out) for slot, act in self._active.items()}
        if need_full:
            self._flush()
        else:
            self._flush_stream()
        events = []
        for slot in list(self._active):
            act = self._active[slot]
            lo = max(pre[slot], 1)
            eos = act.request.eos_id
            fresh_toks = act.out[lo:]
            reason = None
            if eos is not None and eos in fresh_toks:
                act.out = act.out[:lo + fresh_toks.index(eos) + 1]
                reason = "stop"
            elif len(act.out) >= act.request.max_new_tokens:
                reason = "length"
            elif slot in expired:
                reason = "timeout"   # evicted mid-decode, partial output kept
            if act.request.stream:
                new = act.out[act.n_streamed:]
                act.n_streamed = len(act.out)
                if new or reason is not None:
                    events.append((act.request, new, reason))
            if reason is not None:
                finished.append(self._finish(act, reason))
        # callbacks fire once the engine's own bookkeeping is consistent
        for req, new, reason in events:
            self._emit(req, new, reason)
        return finished

    def run(self, requests: Sequence[Request] = ()) -> Dict[Any, List[int]]:
        """Drive ``step()`` until every submitted request has finished;
        returns (and forgets) their results."""
        for req in requests:
            self.submit(req)
        while self.has_work:
            self.step()
        out, self._results = self._results, {}
        for uid in out:
            self._finish_reason.pop(uid, None)
        return out
