"""Continuous-batching serve engine over the port's ``DecoderLM``.

Counterpart of ``repro/serve/scheduler.py``, single-step and dense: KV sits
in dense per-slot rows of ``page_len`` positions (JAX's
``init_slot_caches(page_size=None)`` layout), which computes what JAX's paged
pool computes.  Each slot's next position rides beside its next token.  One
``step()``:

  1. *admit*  — while a slot is free and requests wait: chunked-prefill the
     prompt's head into a fresh batch-1 cache, run its final piece (the last
     token, or the last full chunk when the length divides) to get the first
     token, and copy the state into the slot.  This is the JAX engine's
     admission schedule exactly: chunking sets the scan's reassociation, so
     another schedule would give other numbers;
  2. *decode* — one ``model.decode_step`` over all slots; ``merge_frozen``
     keeps free and finished rows bit-identical;
  3. *evict*  — sequences that hit EOS or their token budget free their
     slot for the next admission.

Greedy sampling.  Not ported yet: the fused multi-step horizon, the async
token lane, streaming, deadlines, cancel, prefix reuse, the paged KV pool
and the HTTP front door.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import torch

from ..models.model import DecoderLM
from .prefill import ChunkedPrefill
from .state_cache import SlotAllocator, merge_frozen, write_slot


@dataclasses.dataclass
class Request:
    """One generation request.

    ``max_new_tokens`` counts every generated token (the first comes from
    the prompt's last logits).  ``prompt + max_new_tokens`` must fit the
    engine's ``page_len``."""

    uid: Any
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None


@dataclasses.dataclass
class _Active:
    request: Request
    slot: int
    out: List[int]


class Engine:
    """Continuous-batching engine over a ``DecoderLM``.

    >>> eng = Engine(model, max_slots=4, page_len=128, chunk=16)
    >>> eng.submit(Request(uid="a", prompt=[3, 1, 4], max_new_tokens=8))
    >>> results = eng.run()          # {"a": [8 generated token ids]}
    """

    def __init__(self, model: DecoderLM, *, max_slots: int = 8,
                 page_len: int = 512, chunk: int = 64):
        if chunk > page_len:
            raise ValueError(f"chunk {chunk} exceeds page_len {page_len}")
        self.model = model
        self.max_slots = max_slots
        self.page_len = page_len
        self._prefill = ChunkedPrefill(model, chunk)
        self._alloc = SlotAllocator(max_slots)
        dev = model.device
        self._caches = model.init_caches(max_slots, page_len)
        # next input token and its absolute position per slot, and which
        # slots advance on a step: all on the device, the decode feeds itself
        self._tokens = torch.zeros(max_slots, dtype=torch.long, device=dev)
        self._pos = torch.zeros(max_slots, dtype=torch.long, device=dev)
        self._live = torch.zeros(max_slots, dtype=torch.bool, device=dev)
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, _Active] = {}
        self._results: Dict[Any, List[int]] = {}
        self._finish_reason: Dict[Any, str] = {}
        self.n_decode_steps = 0

    # -- bookkeeping --------------------------------------------------------
    @property
    def chunk(self) -> int:
        return self._prefill.chunk

    @property
    def n_waiting(self) -> int:
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._active or self._queue)

    def result(self, uid) -> List[int]:
        """Generated tokens of a finished request (KeyError otherwise)."""
        return self._results[uid]

    def finish_reason(self, uid) -> str:
        """Why a request terminated: ``length`` (budget) or ``stop`` (EOS);
        KeyError while it is queued or active, or was never submitted."""
        return self._finish_reason[uid]

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
        uid = request.uid
        if (uid in self._results or any(r.uid == uid for r in self._queue)
                or any(a.request.uid == uid for a in self._active.values())):
            raise ValueError(f"duplicate request uid {uid!r}")

    def submit(self, request: Request) -> None:
        self.validate(request)
        self._queue.append(request)

    def _finish(self, act: _Active, reason: str) -> Any:
        uid = act.request.uid
        self._results[uid] = act.out
        self._finish_reason[uid] = reason
        self._active.pop(act.slot, None)
        self._live[act.slot] = False
        self._alloc.release(act.slot)
        return uid

    @staticmethod
    def _reason(act: _Active) -> Optional[str]:
        req = act.request
        if req.eos_id is not None and act.out[-1] == req.eos_id:
            return "stop"
        if len(act.out) >= req.max_new_tokens:
            return "length"
        return None

    def _admit(self) -> List[Any]:
        finished = []
        model, dev = self.model, self.model.device
        while self._queue and self._alloc.n_free:
            req = self._queue.popleft()
            prompt = [int(t) for t in req.prompt]
            p, c = len(prompt), self.chunk
            slot = self._alloc.allocate()
            # the final piece is a full chunk when the length divides, the
            # last token otherwise; the head before it is chunk-prefilled
            fused_start = p - (1 if p % c else c)
            caches = model.init_caches(1, self.page_len)
            if fused_start:
                _, caches = self._prefill(prompt[:fused_start], caches)
            last = torch.tensor([prompt[fused_start:]], dtype=torch.long,
                                device=dev)
            at = torch.arange(fused_start, p, device=dev)
            if p % c:
                logits, caches = model.decode_step(last, caches, at)
            else:
                logits, caches = model.prefill(last, caches, positions=at[None])
            first = torch.argmax(logits[:, -1, :], dim=-1)[0]
            write_slot(self._caches, caches, slot)
            self._tokens[slot] = first
            self._pos[slot] = p
            act = _Active(request=req, slot=slot, out=[int(first)])
            self._active[slot] = act
            reason = self._reason(act)
            if reason is None:
                self._live[slot] = True
            else:
                finished.append(self._finish(act, reason))
        return finished

    # -- the hot loop --------------------------------------------------------
    @torch.no_grad()
    def step(self) -> List[Any]:
        """Admit waiting requests, advance every live slot one token, evict
        finished sequences.  Returns the uids that finished this step."""
        finished = self._admit()
        if not self._active:
            return finished
        logits, stepped = self.model.decode_step(self._tokens[:, None],
                                                 self._caches, self._pos)
        self._caches = merge_frozen(stepped, self._caches, self._live)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        self._tokens = torch.where(self._live, nxt, self._tokens)
        self._pos = torch.where(self._live, self._pos + 1, self._pos)
        self.n_decode_steps += 1
        toks = self._tokens.tolist()  # the step's one host sync
        for slot, act in list(self._active.items()):
            act.out.append(toks[slot])
            reason = self._reason(act)
            if reason is not None:
                finished.append(self._finish(act, reason))
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
