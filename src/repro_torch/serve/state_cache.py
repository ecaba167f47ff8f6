"""Slot-managed decode state for continuous batching (dense part).

The slot caches are ``DecoderLM.init_caches(max_slots, page_len)``: one dict
per layer whose leaves lead with the slot dimension.  A *slot* is one
resident sequence.  A goom-rnn layer's state is its fixed-size (H, hd, 1)
GOOM carry, a Mamba layer's its conv tail and SSM state, whatever the
context length; an attention layer's is its KV row of ``page_len``
positions and the row's index.  Joining and leaving the batch are row
copies.  Counterpart of the dense parts of ``repro/serve/state_cache.py``;
the paged KV pool and the prefix index are not ported.

Unlike their JAX counterparts, ``write_slot`` updates the slot caches in
place (the resident state is never copied whole).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional

import torch

Caches = List[Dict[str, torch.Tensor]]


def write_slot(slot_caches: Caches, src_caches: Caches, slot: int) -> Caches:
    """Copy sequence 0 of a batch-1 cache into row ``slot``, in place."""
    for dst, src in zip(slot_caches, src_caches):
        for k, leaf in dst.items():
            leaf[slot].copy_(src[k][0])
    return slot_caches


def read_slot(slot_caches: Caches, slot: int) -> Caches:
    """Row ``slot`` as a batch-1 cache (a copy: the inverse of write_slot)."""
    return [{k: v[slot:slot + 1].clone() for k, v in layer.items()}
            for layer in slot_caches]


def merge_frozen(new_caches: Caches, old_caches: Caches,
                 active: torch.Tensor) -> Caches:
    """Post-step state for active slots, pre-step state for frozen ones.

    Every leaf leads with the slot dimension, so one broadcast ``where`` per
    leaf keeps a frozen slot bit-identical while the batch decodes."""
    out = []
    for new, old in zip(new_caches, old_caches):
        merged = {}
        for k, v in new.items():
            act = active.reshape((active.shape[0],) + (1,) * (v.ndim - 1))
            merged[k] = torch.where(act, v, old[k])
        out.append(merged)
    return out


class SlotAllocator:
    """Host-side free list over ``max_slots`` cache rows.

    Lowest-numbered free slot first (min-heap); a mirrored in-use set makes
    the double-release check O(1)."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self._free: List[int] = list(range(max_slots))  # already a heap
        self._used: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    def allocate(self) -> Optional[int]:
        """Claim the lowest free slot, or None when the batch is full."""
        if not self._free:
            return None
        slot = heapq.heappop(self._free)
        self._used.add(slot)
        return slot

    def release(self, slot: int) -> None:
        if not (0 <= slot < self.max_slots):
            raise ValueError(f"slot {slot} out of range [0, {self.max_slots})")
        if slot not in self._used:
            raise ValueError(f"slot {slot} is already free (double release)")
        self._used.remove(slot)
        heapq.heappush(self._free, slot)
