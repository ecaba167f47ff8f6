"""Slot-managed decode state for continuous batching, with a paged KV pool
and cross-request prefix reuse.

Counterpart of ``repro/serve/state_cache.py``.  The slot caches are
``DecoderLM.init_slot_caches(max_slots, page_len, page_size=ps)``: one dict
per layer whose recurrent leaves lead with the slot dimension, while an
attention layer keeps its KV in a shared page pool of ``(n_pages + 1, ps,
kvh, hd)`` pages with a per-slot ``(max_slots, max_blocks)`` page table.  A
*slot* is one resident sequence; a *page* is ``ps`` tokens of one layer's
KV, shareable between slots that decode from a common prompt prefix.  A
goom-rnn layer's state is its fixed-size GOOM carry, a Mamba layer's its
conv tail and SSM state, an RWKV6 layer's its token-shift rows and WKV
state, and a windowed attention layer's its dense rolling buffer of
``min(page_len, window)`` rows, whatever the context length: a prefix
checkpoint holds them whole and restores them exactly.  A model with no
global attention layer (rwkv6, mixtral) pages nothing and reuses prefixes
through checkpoints alone.

Device-side tree ops.  Page id ``n_pages`` is the sentinel, as in JAX; JAX
drops scatters through it and clamps gathers, while here it is a real trash
page that takes those writes and serves those reads (masked or zeroed):

  * ``write_slot_paged`` — copy a prefilled batch-1 cache into row ``slot``:
    recurrent leaves by row, KV blocks into the pages named by
    ``write_pages`` (sentinel entries go to the trash page: shared prefix
    pages are never rewritten), and the slot's page table set;
  * ``gather_prefix`` — a dense batch-1 prefill cache from a carry
    checkpoint and pool pages (the prefix-hit resume path);
  * ``strip_checkpoint`` — a batch-1 cache minus its paged KV: the carries
    and attention indexes captured at page boundaries during prefill;
  * ``clear_slot_pages`` — a released slot's tables back to the sentinel;
  * ``init_term_state`` / ``mask_frozen_pages`` / ``merge_frozen`` — the
    on-device termination state of multi-step decode;
  * ``write_slot`` / ``read_slot`` — dense row copy and gather (``read_slot``
    also densifies paged layers).

Unlike their JAX counterparts, the writers update the slot caches in place
(the resident state is never copied whole), and ``assign_caches`` copies a
step's results back into static tensors, which a replayed CUDA graph needs.

Host-side bookkeeping (allocation is control flow, not device work):
``SlotAllocator`` (free list over slot rows), ``PagePool`` (refcounted free
list over pages) and ``PrefixIndex`` (a radix trie over ``page_size``-token
blocks mapping prompt prefixes to (page, carry checkpoint), with leaf-first
LRU eviction).
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

Caches = List[Dict[str, torch.Tensor]]
Slot = Union[int, torch.Tensor]


def _is_paged(layer: Dict[str, Any]) -> bool:
    return "pages" in layer


def slot_cache_bytes(model, max_slots: int, page_len: int, **kw) -> dict:
    """Byte cost of a serving config, from ``device="meta"`` shapes.

    Returns ``{"total", "per_slot", "kv_pages", "recurrent"}`` (bytes):
    ``kv_pages`` counts the attention K/V leaves (dense rows, rolling
    buffers or pool pages, the trash page included), ``recurrent``
    everything else.  Extra
    ``init_slot_caches`` kwargs (``page_size``, ``cache_pages``) pass
    through."""
    caches = model.init_slot_caches(max_slots, page_len, device="meta", **kw)
    kv = rec = 0
    for blk, layer in zip(model.cfg.layer_list, caches):
        for key, leaf in layer.items():
            nbytes = leaf.numel() * leaf.element_size()
            if blk.mixer == "attention" and key in ("k", "v"):
                kv += nbytes
            else:
                rec += nbytes
    total = kv + rec
    return {"total": total, "per_slot": total // max(max_slots, 1),
            "kv_pages": kv, "recurrent": rec}


def paged_meta(caches: Caches) -> List[Optional[str]]:
    """Per layer, ``"paged"`` where the slot caches keep KV in the pool, else
    None: the skeleton that lets walkers over *dense* batch-1 caches (which
    carry no ``pages``) tell the paged layers apart."""
    return ["paged" if _is_paged(layer) else None for layer in caches]


def _slot_index(slot: Slot, device) -> torch.Tensor:
    return torch.as_tensor(slot, dtype=torch.long, device=device).reshape(1)


def write_slot(slot_caches: Caches, src_caches: Caches, slot: int) -> Caches:
    """Copy sequence 0 of a batch-1 cache into row ``slot``, in place (dense
    slot caches only; the engine's paged path is :func:`write_slot_paged`)."""
    for dst, src in zip(slot_caches, src_caches):
        for k, leaf in dst.items():
            leaf[slot].copy_(src[k][0])
    return slot_caches


def write_slot_paged(slot_caches: Caches, src_caches: Caches, slot: Slot,
                     write_pages: torch.Tensor, table_row: torch.Tensor) -> Caches:
    """Copy a batch-1 cache into row ``slot`` of paged slot caches, in place.

    ``write_pages``/``table_row`` are ``(max_blocks,)`` page ids shared by
    every paged layer: block b of the dense cache's K/V goes to page
    ``write_pages[b]`` (the sentinel sends it to the trash page: shared
    prefix pages already hold the same bits and other slots read them), and
    the slot's table entry b becomes ``table_row[b]``.  Every other leaf is
    copied by row.  ``slot`` may be an int or a device tensor (a replayed
    graph reads it from a static buffer)."""
    for dst, src in zip(slot_caches, src_caches):
        idx = _slot_index(slot, next(iter(dst.values())).device)
        if _is_paged(dst):
            ps, mb = dst["k"].shape[1], dst["pages"].shape[1]
            for key in ("k", "v"):
                blocks = src[key][0].reshape((mb, ps) + src[key].shape[2:])
                dst[key].index_copy_(0, write_pages, blocks.to(dst[key].dtype))
            dst["pages"].index_copy_(0, idx, table_row.reshape(1, -1))
            dst["index"].index_copy_(0, idx, src["index"][:1])
            continue
        for key, leaf in dst.items():
            leaf.index_copy_(0, idx, src[key][:1].to(leaf.dtype))
    return slot_caches


def _densify(layer: Dict[str, torch.Tensor], rows: torch.Tensor, key: str) -> torch.Tensor:
    """Pool pages ``rows`` as one dense (1, L, KVH, D) row; sentinel entries
    (the trash page) read as exact zeros."""
    pool = layer[key]
    ok = (rows < pool.shape[0] - 1)[:, None, None, None]
    return torch.where(ok, pool[rows], 0).reshape((1, -1) + pool.shape[2:])


def read_slot(slot_caches: Caches, slot: int) -> Caches:
    """Row ``slot`` as a batch-1 cache (a copy: the inverse of the writes).
    Paged layers are densified through the slot's page table."""
    out = []
    for layer in slot_caches:
        if _is_paged(layer):
            rows = layer["pages"][slot]
            out.append({"k": _densify(layer, rows, "k"), "v": _densify(layer, rows, "v"),
                        "index": layer["index"][slot:slot + 1].clone()})
        else:
            out.append({k: v[slot:slot + 1].clone() for k, v in layer.items()})
    return out


def strip_checkpoint(meta: Sequence[Optional[str]], caches: Caches) -> Caches:
    """A batch-1 prefill cache minus its paged K/V: the carry checkpoint.

    Keeps (as copies) every fixed-size leaf, the GOOM and Mamba states and
    the attention indexes, and drops the K/V of the layers ``meta`` marks
    paged, whose blocks live in the pool."""
    return [{"index": layer["index"].clone()} if m == "paged"
            else {k: v.clone() for k, v in layer.items()}
            for m, layer in zip(meta, caches)]


def gather_prefix(slot_caches: Caches, ckpt: Caches, rows: torch.Tensor,
                  out: Optional[Caches] = None) -> Caches:
    """A dense batch-1 prefill cache from checkpoint + pool pages.

    ``rows`` is one ``(max_blocks,)`` page-id vector (the matched prefix
    blocks, sentinel past the hit): paged layers gather those pages into
    dense K/V, sentinel entries as exact zeros (a fresh cache's bits), and
    every other leaf comes from the checkpoint (whose attention ``index`` is
    the hit length).  With ``out`` the result is written into that cache in
    place and returned."""
    got = []
    for sc, ck in zip(slot_caches, ckpt):
        if _is_paged(sc):
            got.append({"k": _densify(sc, rows, "k"), "v": _densify(sc, rows, "v"),
                        "index": ck["index"]})
        else:
            got.append(ck)
    if out is None:
        return [{k: v.clone() for k, v in layer.items()} for layer in got]
    assign_caches(out, got)
    return out


def clear_slot_pages(slot_caches: Caches, slot: int) -> Caches:
    """Point row ``slot``'s page tables at the sentinel, in place.

    A released slot keeps decoding dead weight (static shapes); with its
    table on the sentinel those KV writes land in the trash page, so pages
    freed to the pool, maybe reassigned or held by the prefix index, are
    never written."""
    for layer in slot_caches:
        if _is_paged(layer):
            layer["pages"][slot] = layer["k"].shape[0] - 1
    return slot_caches


# ---------------------------------------------------------------------------
# on-device termination state (multi-step decode)
# ---------------------------------------------------------------------------
def init_term_state(max_slots: int, *, device=None) -> Dict[str, torch.Tensor]:
    """Per-slot termination state carried on the device by the fused decode.

    ``active`` (bool): the slot still produces tokens; a frozen slot's
    token, position and caches stop advancing on the device.  ``eos``: the
    slot's stop token or -1 (no token id is negative).  ``remaining``:
    decode steps left in its budget (``max_new_tokens - 1``: the first token
    comes from admission).  All slots start frozen; admission arms a row."""
    return {"active": torch.zeros(max_slots, dtype=torch.bool, device=device),
            "eos": torch.full((max_slots,), -1, dtype=torch.long, device=device),
            "remaining": torch.zeros(max_slots, dtype=torch.long, device=device)}


def mask_frozen_pages(caches: Caches, active: torch.Tensor) -> Caches:
    """Frozen slots' page tables pointed at the sentinel for one step.

    The paged decode then writes a frozen slot's K/V into the trash page, so
    the pages it holds stay bit-identical while the batch decodes; its reads
    come from the trash page too, garbage that :func:`merge_frozen`
    discards.  Only the table is replaced (a new tensor); every other leaf
    is the caller's."""
    out = []
    for layer in caches:
        if _is_paged(layer):
            sentinel = layer["k"].shape[0] - 1
            layer = dict(layer, pages=torch.where(active[:, None], layer["pages"],
                                                  sentinel))
        out.append(layer)
    return out


def merge_frozen(new_caches: Caches, old_caches: Caches,
                 active: torch.Tensor) -> Caches:
    """Post-step state for active slots, pre-step state for frozen ones.

    Paged layers keep the stepped pool (frozen slots wrote only to the trash
    page), take the real tables from ``old`` (the stepped ones are masked)
    and revert ``index`` for frozen rows.  Every other leaf leads with the
    slot dimension and merges with one broadcast ``where``."""
    out = []
    for new, old in zip(new_caches, old_caches):
        if _is_paged(new):
            out.append(dict(new, pages=old["pages"],
                            index=torch.where(active, new["index"], old["index"])))
            continue
        merged = {}
        for k, v in new.items():
            act = active.reshape((active.shape[0],) + (1,) * (v.ndim - 1))
            merged[k] = torch.where(act, v, old[k])
        out.append(merged)
    return out


def assign_caches(dst: Caches, src: Caches) -> Caches:
    """Copy ``src``'s leaves into ``dst``'s tensors in place (a leaf that
    already is ``dst``'s tensor is left alone): a step's results back into
    the static tensors a replayed graph reads."""
    for d_layer, s_layer in zip(dst, src):
        for k, d in d_layer.items():
            s = s_layer[k]
            if s is not d:
                d.copy_(s)
    return dst


# ---------------------------------------------------------------------------
# host-side allocators
# ---------------------------------------------------------------------------
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

    @property
    def n_used(self) -> int:
        return len(self._used)

    def in_use(self, slot: int) -> bool:
        return slot in self._used

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


class PagePool:
    """Refcounted host-side free list over the KV page pool.

    One page id addresses the same page of every paged layer's pool.  A
    page's holders are each slot whose table references it and the prefix
    index node that published it; it returns to the free list only when the
    last holder unrefs, and a double free raises.  Lowest id first."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_pages = n_pages
        self.sentinel = n_pages          # the trash page's id
        self._free: List[int] = list(range(n_pages))  # already a heap
        self._rc: List[int] = [0] * n_pages

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` pages (refcount 1 each), or None if short: all or
        nothing, so a failed admission leaks nothing."""
        if n > len(self._free):
            return None
        pages = [heapq.heappop(self._free) for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def ref(self, page: int) -> None:
        if not (0 <= page < self.n_pages) or self._rc[page] < 1:
            raise ValueError(f"ref of unallocated page {page}")
        self._rc[page] += 1

    def unref(self, page: int) -> bool:
        """Drop one reference; True when this freed the page."""
        if not (0 <= page < self.n_pages) or self._rc[page] < 1:
            raise ValueError(f"unref of free page {page} (double free)")
        self._rc[page] -= 1
        if self._rc[page] == 0:
            heapq.heappush(self._free, page)
            return True
        return False


class _PrefixNode:
    __slots__ = ("key", "parent", "children", "page", "ckpt", "tick")

    def __init__(self, key, parent, page, ckpt, tick):
        self.key = key                   # tuple of page_size token ids
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.page = page                 # pool page id (one index ref held)
        self.ckpt = ckpt                 # carry checkpoint at this block's end
        self.tick = tick                 # LRU clock


class PrefixIndex:
    """Host-side radix trie over token blocks: prompt prefix -> cache.

    One trie level per KV page of ``page_size`` tokens; each node owns one
    pool page (a ``PagePool`` reference) and the carry checkpoint taken at
    its block's end during chunked prefill.  ``match`` walks the longest
    indexed block-prefix of a prompt; ``publish`` inserts a request's
    freshly prefilled blocks.  Eviction is leaf-first LRU and drops only the
    index's reference, so pages live slots hold stay allocated; repeated
    eviction can always drain the index."""

    def __init__(self, pool: PagePool, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.pool = pool
        self.page_size = page_size
        self._root = _PrefixNode((), None, None, None, 0)
        self._tick = 0
        self.n_nodes = 0
        self.n_lookups = 0
        self.n_hits = 0
        self.n_hit_tokens = 0
        self.n_evicted = 0

    def match(self, tokens: Sequence[int], max_blocks: Optional[int] = None):
        """``(hit_blocks, page_ids, ckpt)``: the longest indexed block-prefix
        of ``tokens`` (at most ``max_blocks`` blocks), its pages, and the
        checkpoint at its end (None on a miss).  Matched nodes are
        LRU-touched; the caller takes its own page refs before anything can
        evict."""
        self.n_lookups += 1
        self._tick += 1
        ps = self.page_size
        limit = len(tokens) // ps
        if max_blocks is not None:
            limit = min(limit, max_blocks)
        node, pages, ckpt = self._root, [], None
        for b in range(limit):
            child = node.children.get(tuple(tokens[b * ps:(b + 1) * ps]))
            if child is None:
                break
            child.tick = self._tick
            pages.append(child.page)
            ckpt = child.ckpt
            node = child
        if pages:
            self.n_hits += 1
            self.n_hit_tokens += len(pages) * ps
        return len(pages), pages, ckpt

    def publish(self, tokens: Sequence[int], pages: Sequence[int],
                ckpts: Sequence[Any]) -> int:
        """Insert blocks ``0..len(pages)`` of ``tokens``; ``ckpts[b]`` is the
        checkpoint at ``(b+1) * page_size``, None for a block whose node must
        already exist.  A new node takes one pool ref on its page; existing
        nodes are touched.  Stops at the first gap; returns the nodes made."""
        self._tick += 1
        ps = self.page_size
        node, created = self._root, 0
        for b, (page, ckpt) in enumerate(zip(pages, ckpts)):
            key = tuple(tokens[b * ps:(b + 1) * ps])
            child = node.children.get(key)
            if child is None:
                if ckpt is None:
                    break
                child = _PrefixNode(key, node, page, ckpt, self._tick)
                node.children[key] = child
                self.pool.ref(page)
                self.n_nodes += 1
                created += 1
            else:
                child.tick = self._tick
            node = child
        return created

    def _leaves(self) -> List[_PrefixNode]:
        out, stack = [], list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                out.append(node)
        return out

    def evict_one(self) -> bool:
        """Drop the least-recently-used leaf (its index reference only);
        False when the trie is empty."""
        leaves = self._leaves()
        if not leaves:
            return False
        victim = min(leaves, key=lambda n: n.tick)
        del victim.parent.children[victim.key]
        self.pool.unref(victim.page)
        self.n_nodes -= 1
        self.n_evicted += 1
        return True

    def reserve(self, n: int) -> bool:
        """Evict until the pool can serve ``n`` pages (True on success)."""
        while self.pool.n_free < n:
            if not self.evict_one():
                return False
        return True

    def clear(self) -> None:
        while self.evict_one():
            pass
