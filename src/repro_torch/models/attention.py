"""Attention: causal GQA with RoPE over a dense, a rolling or a paged KV
cache.

Counterpart of ``repro/models/attention.py``: q/k/v biases (``qkv_bias``),
q/k RMSNorms over the head dim (``qk_norm``; plain RMS whatever the
block's norm), ``query_scale``, partial rotary (``rotary_fraction``),
M-RoPE (``mrope_sections``: q and k rotate by three position streams,
``mrope_positions`` (3, B, S), each stream ``positions`` when none are
given) and sliding windows.  Four paths, each the JAX package's arithmetic:

  * no cache: causal (and windowed) self-attention over the sequence
    (``flash_attention``, which for one KV block is this masked softmax),
    or, for a windowed layer with ``use_banded`` and at least two windows
    of sequence, the two-block band (:func:`banded_attention`);
  * a cache and S > 1: chunked prefill (``_prefill_attention``).  Global:
    the chunk's K/V are written into the cache at the row's ``index`` and
    the chunk attends over everything cached so far.  Windowed: the cache
    is a rolling buffer of ``min(max_len, window)`` rows; the chunk attends
    over [buffer ; chunk] (each buffer row at the absolute position it
    holds, the chunk's own K/V unrounded), then the chunk is written at
    ``(start + i) % length``, or, when its tail fills the buffer, rolled in
    so that position p sits in row p % length;
  * a cache and S == 1: decode (``_decode_attention``): each row writes at
    its own ``index`` (``index % length`` in a rolling buffer) and attends
    over its cache row (positions in ``(index - window, index]``);
  * a paged cache (one with ``pages``) and S == 1: decode against the
    shared page pool (``_paged_decode_attention``, see
    :func:`init_paged_cache`); global layers only.

Scores and the softmax are f32; ``p`` is cast to the value dtype before
the product and the sum is divided out after the f32 accumulation.  The KV
cache is bf16 whatever the compute dtype, as the JAX package stores it.
These are plain tensor ops: the JAX package leaves attention to XLA, no
Pallas kernel, so the port has no kernel here either.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import AttentionCfg
from ..sharding.rules import constrain
from .common import Dense
from .norms import RMSNorm
from .rope import apply_mrope, apply_rope

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
            scale: float, *, fill: float, p_dtype: torch.dtype) -> torch.Tensor:
    """Masked softmax attention, GQA by head groups.

    q (B, Sq, H, D); k, v (B, Sk, KVH, D); ``valid`` broadcasts to (B, Sq, Sk).
    Masked scores become ``fill``; ``p`` is rounded to ``p_dtype`` before the
    product.  Returns (B, Sq, H, D) in f32."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.float().reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, k.float()) * scale
    s = s.masked_fill(~valid[:, :, None, None, :], fill)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)   # max-rescaled softmax; goomcheck: disable=GC202
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p.to(p_dtype).float(), v.float())
    return (acc / l).reshape(b, sq, h, d)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     positions: torch.Tensor, window: int, scale: float) -> torch.Tensor:
    """Exact sliding-window attention by two-block bands (Longformer-style),
    ``repro/models/attention.py::banded_attention``: q (B, S, H, D), k and v
    (B, S, KVH, D) at ``positions`` (S,).

    The sequence is cut into blocks of W = ``window`` (padded at positions
    of -2^30, which no query sees) and block i attends to blocks i-1 and i
    under the causal and window mask: O(S·2W) scores instead of O(S²).  The
    scores and the softmax are f32; a row with no valid key keeps a maximum
    of 0 and a sum floored at 1e-30; ``p`` is cast to the value dtype before
    the f32-accumulated product.  Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    w = window
    nb = -(-s // w)
    pad = nb * w - s
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        positions = torch.nn.functional.pad(positions, (0, pad), value=-(2 ** 30))
    qb = q.reshape(b, nb, w, kvh, h // kvh, d)
    kb = k.reshape(b, nb, w, kvh, d)
    vb = v.reshape(b, nb, w, kvh, d)
    pos_b = positions.reshape(nb, w)

    # pair each block with its predecessor (block -1: zeros, fully masked)
    k_pair = torch.cat([torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], kb], 2)
    v_pair = torch.cat([torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, 0, 1, 0))[:, :-1], vb], 2)
    pos_prev = torch.nn.functional.pad(pos_b, (0, 0, 1, 0), value=-(2 ** 30))[:-1]
    pos_pair = torch.cat([pos_prev, pos_b], 1)                       # (nb, 2W)

    scores = torch.einsum("bnqhgd,bnkhd->bnqhgk", qb.float(), k_pair.float()) * scale
    mask = ((pos_pair[:, None, :] <= pos_b[:, :, None])
            & (pos_pair[:, None, :] > pos_b[:, :, None] - w))        # (nb, W, 2W)
    scores = scores.masked_fill(~mask[None, :, :, None, None, :], -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)   # max-rescaled softmax; goomcheck: disable=GC202
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bnqhgk,bnkhd->bnqhgd", (p / l).to(v_pair.dtype).float(),
                       v_pair.float())
    return out.reshape(b, nb * w, h, d)[:, :s].to(q.dtype)


def _ring_positions(last: torch.Tensor, length: int) -> torch.Tensor:
    """Absolute position each row of a rolling buffer of ``length`` rows
    holds once position ``last`` (any shape) is written: the latest position
    <= ``last`` with that residue.  Shape ``last.shape + (length,)``;
    negative where the row was never written."""
    slots = torch.arange(length, device=last.device)
    last = last[..., None]
    return last - (last - slots) % length


class Attention(nn.Module):
    """One attention mixer; parameter names follow the JAX param tree
    (``q.w`` (d, H, hd), ``k.w``/``v.w`` (d, KVH, hd), ``o.w`` (H, hd, d);
    with ``qkv_bias`` also ``q.b``, ``k.b``, ``v.b``; with ``qk_norm``
    ``q_norm.scale`` and ``k_norm.scale``)."""

    def __init__(self, cfg: AttentionCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.n_heads % cfg.n_kv_heads:
            raise ValueError(f"{cfg.n_heads} heads do not group over "
                             f"{cfg.n_kv_heads} KV heads")
        self.cfg = cfg
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q = Dense(d, (h, hd), bias=cfg.qkv_bias, in_axis="qkv_embed",
                       out_axes=("heads", "head_dim"), **kw)
        self.k = Dense(d, (kvh, hd), bias=cfg.qkv_bias, in_axis="qkv_embed",
                       out_axes=("kv_heads", "head_dim"), **kw)
        self.v = Dense(d, (kvh, hd), bias=cfg.qkv_bias, in_axis="qkv_embed",
                       out_axes=("kv_heads", "head_dim"), **kw)
        self.o = Dense(h, (hd, d), std=(h * hd) ** -0.5, in_axis="heads",
                       out_axes=("head_dim", "embed"), **kw)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device=device, dtype=dtype)
            self.k_norm = RMSNorm(hd, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                mrope_positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, d) at absolute ``positions`` (B, S), and for M-RoPE at
        ``mrope_positions`` (3, B, S) → (y (B, S, d), new cache or None)."""
        cfg, cd = self.cfg, compute_dtype
        b, s, _ = x.shape
        scale = cfg.query_scale if cfg.query_scale is not None else cfg.head_dim ** -0.5
        q = self.q(x, compute_dtype=cd)
        k = self.k(x, compute_dtype=cd)
        v = self.v(x, compute_dtype=cd)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if cfg.mrope_sections is not None:
            pos3 = (mrope_positions if mrope_positions is not None
                    else positions.expand((3,) + positions.shape))
            q = apply_mrope(q, pos3, theta=cfg.rope_theta, sections=cfg.mrope_sections)
            k = apply_mrope(k, pos3, theta=cfg.rope_theta, sections=cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, theta=cfg.rope_theta,
                           rotary_fraction=cfg.rotary_fraction)
            k = apply_rope(k, positions, theta=cfg.rope_theta,
                           rotary_fraction=cfg.rotary_fraction)

        q = constrain(q, "batch", "act_seq", "act_heads", None)
        k = constrain(k, "batch", "act_seq", "act_kv_heads", None)
        v = constrain(v, "batch", "act_seq", "act_kv_heads", None)
        new_cache = None
        if cache is None:
            pos = positions[0]
            if cfg.use_banded and cfg.window is not None and 2 * cfg.window <= s:
                out = banded_attention(q, k, v, positions=pos, window=cfg.window,
                                       scale=scale)
            else:
                out = _attend(q, k, v, self._mask(pos, pos)[None], scale,
                              fill=-torch.inf, p_dtype=cd)
        elif "pages" in cache:
            if s != 1:
                raise ValueError("a paged KV cache takes one token per row")
            out, new_cache = self._paged_decode(q, k, v, cache, scale)
        elif s > 1 and cfg.window is not None:
            out, new_cache = self._prefill_window(q, k, v, cache, positions, scale)
        elif s > 1:
            out, new_cache = self._prefill(q, k, v, cache, positions, scale)
        else:
            out, new_cache = self._decode(q, k, v, cache, scale)
        out = constrain(out.to(cd), "batch", "act_seq", "act_heads", None).reshape(b, s, -1)
        y = out @ self.o.w.to(cd).reshape(-1, cfg.d_model)
        return y, new_cache

    def _mask(self, q_pos: torch.Tensor, kv_pos: torch.Tensor) -> torch.Tensor:
        """(Sq, Sk) causal mask, also windowed when the layer is."""
        m = kv_pos[None, :] <= q_pos[:, None]
        if self.cfg.window is not None:
            m = m & (kv_pos[None, :] > q_pos[:, None] - self.cfg.window)
        return m

    @staticmethod
    def _prefill(q, k_new, v_new, cache: Cache, positions, scale):
        """One prompt chunk from row 0's ``index`` (a prefill batch shares
        its positions): write the chunk's K/V there, attend over the cache up
        to the chunk's last position."""
        b, s = q.shape[:2]
        length = cache["k"].shape[1]
        slots = torch.arange(length, device=q.device)
        start = cache["index"][0]
        at = start + torch.arange(s, device=q.device)
        k = cache["k"].index_copy(1, at, k_new.to(cache["k"].dtype))
        v = cache["v"].index_copy(1, at, v_new.to(cache["v"].dtype))
        kv_pos = torch.where(slots <= start + (s - 1), slots, 2 ** 30)
        valid = (kv_pos[None, :] <= positions[0][:, None])[None]
        out = _attend(q, k.to(q.dtype), v.to(q.dtype), valid, scale,
                      fill=-torch.inf, p_dtype=q.dtype)
        return out, {"k": k, "v": v, "index": cache["index"] + s}

    def _prefill_window(self, q, k_new, v_new, cache: Cache, positions, scale):
        """One prompt chunk against a rolling buffer, from row 0's
        ``index``: attend over [buffer ; chunk] (a buffer row at the absolute
        position it holds, 2**30 where never written), then write the chunk
        into the buffer."""
        s = q.shape[1]
        length = cache["k"].shape[1]
        start = cache["index"][0]
        abs_prev = _ring_positions(start - 1, length)
        kv_pos = torch.where(abs_prev >= 0, abs_prev, 2 ** 30)
        k_cat = torch.cat([cache["k"].to(q.dtype), k_new], dim=1)
        v_cat = torch.cat([cache["v"].to(q.dtype), v_new], dim=1)
        pos = positions[0]
        valid = self._mask(pos, torch.cat([kv_pos, pos]))[None]
        out = _attend(q, k_cat, v_cat, valid, scale, fill=-torch.inf, p_dtype=q.dtype)
        dt = cache["k"].dtype
        if s >= length:
            # the chunk's tail fills the buffer: position p goes to row p % length
            shift = (start + s - length) % length
            k = _roll_rows(k_new[:, s - length:], shift).to(dt)
            v = _roll_rows(v_new[:, s - length:], shift).to(dt)
        else:
            at = (start + torch.arange(s, device=q.device)) % length
            k = cache["k"].index_copy(1, at, k_new.to(dt))
            v = cache["v"].index_copy(1, at, v_new.to(dt))
        return out, {"k": k, "v": v, "index": cache["index"] + s}

    def _decode(self, q, k_new, v_new, cache: Cache, scale):
        """One token per row, written at the row's own ``index`` (a write
        past the end of a global row is dropped; a rolling buffer writes at
        ``index % length``), attending over the row's valid positions."""
        b = q.shape[0]
        length = cache["k"].shape[1]
        index = cache["index"]
        rows = torch.arange(b, device=q.device)
        window = self.cfg.window
        k, v = cache["k"].clone(), cache["v"].clone()
        if window is None:
            at = index.clamp(max=length - 1)
            keep = (index < length)[:, None, None]
            k[rows, at] = torch.where(keep, k_new[:, 0].to(k.dtype), k[rows, at])
            v[rows, at] = torch.where(keep, v_new[:, 0].to(v.dtype), v[rows, at])
            slots = torch.arange(length, device=q.device)
            valid = slots[None, :] <= index[:, None]
        else:
            at = index % length
            k[rows, at] = k_new[:, 0].to(k.dtype)
            v[rows, at] = v_new[:, 0].to(v.dtype)
            abs_pos = _ring_positions(index, length)
            valid = (abs_pos >= 0) & (abs_pos > index[:, None] - window)
        out = _attend(q, k, v, valid[:, None, :], scale, fill=NEG_INF, p_dtype=v.dtype)
        return out, {"k": k, "v": v, "index": index + 1}

    @staticmethod
    def _paged_decode(q, k_new, v_new, cache: Cache, scale):
        """One token per row against the page pool: write the new K/V at
        ``(pages[row, index // ps], index % ps)``, then gather each row's
        pages into a dense (B, L, KVH, D) view and attend over positions
        up to ``index``.

        Unlike the JAX package's functional update, the write lands in the
        pool in place (the returned ``k``/``v`` are the pool itself).  A
        row whose table holds the trash page id (a cleared or frozen slot)
        writes into the trash page and reads it back; the validity mask
        gives every position past ``index`` exactly zero probability, so a
        live row's output is the dense path's."""
        b = q.shape[0]
        pool_k, pool_v, pages = cache["k"], cache["v"], cache["pages"]
        ps, mb = pool_k.shape[1], pages.shape[1]
        length = mb * ps
        index = cache["index"]
        rows = torch.arange(b, device=q.device)
        page = pages[rows, (index // ps).clamp(max=mb - 1)]
        at = (page, index % ps)
        pool_k.index_put_(at, k_new[:, 0].to(pool_k.dtype))
        pool_v.index_put_(at, v_new[:, 0].to(pool_v.dtype))
        kg = pool_k[pages].reshape((b, length) + pool_k.shape[2:])
        vg = pool_v[pages].reshape((b, length) + pool_v.shape[2:])
        slots = torch.arange(length, device=q.device)
        valid = (slots[None, :] <= index[:, None])[:, None, :]
        out = _attend(q, kg, vg, valid, scale, fill=NEG_INF, p_dtype=vg.dtype)
        return out, {"k": pool_k, "v": pool_v, "pages": pages, "index": index + 1}


def _roll_rows(x: torch.Tensor, shift) -> torch.Tensor:
    """``jnp.roll(x, shift, axis=1)`` for a tensor ``shift`` (no host read):
    row r of the result is row (r - shift) % L of ``x``."""
    length = x.shape[1]
    src = (torch.arange(length, device=x.device) - shift) % length
    return x.index_select(1, src)


def attention_init_cache(batch: int, cfg: AttentionCfg, max_len: int, *,
                         device) -> Cache:
    """Dense bf16 KV rows and a per-row ``index`` (the absolute position of
    the next token): every row is its own slot.  A global layer holds
    ``max_len`` positions; a windowed one a rolling buffer of ``min(max_len,
    window)`` rows."""
    length = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "index": torch.zeros(batch, dtype=torch.long, device=device)}


def init_paged_cache(batch: int, cfg: AttentionCfg, page_size: int, n_pages: int,
                     max_blocks: int, *, device) -> Cache:
    """Block-granular paged decode cache (serve slot caches).

    K/V live in a pool of ``n_pages`` pages of ``page_size`` tokens shared by
    the ``batch`` slots; each slot's ``(max_blocks,)`` page table maps its
    block b to the page holding positions [b*ps, (b+1)*ps).  Page id
    ``n_pages`` is the sentinel, as in the JAX package, but the pool holds
    one page more: the sentinel is a real trash page.  JAX drops writes
    through the sentinel and clamps reads to some pool page; in PyTorch an
    out-of-range index is a device-side assert, so sentinel writes land in
    the trash page and sentinel reads come from it, masked to zero
    probability.  Tables start at the sentinel: no slot owns a page until
    admission assigns it."""
    shape = (n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "pages": torch.full((batch, max_blocks), n_pages, dtype=torch.long,
                                device=device),
            "index": torch.zeros(batch, dtype=torch.long, device=device)}
