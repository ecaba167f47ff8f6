"""Attention: causal GQA with RoPE over a dense, a rolling or a paged KV
cache.

Counterpart of ``repro/models/attention.py``: q/k/v biases (``qkv_bias``),
q/k RMSNorms over the head dim (``qk_norm``; plain RMS whatever the
block's norm), ``query_scale``, partial rotary (``rotary_fraction``),
M-RoPE (``mrope_sections``: q and k rotate by three position streams,
``mrope_positions`` (3, B, S), each stream ``positions`` when none are
given) and sliding windows.  Four paths, each the JAX package's arithmetic:

  * no cache: causal (and windowed) self-attention over the sequence by
    :func:`flash_attention`, or, for a windowed layer with ``use_banded``
    and at least two windows of sequence, the two-block band
    (:func:`banded_attention`);
  * a cache and S > 1: prefill of one prompt chunk (``_prefill``, JAX's
    ``_prefill_attention``), each branch through :func:`flash_attention`
    with the layer's tiles.  ``fresh`` (static) promises an empty cache:
    the chunk attends over itself, so the work scales with the prompt and
    not with the cache.  Global: a prompt no shorter than the cache keeps
    its last ``length`` tokens; else the chunk's K/V are written at the
    row's ``index`` and the chunk attends over everything cached so far.
    Windowed: the cache is a rolling buffer of ``min(max_len, window)``
    rows; the chunk attends over [buffer ; chunk] (each buffer row at the
    absolute position it holds, the chunk's own K/V unrounded), then the
    chunk is written at ``(start + i) % length``, or, when its tail fills
    the buffer, rolled in so that position p sits in row p % length;
  * a cache and S == 1: decode (``_decode``): each row writes at its own
    ``index`` (``index % length`` in a rolling buffer) and attends over its
    cache row (positions in ``(index - window, index]``);
  * a paged cache (one with ``pages``) and S == 1: decode against the
    shared page pool (``_paged_decode``, see :func:`init_paged_cache`);
    global layers only.

Scores and the softmax are f32; ``p`` is cast to the value dtype before
the product and the sum is divided out after the f32 accumulation.  The KV
cache is bf16 whatever the compute dtype, as the JAX package stores it.
Decode contracts a bf16 cache on the card in bf16 with f32 outputs, as
JAX's ``preferred_element_type`` (:func:`_attend`).  These are plain tensor
ops: the JAX package leaves attention to XLA, no Pallas kernel, so the port
has no kernel here either.

The model axis (``sharding/tensor_parallel.py``): under rules that split
``act_heads``, a rank runs its block of query heads (q column-split, o
row-split and all-reduced) and of KV heads where ``act_kv_heads`` splits on
the same axis; where it does not (KV heads that do not divide the axis),
k and v are computed whole and each rank attends with the KV heads its
query heads need.  Its caches then hold every KV head: whole, or, where
the rules put ``cache_seq`` on one mesh axis (JAX's rule for such KV
heads; the heads' axis, or any where the query heads do not split), the
rank's block of the rows (a rolling buffer's too).  A fresh prefill writes
the rows of its block; a decode step writes the new K/V only where its
row's slot lies in the block, attends over its rows for every query head
(q gathered over the heads' group where they split) and combines the
partials across ranks (the all-reduced max of each score row, then the
sum of the exponentials and of the weighted V, in f32), then keeps its
heads' block.  A chunked prefill or a paged decode on such a cache raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import AttentionCfg
from ..core.goom import safe_log
from ..sharding.rules import constrain, current_rules
from ..sharding.tensor_parallel import (Split, all_max, enter, gather_last, leave, split_of,
                                       split_on)
from .common import Dense, wide
from .norms import RMSNorm
from .rope import apply_mrope, apply_rope

NEG_INF = -1e30

Cache = Dict[str, torch.Tensor]


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
            scale: float, rows: Optional[Split] = None) -> torch.Tensor:
    """Decode's masked softmax over a whole cache row, GQA by head groups
    (JAX's ``_decode_attention``): q (B, 1, H, D); k, v (B, L, KVH, D);
    ``valid`` broadcasts to (B, 1, L).  Masked scores are ``NEG_INF``; ``p``
    is rounded to v's dtype before the product.  Returns (B, 1, H, D) f32
    (f64 for f64 inputs).  ``rows``: the cache holds this rank's block of
    the rows; each score row's max is all-reduced before the exponentials
    and the sums of ``p`` and of ``p·v`` after (:func:`_combined`), so every
    rank returns the whole row's softmax.

    As JAX's ``preferred_element_type``, a bf16 cache on the card is
    contracted in its own dtype with f32 products out (``torch.bmm(...,
    out_dtype=torch.float32)``, one call a KV head over the cache's strided
    rows, nothing of the cache copied); elsewhere the operands go to f32
    first, which gives the same products (bf16 products are exact in
    f32)."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    if k.is_cuda and k.dtype in (torch.bfloat16, torch.float16):
        return _attend_narrow(q, k, v, valid, scale, rows)
    qg = wide(q).reshape(b, sq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qg, wide(k)) * scale
    s = s.masked_fill(~valid[:, :, None, None, :], NEG_INF)
    p = torch.exp(s - all_max(s.amax(dim=-1, keepdim=True), rows))   # max-rescaled softmax; goomcheck: disable=GC202
    acc = torch.einsum("bqhgk,bkhd->bqhgd", wide(p.to(v.dtype)), wide(v))
    acc, total = _combined(acc, p.sum(dim=-1, keepdim=True), rows)
    return (acc / total).reshape(b, sq, h, d)


def _attend_narrow(q, k, v, valid, scale, rows=None):
    """:func:`_attend` on a bf16 (or f16) cache on the card: each KV head's
    scores and its values' sum as bf16 products with f32 outputs."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    # (B, KVH, Sq·G, D) queries in the cache's dtype, as JAX's einsum has them
    qg = q.to(k.dtype).reshape(b, sq, kvh, g, d).permute(0, 2, 1, 3, 4).reshape(b, kvh, sq * g, d)
    s = torch.stack([torch.bmm(qg[:, i], k[:, :, i].transpose(1, 2), out_dtype=torch.float32)
                     for i in range(kvh)], 1).mul_(scale)          # (B, KVH, Sq·G, L)
    s = s.view(b, kvh, sq, g, -1).masked_fill_(~valid[:, None, :, None, :], NEG_INF)
    p = torch.exp(s - all_max(s.amax(dim=-1, keepdim=True), rows))   # max-rescaled softmax; goomcheck: disable=GC202
    pv = p.to(v.dtype).view(b, kvh, sq * g, -1)
    acc = torch.stack([torch.bmm(pv[:, i], v[:, :, i], out_dtype=torch.float32)
                       for i in range(kvh)], 1)                    # (B, KVH, Sq·G, D)
    acc, total = _combined(acc.view(b, kvh, sq, g, d), p.sum(dim=-1, keepdim=True), rows)
    return (acc / total).permute(0, 2, 1, 3, 4).reshape(b, sq, h, d)


def _combined(acc: torch.Tensor, total: torch.Tensor, rows: Optional[Split]):
    """A row-split softmax's weighted values and sums of exponentials (both
    taken after the all-reduced max) summed over the ranks in one f32
    all-reduce; as they are without a split."""
    if rows is None:
        return acc, total
    both = leave(torch.cat([acc, total], dim=-1), rows)
    return both[..., :-1], both[..., -1:]


# ---------------------------------------------------------------------------
# blockwise flash attention (train, prefill)
# ---------------------------------------------------------------------------
#: padded keys sit at this position: after every query
_PAD_KV_POS = 2 ** 30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    window: Optional[int], scale: float, block_q: int,
                    block_kv: int) -> torch.Tensor:
    """Online-softmax attention over blocks of ``block_kv`` keys,
    ``repro/models/attention.py::flash_attention`` step for step: q (B, Sq,
    H, D) at ``q_positions`` (Sq,), k and v (B, Skv, KVH, D) at
    ``kv_positions`` (Skv,), causal and, with ``window``, windowed.

    q is padded to a multiple of ``min(block_q, Sq)`` (positions -1: rows
    that see no key) and k, v to a multiple of ``min(block_kv, Skv)``
    (positions 2**30: keys no query sees).  The whole query set stays
    resident; a Python loop over the key blocks carries the running max,
    denominator and f32 accumulator, so the scores alive at a time are one
    block's, (B, Sq, H, block_kv) f32, exponentiated and rounded in place.
    The backward (:class:`_Flash`) recomputes each block's ``p = exp(s -
    lse)`` from q, k, v and the per-row log-sum-exp instead of saving
    scores.  No value is read on the host: a CUDA graph captures it.
    Returns (B, Sq, H, D) in q's dtype."""
    sq, skv = q.shape[1], k.shape[1]
    block_q, block_kv = min(block_q, sq), min(block_kv, skv)
    pad_q = -(-sq // block_q) * block_q - sq
    pad_k = -(-skv // block_kv) * block_kv - skv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_positions = torch.cat([q_positions, q_positions.new_full((pad_q,), -1)])
    if pad_k:
        k, v = (F.pad(x, (0, 0, 0, 0, 0, pad_k)) for x in (k, v))
        kv_positions = torch.cat([kv_positions, kv_positions.new_full((pad_k,), _PAD_KV_POS)])
    out = _Flash.apply(q, k, v, q_positions, kv_positions,
                       -1 if window is None else window, scale, block_kv)
    return out[:, :sq].to(q.dtype)


def _grouped(x: torch.Tensor, kvh: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, KVH, S·G, D) f32 (f64 for f64), each KV head's
    query rows in (position, group) order: one batched product per block
    over them."""
    b, s, h, d = x.shape
    return (wide(x).reshape(b, s, kvh, h // kvh, d).transpose(1, 2)
            .reshape(b, kvh, s * (h // kvh), d).contiguous())


def _ungrouped(x: torch.Tensor, s: int) -> torch.Tensor:
    """(B, KVH, S·G, D) -> (B, S, H, D)."""
    b, kvh, _, d = x.shape
    return x.reshape(b, kvh, s, -1, d).transpose(1, 2).reshape(b, s, -1, d)


def _block_scores(qg, k_blk, qpos, kp, window: int, scale: float, sq: int):
    """One block's f32 scores (B, KVH, Sq·G, Bk) times ``scale``, -inf
    where the causal (and window) mask drops a key (JAX's ``_mask_block``)."""
    b, kvh, rows, _ = qg.shape
    s = torch.matmul(qg, k_blk.to(qg.dtype).permute(0, 2, 3, 1)).mul_(scale)
    keep = kp[None, :] <= qpos[:, None]
    if window >= 0:
        keep = keep & (kp[None, :] > qpos[:, None] - window)
    s.view(b, kvh, sq, rows // sq, -1).masked_fill_(~keep[:, None, :], -torch.inf)
    return s


class _Flash(torch.autograd.Function):
    """JAX's ``_flash`` custom VJP (FlashAttention-2 style) on padded
    operands: the forward saves q, k, v, the positions, the f32 output and
    the per-row LSE, never a block's scores."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, window: int, scale: float, block_kv: int):
        sq, kvh = q.shape[1], k.shape[2]
        qg = _grouped(q, kvh)
        shape = qg.shape[:3]
        m = torch.full(shape, -torch.inf, device=q.device, dtype=qg.dtype)
        l = torch.zeros(shape, device=q.device, dtype=qg.dtype)
        acc = torch.zeros_like(qg)
        for lo in range(0, k.shape[1], block_kv):
            s = _block_scores(qg, k[:, lo:lo + block_kv], qpos, kpos[lo:lo + block_kv],
                              window, scale, sq)
            m_new = torch.maximum(m, s.amax(-1))
            # guards: a row masked so far keeps p == 0, never NaN
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)  # online-softmax rescale; goomcheck: disable=GC202
            p = s.sub_(m_safe[..., None]).exp_()  # max-rescaled softmax, in place; goomcheck: disable=GC202
            l = l * alpha + p.sum(-1)
            if v.dtype != p.dtype:
                p.copy_(p.to(v.dtype))      # p rounded to v's dtype, in place
            v_blk = v[:, lo:lo + block_kv].to(qg.dtype).transpose(1, 2)
            acc = acc * alpha[..., None] + torch.matmul(p, v_blk)
            m = m_new
        l_safe = l.clamp_min(1e-30)
        out = acc / l_safe[..., None]
        # the +1e30 sentinel of an empty row keeps the backward's p = 0
        lse = torch.where(l > 0, torch.where(torch.isfinite(m), m, 0.0) + safe_log(l_safe),
                          1e30)
        out = _ungrouped(out, sq)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.cfg = (window, scale, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        window, scale, block_kv = ctx.cfg
        sq, kvh = q.shape[1], k.shape[2]
        dout = _grouped(dout, kvh)
        delta = (dout * _grouped(out, kvh)).sum(-1)     # rowsum(dO ⊙ O)
        qg = _grouped(q, kvh)
        dq = torch.zeros_like(qg)
        dk = torch.empty(k.shape, device=k.device, dtype=qg.dtype)
        dv = torch.empty(v.shape, device=v.device, dtype=qg.dtype)
        for lo in range(0, k.shape[1], block_kv):
            k_blk = k[:, lo:lo + block_kv].to(qg.dtype).transpose(1, 2)
            v_blk = v[:, lo:lo + block_kv].to(qg.dtype).transpose(1, 2)
            s = _block_scores(qg, k[:, lo:lo + block_kv], qpos, kpos[lo:lo + block_kv],
                              window, scale, sq)
            p = s.sub_(lse[..., None]).exp_()  # exact probabilities, lse-rescaled; goomcheck: disable=GC202
            dv[:, lo:lo + block_kv] = torch.matmul(p.transpose(-1, -2), dout).transpose(1, 2)
            dp = torch.matmul(dout, v_blk.transpose(-1, -2))
            ds = p.mul_(dp.sub_(delta[..., None])).mul_(scale)
            del p, dp
            dq += torch.matmul(ds, k_blk)
            dk[:, lo:lo + block_kv] = torch.matmul(ds.transpose(-1, -2), qg).transpose(1, 2)
        return (_ungrouped(dq, sq).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


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

    scores = torch.einsum("bnqhgd,bnkhd->bnqhgk", wide(qb), wide(k_pair)) * scale
    mask = ((pos_pair[:, None, :] <= pos_b[:, :, None])
            & (pos_pair[:, None, :] > pos_b[:, :, None] - w))        # (nb, W, 2W)
    scores = scores.masked_fill(~mask[None, :, :, None, None, :], -torch.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)   # max-rescaled softmax; goomcheck: disable=GC202
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bnqhgk,bnkhd->bnqhgd", wide((p / l).to(v_pair.dtype)),
                       wide(v_pair))
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

    def split_dims(self, rules) -> Tuple[Optional[str], Dict[str, Optional[int]]]:
        """The mesh axis the heads split on under ``rules`` (None: whole) and
        the dim of each parameter whose block a rank reads (None: read whole,
        its gradient partial on each rank; ``sharding/tensor_parallel.py``):
        q column-split, o row-split, k and v column-split where the KV heads
        split on the same axis, else read whole (each rank picks the KV heads
        its query heads need), the q/k norms' scales whole."""
        cfg = self.cfg
        axis = rules.split_axis("act_heads", cfg.n_heads)
        if axis is None:
            return None, {}
        kv = 1 if rules.split_axis("act_kv_heads", cfg.n_kv_heads) == axis else None
        dims = {"q.w": 1, "o.w": 0, "k.w": kv, "v.w": kv}
        if cfg.qkv_bias:
            dims.update({"q.b": 0, "k.b": None if kv is None else 0,
                         "v.b": None if kv is None else 0})
        if cfg.qk_norm:
            dims.update({"q_norm.scale": None, "k_norm.scale": None})
        return axis, dims

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                mrope_positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                fresh_cache: bool = False
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, d) at absolute ``positions`` (B, S), and for M-RoPE at
        ``mrope_positions`` (3, B, S) → (y (B, S, d), new cache or None).
        ``fresh_cache`` (static) promises that ``cache`` holds nothing yet:
        a prompt then attends over itself (single-shot prefill).

        Under rules that split the heads (:meth:`split_dims`) a rank runs
        its block of query heads, and of KV heads where those split too
        (its caches then hold them alone); o's partial sums are all-reduced
        over the model group."""
        cfg, cd = self.cfg, compute_dtype
        b, s, _ = x.shape
        h, kvh = cfg.n_heads, cfg.n_kv_heads
        scale = cfg.query_scale if cfg.query_scale is not None else cfg.head_dim ** -0.5
        sp, kv_sp, rows = _splits(cfg)
        sel = _kv_select(sp, h, kvh) if sp is not None and kv_sp is None else None
        x = enter(x, sp)
        q = self.q(x, compute_dtype=cd, split=(sp, 1, h))
        k = self.k(x, compute_dtype=cd, split=(kv_sp, 1, kvh))
        v = self.v(x, compute_dtype=cd, split=(kv_sp, 1, kvh))
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
            kk, vv = _selected(sel, k, v)
            if cfg.use_banded and cfg.window is not None and 2 * cfg.window <= s:
                out = banded_attention(q, kk, vv, positions=pos, window=cfg.window,
                                       scale=scale)
            else:
                out = flash_attention(q, kk, vv, q_positions=pos, kv_positions=pos,
                                      window=cfg.window, scale=scale,
                                      block_q=cfg.block_q, block_kv=cfg.block_kv)
        elif "pages" in cache:
            if s != 1:
                raise ValueError("a paged KV cache takes one token per row")
            if rows is not None:
                raise NotImplementedError("a paged decode under rules that split the KV "
                                          "cache's sequence across ranks")
            out, new_cache = self._paged_decode(q, k, v, cache, scale, sel)
        elif s > 1:
            if rows is not None and not fresh_cache:
                raise NotImplementedError("a chunked (non-fresh) prefill into a KV cache "
                                          "split by sequence across ranks")
            out, new_cache = self._prefill(q, k, v, cache, positions, scale,
                                           fresh=fresh_cache, sel=sel, rows=rows)
        else:
            out, new_cache = self._decode(q, k, v, cache, scale, sel, rows, sp)
        out = constrain(out.to(cd), "batch", "act_seq", "act_heads", None).reshape(b, s, -1)
        o = self.o.w if sp is None else sp.take(self.o.w, 0, h)
        y = out @ o.to(cd).reshape(-1, cfg.d_model)
        return leave(y, sp), new_cache

    def _flash(self, q, k, v, q_pos, kv_pos, scale, window, sel=None):
        k, v = _selected(sel, k, v)
        return flash_attention(q, k, v, q_positions=q_pos, kv_positions=kv_pos,
                               window=window, scale=scale, block_q=self.cfg.block_q,
                               block_kv=self.cfg.block_kv)

    def _prefill(self, q, k_new, v_new, cache: Cache, positions, scale, *, fresh: bool,
                 sel=None, rows: Optional[Split] = None):
        """One prompt chunk from row 0's ``index`` (a prefill batch shares
        its positions), JAX's ``_prefill_attention`` branch for branch (the
        module docstring); ``fresh`` (static) takes the index as 0.  ``sel``
        picks a split rank's KV heads from whole ones (:func:`_kv_select`)
        where the attention reads them; the cache keeps what it is given.
        ``rows`` (fresh only): the cache holds the rank's block of rows, and
        gets the rows of the whole cache's write that fall in it."""
        s = q.shape[1]
        window = self.cfg.window
        length = cache["k"].shape[1]
        dt = cache["k"].dtype
        pos = positions[0]
        start = 0 if fresh else cache["index"][0]
        new_index = cache["index"] + s
        if fresh:   # nothing cached: the chunk is all there is to attend to
            out = self._flash(q, k_new, v_new, pos, pos, scale, window, sel)
        if rows is not None:
            k, v = (_fresh_block(new, cache[key], s, window is not None, rows)
                    for new, key in ((k_new, "k"), (v_new, "v")))
            return out, {"k": k, "v": v, "index": new_index}

        if window is None:
            if s >= length:
                # the whole prompt at the cache's length or beyond (start 0):
                # keep its last `length` tokens, each in its row
                if not fresh:
                    out = self._flash(q, k_new, v_new, pos, pos, scale, None, sel)
                return out, {"k": k_new[:, s - length:].to(dt),
                             "v": v_new[:, s - length:].to(dt), "index": new_index}
            # the chunk's rows from `start`, clamped into the cache as JAX's
            # dynamic_update_slice clamps (the Engine keeps start + s <= length)
            first = start if fresh else start.clamp(max=length - s)
            at = first + torch.arange(s, device=q.device)
            k = cache["k"].index_copy(1, at, k_new.to(dt))
            v = cache["v"].index_copy(1, at, v_new.to(dt))
            if not fresh:
                # row i holds position i once written (up to the chunk's last)
                slots = torch.arange(length, device=q.device)
                kv_pos = torch.where(slots <= start + (s - 1), slots, _PAD_KV_POS)
                out = self._flash(q, k.to(q.dtype), v.to(q.dtype), pos, kv_pos, scale, None,
                                  sel)
            return out, {"k": k, "v": v, "index": new_index}

        if not fresh:
            # a rolling buffer: the window's earlier tokens sit in it, each row
            # at the absolute position it holds; attend over [buffer ; chunk]
            abs_prev = _ring_positions(start - 1, length)
            kv_pos = torch.where(abs_prev >= 0, abs_prev, _PAD_KV_POS)
            k_cat = torch.cat([cache["k"].to(q.dtype), k_new], dim=1)
            v_cat = torch.cat([cache["v"].to(q.dtype), v_new], dim=1)
            out = self._flash(q, k_cat, v_cat, pos, torch.cat([kv_pos, pos]), scale, window,
                              sel)
        if s >= length:
            # the chunk's tail fills the buffer: position p goes to row p % length
            shift = (start + s - length) % length
            k = _roll_rows(k_new[:, s - length:], shift).to(dt)
            v = _roll_rows(v_new[:, s - length:], shift).to(dt)
        else:
            at = (start + torch.arange(s, device=q.device)) % length
            k = cache["k"].index_copy(1, at, k_new.to(dt))
            v = cache["v"].index_copy(1, at, v_new.to(dt))
        return out, {"k": k, "v": v, "index": new_index}

    def _decode(self, q, k_new, v_new, cache: Cache, scale, sel=None,
                rows: Optional[Split] = None, heads: Optional[Split] = None):
        """One token per row, written at the row's own ``index`` (a write
        past the end of a global row is dropped; a rolling buffer writes at
        ``index % length``), attending over the row's valid positions.
        ``rows``: the cache holds the rank's block of rows; the write lands
        only where its slot lies in the block, every query head (q gathered
        over the group where ``heads`` splits them) attends over the block,
        the partials combine across ranks (:func:`_attend`) and the rank
        keeps its heads."""
        b = q.shape[0]
        length = cache["k"].shape[1]
        whole, lo = (length, 0) if rows is None else (length * rows.size, rows.index * length)
        index = cache["index"]
        at_row = torch.arange(b, device=q.device)
        window = self.cfg.window
        k, v = cache["k"].clone(), cache["v"].clone()
        if window is None:
            at = index.clamp(max=whole - 1)
            keep = index < whole
            slots = lo + torch.arange(length, device=q.device)
            valid = slots[None, :] <= index[:, None]
        else:
            at = index % whole
            keep = torch.ones_like(index, dtype=torch.bool)
            abs_pos = _ring_positions(index, whole)[:, lo:lo + length]
            valid = (abs_pos >= 0) & (abs_pos > index[:, None] - window)
        local = at - lo
        keep = (keep & (local >= 0) & (local < length))[:, None, None]
        local = local.clamp(0, length - 1)
        k[at_row, local] = torch.where(keep, k_new[:, 0].to(k.dtype), k[at_row, local])
        v[at_row, local] = torch.where(keep, v_new[:, 0].to(v.dtype), v[at_row, local])
        if rows is None:
            out = _attend(q, *_selected(sel, k, v), valid[:, None, :], scale)
        elif heads is None:
            out = _attend(q, k, v, valid[:, None, :], scale, rows)
        else:
            h = self.cfg.n_heads
            q_all = gather_last(q.movedim(2, -1), heads, h).movedim(-1, 2)
            out = heads.take(_attend(q_all, k, v, valid[:, None, :], scale, rows), 2, h)
        return out, {"k": k, "v": v, "index": index + 1}

    @staticmethod
    def _paged_decode(q, k_new, v_new, cache: Cache, scale, sel=None):
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
        out = _attend(q, *_selected(sel, kg, vg), valid, scale)
        return out, {"k": pool_k, "v": pool_v, "pages": pages, "index": index + 1}


def _kv_select(sp: Split, h: int, kvh: int):
    """A rank's pick of whole KV heads (B, S, KVH, D) for its block of
    query heads: the KV heads of their groups, a contiguous run where the
    block covers whole groups or lies in one, else one KV head a query
    head (groups of one)."""
    lo, hl = sp.block(h)
    g = h // kvh
    idx = [(lo + j) // g for j in range(hl)]
    if hl % g == 0 or g % hl == 0:
        first, n = idx[0], max(1, hl // g)
        return lambda t: t.narrow(2, first, n)
    at = torch.tensor(idx)
    return lambda t: t.index_select(2, at.to(t.device))


def _selected(sel, k, v):
    return (k, v) if sel is None else (sel(k), sel(v))


def _splits(cfg: AttentionCfg) -> Tuple[Optional[Split], Optional[Split], Optional[Split]]:
    """Under the active rules: the split of the query heads, of the KV heads
    (None unless on the same axis) and of the caches' rows: the one mesh
    axis ``cache_seq`` maps to, where the KV heads stay whole on it and the
    query heads split on it or not at all (JAX's rule for KV heads that do
    not divide the axis)."""
    sp = split_of("act_heads", cfg.n_heads)
    kv = split_of("act_kv_heads", cfg.n_kv_heads) if sp is not None else None
    if kv is not None and kv.axis == sp.axis:
        return sp, kv, None
    rules = current_rules()
    if rules is None or getattr(rules.mesh, "device_mesh", None) is None:
        return sp, None, None
    seq = rules.mesh_axes_for("cache_seq")
    if len(seq) != 1 or rules.mesh.shape[seq[0]] == 1 or (sp is not None
                                                          and sp.axis != seq[0]):
        return sp, None, None
    return sp, None, sp if sp is not None else split_on(rules, seq[0])


def kv_heads(cfg: AttentionCfg) -> int:
    """The KV heads a rank's cache holds under the active rules: its block
    where the KV heads split with the query heads, else all of them."""
    _, kv, _ = _splits(cfg)
    return cfg.n_kv_heads if kv is None else kv.block(cfg.n_kv_heads)[1]


def cache_rows(cfg: AttentionCfg, length: int) -> int:
    """The rows a rank's cache of ``length`` rows holds under the active
    rules: its block where they split the cache's sequence (which must then
    divide the axis), else all."""
    _, _, rows = _splits(cfg)
    if rows is None:
        return length
    if length % rows.size:
        raise ValueError(f"a KV cache of {length} rows does not split over the "
                         f"{rows.size} ranks of {rows.axis!r}")
    return length // rows.size


def _fresh_block(new: torch.Tensor, cache: torch.Tensor, s: int, windowed: bool,
                 rows: Split) -> torch.Tensor:
    """A rank's block of the rows a fresh prefill of ``s`` tokens leaves in
    a whole cache (``Attention._prefill``): ``new`` (B, s, KVH, D), ``cache``
    the rank's (B, L/M, KVH, D).  A prompt no shorter than the whole cache
    keeps its last L tokens (a rolling buffer rolled so that position p sits
    in row p % L); a shorter one fills rows 0..s-1 and leaves the rest."""
    length = cache.shape[1]
    whole = length * rows.size
    r = torch.arange(rows.index * length, (rows.index + 1) * length, device=new.device)
    if s >= whole:
        off = s - whole
        src = off + ((r - off) % whole if windowed else r)
        return new.index_select(1, src).to(cache.dtype)
    written = new.index_select(1, r.clamp(max=s - 1)).to(cache.dtype)
    return torch.where((r < s)[None, :, None, None], written, cache)


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
    window)`` rows; of the rank's KV heads under rules that split them
    (:func:`kv_heads`), and of its block of the rows under rules that split
    the cache's sequence (:func:`cache_rows`)."""
    length = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, cache_rows(cfg, length), kv_heads(cfg), cfg.head_dim)
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
    shape = (n_pages + 1, page_size, kv_heads(cfg), cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "pages": torch.full((batch, max_blocks), n_pages, dtype=torch.long,
                                device=device),
            "index": torch.zeros(batch, dtype=torch.long, device=device)}
