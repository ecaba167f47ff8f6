"""Attention: causal GQA with RoPE over a dense or a paged KV cache.

Counterpart of ``repro/models/attention.py`` for global attention (no
sliding window, biases, q/k norms or M-RoPE).  Four paths, each the JAX
package's arithmetic:

  * no cache: causal self-attention over the sequence (``flash_attention``,
    which for one KV block is this masked softmax);
  * a cache and S > 1: chunked prefill (``_prefill_attention``): the chunk's
    K/V are written into the cache at the row's ``index`` and the chunk
    attends over everything cached so far;
  * a cache and S == 1: decode (``_decode_attention``): each row writes at
    its own ``index`` and attends over its cache row;
  * a paged cache (one with ``pages``) and S == 1: decode against the
    shared page pool (``_paged_decode_attention``, see
    :func:`init_paged_cache`).

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
from .common import Dense
from .rope import apply_rope

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
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqhgk,bkhd->bqhgd", p.to(p_dtype).float(), v.float())
    return (acc / l).reshape(b, sq, h, d)


class Attention(nn.Module):
    """One attention mixer; parameter names follow the JAX param tree
    (``q.w`` (d, H, hd), ``k.w``/``v.w`` (d, KVH, hd), ``o.w`` (H, hd, d))."""

    def __init__(self, cfg: AttentionCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.n_heads % cfg.n_kv_heads:
            raise ValueError(f"{cfg.n_heads} heads do not group over "
                             f"{cfg.n_kv_heads} KV heads")
        self.cfg = cfg
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.q = Dense(d, (h, hd), **kw)
        self.k = Dense(d, (kvh, hd), **kw)
        self.v = Dense(d, (kvh, hd), **kw)
        self.o = Dense(h, (hd, d), std=(h * hd) ** -0.5, **kw)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[Cache] = None,
                compute_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """x (B, S, d) at absolute ``positions`` (B, S) → (y (B, S, d), new
        cache or None)."""
        cfg, cd = self.cfg, compute_dtype
        b, s, _ = x.shape
        scale = cfg.head_dim ** -0.5
        q = self.q(x, compute_dtype=cd)
        k = self.k(x, compute_dtype=cd)
        v = self.v(x, compute_dtype=cd)
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)

        new_cache = None
        if cache is None:
            pos = positions[0]
            causal = (pos[None, :] <= pos[:, None])[None]
            out = _attend(q, k, v, causal, scale, fill=-torch.inf, p_dtype=cd)
        elif "pages" in cache:
            if s != 1:
                raise ValueError("a paged KV cache takes one token per row")
            out, new_cache = self._paged_decode(q, k, v, cache, scale)
        elif s > 1:
            out, new_cache = self._prefill(q, k, v, cache, positions, scale)
        else:
            out, new_cache = self._decode(q, k, v, cache, scale)
        out = out.to(cd).reshape(b, s, -1)
        y = out @ self.o.w.to(cd).reshape(-1, cfg.d_model)
        return y, new_cache

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

    @staticmethod
    def _decode(q, k_new, v_new, cache: Cache, scale):
        """One token per row, written at the row's own ``index`` (a write
        past the end of the row is dropped), attending over the row."""
        b = q.shape[0]
        length = cache["k"].shape[1]
        index = cache["index"]
        rows = torch.arange(b, device=q.device)
        at = index.clamp(max=length - 1)
        keep = (index < length)[:, None, None]
        k, v = cache["k"].clone(), cache["v"].clone()
        k[rows, at] = torch.where(keep, k_new[:, 0].to(k.dtype), k[rows, at])
        v[rows, at] = torch.where(keep, v_new[:, 0].to(v.dtype), v[rows, at])
        slots = torch.arange(length, device=q.device)
        valid = (slots[None, :] <= index[:, None])[:, None, :]
        out = _attend(q, k, v, valid, scale, fill=NEG_INF, p_dtype=v.dtype)
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


def attention_init_cache(batch: int, cfg: AttentionCfg, max_len: int, *,
                         device) -> Cache:
    """Dense bf16 KV rows of ``max_len`` positions and a per-row ``index``
    (the absolute position of the next token): every row is its own slot."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
