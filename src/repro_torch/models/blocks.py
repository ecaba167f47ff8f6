"""Per-layer block: a pre-normed sequence mixer and a pre-normed channel
mixer, each with a residual add (``repro/models/blocks.py``).

Mixers: ``goom_ssm`` (the paper's RNN layer), ``mamba`` and ``attention``;
channels: ``none``, ``mlp`` and ``moe``; norms ``rms`` and ``ln``.  The
goom layer applies its own ``ln`` after the block's ``mixer_norm``; both are
real parameters of the model, so both stay.  The MoE routes dropless when
the block runs with a cache (serving) and with capacity dropping without
one, as in the JAX package, and its aux losses come back beside the block's
output (empty for the other channels and when serving).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import BlockCfg
from .attention import Attention, attention_init_cache, init_paged_cache
from .goom_layer import GoomSSM, goom_ssm_init_state
from .mlp import Mlp, Moe
from .norms import make_norm
from .ssm import Mamba, mamba_init_state

Cache = Dict[str, torch.Tensor]

_MIXERS = {"goom_ssm": ("goom", GoomSSM), "mamba": ("mamba", Mamba),
           "attention": ("attn", Attention)}
_CHANNELS = {"mlp": ("mlp", Mlp), "moe": ("moe", Moe)}


def _part(table, kind: str, blk: BlockCfg, what: str):
    if kind not in table:
        raise NotImplementedError(f"block {what}={kind!r}: the port builds "
                                  f"{sorted(table)}")
    field, cls = table[kind]
    cfg = getattr(blk, field)
    if cfg is None:
        raise ValueError(f"block {what}={kind!r} needs its {field!r} config")
    return cfg, cls


class Block(nn.Module):
    def __init__(self, blk: BlockCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.blk = blk
        kw = dict(device=device, dtype=dtype)
        mcfg, mixer = _part(_MIXERS, blk.mixer, blk, "mixer")
        self.mixer_norm = make_norm(blk.norm, mcfg.d_model, **kw)
        self.mixer = mixer(mcfg, generator=generator, **kw)
        if blk.channel != "none":
            ccfg, channel = _part(_CHANNELS, blk.channel, blk, "channel")
            self.channel_norm = make_norm(blk.norm, ccfg.d_model, **kw)
            self.channel = channel(ccfg, generator=generator, **kw)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[Cache] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """Returns (x, new cache or None, aux losses); residual adds are in
        x's dtype."""
        h = self.mixer_norm(x)
        if self.blk.mixer == "attention":
            h, c = self.mixer(h, positions=positions, cache=cache,
                              compute_dtype=compute_dtype)
        else:
            h, c = self.mixer(h, state=cache, compute_dtype=compute_dtype)
        x = x + h.to(x.dtype)
        aux: Dict[str, torch.Tensor] = {}
        if self.blk.channel != "none":
            h = self.channel_norm(x)
            if self.blk.channel == "moe":
                h, aux = self.channel(h, compute_dtype=compute_dtype,
                                      dropless=cache is not None)
            else:
                h = self.channel(h, compute_dtype=compute_dtype)
            x = x + h.to(x.dtype)
        return x, c, aux


def block_init_cache(blk: BlockCfg, batch: int, *, device,
                     max_len: Optional[int] = None,
                     kv_pages: Optional[Tuple[int, int, int]] = None) -> Cache:
    """One layer's decode state, every leaf leading with ``batch``: the GOOM
    carry, Mamba's conv tail and SSM state, or attention's KV rows of
    ``max_len`` positions with a per-row index.  ``kv_pages=(page_size,
    n_pages, max_blocks)`` puts attention's KV in a paged pool instead
    (``attention.init_paged_cache``)."""
    if blk.mixer == "goom_ssm":
        return goom_ssm_init_state(batch, blk.goom, device=device)
    if blk.mixer == "mamba":
        return mamba_init_state(batch, blk.mamba, device=device)
    if blk.mixer == "attention":
        if kv_pages is not None:
            ps, n_pages, max_blocks = kv_pages
            return init_paged_cache(batch, blk.attn, ps, n_pages, max_blocks,
                                    device=device)
        if max_len is None:
            raise ValueError("an attention layer's cache needs max_len")
        return attention_init_cache(batch, blk.attn, max_len, device=device)
    raise NotImplementedError(f"no cache for mixer {blk.mixer!r}")
