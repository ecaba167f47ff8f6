"""Per-layer block: a pre-normed sequence mixer and a pre-normed channel
mixer, each with a residual add (``repro/models/blocks.py``).

Mixers: ``goom_ssm`` (the paper's RNN layer), ``mamba``, ``attention``,
``rwkv6`` and ``none``; channels: ``none``, ``mlp``, ``moe`` and
``rwkv6_cm``; norms ``rms``, ``rms_plus_one``, ``ln`` and ``ln_nonparam``;
``post_norms`` (gemma3's sandwich norms) norm each mixer's output before
its residual add.  The goom layer applies its own ``ln`` after the block's
``mixer_norm``; both are real parameters of the model, so both stay.  The
MoE routes dropless when the block runs with a cache (serving) and with
capacity dropping without one, as in the JAX package, and its aux losses
come back beside the block's output (empty for the other channels and when
serving).  RWKV6's channel mix token-shifts its *normed* input, so the
block caches that (``cm_x_prev``) beside the time mix's state.

Under rules that split heads or channels across ranks (the model axis,
``sharding/tensor_parallel.py``) the attention, goom, Mamba and RWKV6
mixers, the dense MLP, RWKV6's channel mix and the MoE experts run the
rank's block and all-reduce what leaves it, so a block's input and output
are whole on every rank; ``block_init_cache`` then holds the rank's KV
heads (or its block of the KV rows, where the rules put the caches'
sequence on the axis), goom heads, Mamba channels and RWKV6 heads.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import BlockCfg
from ..sharding.rules import constrain
from .attention import Attention, attention_init_cache, init_paged_cache
from .goom_layer import GoomSSM, goom_ssm_init_state
from .mlp import Mlp, Moe
from .norms import make_norm
from .ssm import Mamba, Rwkv6ChannelMix, Rwkv6TimeMix, mamba_init_state, rwkv6_init_state

Cache = Dict[str, torch.Tensor]

_MIXERS = {"goom_ssm": ("goom", GoomSSM), "mamba": ("mamba", Mamba),
           "attention": ("attn", Attention), "rwkv6": ("rwkv", Rwkv6TimeMix)}
_CHANNELS = {"mlp": ("mlp", Mlp), "moe": ("moe", Moe), "rwkv6_cm": ("rwkv", Rwkv6ChannelMix)}


def _part(table, kind: str, blk: BlockCfg, what: str):
    if kind not in table:
        raise NotImplementedError(f"block {what}={kind!r}: the port builds "
                                  f"{sorted(table)} and 'none'")
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
        if blk.mixer != "none":
            mcfg, mixer = _part(_MIXERS, blk.mixer, blk, "mixer")
            self.mixer_norm = make_norm(blk.norm, mcfg.d_model, **kw)
            self.mixer = mixer(mcfg, generator=generator, **kw)
            if blk.post_norms:
                self.mixer_post_norm = make_norm(blk.norm, mcfg.d_model, **kw)
        if blk.channel != "none":
            ccfg, channel = _part(_CHANNELS, blk.channel, blk, "channel")
            self.channel_norm = make_norm(blk.norm, ccfg.d_model, **kw)
            self.channel = channel(ccfg, generator=generator, **kw)
            if blk.post_norms:
                self.channel_post_norm = make_norm(blk.norm, ccfg.d_model, **kw)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                mrope_positions: Optional[torch.Tensor] = None,
                cache: Optional[Cache] = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                fresh_caches: bool = False):
        """Returns (x, new cache or None, aux losses); residual adds are in
        x's dtype.  ``mrope_positions`` (3, B, S) go to an attention mixer;
        the other mixers take no positions.  ``fresh_caches`` (static)
        promises an empty cache: an attention mixer's single-shot prefill
        then attends over the prompt alone."""
        blk = self.blk
        c = None
        if blk.mixer != "none":
            h = self.mixer_norm(x)
            if blk.mixer == "attention":
                h, c = self.mixer(h, positions=positions,
                                  mrope_positions=mrope_positions, cache=cache,
                                  compute_dtype=compute_dtype, fresh_cache=fresh_caches)
            else:
                h, c = self.mixer(h, state=cache, compute_dtype=compute_dtype)
            if blk.post_norms:
                h = self.mixer_post_norm(h)
            x = constrain(x + h.to(x.dtype), "batch", "act_seq", "act_embed")
        aux: Dict[str, torch.Tensor] = {}
        if blk.channel != "none":
            h = self.channel_norm(x)
            if blk.channel == "moe":
                h, aux = self.channel(h, compute_dtype=compute_dtype,
                                      dropless=cache is not None)
            elif blk.channel == "rwkv6_cm":
                if cache is not None:
                    prev = cache["cm_x_prev"]
                    c = dict(c or {}, cm_x_prev=h[:, -1:].to(prev.dtype))
                h = self.channel(h, x_prev=None if cache is None else prev,
                                 compute_dtype=compute_dtype)
            else:
                h = self.channel(h, compute_dtype=compute_dtype)
            if blk.post_norms:
                h = self.channel_post_norm(h)
            x = constrain(x + h.to(x.dtype), "batch", "act_seq", "act_embed")
        return x, c, aux


def block_init_cache(blk: BlockCfg, batch: int, *, device,
                     max_len: Optional[int] = None,
                     kv_pages: Optional[Tuple[int, int, int]] = None) -> Cache:
    """One layer's decode state, every leaf leading with ``batch``: the GOOM
    carry, Mamba's conv tail and SSM state, RWKV6's token-shift rows and WKV
    state (and the channel mix's ``cm_x_prev``), or attention's KV rows with
    a per-row index: ``max_len`` positions for a global layer, a rolling
    buffer of ``min(max_len, window)`` for a windowed one.
    ``kv_pages=(page_size, n_pages, max_blocks)`` puts a global layer's KV
    in a paged pool instead (``attention.init_paged_cache``); windowed
    layers keep their dense rolling buffers, whose size the window bounds.
    KV is bf16, as the JAX package stores it."""
    if blk.mixer == "goom_ssm":
        c = goom_ssm_init_state(batch, blk.goom, device=device)
    elif blk.mixer == "mamba":
        c = mamba_init_state(batch, blk.mamba, device=device)
    elif blk.mixer == "rwkv6":
        c = rwkv6_init_state(batch, blk.rwkv, device=device)
    elif blk.mixer == "attention":
        if kv_pages is not None and blk.attn.window is None:
            ps, n_pages, max_blocks = kv_pages
            c = init_paged_cache(batch, blk.attn, ps, n_pages, max_blocks,
                                 device=device)
        elif max_len is None:
            raise ValueError("an attention layer's cache needs max_len")
        else:
            c = attention_init_cache(batch, blk.attn, max_len, device=device)
    elif blk.mixer == "none":
        c = {}
    else:
        raise NotImplementedError(f"no cache for mixer {blk.mixer!r}")
    if blk.channel == "rwkv6_cm":
        c["cm_x_prev"] = torch.zeros(batch, 1, blk.rwkv.d_model, device=device)
    return c
