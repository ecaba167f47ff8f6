"""Per-layer block: a pre-normed sequence mixer with a residual add.

This slice builds ``mixer="goom_ssm"``, ``channel="none"``, ``norm="ln"``,
the goom-rnn layer.  Counterpart of ``repro/models/blocks.py``: the block
applies ``mixer_norm`` and the mixer then applies its own ``ln``; both norms
are real parameters of the model, so both stay.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..configs.base import BlockCfg
from .goom_layer import GoomSSM, goom_ssm_init_state
from .norms import LayerNorm


def _check_supported(blk: BlockCfg) -> None:
    if (blk.mixer, blk.channel, blk.norm) != ("goom_ssm", "none", "ln"):
        raise NotImplementedError(
            f"block mixer={blk.mixer!r} channel={blk.channel!r} "
            f"norm={blk.norm!r}: this slice of the port builds goom_ssm/none/ln")


class Block(nn.Module):
    def __init__(self, blk: BlockCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_supported(blk)
        self.blk = blk
        self.mixer_norm = LayerNorm(blk.goom.d_model, device=device, dtype=dtype)
        self.mixer = GoomSSM(blk.goom, device=device, dtype=dtype,
                             generator=generator)

    def forward(self, x: torch.Tensor, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                compute_dtype: torch.dtype = torch.bfloat16):
        """Returns (x, new cache or None); the residual add is in x's dtype."""
        h = self.mixer_norm(x)
        h, c = self.mixer(h, state=cache, compute_dtype=compute_dtype)
        return x + h.to(x.dtype), c


def block_init_cache(blk: BlockCfg, batch: int, *, device) -> Dict[str, torch.Tensor]:
    _check_supported(blk)
    return goom_ssm_init_state(batch, blk.goom, device=device)
