"""RMSNorm and LayerNorm with JAX-package semantics: statistics in f32
(f64 for f64 inputs), the result cast back to the input's dtype
(``repro/models/norms.py``).

Four kinds, as a config names them: ``rms``; ``rms_plus_one`` (gemma's
scale, initialised to zeros and applied as 1 + w); ``ln`` (elementwise
affine); ``ln_nonparam`` (OLMo's LayerNorm without parameters: its state
dict is empty, as the JAX entry is an empty dict)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .common import wide, with_axes


def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6,
                  plus_one: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = wide(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    s = scale.to(xf.dtype)
    return (xf * torch.rsqrt(var + eps) * (1.0 + s if plus_one else s)).to(dt)


def layernorm_apply(scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                    x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm; with no scale and bias it is OLMo's non-parametric LN."""
    dt = x.dtype
    xf = wide(x)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.to(xf.dtype) + bias.to(xf.dtype)
    return y.to(dt)


class RMSNorm(nn.Module):
    """RMSNorm (eps 1e-6) computed in f32; ``plus_one``: the scale starts at
    zeros and multiplies as 1 + w."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32,
                 plus_one: bool = False):
        super().__init__()
        self.plus_one = plus_one
        init = torch.zeros if plus_one else torch.ones
        self.scale = with_axes(init(dim, device=device, dtype=dtype), ("norm",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(self.scale, x, plus_one=self.plus_one)


class LayerNorm(nn.Module):
    """LayerNorm (eps 1e-5) computed in f32, elementwise affine unless
    ``elementwise=False`` (no parameters at all)."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32,
                 elementwise: bool = True):
        super().__init__()
        self.scale = self.bias = None
        if elementwise:
            self.scale = with_axes(torch.ones(dim, device=device, dtype=dtype), ("norm",))
            self.bias = with_axes(torch.zeros(dim, device=device, dtype=dtype), ("norm",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_apply(self.scale, self.bias, x)


def make_norm(kind: str, dim: int, *, device=None, dtype=torch.float32) -> nn.Module:
    """The norm a config names: ``rms``, ``rms_plus_one``, ``ln`` or
    ``ln_nonparam``."""
    if kind in ("rms", "rms_plus_one"):
        return RMSNorm(dim, device=device, dtype=dtype, plus_one=kind == "rms_plus_one")
    if kind in ("ln", "ln_nonparam"):
        return LayerNorm(dim, device=device, dtype=dtype, elementwise=kind == "ln")
    raise ValueError(f"unknown norm {kind!r}; one of 'rms', 'rms_plus_one', "
                     "'ln', 'ln_nonparam'")
