"""RMSNorm and LayerNorm with JAX-package semantics: statistics in f32,
the result cast back to the input's dtype (``repro/models/norms.py``)."""

from __future__ import annotations

import torch
from torch import nn


def rmsnorm_apply(scale: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layernorm_apply(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                    *, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


class RMSNorm(nn.Module):
    """RMSNorm (eps 1e-6) computed in f32."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm_apply(self.scale, x)


class LayerNorm(nn.Module):
    """Elementwise-affine LayerNorm (eps 1e-5) computed in f32."""

    def __init__(self, dim: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_apply(self.scale, self.bias, x)


def make_norm(kind: str, dim: int, *, device=None, dtype=torch.float32) -> nn.Module:
    """The norm a config names: ``rms`` or ``ln``."""
    if kind == "rms":
        return RMSNorm(dim, device=device, dtype=dtype)
    if kind == "ln":
        return LayerNorm(dim, device=device, dtype=dtype)
    raise ValueError(f"unknown norm {kind!r}; the port builds 'rms' and 'ln'")
