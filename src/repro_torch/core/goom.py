"""Generalized orders of magnitude (GOOMs) in PyTorch: the split representation.

A real number x is held as the pair ``Goom(log_abs, sign)``: ``log_abs`` is
log|x| and ``sign`` is a float plane in {+1, -1}, the layout of the JAX
package (``repro.core.goom``).  Derivatives follow the paper:

  eq. (5)  d/dx abs(x)   := sign(x), with sign(0) := +1   (never zero)
  eq. (6)  d/dx log(x)   := 1 / (x + eps)                 (finite at 0)
  eq. (8)  d/dx' exp(x') := exp(x') +/- eps               (never zero)

each as a ``torch.autograd.Function``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "Goom",
    "to_goom",
    "from_goom",
    "safe_abs",
    "safe_log",
    "signed_exp",
    "nonzero_sign",
    "finite_floor",
    "goom_zeros",
    "goom_ones",
    "goom_from_complex",
    "goom_to_complex",
    "LOG_ZERO",
]

# log(0) stand-in per dtype: 2*log(smallest normal), paper footnote 5.  Planes
# narrower than f32 (bf16, f16) cannot hold their own floor and use the f32
# one, as the JAX package does.
_F32_FLOOR = 2.0 * math.log(torch.finfo(torch.float32).tiny)
_FINITE_FLOOR = {
    torch.float32: _F32_FLOOR,
    torch.float64: 2.0 * math.log(torch.finfo(torch.float64).tiny),
}

LOG_ZERO = _F32_FLOOR


def finite_floor(dtype: torch.dtype) -> float:
    """The finite value that stands for log(0) in a ``dtype`` log plane."""
    return _FINITE_FLOOR.get(dtype, _F32_FLOOR)


def _eps(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).eps


@dataclasses.dataclass(frozen=True)
class Goom:
    """Split-representation GOOM: real = sign * exp(log_abs).

    Both planes share one shape; broadcasting happens in the ops."""

    # goomcheck seeds each plane's domain from this tag (analysis/lattice.py)
    _goomcheck_domains = ("log", "sign")

    log_abs: torch.Tensor
    sign: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.log_abs.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.log_abs.dtype

    @property
    def device(self) -> torch.device:
        return self.log_abs.device

    def __getitem__(self, idx) -> "Goom":
        return Goom(self.log_abs[idx], self.sign[idx])


def nonzero_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(0) := +1, as a float plane in {+1, -1}."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x >= 0, one, -one)


class _SafeAbs(torch.autograd.Function):
    """|x| with derivative sign(x), sign(0) := +1 (paper eq. 5)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * nonzero_sign(x)


class _SafeLog(torch.autograd.Function):
    """log(x), optionally floored; derivative 1/(x + eps) (paper eq. 6)."""

    @staticmethod
    def forward(ctx, x, use_floor):
        ctx.save_for_backward(x)
        out = torch.log(x)
        if use_floor:
            floor = finite_floor(x.dtype)
            out = torch.where(x == 0, torch.full_like(out, floor), out)
            out = out.clamp_min(floor)
        return out

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / (x + _eps(x.dtype)), None


class _SignedExp(torch.autograd.Function):
    """sign * exp(log_abs); derivative exp(x') +/- eps (paper eq. 8).

    The sign plane is a constant {+1, -1} and gets no gradient."""

    @staticmethod
    def forward(ctx, log_abs, sign):
        y = sign * torch.exp(log_abs)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        eps = _eps(y.dtype)
        shifted = y + torch.where(y >= 0, eps, -eps)
        return grad * shifted, None


def safe_abs(x: torch.Tensor) -> torch.Tensor:
    return _SafeAbs.apply(x)


def safe_log(x: torch.Tensor, use_floor: bool = False) -> torch.Tensor:
    return _SafeLog.apply(x, use_floor)


def signed_exp(log_abs: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    return _SignedExp.apply(log_abs, sign)


def to_goom(x: torch.Tensor, *, use_floor: bool = False) -> Goom:
    """Map a real tensor to its GOOM (paper eq. 4); bf16 is widened to f32.
    A complex tensor is read as the paper's complex form
    (``goom_from_complex``)."""
    if x.is_complex():
        return goom_from_complex(x)
    xf = x.float() if x.dtype == torch.bfloat16 else x
    return Goom(safe_log(safe_abs(xf), use_floor), nonzero_sign(xf))


def from_goom(g: Goom) -> torch.Tensor:
    """Map a GOOM back to a real tensor (paper eq. 7: the real part)."""
    return signed_exp(g.log_abs, g.sign)


def goom_from_complex(z: torch.Tensor) -> Goom:
    """From the paper's complex formulation: x' = log|x| + k·pi·i.  The sign
    is +1 where cos(imag) >= 0, else -1 (snapping numerical error to the
    convention)."""
    re = z.real
    sign = torch.where(torch.cos(z.imag) >= 0, 1.0, -1.0).to(re.dtype)
    return Goom(re, sign)


def goom_to_complex(g: Goom) -> torch.Tensor:
    """To the paper's complex formulation, on the principal branch (imag in
    {0, pi}): complex64 for f32 planes, else complex128."""
    real = torch.float32 if g.dtype == torch.float32 else torch.float64
    pi = torch.full_like(g.log_abs, math.pi)      # pi rounded to the planes' dtype
    imag = torch.where(g.sign < 0, pi, torch.zeros_like(pi)).to(real)
    return torch.complex(g.log_abs.to(real), imag)


def goom_zeros(shape, dtype=torch.float32, *, device, use_floor: bool = False) -> Goom:
    """GOOM of real 0: log_abs = -inf, or the finite floor with ``use_floor``."""
    la = finite_floor(dtype) if use_floor else -math.inf
    return Goom(torch.full(shape, la, dtype=dtype, device=device),
                torch.ones(shape, dtype=dtype, device=device))


def goom_ones(shape, dtype=torch.float32, *, device) -> Goom:
    return Goom(torch.zeros(shape, dtype=dtype, device=device),
                torch.ones(shape, dtype=dtype, device=device))
