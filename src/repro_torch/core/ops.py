"""Real-valued operations over GOOMs (paper §3), on torch tensors.

Multiplication over R is addition over C' (Example 1); sums over R are
signed log-sum-exp (Example 2); matrix products are LMME (eq. 9).

  * ``lmme_naive``      — the exact eq. 9 (O(n*d*m) space); test oracle only.
  * ``lmme_reference``  — the paper's compromise (eq. 10-12): per-row and
                          per-column max scaling plus one real matmul.  It is
                          the plain version the CUDA LMME kernel is held to.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from .goom import Goom, from_goom, nonzero_sign, safe_abs, safe_log

__all__ = [
    "goom_mul",
    "goom_neg",
    "goom_add",
    "goom_sub",
    "goom_scale",
    "goom_lse",
    "goom_dot",
    "goom_matmul",
    "goom_norm",
    "goom_normalize_cols",
    "lmme_naive",
    "lmme_reference",
    "scaled_exp",
]

Dims = Union[None, int, Sequence[int]]


def _dims(x: torch.Tensor, dim: Dims):
    if dim is None:
        return tuple(range(x.ndim))
    return dim


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def goom_mul(a: Goom, b: Goom) -> Goom:
    """x*y over R == elementwise addition over C' (Example 1)."""
    return Goom(a.log_abs + b.log_abs, a.sign * b.sign)


def goom_neg(a: Goom) -> Goom:
    return Goom(a.log_abs, -a.sign)


def goom_scale(a: Goom, log_c) -> Goom:
    """Multiply by a positive constant exp(log_c): a shift in log space."""
    return Goom(a.log_abs + log_c, a.sign)


def goom_lse(a: Goom, dim: Dims = None, keepdim: bool = False) -> Goom:
    """Signed log-sum-exp over ``dim``: log|sum(sign*exp(log_abs))| + sign.

    The max is detached (paper: scaling constants sit outside the graph),
    and an all-zero slice (max == -inf) is scaled by 0 so -inf - m is no NaN.
    """
    dims = _dims(a.log_abs, dim)
    m = _finite_or_zero(torch.amax(a.log_abs, dim=dims, keepdim=True).detach())
    t = torch.sum(a.sign * torch.exp(a.log_abs - m), dim=dims, keepdim=True)
    out_log = safe_log(safe_abs(t)) + m
    out_sign = nonzero_sign(t)
    if not keepdim:
        out_log = out_log.squeeze(dims)
        out_sign = out_sign.squeeze(dims)
    return Goom(out_log, out_sign)


def goom_add(a: Goom, b: Goom) -> Goom:
    """x+y over R == signed LSE of the two GOOMs (Example 2 with d=2)."""
    return goom_lse(Goom(torch.stack([a.log_abs, b.log_abs]),
                         torch.stack([a.sign, b.sign])), dim=0)


def goom_sub(a: Goom, b: Goom) -> Goom:
    return goom_add(a, goom_neg(b))


def goom_dot(a: Goom, b: Goom) -> Goom:
    """Dot product of two 1-D GOOM vectors (Example 2)."""
    return goom_lse(goom_mul(a, b), dim=-1)


def lmme_naive(a: Goom, b: Goom) -> Goom:
    """Exact eq. 9: LSE over the full (..., n, d, m) sum tensor.

    O(n*d*m) memory: the test oracle.  Batch dims broadcast like matmul."""
    z_log = a.log_abs[..., :, :, None] + b.log_abs[..., None, :, :]
    z_sign = a.sign[..., :, :, None] * b.sign[..., None, :, :]
    return goom_lse(Goom(z_log, z_sign), dim=-2)


def lmme_reference(a: Goom, b: Goom, *, clip_at_zero: bool = False) -> Goom:
    """The paper's compromise LMME (eq. 10-12), batch dims broadcast.

    Each row of ``a`` and column of ``b`` is scaled by the detached max of
    its log-magnitudes (the raw max; ``clip_at_zero=True`` is the paper's
    ``max(., 0)``, which lets tiny rows underflow), one real f32 matmul runs
    on the exponentiated signed values, and the scaling is undone in log
    space.
    """
    ai = _finite_or_zero(torch.amax(a.log_abs, dim=-1, keepdim=True).detach())
    bk = _finite_or_zero(torch.amax(b.log_abs, dim=-2, keepdim=True).detach())
    if clip_at_zero:
        ai = ai.clamp_min(0.0)
        bk = bk.clamp_min(0.0)
    ar = a.sign * torch.exp(a.log_abs - ai)
    br = b.sign * torch.exp(b.log_abs - bk)
    prod = torch.matmul(ar, br)
    out_log = safe_log(safe_abs(prod)) + ai + bk  # eq. 10 un-scaling
    return Goom(out_log, nonzero_sign(prod))


def goom_matmul(a: Goom, b: Goom) -> Goom:
    """The default LMME entry point: the compromise (the engine's ``lmme``
    runs the kernel)."""
    return lmme_reference(a, b)


def goom_norm(a: Goom, dim: Dims = -1, keepdim: bool = False) -> torch.Tensor:
    """log of the L2 norm over ``dim``: 0.5 * LSE(2*log_abs)."""
    doubled = Goom(2.0 * a.log_abs, torch.ones_like(a.sign))
    return 0.5 * goom_lse(doubled, dim=dim, keepdim=keepdim).log_abs


def goom_normalize_cols(a: Goom) -> Goom:
    """Log-scale the columns of a (..., d, k) GOOM matrix to log-unit norms.

    The norm is detached; all-zero columns (norm == -inf) are left unscaled
    to avoid -inf - -inf."""
    ln = _finite_or_zero(goom_norm(a, dim=-2, keepdim=True).detach())
    return Goom(a.log_abs - ln, a.sign)


def scaled_exp(a: Goom, dim: Dims = None, shift: float = 2.0,
               reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """exp(x' - max + shift): a bounded map back to floats (paper eq. 27).
    ``reduce_max`` maps the local max to the one over every rank's part
    (heads split across ranks).

    Returns ``(values, log_scale)`` so callers can undo the scaling."""
    dims = _dims(a.log_abs, dim)
    m = torch.amax(a.log_abs, dim=dims, keepdim=True).detach()
    c = _finite_or_zero(m if reduce_max is None else reduce_max(m))
    vals = from_goom(Goom(a.log_abs - c + shift, a.sign))
    return vals, c - shift
