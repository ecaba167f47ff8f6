"""Parallel prefix scans of linear recurrences over GOOMs (paper §4.2, §5).

Counterpart of ``repro/core/scan.py``: the plain PyTorch scans that are both
the CPU path and the oracle of the CUDA diagonal- and matrix-scan kernels.  Application
code calls ``repro_torch.core.engine``, which dispatches between these and
the kernels; the ``matmul=`` keywords are the engine's plumbing.

Scans run over the leading axis (time).  For ``X_t = A_t X_{t-1} ⊕ B_t`` the
combine of an earlier compound ``(A_e, B_e)`` with a later one ``(A_l, B_l)``
is ``(A_l ∘ A_e, A_l ∘ B_e ⊕ B_l)`` (∘ = LMME for matrices, the elementwise
GOOM product for a diagonal recurrence; ⊕ = signed LSE).

:func:`associative_scan` brackets exactly as ``jax.lax.associative_scan``
does, so every interim compound is the one JAX forms.  Selective resetting
inspects interim compounds, so its reset flags depend on the bracketing:
with JAX's tree they can be held equal to JAX's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from .goom import Goom, from_goom, goom_zeros, to_goom
from .ops import goom_add, goom_mul, goom_normalize_cols, lmme_reference

__all__ = [
    "associative_scan",
    "diagonal_scan",
    "matrix_scan",
    "cumulative_lmme",
    "selective_reset_scan",
    "colinearity_select",
    "orthonormal_reset",
]

Matmul = Callable[[Goom, Goom], Goom]
Elems = Union[torch.Tensor, Sequence[torch.Tensor]]


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a0 b0 a1 b1 ... along dim 0; ``a`` is as long as ``b`` or one longer."""
    nb = b.shape[0]
    out = torch.stack([a[:nb], b], dim=1).flatten(0, 1)
    return torch.cat([out, a[nb:]]) if a.shape[0] > nb else out


def associative_scan(fn: Callable, elems: Elems):
    """Inclusive scan over dim 0 with the associative ``fn(earlier, later)``.

    ``elems`` is a tensor or a tuple of tensors sharing dim 0; ``fn`` takes
    and returns the same kind, batched over dim 0.  The recursion is
    ``jax.lax.associative_scan``'s: combine adjacent pairs, scan the
    result, then fill in the even positions, with the same pairing for odd
    and even lengths.
    """
    single = isinstance(elems, torch.Tensor)

    def combine(e, l):
        out = fn(e[0], l[0]) if single else fn(tuple(e), tuple(l))
        return (out,) if single else tuple(out)

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        odd = scan(combine(tuple(x[0:-1:2] for x in xs), tuple(x[1::2] for x in xs)))
        later = tuple(x[2::2] for x in xs)
        if later[0].shape[0] == 0:  # n == 2: no even position past the first
            even = tuple(x[:1] for x in xs)
        else:
            earlier = odd if n % 2 else tuple(o[:-1] for o in odd)
            even = tuple(torch.cat([x[:1], c]) for x, c in zip(xs, combine(earlier, later)))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan((elems,) if single else tuple(elems))
    return out[0] if single else out


# ---------------------------------------------------------------------------
# diagonal recurrence:  x_t = a_t ⊙ x_{t-1} ⊕ b_t   (Mamba, SSMs)
# ---------------------------------------------------------------------------
def _diag_combine(e, l):
    a_e, b_e = Goom(e[0], e[1]), Goom(e[2], e[3])
    a_l, b_l = Goom(l[0], l[1]), Goom(l[2], l[3])
    a = goom_mul(a_l, a_e)
    b = goom_add(goom_mul(a_l, b_e), b_l)
    return a.log_abs, a.sign, b.log_abs, b.sign


def diagonal_scan(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
    """All states of the diagonal GOOM recurrence, via associative scan.

    a, b: GOOMs of one shape with a leading time axis (T, ...); x0: (...)
    entering state (default zero).  Returns the (T, ...) states."""
    al, asn, bl, bsn = associative_scan(
        _diag_combine, (a.log_abs, a.sign, b.log_abs, b.sign))
    b_star = Goom(bl, bsn)
    if x0 is None:
        return b_star
    x0b = Goom(x0.log_abs.expand(al.shape), x0.sign.expand(al.shape))
    return goom_add(goom_mul(Goom(al, asn), x0b), b_star)


# ---------------------------------------------------------------------------
# non-diagonal recurrence:  X_t = A_t X_{t-1} ⊕ B_t   (paper §4.3 RNN)
# ---------------------------------------------------------------------------
def _matrix_combine(matmul: Matmul):
    def combine(e, l):
        a_e, b_e = Goom(e[0], e[1]), Goom(e[2], e[3])
        a_l, b_l = Goom(l[0], l[1]), Goom(l[2], l[3])
        a = matmul(a_l, a_e)
        b = goom_add(matmul(a_l, b_e), b_l)
        return a.log_abs, a.sign, b.log_abs, b.sign

    return combine


def matrix_scan(a: Goom, b: Goom, x0: Optional[Goom] = None, *,
                matmul: Matmul = lmme_reference) -> Goom:
    """All states of X_t = A_t X_{t-1} ⊕ B_t.

    a: (T, ..., d, d) transitions; b: (T, ..., d, m) biases; x0: (..., d, m)
    entering state (default zero).  Returns the (T, ..., d, m) states."""
    al, asn, bl, bsn = associative_scan(
        _matrix_combine(matmul), (a.log_abs, a.sign, b.log_abs, b.sign))
    b_star = Goom(bl, bsn)
    if x0 is None:
        return b_star
    shape = (al.shape[0],) + tuple(x0.shape)
    x0b = Goom(x0.log_abs.expand(shape), x0.sign.expand(shape))
    return goom_add(matmul(Goom(al, asn), x0b), b_star)


def cumulative_lmme(a: Goom, *, matmul: Matmul = lmme_reference) -> Goom:
    """PSCAN(LMME): all prefix products A_t···A_1 (paper eq. 24's scan)."""

    def combine(e, l):
        out = matmul(Goom(*l), Goom(*e))
        return out.log_abs, out.sign

    return Goom(*associative_scan(combine, (a.log_abs, a.sign)))


# ---------------------------------------------------------------------------
# selective resetting (paper §5)
# ---------------------------------------------------------------------------
def _where_goom(cond: torch.Tensor, x: Goom, y: Goom) -> Goom:
    c = cond[..., None, None]
    return Goom(torch.where(c, x.log_abs, y.log_abs), torch.where(c, x.sign, y.sign))


def selective_reset_scan(
    a: Goom,
    select_fn: Callable[[Goom], torch.Tensor],
    reset_fn: Callable[[Goom], Goom],
    *,
    matmul: Matmul = lmme_reference,
    reset_only_state_compounds: bool = True,
    assoc_scan: Callable = associative_scan,
) -> Tuple[Goom, torch.Tensor]:
    """Prefix scan of X_t = A_t X_{t-1} with conditional resets (paper §5).

    a: (T, ..., d, d) GOOM transitions, the initial state folded in as
    element 0 (paper App. C).  ``select_fn`` maps a batched GOOM matrix to a
    bool (...,); ``reset_fn`` maps it to its replacement.  Returns (states,
    was_reset flags).  The combine is eq. 28: an earlier compound that is
    selected and not yet reset becomes (0, R(A*_e)), then the ordinary
    recurrence runs.  ``reset_only_state_compounds`` resets only compounds
    that contain element 0, i.e. actual deviation states (see the JAX
    package's docstring for why).  ``assoc_scan`` runs the scan (the engine
    passes the sequence-sharded one under a mesh).
    """
    zeros = goom_zeros(a.shape, a.dtype, device=a.device)

    def combine(e, l):
        a_e, b_e = Goom(e[0], e[1]), Goom(e[2], e[3])
        a_l, b_l = Goom(l[0], l[1]), Goom(l[2], l[3])
        e_reset, e_x0 = e[4], e[5]
        eligible = ~e_reset
        if reset_only_state_compounds:
            eligible = eligible & e_x0
        do_reset = select_fn(a_e) & eligible
        zero = goom_zeros(a_e.shape, a_e.dtype, device=a_e.log_abs.device)
        b_e = _where_goom(do_reset, reset_fn(a_e), b_e)
        a_e = _where_goom(do_reset, zero, a_e)
        a_out = matmul(a_l, a_e)
        b_out = goom_add(matmul(a_l, b_e), b_l)
        return (a_out.log_abs, a_out.sign, b_out.log_abs, b_out.sign,
                e_reset | do_reset | l[4], e_x0 | l[5])

    flags = torch.zeros(a.shape[:-2], dtype=torch.bool, device=a.device)
    contains_x0 = flags.clone()
    contains_x0[0] = True
    out = assoc_scan(combine, (a.log_abs, a.sign, zeros.log_abs,
                               zeros.sign, flags, contains_x0))
    # X_t = A*_t ⊕ B*_t: un-reset, B* is zero and the LSE returns A*; reset,
    # A* has been zeroed and the LSE returns B*
    states = goom_add(Goom(out[0], out[1]), Goom(out[2], out[3]))
    return states, out[4]


# ---------------------------------------------------------------------------
# selection / reset functions of the Lyapunov pipeline (paper §4.2.1a)
# ---------------------------------------------------------------------------
def colinearity_select(threshold: float = 0.99) -> Callable[[Goom], torch.Tensor]:
    """True where any pair of state columns has |cosine similarity| > threshold."""

    def select(a: Goom) -> torch.Tensor:
        v = from_goom(goom_normalize_cols(a))  # unit columns: safe to exp
        gram = torch.einsum("...ij,...ik->...jk", v, v)
        d = gram.shape[-1]
        off = gram.abs() * (1.0 - torch.eye(d, dtype=gram.dtype, device=gram.device))
        return torch.amax(off, dim=(-2, -1)) > threshold

    return select


def orthonormal_reset() -> Callable[[Goom], Goom]:
    """Replace a near-colinear state with an orthonormal basis of its span."""

    def reset(a: Goom) -> Goom:
        q, _ = torch.linalg.qr(from_goom(goom_normalize_cols(a)))
        return to_goom(q)

    return reset
