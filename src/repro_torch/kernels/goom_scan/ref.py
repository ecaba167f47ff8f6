"""Plain PyTorch versions of the scan kernels, at their calling conventions.

Matrix scan: a (T, ..., d, d), b (T, ..., d, m) or None, x0 (..., d, m).

``matrix_scan_ref`` is the port of the JAX package's chunked reference
(``repro/kernels/dispatch.py::_matrix_ref_chunked``, chunk 128): the full
associative scan inside each chunk of ``chunk`` steps, the state carried
from chunk to chunk.  ``matrix_scan_zero_b_ref`` is its B = 0 form, the
prefix products folded with X_0, as the JAX zero-B kernel's backward
computes it.

Diagonal scan: a and b (T, ...) broadcast to one shape, x0 (...).
``goom_diag_scan_ref`` is ``core.scan.diagonal_scan``, the associative scan
bracketed as ``jax.lax.associative_scan``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.goom import Goom
from ...core.ops import lmme_reference
from ...core.scan import cumulative_lmme, diagonal_scan, matrix_scan

__all__ = ["REF_CHUNK", "goom_diag_scan_ref", "matrix_scan_ref",
           "matrix_scan_zero_b_ref"]

#: the JAX reference's time chunk (``repro/kernels/blocks.py::_REF_MAT``)
REF_CHUNK = 128


def _expand(g: Goom, shape) -> Goom:
    return Goom(g.log_abs.expand(shape), g.sign.expand(shape))


def _cat(gs) -> Goom:
    return Goom(torch.cat([g.log_abs for g in gs]), torch.cat([g.sign for g in gs]))


def matrix_scan_ref(a: Goom, b: Goom, x0: Optional[Goom] = None,
                    chunk: int = REF_CHUNK) -> Goom:
    """All states of X_t = A_t X_{t-1} ⊕ B_t, chunked over time; ``x0=None``
    starts from exact zeros (log -inf, sign +1)."""
    t = b.shape[0]
    batch = torch.broadcast_shapes(a.shape[1:-2], b.shape[1:-2])
    a = _expand(a, (t,) + batch + tuple(a.shape[-2:]))
    b = _expand(b, (t,) + batch + tuple(b.shape[-2:]))
    if x0 is not None:
        x0 = _expand(x0, batch + tuple(b.shape[-2:]))
    if t <= chunk or t % chunk:
        return matrix_scan(a, b, x0, matmul=lmme_reference)
    if x0 is None:
        shape = batch + tuple(b.shape[-2:])
        x0 = Goom(torch.full(shape, -torch.inf, device=b.device),
                  torch.ones(shape, device=b.device))
    states = []
    for k in range(0, t, chunk):
        st = matrix_scan(a[k:k + chunk], b[k:k + chunk], x0, matmul=lmme_reference)
        x0 = st[-1]
        states.append(st)
    return _cat(states)


def matrix_scan_zero_b_ref(a: Goom, x0: Goom) -> Goom:
    """X_t = (A_t ··· A_1) X_0: the prefix products, then one LMME with x0."""
    return lmme_reference(cumulative_lmme(a, matmul=lmme_reference), x0)


def goom_diag_scan_ref(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
    """Plain version of the diagonal-scan kernel: ``core.scan.diagonal_scan``
    (the JAX package's ``goom_diag_scan_ref``) on ``a`` and ``b`` broadcast
    to a common (T, ...) shape, ``x0`` to its trailing dims."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    x0 = None if x0 is None else _expand(x0, shape[1:])
    return diagonal_scan(_expand(a, shape), _expand(b, shape), x0)
