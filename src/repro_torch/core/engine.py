"""Engine ops with backend dispatch: the one door every GOOM product and
scan goes through.

  * ``lmme(a, b)``                 log-matmul-exp (paper eq. 9);
  * ``diagonal_scan(a, b, x0)``    all states of x_t = a_t ⊙ x_{t-1} ⊕ b_t,
                                   the diagonal-scan kernel;
  * ``diagonal_scan_carry(a, b, x0)`` the same with the last state as a
                                   carry, for chunked ingestion;
  * ``matrix_scan(a, b, x0)``      all states of X_t = A_t X_{t-1} ⊕ B_t
                                   (eq. 26), the fused matrix-scan kernel;
  * ``matrix_scan_carry(a, b, x0)`` the same with the last state as a carry,
                                   for chunked ingestion;
  * ``cumulative_lmme(a)``         all prefix products A_t···A_1 (eq. 24's
                                   scan), the kernel's zero-B form;
  * ``selective_reset_scan(...)``  the resetting scan of §5, its products
                                   through ``lmme``.

The backend is picked per call from the operands (see
``repro_torch.kernels.dispatch``): ``auto`` runs the CUDA kernels on CUDA
f32 planes and the plain PyTorch versions on CPU planes.  Override it in a
scope::

    from repro_torch.core import engine

    with engine.use_backend("torch_reference"):
        out = engine.lmme(a, b)      # plain PyTorch, even on the card

``calls`` counts engine op calls, so a run can show that every one of them
reached a kernel: ``calls["lmme"]`` against ``lmme_cuda.launches``,
``calls["diagonal_scan"]`` against ``diagonal_scan_cuda.launches``,
``calls["matrix_scan"]`` against ``matrix_scan_cuda.launches`` and
``calls["cumulative_lmme"]`` against ``matrix_scan_cuda.launches_zero_b``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import scan as _scan
from .goom import Goom

__all__ = ["use_backend", "current_backend", "lmme", "diagonal_scan",
           "diagonal_scan_carry", "matrix_scan", "matrix_scan_carry", "cumulative_lmme", "selective_reset_scan",
           "calls", "reset_calls"]

_STACK: List[str] = []

#: engine op calls since the last ``reset_calls()``
calls: Dict[str, int] = {"lmme": 0, "diagonal_scan": 0, "diagonal_scan_carry": 0,
                         "matrix_scan": 0, "matrix_scan_carry": 0,
                         "cumulative_lmme": 0, "selective_reset_scan": 0}


def reset_calls() -> None:
    for op in calls:
        calls[op] = 0


def current_backend() -> str:
    return _STACK[-1] if _STACK else "auto"


@contextlib.contextmanager
def use_backend(backend: str = "auto"):
    """Scoped backend override: ``auto``, ``torch_reference`` or ``cuda``."""
    from ..kernels.dispatch import BACKENDS

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    _STACK.append(backend)
    try:
        yield backend
    finally:
        _STACK.pop()


def _impl(op: str, a: Goom):
    """Count a call of ``op`` and return the implementation that runs it."""
    from ..kernels import dispatch

    resolved = dispatch.resolve_backend(
        current_backend(), device_type=a.log_abs.device.type, dtype=a.dtype)
    calls[op] += 1
    return dispatch.get_impl(op, resolved)


def lmme(a: Goom, b: Goom) -> Goom:
    """LMME over GOOMs: (..., n, d) ∘ (..., d, m), batch dims broadcast."""
    return _impl("lmme", a)(a, b)


def diagonal_scan(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
    """All states of x_t = a_t ⊙ x_{t-1} ⊕ b_t over the leading axis: a and
    b (T, ...) broadcast to one shape, x0 (...) or None (zeros)."""
    return _impl("diagonal_scan", a)(a, b, x0)


def diagonal_scan_carry(a: Goom, b: Goom, x0: Optional[Goom] = None
                        ) -> Tuple[Goom, Goom]:
    """``(states, final state)``: feed a chunk with the previous chunk's
    carry as ``x0``; the concatenated chunk states equal one full scan."""
    calls["diagonal_scan_carry"] += 1
    states = diagonal_scan(a, b, x0)
    return states, states[-1]


def matrix_scan(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
    """All states of X_t = A_t X_{t-1} ⊕ B_t over the leading axis: a
    (T, ..., d, d), b (T, ..., d, m), x0 (..., d, m) or None (zeros)."""
    return _impl("matrix_scan", a)(a, b, x0)


def matrix_scan_carry(a: Goom, b: Goom, x0: Optional[Goom] = None
                      ) -> Tuple[Goom, Goom]:
    """``(states, final state)``: feed a chunk with the previous chunk's
    carry as ``x0``; the concatenated chunk states equal one full scan."""
    calls["matrix_scan_carry"] += 1
    states = matrix_scan(a, b, x0)
    return states, states[-1]


def cumulative_lmme(a: Goom) -> Goom:
    """All prefix products A_t ··· A_1 (paper eq. 24's scan)."""
    return _impl("cumulative_lmme", a)(a)


def selective_reset_scan(
    a: Goom,
    select_fn: Callable[[Goom], torch.Tensor],
    reset_fn: Callable[[Goom], Goom],
    *,
    reset_only_state_compounds: bool = True,
) -> Tuple[Goom, torch.Tensor]:
    """Selective-resetting scan (paper §5).  The reset combine is
    data-dependent control flow in plain PyTorch; its matrix products, where
    the flops are, go through :func:`lmme`, so each is counted there and on
    the card is one launch of the LMME kernel."""
    calls["selective_reset_scan"] += 1
    return _scan.selective_reset_scan(
        a, select_fn, reset_fn, matmul=lmme,
        reset_only_state_compounds=reset_only_state_compounds)
