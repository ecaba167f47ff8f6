"""Engine ops with backend dispatch: the one door every GOOM product goes
through.

This slice carries ``lmme(a, b)``, log-matmul-exp (paper eq. 9).  The
backend is picked per call from the operands (see
``repro_torch.kernels.dispatch``): ``auto`` runs the CUDA kernel on CUDA
f32 planes and the plain PyTorch version on CPU planes.  Override it in a
scope::

    from repro_torch.core import engine

    with engine.use_backend("torch_reference"):
        out = engine.lmme(a, b)      # plain PyTorch, even on the card

``calls`` counts engine op calls, so a run can show that every one of them
reached a kernel (compare with ``lmme_cuda.launches``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

from .goom import Goom

__all__ = ["use_backend", "current_backend", "lmme", "calls", "reset_calls"]

_STACK: List[str] = []

#: engine op calls since the last ``reset_calls()``
calls: Dict[str, int] = {"lmme": 0}


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


def lmme(a: Goom, b: Goom) -> Goom:
    """LMME over GOOMs: (..., n, d) ∘ (..., d, m), batch dims broadcast."""
    from ..kernels import dispatch

    resolved = dispatch.resolve_backend(
        current_backend(), device_type=a.log_abs.device.type, dtype=a.dtype)
    calls["lmme"] += 1
    return dispatch.get_impl("lmme", resolved)(a, b)
