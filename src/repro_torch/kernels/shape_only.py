"""Kernel calls on FakeTensor operands: shapes, no launch.

Under ``FakeTensorMode`` (the dry-run's cost pass, ``launch/cost.py``) the
operands of a kernel wrapper are FakeTensors, which have no memory to hand
a kernel.  On any device (the pass runs on a fake CPU device with the
engine's ``cuda`` backend: a CPU-only build of torch cannot index fake CUDA
tensors), the wrappers then take the card's path up to the launch: they
check the operands, copy those whose strides the kernel cannot take (the
matrix scan's ``copies`` counter counts these copies, as on the card),
allocate the outputs (and the zero-B scan's scratch) as on the card, and
their autograd functions save what they save there; then they report the
call through :func:`record` and return without launching.  Their
``launches`` counters do not move.  Real CPU operands still take the plain
versions, and real CUDA operands still launch.

``listening(fn)`` calls ``fn(kernel, dims)`` for every such call made
inside it; ``kernel`` is ``"lmme"``, ``"matrix_scan"``,
``"matrix_scan_zero_b"`` or ``"diag_scan"``, and ``dims`` the call's
dimensions (``launch/roofline.py``'s work formulas read them).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["is_fake", "listening", "record"]

_listener: Optional[Callable[[str, Dict[str, object]], None]] = None


def is_fake(x: torch.Tensor) -> bool:
    """Whether ``x`` is a FakeTensor (shape, dtype and device, no data)."""
    return isinstance(x, FakeTensor)


def record(kernel: str, **dims) -> None:
    """Report one shape-only call of ``kernel`` to the listener, if any."""
    if _listener is not None:
        _listener(kernel, dims)


@contextlib.contextmanager
def listening(fn: Callable[[str, Dict[str, object]], None]):
    """Call ``fn(kernel, dims)`` for each shape-only kernel call inside (in
    place of any listener outside)."""
    global _listener
    prev, _listener = _listener, fn
    try:
        yield
    finally:
        _listener = prev
