"""Backend registry and resolution for the port's engine ops.

**Resolution** maps a requested backend to the one that runs, from the
operands' device and dtype:

  requested         device   dtype     resolved
  ---------         ------   -----     --------
  auto              cuda     float32   cuda             (hand-written kernel)
  auto              cuda     other     raises: the kernels take f32 only
  auto              cpu      any       torch_reference
  torch_reference   any      any       torch_reference  (plain PyTorch)
  cuda              any      any       cuda             (plain version on CPU
                                                         tensors, kernel on
                                                         CUDA tensors)

A CUDA tensor never falls back to the plain version on its own: only a
caller's ``use_backend("torch_reference")`` puts it there.

**Registry**: implementations are registered per ``(op, backend)`` with
:func:`register_impl` as factories of the launch knobs (a
``blocks.BlockConfig``): ``lmme``, ``diagonal_scan``, ``matrix_scan`` and
``cumulative_lmme``, each on both backends.  :func:`register_backend` adds
a concrete backend at run time (an experimental one), which must cover
every op.  :func:`get_impl` resolves the
knobs (``use_blocks`` overrides, the autotune cache, the defaults) and,
under a mesh, wraps a scan in its sequence-sharded form.  Both ``diagonal_scan``
implementations broadcast ``a`` and ``b`` to a common shape, as the JAX
package's do.  On ``cuda``, ``cumulative_lmme`` is the zero-B
matrix-scan kernel with X_0 = I, as in the JAX package.

The platform (is there a card at all?) is read once per process by
:func:`current_platform`.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import scan
from ..core.goom import Goom
from ..core.ops import lmme_reference
from .blocks import DEFAULTS, OPS, BlockConfig
from .goom_scan import (
    REF_CHUNK,
    diagonal_scan_cuda,
    goom_diag_scan_ref,
    matrix_scan_cuda,
    matrix_scan_ref,
)
from .lmme import lmme_cuda

__all__ = ["BACKENDS", "CONCRETE_BACKENDS", "current_platform", "resolve_device",
           "resolve_backend", "register_backend", "register_impl", "registered_backends",
           "registered_impls", "get_impl"]

#: the backends a name resolves to; ``register_backend`` appends to it
CONCRETE_BACKENDS = ["torch_reference", "cuda"]
#: the built-in names (the launcher's choices)
BACKENDS = ("auto",) + tuple(CONCRETE_BACKENDS)


@functools.lru_cache(maxsize=None)
def current_platform() -> str:
    """``"cuda"`` when the process sees a CUDA card, else ``"cpu"``; read once."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when ``cuda`` is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and current_platform() != "cuda":
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def resolve_backend(requested: str, *, device_type: str,
                    dtype: torch.dtype = torch.float32) -> str:
    """Resolve a requested backend name to a registered one (table above)."""
    if requested in CONCRETE_BACKENDS:
        return requested
    if requested != "auto":
        raise ValueError(f"unknown backend {requested!r}; one of "
                         f"{['auto'] + CONCRETE_BACKENDS}")
    if device_type == "cpu":
        return "torch_reference"
    if device_type == "cuda":
        if dtype == torch.float32:
            return "cuda"
        raise TypeError(
            f"no CUDA kernel takes {dtype} planes (float32 only); cast the "
            "operands or request use_backend('torch_reference')")
    raise ValueError(f"no backend for device type {device_type!r}")


_Impl = Callable
_REGISTRY: Dict[Tuple[str, str], _Impl] = {}


def register_impl(op: str, *backends: str):
    """Decorator: register ``factory(blocks) -> impl`` for ``op`` on each
    named backend."""

    def deco(factory: Callable[[BlockConfig], _Impl]):
        for backend in backends:
            _REGISTRY[(op, backend)] = factory
        return factory

    return deco


def register_backend(name: str, impls: Dict[str, Callable[[BlockConfig], _Impl]]) -> None:
    """Add the concrete backend ``name`` at run time (an experimental one):
    ``impls`` maps every engine op to its ``factory(blocks)``.  A backend
    that misses an op is refused, so that resolution never lands on a hole;
    its launch knobs default to an empty ``BlockConfig``."""
    missing = set(OPS) - set(impls)
    if missing:
        raise ValueError(f"backend {name!r} missing impls for {sorted(missing)}")
    if name not in CONCRETE_BACKENDS:
        CONCRETE_BACKENDS.append(name)
    for op, factory in impls.items():
        _REGISTRY[(op, name)] = factory
        DEFAULTS.setdefault((op, name), BlockConfig())


def registered_backends(op: str) -> Tuple[str, ...]:
    return tuple(b for (o, b) in _REGISTRY if o == op)


def registered_impls() -> Tuple[Tuple[str, str], ...]:
    """Every registered ``(op, backend)`` pair, sorted."""
    return tuple(sorted(_REGISTRY))


# Each registered entry is a factory: ``factory(blocks) -> impl``, the
# implementation with the launch knobs of ``blocks`` bound.
register_impl("lmme", "torch_reference")(lambda blocks: lmme_reference)
register_impl("lmme", "cuda")(lambda blocks: lmme_cuda)
register_impl("diagonal_scan", "torch_reference")(lambda blocks: goom_diag_scan_ref)
register_impl("diagonal_scan", "cuda")(lambda blocks: diagonal_scan_cuda)


def _chunk(blocks: BlockConfig, t: int) -> Optional[int]:
    """The time chunk L a ``cuda`` scan launches with: T for ``algo="seq"``,
    else ``block_t`` (None: the kernel's default for (T, d))."""
    return max(t, 1) if blocks.algo == "seq" else blocks.block_t


@register_impl("matrix_scan", "torch_reference")
def _matrix_scan_ref(blocks: BlockConfig):
    chunk = blocks.block_t or REF_CHUNK

    def ref(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
        return matrix_scan_ref(a, b, x0, chunk=chunk)

    return ref


@register_impl("matrix_scan", "cuda")
def _matrix_scan_cuda(blocks: BlockConfig):
    if blocks.block_t is None and blocks.algo is None:
        return matrix_scan_cuda   # the default L for (T, d)

    def f(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
        return matrix_scan_cuda(a, b, x0, ell=_chunk(blocks, b.shape[0]))

    return f


@register_impl("cumulative_lmme", "torch_reference")
def _cumulative_lmme_ref(blocks: BlockConfig):
    return lambda a: scan.cumulative_lmme(a, matmul=lmme_reference)


@register_impl("cumulative_lmme", "cuda")
def _cumulative_lmme_cuda(blocks: BlockConfig):
    def f(a: Goom) -> Goom:
        """A_t···A_1 as the B = 0 recurrence from X_0 = I: only the (d, d)
        identity is built (0 on the diagonal, -inf off it), no B operand."""
        d, dev = a.shape[-1], a.log_abs.device
        eye = torch.eye(d, dtype=torch.bool, device=dev)
        x0 = Goom(torch.zeros(d, d, device=dev).masked_fill(~eye, -torch.inf),
                  torch.ones(d, d, device=dev))
        return matrix_scan_cuda(a, None, x0, ell=_chunk(blocks, a.shape[0]))

    return f


def _make(op: str, resolved: str, blocks: Optional[BlockConfig],
          shapes: Optional[Tuple[int, ...]]) -> _Impl:
    if blocks is None:
        from . import autotune   # autotune imports this module for timing

        blocks = autotune.cached_blocks(op, resolved, shapes)
    try:
        factory = _REGISTRY[(op, resolved)]
    except KeyError:
        raise KeyError(
            f"no implementation registered for op {op!r} on backend "
            f"{resolved!r}; registered: {registered_backends(op)}") from None
    return factory(blocks)


def get_impl(op: str, resolved: str, blocks: Optional[BlockConfig] = None,
             shard=None, shapes: Optional[Tuple[int, ...]] = None,
             time_sharded: bool = False) -> _Impl:
    """The callable that runs ``op`` on the resolved backend.

    ``blocks`` pins the launch knobs; None reads the autotune cache for
    ``(op, resolved, device_kind, shape_bucket(shapes))`` and falls back to
    the defaults (``blocks.DEFAULTS``).  ``shard`` (a
    ``kernels.sharded.ShardSpec``) wraps a scan op's local implementation
    in the sequence-sharded algebra of ``kernels/sharded.py``; ``lmme`` is
    not a scan and ignores it.  Inside a shard, the local zero-B scan runs
    at its default L and the stitch's LMME is this backend's.
    ``time_sharded``: the operands are DTensors sharded along time over the
    shard's seq axis, and so are the states returned (``local_map`` around
    the local algebra, JAX's ``shard_map``); else every rank holds the
    full-length operands and gets the full-length states back."""
    base = _make(op, resolved, blocks, shapes)
    if shard is None or op == "lmme":
        return base
    from . import sharded   # collectives only where a shard asks for them

    if op == "diagonal_scan":
        f = sharded.mapped_diagonal_scan if time_sharded else sharded.seq_sharded_diagonal_scan
        return lambda a, b, x0=None: f(a, b, x0, spec=shard, local_diagonal_scan=base)
    lmme_impl = _make("lmme", resolved, None, None)
    if op == "matrix_scan":
        cum = _make("cumulative_lmme", resolved, None, None)
        f = sharded.mapped_matrix_scan if time_sharded else sharded.seq_sharded_matrix_scan
        return lambda a, b, x0=None: f(a, b, x0, spec=shard, local_matrix_scan=base,
                                       local_cumulative_lmme=cum, lmme=lmme_impl)
    assert op == "cumulative_lmme", op
    f = sharded.mapped_cumulative_lmme if time_sharded else sharded.seq_sharded_cumulative_lmme
    return lambda a: f(a, spec=shard, local_cumulative_lmme=base, lmme=lmme_impl)
