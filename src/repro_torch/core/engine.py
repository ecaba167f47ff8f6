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

**Launch knobs** (``kernels/blocks.py``) resolve per call in this order:
``use_blocks`` overrides, the autotune cache (``autotune()``,
``kernels/autotune.py``), the defaults; no caller names a block size::

    with engine.use_blocks(matrix_scan={"block_t": 8}):
        out = engine.matrix_scan(a, b)   # the with-B kernel at L = 8

**Sequence-sharded scans** (``kernels/sharded.py``) run under a mesh, in
this order of precedence:

  1. ``use_mesh(mesh, seq_axis=...)``: an explicit mesh (a
     ``sharding.NamedMesh`` or a ``DeviceMesh`` with axis names);
  2. active ``sharding.rules`` whose ``scan_seq`` logical axis maps to a
     mesh axis (``scan_batch`` gives the batch axes);
  3. otherwise, or with ``seq_shards=1`` or a 1-sized axis, local scans
     (``seq_shards="auto"`` falls back silently; an explicit count with no
     mesh raises).

``use_mesh(None)`` turns sharding off in its scope.  Two forms of operands:

  * plain tensors: every rank of the seq group runs the same op on the same
    full-length operands and gets the full states back;
  * DTensors sharded along time over the seq axis (what the models hand the
    engine under the launcher's rules, ``sharding/layout.py``): each rank
    holds and scans its time shard and gets its shard's states back, as
    JAX's ``shard_map`` (``local_map`` around the dispatch-resolved local
    implementation; the CUDA kernels see local tensors only).

``calls`` counts engine op calls, so a run can show that every one of them
reached a kernel: ``calls["lmme"]`` against ``lmme_cuda.launches``,
``calls["diagonal_scan"]`` against ``diagonal_scan_cuda.launches``,
``calls["matrix_scan"]`` against ``matrix_scan_cuda.launches`` and
``calls["cumulative_lmme"]`` against ``matrix_scan_cuda.launches_zero_b``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from ..sharding.rules import is_dtensor
from . import scan as _scan
from .goom import Goom

__all__ = ["EngineConfig", "set_default_backend", "use_backend", "use_blocks", "use_mesh", "current_backend",
           "get_config", "resolved_backend", "active_seq_shards", "autotune", "lmme",
           "diagonal_scan", "diagonal_scan_carry", "matrix_scan", "matrix_scan_carry",
           "cumulative_lmme", "selective_reset_scan", "calls", "reset_calls"]

# (op, backend or "*", BlockConfig) override entries; later entries win
_BlockEntry = Tuple[str, str, Any]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The engine's scoped settings: the backend, ``use_blocks`` entries and
    the mesh of sharded scans."""

    backend: str = "auto"
    blocks: Tuple[_BlockEntry, ...] = ()
    mesh: Optional[Any] = None            # sharding.NamedMesh; None -> the rules
    seq_axis: Optional[str] = None        # the mesh axis carrying time shards
    batch_axis: Union[None, str, Tuple[str, ...]] = None
    seq_shards: Union[str, int] = "auto"  # "auto" | 1 (off) | the axis size


_DEFAULT = EngineConfig()
_STACK: list = []

#: engine op calls since the last ``reset_calls()``
calls: Dict[str, int] = {"lmme": 0, "diagonal_scan": 0, "diagonal_scan_carry": 0,
                         "matrix_scan": 0, "matrix_scan_carry": 0,
                         "cumulative_lmme": 0, "selective_reset_scan": 0}


def reset_calls() -> None:
    for op in calls:
        calls[op] = 0


def get_config() -> EngineConfig:
    return _STACK[-1] if _STACK else _DEFAULT


def current_backend() -> str:
    return get_config().backend


@contextlib.contextmanager
def _push(cfg: EngineConfig):
    _STACK.append(cfg)
    try:
        yield cfg
    finally:
        _STACK.pop()


def _check_backend(backend: str) -> None:
    from ..kernels.dispatch import CONCRETE_BACKENDS

    if backend != "auto" and backend not in CONCRETE_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{['auto'] + CONCRETE_BACKENDS}")


def set_default_backend(backend: str) -> None:
    """Set the process-wide default backend (what runs outside any
    ``use_backend`` scope)."""
    global _DEFAULT
    _check_backend(backend)
    _DEFAULT = dataclasses.replace(_DEFAULT, backend=backend)


@contextlib.contextmanager
def use_backend(backend: str = "auto", **overrides):
    """Scoped backend override: ``auto``, ``torch_reference`` or ``cuda``;
    ``overrides`` set other fields of the config (e.g. ``seq_shards``)."""
    _check_backend(backend)
    with _push(dataclasses.replace(get_config(), backend=backend, **overrides)) as cfg:
        yield cfg


@contextlib.contextmanager
def use_blocks(_backend: str = "*", **per_op):
    """Scoped per-op launch knobs: keywords are engine ops, values dicts of
    ``BlockConfig`` fields (or ``BlockConfig``s).  ``_backend`` limits them
    to one concrete backend.  Inner scopes win field by field over outer
    ones, which win over the autotune cache and the defaults."""
    from ..kernels.blocks import OPS, BlockConfig

    entries = []
    for op, fields in per_op.items():
        if op not in OPS:
            raise ValueError(f"unknown engine op {op!r}; one of {OPS}")
        cfg = fields if isinstance(fields, BlockConfig) else BlockConfig(**fields)
        entries.append((op, _backend, cfg))
    base = get_config()
    with _push(dataclasses.replace(base, blocks=base.blocks + tuple(entries))) as cfg:
        yield cfg


@contextlib.contextmanager
def use_mesh(mesh, *, seq_axis: Optional[str] = None,
             batch_axis: Union[None, str, Tuple[str, ...]] = None,
             seq_shards: Union[str, int] = "auto", **overrides):
    """Scoped mesh for sequence-sharded scans.  ``seq_axis`` defaults to the
    axis named ``"seq"`` when there is one, else the last axis; ``mesh=None``
    turns sharding off in the scope."""
    from ..sharding.mesh import as_named_mesh

    mesh = as_named_mesh(mesh)
    if mesh is not None and seq_axis is None:
        names = tuple(mesh.axis_names)
        seq_axis = "seq" if "seq" in names else names[-1]
    cfg = dataclasses.replace(get_config(), mesh=mesh, seq_axis=seq_axis,
                              batch_axis=batch_axis,
                              seq_shards=1 if mesh is None else seq_shards, **overrides)
    with _push(cfg) as cfg:
        yield cfg


def _block_overrides(cfg: EngineConfig, op: str, resolved: str,
                     shapes: Optional[Tuple[int, ...]]):
    """The active ``use_blocks`` entries for (op, resolved) merged over the
    cache winner or the default, or None (dispatch then reads the cache)."""
    matches = [entry for (o, b, entry) in cfg.blocks if o == op and b in ("*", resolved)]
    if not matches:
        return None
    from ..kernels.autotune import cached_blocks
    from ..kernels.blocks import merge

    out = cached_blocks(op, resolved, shapes)
    for entry in matches:
        out = merge(out, entry)
    return out


def resolved_backend(dtype: Optional[torch.dtype] = None,
                     device_type: Optional[str] = None) -> str:
    """The backend the current config resolves to for planes of ``dtype``
    (f32) on ``device_type`` (the card when there is one, else the CPU)."""
    from ..kernels import dispatch

    return dispatch.resolve_backend(
        get_config().backend, device_type=device_type or dispatch.current_platform(),
        dtype=torch.float32 if dtype is None else dtype)


def _resolved_shard():
    """The ShardSpec the current config resolves to, or None (local)."""
    cfg = get_config()
    if cfg.seq_shards == 1:
        return None
    mesh, seq_axis, batch_axis = cfg.mesh, cfg.seq_axis, cfg.batch_axis
    if mesh is None:
        from ..sharding.rules import current_rules

        active = current_rules()
        if active is not None:
            seq = active.mesh_axes_for("scan_seq")
            if seq:
                mesh, seq_axis = active.mesh, seq[0]
                if batch_axis is None:
                    batch_axis = active.mesh_axes_for("scan_batch")
    if mesh is None or seq_axis is None:
        if isinstance(cfg.seq_shards, int) and cfg.seq_shards > 1:
            raise ValueError(
                f"seq_shards={cfg.seq_shards} requested but no mesh is active "
                "(use engine.use_mesh or sharding rules with a scan_seq mapping)")
        return None
    from ..kernels.sharded import ShardSpec

    n = int(mesh.shape[seq_axis])
    if cfg.seq_shards not in ("auto", n):
        raise ValueError(f"seq_shards={cfg.seq_shards} does not match mesh axis "
                         f"{seq_axis!r} of size {n}")
    if n == 1:
        return None
    batch_axes = (batch_axis,) if isinstance(batch_axis, str) else tuple(batch_axis or ())
    return ShardSpec(mesh, seq_axis, batch_axes)


def active_seq_shards() -> int:
    """How many sequence shards the current config resolves to (1: local).
    Model code reads it to hand the engine one full-length scan."""
    shard = _resolved_shard()
    return 1 if shard is None else shard.n_shards


def _impl(op: str, a: Goom, hint: Callable[[], Tuple[int, ...]]):
    """Count a call of ``op`` and return the implementation that runs it;
    ``hint()`` gives the problem dims the cache is keyed on (read after the
    backend resolved, which raises first on planes no backend takes)."""
    from ..kernels import dispatch

    cfg = get_config()
    resolved = dispatch.resolve_backend(
        cfg.backend, device_type=a.log_abs.device.type, dtype=a.dtype)
    calls[op] += 1
    shapes = hint()
    dt = is_dtensor(a.log_abs)
    shard = None if op == "lmme" else _resolved_shard()
    if dt and shard is None:
        raise ValueError(f"{op}: DTensor operands need sharding rules whose scan_seq "
                         "maps to a mesh axis")
    return dispatch.get_impl(op, resolved,
                             blocks=_block_overrides(cfg, op, resolved, shapes),
                             shard=shard, shapes=shapes, time_sharded=dt)



def autotune(ops: Optional[Tuple[str, ...]] = None, *, backend: Optional[str] = None,
             shapes: Optional[Mapping[str, Tuple[int, ...]]] = None, reps: int = 3,
             cache_path: Optional[str] = None, verbose: bool = False) -> Dict[str, dict]:
    """Sweep the launch knobs of each op (default: all four) on the backend
    the config resolves to (the card's kernels when there is one) and
    persist the winners; later engine calls on matching shape buckets use
    them.  ``shapes`` maps op -> problem dims (``autotune.DEFAULT_SHAPES``'
    conventions).  Returns each op's report, its table of candidates."""
    from ..kernels import autotune as _autotune
    from ..kernels.blocks import OPS

    backend = backend or resolved_backend()
    reports = {}
    for op in ops or OPS:
        if op not in OPS:
            raise ValueError(f"unknown engine op {op!r}; one of {OPS}")
        reports[op] = r = _autotune.autotune_op(
            op, backend, (shapes or {}).get(op), reps=reps, path=cache_path,
            verbose=verbose)
        if verbose:
            print(f"autotune[{op}/{backend}]: {r['blocks']} ({r['ms']:.4f} ms) -> "
                  f"{r['key']}", flush=True)
    return reports


def lmme(a: Goom, b: Goom) -> Goom:
    """LMME over GOOMs: (..., n, d) ∘ (..., d, m), batch dims broadcast."""
    return _impl("lmme", a, lambda: (a.shape[-2], a.shape[-1], b.shape[-1]))(a, b)


def diagonal_scan(a: Goom, b: Goom, x0: Optional[Goom] = None) -> Goom:
    """All states of x_t = a_t ⊙ x_{t-1} ⊕ b_t over the leading axis: a and
    b (T, ...) broadcast to one shape, x0 (...) or None (zeros)."""
    def hint():
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return (shape[0], math.prod(shape[1:]) if shape[1:] else 1)

    return _impl("diagonal_scan", a, hint)(a, b, x0)


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
    return _impl("matrix_scan", a, lambda: (a.shape[0], a.shape[-1], b.shape[-1]))(a, b, x0)


def matrix_scan_carry(a: Goom, b: Goom, x0: Optional[Goom] = None
                      ) -> Tuple[Goom, Goom]:
    """``(states, final state)``: feed a chunk with the previous chunk's
    carry as ``x0``; the concatenated chunk states equal one full scan."""
    calls["matrix_scan_carry"] += 1
    states = matrix_scan(a, b, x0)
    return states, states[-1]


def cumulative_lmme(a: Goom) -> Goom:
    """All prefix products A_t ··· A_1 (paper eq. 24's scan)."""
    return _impl("cumulative_lmme", a, lambda: (a.shape[0], a.shape[-1]))(a)


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
    the card is one launch of the LMME kernel.

    Under a mesh the whole associative scan is time-sharded
    (``seq_sharded_associative_scan``) when T is a multiple of the shard
    count, else it runs locally (the reset monoid has no identity to pad
    with).  The reset positions depend on the bracketing, so a sharded run
    equals JAX's sharded run at the same shard count, not the local one."""
    calls["selective_reset_scan"] += 1
    shard = _resolved_shard()
    assoc = _scan.associative_scan
    if shard is not None and a.shape[0] % shard.n_shards == 0 \
            and a.shape[0] >= shard.n_shards:
        from ..kernels.sharded import seq_sharded_associative_scan

        def assoc(fn, elems, _spec=shard):
            return seq_sharded_associative_scan(fn, elems, spec=_spec)

    return _scan.selective_reset_scan(
        a, select_fn, reset_fn, matmul=lmme,
        reset_only_state_compounds=reset_only_state_compounds, assoc_scan=assoc)
