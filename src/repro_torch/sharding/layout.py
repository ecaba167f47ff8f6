"""JAX's sharding specs as DTensor placements.

A spec from ``AxisRules.spec`` names, per tensor dim, the mesh axes that
split it; DTensor names, per mesh dim, the tensor dim it splits.
:func:`placements` turns one into the other: ``Shard(d)`` on every mesh
dim named on tensor dim ``d``, ``Replicate()`` elsewhere.  An entry of
two axes such as ``("pod", "data")`` splits one tensor dim over two mesh
dims, the first named the major one, which is DTensor's order when the
entry follows the mesh's axis order (the rules' tables always do).
:func:`shard_shape` and :func:`shard_slice` give what a device holds under
placements on a mesh of any size, with no process group (the tests hold
them to JAX's ``NamedSharding`` on the production meshes).

**Time shards.**  Under rules that map ``scan_seq`` to a mesh axis of a
``DeviceMesh`` (the launcher's ``--seq-shards``), the models' activations
stay plain tensors, each rank's slice of the batch and whole along time,
and :func:`time_shards` gives the layer that turns a recurrent layer's
inputs into this rank's time shard (``TimeShards.shard``, a constrain to
``("batch", "scan_seq", ...)``: a slice, no collective), hands the engine
its scan operands as DTensors sharded along time (``TimeShards.wrap``),
and gathers the layer's output back along time (``TimeShards.gather``, a
constrain to ``act_seq``, which JAX's table leaves unsharded: an
all-gather).  A parameter read inside a rank's time shard goes through
``TimeShards.replicated``: its gradient is summed over the seq group.
The autograd of all four is DTensor's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .rules import AxisRules, Spec, constrain, current_rules

__all__ = ["placements", "shard_shape", "shard_slice", "TimeShards", "time_shards"]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_dims(axis_names: Sequence[str], spec: Spec) -> Tuple[Tuple[int, ...], ...]:
    """Per tensor dim of ``spec``, the mesh dims that split it, major first."""
    out = []
    for d, entry in enumerate(spec):
        idx = tuple(list(axis_names).index(a) for a in _axes(entry))
        if list(idx) != sorted(idx):
            raise NotImplementedError(
                f"spec entry {entry!r} of dim {d} names mesh axes against the mesh's "
                f"order {tuple(axis_names)}; DTensor splits in mesh order")
        out.append(idx)
    return tuple(out)


def placements(axis_names: Sequence[str], spec: Spec):
    """The DTensor placements (one per mesh dim) of a JAX spec."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(axis_names)
    for d, dims in enumerate(mesh_dims(axis_names, spec)):
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh_shape) -> Tuple[int, ...]:
    """The per-device block of an array of ``shape`` laid out by ``spec`` on a
    mesh of ``mesh_shape`` (name -> size), padded up as JAX pads an uneven
    split (``NamedSharding.shard_shape``)."""
    names = list(mesh_shape)
    dims = mesh_dims(names, spec) + ((),) * (len(shape) - len(spec))
    return tuple(-(-n // math.prod(mesh_shape[names[i]] for i in ds))
                 for n, ds in zip(shape, dims))


def shard_slice(shape: Sequence[int], spec: Spec, mesh_shape,
                coord: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(start, stop) per dim of the block the device at mesh coordinate
    ``coord`` holds; the split must be even."""
    names = list(mesh_shape)
    dims = mesh_dims(names, spec) + ((),) * (len(shape) - len(spec))
    out = []
    for n, ds in zip(shape, dims):
        parts, idx = 1, 0
        for i in ds:
            parts, idx = parts * mesh_shape[names[i]], idx * mesh_shape[names[i]] + coord[i]
        if n % parts:
            raise ValueError(f"dim {n} does not split evenly into {parts}")
        size = n // parts
        out.append((idx * size, (idx + 1) * size))
    return tuple(out)


class TimeShards:
    """The seq group's time shards of a recurrent layer (module docstring)."""

    def __init__(self, rules: AxisRules, seq_axis: str):
        self.device_mesh = rules.mesh.device_mesh
        self.names = tuple(rules.mesh.axis_names)
        self.seq = self.names.index(seq_axis)
        self.n = int(rules.mesh.shape[seq_axis])
        dims = lambda name: tuple(self.names.index(a) for a in rules.mesh_axes_for(name)
                                  if a in self.names)
        self.batch, self.scan_batch = dims("batch"), dims("scan_batch")
        if seq_axis in rules.mesh_axes_for("act_seq"):
            raise NotImplementedError("the port's activations are whole along time: "
                                      "act_seq must not map to the scan_seq axis")

    def _dtensor(self, x: torch.Tensor, pl):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(x, self.device_mesh, pl, run_check=False)

    def _placements(self, time: Optional[int] = None, batch: Optional[int] = 0,
                    batch_dims: Tuple[int, ...] = ()):
        """``batch`` over ``batch_dims`` (the launcher's split of the batch),
        ``time`` (if any) over the seq axis, the rest replicated."""
        from torch.distributed.tensor import Replicate, Shard

        pl = [Shard(batch) if i in batch_dims and batch is not None else Replicate()
              for i in range(len(self.names))]
        if time is not None:
            pl[self.seq] = Shard(time)
        return tuple(pl)

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's time shard of ``x`` (batch first, whole along time on
        every rank of the group): ``dim`` padded at its end to a multiple of
        the shard count, then cut into equal shards of ⌈T/P⌉."""
        pad = -x.shape[dim] % self.n
        if pad:
            x = F.pad(x, (0, 0) * (x.ndim - 1 - dim) + (0, pad))
        names = ["batch"] + [None] * (x.ndim - 1)
        names[dim] = "scan_seq"
        return constrain(self._dtensor(x, self._placements(batch_dims=self.batch)),
                         *names).to_local()

    def gather(self, x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
        """The inverse of :meth:`shard`: every rank's shard of ``x`` along
        ``dim``, cut back to ``length``."""
        names = ["batch"] + [None] * (x.ndim - 1)
        names[dim] = "act_seq"
        full = constrain(self._dtensor(x, self._placements(dim, batch_dims=self.batch)),
                         *names).to_local()
        return full.narrow(dim, 0, length)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is; its gradient is summed over the seq group."""
        from torch.distributed.tensor import Partial

        grad = list(self._placements())
        grad[self.seq] = Partial()
        return self._dtensor(x, self._placements()).to_local(grad_placements=grad)

    def wrap(self, g, time: int = 0, batch: Optional[int] = None):
        """A Goom of local time shards as DTensors: ``time`` over the seq
        axis, ``batch`` (if any) over the ``scan_batch`` axes."""
        from ..core.goom import Goom

        pl = self._placements(time, batch, self.scan_batch)
        return Goom(self._dtensor(g.log_abs, pl), self._dtensor(g.sign, pl))

    @staticmethod
    def local(g):
        """A Goom of DTensors as this rank's local tensors."""
        from ..core.goom import Goom

        return Goom(g.log_abs.to_local(), g.sign.to_local())


def time_shards() -> Optional[TimeShards]:
    """The active rules' time shards, or None: no rules, ``scan_seq``
    unmapped or on a 1-sized axis, an abstract mesh, or an engine scope that
    sets its own mesh (``engine.use_mesh``, which keeps full-length
    operands)."""
    rules = current_rules()
    if rules is None or getattr(rules.mesh, "device_mesh", None) is None:
        return None
    seq = rules.mesh_axes_for("scan_seq")
    if not seq or rules.mesh.shape[seq[0]] == 1:
        return None
    from ..core import engine

    cfg = engine.get_config()
    if cfg.mesh is not None or cfg.seq_shards == 1:
        return None
    return TimeShards(rules, seq[0])
