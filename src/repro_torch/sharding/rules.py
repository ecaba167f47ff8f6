"""Logical-axis sharding rules (MaxText-style), mapped onto a mesh.

The port's copy of ``repro/sharding/rules.py``, plain Python.  Every
parameter and activation is named by *logical* axes ("embed", "mlp",
"heads", "batch", ...); an :class:`AxisRules` table maps each logical name
to zero or more *mesh* axes, per array with a divisibility check: a mesh
axis that does not divide the dim is dropped (explicit replication), unless
``allow_uneven`` keeps a padded split that wastes under 25 %.

The mesh is anything with JAX's ``mesh.shape`` mapping from axis name to
size: a ``sharding.mesh.NamedMesh`` over a ``DeviceMesh``, or an abstract
one.  ``AxisRules.spec`` returns a tuple of per-dim entries (an axis name,
a tuple of names, or None; trailing Nones stripped), the values of JAX's
``PartitionSpec``.

Mesh axes:
  * single-pod:  ("data", "model")            = (16, 16)
  * multi-pod:   ("pod", "data", "model")     = (2, 16, 16)

The engine reads ``scan_seq`` (sequence-sharded GOOM scans, opt-in) and
``scan_batch`` from the active rules (``core/engine.py``).

Layouts (``sharding/layout.py`` turns a spec into DTensor placements):
``param_placements(rules, model)`` is JAX's ``param_shardings``, a spec per
parameter from its logical axes without ``allow_uneven`` (an indivisible
axis drops out); ``distribute_model`` places the parameters so.
``constrain(x, *names)`` is JAX's activation constraint: without active
rules, or on a plain tensor, it returns ``x``; on a DTensor it
redistributes to the spec *with* ``allow_uneven``.  The single-process
paths (serving and its CUDA graphs among them) see plain tensors only.
The split of heads, channels and the vocabulary across the ranks of a
mesh axis does not live in ``constrain``: each split module computes its
block of plain tensors and all-reduces what leaves it
(``sharding/tensor_parallel.py``), on the axis ``AxisRules.split_axis``
names.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

__all__ = ["AxisRules", "DEFAULT_RULES", "MULTIPOD_RULES", "make_rules", "use_rules",
           "current_rules", "logical_to_spec", "constrain", "param_specs",
           "param_placements", "distribute_model"]


class AxisRules:
    """A mapping logical-axis name -> mesh axes, bound to a mesh."""

    def __init__(self, mesh, table: Dict[str, MeshAxes]):
        self.mesh = mesh
        self.table = dict(table)

    def mesh_axes_for(self, name: Optional[str]) -> Tuple[str, ...]:
        if name is None:
            return ()
        v = self.table.get(name, None)
        if v is None:
            return ()
        if isinstance(v, str):
            return (v,)
        return tuple(v)

    def axis_size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def spec(self, shape: Sequence[int], names: Sequence[Optional[str]], *,
             allow_uneven: bool = False) -> Spec:
        """Per-dim mesh axes for ``shape`` given logical ``names`` per dim.

        Never maps one mesh axis to two dims (the first dim wins).  Mesh axes
        that do not divide the dim are dropped, except with ``allow_uneven``,
        where a padded split that wastes under 25 % is kept."""
        if len(shape) != len(names):
            raise ValueError(f"shape {tuple(shape)} and names {tuple(names)} differ in length")
        used: set = set()
        entries = []
        for dim, name in zip(shape, names):
            axes = [a for a in self.mesh_axes_for(name) if a not in used]
            kept = []
            prod = 1
            for a in axes:
                n = prod * self.mesh.shape[a]
                if dim % n == 0:
                    kept.append(a)
                    prod = n
                elif allow_uneven and dim >= n:
                    padded = -(-dim // n) * n
                    if (padded - dim) / dim < 0.25:
                        kept.append(a)
                        prod = n
            used.update(kept)
            if not kept:
                entries.append(None)
            elif len(kept) == 1:
                entries.append(kept[0])
            else:
                entries.append(tuple(kept))
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def split_axis(self, name: str, n: int, *, scans: bool = False) -> Optional[str]:
        """The mesh axis the logical activation ``name`` (a dim of ``n``) is
        split on across ranks, or None: ``spec(..., allow_uneven=True)``'s
        axis, where it is one axis of more than one rank.  Heads and
        channels split only where they divide it; the vocabulary
        (``act_vocab``) keeps a padded uneven split.  ``scans``: None where
        ``scan_seq`` maps to the same axis (the recurrent layers then
        time-shard with whole heads; ``sharding/tensor_parallel.py``)."""
        spec = self.spec((n,), (name,), allow_uneven=True)
        if not spec or spec[0] is None:
            return None
        axes = (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])
        if len(axes) != 1:
            raise NotImplementedError(f"{name!r} split over several mesh axes {axes}")
        axis, size = axes[0], self.mesh.shape[axes[0]]
        if size == 1 or (name != "act_vocab" and n % size):
            return None
        if scans and axis in self.mesh_axes_for("scan_seq"):
            return None
        return axis


def _base_table(batch_axes: Tuple[str, ...]) -> Dict[str, MeshAxes]:
    return {
        # activations
        "batch": batch_axes,
        "act_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_expert": "data",
        "cache_seq": None,
        # scan engine
        "scan_seq": None,             # sequence-sharded GOOM scans (opt-in)
        "scan_batch": batch_axes,
        # parameters
        "embed": "data",
        "vocab": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "qkv_embed": "data",
        "expert": "data",
        "expert_mlp": "model",
        "state": None,
        "conv": None,
        "layers": None,
        "periods": None,
        "norm": None,
    }


def DEFAULT_RULES(mesh) -> AxisRules:
    """Single-pod rules: batch over ("data",)."""
    return AxisRules(mesh, _base_table(("data",)))


def MULTIPOD_RULES(mesh) -> AxisRules:
    """Multi-pod rules: batch over ("pod", "data")."""
    return AxisRules(mesh, _base_table(("pod", "data")))


def make_rules(mesh, overrides: Optional[Dict[str, MeshAxes]] = None) -> AxisRules:
    table = _base_table(("pod", "data") if "pod" in mesh.shape else ("data",))
    if overrides:
        table.update(overrides)
    return AxisRules(mesh, table)


_ACTIVE = threading.local()


def current_rules() -> Optional[AxisRules]:
    return getattr(_ACTIVE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    prev = current_rules()
    _ACTIVE.rules = rules
    try:
        yield rules
    finally:
        _ACTIVE.rules = prev


def logical_to_spec(rules: AxisRules, shape, names) -> Spec:
    return rules.spec(shape, names)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing torch.distributed)."""
    return type(x).__name__ == "DTensor"


def constrain(x, *names: Optional[str]):
    """Redistribute a DTensor to the active rules' spec for ``names`` (uneven
    splits allowed); anything else, and everything without rules, as it is.
    A split module's plain activations are its rank's block already
    (``sharding/tensor_parallel.py``), so they pass through."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    from .layout import placements

    spec = rules.spec(x.shape, names, allow_uneven=True)
    return x.redistribute(x.device_mesh, placements(rules.mesh.axis_names, spec))


def param_specs(rules: AxisRules, model) -> Dict[str, Spec]:
    """Each parameter's spec (state-dict name -> spec) from its logical axes
    (``model.param_axes()``), indivisible axes dropped: JAX's
    ``param_shardings``."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return {n: rules.spec(shapes[n], axes) for n, axes in model.param_axes().items()}


def param_placements(rules: AxisRules, model) -> Dict[str, tuple]:
    """Each parameter's DTensor placements over ``rules.mesh``."""
    from .layout import placements

    return {n: placements(rules.mesh.axis_names, spec)
            for n, spec in param_specs(rules, model).items()}


def distribute_model(model, rules: AxisRules):
    """Replace every parameter of ``model`` by a DTensor laid out by
    :func:`param_placements` over ``rules.mesh``'s ``DeviceMesh`` (each rank
    keeps its own block of the values it holds, a copy, and moves nothing:
    every rank must hold the same values, as a model built from one seed
    does).  Returns ``model``."""
    import torch
    from torch.distributed.tensor import DTensor

    mesh = rules.mesh.device_mesh
    if mesh is None:
        raise ValueError("distribute_model needs a NamedMesh over a DeviceMesh")
    pl = param_placements(rules, model)
    for name, p in list(model.named_parameters()):
        owner, leaf = _owner(model, name)
        local = p.detach()
        for i, place in enumerate(pl[name]):   # nested in mesh order, as DTensor splits
            if place.is_shard():
                n = mesh.size(i)
                if local.shape[place.dim] % n:
                    raise ValueError(f"{name}: dim {place.dim} of {tuple(local.shape)} does "
                                     f"not split over {n}")
                k = local.shape[place.dim] // n
                local = local.narrow(place.dim, mesh.get_local_rank(i) * k, k)
        dt = DTensor.from_local(local.clone(memory_format=torch.contiguous_format), mesh,
                                pl[name], run_check=False, shape=p.shape, stride=p.stride())
        setattr(owner, leaf, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def _owner(model, name: str):
    *path, leaf = name.split(".")
    mod = model
    for k in path:
        mod = getattr(mod, k) if not k.isdigit() else mod[int(k)]
    return mod, leaf
