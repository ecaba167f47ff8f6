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
``scan_batch`` from the active rules (``core/engine.py``).  JAX's
``constrain`` and ``param_shardings`` (activation constraints and parameter
layouts) wait for DTensor layouts.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

__all__ = ["AxisRules", "DEFAULT_RULES", "MULTIPOD_RULES", "make_rules", "use_rules",
           "current_rules", "logical_to_spec"]


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
