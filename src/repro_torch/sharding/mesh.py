"""A device mesh seen as JAX sees one: axis names and a name → size map.

``torch.distributed``'s ``DeviceMesh`` gives its sizes as a tuple
(``mesh.shape``) and its axis names apart (``mesh_dim_names``); the rules
(``sharding/rules.py``) and the engine read ``mesh.shape[axis]`` and
``mesh.axis_names`` as JAX's ``Mesh`` offers them.  :class:`NamedMesh`
offers both over a ``DeviceMesh``, whose process groups the sharded scans'
collectives run over (``get_group``), or over no processes at all (an
abstract mesh: sizes and names only, as ``jax.sharding.AbstractMesh``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["NamedMesh", "as_named_mesh"]


class NamedMesh:
    """Axis names, their sizes, and the ``DeviceMesh`` behind them (None for
    an abstract mesh)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 device_mesh: Optional[Any] = None):
        if len(sizes) != len(axis_names):
            raise ValueError(f"sizes {tuple(sizes)} and axis names {tuple(axis_names)} "
                             "differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(n) for n in sizes)))
        self.device_mesh = device_mesh

    @classmethod
    def of(cls, device_mesh) -> "NamedMesh":
        """Wrap a ``torch.distributed.device_mesh.DeviceMesh`` with axis names."""
        names = device_mesh.mesh_dim_names
        if names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        return cls(tuple(device_mesh.shape), names, device_mesh)

    def _mesh(self):
        if self.device_mesh is None:
            raise ValueError("an abstract NamedMesh has no process groups")
        return self.device_mesh

    def get_group(self, axis: str):
        """The process group of this rank along ``axis``."""
        return self._mesh().get_group(axis)

    def get_local_rank(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return int(self._mesh().get_local_rank(axis))

    def __repr__(self):
        kind = "abstract" if self.device_mesh is None else "device"
        return f"NamedMesh({self.shape}, {kind})"


def as_named_mesh(mesh) -> Optional[NamedMesh]:
    """``mesh`` as a :class:`NamedMesh`: a ``NamedMesh`` as it is, a
    ``DeviceMesh`` wrapped, None as None."""
    if mesh is None or isinstance(mesh, NamedMesh):
        return mesh
    return NamedMesh.of(mesh)
