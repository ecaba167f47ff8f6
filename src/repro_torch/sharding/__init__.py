"""Sharding: logical-axis rules mapped onto a named device mesh."""

from .mesh import NamedMesh, as_named_mesh
from .rules import (
    DEFAULT_RULES,
    MULTIPOD_RULES,
    AxisRules,
    current_rules,
    logical_to_spec,
    make_rules,
    use_rules,
)

__all__ = ["NamedMesh", "as_named_mesh", "AxisRules", "DEFAULT_RULES", "MULTIPOD_RULES",
           "current_rules", "logical_to_spec", "make_rules", "use_rules"]
