"""Sharding: logical-axis rules mapped onto a named device mesh."""

from .mesh import NamedMesh, as_named_mesh
from .rules import (
    DEFAULT_RULES,
    MULTIPOD_RULES,
    AxisRules,
    constrain,
    current_rules,
    distribute_model,
    logical_to_spec,
    param_placements,
    param_specs,
    make_rules,
    use_rules,
)

__all__ = ["NamedMesh", "as_named_mesh", "AxisRules", "DEFAULT_RULES", "MULTIPOD_RULES",
           "constrain", "current_rules", "distribute_model", "logical_to_spec",
           "make_rules", "param_placements", "param_specs", "use_rules"]
