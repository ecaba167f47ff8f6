"""The port's logical-axis rules (``repro_torch.sharding``) against the JAX
package's ``repro.sharding.rules`` on abstract meshes of (16, 16) ("data",
"model") and (2, 16, 16) ("pod", "data", "model"): ``AxisRules.spec`` is
equal to JAX's ``PartitionSpec`` entry for entry over a grid of shapes and
logical names, with and without ``allow_uneven`` and overrides.  On the
JAX side ``jax.sharding.AbstractMesh`` stands for the mesh; on the port's a
``NamedMesh`` of sizes and names only.
"""

import itertools

import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.sharding import rules as jrules
from repro_torch.sharding import NamedMesh
from repro_torch.sharding import rules

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
NAMES = sorted(jrules._base_table(("data",))) + [None, "unknown"]
DIMS = [1, 2, 3, 7, 14, 16, 28, 30, 32, 48, 64, 100, 256, 1000, 4096]
OVERRIDES = [None, {"scan_seq": "model", "act_seq": "model"},
             {"embed": ("data", "model"), "batch": ("pod", "data", "model")}]


def _pair(kind, overrides):
    sizes, names = MESHES[kind]
    ov = None if overrides is None else {
        k: v for k, v in overrides.items()
        if all(a in names for a in ((v,) if isinstance(v, str) else v))}
    return (rules.make_rules(NamedMesh(sizes, names), ov),
            jrules.make_rules(AbstractMesh(sizes, names), ov))


def _grid(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        rank = int(rng.integers(1, 4))
        yield (tuple(int(rng.choice(DIMS)) for _ in range(rank)),
               [NAMES[int(i)] for i in rng.integers(0, len(NAMES), rank)])


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("allow_uneven", [False, True])
@pytest.mark.parametrize("ov", range(len(OVERRIDES)))
def test_spec_equals_jax(kind, allow_uneven, ov):
    port, jax_rules = _pair(kind, OVERRIDES[ov])
    for shape, names in _grid(ov * 7 + allow_uneven, 400):
        want = tuple(jax_rules.spec(shape, names, allow_uneven=allow_uneven))
        assert port.spec(shape, names, allow_uneven=allow_uneven) == want, (shape, names)


@pytest.mark.parametrize("kind", list(MESHES))
def test_every_name_pair_on_square_dims(kind):
    """Every pair of logical names on (256, 256) and (28, 4096): one mesh axis
    never maps to two dims, the first dim wins."""
    port, jax_rules = _pair(kind, None)
    for a, b in itertools.product(NAMES, repeat=2):
        for shape in ((256, 256), (28, 4096)):
            for uneven in (False, True):
                assert port.spec(shape, [a, b], allow_uneven=uneven) == \
                    tuple(jax_rules.spec(shape, [a, b], allow_uneven=uneven))


def test_tables_and_axes_equal_jax():
    for kind in MESHES:
        sizes, names = MESHES[kind]
        for make in ("DEFAULT_RULES", "MULTIPOD_RULES"):
            if (make == "MULTIPOD_RULES") != ("pod" in names):
                continue
            port = getattr(rules, make)(NamedMesh(sizes, names))
            want = getattr(jrules, make)(AbstractMesh(sizes, names))
            assert port.table == want.table
            for name in NAMES:
                assert port.mesh_axes_for(name) == want.mesh_axes_for(name)
                axes = port.mesh_axes_for(name)
                assert port.axis_size(axes) == want.axis_size(axes)
    port, want = _pair("pod", None)
    assert rules.logical_to_spec(port, (64, 48), ["batch", "heads"]) == \
        tuple(jrules.logical_to_spec(want, (64, 48), ["batch", "heads"]))


def test_use_rules_nests_and_restores():
    assert rules.current_rules() is None
    a, _ = _pair("pod", None)
    b, _ = _pair("multipod", None)
    with rules.use_rules(a):
        assert rules.current_rules() is a
        with rules.use_rules(b):
            assert rules.current_rules() is b
        assert rules.current_rules() is a
    assert rules.current_rules() is None


def test_spec_length_mismatch_raises():
    port, _ = _pair("pod", None)
    with pytest.raises(ValueError, match="differ in length"):
        port.spec((4, 4), ["batch"])


def test_named_mesh_of_sizes_has_no_groups():
    mesh = NamedMesh((2, 4), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 4}
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="abstract"):
        mesh.get_group("model")
    with pytest.raises(ValueError, match="length"):
        NamedMesh((2,), ("data", "model"))
