"""The port's parameter layouts against the JAX package's.

* ``DecoderLM.param_axes()`` mapped through ``convert.param_axes_to_jax``
  equals the axes tree of JAX's ``DecoderLM.init_shapes`` for the smoke
  config of every registered arch;
* every parameter's DTensor placements (``sharding.param_specs`` and
  ``layout.placements``), turned into a per-device block
  (``layout.shard_shape``), equal JAX's ``NamedSharding(AbstractMesh(...),
  spec).shard_shape`` on the (16, 16) and (2, 16, 16) production meshes at
  full width (the port's model built on the meta device, JAX's by
  ``eval_shape``: no weights are made);
* the block a rank holds (``layout.shard_slice``) equals JAX's
  ``devices_indices_map`` on a (2, 2) mesh of 4 host devices (a
  subprocess; row-major device order on both sides);
* ``make_production_mesh`` is abstract off a world of 256 or 512 ranks;
* ``constrain`` is the identity without rules and on plain tensors.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jax_get_config
from repro.models.model import DecoderLM as JaxLM
from repro.sharding import rules as jrules
from repro_torch import DecoderLM, get_config
from repro_torch.configs import list_archs
from repro_torch.convert import jax_path, param_axes_to_jax
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import NamedMesh, constrain, make_rules, param_specs, use_rules
from repro_torch.sharding.layout import placements, shard_shape, shard_slice

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"production": ((16, 16), ("data", "model")),
          "production-multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_axes(cfg):
    shapes, axes = JaxLM(cfg).init_shapes(jax.random.PRNGKey(0))
    flat_axes = {}
    flat_shapes = {}

    def walk(sh, ax, prefix):
        if isinstance(sh, dict):
            for k in sh:
                walk(sh[k], ax[k], f"{prefix}{k}.")
        else:
            flat_axes[prefix[:-1]] = tuple(ax)
            flat_shapes[prefix[:-1]] = tuple(sh.shape)

    walk(shapes, axes, "")
    return flat_axes, flat_shapes


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_axes_tree_equals_jax(arch):
    cfg = get_config(arch, smoke=True)
    model = DecoderLM(cfg, device="meta")
    want, _ = _jax_axes(jax_get_config(arch, smoke=True))
    assert param_axes_to_jax(cfg, model.param_axes()) == want


_FULL = {}


def _full(arch):
    """(port model on meta, JAX shapes by path) at full width, built once."""
    if arch not in _FULL:
        cfg = get_config(arch)
        _FULL[arch] = (cfg, DecoderLM(cfg, device="meta"),
                       _jax_axes(jax_get_config(arch)))
    return _FULL[arch]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_shard_shapes_equal_jax_on_production_meshes(arch, mesh):
    sizes, names = MESHES[mesh]
    cfg, model, (jax_axes, jax_shapes) = _full(arch)
    port_rules = make_rules(NamedMesh(sizes, names))
    jmesh = AbstractMesh(sizes, names)
    j_rules = jrules.make_rules(jmesh)
    mesh_shape = dict(zip(names, sizes))
    specs = param_specs(port_rules, model)
    for name, spec in specs.items():
        p = dict(model.named_parameters())[name]
        path, period = jax_path(cfg, name)
        # the port's own block of its per-layer tensor
        got = shard_shape(tuple(p.shape), spec, mesh_shape)
        placements(names, spec)          # every spec has DTensor placements
        shape = jax_shapes[path]
        jspec = j_rules.spec(shape, list(jax_axes[path]))
        want = NamedSharding(jmesh, jspec).shard_shape(shape)
        if period is None:
            assert got == tuple(want), (name, spec, jspec)
        else:
            # JAX stacks a group's periods on an unsharded "layers" axis
            assert jspec[:1] in ((), (None,)), (path, jspec)
            assert (shape[0],) + got == tuple(want), (name, spec, jspec)
    assert len(specs) == len(model.param_axes())


_JAX_SLICES = """
import json, sys, numpy as np, jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec
cases = json.loads(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = []
for shape, spec in cases:
    spec = PartitionSpec(*[tuple(e) if isinstance(e, list) else e for e in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out.append([[[s.start or 0, s.stop if s.stop is not None else n]
                 for s, n in zip(m[d], shape)] for d in jax.devices()[:4]])
print(json.dumps(out))
"""


def test_rank_slices_equal_jax_devices_indices_map():
    rules = make_rules(NamedMesh((2, 2), ("data", "model")))
    model = DecoderLM(get_config("goom-rnn-124m", smoke=True), device="meta")
    cases = [(list(p.shape), list(spec)) for p, spec in
             ((dict(model.named_parameters())[n], s)
              for n, s in param_specs(rules, model).items())]
    cases += [([8, 12], [("data", "model")]), ([8, 6, 4], ["model", None, "data"]),
              ([4, 4], [None, "data"])]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _JAX_SLICES, json.dumps(cases)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.strip().splitlines()[-1])
    sizes = {"data": 2, "model": 2}
    for (shape, spec), per_dev in zip(cases, want):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        for rank, w in enumerate(per_dev):
            coord = divmod(rank, 2)
            assert [list(s) for s in shard_slice(shape, spec, sizes, coord)] == w, \
                (shape, spec, rank)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_is_abstract_off_its_world(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    assert tuple(mesh.shape.values()) == want[0] and mesh.axis_names == want[1]
    assert mesh.device_mesh is None


def test_placements_of_a_two_axis_entry():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert placements(names, (("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    assert placements(names, (None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(NotImplementedError):
        placements(names, (("data", "pod"),))


def test_constrain_is_identity_without_rules_and_on_plain_tensors():
    x = torch.randn(4, 8, 16)
    assert constrain(x, "batch", "act_seq", "act_embed") is x
    with use_rules(make_rules(NamedMesh((2, 2), ("data", "model")))):
        assert constrain(x, "batch", "act_seq", "act_mlp") is x


def test_jax_spec_of_every_param_is_the_ports():
    """The spec the port gives a parameter is JAX's rules' spec of the same
    leaf, the stacked axis left out (goom-rnn and jamba smoke, multipod)."""
    sizes, names = MESHES["production-multipod"]
    port_rules = make_rules(NamedMesh(sizes, names))
    j_rules = jrules.make_rules(AbstractMesh(sizes, names))
    for arch in ("goom-rnn-124m", "jamba-v0.1"):
        cfg = get_config(arch, smoke=True)
        model = DecoderLM(cfg, device="meta")
        axes, shapes = _jax_axes(jax_get_config(arch, smoke=True))
        for name, spec in param_specs(port_rules, model).items():
            path, period = jax_path(cfg, name)
            jspec = tuple(j_rules.spec(shapes[path], list(axes[path])))
            if period is not None:
                jspec = jspec[1:]
            assert spec == jspec, (arch, name)

