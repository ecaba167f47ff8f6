"""The port's sequence-sharded scans on gloo ranks (CPU) against the JAX
package's single-device ``xla_reference``.

Every case of ``tests/test_sharded.py`` runs at P = 2 and P = 4 ranks of one
``torch.distributed`` process group (``launch.mesh.spawn_ranks``; each rank
holds the full-length operands and gets the full states back), at that
file's bars: 1e-5 relative in log space on positive operands (e±200
included), 1e-3 where signed sums reassociate, gradients at rtol/atol 1e-4.
One spawn per P serves every case; the rank functions are in
``torch_dist_workers.py``.

The selective-reset scan's reset positions depend on the bracketing, so
with resets firing it is held to JAX's own sharded run at the same P,
computed in a subprocess with ``--xla_force_host_platform_device_count=4``.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core.goom import Goom as JGoom
from repro_torch.core import engine
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.sharding.mesh import NamedMesh

import torch_dist_workers as workers

ROOT = pathlib.Path(__file__).resolve().parents[1]
PS = (2, 4)


def goom_np(x):
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):
        return np.log(np.abs(x)).astype(np.float32), np.where(x >= 0, 1.0, -1.0).astype(
            np.float32)


def jg(pair):
    return None if pair is None else JGoom(jnp.asarray(pair[0]), jnp.asarray(pair[1]))


def positive(rng, shape, scale=0.6, shift=0.05):
    return goom_np(np.abs(rng.normal(size=shape)) * scale + shift)


def e200(rng, t, d):
    """Positive (t, d, d) with each step scaled by e^+200 or e^-200."""
    log, sign = positive(rng, (t, d, d), 1.0, 0.1)
    return (log + 200.0 * rng.choice([-1.0, 1.0], size=(t, 1, 1))).astype(np.float32), sign


def _cases():
    rng = np.random.default_rng(0)
    c = {}
    c["batched_x0"] = ("matrix_scan", (positive(rng, (64, 2, 4, 4)),
                                       positive(rng, (64, 2, 4, 2)),
                                       positive(rng, (2, 4, 2), 1.0, 0.1)), None)
    c["signed"] = ("matrix_scan", (goom_np(rng.normal(size=(32, 4, 4)) * 0.6),
                                   goom_np(rng.normal(size=(32, 4, 2)) * 0.6),
                                   goom_np(rng.normal(size=(4, 2)))), None)
    c["non_divisible"] = ("matrix_scan", (positive(rng, (13, 3, 3), 1.0, 0.1),
                                          positive(rng, (13, 3, 1), 1.0, 0.1), None), None)
    c["cumulative_e200"] = ("cumulative_lmme", (e200(rng, 48, 4),), None)
    c["matrix_e200"] = ("matrix_scan", (e200(rng, 24, 4), positive(rng, (24, 4, 2), 1.0, 0.1),
                                        positive(rng, (4, 2), 1.0, 0.1)), None)
    c["diagonal_x0"] = ("diagonal_scan", (goom_np(np.exp(-np.abs(rng.normal(size=(48, 2, 5))))),
                                          goom_np(rng.normal(size=(48, 2, 5))),
                                          goom_np(rng.normal(size=(2, 5)))), None)
    c["diagonal_odd"] = ("diagonal_scan", (goom_np(np.exp(-np.abs(rng.normal(size=(19, 3))))),
                                           goom_np(rng.normal(size=(19, 3))), None), None)
    c["grad"] = ("grad", (positive(rng, (16, 3, 3), 1.0, 0.1),
                          positive(rng, (16, 3, 2), 1.0, 0.1),
                          positive(rng, (3, 2), 1.0, 0.1)), None)
    # 32 steps whose resets fire at 0.995: 20 of them at P = 1 and 2, 16 at
    # P = 4 (in JAX): the positions depend on the bracketing
    mats = goom_np(np.random.default_rng(0).normal(size=(32, 3, 3)) * 2.0)
    c["reset_none"] = ("reset", (mats,), 1.01)
    c["reset_fires"] = ("reset", (mats,), 0.995)
    return c


CASES = _cases()
# a case shorter than the mesh runs locally: T = P - 1
SHORT = {p: ("matrix_scan", (positive(np.random.default_rng(p), (p - 1, 3, 3), 1.0, 0.1),
                             positive(np.random.default_rng(p + 9), (p - 1, 3, 1), 1.0, 0.1),
                             None), None) for p in PS}
BATCH = (positive(np.random.default_rng(5), (32, 4, 3, 3), 0.5),
         positive(np.random.default_rng(6), (32, 4, 3, 1), 0.5))

_JAX_SHARDED = """
import sys, numpy as np, jax
from jax.sharding import Mesh
from repro.core import engine
from repro.core.goom import Goom
from repro.core.scan import colinearity_select, orthonormal_reset
d = np.load(sys.argv[1])
mats = Goom(d["log"], d["sign"])
out = {}
for p in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:p]).reshape(1, p), ("data", "seq"))
    with engine.use_mesh(mesh, backend="xla_reference"):
        assert engine.active_seq_shards() == p
        st, fl = jax.jit(lambda m: engine.selective_reset_scan(
            m, colinearity_select(0.995), orthonormal_reset()))(mats)
    out[f"log{p}"], out[f"sign{p}"], out[f"flags{p}"] = map(np.asarray, (st.log_abs, st.sign, fl))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on P = 2 and 4 ranks, and JAX's sharded reset scan."""
    tmp = tmp_path_factory.mktemp("sharded")
    mats = CASES["reset_fires"][1][0]
    np.savez(tmp / "mats.npz", log=mats[0], sign=mats[1])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SHARDED, str(tmp / "mats.npz"),
                             str(tmp / "jax.npz")], env=env, stderr=subprocess.PIPE)
    out = {}
    for p in PS:
        cases = dict(CASES, short=SHORT[p])
        out[p] = spawn_ranks(workers.sharded_cases, p, p, cases,
                             BATCH if p == 4 else None, timeout=300)
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err.decode()[-3000:]
    out["jax"] = dict(np.load(tmp / "jax.npz"))
    return out


def jax_ref(op, pairs, extra=None):
    args = [jg(x) for x in pairs]
    with jengine.use_backend("xla_reference"):
        if op == "reset":
            from repro.core.scan import colinearity_select, orthonormal_reset

            st, fl = jax.jit(lambda a: jengine.selective_reset_scan(
                a, colinearity_select(extra), orthonormal_reset()))(args[0])
            return np.asarray(st.log_abs), np.asarray(st.sign), np.asarray(fl)
        if op == "grad":
            a, b, x0 = args

            def loss(al, bl):
                out = jengine.matrix_scan(JGoom(al, a.sign), JGoom(bl, b.sign), x0)
                return jnp.sum(jnp.where(jnp.isfinite(out.log_abs), out.log_abs, 0.0))

            return tuple(map(np.asarray, jax.jit(jax.grad(loss, argnums=(0, 1)))(
                a.log_abs, b.log_abs)))
        fn = getattr(jengine, op)
        live = [x for x in args if x is not None]   # only a trailing x0 is None
        out = jax.jit(lambda *xs: fn(*xs, *[None] * (len(args) - len(live))))(*live)
        return np.asarray(out.log_abs), np.asarray(out.sign)


def assert_log_close(got, want, rtol):
    g, w = got[0], want[0]
    finite = np.isfinite(w)
    assert np.array_equal(np.isfinite(g), finite)
    rel = np.abs(g[finite] - w[finite]) / np.maximum(np.abs(w[finite]), 1.0)
    assert float(rel.max()) <= rtol, float(rel.max())


def each_rank(runs, p, name):
    for r, res in enumerate(runs[p]):
        assert res["_shards"] == p
        yield res[name]


# ---------------------------------------------------------------------------
# single-process semantics
# ---------------------------------------------------------------------------
def test_no_mesh_means_single_device():
    assert engine.active_seq_shards() == 1
    with engine.use_backend("torch_reference"):
        assert engine.active_seq_shards() == 1


def test_explicit_shards_without_mesh_raises():
    with engine.use_backend("auto", seq_shards=4):
        with pytest.raises(ValueError, match="no mesh"):
            engine.active_seq_shards()


def test_use_mesh_none_disables():
    with engine.use_mesh(None):
        assert engine.active_seq_shards() == 1


def test_scan_logical_axes_in_rules():
    from repro_torch.sharding.rules import make_rules, use_rules

    mesh = NamedMesh((1, 1), ("data", "model"))
    rules = make_rules(mesh)
    assert rules.mesh_axes_for("scan_seq") == ()
    assert rules.mesh_axes_for("scan_batch") == ("data",)
    rules = make_rules(mesh, overrides={"scan_seq": "model"})
    assert rules.mesh_axes_for("scan_seq") == ("model",)
    with use_rules(rules):        # a 1-sized axis: local
        assert engine.active_seq_shards() == 1
    with use_rules(make_rules(NamedMesh((1, 4), ("data", "model")),
                              overrides={"scan_seq": "model"})):
        assert engine.active_seq_shards() == 4


def test_one_sized_seq_axis_falls_back():
    mesh = NamedMesh((1, 1), ("data", "seq"))
    with engine.use_mesh(mesh, seq_axis="seq"):
        assert engine.active_seq_shards() == 1
        a = workers._g(goom_np(np.random.default_rng(0).normal(size=(6, 3, 3)) * 0.5))
        assert engine.cumulative_lmme(a).shape == (6, 3, 3)


def test_use_mesh_defaults_to_seq_axis_name():
    with engine.use_mesh(NamedMesh((1, 1), ("seq", "other"))):
        assert engine.get_config().seq_axis == "seq"
    with engine.use_mesh(NamedMesh((1, 1), ("data", "model"))):
        assert engine.get_config().seq_axis == "model"


def test_shard_count_must_match_the_axis():
    with engine.use_mesh(NamedMesh((1, 4), ("data", "model")), seq_shards=2):
        with pytest.raises(ValueError, match="does not match"):
            engine.active_seq_shards()


# ---------------------------------------------------------------------------
# P ranks against JAX's single-device xla_reference
# ---------------------------------------------------------------------------
BARS = {"batched_x0": 1e-5, "signed": 1e-3, "non_divisible": 1e-5,
        "cumulative_e200": 1e-5, "matrix_e200": 1e-5, "diagonal_x0": 1e-5,
        "diagonal_odd": 1e-5}


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", list(BARS))
def test_sharded_parity(runs, p, name):
    op, pairs, _ = CASES[name]
    want = jax_ref(op, pairs)
    if name == "cumulative_e200" or name == "matrix_e200":
        assert float(np.max(np.abs(want[0]))) > 200.0   # genuinely extreme
    for got in each_rank(runs, p, name):
        assert got[0].shape == want[0].shape
        assert_log_close(got, want, BARS[name])
        if name in ("batched_x0", "signed", "diagonal_x0"):
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("p", PS)
def test_shorter_than_mesh_runs_locally(runs, p):
    op, pairs, _ = SHORT[p]
    want = jax_ref(op, pairs)
    for got in each_rank(runs, p, "short"):
        assert_log_close(got, want, 1e-5)


@pytest.mark.parametrize("p", PS)
def test_sharded_gradients_match_reference(runs, p):
    _, pairs, _ = CASES["grad"]
    want = jax_ref("grad", pairs)
    for got in each_rank(runs, p, "grad"):
        for x, y in zip(got, want):
            assert np.all(np.isfinite(x))
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", PS)
def test_selective_reset_scan_sharded_parity_no_resets(runs, p):
    """A threshold that never fires: the reset monoid is plain products, and
    the sharded scan matches the local one strictly."""
    want = jax_ref("reset", CASES["reset_none"][1], 1.01)
    for got in each_rank(runs, p, "reset_none"):
        assert not got[2].any() and not want[2].any()
        assert_log_close(got, want, 1e-4)


@pytest.mark.parametrize("p", PS)
def test_selective_reset_scan_sharded_with_resets_equals_jax_sharded(runs, p):
    """Resets firing: the port's P-rank run equals JAX's run at the same P
    (the same tree: the port's associative scan brackets as JAX's)."""
    j = runs["jax"]
    want = (j[f"log{p}"], j[f"sign{p}"], j[f"flags{p}"])
    assert want[2].any()          # the data does trigger resets
    for got in each_rank(runs, p, "reset_fires"):
        np.testing.assert_array_equal(got[2], want[2])
        assert_log_close(got, want, 1e-4)
        assert not np.any(np.isnan(got[0])) and not np.any(np.isposinf(got[0]))


def test_sharded_with_a_data_axis(runs):
    """A (2, 2) ("data", "seq") mesh: each data rank scans its half of the
    batch over the seq group of 2; together they are JAX's full result."""
    want = jax_ref("matrix_scan", BATCH + (None,))
    halves = {}
    for res in runs[4]:
        assert res["_batch_shards"] == 2
        i, got = res["_batch"]
        halves.setdefault(i, got)
        np.testing.assert_array_equal(halves[i][0], got[0])   # the seq group agrees
    got = tuple(np.concatenate([halves[0][k], halves[1][k]], axis=1) for k in range(2))
    assert_log_close(got, want, 1e-5)
