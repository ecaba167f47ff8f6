"""The per-period FSDP gather (``sharding/gather.py``) on gloo CPU ranks.

A laid-out step gathers each period's parameters as it enters the period,
inside the period's checkpoint region, and the embedding, final norm and
head around their use; the gather's backward puts each gradient into its
parameter's layout.  Held here:

* the laid-out step of goom-rnn smoke and of Mixtral smoke (an MoE) at
  (2, 1), (1, 2) and (2, 2) ("data", "model") against one process on the
  same weights, stepping on the data ranks' batch slices as its
  microbatches (the MoE's capacity and aux losses are per slice, as on the
  ranks): the loss equal to the bit (each rank's slice loss is the one
  process's, and the mean of two is exact either way), the gradient norm
  within 1e-5 and every parameter after the step within 1e-5 (the
  tolerances of ``tests/test_torch_train_dtensor.py``);
* goom-rnn's (2, 1) step against JAX's loss and gradients on the global
  batch from the same weights: the loss within rtol 1e-5, the gradient
  norm within 5e-4 (``tests/test_torch_train.py``'s per-leaf bound);
* the gathered parameter bytes alive at once on a rank (the gather's own
  count) under ``full`` and ``dots``: at most the largest period's plus
  the parameters outside the periods, below the whole model's (which the
  step gathered at once before), and none left after the step;
* the dry-run's rank of a (2, 1) cell (``launch/dryrun.py``: the laid-out
  step traced over torch's fake process group, the plain versions as on
  the CPU) against the peak a rank measured with the same tracker: within
  1.05x, its parameters and moments the blocks';
  one and two periods extrapolated against a whole laid-out trace;
* a laid-out ``make_prefill_step`` equal to the plain one (last logits and
  every cache leaf, to the bit);
* two int8-compressed steps at (1, 2) against one process, and the port's
  gather of parameters and moments (what checkpoints store) equal to
  DTensor's ``full_tensor`` in every layout; a dim split over two mesh
  dims (multi-pod's "embed") gathered whole, its gradient summed into each
  block;
* the launcher lays gloo ranks sharing a card out at ``--seq-shards 1``
  and keeps them plain at 2;
* a ``prefill_32k``-style cell on the production mesh holds the blocks.

The ranks lay the parameters out under the default rules with no
activation split (``torch_dist_workers.FSDP_ONLY``), so each rank of the
model axis computes whole heads and the one-process checks stay to the
bit; the split of heads, channels and the vocabulary across ranks is held
in ``tests/test_torch_model_axis.py``.  The ranks are ``tests/test_torch_train_dtensor.py``'s spawns
(``torch_dist_workers.layouts_ranks``: ``layouts_world2`` and
``layouts_world4`` run these cases too).
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.models.model import DecoderLM as JaxLM
from repro_torch import DecoderLM, get_config
from repro_torch.configs import ShapeCfg
from repro_torch.convert import params_to_jax
from repro_torch.launch import cost, dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import NamedMesh, make_rules, param_specs
from repro_torch.sharding.layout import shard_shape

torch.set_num_threads(2)
TOL = 1e-5
LAYOUTS = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = workers.layouts_ranks(tmp_path_factory)
    return {"two": [r["per_period"] for r in out["two"]],
            "four": [r["per_period"] for r in out["four"]]}


def _world(ranks, shape):
    return ranks["four"] if shape == (2, 2) else ranks["two"]


@pytest.mark.parametrize("arch", workers.FSDP_ARCHS)
@pytest.mark.parametrize("shape", LAYOUTS)
def test_laid_out_step_equals_one_process(ranks, shape, arch):
    world = _world(ranks, shape)
    r0 = world[0]["steps"][(shape, arch)]
    for r in world:
        assert r["steps"][(shape, arch)]["rows"] == r0["rows"]
    (got,), (want,) = r0["rows"], r0["one"]
    assert got["loss"] == want["loss"], (got["loss"], want["loss"])
    assert abs(got["grad_norm"] - want["grad_norm"]) <= TOL * want["grad_norm"]
    # the ranks sum their slices' tokens, microbatches average theirs
    assert got["tokens"] == want["tokens"] * shape[0] and got["lr"] == want["lr"]
    assert set(r0["params"]) == set(r0["one_params"])
    for name, w in r0["one_params"].items():
        np.testing.assert_allclose(r0["params"][name], w, rtol=0, atol=TOL, err_msg=name)


def test_laid_out_step_tracks_jax(ranks):
    """goom-rnn smoke's (2, 1) step against JAX's loss and gradients of the
    global batch (both data ranks' slices) from the port's seed-0 weights."""
    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True),
                              compute_dtype=torch.float32)
    jcfg = dataclasses.replace(jax_get_config("goom-rnn-124m", smoke=True),
                               compute_dtype=jnp.float32)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray, params_to_jax(cfg, {
        n: p.detach() for n, p in model.named_parameters()}))
    jmodel = JaxLM(jcfg)

    def loss(params, tokens, labels):
        with jax_engine.use_backend("reference"):
            return jmodel.loss(params, tokens, labels)

    b = workers.global_batch(0, 2)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    jnorm = float(np.sqrt(sum(float(jnp.sum(jnp.square(g)))
                              for g in jax.tree.leaves(jgrads))))
    (got,) = ranks["two"][0]["steps"][((2, 1), "goom-rnn-124m")]["rows"]
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], jnorm, rtol=5e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_gathered_bytes_stay_within_one_period(ranks, remat):
    for r in ranks["two"]:
        g = r["gathered"][remat]
        assert g["period"] <= g["peak"] <= g["bound"] < g["whole"], g
        assert g["live_after"] == 0


def _smoke_f32():
    return dataclasses.replace(get_config("goom-rnn-124m", smoke=True),
                               compute_dtype=torch.float32)


def test_dry_run_predicts_a_ranks_peak(ranks):
    """The measured step is the first from a fresh state on a rank's slice
    of 2 rows of 32 tokens; the trace is the dry-run's rank of the same
    (2, 1) cell under the plain versions (the CPU ranks' path), at its
    whole depth (the extrapolation over periods is held below)."""
    cfg = _smoke_f32()
    with dryrun.fake_ranks(NamedMesh((2, 1), ("data", "model"))) as mesh:
        c = dryrun.train_trace(cfg, ShapeCfg("t", 32, 4, "train"), 2, rules=make_rules(mesh),
                               backend="torch_reference")
    model = DecoderLM(cfg, device="meta")
    specs = param_specs(make_rules(NamedMesh((2, 1), ("data", "model"))), model)
    blocks = sum(int(np.prod(shard_shape(p.shape, specs[n], {"data": 2, "model": 1})))
                 for n, p in model.named_parameters()) * 4
    assert c.memory["parameters"] == blocks and c.memory["state"] == 2 * blocks
    for r in ranks["two"]:
        measured = r["peak"]
        assert measured["parameters"] == blocks and measured["state"] == 2 * blocks
        ratio = c.memory["peak"] / measured["peak"]
        assert 1 / 1.05 <= ratio <= 1.05, (c.memory, measured)


def test_laid_out_periods_equal_a_whole_trace():
    """One and two periods of a laid-out rank, extrapolated to three,
    against a trace of three: FLOPs, bytes and launches exactly, the peak
    within 1 % (``tests/test_torch_dryrun.py``'s bars for the plain
    trace)."""
    cfg = cost.with_periods(dataclasses.replace(_smoke_f32(), logit_chunk=16), [3])
    shape = ShapeCfg("t", 16, 2, "train")
    with dryrun.fake_ranks(NamedMesh((2, 1), ("data", "model"))) as mesh:
        rules = make_rules(mesh)
        whole = dryrun.train_trace(cfg, shape, 1, rules=rules)
        got = cost.periods(cfg, lambda c, mb: dryrun.train_trace(c, shape, 1, rules=rules))
    assert got.flops == whole.flops and got.bytes == whole.bytes
    assert got.written == whole.written and got.launches == whole.launches
    assert got.memory["peak"] == pytest.approx(whole.memory["peak"], rel=0.01)


@pytest.mark.parametrize("arch", workers.FSDP_ARCHS)
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_laid_out_prefill_equals_plain(ranks, shape, arch):
    for r in ranks["two"]:
        gap = r["prefill"][(shape, arch)]
        assert gap["laid"] == "DTensor" and gap["n_leaves"] > 0
        assert gap["logits"] == 0.0 and gap["caches"] == 0.0, gap


def test_int8_steps_gather_on_the_port(ranks):
    """Two int8-compressed steps at (1, 2) (the gradients gathered whole on
    the port's collectives, rounded through int8, laid out again): the
    first loss to the bit, the second within 1e-5 (the clip's norm sums
    the blocks in another order), the parameters within 1e-5."""
    r0 = ranks["two"][0]["int8"]
    got, want = r0["rows"], r0["one"]
    assert got[0]["loss"] == want[0]["loss"]
    assert abs(got[1]["loss"] - want[1]["loss"]) <= TOL * want[1]["loss"]
    assert got[1]["loss"] != got[0]["loss"]
    for name, w in r0["one_params"].items():
        np.testing.assert_allclose(r0["params"][name], w, rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("shape", LAYOUTS)
def test_checkpoint_gathers_equal_dtensors(ranks, shape):
    """The parameters and moments as ``state_tree`` gathers them (the
    port's gather) equal DTensor's ``full_tensor`` to the bit, on every
    rank."""
    for r in _world(ranks, shape):
        assert all(r["steps"][(shape, arch)]["gathers_agree"] for arch in workers.FSDP_ARCHS)
    if shape == (1, 2):
        assert all(r["int8"]["gathers_agree"] for r in ranks["two"])


def test_nested_split_gathers_and_reduces(ranks):
    """One tensor dim split over two mesh dims, as a multi-pod mesh splits
    "embed" over ("pod", "data"): the gather (the inner dim first) gives
    the whole, and the backward sums every rank's gradient into each
    rank's block (the outer dim first)."""
    for r in ranks["four"]:
        n = r["nested"]
        assert n["whole"] and n["full_tensor"] and n["block"] == (2, 3)
        assert n["grad"] == [[10.0] * 3] * 2


@pytest.mark.parametrize("backend,seq_shards,laid", [
    ("gloo", 1, True), ("gloo", 2, False), ("nccl", 2, True)])
def test_launcher_lays_out_gloo_ranks_sharing_a_card(backend, seq_shards, laid):
    args = argparse.Namespace(dist_backend=backend, seq_shards=seq_shards)
    assert launch_train.uses_layouts(args, torch.device("cuda"), True) is laid
    assert launch_train.uses_layouts(args, torch.device("cpu"), True)
    assert not launch_train.uses_layouts(args, torch.device("cuda"), False)


def test_prefill_cell_holds_the_blocks():
    """A prefill cell on the (16, 16) mesh: the traced rank holds its
    blocks (the specs' shard shapes) and gathers a period at a time."""
    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True), logit_chunk=16)
    mem = dryrun.lower_cell(cfg, ShapeCfg("p", 32, 32, "prefill"), make_production_mesh(),
                            verbose=False).memory_per_device
    assert mem["trace_parameters_bytes"] == mem["param_shard_bytes"] < mem["param_bytes"]
    assert 0 < mem["gathered_param_bytes"] < mem["param_bytes"]
