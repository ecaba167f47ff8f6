"""Training with the parameters laid out as DTensors (``sharding.
distribute_model``, JAX's ``param_shardings``) on gloo ranks on the CPU,
against one process.

* an f32 goom-rnn smoke step at (2, 1) ("data": FSDP, each rank its slice
  of the batch), (1, 2) (the "model" axis's splits of heads, MLP and vocab;
  the batch whole on both ranks) and (2, 2): the loss and gradient norm
  within 1e-5 of one process stepping on the data ranks' slices together,
  and every parameter after the step within 1e-5;
* ``--seq-shards 2`` at (1, 2): a step's loss and gradient norm within
  1e-5 of one process, and one
  layer's scan seen from inside the rank's shard: operands and states of
  ⌈T/2⌉ steps, states equal to the full-length sharded path's (the
  same algebra) at T = 32 and 31, logits equal;
* Jamba smoke's Mamba layers time-sharded at (1, 2): loss and gradients
  equal to the local run's;
* a checkpoint written at 2 ranks ((2, 1)) restores at 1 and at 4 ranks
  ((2, 2): the parameters in four blocks), and the next step's loss equals
  the 2-rank run's (every run draws the batch as two slices, as the data
  stream gives each data rank its own: one process steps on both);
* the launcher refuses ``--mesh production`` and ``production-multipod``
  off their worlds, naming them.

The layouts' rules switch the activations' split across ranks off
(``torch_dist_workers.FSDP_ONLY``): the parameters' splits are held here,
the model axis's split of the compute in ``tests/test_torch_model_axis.py``.
The ranks are spawned twice a test run (2 and 4 ranks, ``spawn_ranks``),
each spawn under its own time limit, and shared with
``tests/test_torch_fsdp.py`` (``torch_dist_workers.layouts_ranks``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro_torch import DecoderLM, get_config
from repro_torch.launch import train as launch_train
from repro_torch.train import (AdamW, CheckpointManager, cosine_schedule, init_train_state,
                               load_state_tree, make_train_step, state_tree)
from repro_torch.train.data import to_device
from torch_parity import with_scan_variant

torch.set_num_threads(2)
TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return workers.layouts_ranks(tmp_path_factory)


def _one_process(variant="shared_a", count=1, steps=1, start=0, restore=None):
    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True),
                              compute_dtype=torch.float32)
    cfg = with_scan_variant(cfg, variant)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    opt = AdamW(cosine_schedule(3e-3, 1, 4))
    state = init_train_state(model, opt)
    if restore is not None:
        start, tree, _ = CheckpointManager(restore).restore_latest(state_tree(cfg, state))
        state = load_state_tree(cfg, state, tree)
    step = make_train_step(model, opt)
    rows = []
    for i in range(start, start + steps):
        state, m = step(state, to_device(workers.global_batch(i, count), "cpu"))
        rows.append({k: float(v) for k, v in m.items()})
    return rows, {n: p.detach().numpy() for n, p in model.named_parameters()}


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm"):
            assert abs(g[key] - w[key]) <= TOL * abs(w[key]), (key, g[key], w[key])
        assert g["tokens"] == w["tokens"] and g["lr"] == w["lr"]


@pytest.mark.parametrize("layout", ["fsdp", "tp", "dp_tp", "seq"])
def test_layout_step_equals_one_process(ranks, layout):
    run = (ranks["four"] if layout == "dp_tp" else ranks["two"])
    variant = "generic" if layout == "seq" else "shared_a"
    want_rows, want_params = _one_process(variant, count=2 if layout in ("fsdp", "dp_tp")
                                          else 1)
    for r in run:
        _same_rows(r[layout]["rows"], want_rows)
    if layout == "seq":
        # the time shards sum a gradient in another order; Adam's first
        # update, g / (|g| + eps), moves a weight whose gradient is near eps
        # by a visible part of lr (7.6e-5 at lr 3e-3 on 3 of in_proj's 4096),
        # so the parameters after the step are held through the loss and
        # gradient norm above
        return
    got = run[0][layout]["params"]
    assert set(got) == set(want_params)
    for name, w in want_params.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=TOL, err_msg=name)


def test_layouts_shard_the_parameters(ranks):
    """The FSDP run shards "embed" over data, the (1, 2) run "vocab" and
    "heads" over model, as JAX's rules say (a 1-sized axis divides every
    dim, so it keeps its entry, as in JAX)."""
    fsdp = ranks["two"][0]["fsdp"]["placements"]
    tp = ranks["two"][0]["tp"]["placements"]
    assert fsdp["embed"] == "(Shard(dim=1), Shard(dim=0))"          # (vocab, embed)
    assert tp["embed"] == "(Shard(dim=1), Shard(dim=0))"
    assert tp["layers.0.mixer.A"] == "(Replicate(), Shard(dim=0))"  # heads
    assert tp["layers.0.mixer.ln.scale"] == "(Replicate(), Replicate())"
    assert ranks["four"][0]["dp_tp"]["placements"]["lm_head.w"] == \
        "(Shard(dim=0), Shard(dim=1))"                                 # (embed, vocab)
    # JAX's state_shardings: the moments laid out as their parameters
    assert all(r[k]["moments_follow"] for r in ranks["two"] for k in ("fsdp", "tp", "seq"))
    assert all(r["dp_tp"]["moments_follow"] for r in ranks["four"])


@pytest.mark.parametrize("seq", [32, 31])
def test_a_rank_holds_its_time_shard_only(ranks, seq):
    half = -(-seq // 2)
    for rank, r in enumerate(ranks["two"]):
        cap = r["shards"][seq]
        a_shape, b_shape, out_shape, (log, sign) = cap["time_shard"]
        assert a_shape[0] == b_shape[0] == out_shape[0] == half
        _, _, full_shape, (flog, fsign) = cap["full"]
        assert full_shape == out_shape
        valid = min(half, seq - rank * half)   # the last shard's padded step differs
        np.testing.assert_array_equal(sign[:valid], fsign[:valid])
        np.testing.assert_allclose(log[:valid], flog[:valid], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(cap["logits_ts"], cap["logits_full"], rtol=0, atol=1e-5)


def test_mamba_time_shards_keep_the_loss_and_gradients(ranks):
    """Jamba smoke's Mamba layers under the time shards: each a single
    time-sharded diagonal scan (no chunk loop), the loss within 1e-5 of the
    local run's and every gradient within 5e-4 of the leaf's largest, or of
    1e-5 of the model's largest where a leaf's is smaller (the bound and
    floor ``test_torch_remat.py`` holds the port to JAX by).  The shards'
    algebra sums a scan in another order than the local loop of 8-step
    chunks: the largest gap measured was 9.6e-5 of its leaf, at the first
    layer's ``x_proj.w`` (Mamba's B, C and Δ)."""
    for r in ranks["two"]:
        (l0, g0, c0), (l1, g1, c1) = r["jamba"]["local"], r["jamba"]["time_shards"]
        # 7 Mamba layers, each scanned once in the forward and once in its
        # period's recompute (remat "full")
        assert c1["diagonal_scan"] == 2 * 7 and c0["diagonal_scan"] > c1["diagonal_scan"]
        assert abs(l1 - l0) <= TOL * abs(l0)
        floor = 1e-5 * max(np.abs(g).max() for g in g0.values())
        for name, g in g0.items():
            scale = max(np.abs(g).max(), floor)
            assert np.abs(g1[name] - g).max() <= 5e-4 * scale, name


@pytest.mark.parametrize("world", [1, 2, 4])
def test_checkpoint_restores_at_another_rank_count(ranks, world):
    want = ranks["two"][0]["next"]
    if world == 1:
        got, _ = _one_process(count=2, restore=ranks["ckpt"])
    else:
        got = (ranks["four"] if world == 4 else ranks["two"])[0]["next"]
    assert [r["loss"] for r in got] and abs(got[0]["loss"] - want[0]["loss"]) <= \
        TOL * abs(want[0]["loss"])
    _same_rows(got, want)


@pytest.mark.parametrize("mesh,world", [("production", 256), ("production-multipod", 512)])
def test_production_mesh_is_refused_off_its_world(ranks, mesh, world):
    with pytest.raises(ValueError, match=f"needs a world of {world} ranks; this one has 1"):
        launch_train.main(["--smoke", "--device", "cpu", "--steps", "1", "--mesh", mesh])
    for r in ranks["two"]:   # 2 ranks: an abstract mesh, and the launcher's refusal
        built, err = r["production"][mesh]
        assert not built and err.endswith(f"needs a world of {world} ranks; this one has 2")
