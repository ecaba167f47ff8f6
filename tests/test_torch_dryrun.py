"""The dry-run's cost pass (``launch/cost.py``) and cells (``launch/dryrun.py``).

* the cost pass on ``tests/test_hlo_cost.py``'s ground truths: a 128³ f32
  matmul counts 2·128³ FLOPs (within 1 %; it is exact), a Python loop of 7
  counts 7× that, a gradient at least 1.8× its forward;
* each GOOM kernel wrapper's shape-only branch on FakeTensors gives the
  plain version's shapes and dtypes, saves for a backward of the plain
  version's shapes, launches nothing and moves no ``launches`` counter;
  real CPU operands still take the plain version;
* one and two periods of each group, extrapolated, equal a whole trace:
  FLOPs, bytes and launches exactly, the peak within 1 % (goom-rnn smoke's
  train step, and gemma3-1b smoke's prefill with its mixed local/global
  period);
* above two microbatches, a long sequence's counts fitted from three short
  ones (``cost.lengths``) against a trace at the full length: FLOPs and
  launches exactly, bytes within 1 % (goom-rnn smoke, one layer, three
  microbatches); its memory is traced at the full length at two
  microbatches, and its peak is within 0.1 % of three's (the per-microbatch
  scalars differ); at one microbatch the cost is the full-length trace; the
  same fit across flash attention's key blocks (a Mamba and an attention
  layer, lengths a multiple of the chunk and the tiles);
* a smoke train cell and a decode cell through ``lower_cell`` on the
  abstract (16, 16) mesh: the bytes a device keeps are the shard shapes of
  the specs that ``tests/test_torch_layouts.py`` holds to JAX's, and the
  traced rank holds them, gathering a period at a time; under
  ``scan_seq`` on "model" the time shards add their gathers;
* the analytic collectives against a laid-out step's on a (2, 2) gloo CPU
  mesh (``CommDebugMode``'s counts by kind, and every collective's result
  bytes), with and without ``cast_params_bf16``, and under ``remat="full"``
  (each period gathered again in its recomputation); the default rules
  split goom-rnn's heads and vocabulary on "model", so the parameters'
  collectives follow the split roles and the rank's split activation
  collectives (the port's listener) make up the rest;
* the model axis on the (16, 16) mesh: a smoke config with 16 heads, 256
  MLP channels and a vocabulary of 256 runs its block on each rank, its
  activations and FLOPs below the same cell with the split switched off
  (``torch_dist_workers.FSDP_ONLY``), its split all-reduces counted and its
  split weights' gathers over "model" gone; its prefill holds its block of
  the KV heads, JAX's ``cache_shard_bytes``;
* the rest of the model axis on the (16, 16) mesh: rwkv6-7b at full width
  (train_4k's batch, 256 tokens: a train_4k cell takes 100 s of host time)
  holds fewer bytes above its state, in the forward and gathered a rank
  than with the split off; Jamba's gathered period keeps 1/16 of its MoE's bytes; a gemma3-1b
  ``decode_32k`` rank (one KV head: its caches' rows on "model") holds
  JAX's ``cache_shard_bytes``;
* ``cast_params_bf16``: the port's step against JAX's for 2 steps from the
  same weights, losses within rtol 1e-5.  Both packages round the f32
  weights to the same bf16 values (to nearest even), so both forwards run
  on equal weights: a probe found the losses 8e-8 apart, while the step
  without the cast is 5e-5 and 7e-4 away from the cast one's (goom-rnn
  smoke, f32 compute, B=2, S=32), so the bound tells the two apart.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.models.common import unzip
from repro.models.model import DecoderLM as JaxLM
from repro.train import optimizer as jopt
from repro.train.train_loop import init_train_state as jax_init_train_state
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro_torch import DecoderLM, get_config, params_from_jax
from repro_torch.configs import ShapeCfg
from repro_torch.core.goom import Goom
from repro_torch.kernels import shape_only
from repro_torch.kernels.goom_scan import diagonal_scan_cuda, matrix_scan_cuda
from repro_torch.kernels.lmme import lmme_cuda
from repro_torch.launch import cost, dryrun
from repro_torch.launch.mesh import make_production_mesh, spawn_ranks
from repro_torch.launch.roofline import CollectiveOp, collective_bytes_per_device
from repro_torch.sharding import NamedMesh, make_rules, param_specs
from repro_torch.sharding.layout import shard_shape
from repro_torch.train import AdamW, DataConfig, SyntheticStream, cosine_schedule
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.data import to_device

import torch_dist_workers as workers

torch.set_num_threads(2)
X = 128


def _fake_cost(fn, *shapes, grad=False):
    with FakeTensorMode():
        args = [torch.empty(s).requires_grad_(grad) for s in shapes]
        _, c = cost.measure(lambda: fn(*args))
    return c


def _grad(x, w):
    return torch.autograd.grad(torch.tanh(x @ w).square().sum(), w)


@pytest.mark.parametrize("case", ["matmul", "loop", "grad"])
def test_cost_pass_ground_truths(case):
    one = 2 * X ** 3
    mm = _fake_cost(lambda a, b: a @ b, (X, X), (X, X))
    assert abs(mm.flops - one) / one < 0.01
    assert mm.f32_flops == mm.flops
    assert mm.written == 4 * X * X and mm.bytes == 3 * 4 * X * X
    if case == "loop":
        def seven(a, b):
            for _ in range(7):
                a = a @ b
            return a

        assert abs(_fake_cost(seven, (X, X), (X, X)).flops - 7 * one) / (7 * one) < 0.01
    if case == "grad":
        fwd = _fake_cost(lambda x, w: torch.tanh(x @ w).square().sum(), (X, X), (X, X))
        assert _fake_cost(_grad, (X, X), (X, X), grad=True).flops > 1.8 * fwd.flops


def _planes(rng, *shape):
    return Goom(torch.tensor(rng.normal(size=shape), dtype=torch.float32),
                torch.tensor(np.where(rng.random(shape) < 0.5, -1.0, 1.0), dtype=torch.float32))


CALLS = {   # kernel: (the wrapper's call on (a, b, x0), their shapes)
    "lmme": (lambda a, b, x: lmme_cuda(a, b), ((3, 4, 5), (3, 5, 2), None)),
    "matrix_scan": (lambda a, b, x: matrix_scan_cuda(a, b, x),
                    ((6, 2, 4, 4), (6, 2, 4, 3), (2, 4, 3))),
    "matrix_scan_zero_b": (lambda a, b, x: matrix_scan_cuda(a, None, x),
                           ((6, 2, 4, 4), None, (2, 4, 3))),
    "diag_scan": (lambda a, b, x: diagonal_scan_cuda(a, b, x), ((7, 3, 5), (7, 3, 5), (3, 5))),
}


def _counters():
    return (lmme_cuda.launches, matrix_scan_cuda.launches, matrix_scan_cuda.launches_zero_b,
            diagonal_scan_cuda.launches)


@pytest.mark.parametrize("kernel", sorted(CALLS))
def test_shape_only_branch_launches_nothing(kernel):
    fn, shapes = CALLS[kernel]
    rng = np.random.default_rng(0)
    ops = [None if s is None else _planes(rng, *s) for s in shapes]
    calls = []
    with shape_only.listening(lambda k, dims: calls.append(k)):
        want = fn(*ops)                      # real CPU operands: the plain version
    assert calls == []
    before = _counters()
    with FakeTensorMode() as mode, shape_only.listening(lambda k, dims: calls.append(k)):
        fake = [None if g is None else Goom(mode.from_tensor(g.log_abs).requires_grad_(),
                                            mode.from_tensor(g.sign)) for g in ops]
        got = fn(*fake)
        grads = torch.autograd.grad(got.log_abs.sum(), [g.log_abs for g in fake if g])
    assert calls == [kernel] and _counters() == before
    for g, w in ((got.log_abs, want.log_abs), (got.sign, want.sign)):
        assert isinstance(g, FakeTensor) and g.shape == w.shape and g.dtype == w.dtype
    assert [tuple(g.shape) for g in grads] == [tuple(g.log_abs.shape) for g in fake if g]


@pytest.mark.parametrize("toggle", ["seq_parallel", "constrain_grads", "no_such_toggle"])
def test_lower_cell_refuses_toggles_that_change_nothing(toggle):
    with pytest.raises(ValueError, match=toggle):
        dryrun.lower_cell(_smoke_train("goom-rnn-124m"), ShapeCfg("t", 16, 16, "train"),
                          make_production_mesh(), perf={toggle: True})


def _smoke_train(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True), logit_chunk=16, **kw)


@pytest.mark.parametrize("arch", ["goom-rnn-124m", "gemma3-1b"])
def test_periods_equal_a_whole_trace(arch):
    """goom-rnn's train step; gemma3's prefill (its train step traces three
    times the ops: 15 s here)."""
    cfg = _smoke_train(arch, remat="none")
    if arch == "gemma3-1b":     # two of its 5-local + 1-global periods, 2 locals after
        cfg = cost.with_periods(cfg, [2, 1])
    assert cfg.groups[0].n_periods > 1
    if arch == "gemma3-1b":
        shape = ShapeCfg("p", 16, 1, "prefill")
        trace = lambda c: dryrun.serve_trace(c, shape, 1)  # noqa: E731
    else:
        shape = ShapeCfg("t", 16, 1, "train")
        trace = lambda c: dryrun.train_trace(c, shape, 1)  # noqa: E731
    whole = trace(cfg)
    got = cost.periods(cfg, lambda c, mb: trace(c))
    assert got.flops == whole.flops and got.f32_flops == whole.f32_flops
    assert got.bytes == whole.bytes and got.written == whole.written
    assert got.launches == whole.launches
    assert got.memory["peak"] == pytest.approx(whole.memory["peak"], rel=0.01)


@pytest.mark.parametrize("microbatches", [1, 3])
def test_lengths_fit_a_long_sequence(microbatches):
    cfg = cost.with_periods(_smoke_train("goom-rnn-124m", remat="none"), [1])
    assert dryrun._length_fit(cfg) == (16, 16)   # chunk 16: fitted from 16, 32, 48
    shape = ShapeCfg("t", 64, microbatches, "train")
    whole = dryrun.train_trace(cfg, shape, microbatches, microbatches)
    got = dryrun.train_cost(cfg, shape, microbatches, microbatches=microbatches)
    assert got.flops == whole.flops and got.launches == whole.launches
    if microbatches == 1:                         # the full-length trace itself
        assert (got.bytes, got.written, got.memory) == (whole.bytes, whole.written,
                                                        whole.memory)
        return
    assert got.bytes == pytest.approx(whole.bytes, rel=0.01)
    assert got.written == pytest.approx(whole.written, rel=0.01)
    assert got.memory["peak"] == pytest.approx(whole.memory["peak"], rel=1e-3)


def test_lengths_fit_across_flash_key_blocks():
    """A Mamba layer and an attention layer (Jamba smoke's first and fifth,
    Mamba's chunk 16, flash tiles of 8 queries and 16 keys): the lengths
    step by the chunks' and tiles' multiple, so the key blocks grow with S
    and nothing is padded, and the fit from 16, 32, 48 gives the trace at
    64: FLOPs and launches exactly, bytes within 0.1 % (the fit's
    standard above)."""
    cfg = _smoke_train("jamba-v0.1", remat="none")
    mamba, attn = cfg.layer_list[0], cfg.layer_list[4]
    period = (dataclasses.replace(mamba, mamba=dataclasses.replace(mamba.mamba, chunk=16)),
              dataclasses.replace(attn, attn=dataclasses.replace(attn.attn, block_q=8,
                                                                 block_kv=16)))
    cfg = dataclasses.replace(cfg, n_layers=2, groups=(
        dataclasses.replace(cfg.groups[0], period=period, n_periods=1),))
    assert dryrun._length_fit(cfg) == (16, 16)

    def at(n):
        return dryrun.train_trace(cfg, ShapeCfg("t", n, 1, "train"), 1, memory=False)

    whole = at(64)
    got = cost.lengths(64, at, base=16, step=16)
    assert got.flops == whole.flops and got.f32_flops == whole.f32_flops
    assert got.launches == whole.launches and whole.launches["diag_scan"] > 0
    assert got.bytes == pytest.approx(whole.bytes, rel=1e-3)
    assert got.written == pytest.approx(whole.written, rel=1e-3)


def _shard_bytes(shapes_dtypes, specs, mesh_shape, dtype=None):
    return sum(math.prod(shard_shape(s, specs[n], mesh_shape))
               * torch.empty((), dtype=dtype or d).element_size()
               for n, (s, d) in shapes_dtypes.items())


def test_train_and_decode_cells_on_the_production_mesh(capsys):
    mesh = make_production_mesh()
    cfg = _smoke_train("goom-rnn-124m")
    rf = dryrun.lower_cell(cfg, ShapeCfg("t", 32, 32, "train"), mesh)
    mem = rf.memory_per_device
    model = DecoderLM(cfg, device="meta")
    specs = param_specs(make_rules(mesh), model)
    params = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    assert mem["rows"] == 2 and mem["batch_shards"] == 16 and rf.chips == 256
    assert mem["param_shard_bytes"] == _shard_bytes(params, specs, mesh.shape)
    assert mem["moment_shard_bytes"] == 2 * _shard_bytes(params, specs, mesh.shape,
                                                         torch.float32)
    # the trace is one rank's laid-out step: it holds the blocks and their
    # moments, and gathers a period at a time above them
    assert mem["trace_parameters_bytes"] == mem["param_shard_bytes"]
    assert mem["trace_state_bytes"] == mem["moment_shard_bytes"]
    assert mem["peak_bytes"] == mem["param_shard_bytes"] + mem["moment_shard_bytes"] \
        + mem["above_state_bytes"]
    assert mem["gathered_param_bytes"] == dryrun.gathered_bytes(
        model, rules=make_rules(mesh)) < dryrun.gathered_bytes(model) < mem["param_bytes"]
    assert rf.launches["lmme"] > 0 and rf.collective_bytes > 0
    assert rf.step_time_s == max(rf.compute_s, rf.memory_s, rf.collective_s) > 0
    # with scan_seq on "model", each goom layer adds the gather of its output
    # and an all-reduce of the gradients of A, B, C and D over the seq group
    shards = dryrun._time_shard_bytes(cfg, 2, 32, False)
    plain = dryrun.train_collectives(make_rules(mesh), params, specs)
    timed = dryrun.train_collectives(make_rules(mesh, {"scan_seq": "model"}), params, specs,
                                     time_shards=shards)
    extra = [(op.kind, op.result_bytes) for op in timed[len(plain):]]
    assert extra == [k for layer in shards for k in
                     [("all-gather", layer[0])] + [("all-reduce", b) for b in layer[1]]]
    assert len(shards) == cfg.n_layers and shards[0][0] == 2 * 2 * 32 * cfg.d_model

    dec = dryrun.lower_cell(cfg, ShapeCfg("d", 64, 128, "decode"), mesh)
    caches = model.init_caches(128, 64, device="meta")
    cspecs = dryrun.cache_specs(make_rules(mesh, dryrun._serve_overrides(
        cfg, ShapeCfg("d", 64, 128, "decode"), mesh, {})), caches)
    want = _shard_bytes({f"{i}.{k}": (tuple(v.shape), v.dtype) for i, layer in
                         enumerate(caches) for k, v in layer.items()}, cspecs, mesh.shape)
    assert dec.memory_per_device["cache_shard_bytes"] == want
    # a decode rank is laid out as a prefill rank: it holds its parameter
    # blocks and gathers a period at a time, without gradients
    dm = dec.memory_per_device
    assert dm["rows"] == 8 and dm["trace_parameters_bytes"] == mem["param_shard_bytes"]
    gathers = dryrun.train_collectives(make_rules(mesh), params, specs, grads=False,
                                       roles=model.split_roles(make_rules(mesh)))
    assert {op.kind for op in gathers} == {"all-gather"}
    ring = collective_bytes_per_device(gathers)[1]["all-gather"]
    assert dec.collective_by_kind["all-gather"] >= ring > 0
    assert dec.launches["lmme"] == 2 * cfg.n_layers   # B·u and the carry fold a layer
    assert "costed in" in capsys.readouterr().out


@pytest.fixture(scope="module")
def dtensor_steps():
    """Rank 0's collectives of a DTensor step without and with the cast
    (``remat="none"``), and without the cast under ``"full"`` (one process
    group for all)."""
    return spawn_ranks(workers.dtensor_step_collectives, 4,
                       [(False, "none"), (True, "none"), (False, "full")])[0]


def _check_collectives(r0, cast, remat):
    """The dry-run's collectives of the step against what rank 0 ran: the
    counts by kind and each (kind, result bytes)."""
    rules = make_rules(NamedMesh((2, 2), ("data", "model")))
    params = {n: (s, getattr(torch, d.split(".")[-1])) for n, (s, d) in r0["shapes"].items()}
    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True), remat=remat)
    ops = dryrun.train_collectives(rules, params, r0["specs"], cast_params_bf16=cast,
                                   n_metrics=r0["n_metrics"],
                                   counts=dryrun.gather_counts(cfg, params), roles=r0["roles"])
    # the split modules' activation collectives, as the rank's listener saw them
    ops += [CollectiveOp(kind, n, size) for kind, n, size in r0["split_ops"]]
    assert r0["split_ops"] and r0["roles"]
    counts = {}
    for op in ops:
        counts[op.kind] = counts.get(op.kind, 0) + 1
    assert counts == {k.replace("_into_tensor", "").replace("_tensor", "").replace("_", "-"): v
                      for k, v in r0["counts"].items()}
    assert sorted((op.kind, op.result_bytes) for op in ops) == sorted(map(tuple, r0["seen"]))
    assert all(op.group_size == 2 for op in ops)


@pytest.mark.parametrize("cast", [False, True])
def test_collectives_equal_a_dtensor_steps(cast, dtensor_steps):
    _check_collectives(dtensor_steps[cast], cast, "none")


def test_collectives_count_the_recomputed_gathers(dtensor_steps):
    """Under ``remat="full"`` each period's parameters are gathered again
    in its recomputation: twice the layers' all-gathers, the same
    reductions."""
    r0 = dtensor_steps[2]
    _check_collectives(r0, False, "full")
    assert r0["counts"]["all_gather_into_tensor"] > dtensor_steps[0]["counts"][
        "all_gather_into_tensor"]


def test_cast_params_bf16_tracks_jax():
    """2 AdamW steps from the same weights on the same batches with the f32
    parameters cast to bf16 for the forward (f32 compute otherwise):
    losses within rtol 1e-5 (module docstring)."""
    jcfg = dataclasses.replace(jax_get_config("goom-rnn-124m", smoke=True),
                               compute_dtype=jnp.float32, logit_chunk=16)
    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True),
                              compute_dtype=torch.float32, logit_chunk=16)
    jmodel = JaxLM(jcfg)
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    sched = dict(peak_lr=3e-3, warmup_steps=1, total_steps=4)
    jo = jopt.AdamW(jopt.cosine_schedule(**sched))
    jstep = jax_make_train_step(jmodel, jo, cast_params_bf16=True)

    def jax_step(state, batch):
        with jax_engine.use_backend("reference"):
            return jstep(state, batch)

    jax_step = jax.jit(jax_step)
    jstate = jax_init_train_state(jmodel, jo, jax.random.PRNGKey(0))._replace(params=jparams)
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    opt = AdamW(cosine_schedule(**sched))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, cast_params_bf16=True)
    got, want = [], []
    for i in range(2):
        b = SyntheticStream(DataConfig(task="copy", vocab=256, seq_len=32,
                                       global_batch=2)).generate(i)
        jstate, jm = jax_step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, to_device(b, "cpu"))
        want.append(float(jm["loss"]))
        got.append(float(m["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _heads16(arch):
    """``arch``'s smoke config with 16 query and KV heads of 4 and 256 MLP
    channels: every split the (16, 16) mesh's model axis can take."""
    cfg = get_config(arch, smoke=True)

    def blk(b):
        attn = dataclasses.replace(b.attn, n_heads=16, n_kv_heads=16, head_dim=4)
        return dataclasses.replace(b, attn=attn, mlp=dataclasses.replace(b.mlp, d_ff=256))

    from repro_torch.configs.base import transform_blocks

    return transform_blocks(dataclasses.replace(cfg, logit_chunk=16), blk)


def test_model_axis_shrinks_a_ranks_cells():
    """On the (16, 16) mesh a rank of a model whose heads, channels and
    vocabulary divide 16 runs its block: its train step's activations and
    FLOPs fall below those of the same cell with the split switched off,
    the split's all-reduces are counted and its weights' gathers over
    "model" are not, and its prefill holds its block of the KV heads,
    JAX's ``cache_shard_bytes``."""
    mesh = make_production_mesh()
    cfg = _heads16("olmo-1b")
    shape = ShapeCfg("t", 32, 32, "train")
    whole = dryrun.lower_cell(cfg, shape, mesh, rules_overrides=workers.FSDP_ONLY,
                              verbose=False)
    split = dryrun.lower_cell(cfg, shape, mesh, verbose=False)
    ws, ss = whole.memory_per_device, split.memory_per_device
    assert ss["trace_activations_bytes"] < ws["trace_activations_bytes"]
    assert ss["above_state_bytes"] < ws["above_state_bytes"]
    assert split.hlo_flops < whole.hlo_flops / 2
    # the activations' all-reduces are counted; the split weights' gathers
    # over "model" are gone
    assert split.collective_by_kind["all-reduce"] > whole.collective_by_kind["all-reduce"]
    assert split.collective_by_kind["all-gather"] < whole.collective_by_kind["all-gather"]
    pre = dryrun.lower_cell(cfg, ShapeCfg("p", 64, 32, "prefill"), mesh, verbose=False)
    mem = pre.memory_per_device
    kv = sum(v for k, v in mem.items() if k == "cache_shard_bytes")
    assert mem["cache_bytes"] == kv > 0


def test_rwkv6_rank_shrinks_by_the_model_axis():
    mesh = make_production_mesh()
    shape = ShapeCfg("train_4k_256", 256, 256, "train")
    whole = dryrun.lower_cell("rwkv6-7b", shape, mesh, rules_overrides=workers.FSDP_ONLY,
                              verbose=False).memory_per_device
    split = dryrun.lower_cell("rwkv6-7b", shape, mesh, verbose=False).memory_per_device
    # above the state: the activations and temporaries at the peak (the split's
    # in the backward, the whole's at the loss's vocabulary-wide logits)
    assert split["above_state_bytes"] < whole["above_state_bytes"] / 2
    assert split["trace_peak_forward_bytes"] < whole["trace_peak_forward_bytes"]
    assert split["gathered_param_bytes"] < whole["gathered_param_bytes"] / 4


def test_jamba_gathered_period_keeps_a_sixteenth_of_its_moe(monkeypatch):
    from repro_torch.models.mlp import Moe

    rules = make_rules(make_production_mesh())
    model = DecoderLM(get_config("jamba-v0.1"), device="meta")
    split = dryrun.gathered_bytes(model, rules=rules)
    moe = max(sum(p.numel() * p.element_size() for i in range(lo, hi)
                  for n, p in model.layers[i].named_parameters()
                  if n in ("channel.gate", "channel.up", "channel.down"))
              for lo, hi in model._periods)
    monkeypatch.setattr(Moe, "split_dims", lambda self, rules: (None, {}))
    whole = dryrun.gathered_bytes(model, rules=rules)
    assert moe > 0 and whole - split == moe * 15 // 16


def test_gemma3_decode_rank_holds_jax_cache_shard():
    rf = dryrun.lower_cell("gemma3-1b", "decode_32k", make_production_mesh(), verbose=False)
    mem = rf.memory_per_device
    assert mem["cache_bytes"] == mem["cache_shard_bytes"] > 0
    assert rf.collective_by_kind["all-reduce"] > 0     # the rows' combine
