"""The training slice of the PyTorch port against the JAX package.

JAX runs on the CPU; the port at ``device="cpu"`` (the kernels' plain
versions).  Weights come from the JAX model through ``params_from_jax``,
batches from the port's ``SyntheticStream`` (held equal to JAX's in
``test_torch_train_data.py``).  Tolerances, each stated where it is used:

  * loss: rtol 1e-5 (an f32 mean over the batch's labelled tokens);
  * gradients, per leaf: max |port - JAX| / max |JAX| <= 5e-4.  A probe on
    the plain path (smoke config, f32, B=2, S=64) found 9.7e-05 for
    ``shared_a`` and 1.5e-04 for ``generic``, both at ``layers.0.mixer.A``:
    the bound is three times the larger, and a wrong gradient is off by
    O(1);
  * optimizers on identical gradients: parameters within 1e-7 absolute
    (one f32 ulp at |p| ~ 1; the probe found 6e-8), moments within 1e-6 of
    each leaf's largest (FMA or not in b·m + (1-b)·g);
  * the 5-step loss trajectory: rtol 1e-3 per step.  Adam's first update is
    sign(g), so a gradient that rounds to the other side of zero moves its
    weight by 2·lr; a few such flips move the loss by far less than 1e-3.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.models.common import unzip
from repro.models.model import DecoderLM as JaxLM
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.train_loop import init_train_state as jax_init_train_state
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro_torch import DecoderLM, get_config, params_from_jax
from repro_torch.convert import jax_path, params_to_jax
from repro_torch.kernels import dispatch
from repro_torch.launch import train as launch_train
from repro_torch.train import (
    AdamW,
    CheckpointManager,
    DataConfig,
    Lion,
    SyntheticStream,
    constant_schedule,
    cosine_schedule,
    init_train_state,
    load_state_tree,
    make_train_step,
    state_tree,
)
from repro_torch.train.data import to_device
from torch_parity import with_scan_variant

torch.set_num_threads(2)

SEQ, BATCH = 32, 4
LOGIT_CHUNK = 16   # two CE pieces at SEQ = 32, in both packages


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, variant=None, **kw):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if variant is not None:
        jcfg, cfg = with_scan_variant(jcfg, variant), with_scan_variant(cfg, variant)
    return (dataclasses.replace(jcfg, compute_dtype=jnp.float32, **kw),
            dataclasses.replace(cfg, compute_dtype=torch.float32, **kw))


def _port_model(cfg, jparams):
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, _np_tree(jparams)))
    return model


def _batch(step=0, vocab=256, seq=SEQ, batch=BATCH):
    return SyntheticStream(DataConfig(task="copy", vocab=vocab, seq_len=seq,
                                      global_batch=batch)).generate(step)


def _jax_loss_fn(jmodel):
    def loss(params, tokens, labels):
        with jax_engine.use_backend("reference"):
            return jmodel.loss(params, tokens, labels)
    return loss


def _max_normalised(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module", params=["shared_a", "generic"])
def pair(request):
    """(variant, JAX model, JAX params, port cfg) at f32 compute, logit
    pieces of LOGIT_CHUNK tokens."""
    jcfg, cfg = _configs("goom-rnn-124m", request.param, logit_chunk=LOGIT_CHUNK)
    jmodel = JaxLM(jcfg)
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    return request.param, jmodel, jparams, cfg


def test_loss_and_grads_match_jax(pair):
    _, jmodel, jparams, cfg = pair
    b = _batch()
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel), has_aux=True))(
        jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    model = _port_model(cfg, jparams)
    tb = to_device(b, "cpu")
    loss, metrics = model.loss(tb["tokens"], tb["labels"])
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    assert set(metrics) == set(jmet) == {"ce_loss", "tokens", "loss"}
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmet[k]), rtol=1e-5)
    assert float(metrics["tokens"]) == BATCH * 16    # the copy task's labelled tokens
    want = params_from_jax(cfg, _np_tree(jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert bool(torch.isfinite(g).all()), name
        err = _max_normalised(g, want[name])
        assert err <= 5e-4, f"{name}: max-normalised grad error {err:.3e}"


def test_loss_pieces_do_not_change_the_loss(pair):
    """One CE piece or two: the same loss and gradients (to f32 rounding of
    the sum's order)."""
    _, _, jparams, cfg = pair
    tb = to_device(_batch(3), "cpu")
    out = []
    for chunk in (LOGIT_CHUNK, 512):
        model = _port_model(dataclasses.replace(cfg, logit_chunk=chunk), jparams)
        loss, _ = model.loss(tb["tokens"], tb["labels"])
        out.append((loss, torch.autograd.grad(loss, model.lm_head.w)[0]))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-6, atol=0)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="logit_chunk"):
        _port_model(dataclasses.replace(cfg, logit_chunk=12), jparams).loss(
            tb["tokens"], tb["labels"])


def test_train_trajectory_tracks_jax():
    """5 steps of AdamW (cosine, 2 warm-up steps) from the same weights on
    the same batches, ``shared_a``: the port's losses, grad norms and rates
    track JAX's train loop within rtol 1e-3 a step."""
    jcfg, cfg = _configs("goom-rnn-124m", "shared_a", logit_chunk=LOGIT_CHUNK)
    jmodel = JaxLM(jcfg)
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    sched = dict(peak_lr=3e-3, warmup_steps=2, total_steps=5)
    jo = jopt.AdamW(jopt.cosine_schedule(**sched))
    jstep = jax_make_train_step(jmodel, jo)

    def jax_step(state, batch):
        with jax_engine.use_backend("reference"):
            return jstep(state, batch)

    jax_step = jax.jit(jax_step)
    jstate = jax_init_train_state(jmodel, jo, jax.random.PRNGKey(0))
    jstate = jstate._replace(params=jparams)
    model = _port_model(cfg, jparams)
    opt = AdamW(cosine_schedule(**sched))
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    got, want = [], []
    for i in range(5):
        b = _batch(i)
        jstate, jm = jax_step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, to_device(b, "cpu"))
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    assert got[-1][0] < got[0][0]
    assert state.step == 5 and state.opt_state["step"] == 5
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-3)


def test_jamba_smoke_loss_and_aux_match_jax():
    """Jamba smoke (MoE with capacity routing in training) at f32: the loss
    and each aux term against JAX's, rtol 1e-5."""
    jcfg, cfg = _configs("jamba-v0.1")
    jmodel = JaxLM(jcfg)
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(1)))
    b = _batch(0, vocab=cfg.vocab, seq=40, batch=2)
    _, jmet = jax.jit(_jax_loss_fn(jmodel))(jparams, jnp.asarray(b["tokens"]),
                                            jnp.asarray(b["labels"]))
    model = _port_model(cfg, jparams)
    tb = to_device(b, "cpu")
    with torch.no_grad():
        loss, metrics = model.loss(tb["tokens"], tb["labels"])
    assert set(metrics) == set(jmet) == {"ce_loss", "tokens", "loss",
                                         "load_balance_loss", "router_z_loss"}
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    assert float(metrics["load_balance_loss"]) > 0 and float(metrics["router_z_loss"]) > 0
    np.testing.assert_allclose(
        float(loss), float(metrics["ce_loss"] + 0.01 * metrics["load_balance_loss"]
                           + metrics["router_z_loss"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizers, schedules, the decay mask, the param tree
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def goom_smoke_params():
    jcfg, cfg = jax_get_config("goom-rnn-124m", smoke=True), get_config("goom-rnn-124m",
                                                                       smoke=True)
    jparams, _ = unzip(jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(0)))
    return cfg, jparams


SCHEDULES = {
    "cosine": (lambda m: m.cosine_schedule(3e-3, 2, 10)),
    "constant": (lambda m: m.constant_schedule(1e-3)),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", ["adamw", "lion"])
def test_optimizer_matches_jax_on_the_same_grads(goom_smoke_params, name, schedule):
    """3 updates from the same parameters with the same numpy gradients,
    whose entries span 1e-9..1 (near-zero ones included)."""
    cfg, jparams = goom_smoke_params
    from repro_torch.train import optimizer as popt

    jo = {"adamw": jopt.AdamW, "lion": jopt.Lion}[name](SCHEDULES[schedule](jopt))
    po = {"adamw": AdamW, "lion": Lion}[name](SCHEDULES[schedule](popt))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape)
                                     * 10.0 ** rng.uniform(-9, 0, size=p.shape)
                                     ).astype(np.float32), jparams) for _ in range(3)]
    jstate, jp = jo.init(jparams), jparams
    update = jax.jit(jo.update)
    params = params_from_jax(cfg, _np_tree(jparams))
    state = po.init(params)
    mask = po.decay_mask(cfg, list(params))
    for g in grads:
        jp, jstate = update(g, jstate, jp)
        params, state = po.update(params_from_jax(cfg, g), state, params, mask)
    assert state["step"] == int(jstate["step"]) == 3
    want = params_from_jax(cfg, _np_tree(jp))
    for n in params:
        np.testing.assert_allclose(params[n].numpy(), want[n].numpy(), rtol=0, atol=1e-7,
                                   err_msg=n)
    for moment in [k for k in jstate if k != "step"]:
        wm = params_from_jax(cfg, _np_tree(jstate[moment]))
        for n in params:
            assert _max_normalised(state[moment][n], wm[n]) <= 1e-6, (moment, n)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedules_match_jax(schedule):
    from repro_torch.train import optimizer as popt

    js, ps = SCHEDULES[schedule](jopt), SCHEDULES[schedule](popt)
    for step in range(0, 14):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6, err_msg=str(step))


def test_clip_by_global_norm_matches_jax(goom_smoke_params):
    cfg, jparams = goom_smoke_params
    from repro_torch.train.optimizer import clip_by_global_norm

    rng = np.random.default_rng(3)
    g = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), jparams)
    for max_norm in (1.0, 1e4):
        jclipped, jnorm = jopt.clip_by_global_norm(g, max_norm)
        clipped, norm = clip_by_global_norm(params_from_jax(cfg, g), max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        want = params_from_jax(cfg, _np_tree(jclipped))
        for n in want:
            np.testing.assert_allclose(clipped[n].numpy(), want[n].numpy(), rtol=2e-6,
                                       atol=1e-9)


@pytest.mark.parametrize("arch", ["goom-rnn-124m", "jamba-v0.1"])
def test_decay_mask_matches_jax(arch):
    """The mask keys on the JAX tree path: equal to JAX's own mask leaf for
    leaf, and not derived from the port's names."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams, _ = unzip(jax.eval_shape(JaxLM(jcfg).init, jax.random.PRNGKey(0)))
    jmask = jax.tree.map(lambda m, p: np.full(p.shape, m),
                         jopt.AdamW(jopt.constant_schedule(1.0))._decay_mask(jparams), jparams)
    want = {n: bool(v.all()) for n, v in params_from_jax(cfg, jmask).items()}
    assert all(bool(v.all()) == bool(v.any()) for v in params_from_jax(cfg, jmask).values())
    model = DecoderLM(cfg, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    for opt in (AdamW(constant_schedule(1.0)), Lion(constant_schedule(1.0))):
        assert opt.decay_mask(cfg, names) == want
    assert any(want.values()) and not all(want.values())


@pytest.mark.parametrize("arch", ["goom-rnn-124m", "jamba-v0.1"])
def test_params_to_jax_inverts_params_from_jax(arch):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rng = np.random.default_rng(2)   # every leaf distinct, in the JAX tree's shapes
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype),
                        unzip(jax.eval_shape(JaxLM(jcfg).init, jax.random.PRNGKey(2)))[0])
    back = params_to_jax(cfg, params_from_jax(cfg, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_jax_path_names_group_block_and_period():
    cfg = get_config("goom-rnn-124m")
    assert jax_path(cfg, "layers.3.mixer.A") == ("group_0.b0.mixer.A", 3)
    assert jax_path(cfg, "lm_head.w") == ("lm_head.w", None)
    jamba = get_config("jamba-v0.1")   # 4 periods of 8 blocks
    assert jax_path(jamba, "layers.13.channel.router.w") == ("group_0.b5.channel.router.w", 1)
    smoke = get_config("jamba-v0.1", smoke=True)   # one period: not stacked
    assert jax_path(smoke, "layers.4.mixer_norm.scale") == ("group_0.b4.mixer_norm.scale", None)


# ---------------------------------------------------------------------------
# the train loop: microbatches, learning, resume, checkpoints both ways
# ---------------------------------------------------------------------------
class _Capture:
    """An optimizer that records the gradients it is given and moves nothing."""

    schedule = staticmethod(constant_schedule(0.0))

    def __init__(self):
        self.grads = None

    def init(self, params):
        return {"step": 0}

    def decay_mask(self, cfg, names):
        return {n: True for n in names}

    def update(self, grads, state, params, decay):
        self.grads = {n: g.clone() for n, g in grads.items()}
        return params, dict(state, step=state["step"] + 1)


def test_microbatched_grads_match_full_batch(goom_smoke_params):
    """Accumulated gradients of 4 microbatches equal the full batch's (each
    microbatch holds the same count of labelled tokens, so means compose);
    f32 compute, within 1e-5 of the largest gradient entry."""
    cfg, jparams = goom_smoke_params
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    b = to_device(_batch(0, seq=64, batch=8), "cpu")
    got = []
    for mb in (1, 4):
        model = _port_model(cfg, jparams)
        cap = _Capture()
        step = make_train_step(model, cap, max_grad_norm=1e9, microbatches=mb)
        _, metrics = step(init_train_state(model, cap), b)
        got.append((cap.grads, metrics))
    (g1, m1), (g4, m4) = got
    gmax = max(float(g.abs().max()) for g in g1.values())
    for n in g1:
        torch.testing.assert_close(g4[n], g1[n], rtol=0, atol=1e-5 * gmax)
    np.testing.assert_allclose(float(m4["ce_loss"]), float(m1["ce_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m4["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)


def _setup(seed=0, lr=3e-3):
    cfg = get_config("goom-rnn-124m", smoke=True)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    opt = AdamW(constant_schedule(lr))
    stream = SyntheticStream(DataConfig(task="copy", vocab=cfg.vocab, seq_len=64,
                                        global_batch=8))
    return cfg, model, opt, init_train_state(model, opt), stream


def test_loss_decreases_on_copy_task():
    _, model, opt, state, stream = _setup()
    step = make_train_step(model, opt)
    first = last = None
    for i in range(30):
        state, metrics = step(state, to_device(stream.generate(i), "cpu"))
        if first is None:
            first = float(metrics["ce_loss"])
        last = float(metrics["ce_loss"])
    assert np.isfinite(last) and last < first - 0.2, (first, last)


def test_resume_is_bit_exact(tmp_path):
    """4 straight steps equal 2 steps, a checkpoint, a restore into a model
    built from other weights, and 2 more steps: bit for bit."""
    cfg, model_a, opt, sa, stream = _setup()
    step_a = make_train_step(model_a, opt)
    for i in range(4):
        sa, _ = step_a(sa, to_device(stream.generate(i), "cpu"))

    _, model_b, _, sb, _ = _setup()
    step_b = make_train_step(model_b, opt)
    for i in range(2):
        sb, _ = step_b(sb, to_device(stream.generate(i), "cpu"))
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(2, state_tree(cfg, sb), extra={"data": {"step": 2}})
    for p in model_b.parameters():   # moved after the save: the files keep step 2
        p.data.add_(1.0)

    _, model_c, _, sc, _ = _setup(seed=1)
    restored = mgr.restore_latest(state_tree(cfg, sc))
    assert restored is not None and restored[0] == 2 and restored[2] == {"data": {"step": 2}}
    sc = load_state_tree(cfg, sc, restored[1])
    assert sc.step == 2 and sc.opt_state["step"] == 2
    step_c = make_train_step(model_c, opt)
    for i in range(2, 4):
        sc, _ = step_c(sc, to_device(stream.generate(i), "cpu"))
    for n, p in sa.params.items():
        assert torch.equal(p, sc.params[n]), n
    for n, m in sa.opt_state["nu"].items():
        assert torch.equal(m, sc.opt_state["nu"][n]), n


def test_checkpoint_layout_is_atomic_and_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "step": np.asarray(5, np.int32)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, extra={"data": {"step": s}})
    os.makedirs(tmp_path / "step_9.tmp")                   # a save cut mid-write
    os.makedirs(tmp_path / "step_8")                       # no COMPLETE marker
    assert mgr.all_steps() == [2, 3, 4] and mgr.latest_step() == 4
    d = tmp_path / "step_4"
    assert sorted(os.listdir(d)) == ["COMPLETE", "a.b.p0s0.npy", "index.json",
                                     "step.p0s0.npy"]
    index = json.loads((d / "index.json").read_text())
    assert index["step"] == 4 and index["extra"] == {"data": {"step": 4}}
    assert index["leaves"]["a.b"] == {"shape": [2, 3], "dtype": "float32", "n_shards": 1}
    out, _ = mgr.restore(4, tree)
    np.testing.assert_array_equal(out["a"]["b"], tree["a"]["b"])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(4, {"a": {"b": np.zeros((3, 2))}})
    with pytest.raises(KeyError):
        mgr.restore(4, {"c": np.zeros(1)})


def test_async_write_error_is_raised_by_wait(tmp_path):
    d = tmp_path / "ckpt"
    mgr = CheckpointManager(str(d))
    mgr.save(1, {"x": np.zeros(2)})
    assert mgr.latest_step() == 1            # waits for the write in flight
    shutil.rmtree(d)
    d.write_text("not a directory")          # the next write cannot make step_2.tmp
    mgr.save(2, {"x": np.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                               # raised once


@pytest.fixture(scope="module")
def jax_train_state():
    jcfg = jax_get_config("goom-rnn-124m", smoke=True)
    jmodel = JaxLM(jcfg)
    jo = jopt.AdamW(jopt.constant_schedule(1e-3))
    state = jax.jit(lambda k: jax_init_train_state(jmodel, jo, k))(jax.random.PRNGKey(4))
    rng = np.random.default_rng(4)   # moments made nonzero
    state = state._replace(
        opt_state={"mu": jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                                      state.params),
                   "nu": jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                                      state.params),
                   "step": jnp.asarray(7, jnp.int32)},
        step=jnp.asarray(7, jnp.int32))
    return jax.tree.map(np.asarray, state)


def test_jax_written_checkpoint_restores_into_the_port(tmp_path, jax_train_state):
    cfg = get_config("goom-rnn-124m", smoke=True)
    JaxCheckpointManager(str(tmp_path), async_save=False).save(
        7, jax_train_state, extra={"data": {"step": 7}})
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    state = init_train_state(model, AdamW(constant_schedule(1e-3)))
    step, tree, extra = CheckpointManager(str(tmp_path)).restore_latest(state_tree(cfg, state))
    state = load_state_tree(cfg, state, tree)
    assert step == 7 and extra == {"data": {"step": 7}}
    assert state.step == 7 and state.opt_state["step"] == 7
    js = jax_train_state
    for got, want in ((state.params, js.params), (state.opt_state["mu"], js.opt_state["mu"]),
                      (state.opt_state["nu"], js.opt_state["nu"])):
        want = params_from_jax(cfg, want)
        for n in want:
            assert torch.equal(got[n], want[n]), n
    assert torch.equal(dict(model.named_parameters())["layers.1.mixer.A"],
                       torch.tensor(js.params["group_0"]["b0"]["mixer"]["A"][1]))


def test_port_written_checkpoint_restores_in_jax(tmp_path, jax_train_state):
    cfg = get_config("goom-rnn-124m", smoke=True)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    opt = AdamW(constant_schedule(1e-3))
    state, metrics = make_train_step(model, opt)(init_train_state(model, opt),
                                                 to_device(_batch(0), "cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_tree(cfg, state), extra={"data": {"step": 1}})
    mgr.wait()
    js = jax_train_state
    target = {"params": js.params, "opt_state": js.opt_state, "step": js.step}
    got, extra = JaxCheckpointManager(str(tmp_path)).restore(1, target)
    assert extra == {"data": {"step": 1}}
    assert int(got["step"]) == 1 and int(got["opt_state"]["step"]) == 1
    assert got["step"].dtype == jnp.int32
    for tree, want in ((got["params"], state.params), (got["opt_state"]["mu"],
                                                       state.opt_state["mu"]),
                       (got["opt_state"]["nu"], state.opt_state["nu"])):
        back = params_from_jax(cfg, _np_tree(tree))
        for n in want:
            assert torch.equal(back[n], want[n].detach()), n


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
ARGV = ["--smoke", "--task", "copy", "--seq-len", "32", "--batch", "4", "--log-every", "1"]


def test_launcher_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    _, state, metrics = launch_train.main(ARGV + ["--device", "cpu", "--steps", "3"] + ckpt)
    assert state.step == 3 and np.isfinite(float(metrics["loss"]))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    _, resumed, _ = launch_train.main(ARGV + ["--device", "cpu", "--steps", "5"] + ckpt)
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 3" in out and "done: 2 steps" in out
    assert resumed.step == 5 and CheckpointManager(str(tmp_path)).latest_step() == 5


def test_launcher_without_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(dispatch, "current_platform", lambda: "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(ARGV + ["--steps", "1"])


def test_example_trains_the_smoke_config(monkeypatch, capsys):
    import runpy

    monkeypatch.setattr("sys.argv", ["train_goom_rnn_torch.py", "--device", "cpu",
                                     "--steps", "2", "--seq-len", "48", "--batch", "4"])
    runpy.run_path(str(os.path.join(os.path.dirname(__file__), "..", "examples",
                                    "train_goom_rnn_torch.py")), run_name="__main__")
    assert "done: 2 steps" in capsys.readouterr().out
