"""Remat (``LMConfig.remat``) and Mamba's float scan (``MambaCfg.scan_impl``)
in the port, against the port itself and the JAX package.

At f32 on the CPU (the kernels' plain versions):

  * under ``full`` and ``dots`` the loss and every gradient equal the port's
    ``none`` within 1e-6 relative (max |g - g_none| / max |g_none| per
    leaf), for goom-rnn smoke in both scan variants and Jamba smoke;
  * the port's ``none`` is held to JAX's ``jax.value_and_grad(model.loss)``
    under each of JAX's ``remat`` values: loss rtol 1e-5, gradients within
    5e-4 of the leaf's largest (``test_torch_train.py``'s bound), or of
    1e-5 of the model's largest gradient where a leaf's is smaller.  Jamba
    smoke's Mamba Δ and A leaves have gradients of 1e-7 to 1e-9, five to
    seven orders below the model's largest; there XLA's and PyTorch's f32
    sums of the GOOM scan's backward part by up to 5 % of the leaf (2e-10
    of the model's largest gradient, measured on this input);
  * the backward of ``full`` and ``dots`` re-runs the forward's GOOM ops
    (the engine's call counts double), ``none`` runs none again, and remat
    is off with caches and without grad;
  * Mamba's ``float`` ``segment_states`` equals JAX's within 1e-6, Jamba
    smoke logits under ``float`` equal JAX's ``float`` within 1e-5, and
    ``float`` equals ``goom`` within 1e-4 of the logits' spread at smoke
    decays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import jamba_v01 as jax_jamba
from repro.core import engine as jax_engine
from repro.models.common import unzip
from repro.models.model import DecoderLM as JaxLM
from repro.models.ssm import segment_states as jax_segment_states
from repro_torch import DecoderLM, get_config, params_from_jax
from repro_torch.configs import jamba_v01
from repro_torch.core import engine
from repro_torch.models.ssm import segment_states
from repro_torch.train import DataConfig, SyntheticStream
from torch_parity import with_scan_variant

torch.set_num_threads(2)

SEQ, BATCH = 32, 2
CASES = [("goom-rnn-124m", "shared_a"), ("goom-rnn-124m", "generic"), ("jamba-v0.1", None)]


def _configs(arch, variant):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if variant is not None:
        jcfg, cfg = with_scan_variant(jcfg, variant), with_scan_variant(cfg, variant)
    return (dataclasses.replace(jcfg, compute_dtype=jnp.float32, logit_chunk=16),
            dataclasses.replace(cfg, compute_dtype=torch.float32, logit_chunk=16))


def _batch(vocab):
    b = SyntheticStream(DataConfig(task="copy", vocab=vocab, seq_len=SEQ,
                                   global_batch=BATCH)).generate(0)
    return {k: np.asarray(v) for k, v in b.items()}


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1] or 'goom'}")
def case(request):
    """(JAX cfg, JAX params, port cfg, batch, port (loss, grads) per remat)."""
    arch, variant = request.param
    jcfg, cfg = _configs(arch, variant)
    jparams, _ = unzip(jax.jit(JaxLM(jcfg).init)(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(np.asarray, jparams)
    b = _batch(cfg.vocab)
    port = {r: _port_loss_grads(dataclasses.replace(cfg, remat=r), jparams, b)
            for r in ("none", "dots", "full")}
    return jcfg, jparams, cfg, b, port


def _port_loss_grads(cfg, jparams, b):
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jparams))
    engine.reset_calls()
    loss, _ = model.loss(torch.as_tensor(b["tokens"]), torch.as_tensor(b["labels"]))
    fwd = dict(engine.calls)
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    bwd = {k: engine.calls[k] - fwd[k] for k in fwd}
    return loss.detach(), grads, fwd, bwd


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_equals_none(case, remat):
    *_, port = case
    loss0, grads0, _, _ = port["none"]
    loss, grads, _, _ = port[remat]
    assert abs(float(loss) - float(loss0)) <= 1e-6 * abs(float(loss0))
    assert set(grads) == set(grads0)
    for name, g in grads.items():
        assert _rel(g, grads0[name]) <= 1e-6, name


def test_backward_recomputes_the_forward_under_remat(case):
    """The engine's calls in the backward: Mamba's chunk steps are
    checkpointed on their own (their diagonal scans run again under every
    remat), and ``full``/``dots`` re-run every GOOM op of the forward once
    more (a period's; the kernels are not dots)."""
    *_, port = case
    _, _, fwd, bwd = port["none"]
    chunk = {k: v if k.startswith("diagonal_scan") else 0 for k, v in fwd.items()}
    assert sum(fwd.values()) > 0 and bwd == chunk
    for remat in ("full", "dots"):
        _, _, fwd_r, bwd_r = port[remat]
        assert fwd_r == fwd
        assert bwd_r == {k: fwd[k] + chunk[k] for k in fwd}


@pytest.mark.parametrize("jremat", ["none", "dots", "full"])
def test_port_none_matches_jax_under_each_remat(case, jremat):
    jcfg, jparams, cfg, b, port = case
    jmodel = JaxLM(dataclasses.replace(jcfg, remat=jremat))

    def loss_fn(params, tokens, labels):
        with jax_engine.use_backend("reference"):
            return jmodel.loss(params, tokens, labels)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    loss, grads, _, _ = port["none"]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    floor = 1e-5 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        scale = max(float(want[name].abs().max()), floor)
        assert float((g - want[name]).abs().max()) <= 5e-4 * scale, name


def test_remat_is_off_with_caches_and_without_grad():
    cfg = dataclasses.replace(get_config("goom-rnn-124m", smoke=True),
                              compute_dtype=torch.float32, remat="full")
    model = DecoderLM(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(tokens)
    got = model(tokens)
    assert got.grad_fn is not None
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    engine.reset_calls()
    logits, _ = model.prefill(tokens, model.init_caches(2))
    fwd = sum(engine.calls.values())
    logits.sum().backward()
    assert sum(engine.calls.values()) == fwd      # nothing recomputed


def test_unknown_remat_and_scan_impl_raise():
    cfg = get_config("goom-rnn-124m", smoke=True)
    with pytest.raises(ValueError, match="remat"):
        DecoderLM(dataclasses.replace(cfg, remat="some"), device="cpu")
    with pytest.raises(ValueError, match="scan_impl"):
        DecoderLM(jamba_v01._make(64, 8, 4, 2, 128, 256, 4, "x", d_state=4, chunk=8,
                                  scan_impl="fast"), device="cpu")


# ---------------------------------------------------------------------------
# Mamba's float baseline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("length", [1, 5, 8, 13])
def test_float_segment_states_equal_jax(length):
    rng = np.random.default_rng(length)
    log_a = -rng.uniform(0.0, 0.5, size=(length, 2, 3, 4)).astype(np.float32)
    b = rng.normal(size=(length, 2, 3, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    want_s, want_h = jax.jit(lambda *a: jax_segment_states(*a, impl="float"))(log_a, b, h0)
    got_s, got_h = segment_states(*(torch.as_tensor(x) for x in (log_a, b, h0)), "float")
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-6, atol=1e-6)


def _jamba_pair(impl):
    args = (64, 8, 4, 2, 128, 256, 4, "jamba-v0.1-smoke")
    jcfg = jax_jamba._make(*args, d_state=4, chunk=8, scan_impl=impl)
    cfg = jamba_v01._make(*args, d_state=4, chunk=8, scan_impl=impl)
    assert cfg.layer_list[0].mamba.scan_impl == impl
    return (dataclasses.replace(jcfg, compute_dtype=jnp.float32),
            dataclasses.replace(cfg, compute_dtype=torch.float32))


def test_jamba_float_logits_equal_jax_and_goom():
    jcfg, cfg = _jamba_pair("float")
    jmodel = JaxLM(jcfg)
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(2)))
    jparams = jax.tree.map(np.asarray, jparams)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    with jax_engine.use_backend("reference"):
        want, _, _ = jax.jit(jmodel.apply)(jparams, jnp.asarray(tokens))
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jparams))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    _, gcfg = _jamba_pair("goom")
    goom = DecoderLM(gcfg, device="cpu")
    goom.load_state_dict(model.state_dict())
    with torch.no_grad():
        other = goom(torch.as_tensor(tokens)).numpy()
    assert np.abs(other - got).max() <= 1e-4 * got.std()
