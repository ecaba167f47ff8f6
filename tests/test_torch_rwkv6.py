"""RWKV6 in the PyTorch port against the JAX package, on the CPU.

Same numpy inputs (or the same weights, carried by ``params_from_jax`` or a
module's own state dict, with zero-initialised leaves perturbed so that they
take part) through both, at f32 compute:

  * the chunked WKV scan, ``"goom"`` (the scores one ``engine.lmme`` call a
    chunk) and ``"float"``, at chunks 8, 16 and 32 over a length that is no
    multiple of the chunk, from a nonzero state; and at a decay of e^-60 a
    step, where the GOOM form stays finite and equal to JAX's while the
    float form overflows in both packages;
  * the time mix and the channel mix, full sequence and chunked with a
    carried state, and decode continuation through the block;
  * the smoke model's logits at 1 and 2 layers, and
    ``params_to_jax(params_from_jax(tree))`` giving the tree back;
  * chunked prefill at chunks 1, 7 and 64 against JAX's dense caches, leaf
    by leaf;
  * the port's ``Engine`` against JAX's at horizons 1 and 8 and chunks 1, 7
    and 64, and prefix hits through carry checkpoints alone (the model has
    no paged layer) bit-identical to misses;
  * ``slot_cache_bytes`` of a model with no paged layer;
  * a ``BackgroundServer`` over the smoke config serving a few tokens.

Tolerance: 1e-5 absolute for modules, 1e-4·std for logits, tokens equal up
to a near tie (``torch_parity.check_tokens``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jax_engine
from repro.models import blocks as jblocks
from repro.models import ssm as jssm
from repro.models.common import KeyGen, unzip
from repro_torch import Engine, Request
from repro_torch.configs import BlockCfg, Rwkv6Cfg
from repro_torch.convert import params_to_jax
from repro_torch.core import engine
from repro_torch.kernels.lmme import lmme_cuda
from repro_torch.models import Block
from repro_torch.models.ssm import (
    Rwkv6ChannelMix,
    Rwkv6TimeMix,
    rwkv6_init_state,
    rwkv6_scan,
)
from torch_parity import (
    check_engine_against_jax,
    check_prefill_caches,
    check_prefix_hits_bit_identical,
    n,
    serve_pair,
    state_dict_of,
    t,
)

torch.set_num_threads(2)
F32 = dict(compute_dtype=jnp.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), rtol=0, atol=atol)


def _scan_inputs(seed, b=2, s=37, h=3, d=8, decay=None):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.normal(size=(b, s, h, d)) for _ in range(3))
    if decay is None:   # decays e^-0.14 .. e^-1 a step
        log_a = -np.exp(rng.uniform(-2.0, 0.0, size=(b, s, h, d)))
    else:
        log_a = np.full((b, s, h, d), decay)
    u = 0.1 * rng.normal(size=(h, d))
    h0 = 0.1 * rng.normal(size=(b, h, d, d))
    return [x.astype(np.float32) for x in (r, k, v, log_a, u, h0)]


def _jax_scan(impl, chunk, r, k, v, log_a, u, h0):
    jcfg = jssm.Rwkv6Cfg(d_model=r.shape[2] * r.shape[3], d_ff=8, head_dim=r.shape[3],
                         chunk=chunk, scan_impl=impl)

    def f(r, k, v, log_a, u, h0):
        with jax_engine.use_backend("xla_reference"):
            return jssm._rwkv6_scan(r, k, v, log_a, u, jcfg, h0=h0)

    return jax.jit(f)(r, k, v, log_a, u, h0)


def _port_scan(impl, chunk, r, k, v, log_a, u, h0):
    cfg = Rwkv6Cfg(d_model=r.shape[2] * r.shape[3], d_ff=8, head_dim=r.shape[3],
                   chunk=chunk, scan_impl=impl)
    return rwkv6_scan(t(r), t(k), t(v), t(log_a), t(u), cfg, h0=t(h0))


# ---------------------------------------------------------------------------
# the WKV scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("impl", ["goom", "float"])
def test_rwkv6_scan_matches_jax(impl, chunk):
    """37 steps (identity-padded to whole chunks) from a nonzero state; the
    GOOM form makes one engine LMME call a chunk, the float form none."""
    x = _scan_inputs(chunk)
    want_y, want_s = _jax_scan(impl, chunk, *x)
    engine.reset_calls()
    launches = lmme_cuda.launches
    got_y, got_s = _port_scan(impl, chunk, *x)
    assert engine.calls["lmme"] == (-(-37 // chunk) if impl == "goom" else 0)
    assert lmme_cuda.launches == launches   # the CPU launches no kernel
    _close(got_y, want_y)
    _close(got_s, want_s)


def test_rwkv6_scan_strong_decay_goom_finite_and_equal_to_jax():
    """A decay of e^-60 a step over a 64-token chunk: the in-chunk ratios
    A_i / A_j reach e^±3780, far outside f32.  The GOOM form stays finite and
    equal to JAX's (and to the sequential recurrence); the float form's
    products overflow, in JAX as in the port."""
    x = _scan_inputs(7, b=1, s=64, h=2, d=8, decay=-60.0)
    got_y, got_s = _port_scan("goom", 64, *x)
    want_y, want_s = _jax_scan("goom", 64, *x)
    assert np.isfinite(n(got_y)).all() and np.isfinite(n(got_s)).all()
    _close(got_y, want_y)
    _close(got_s, want_s)
    # the recurrence step by step in float64: S_t = a_t S_{t-1} + k_t v_t^T
    r, k, v, log_a, u, h0 = (np.asarray(a, np.float64) for a in x)
    S, ys = h0.copy(), []
    for i in range(r.shape[1]):
        kv = np.einsum("bhk,bhv->bhkv", k[:, i], v[:, i])
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, i], S + u[None, :, :, None] * kv))
        S = np.exp(log_a[:, i])[..., None] * S + kv
    # at |log| ~ 3780 an f32 log holds a value to ~2.4e-4 of itself: the
    # JAX package's own tolerance for this check (tests/test_ssm_blocks.py)
    np.testing.assert_allclose(n(got_y), np.stack(ys, axis=1), rtol=1e-3, atol=1e-3)
    float_y, _ = _port_scan("float", 64, *x)
    jfloat_y, _ = _jax_scan("float", 64, *x)
    assert not np.isfinite(n(float_y)).all()
    assert not np.isfinite(np.asarray(jfloat_y)).all()


# ---------------------------------------------------------------------------
# the mixes and the block
# ---------------------------------------------------------------------------
RWKV = dict(d_model=16, d_ff=24, head_dim=4, lora_mix=4, lora_decay=6, chunk=4)


def _perturbed(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: (np.asarray(v) + scale * rng.normal(size=v.shape))
                        .astype(np.float32), tree)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _time_mix_pair(impl):
    jcfg = jssm.Rwkv6Cfg(**RWKV, scan_impl=impl)
    p, _ = unzip(jssm.rwkv6_time_mix_init(KeyGen(jax.random.PRNGKey(1)), jcfg))
    p = _perturbed(p, 2)
    layer = Rwkv6TimeMix(Rwkv6Cfg(**RWKV, scan_impl=impl), device="cpu")
    layer.load_state_dict(state_dict_of(p))
    return jcfg, p, layer


def _jax_time_mix(jcfg, p, x, state):
    def f(p, x, state):
        with jax_engine.use_backend("xla_reference"):
            return jssm.rwkv6_time_mix_apply(p, x, jcfg, state=state, **F32)

    return jax.jit(f)(p, x, state)


@pytest.mark.parametrize("impl", ["goom", "float"])
def test_time_mix_full_sequence_matches_jax(impl):
    jcfg, p, layer = _time_mix_pair(impl)
    assert set(layer.state_dict()) == set(state_dict_of(p))
    x = _x((2, 13, 16), 3)
    want, _ = _jax_time_mix(jcfg, p, x, None)
    with torch.no_grad():
        got, st = layer(t(x), compute_dtype=torch.float32)
    assert st is None
    _close(got, want)


def test_time_mix_chunked_and_decode_continuation_match_jax():
    jcfg, p, layer = _time_mix_pair("goom")
    x = _x((2, 11, 16), 4)
    jstate = jssm.rwkv6_init_state(2, jcfg)
    state = rwkv6_init_state(2, layer.cfg, device="cpu")
    for lo, hi in ((0, 6), (6, 9), (9, 10), (10, 11)):   # chunks, then decode
        want, jstate = _jax_time_mix(jcfg, p, x[:, lo:hi], jstate)
        with torch.no_grad():
            got, state = layer(t(x[:, lo:hi]), state=state, compute_dtype=torch.float32)
        _close(got, want)
        assert set(state) == set(jstate) == {"x_prev", "wkv"}
        for k in state:
            assert state[k].dtype == torch.float32
            _close(state[k], jstate[k])


def test_channel_mix_matches_jax():
    jcfg = jssm.Rwkv6Cfg(**RWKV)
    p, _ = unzip(jssm.rwkv6_channel_mix_init(KeyGen(jax.random.PRNGKey(5)), jcfg))
    p = _perturbed(p, 6)
    layer = Rwkv6ChannelMix(Rwkv6Cfg(**RWKV), device="cpu")
    layer.load_state_dict(state_dict_of(p))
    x, prev = _x((2, 7, 16), 7), _x((2, 1, 16), 8)
    for xp in (None, prev):
        want = jax.jit(lambda p, x, xp: jssm.rwkv6_channel_mix_apply(
            p, x, jcfg, x_prev=xp, **F32))(p, x, xp)
        with torch.no_grad():
            got = layer(t(x), x_prev=None if xp is None else t(xp),
                        compute_dtype=torch.float32)
        _close(got, want)


def test_block_decode_continuation_matches_jax():
    """The rwkv6 + rwkv6_cm block (LayerNorms) over a prompt chunk and
    then token by token: outputs and the flat cache (x_prev, wkv, cm_x_prev:
    the channel mix's *normed* input) equal JAX's nested one."""
    jblk = jblocks.BlockCfg(mixer="rwkv6", channel="rwkv6_cm",
                            rwkv=jssm.Rwkv6Cfg(**RWKV), norm="ln")
    p, _ = unzip(jblocks.block_init(KeyGen(jax.random.PRNGKey(9)), jblk))
    p = _perturbed(p, 10)
    blk = Block(BlockCfg(mixer="rwkv6", channel="rwkv6_cm", rwkv=Rwkv6Cfg(**RWKV),
                         norm="ln"), device="cpu")
    blk.load_state_dict(state_dict_of(p))
    x = _x((2, 9, 16), 11)
    jcache = jblocks.block_init_cache(jblk, 2, 16)
    cache = {"x_prev": t(jcache["rwkv"]["x_prev"]), "wkv": t(jcache["rwkv"]["wkv"]),
             "cm_x_prev": t(jcache["cm_x_prev"])}
    step = jax.jit(lambda p, x, pos, c: jblocks.block_apply(
        p, x, jblk, positions=pos, mrope_positions=None, cache=c, **F32))
    for lo, hi in ((0, 5), (5, 6), (6, 7), (7, 9)):
        pos = np.broadcast_to(np.arange(lo, hi), (2, hi - lo)).astype(np.int32)
        want, jcache, _ = step(p, x[:, lo:hi], pos, jcache)
        with torch.no_grad():
            got, cache, aux = blk(t(x[:, lo:hi]), positions=t(pos, torch.long),
                                  cache=cache, compute_dtype=torch.float32)
        assert aux == {}
        _close(got, want)
        flat = {**jcache["rwkv"], "cm_x_prev": jcache["cm_x_prev"]}
        assert set(cache) == set(flat)
        for k in cache:
            _close(cache[k], flat[k])


# ---------------------------------------------------------------------------
# the model and serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[1, 2], ids=["1layer", "2layers"])
def pair(request):
    """(JAX model, JAX params, port model) of rwkv6-7b's smoke config at f32
    compute with ``request.param`` layers (JAX stacks two), weights
    perturbed by N(0, 0.05²)."""
    return serve_pair("rwkv6-7b", periods=request.param, perturb=0.05)


def test_logits_match_jax_and_params_round_trip(pair):
    jmodel, jparams, model = pair
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab, size=(2, 37))
    with jax_engine.use_backend("xla_reference"):
        want = np.asarray(jax.jit(lambda p, x: jmodel.apply(p, x)[0])(jparams, toks))
    engine.reset_calls()
    with torch.no_grad():
        got = model(t(toks, torch.long)).numpy()
    # one LMME a layer and 16-token scan chunk
    assert engine.calls["lmme"] == model.cfg.n_layers * 3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(want.std()))
    back = params_to_jax(model.cfg, model.state_dict())
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)
    flat_b = jax.tree_util.tree_flatten_with_path(back)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    for (pj, vj), (pb, vb) in zip(flat_j[0], flat_b[0]):
        assert pj == pb
        np.testing.assert_array_equal(np.asarray(vj), vb)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_prefill_matches_jax_dense_caches(pair, chunk):
    jmodel, jparams, model = pair
    seq = np.random.default_rng(2).integers(0, model.cfg.vocab, size=70).tolist()
    check_prefill_caches(jmodel, jparams, model, seq, chunk, 80)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_engine_matches_jax_engine(pair, chunk):
    jmodel, jparams, model = pair
    check_engine_against_jax(jmodel, jparams, model, chunk)


@pytest.mark.parametrize("chunk", [7, 64])
def test_prefix_hits_through_checkpoints_bit_identical(pair, chunk):
    """No layer of RWKV6 is paged: a hit restores the carry checkpoint
    (token-shift rows and WKV states) alone."""
    _, _, model = pair
    assert not any("pages" in layer for layer in model.init_slot_caches(2, 64, page_size=8))
    check_prefix_hits_bit_identical(model, chunk)


def test_slot_cache_bytes_without_a_paged_layer(pair):
    """Every leaf is recurrent and fixed-size, as JAX counts them; page
    settings change nothing."""
    from repro.serve import slot_cache_bytes as jax_bytes
    from repro_torch.serve import slot_cache_bytes

    jmodel, _, model = pair
    got, want = slot_cache_bytes(model, 3, 40), jax_bytes(jmodel, 3, 40)
    assert got == want and got["kv_pages"] == 0
    d, hd = model.cfg.d_model, model.cfg.layer_list[0].rwkv.head_dim
    assert got["recurrent"] == 3 * model.cfg.n_layers * 4 * (2 * d + d * hd)
    assert slot_cache_bytes(model, 3, 40, page_size=8, cache_pages=4) == got


def test_background_server_serves_rwkv6():
    """``build_engine`` builds any registered architecture: a smoke rwkv6
    ``BackgroundServer`` on the CPU streams the tokens a solo Engine gives."""
    from repro_torch.serve.api import BackgroundServer, Gateway, build_engine
    from repro_torch.serve.api import client as api_client

    eng, cfg = build_engine("rwkv6-7b", smoke=True, max_slots=2, page_len=64,
                            chunk=4, device="cpu")
    assert cfg.name == "rwkv6-7b-smoke"
    prompt = [3, 1, 4, 1, 5, 9, 2]
    ref = Engine(eng.model, max_slots=1, page_len=64, chunk=4).run(
        [Request(uid="r", prompt=prompt, max_new_tokens=6)])["r"]
    srv = BackgroundServer(Gateway(eng, max_queue=4)).start()
    try:
        out = api_client.completion(srv.host, srv.port, {"prompt": prompt, "max_tokens": 6})
        assert out["choices"][0]["tokens"] == ref
        events = list(api_client.stream_completion(srv.host, srv.port,
                                                   {"prompt": prompt, "max_tokens": 6}))
        assert [e["choices"][0]["token"] for e in events] == ref
    finally:
        srv.stop()
