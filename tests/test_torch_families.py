"""The attention families of the PyTorch port against the JAX package, on
the CPU: olmo-1b, codeqwen1.5-7b, phi3.5-moe, mixtral-8x7b, glm4-9b and
gemma3-1b, and every registered config field by field.

  * units on the same numpy inputs: partial rotary (fractions 1, 0.5, 0.3,
    0), ``rms_plus_one``, ``ln_nonparam`` (no parameters), each activation
    gated and not, the MoE's activation, and attention with qkv biases,
    q/k norms, a query scale and a sliding window, without a cache and over
    a rolling buffer that wraps;
  * the smoke models' logits at 1 and 2 periods after ``params_from_jax``,
    and ``params_to_jax`` giving the JAX tree back (gemma3's two groups,
    stacked or not; tied models without ``lm_head``; empty non-parametric
    norms);
  * chunked prefill at chunks 1, 7 and 64 against JAX's dense caches, leaf
    by leaf, for olmo, gemma3 (rings of 16 that a 70-token prompt wraps four
    times) and mixtral (rings of 32);
  * what is not ported raises (the Engine with a frontend model).

The Engine's runs of these models are in ``test_torch_families_serve.py``.

All at f32 compute, weights perturbed by N(0, 0.05²) so that biases and
zero-initialised norm scales take part.  Tolerance: 1e-5 absolute for
modules, 1e-4·std for logits (through bf16 KV caches as in
``torch_parity.check_prefill_caches``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models.common import KeyGen, unzip
from repro.models.norms import layernorm_apply as j_layernorm
from repro.models.norms import rmsnorm_apply as j_rmsnorm
from repro.models.rope import apply_rope as j_apply_rope
from repro_torch import DecoderLM, get_config
from repro_torch.configs import AttentionCfg, MlpCfg, MoeCfg, list_archs
from repro_torch.convert import params_to_jax
from repro_torch.models import Attention, LayerNorm, Mlp, Moe, RMSNorm
from repro_torch.models.rope import apply_rope
from torch_parity import check_prefill_caches, n, serve_pair, state_dict_of, t

torch.set_num_threads(2)
F32 = dict(compute_dtype=jnp.float32)
FAMILIES = ["olmo-1b", "codeqwen1.5-7b", "phi3.5-moe", "mixtral-8x7b", "glm4-9b",
            "gemma3-1b"]
# JAX fields the port leaves out: none (the flash-attention tiles are ported)
JAX_ONLY = set()


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), rtol=0, atol=atol)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(init_fn, cfg, seed, perturb=0.05):
    p, _ = unzip(init_fn(KeyGen(jax.random.PRNGKey(seed)), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: (np.asarray(v) + perturb * rng.normal(size=v.shape))
                        .astype(np.float32), p)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def _same(port, ref, where):
    """``port`` equals ``ref`` field by field (dataclasses recursively,
    dtypes by name); JAX fields the port leaves out are in ``JAX_ONLY``."""
    if dataclasses.is_dataclass(ref):
        assert dataclasses.is_dataclass(port), where
        mine = {f.name for f in dataclasses.fields(port)}
        theirs = {f.name for f in dataclasses.fields(ref)}
        assert mine <= theirs, (where, mine - theirs)
        assert theirs - mine <= JAX_ONLY, (where, theirs - mine)
        for name in mine:
            _same(getattr(port, name), getattr(ref, name), f"{where}.{name}")
    elif isinstance(ref, (tuple, list)):
        assert len(port) == len(ref), where
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{where}[{i}]")
    elif isinstance(port, torch.dtype):
        assert str(port).removeprefix("torch.") == jnp.dtype(ref).name, where
    else:
        assert port == ref, (where, port, ref)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_every_config_equals_jax_field_by_field(smoke):
    from repro.configs import list_archs as jax_archs

    ported = list_archs()
    assert set(FAMILIES + ["rwkv6-7b", "goom-rnn-124m", "jamba-v0.1", "musicgen-large",
                           "qwen2-vl-7b"]) == set(ported)
    assert set(ported) == set(jax_archs())
    for arch in ported:
        _same(get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke), arch)
    gemma = get_config("gemma3-1b")
    assert [(len(g.period), g.n_periods) for g in gemma.groups] == [(6, 4), (2, 1)]
    assert gemma.n_layers == len(gemma.layer_list) == 26


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.3, 0.0])
def test_partial_rotary_matches_jax(fraction):
    x = _x((2, 5, 3, 10), 1)
    pos = np.random.default_rng(2).integers(0, 500, size=(2, 5)).astype(np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0,
                        rotary_fraction=fraction)
    got = apply_rope(t(x), t(pos, torch.long), theta=10000.0, rotary_fraction=fraction)
    _close(got, want, atol=2e-5)
    rot = int(10 * fraction) // 2 * 2
    np.testing.assert_array_equal(n(got)[..., rot:], x[..., rot:])


def test_rms_plus_one_and_ln_nonparam_match_jax():
    x = _x((2, 5, 8), 3)
    w = 0.1 * _x((8,), 4)
    norm = RMSNorm(8, device="cpu", plus_one=True)
    assert not norm.scale.detach().any()    # (1 + w) with w zeros: the identity scale
    norm.scale.data.copy_(t(w))
    with torch.no_grad():
        _close(norm(t(x)), j_rmsnorm({"scale": jnp.asarray(w)}, jnp.asarray(x),
                                     plus_one=True))
    ln = LayerNorm(8, device="cpu", elementwise=False)
    assert dict(ln.state_dict()) == {}
    _close(ln(t(x)), j_layernorm({}, jnp.asarray(x)))


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
def test_mlp_activations_match_jax(act, gated):
    jcfg = jmlp.MlpCfg(d_model=16, d_ff=24, activation=act, gated=gated)
    p = _init(jmlp.mlp_init, jcfg, 5)
    layer = Mlp(MlpCfg(d_model=16, d_ff=24, activation=act, gated=gated), device="cpu")
    assert set(layer.state_dict()) == set(state_dict_of(p))
    layer.load_state_dict(state_dict_of(p))
    x = _x((2, 5, 16), 6)
    want = jax.jit(lambda p, x: jmlp.mlp_apply(p, x, jcfg, **F32))(p, x)
    with torch.no_grad():
        _close(layer(t(x), compute_dtype=torch.float32), want)


def test_moe_activation_matches_jax():
    kw = dict(d_model=16, d_ff=24, n_experts=4, top_k=2, activation="gelu")
    jcfg = jmlp.MoeCfg(**kw)
    p = _init(jmlp.moe_init, jcfg, 7)
    layer = Moe(MoeCfg(**kw), device="cpu")
    layer.load_state_dict(state_dict_of(p))
    x = _x((2, 9, 16), 8)
    want, _ = jax.jit(lambda p, x: jmlp.moe_apply(p, x, jcfg, dropless=True, **F32))(p, x)
    with torch.no_grad():
        _close(layer(t(x), compute_dtype=torch.float32, dropless=True)[0], want)


ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)
VARIANTS = {
    "window": dict(window=5),
    "bias_partial": dict(qkv_bias=True, rotary_fraction=0.5),
    "qknorm_scale_window": dict(qk_norm=True, query_scale=0.3, window=6),
}


def _attn_pair(extra):
    jcfg = jattn.AttentionCfg(**ATTN, **extra)
    p = _init(jattn.attention_init, jcfg, 9)
    layer = Attention(AttentionCfg(**ATTN, **extra), device="cpu")
    assert set(layer.state_dict()) == set(state_dict_of(p))
    layer.load_state_dict(state_dict_of(p))
    return jcfg, p, layer


def _jax_attn(jcfg, p, x, positions, cache):
    return jax.jit(lambda p, x, pos, c: jattn.attention_apply(
        p, x, jcfg, positions=pos, cache=c, **F32))(p, x, positions, cache)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_features_without_cache_match_jax(variant):
    """The causal mask, windowed where the layer is, over 12 positions."""
    jcfg, p, layer = _attn_pair(VARIANTS[variant])
    x = _x((2, 12, 32), 10)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want, _ = _jax_attn(jcfg, p, x, pos, None)
    with torch.no_grad():
        got, c = layer(t(x), positions=t(pos, torch.long), compute_dtype=torch.float32)
    assert c is None
    _close(got, want)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_attention_chunks_and_decode_match_jax_dense_cache(variant):
    """Over a cache of 16 positions: a window of 5 or 6 keeps a rolling
    buffer of that many rows, fed chunks of 3, 4, 1, the buffer's length (a
    roll) and 9 (longer than the buffer), then single tokens, wrapping it
    many times; the global layer chunks of 3, 4, 1, 6, then tokens, on past
    the cache's 16 positions (a write past the end is dropped, as JAX's).
    Outputs, the bf16 buffer bits and the index equal JAX's."""
    jcfg, p, layer = _attn_pair(VARIANTS[variant])
    x = _x((2, 30, 32), 11)
    jcache = dict(jattn.init_cache(2, jcfg, 16), index=jnp.zeros((2,), jnp.int32))
    cache = {"k": t(np.asarray(jcache["k"], np.float32), torch.bfloat16),
             "v": t(np.asarray(jcache["v"], np.float32), torch.bfloat16),
             "index": torch.zeros(2, dtype=torch.long)}
    length = cache["k"].shape[1]
    assert length == min(16, jcfg.window or 16)
    if jcfg.window is None:     # a global cache of 16 positions, then decode past it
        bounds = [0, 3, 7, 8, 14, 15, 16, 17, 18]
    else:
        bounds = [0, 3, 7, 8, 8 + length, 17 + length, 18 + length, 19 + length]
    for lo, hi in zip(bounds, bounds[1:]):
        pos = np.broadcast_to(np.arange(lo, hi), (2, hi - lo)).astype(np.int32)
        want, jcache = _jax_attn(jcfg, p, x[:, lo:hi], pos, jcache)
        with torch.no_grad():
            got, cache = layer(t(x[:, lo:hi]), positions=t(pos, torch.long), cache=cache,
                               compute_dtype=torch.float32)
        _close(got, want)
        for k in ("k", "v"):
            np.testing.assert_array_equal(n(cache[k]), np.asarray(jcache[k], np.float32))
        assert cache["index"].tolist() == [hi, hi]


def test_unported_features_raise():
    """M-RoPE, banded attention, frontends and sinusoidal positions build;
    what the port leaves unported is what JAX's Engine refuses too: a
    model with a frontend (``test_torch_frontends.py`` holds the message to
    JAX's)."""
    from repro_torch import Engine

    Attention(AttentionCfg(**ATTN, mrope_sections=(1, 1, 2)), device="cpu")
    Attention(AttentionCfg(**ATTN, window=4, use_banded=True), device="cpu")
    cfg = get_config("olmo-1b", smoke=True)
    for change in (dict(frontend="audio", n_prefix=4), dict(pos_embedding="sinusoidal"),
                   dict(mrope=True)):
        model = DecoderLM(dataclasses.replace(cfg, **change), device="cpu")
        if "frontend" in change:
            with pytest.raises(NotImplementedError, match="token prompts only"):
                Engine(model, max_slots=2, page_len=32, chunk=8)
        else:
            Engine(model, max_slots=2, page_len=32, chunk=8)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("periods", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_logits_match_jax_and_params_round_trip(arch, periods):
    jmodel, jparams, model = serve_pair(arch, periods=periods, perturb=0.05)
    cfg = model.cfg
    assert ("lm_head.w" in model.state_dict()) == (not cfg.tie_embeddings)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 37))
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply(p, x)[0])(jparams, toks))
    with torch.no_grad():
        got = model(t(toks, torch.long)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(want.std()))
    back = params_to_jax(cfg, model.state_dict())
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module", params=["olmo-1b", "gemma3-1b", "mixtral-8x7b"])
def smoke(request):
    return serve_pair(request.param, perturb=0.05)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_prefill_matches_jax_dense_caches(smoke, chunk):
    """70 tokens over caches of 80 positions: gemma3's local layers keep
    rings of 16 and mixtral's of 32, wrapped; chunk 64 fills a ring in one
    call and rolls it."""
    jmodel, jparams, model = smoke
    seq = np.random.default_rng(2).integers(0, model.cfg.vocab, size=70).tolist()
    rings = {c["k"].shape[1] for c, blk in zip(model.init_caches(1, 80), model.cfg.layer_list)
             if blk.attn.window is not None}
    assert rings == {"olmo-1b-smoke": set(), "gemma3-1b-smoke": {16},
                     "mixtral-8x7b-smoke": {32}}[model.cfg.name]
    check_prefill_caches(jmodel, jparams, model, seq, chunk, 80)
