"""Blockwise flash attention, fresh-cache prefill and the last substrate
functions of the PyTorch port against the JAX package, on the CPU.

  * ``flash_attention`` against JAX's at ``tests/test_attention.py``'s five
    shapes, windows and tiles (f32, rtol/atol 2e-5, JAX's own bound against
    its dense reference), one shape whose length pads both tiles, and bf16
    q/k/v; its gradients against ``jax.grad`` through JAX's ``custom_vjp``
    (f32 rtol/atol 2e-4, JAX's own bound); the backward saves no tensor of
    a score matrix's size;
  * a prompt longer than a global layer's cache keeps its last tokens, as
    JAX's ``_prefill_attention`` does; smoke models' single-shot prefill on
    fresh caches (``fresh_caches=True``, several key blocks), a multi-block
    train step and ``generate`` against JAX's;
  * ``goom_neg``, ``goom_scale``, ``goom_sub``, ``goom_dot``,
    ``goom_matmul``, ``goom_from_complex``, ``goom_to_complex``,
    ``lmme_ref_exact``, ``set_default_backend`` and ``register_backend``
    against JAX's.

bf16 tolerance: both packages compute the same f32 arithmetic and round the
result to bf16 once, so an output or gradient whose f32 values differ in
the last place may round one bf16 ulp apart: held within 2^-7 of the
tensor's largest magnitude (one bf16 ulp at that scale).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import transform_blocks as jax_transform_blocks
from repro.core import engine as jax_engine
from repro.core import goom as jgoom
from repro.core import ops as jops
from repro.kernels import dispatch as jdispatch
from repro.kernels.lmme.ref import lmme_ref_exact as j_lmme_ref_exact
from repro.models import attention as jattn
from repro.models.model import DecoderLM as JaxLM
from repro.serve import generate as jax_generate
from repro_torch import DecoderLM, get_config, params_from_jax
from repro_torch.convert import params_to_jax
from repro_torch.configs import AttentionCfg, transform_blocks
from repro_torch.core import Goom, engine, goom, ops
from repro_torch.kernels import dispatch
from repro_torch.kernels.lmme import lmme_ref_exact
from repro_torch.models import Attention
from repro_torch.models.attention import flash_attention
from repro_torch.serve import generate
from torch_parity import check_tokens, jax_layer_caches, n, state_dict_of, t

torch.set_num_threads(2)

BF16_ULP = 2.0 ** -7


def _x(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


def _qkv(s, h, kvh, d, seed=0):
    return _x((2, s, h, d), seed), _x((2, s, kvh, d), seed + 1), _x((2, s, kvh, d), seed + 2)


def _jax_flash(window, scale, bq, bk):
    def f(q, k, v):
        pos = jnp.arange(q.shape[1])
        return jattn.flash_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                     window=window, scale=scale, block_q=bq, block_kv=bk)
    return f


def _flash(q, k, v, window, scale, bq, bk):
    pos = torch.arange(q.shape[1])
    return flash_attention(q, k, v, q_positions=pos, kv_positions=pos, window=window,
                           scale=scale, block_q=bq, block_kv=bk)


# JAX's tests/test_attention.py shapes, and one that pads both tiles
SHAPES = [(64, 4, 2, 16, None, 16, 16), (64, 4, 1, 16, 24, 16, 16),
          (128, 2, 2, 8, None, 32, 64), (96, 4, 4, 8, 17, 32, 16),
          (64, 8, 2, 4, 1, 16, 16), (50, 4, 2, 8, 20, 16, 16)]


@pytest.mark.parametrize("s,h,kvh,d,window,bq,bk", SHAPES)
def test_flash_matches_jax(s, h, kvh, d, window, bq, bk):
    q, k, v = _qkv(s, h, kvh, d)
    want = jax.jit(_jax_flash(window, d ** -0.5, bq, bk))(q, k, v)
    got = _flash(t(q), t(k), t(v), window, d ** -0.5, bq, bk)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def _grads(q, k, v, dtype, window, scale, bq, bk):
    """(out, dq, dk, dv) of sum(sin(flash)) in both packages, q/k/v in
    ``dtype`` (the loss in f32)."""
    jf = _jax_flash(window, scale, bq, bk)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x, jd) for x in (q, k, v))
    want = jax.jit(jf)(jq, jk, jv)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(jf(*a).astype(jnp.float32))),
                          argnums=(0, 1, 2)))(jq, jk, jv)
    tq, tk, tv = (t(x, dtype).requires_grad_() for x in (q, k, v))
    out = _flash(tq, tk, tv, window, scale, bq, bk)
    torch.sin(out.float()).sum().backward()
    return ((n(out), np.asarray(want, np.float32)),
            *((n(a.grad), np.asarray(b, np.float32)) for a, b in zip((tq, tk, tv), jg)))


@pytest.mark.parametrize("case", [(64, 4, 2, 16, 20, 16, 16), (50, 4, 1, 8, None, 16, 16)],
                         ids=["window", "padded"])
def test_flash_gradients_match_jax_custom_vjp(case):
    """f32 gradients through the backward from the LSE, at rtol/atol 2e-4:
    JAX's window-20 case of ``test_flash_gradients_match_reference``, and
    a global one whose length pads the last key block."""
    s, h, kvh, d, window, bq, bk = case
    for got, want in _grads(*_qkv(s, h, kvh, d, 3), torch.float32, window, d ** -0.5,
                            bq, bk):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_bf16_matches_jax():
    """bf16 q/k/v (p rounded to bf16 before the product with v, f32
    accumulation; the backward in f32): output and gradients within one
    bf16 ulp of each tensor's scale (module docstring)."""
    for got, want in _grads(*_qkv(64, 4, 2, 16, 5), torch.bfloat16, 24, 0.25, 16, 16):
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ULP * np.abs(want).max())


def test_flash_saves_no_score_matrix():
    """The autograd graph of flash keeps q, k, v, the positions, the output
    and the LSE: no saved tensor as large as a (B, Sq, H, block_kv) block of
    scores, let alone the (B, Sq, H, Skv) matrix a dense softmax saves."""
    b, s, h, kvh, d, bk = 2, 64, 4, 2, 8, 16
    q, k, v = (t(x).requires_grad_() for x in _qkv(s, h, kvh, d))
    sizes = []

    def pack(x):
        sizes.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = _flash(q, k, v, None, d ** -0.5, 16, bk)
    assert sizes and max(sizes) < b * s * h * bk
    dense = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: dense.append(x.numel()) or x,
                                                  lambda x: x):
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(h // kvh, 2))
        torch.softmax(sc, -1)
    assert max(dense) >= b * s * h * s     # the hooks see a score matrix where there is one
    out.sum().backward()
    assert all(x.grad is not None for x in (q, k, v))


# ---------------------------------------------------------------------------
# prefill branches
# ---------------------------------------------------------------------------
ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)


@pytest.mark.parametrize("fresh", [False, True], ids=["indexed", "fresh"])
def test_prompt_longer_than_global_cache_matches_jax(fresh):
    """A 12-token prompt into an 8-row global cache: JAX's output (2, 12,
    32), its last 8 tokens' K/V bits in the cache and index 12."""
    jcfg = jattn.AttentionCfg(**ATTN)
    layer = Attention(AttentionCfg(**ATTN), device="cpu")
    rng = np.random.default_rng(9)
    p = {}
    for name, w in layer.state_dict().items():      # "q.w" -> {"q": {"w": ...}}
        mod, leaf = name.split(".")
        p.setdefault(mod, {})[leaf] = (0.3 * rng.normal(size=w.shape)).astype(np.float32)
    layer.load_state_dict(state_dict_of(p))
    x = _x((2, 12, 32), 11)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    jcache = dict(jattn.init_cache(2, jcfg, 8), index=jnp.zeros((2,), jnp.int32))
    want, jc = jax.jit(lambda p, x, pos, c: jattn.attention_apply(
        p, x, jcfg, positions=pos, cache=c, compute_dtype=jnp.float32,
        fresh_cache=fresh))(p, x, pos, jcache)
    cache = {"k": torch.zeros(2, 8, 2, 8, dtype=torch.bfloat16),
             "v": torch.zeros(2, 8, 2, 8, dtype=torch.bfloat16),
             "index": torch.zeros(2, dtype=torch.long)}
    with torch.no_grad():
        got, c = layer(t(x), positions=t(pos, torch.long), cache=cache,
                       compute_dtype=torch.float32, fresh_cache=fresh)
    assert tuple(got.shape) == (2, 12, 32)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_array_equal(n(c[key]), np.asarray(jc[key], np.float32))
    assert c["index"].tolist() == [12, 12] == np.asarray(jc["index"]).tolist()


TILES = dict(block_q=8, block_kv=16)


def _tiled(cfg, transform):
    return transform(cfg, lambda blk: blk if blk.attn is None else dataclasses.replace(
        blk, attn=dataclasses.replace(blk.attn, **TILES)))


@functools.lru_cache(maxsize=None)
def _tiled_pair(arch):
    """(JAX model, JAX params, port model) of the smoke config at f32 with
    flash tiles of 8 queries and 16 keys: several key blocks at S >= 32."""
    jcfg = dataclasses.replace(_tiled(jax_get_config(arch, smoke=True), jax_transform_blocks),
                               compute_dtype=jnp.float32)
    cfg = dataclasses.replace(_tiled(get_config(arch, smoke=True), transform_blocks),
                              compute_dtype=torch.float32)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    jparams = params_to_jax(cfg, model.state_dict())   # the port's seeded weights
    return JaxLM(jcfg), jax.tree.map(jnp.asarray, jparams), model


@pytest.fixture(params=["olmo-1b", "gemma3-1b"])
def tiled_pair(request):
    return _tiled_pair(request.param)


def test_fresh_prefill_matches_jax(tiled_pair):
    """Two 40-token prompts into fresh caches of 48 positions (gemma3's
    local layers: rings of 16 rows, rolled) through ``prefill(...,
    fresh_caches=True)``: last logits within 1e-4·std of JAX's and of the
    port's no-cache forward (both attend over the unrounded K/V; an indexed
    prefill reads them back from the bf16 cache), bf16 KV within one bf16
    ulp of each leaf's scale, indexes equal."""
    jmodel, jparams, model = tiled_pair
    seq = np.random.default_rng(7).integers(0, model.cfg.vocab, (2, 40))

    def jprefill(p, tok, c):
        with jax_engine.use_backend("reference"):
            return jmodel.prefill(p, tok, c, fresh_caches=True)

    want, jcaches = jax.jit(jprefill)(jparams, jnp.asarray(seq, jnp.int32),
                                      jmodel.init_caches(2, 48))
    with torch.no_grad():
        got, caches = model.prefill(t(seq, torch.long), model.init_caches(2, 48),
                                    fresh_caches=True)
        uncached = model(t(seq, torch.long))[:, -1:]
    want = np.asarray(want, np.float32)
    tol = 1e-4 * float(want.std())
    np.testing.assert_allclose(n(got), want, rtol=0, atol=tol)
    np.testing.assert_allclose(n(uncached), n(got), rtol=0, atol=tol)
    jflat = jax_layer_caches(jmodel.cfg, jcaches)
    assert len(jflat) == len(caches)
    for layer, jlayer in zip(caches, jflat):
        assert set(layer) == set(jlayer)
        for key, leaf in layer.items():
            ref = np.asarray(jlayer[key], np.float32)
            if key == "index":
                np.testing.assert_array_equal(n(leaf), np.broadcast_to(ref, n(leaf).shape))
            else:
                np.testing.assert_allclose(n(leaf), ref, rtol=0,
                                           atol=BF16_ULP * float(np.abs(ref).max()))


def test_generate_matches_jax():
    """``generate`` (fresh single-shot prefill, then decode) on two
    24-token prompts for 6 tokens: JAX's tokens, or the same up to a near
    tie (``torch_parity.check_tokens``); olmo-1b (gemma3-1b's prefill is
    held above, and its decode in ``test_torch_families_serve.py``)."""
    jmodel, jparams, model = _tiled_pair("olmo-1b")
    prompt = np.random.default_rng(8).integers(0, model.cfg.vocab, (2, 24))
    want = np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompt, jnp.int32), 6, 40,
                                   backend="reference"))
    got = n(generate(model, t(prompt, torch.long), 6, 40)).astype(np.int64)
    for row in range(2):
        check_tokens(jmodel, jparams, prompt[row], got[row].tolist(), want[row].tolist())


def test_multi_block_train_step_matches_jax():
    """olmo-1b's smoke loss and gradients at S = 32 (four key blocks of 8,
    ``remat="full"``), f32: loss rtol 1e-5 and each leaf's max |port - JAX|
    within 5e-4 of its max |JAX| (``test_torch_train.py``'s bounds)."""
    from repro.core import engine as je

    tiles = dict(block_q=8, block_kv=8)

    def tiled(cfg, transform):
        return transform(cfg, lambda blk: dataclasses.replace(
            blk, attn=dataclasses.replace(blk.attn, **tiles)))

    jcfg = dataclasses.replace(tiled(jax_get_config("olmo-1b", smoke=True),
                                     jax_transform_blocks), compute_dtype=jnp.float32,
                               logit_chunk=16)
    cfg = dataclasses.replace(tiled(get_config("olmo-1b", smoke=True), transform_blocks),
                              compute_dtype=torch.float32, logit_chunk=16)
    jmodel = JaxLM(jcfg)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    jparams = jax.tree.map(jnp.asarray, params_to_jax(cfg, model.state_dict()))
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    labels = np.where(rng.random((4, 32)) < 0.2, -1, rng.integers(0, cfg.vocab, (4, 32)))

    def jloss(p, tok, lab):
        with je.use_backend("reference"):
            return jmodel.loss(p, tok, lab)

    (want, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jnp.asarray(tokens), jnp.asarray(labels, jnp.int32))
    loss, _ = model.loss(t(tokens, torch.long), t(labels, torch.long))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        gap = float((g - want[name]).abs().max() / want[name].abs().max().clamp_min(1e-30))
        assert gap <= 5e-4, (name, gap)


# ---------------------------------------------------------------------------
# the substrate's last public functions
# ---------------------------------------------------------------------------
def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    log = (3 * rng.normal(size=shape)).astype(np.float32)
    log[rng.random(shape) < 0.1] = -np.inf                # exact zeros
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)
    return log, sign


def _same_goom(got: Goom, want, atol=1e-5):
    np.testing.assert_allclose(n(got.log_abs), np.asarray(want.log_abs), rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(n(got.sign), np.asarray(want.sign))


def test_goom_ops_match_jax():
    a, b, m = _planes((5, 7), 1), _planes((5, 7), 2), _planes((7, 4), 3)

    def jax_ops(a, b, m):
        ja, jb, jm = (jgoom.Goom(*x) for x in (a, b, m))
        return (jops.goom_neg(ja), jops.goom_scale(ja, 2.5), jops.goom_sub(ja, jb),
                jops.goom_dot(ja, jb), jops.goom_matmul(ja, jm),
                jgoom.Goom(*j_lmme_ref_exact(*a, *m)))

    want = jax.jit(jax_ops)(a, b, m)
    ga, gb, gm = (Goom(t(x[0]), t(x[1])) for x in (a, b, m))
    got = (ops.goom_neg(ga), ops.goom_scale(ga, 2.5), ops.goom_sub(ga, gb),
           ops.goom_dot(ga, gb), ops.goom_matmul(ga, gm),
           Goom(*lmme_ref_exact(ga.log_abs, ga.sign, gm.log_abs, gm.sign)))
    for g, w in zip(got, want):
        _same_goom(g, w)


def test_complex_goom_round_trip_matches_jax():
    """f32 planes to complex64 and back, as JAX's; f64 planes to complex128
    with pi in f64 (JAX without x64 has no f64 to compare with)."""
    a = _planes((6, 3), 4)
    a = (np.where(np.isfinite(a[0]), a[0], -1e30).astype(np.float32), a[1])
    jz = jgoom.goom_to_complex(jgoom.Goom(*map(jnp.asarray, a)))
    jback = jgoom.goom_from_complex(jz)
    z = goom.goom_to_complex(Goom(t(a[0]), t(a[1])))
    assert z.dtype == torch.complex64
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    back = goom.goom_from_complex(z)
    np.testing.assert_array_equal(n(back.log_abs), np.asarray(jback.log_abs))
    np.testing.assert_array_equal(n(back.sign), np.asarray(jback.sign))
    via = goom.to_goom(z)          # a complex tensor is read as the complex form
    np.testing.assert_array_equal(n(via.sign), np.asarray(jback.sign))
    z64 = goom.goom_to_complex(Goom(*(torch.from_numpy(x.astype(np.float64)) for x in a)))
    assert z64.dtype == torch.complex128
    np.testing.assert_array_equal(z64.numpy(), a[0] + 1j * np.where(a[1] < 0, np.pi, 0.0))


def test_set_default_backend_and_register_backend_match_jax():
    """``set_default_backend`` moves the default outside any scope;
    ``register_backend`` refuses a backend missing an op with JAX's message
    and otherwise adds a concrete backend that resolves and dispatches."""
    engine.set_default_backend("torch_reference")
    try:
        assert engine.current_backend() == "torch_reference"
        with engine.use_backend("auto"):
            assert engine.current_backend() == "auto"
        assert engine.current_backend() == "torch_reference"
        with pytest.raises(ValueError, match="unknown backend"):
            engine.set_default_backend("nope")
    finally:
        engine.set_default_backend("auto")
    assert engine.current_backend() == "auto"

    msgs = []
    for mod, impls in ((dispatch, {"lmme": lambda blocks: None}),
                       (jdispatch, {"lmme": lambda r, b: None})):
        with pytest.raises(ValueError, match="missing impls") as e:
            mod.register_backend("half_a_backend", impls)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

    from repro_torch.kernels.blocks import DEFAULTS, OPS

    name = "test_only_backend"
    try:
        dispatch.register_backend(name, {op: (lambda blocks, _op=op: lambda *a: _op)
                                         for op in OPS})
        assert dispatch.resolve_backend(name, device_type="cpu") == name
        assert dispatch.get_impl("lmme", name)() == "lmme"
        with engine.use_backend(name):
            assert engine.current_backend() == name
    finally:
        dispatch.CONCRETE_BACKENDS.remove(name)
        for op in OPS:
            dispatch._REGISTRY.pop((op, name), None)
            DEFAULTS.pop((op, name), None)
