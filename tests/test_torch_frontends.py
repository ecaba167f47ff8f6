"""musicgen-large and qwen2-vl-7b in the PyTorch port against the JAX
package, on the CPU: stub frontends (``prefix_embeds``), sinusoidal
positions, M-RoPE and banded sliding-window attention.

  * units on the same numpy inputs: ``apply_mrope`` at Qwen2-VL's sections
    (16, 24, 24) over head dim 128 and at the smoke config's, on text and
    image-grid positions; ``sinusoidal_embedding`` at even and odd dims;
    ``banded_attention`` against JAX's over the (S, W) grid of
    ``tests/test_attention.py`` and against the port's dense windowed path;
    ``Attention`` with M-RoPE without a cache and through chunks and decode
    steps over a bf16 cache;
  * the smoke models' logits at 1 and 2 periods with ``prefix_embeds`` (and
    ``mrope_positions``), and ``params_to_jax`` giving the JAX tree back;
  * chunked prefill at chunks 1, 7 and 64 against JAX's dense caches, leaf
    by leaf;
  * ``generate`` with the frontend inputs against JAX's ``generate``,
    token for token; ``loss`` and a 3-step train trajectory at 2
    microbatches with the frontend inputs against JAX's train loop;
  * the Engine refusing a frontend model as JAX's does.

All at f32 compute, weights perturbed by N(0, 0.05²) so that biases and
LayerNorm parameters take part.  Tolerances: 1e-5 absolute for modules,
1e-4·std for logits, 1e-2·std through bf16 KV caches (see
``torch_parity.check_prefill_caches``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import transform_blocks as jax_transform_blocks
from repro.models import attention as jattn
from repro.models.common import KeyGen, unzip
from repro.models.rope import apply_mrope as j_apply_mrope
from repro.models.rope import sinusoidal_embedding as j_sinusoidal
from repro.serve import Engine as JaxEngine
from repro.serve import generate as jax_generate
from repro.train import optimizer as jopt
from repro.train.train_loop import init_train_state as jax_init_train_state
from repro.train.train_loop import make_train_step as jax_make_train_step
from repro_torch import DecoderLM, Engine, get_config, params_from_jax
from repro_torch.configs import AttentionCfg, transform_blocks
from repro_torch.convert import params_to_jax
from repro_torch.models import Attention
from repro_torch.models.attention import banded_attention
from repro_torch.models.rope import apply_mrope, apply_rope, sinusoidal_embedding
from repro_torch.serve import generate
from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step
from torch_parity import check_prefill_caches, n, serve_pair, state_dict_of, t

torch.set_num_threads(2)
F32 = dict(compute_dtype=jnp.float32)
ARCHS = ["musicgen-large", "qwen2-vl-7b"]


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), rtol=0, atol=atol)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def grid_positions(b, s, n_prefix, side):
    """(3, B, S) M-RoPE positions: the first ``n_prefix`` positions a grid
    of ``side`` columns (t = 0, h = i // side, w = i % side), the rest their
    absolute index on all three streams (what ``decode_step`` continues)."""
    i = np.arange(s)
    pos = np.stack([np.where(i < n_prefix, 0, i), np.where(i < n_prefix, i // side, i),
                    np.where(i < n_prefix, i % side, i)])
    return np.broadcast_to(pos[:, None], (3, b, s)).astype(np.int32)


def frontend_inputs(cfg, b, s, seed):
    """numpy ``prefix_embeds`` (B, n_prefix, d) at 0.5·N(0, 1), and for
    M-RoPE ``mrope_positions`` over a grid of two rows."""
    kw = {"prefix_embeds": 0.5 * _x((b, cfg.n_prefix, cfg.d_model), seed)}
    if cfg.mrope:
        kw["mrope_positions"] = grid_positions(b, s, cfg.n_prefix, cfg.n_prefix // 2)
    return kw


def _port_kw(kw):
    return {k: t(v, torch.long if k == "mrope_positions" else torch.float32)
            for k, v in kw.items()}


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", [False, True], ids=["text", "grid"])
@pytest.mark.parametrize("sections,head_dim", [((16, 24, 24), 128), ((2, 3, 3), 16)],
                         ids=["qwen2-vl", "smoke"])
def test_mrope_matches_jax(sections, head_dim, grid):
    """Positions below 40: the two libraries' f32 inverse frequencies differ
    by an ulp here and there (XLA's and PyTorch's ``pow``), which moves an
    angle by position·ulp, past 1e-5 of the output at positions of some
    hundreds; the models' logits tests cover longer sequences at 1e-4·std."""
    x = _x((2, 20, 3, head_dim), 1)
    if grid:
        pos3 = grid_positions(2, 20, 12, 4)
    else:
        pos3 = np.broadcast_to(np.random.default_rng(2).integers(0, 40, size=(2, 20)),
                               (3, 2, 20)).astype(np.int32)
    want = jax.jit(lambda x, p: j_apply_mrope(x, p, theta=1e6, sections=sections))(x, pos3)
    got = apply_mrope(t(x), t(pos3, torch.long), theta=1e6, sections=sections)
    _close(got, want)
    if not grid:   # equal streams are 1-D RoPE
        _close(got, n(apply_rope(t(x), t(pos3[0], torch.long), theta=1e6)), atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(t(x), t(pos3, torch.long), sections=(1, 1, 1))


@pytest.mark.parametrize("dim", [64, 63, 2048])
def test_sinusoidal_embedding_matches_jax(dim):
    """Positions below 40, for the reason of ``test_mrope_matches_jax``: the
    libraries' f32 ``exp`` of the frequency table differs by an ulp here and
    there."""
    pos = np.random.default_rng(3).integers(0, 40, size=(2, 17)).astype(np.int32)
    want = jax.jit(lambda p: j_sinusoidal(p, dim))(pos)
    got = sinusoidal_embedding(t(pos, torch.long), dim)
    assert got.dtype == torch.float32 and got.shape == (2, 17, dim)
    _close(got, want, atol=1e-5)
    if dim % 2:
        assert not got[..., -1].any()
    np.testing.assert_allclose(n(got)[..., 0][pos == 0], 1.0)   # cos(0) leads


@pytest.mark.parametrize("s,w", [(64, 8), (96, 16), (64, 16), (80, 8), (70, 8)])
def test_banded_attention_matches_jax_and_the_dense_window(s, w):
    """The two-block band equals JAX's and the port's dense windowed softmax
    (the no-cache path with ``use_banded`` off: flash attention, here in one
    key block); S = 70 pads the last block."""
    h, kvh, d = 4, 2, 8
    q, k, v = _x((2, s, h, d), 4), _x((2, s, kvh, d), 5), _x((2, s, kvh, d), 6)
    pos = np.arange(s, dtype=np.int32)
    want = jax.jit(lambda q, k, v, p: jattn.banded_attention(
        q, k, v, positions=p, window=w, scale=d ** -0.5))(q, k, v, pos)
    got = banded_attention(t(q), t(k), t(v), positions=t(pos, torch.long), window=w,
                           scale=d ** -0.5)
    _close(got, want)
    from repro_torch.models.attention import flash_attention

    dense = flash_attention(t(q), t(k), t(v), q_positions=t(pos, torch.long),
                            kv_positions=t(pos, torch.long), window=w, scale=d ** -0.5,
                            block_q=s, block_kv=s)
    _close(got, n(dense))


ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qkv_bias=True,
            rope_theta=1e6, mrope_sections=(1, 1, 2))


def _attn_pair(**extra):
    jcfg = jattn.AttentionCfg(**ATTN, **extra)
    p, _ = unzip(jattn.attention_init(KeyGen(jax.random.PRNGKey(9)), jcfg))
    rng = np.random.default_rng(9)
    p = jax.tree.map(lambda v: (np.asarray(v) + 0.05 * rng.normal(size=v.shape))
                     .astype(np.float32), p)
    layer = Attention(AttentionCfg(**ATTN, **extra), device="cpu")
    layer.load_state_dict(state_dict_of(p))
    return jcfg, p, layer


def _jax_attn(jcfg, p, x, positions, mrope, cache):
    return jax.jit(lambda p, x, pos, m, c: jattn.attention_apply(
        p, x, jcfg, positions=pos, mrope_positions=m, cache=c, **F32))(
            p, x, positions, mrope, cache)


def test_mrope_attention_without_cache_matches_jax():
    jcfg, p, layer = _attn_pair()
    x = _x((2, 14, 32), 10)
    pos = np.broadcast_to(np.arange(14), (2, 14)).astype(np.int32)
    pos3 = grid_positions(2, 14, 6, 3)
    for m in (pos3, None):   # without streams each is ``positions``
        want, _ = _jax_attn(jcfg, p, x, pos, m, None)
        with torch.no_grad():
            got, c = layer(t(x), positions=t(pos, torch.long),
                           mrope_positions=None if m is None else t(m, torch.long),
                           compute_dtype=torch.float32)
        assert c is None
        _close(got, want)


def test_mrope_attention_chunks_and_decode_match_jax_dense_cache():
    """A 6-token image grid and text in chunks of 6 and 4, then single
    tokens whose streams are their index (JAX's default): outputs, the bf16
    cache and the index equal JAX's."""
    jcfg, p, layer = _attn_pair()
    x = _x((2, 14, 32), 11)
    pos3_all = grid_positions(2, 14, 6, 3)
    jcache = dict(jattn.init_cache(2, jcfg, 16), index=jnp.zeros((2,), jnp.int32))
    cache = {"k": torch.zeros(2, 16, 2, 8, dtype=torch.bfloat16),
             "v": torch.zeros(2, 16, 2, 8, dtype=torch.bfloat16),
             "index": torch.zeros(2, dtype=torch.long)}
    for lo, hi in ((0, 6), (6, 10), (10, 11), (11, 12), (12, 13)):
        pos = np.broadcast_to(np.arange(lo, hi), (2, hi - lo)).astype(np.int32)
        m = pos3_all[:, :, lo:hi] if hi - lo > 1 else None
        want, jcache = _jax_attn(jcfg, p, x[:, lo:hi], pos, m, jcache)
        with torch.no_grad():
            got, cache = layer(t(x[:, lo:hi]), positions=t(pos, torch.long),
                               mrope_positions=None if m is None else t(m, torch.long),
                               cache=cache, compute_dtype=torch.float32)
        _close(got, want)
        for k in ("k", "v"):
            np.testing.assert_array_equal(n(cache[k]), np.asarray(jcache[k], np.float32))
        assert cache["index"].tolist() == [hi, hi]


def test_banded_layer_takes_the_band_only_where_jax_does():
    """``use_banded`` on a windowed layer without a cache: the band at
    S >= 2·window, the dense path below; both equal JAX's layer."""
    jcfg, p, layer = _attn_pair(window=4, use_banded=True)
    for s in (7, 8, 19):
        x = _x((2, s, 32), 12 + s)
        pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
        want, _ = _jax_attn(jcfg, p, x, pos, None, None)
        with torch.no_grad():
            got, _ = layer(t(x), positions=t(pos, torch.long), compute_dtype=torch.float32)
        _close(got, want)


def _banded(blk):
    return (dataclasses.replace(blk, attn=dataclasses.replace(blk.attn, use_banded=True))
            if blk.attn is not None else blk)


def test_transform_blocks_flips_banded_as_jax():
    cfg = transform_blocks(get_config("gemma3-1b", smoke=True), _banded)
    jcfg = jax_transform_blocks(jax_get_config("gemma3-1b", smoke=True), _banded)
    assert [b.attn.use_banded for b in cfg.layer_list] == [True] * cfg.n_layers
    assert ([(b.attn.use_banded, b.attn.window) for b in cfg.layer_list]
            == [(b.attn.use_banded, b.attn.window) for b in jcfg.layer_list])


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("periods", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_with_frontend_inputs_match_jax_and_params_round_trip(arch, periods):
    jmodel, jparams, model = serve_pair(arch, periods=periods, perturb=0.05)
    cfg = model.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 21))
    kw = frontend_inputs(cfg, 2, 21, 2)
    want = np.asarray(jax.jit(lambda p, x, kw: jmodel.apply(p, x, **kw)[0])(jparams, toks, kw))
    with torch.no_grad():
        got = model(t(toks, torch.long), **_port_kw(kw)).numpy()
        plain = model(t(toks, torch.long)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(want.std()))
    assert np.abs(got - plain).max() > 1e-2 * float(want.std())   # the prefix counts
    back = params_to_jax(cfg, model.state_dict())
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="prefix longer"):
        model(t(toks[:, :cfg.n_prefix - 1], torch.long), prefix_embeds=t(kw["prefix_embeds"]))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    return serve_pair(request.param, perturb=0.05)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_prefill_matches_jax_dense_caches(smoke, chunk):
    """70 tokens over caches of 80 positions: sinusoidal positions and M-RoPE
    (each stream the absolute index) through chunks and decode steps."""
    jmodel, jparams, model = smoke
    seq = np.random.default_rng(2).integers(0, model.cfg.vocab, size=70).tolist()
    check_prefill_caches(jmodel, jparams, model, seq, chunk, 80)


def test_generate_with_frontend_inputs_matches_jax(smoke):
    """``generate(..., prefix_embeds=, mrope_positions=)``: the prefix goes
    to the prefill, decode positions continue at the prompt's length; equal
    tokens, or a divergence only at a near tie of JAX's logits."""
    jmodel, jparams, model = smoke
    b, p, n_tok = 2, 12, 7
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab, size=(b, p))
    kw = frontend_inputs(model.cfg, b, p, 6)
    want = np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompt, jnp.int32), n_tok,
                                   32, backend="reference",
                                   **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = generate(model, t(prompt, torch.long), n_tok, 32, **_port_kw(kw)).numpy()
    assert got.shape == (b, n_tok)
    pos3 = kw.get("mrope_positions")
    for i in range(b):
        for j in range(n_tok):
            if got[i, j] == want[i, j]:
                continue
            seq = np.concatenate([prompt[i], want[i, :j]])[None]
            fkw = {"prefix_embeds": kw["prefix_embeds"][i:i + 1]}
            if pos3 is not None:
                tail = np.broadcast_to(np.arange(p, p + j), (3, 1, j))
                fkw["mrope_positions"] = np.concatenate([pos3[:, i:i + 1], tail], 2)
            lg = np.asarray(jmodel.apply(jparams, seq, **fkw)[0])[0, -1]
            top2 = np.sort(lg)[-2:]
            assert top2[1] - top2[0] < 1e-4 * lg.std(), (i, j, got[i], want[i])
            break


SEQ, BATCH = 16, 4


def _train_batch(cfg, step):
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((BATCH, 1), -1, np.int32)], 1)
    return dict(tokens=toks, labels=labels, **frontend_inputs(cfg, BATCH, SEQ, 200 + step))


def test_loss_and_train_trajectory_with_frontend_inputs_match_jax(smoke):
    """The loss with the frontend inputs, then 3 steps of AdamW at 2
    microbatches (``mrope_positions`` split along its batch dim 1): losses,
    grad norms and rates within rtol 1e-3 a step of JAX's train loop."""
    jmodel, jparams, model = smoke
    cfg = model.cfg
    b0 = _train_batch(cfg, 0)
    jloss, _ = jax.jit(jmodel.loss)(jparams, b0["tokens"], b0["labels"], **{
        k: v for k, v in b0.items() if k not in ("tokens", "labels")})
    port_b0 = dict(_port_kw({k: v for k, v in b0.items() if k not in ("tokens", "labels")}),
                   tokens=t(b0["tokens"], torch.long), labels=t(b0["labels"], torch.long))
    loss, _ = model.loss(**port_b0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)

    model = DecoderLM(cfg, device="cpu")       # a copy to train, same weights
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    sched = dict(peak_lr=3e-3, warmup_steps=1, total_steps=3)
    jo = jopt.AdamW(jopt.cosine_schedule(**sched))
    jstep = jax.jit(jax_make_train_step(jmodel, jo, microbatches=2))
    jstate = jax_init_train_state(jmodel, jo, jax.random.PRNGKey(0))._replace(params=jparams)
    opt = AdamW(cosine_schedule(**sched))
    state, step = init_train_state(model, opt), make_train_step(model, opt, microbatches=2)
    got, want = [], []
    for i in range(3):
        b = _train_batch(cfg, i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, dict(_port_kw({k: v for k, v in b.items()
                                              if k not in ("tokens", "labels")}),
                                    tokens=t(b["tokens"], torch.long),
                                    labels=t(b["labels"], torch.long)))
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-3)


def test_engine_refuses_a_frontend_model_as_jax_does(smoke):
    jmodel, jparams, model = smoke
    with pytest.raises(NotImplementedError, match="token prompts only") as theirs:
        JaxEngine(jmodel, jparams, max_slots=2, page_len=32, chunk=8)
    with pytest.raises(NotImplementedError, match="token prompts only") as ours:
        Engine(model, max_slots=2, page_len=32, chunk=8)
    assert str(ours.value) == str(theirs.value)
