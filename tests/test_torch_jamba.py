"""The Jamba slice of the PyTorch port against the JAX package, on the CPU.

Each module on the same weights (carried over by ``params_from_jax`` or the
module's own state dict) and the same numpy inputs, at f32 compute:

  * ``Mamba``: full sequence, chunked with a carried state, and decode
    continuation; ``segment_states``;
  * ``Attention``: no cache, chunked prefill and decode against JAX's dense
    caches;
  * ``Mlp``, ``Moe`` (dropless and capacity-dropping routings, ties to the
    lower expert), ``RMSNorm`` and ``apply_rope``;
  * the smoke config's logits (one period, and two periods, which JAX
    stacks), prefill through the caches, and ``Engine`` tokens against JAX's
    ``Engine`` (both page their KV);
  * a frozen slot stays bit-identical over a decode step;
  * a config that names no norm gets RMS norms in both packages.

Tolerance: 1e-5 absolute for modules, 1e-4·std for logits, tokens equal up
to a near tie (``test_torch_serve.py``'s rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.models import attention as jattn
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro.models.blocks import BlockCfg as JBlockCfg
from repro.models.blocks import block_init as jblock_init
from repro.models.common import KeyGen, unzip
from repro.models.goom_layer import GoomSSMCfg as JGoomSSMCfg
from repro.models.model import DecoderLM as JaxLM
from repro.models.model import LMConfig as JLMConfig
from repro.models.norms import rmsnorm_apply as j_rmsnorm
from repro.models.rope import apply_rope as j_apply_rope
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import DecoderLM, Engine, Request, get_config, params_from_jax
from repro_torch.configs import (
    AttentionCfg,
    BlockCfg,
    GoomSSMCfg,
    GroupCfg,
    LMConfig,
    MambaCfg,
    MlpCfg,
    MoeCfg,
)
from repro_torch.core import engine
from repro_torch.kernels.goom_scan import diagonal_scan_cuda
from repro_torch.models import Attention, Block, Mamba, Mlp, Moe, RMSNorm, segment_states
from repro_torch.models.rope import apply_rope
from repro_torch.serve import ChunkedPrefill, merge_frozen, read_slot, write_slot
from torch_parity import n, t

torch.set_num_threads(2)
F32 = dict(compute_dtype=jnp.float32)
PROMPT_LENS = [1, 7, 19, 30]
BUDGETS = [5, 4, 6, 3]


def _state(tree):
    """A JAX param subtree as a port module's state dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _state(v).items()})
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _init(init_fn, cfg, seed):
    p, _ = unzip(init_fn(KeyGen(jax.random.PRNGKey(seed)), cfg))
    return jax.tree.map(np.asarray, p)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(n(got), np.asarray(want, np.float32), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
def test_segment_states_matches_jax():
    rng = np.random.default_rng(0)
    la = -np.abs(rng.normal(size=(6, 2, 5, 3))).astype(np.float32)
    b = rng.normal(size=(6, 2, 5, 3)).astype(np.float32)
    h0 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    with jax_engine.use_backend("xla_reference"):
        ws, wh = jax.jit(jssm.segment_states)(la, b, h0)
    gs, gh = segment_states(t(la), t(b), t(h0))
    _close(gs, ws)
    _close(gh, wh)


MAMBA = dict(d_model=16, d_state=4, chunk=4)


def _mamba_pair():
    jcfg, cfg = jssm.MambaCfg(**MAMBA), MambaCfg(**MAMBA)
    p = _init(jssm.mamba_init, jcfg, 1)
    layer = Mamba(cfg, device="cpu")
    layer.load_state_dict(_state(p))
    return jcfg, p, layer


def _jax_mamba(jcfg, p, x, state):
    def f(p, x, state):
        with jax_engine.use_backend("xla_reference"):
            return jssm.mamba_apply(p, x, jcfg, state=state, **F32)

    return jax.jit(f)(p, x, state)


def test_mamba_full_sequence_matches_jax():
    jcfg, p, layer = _mamba_pair()
    x = _x((2, 13, 16), 2)   # 13 is not a multiple of the chunk: identity pad
    want, _ = _jax_mamba(jcfg, p, x, None)
    with torch.no_grad():
        got, st = layer(t(x), compute_dtype=torch.float32)
    assert st is None
    _close(got, want)


def test_mamba_chunked_and_decode_continuation_match_jax():
    jcfg, p, layer = _mamba_pair()
    x = _x((2, 11, 16), 3)
    jstate = jssm.mamba_init_state(2, jcfg)
    state = {k: t(v) for k, v in jstate.items()}
    for lo, hi in ((0, 6), (6, 9), (9, 10), (10, 11)):   # chunks, then decode
        want, jstate = _jax_mamba(jcfg, p, x[:, lo:hi], jstate)
        with torch.no_grad():
            got, state = layer(t(x[:, lo:hi]), state=state, compute_dtype=torch.float32)
        _close(got, want)
        for k in ("conv", "ssm"):
            assert state[k].dtype == torch.float32
            _close(state[k], jstate[k])


ATTN = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)


def _attn_pair():
    jcfg, cfg = jattn.AttentionCfg(**ATTN), AttentionCfg(**ATTN)
    p = _init(jattn.attention_init, jcfg, 4)
    layer = Attention(cfg, device="cpu")
    layer.load_state_dict(_state(p))
    return jcfg, p, layer


def _jax_attn(jcfg, p, x, positions, cache):
    return jax.jit(lambda p, x, pos, c: jattn.attention_apply(
        p, x, jcfg, positions=pos, cache=c, **F32))(p, x, positions, cache)


def test_attention_without_cache_matches_jax():
    jcfg, p, layer = _attn_pair()
    x = _x((2, 10, 32), 5)
    pos = np.broadcast_to(np.arange(10), (2, 10)).astype(np.int32)
    want, _ = _jax_attn(jcfg, p, x, pos, None)
    with torch.no_grad():
        got, c = layer(t(x), positions=t(pos, torch.long), compute_dtype=torch.float32)
    assert c is None
    _close(got, want)


def test_attention_chunked_prefill_and_decode_match_jax_dense_cache():
    jcfg, p, layer = _attn_pair()
    x = _x((2, 12, 32), 6)
    length = 16
    jcache = dict(jattn.init_cache(2, jcfg, length), index=jnp.zeros((2,), jnp.int32))
    cache = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16)
             if k != "index" else torch.zeros(2, dtype=torch.long) for k, v in jcache.items()}
    for lo, hi in ((0, 6), (6, 10), (10, 11), (11, 12)):   # chunks, then decode
        pos = np.broadcast_to(np.arange(lo, hi), (2, hi - lo)).astype(np.int32)
        want, jcache = _jax_attn(jcfg, p, x[:, lo:hi], pos, jcache)
        with torch.no_grad():
            got, cache = layer(t(x[:, lo:hi]), positions=t(pos, torch.long), cache=cache,
                               compute_dtype=torch.float32)
        _close(got, want)
        assert cache["k"].dtype == torch.bfloat16   # the JAX package's KV dtype
        for k in ("k", "v"):
            np.testing.assert_array_equal(n(cache[k]), np.asarray(jcache[k], np.float32))
        assert cache["index"].tolist() == [hi, hi]


def test_mlp_matches_jax():
    jcfg = jmlp.MlpCfg(d_model=16, d_ff=24)
    p = _init(jmlp.mlp_init, jcfg, 7)
    layer = Mlp(MlpCfg(d_model=16, d_ff=24), device="cpu")
    layer.load_state_dict(_state(p))
    x = _x((2, 5, 16), 8)
    want = jax.jit(lambda p, x: jmlp.mlp_apply(p, x, jcfg, **F32))(p, x)
    with torch.no_grad():
        _close(layer(t(x), compute_dtype=torch.float32), want)


MOE = dict(d_model=16, d_ff=24, n_experts=4, top_k=2)


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_both_routings_match_jax(dropless):
    jcfg = jmlp.MoeCfg(**MOE)
    p = _init(jmlp.moe_init, jcfg, 9)
    layer = Moe(MoeCfg(**MOE), device="cpu")
    layer.load_state_dict(_state(p))
    assert layer.router.w.dtype == torch.float32
    x = _x((2, 9, 16), 10)
    want, want_aux = jax.jit(
        lambda p, x: jmlp.moe_apply(p, x, jcfg, dropless=dropless, **F32))(p, x)
    with torch.no_grad():
        got, got_aux = layer(t(x), compute_dtype=torch.float32, dropless=dropless)
    _close(got, want)
    if dropless:   # serving: the port computes no aux losses
        assert got_aux == {}
    else:
        assert set(got_aux) == set(want_aux)
        for k in want_aux:   # f32 means over 18 tokens: a few ulps
            np.testing.assert_allclose(n(got_aux[k]), np.asarray(want_aux[k]), rtol=1e-6)
    # a zero router ties every expert: both pick the lowest indices, and the
    # capacity routing then drops the same tokens
    p0 = dict(p, router={"w": np.zeros_like(p["router"]["w"])})
    layer.router.w.data.zero_()
    want0, _ = jax.jit(lambda p, x: jmlp.moe_apply(p, x, jcfg, dropless=dropless, **F32))(p0, x)
    with torch.no_grad():
        _close(layer(t(x), compute_dtype=torch.float32, dropless=dropless)[0], want0)


def test_rmsnorm_and_rope_match_jax():
    x = _x((2, 5, 3, 8), 11)
    scale = 1.0 + 0.1 * _x((8,), 12)
    norm = RMSNorm(8, device="cpu")
    norm.scale.data.copy_(t(scale))
    with torch.no_grad():
        _close(norm(t(x)), j_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    pos = np.random.default_rng(13).integers(0, 500, size=(2, 5)).astype(np.int32)
    want = j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0)
    _close(apply_rope(t(x), t(pos, torch.long), theta=10000.0), want, atol=2e-5)


def test_norms_default_to_rms_in_both_packages():
    """A config that names no norm: RMS in the block and at the end, as in
    the JAX package; goom-rnn names ``ln`` and keeps it."""
    jblk = JBlockCfg(mixer="goom_ssm", channel="none",
                     goom=JGoomSSMCfg(d_model=8, head_dim=4))
    jp, _ = unzip(jblock_init(KeyGen(jax.random.PRNGKey(0)), jblk))
    assert set(jp["mixer_norm"]) == {"scale"}
    assert JLMConfig(name="x", family="ssm", vocab=8, d_model=8, n_layers=1,
                     groups=()).final_norm == "rms"
    blk = BlockCfg(mixer="goom_ssm", channel="none", goom=GoomSSMCfg(d_model=8, head_dim=4))
    cfg = LMConfig(name="x", family="ssm", vocab=8, d_model=8, n_layers=1,
                   groups=(GroupCfg(period=(blk,), n_periods=1),))
    model = DecoderLM(cfg, device="cpu")
    assert isinstance(model.layers[0].mixer_norm, RMSNorm)
    assert isinstance(model.final_norm, RMSNorm)
    assert set(model.layers[0].mixer_norm.state_dict()) == set(jp["mixer_norm"])
    rnn = DecoderLM(get_config("goom-rnn-124m", smoke=True), device="cpu")
    assert not isinstance(rnn.layers[0].mixer_norm, RMSNorm)
    assert not isinstance(rnn.final_norm, RMSNorm)


def test_block_of_an_unported_kind_raises():
    """A mixer or a channel that no config names raises, naming it."""
    with pytest.raises(NotImplementedError, match="bogus"):
        Block(BlockCfg(mixer="bogus", channel="none"), device="cpu")
    attn = AttentionCfg(**ATTN)
    with pytest.raises(NotImplementedError, match="bogus"):
        Block(BlockCfg(mixer="attention", channel="bogus", attn=attn), device="cpu")


# ---------------------------------------------------------------------------
# the model and serving
# ---------------------------------------------------------------------------
def _periods(cfg, n_periods):
    return dataclasses.replace(
        cfg, n_layers=8 * n_periods,
        groups=tuple(dataclasses.replace(g, n_periods=n_periods) for g in cfg.groups))


@pytest.fixture(scope="module", params=[1, 2], ids=["1period", "2periods"])
def pair(request):
    """(JAX model, JAX params, port model) of the Jamba smoke config at f32
    compute, with ``request.param`` periods (JAX stacks two on a leading
    axis; ``params_from_jax`` unstacks them)."""
    jcfg = _periods(dataclasses.replace(jax_get_config("jamba-v0.1", smoke=True),
                                        compute_dtype=jnp.float32), request.param)
    jmodel = JaxLM(jcfg)
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    cfg = _periods(dataclasses.replace(get_config("jamba-v0.1", smoke=True),
                                       compute_dtype=torch.float32), request.param)
    model = DecoderLM(cfg, device="cpu")
    sd = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    return jmodel, jparams, model


def test_config_matches_jax_and_params_load(pair):
    jmodel, jparams, model = pair
    for jb, b in zip(jmodel.cfg.layer_list, model.cfg.layer_list):
        assert (jb.mixer, jb.channel, jb.norm) == (b.mixer, b.channel, b.norm)
    full = get_config("jamba-v0.1")
    assert (full.d_model, full.vocab, full.n_layers) == (4096, 65536, 32)
    assert full.layer_list[4].attn.n_kv_heads == 8 and full.layer_list[1].moe.n_experts == 16
    g = jparams["group_0"]["b0"]["mixer"]["a_log"]
    want = g[-1] if model.cfg.groups[0].n_periods > 1 else g
    np.testing.assert_array_equal(n(model.layers[-8].mixer.a_log), np.asarray(want))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=p).tolist() for p in PROMPT_LENS]


def test_logits_match_jax(pair):
    jmodel, jparams, model = pair
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab, size=(2, 19))
    with jax_engine.use_backend("xla_reference"):
        want = np.asarray(jax.jit(lambda p, x: jmodel.apply(p, x)[0])(jparams, toks))
    with torch.no_grad():
        got = model(t(toks, torch.long)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(want.std()))


def _jax_chunked(jmodel, jparams, seq, chunk, length):
    """JAX's chunked ingestion through dense caches: the last logits."""
    def step(p, tok, c, pos):
        with jax_engine.use_backend("xla_reference"):
            if tok.shape[1] > 1:
                return jmodel.prefill(p, tok, c, positions=pos)
            return jmodel.decode_step(p, tok, c, pos[0])

    step = jax.jit(step)
    caches, logits = jmodel.init_caches(1, length), None
    starts = list(range(0, len(seq) - len(seq) % chunk, chunk)) + \
        list(range(len(seq) - len(seq) % chunk, len(seq)))
    for lo in starts:
        hi = lo + (chunk if lo + chunk <= len(seq) - len(seq) % chunk else 1)
        logits, caches = step(jparams, jnp.asarray([seq[lo:hi]]), caches,
                              jnp.arange(lo, hi, dtype=jnp.int32)[None])
    return np.asarray(logits[0, -1])


@pytest.mark.parametrize("chunk", [1, 7, 8])
def test_chunked_prefill_matches_jax_dense_caches(pair, chunk):
    jmodel, jparams, model = pair
    seq = _prompts(model.cfg.vocab)[2]
    want = _jax_chunked(jmodel, jparams, seq, chunk, 32)
    engine.reset_calls()
    cp = ChunkedPrefill(model, chunk)
    got, _, next_pos = cp(seq, model.init_caches(1, 32))
    assert next_pos == len(seq)
    assert (cp.n_chunk_calls, cp.n_tail_calls) == divmod(len(seq), chunk)
    # one diagonal scan per Mamba layer and scan chunk of each call
    mamba_chunks = (len(seq) // chunk) * -(-chunk // 8) + len(seq) % chunk
    n_mamba = sum(b.mixer == "mamba" for b in model.cfg.layer_list)
    assert engine.calls["diagonal_scan"] == engine.calls["diagonal_scan_carry"] \
        == n_mamba * mamba_chunks
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=1e-4 * float(np.std(want)))


def _jax_last_logits(jmodel, jparams, seq):
    def prefill(params, tokens, caches):
        with jax_engine.use_backend("xla_reference"):
            return jmodel.prefill(params, tokens, caches)[0]

    lg = jax.jit(prefill)(jparams, jnp.asarray(seq, jnp.int32)[None],
                          jmodel.init_caches(1, len(seq)))
    return np.asarray(lg[0, -1], np.float32)


def _check_tokens(jmodel, jparams, prompt, got, want):
    """Equal, or diverging only where JAX's top-2 logit margin is a near tie."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            lg = _jax_last_logits(jmodel, jparams, list(prompt) + list(want[:i]))
            top2 = np.sort(lg)[-2:]
            assert float(top2[1] - top2[0]) < 1e-4 * float(np.std(lg)), (
                f"token {i}: port {g} vs JAX {w}")
            return
    assert len(got) == len(want)


def test_engine_tokens_match_jax_engine(pair):
    """Four requests through two slots, joining and leaving mid-batch; JAX's
    Engine and the port's page their KV (page size = chunk).
    Chunk 7 cuts across Mamba's scan chunk of 8; chunk 8 (one period only,
    for time) meets it."""
    jmodel, jparams, model = pair
    prompts = _prompts(model.cfg.vocab)
    for chunk in (7, 8) if model.cfg.groups[0].n_periods == 1 else (7,):
        want = JaxEngine(jmodel, jparams, max_slots=2, page_len=40, chunk=chunk,
                         backend="xla_reference").run(
            [JaxRequest(uid=i, prompt=p, max_new_tokens=b)
             for i, (p, b) in enumerate(zip(prompts, BUDGETS))])
        before = diagonal_scan_cuda.launches
        got = Engine(model, max_slots=2, page_len=40, chunk=chunk).run(
            [Request(uid=i, prompt=p, max_new_tokens=b)
             for i, (p, b) in enumerate(zip(prompts, BUDGETS))])
        assert diagonal_scan_cuda.launches == before  # the CPU never launches
        for i, p in enumerate(prompts):
            assert len(got[i]) == BUDGETS[i]
            _check_tokens(jmodel, jparams, p, got[i], want[i])


def test_frozen_slot_stays_bit_identical(pair):
    """A decode step over two slots with only slot 0 live: after
    ``merge_frozen`` slot 1's KV, index, conv and SSM state are its old
    bits; ``write_slot``/``read_slot`` round-trip a row exactly."""
    _, _, model = pair
    seqs = _prompts(model.cfg.vocab)[1:3]
    slots = model.init_caches(2, 32)
    for s, seq in enumerate(seqs):
        _, c, _ = ChunkedPrefill(model, 4)(seq, model.init_caches(1, 32))
        write_slot(slots, c, s)
        assert all(torch.equal(x, c[i][k]) for i, layer in enumerate(read_slot(slots, s))
                   for k, x in layer.items())
    before = read_slot(slots, 1)
    with torch.no_grad():
        _, stepped = model.decode_step(torch.tensor([[3], [5]]), slots,
                                       torch.tensor([len(s) for s in seqs]))
    merged = merge_frozen(stepped, slots, torch.tensor([True, False]))
    after = read_slot(merged, 1)
    assert any(not torch.equal(stepped[i][k][1:], x) for i, layer in enumerate(before)
               for k, x in layer.items())
    for b_layer, a_layer in zip(before, after):
        assert b_layer.keys() == a_layer.keys()
        for k in b_layer:
            assert torch.equal(b_layer[k], a_layer[k]), k
    assert int(merged[4]["index"][0]) == len(seqs[0]) + 1
