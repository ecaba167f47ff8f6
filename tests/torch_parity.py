"""Shared helpers for the port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both the JAX package
(on the CPU) and the PyTorch port (``device="cpu"``); results come back as
numpy arrays and are compared here.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def t(x, dtype=torch.float32) -> torch.Tensor:
    """numpy -> CPU torch tensor (a copy)."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def n(x) -> np.ndarray:
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


@contextlib.contextmanager
def f32_kv(model):
    """Within: every cache ``model`` builds (``init_caches``, and through it
    ``init_slot_caches``) holds its attention K/V in f32, where the model
    keeps bf16 as the JAX package does, so that the cached paths can be
    held to the cache-free forward without bf16 rounding."""
    build = model.init_caches

    def init_caches(*args, **kw):
        return [{k: v.float() if k in ("k", "v") and "index" in c else v
                 for k, v in c.items()} for c in build(*args, **kw)]

    model.init_caches = init_caches
    try:
        yield model
    finally:
        del model.init_caches


def state_dict_of(tree) -> dict:
    """A JAX param subtree (nested dicts) as a port module's state dict:
    dotted names, CPU tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in state_dict_of(v).items()})
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def assert_goom_close(got_log, got_sign, want_log, want_sign, *, scale_log=None,
                      atol=1e-4, cancel_margin=12.0):
    """Port of ``tests/test_kernels.py::assert_goom_close`` on numpy planes.

    Values normalised by their scale agree to ``atol``; away from
    cancellation (entries within ``cancel_margin`` log-units of the scale)
    log-magnitudes agree to rtol 1e-4 / atol 1e-3 and signs exactly.  The
    scale is the output's row max, as in the JAX helper, or, where larger,
    ``scale_log``: the log of the entry's own absolute contraction
    sum_k |a_ik b_kj| (see ``lmme_abs_scale``).  The row max alone cannot
    see cancellation in an (n, 1) matvec output, whose row is one entry.
    """
    got_log, got_sign = n(got_log), n(got_sign)
    want_log, want_sign = n(want_log), n(want_sign)
    m = np.maximum(want_log.max(-1, keepdims=True), got_log.max(-1, keepdims=True))
    if scale_log is not None:
        m = np.maximum(m, n(scale_log))
    m = np.where(np.isfinite(m), m, 0.0)
    gv = got_sign * np.exp(got_log - m)
    wv = want_sign * np.exp(want_log - m)
    np.testing.assert_allclose(gv, wv, atol=atol, rtol=0)
    ok = want_log > m - cancel_margin
    np.testing.assert_allclose(got_log[ok], want_log[ok], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got_sign[ok], want_sign[ok])


def lmme_abs_scale(a_log, b_log) -> np.ndarray:
    """log sum_k |a_ik||b_kj|: each LMME entry's scale without cancellation."""
    from repro_torch.core.goom import Goom
    from repro_torch.core.ops import lmme_reference

    al, bl = t(a_log), t(b_log)
    out = lmme_reference(Goom(al, torch.ones_like(al)), Goom(bl, torch.ones_like(bl)))
    return n(out.log_abs)


def goom_planes(rng: np.random.Generator, shape, *, spread: float = 0.0,
                along: str = "row", zero_rows: bool = False):
    """Random (log_abs, sign) f32 planes of an LMME operand.

    ``spread`` shifts each row (``along="row"``, for A) or column
    (``along="col"``, for B) by a log offset from [-spread, spread]: outputs
    then span e±spread while each contraction stays well conditioned, as in
    the JAX package's e±200 tests.  ``zero_rows`` sets the first row of every
    matrix to exact zeros (log -inf)."""
    log = rng.normal(size=shape).astype(np.float32)
    if spread:
        off = shape[:-1] + (1,) if along == "row" else shape[:-2] + (1, shape[-1])
        log += rng.uniform(-spread, spread, size=off).astype(np.float32)
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)
    if zero_rows:
        log[..., 0, :] = -np.inf
        sign[..., 0, :] = 1.0
    return log, sign


def with_scan_variant(cfg, variant: str):
    """``cfg`` (a JAX or a port ``LMConfig``) with every goom layer's
    ``scan_variant`` set to ``variant``; neither package names such a config."""
    def block(b):
        return dataclasses.replace(b, goom=dataclasses.replace(b.goom, scan_variant=variant))

    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, period=tuple(block(b) for b in g.period))
        for g in cfg.groups))


def goom_dist(x, exact, scale_log) -> float:
    """max |x - exact| over each entry's scale: the distance of GOOM ``x``
    (any ``.log_abs``/``.sign`` pair) to ``exact``, with ``scale_log`` the
    log of the entry's size before cancellation."""
    def f64(v):
        return v.detach().cpu().double().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v, np.float64)

    xl, el, sc = f64(x.log_abs), f64(exact.log_abs), f64(scale_log)
    sc = np.where(np.isfinite(sc), sc, 0.0)
    return float(np.abs(f64(x.sign) * np.exp(xl - sc) - f64(exact.sign) * np.exp(el - sc)).max())


# ---------------------------------------------------------------------------
# serving: model pairs on the same weights, and token checks
# ---------------------------------------------------------------------------
def serve_pair(arch: str, variant: str = None, periods: int = None,
               perturb: float = 0.0):
    """(JAX model, JAX params, port model) of ``arch``'s smoke config at f32
    compute on the same seeded weights (``params_from_jax``); goom-rnn in
    scan ``variant``, every group cut to ``periods`` periods (Jamba's are 8
    layers long).  ``perturb`` adds N(0, perturb²) noise (numpy, seed 1) to
    every JAX leaf, so that parameters initialised to zeros or constants
    (LoRA ``b``s, token-shift mixes, biases, norm scales) take part."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models.common import unzip
    from repro.models.model import DecoderLM as JaxLM
    from repro_torch import DecoderLM, get_config, params_from_jax

    def shape(cfg, f32):
        cfg = dataclasses.replace(cfg, compute_dtype=f32)
        if variant is not None:
            cfg = with_scan_variant(cfg, variant)
        if periods is not None:
            groups = tuple(dataclasses.replace(g, n_periods=periods) for g in cfg.groups)
            cfg = dataclasses.replace(cfg, groups=groups, n_layers=sum(
                len(g.period) * g.n_periods for g in groups))
        return cfg

    jmodel = JaxLM(shape(jax_get_config(arch, smoke=True), jnp.float32))
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(np.asarray, jparams)
    if perturb:
        rng = np.random.default_rng(1)
        jparams = jax.tree.map(
            lambda v: (v + perturb * rng.normal(size=v.shape)).astype(v.dtype), jparams)
    cfg = shape(get_config(arch, smoke=True), torch.float32)
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jparams))
    return jmodel, jax.tree.map(jnp.asarray, jparams), model


def jax_last_logits(jmodel, jparams, seq) -> np.ndarray:
    """JAX's last-position logits of ``seq`` under its reference backend."""
    import jax
    import jax.numpy as jnp

    from repro.core import engine as jax_engine

    def prefill(params, tokens, caches):
        with jax_engine.use_backend("reference"):
            return jmodel.prefill(params, tokens, caches)[0]

    lg = jax.jit(prefill)(jparams, jnp.asarray(seq, jnp.int32)[None],
                          jmodel.init_caches(1, len(seq)))
    return np.asarray(lg[0, -1], np.float32)


def check_tokens(jmodel, jparams, prompt, got, want) -> None:
    """Port tokens ``got`` against JAX's ``want``: equal, or diverging only
    where JAX's top-2 logit margin is below 1e-4·std(logits) (a near tie),
    after which the request is compared no further."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            lg = jax_last_logits(jmodel, jparams, list(prompt) + list(want[:i]))
            top2 = np.sort(lg)[-2:]
            margin = float(top2[1] - top2[0])
            assert margin < 1e-4 * float(np.std(lg)), (
                f"token {i}: port {g} vs JAX {w} at margin {margin}")
            return
    assert len(got) == len(want)


def cache_leaves(caches):
    """Every slot-cache leaf as (name, tensor), the pools without their trash
    page (whose bits depend on how many dead steps ran)."""
    out = []
    for i, layer in enumerate(caches):
        for k, v in layer.items():
            if "pages" in layer and k in ("k", "v"):
                v = v[:-1]
            out.append((f"{i}.{k}", v))
    return out


def jax_layer_caches(cfg, caches):
    """JAX's per-group, per-period cache tree (``DecoderLM.init_caches``) as
    the port's list of flat per-layer dicts: ``{"rwkv": {x_prev, wkv},
    "cm_x_prev"}`` becomes ``{x_prev, wkv, cm_x_prev}``, ``{"attn": {k, v,
    index}}`` becomes ``{k, v, index}``."""
    out = []
    for grp, gc in zip(cfg.groups, caches):
        for pc in ([gc] if grp.n_periods == 1 else gc):
            for i in range(len(grp.period)):
                flat = {}
                for k, v in pc.get(f"b{i}", {}).items():
                    flat.update(v if isinstance(v, dict) else {k: v})
                out.append(flat)
    return out


ENGINE_LENS = [1, 7, 19, 64, 70]
ENGINE_BUDGETS = [9, 4, 12, 6, 3]


def check_engine_against_jax(jmodel, jparams, model, chunk, page_len=96):
    """Five requests through two slots, joining and leaving mid-batch: the
    port's Engine at horizons 1 and 8 (equal tokens) against JAX's paged
    Engine (equal up to a near tie); the decode and prefix counters equal."""
    from repro.serve import Engine as JaxEngine
    from repro.serve import Request as JaxRequest
    from repro_torch import Engine, Request

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, size=p).tolist() for p in ENGINE_LENS]
    kw = dict(max_slots=2, page_len=page_len, chunk=chunk)
    jeng = JaxEngine(jmodel, jparams, backend="xla_reference", **kw)
    want = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=b)
                     for i, (p, b) in enumerate(zip(prompts, ENGINE_BUDGETS))])
    outs = {}
    for k in (1, 8):
        eng = Engine(model, eos_scan_every=k, **kw)
        outs[k] = eng.run([Request(uid=i, prompt=p, max_new_tokens=b)
                           for i, (p, b) in enumerate(zip(prompts, ENGINE_BUDGETS))])
        if k == 8:
            assert eng.decode_stats() == jeng.decode_stats()
            assert eng.prefix_stats() == jeng.prefix_stats()
    assert outs[8] == outs[1]
    for i, p in enumerate(prompts):
        assert len(outs[1][i]) == ENGINE_BUDGETS[i]
        check_tokens(jmodel, jparams, p, outs[1][i], want[i])


def check_prefix_hits_bit_identical(model, chunk, page_len=128):
    """Prompts over a shared 70-token prefix (cold, mid-page, on a chunk
    boundary, an identical resubmit) through an Engine with prefix reuse and
    one without: equal tokens, a hit for every prompt after the first, and
    only the suffix's chunk and tail calls run."""
    from repro_torch import Engine, Request

    rng = np.random.default_rng(chunk)
    vocab = model.cfg.vocab
    shared = rng.integers(1, vocab, size=70).tolist()
    prompts = [shared + rng.integers(1, vocab, size=5).tolist(),
               shared[:max(chunk + 1, 70 - chunk // 2 - 1)]
               + rng.integers(1, vocab, size=7).tolist(),
               shared[:(70 // chunk) * chunk] + rng.integers(1, vocab, size=6).tolist()]
    prompts.append(list(prompts[0]))
    kw = dict(max_slots=2, page_len=page_len, chunk=chunk)
    on, off = Engine(model, prefix_reuse=True, **kw), Engine(model, prefix_reuse=False, **kw)
    for i, prompt in enumerate(prompts):
        outs, counts = {}, {}
        for name, eng in (("on", on), ("off", off)):
            pre = (eng._prefill.n_chunk_calls, eng._prefill.n_tail_calls,
                   eng.prefix_stats()["prefill_tokens_saved"])
            eng.submit(Request(uid=f"u{i}", prompt=prompt, max_new_tokens=4))
            while eng.has_work:
                eng.step()
            outs[name] = eng.pop_result(f"u{i}")
            counts[name] = (eng._prefill.n_chunk_calls - pre[0],
                            eng._prefill.n_tail_calls - pre[1],
                            eng.prefix_stats()["prefill_tokens_saved"] - pre[2])
        assert outs["on"] == outs["off"], i
        p = len(prompt)
        fused = p - (1 if p % chunk else chunk)
        n_chunk, n_tail, hit = counts["on"]
        assert (n_chunk, n_tail) == divmod(fused - hit, chunk)
        assert (hit > 0) == (i > 0), (i, hit)
    assert off.prefix_stats()["hits"] == 0


def jax_chunked(jmodel, jparams, seq, chunk, length):
    """JAX's chunked ingestion through dense caches: (last logits, caches)."""
    import jax
    import jax.numpy as jnp

    from repro.core import engine as jax_engine

    def step(p, tok, c, pos):
        with jax_engine.use_backend("xla_reference"):
            if tok.shape[1] > 1:
                return jmodel.prefill(p, tok, c, positions=pos)
            return jmodel.decode_step(p, tok, c, pos[0])

    step = jax.jit(step)
    caches, logits = jmodel.init_caches(1, length), None
    full = len(seq) - len(seq) % chunk
    for lo in list(range(0, full, chunk)) + list(range(full, len(seq))):
        hi = lo + (chunk if lo < full else 1)
        logits, caches = step(jparams, jnp.asarray([seq[lo:hi]]), caches,
                              jnp.arange(lo, hi, dtype=jnp.int32)[None])
    return np.asarray(logits[0, -1]), caches


def check_prefill_caches(jmodel, jparams, model, seq, chunk, length):
    """Port's ``ChunkedPrefill`` against JAX's chunked ingestion through dense
    caches, leaf by leaf: f32 leaves within 1e-5 of their own scale (max
    |leaf|, at least 1: a WKV state reaches ~20), indexes equal, and bf16 KV
    within one bf16 ulp of the leaf's largest entry (2^-7·max|leaf|); last
    logits within 1e-4·std, or 1e-2·std for a model with attention.

    Why: both packages round K and V to bf16 in the cache; a value whose f32
    bits differ in the last place between XLA's and PyTorch's products can
    round one bf16 ulp apart, and such a flip moves later layers' K/V and
    the logits (by up to ~1.5e-3·std here; the JAX package's own bound for
    bf16 KV rounding is 0.1·std, ``tests/test_serve_engine.py``)."""
    from repro_torch.serve import ChunkedPrefill

    want, jcaches = jax_chunked(jmodel, jparams, seq, chunk, length)
    cp = ChunkedPrefill(model, chunk)
    got, caches, next_pos = cp(seq, model.init_caches(1, length))
    assert next_pos == len(seq)
    assert (cp.n_chunk_calls, cp.n_tail_calls) == divmod(len(seq), chunk)
    has_kv = any(blk.mixer == "attention" for blk in model.cfg.layer_list)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0,
                               atol=(1e-2 if has_kv else 1e-4) * float(np.std(want)))
    jflat = jax_layer_caches(jmodel.cfg, jcaches)
    assert len(jflat) == len(caches)
    for i, (layer, jlayer) in enumerate(zip(caches, jflat)):
        assert set(layer) == set(jlayer), i
        for k, v in layer.items():
            want_leaf = np.asarray(jlayer[k], np.float32)
            if v.dtype == torch.bfloat16:
                np.testing.assert_allclose(n(v), want_leaf, rtol=0,
                                           atol=2 ** -7 * float(np.abs(want_leaf).max()))
            elif k == "index":
                np.testing.assert_array_equal(n(v), want_leaf)
            else:
                np.testing.assert_allclose(
                    n(v), want_leaf, rtol=0,
                    atol=1e-5 * max(1.0, float(np.abs(want_leaf).max())))
