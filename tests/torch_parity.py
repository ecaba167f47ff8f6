"""Shared helpers for the port's parity tests (``test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both the JAX package
(on the CPU) and the PyTorch port (``device="cpu"``); results come back as
numpy arrays and are compared here.
"""

from __future__ import annotations

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
def serve_pair(arch: str, variant: str = None, periods: int = None):
    """(JAX model, JAX params, port model) of ``arch``'s smoke config at f32
    compute on the same seeded weights (``params_from_jax``); goom-rnn in
    scan ``variant``, Jamba cut to ``periods`` 8-layer periods."""
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
            cfg = dataclasses.replace(cfg, n_layers=8 * periods, groups=tuple(
                dataclasses.replace(g, n_periods=periods) for g in cfg.groups))
        return cfg

    jmodel = JaxLM(shape(jax_get_config(arch, smoke=True), jnp.float32))
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    cfg = shape(get_config(arch, smoke=True), torch.float32)
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model


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
