"""The port's paged KV pool and prefix reuse against the JAX package, on the CPU.

  * ``_paged_decode`` against JAX's ``_paged_decode_attention`` on the same
    pool and page tables, sentinel rows included: live rows' outputs and the
    real pages after the write agree (the port's trash page takes what JAX
    drops);
  * a frozen slot's and a cleared slot's pages stay bit-identical over the
    fused decode;
  * ``PagePool`` and ``PrefixIndex`` driven in lockstep with JAX's by a
    seeded op script: every return value and counter equal;
  * prefix hits on goom-rnn bit-identical to a ``prefix_reuse=False`` engine,
    running only the suffix's chunks and tails, with ``prefix_stats()``,
    ``prefill_tokens_saved`` and the call counts equal to JAX's;
  * the Jamba smoke config's paged Engine against JAX's paged Engine at
    horizons {1, 2, 8} x chunks {1, 7, 64}: tokens JAX's up to a near tie,
    counters JAX's.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.serve import Engine as JaxEngine
from repro.serve import PagePool as JaxPagePool
from repro.serve import PrefixIndex as JaxPrefixIndex
from repro.serve import Request as JaxRequest
from repro_torch import Engine, Request
from repro_torch.models.attention import Attention
from repro_torch.serve import PagePool, PrefixIndex, make_decode_multi, read_slot
from repro_torch.serve.state_cache import clear_slot_pages
from torch_parity import check_tokens, n, serve_pair, t

torch.set_num_threads(2)


def test_paged_decode_attention_matches_jax():
    rng = np.random.default_rng(0)
    b, h, kvh, hd, ps, n_pages, mb = 4, 4, 2, 8, 4, 10, 3
    pool_k = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    pool_v = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    # rows 0, 1 live (own pages, one shared), row 2 cleared (all sentinel),
    # row 3 live with its last block unassigned (sentinel past its index)
    pages = np.array([[0, 1, 2], [0, 3, 4], [n_pages] * 3, [5, 6, n_pages]], np.int64)
    index = np.array([9, 5, 7, 6], np.int64)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k_new = rng.normal(size=(b, 1, kvh, hd)).astype(np.float32)
    v_new = rng.normal(size=(b, 1, kvh, hd)).astype(np.float32)
    scale = hd ** -0.5
    jcfg = jattn.AttentionCfg(d_model=h * hd, n_heads=h, n_kv_heads=kvh, head_dim=hd)
    jcache = {"k": jnp.asarray(pool_k, jnp.bfloat16), "v": jnp.asarray(pool_v, jnp.bfloat16),
              "pages": jnp.asarray(pages, jnp.int32), "index": jnp.asarray(index, jnp.int32)}
    want, jnew = jax.jit(lambda q, k, v, c: jattn._paged_decode_attention(
        q, k, v, c, jcfg, scale))(jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jcache)
    trash = np.zeros((1, ps, kvh, hd), np.float32)
    cache = {"k": t(np.concatenate([pool_k, trash]), torch.bfloat16),
             "v": t(np.concatenate([pool_v, trash]), torch.bfloat16),
             "pages": t(pages, torch.long), "index": t(index, torch.long)}
    got, new = Attention._paged_decode(t(q), t(k_new), t(v_new), cache, scale)
    live = [0, 1, 3]
    np.testing.assert_allclose(n(got)[live], n(want)[live], rtol=1e-6, atol=1e-6)
    assert new["k"] is cache["k"]              # written in place
    np.testing.assert_array_equal(n(new["k"])[:-1], n(jnew["k"]))
    np.testing.assert_array_equal(n(new["v"])[:-1], n(jnew["v"]))
    assert n(new["index"]).tolist() == (index + 1).tolist()
    assert np.isfinite(n(got)).all()


@pytest.fixture(scope="module")
def jamba():
    return serve_pair("jamba-v0.1")


def _pool_pages(caches, pages):
    return [layer[key][pages].clone() for layer in caches if "pages" in layer
            for key in ("k", "v")]


def test_frozen_and_cleared_slots_pages_stay_bit_identical(jamba):
    """Two slots decode on Jamba's paged caches; then slot 1 is frozen
    (its term row off) and later cleared while its row stays live (a
    cancelled slot): its pages keep their bits through fused decode steps,
    while slot 0 advances."""
    _, _, model = jamba
    eng = Engine(model, max_slots=2, page_len=32, chunk=4)
    for i in range(2):
        eng.submit(Request(uid=i, prompt=list(range(3 + i, 12 + i)), max_new_tokens=20))
    eng.step()
    step = make_decode_multi(model, 2)
    block = torch.zeros(2, 2, dtype=torch.long)
    own = eng._slot_pages[1]
    before = _pool_pages(eng._caches, own)
    row0 = read_slot(eng._caches, 0)
    eng._term["active"][1] = False
    step(eng._tokens, eng._caches, eng._pos, eng._term, block)
    after = _pool_pages(eng._caches, own)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert any(not torch.equal(a, b) for la, lb in zip(row0, read_slot(eng._caches, 0))
               for a, b in zip(la.values(), lb.values()))
    assert int(block[0, 1]) == int(block[1, 1])            # frozen: repeats
    eng._term["active"][1] = True
    eng._term["remaining"][1] = 5
    clear_slot_pages(eng._caches, 1)
    pos1 = int(eng._pos[1])
    step(eng._tokens, eng._caches, eng._pos, eng._term, block)
    assert int(eng._pos[1]) == pos1 + 2                    # the dead row ran
    after = _pool_pages(eng._caches, own)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def _lockstep(seed):
    """One seeded op script on both packages' PagePool + PrefixIndex."""
    rng = random.Random(seed)
    sides = []
    for pool_cls, idx_cls in ((JaxPagePool, JaxPrefixIndex), (PagePool, PrefixIndex)):
        pool = pool_cls(12)
        sides.append((pool, idx_cls(pool, 2), []))
    for step in range(200):
        op = rng.randrange(6)
        toks = [rng.randrange(3) for _ in range(rng.randrange(1, 9))]
        k = rng.randrange(1, 4)
        limit = rng.choice([None, 0, 1, 2, 4])
        outs = []
        for pool, idx, held in sides:
            try:
                if op == 0:
                    got = pool.alloc(k)
                    held.extend(got or [])
                elif op == 1:
                    got = pool.unref(held.pop(0)) if held else None
                elif op == 2:
                    got = idx.match(toks, limit)
                    for p in got[1]:
                        pool.ref(p)
                        held.append(p)
                elif op == 3:
                    nb = len(toks) // 2
                    got = pool.alloc(nb)
                    if got is not None:
                        held.extend(got)
                        got = idx.publish(toks, got, [f"ck{step}.{b}" for b in range(nb)])
                elif op == 4:
                    got = idx.reserve(k + pool.n_free)
                else:
                    got = idx.evict_one()
            except ValueError as e:
                got = ("raised", str(e))
            outs.append(got)
        assert outs[0] == outs[1], (step, op)
        (jp, ji, _), (pp, pi, _) = sides
        assert (jp.n_free, jp.n_used, [jp.refcount(i) for i in range(12)]) == \
            (pp.n_free, pp.n_used, [pp.refcount(i) for i in range(12)]), step
        assert (ji.n_nodes, ji.n_lookups, ji.n_hits, ji.n_hit_tokens, ji.n_evicted) == \
            (pi.n_nodes, pi.n_lookups, pi.n_hits, pi.n_hit_tokens, pi.n_evicted), step


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_and_prefix_index_in_lockstep_with_jax(seed):
    _lockstep(seed)


@pytest.fixture(scope="module")
def goom():
    return serve_pair("goom-rnn-124m", "shared_a")


@pytest.mark.parametrize("chunk", [4, 7])
def test_prefix_hits_bit_identical_and_suffix_only(goom, chunk):
    """Cold, mid-page, page-boundary and identical-resubmit prompts over a
    shared prefix: tokens equal a no-reuse engine's, only the suffix's
    chunks and tails run, and every counter is JAX's."""
    jmodel, jparams, model = goom
    rng = np.random.default_rng(chunk)
    shared = rng.integers(1, model.cfg.vocab, size=30).tolist()
    prompts = [shared + rng.integers(1, model.cfg.vocab, size=5).tolist(),
               shared[:30 - chunk // 2 - 1] + rng.integers(1, model.cfg.vocab, size=7).tolist(),
               shared[:(30 // chunk) * chunk] + rng.integers(1, model.cfg.vocab, size=6).tolist()]
    prompts.append(list(prompts[0]))
    kw = dict(max_slots=2, page_len=64, chunk=chunk)
    engines = {"on": Engine(model, prefix_reuse=True, **kw),
               "off": Engine(model, prefix_reuse=False, **kw),
               "jax": JaxEngine(jmodel, jparams, backend="reference", **kw)}
    req = {"on": Request, "off": Request, "jax": JaxRequest}
    for i, prompt in enumerate(prompts):
        outs, counts = {}, {}
        for name, eng in engines.items():
            pre = (eng._prefill.n_chunk_calls, eng._prefill.n_tail_calls,
                   eng.prefix_stats()["prefill_tokens_saved"])
            eng.submit(req[name](uid=f"u{i}", prompt=prompt, max_new_tokens=4))
            while eng.has_work:
                eng.step()
            outs[name] = eng.pop_result(f"u{i}")
            counts[name] = (eng._prefill.n_chunk_calls - pre[0],
                            eng._prefill.n_tail_calls - pre[1],
                            eng.prefix_stats()["prefill_tokens_saved"] - pre[2])
        assert outs["on"] == outs["off"], i
        assert counts["on"] == counts["jax"], i
        p = len(prompt)
        fused = p - (1 if p % chunk else chunk)
        n_chunk, n_tail, hit = counts["on"]
        assert (n_chunk, n_tail) == divmod(fused - hit, chunk)
        assert (hit > 0) == (i > 0), i
        check_tokens(jmodel, jparams, prompt, outs["on"], outs["jax"])
    assert engines["on"].prefix_stats() == engines["jax"].prefix_stats()
    assert engines["off"].prefix_stats()["hits"] == 0


def test_eviction_under_page_pressure_matches_jax(goom):
    """Two cache pages: distinct prompts force index eviction; admission
    always succeeds and the pool and index counters are JAX's."""
    jmodel, jparams, model = goom
    rng = random.Random(7)
    prompts = [[rng.randrange(1, 200) for _ in range(9)] for _ in range(6)]
    kw = dict(max_slots=2, page_len=32, chunk=4, cache_pages=2)
    stats = []
    for eng, req in ((JaxEngine(jmodel, jparams, backend="reference", **kw), JaxRequest),
                     (Engine(model, **kw), Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(uid=f"ev{i}", prompt=p, max_new_tokens=3))
        while eng.has_work:
            eng.step()
        assert eng._index.n_evicted > 0 and eng._pool.n_used == eng._index.n_nodes
        stats.append(eng.prefix_stats())
    assert stats[1] == stats[0]


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_jamba_paged_engine_matches_jax(jamba, chunk):
    """Five requests through two slots on Jamba's paged caches (page size
    = chunk): the port at horizons 1, 2 and 8 against JAX's at 8."""
    jmodel, jparams, model = jamba
    rng = np.random.default_rng(0)
    lens, budgets = [1, 7, 19, 64, 70], [9, 4, 12, 6, 3]
    prompts = [rng.integers(0, model.cfg.vocab, size=p).tolist() for p in lens]
    kw = dict(max_slots=2, page_len=96, chunk=chunk)
    jeng = JaxEngine(jmodel, jparams, backend="xla_reference", eos_scan_every=8, **kw)
    want = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=b)
                     for i, (p, b) in enumerate(zip(prompts, budgets))])
    outs = {}
    for k in (1, 2, 8):
        eng = Engine(model, eos_scan_every=k, **kw)
        outs[k] = eng.run([Request(uid=i, prompt=p, max_new_tokens=b)
                           for i, (p, b) in enumerate(zip(prompts, budgets))])
        if k == 8:
            assert eng.decode_stats() == jeng.decode_stats()
            assert eng.prefix_stats() == jeng.prefix_stats()
            assert (eng._prefill.n_chunk_calls, eng._prefill.n_tail_calls) == \
                (jeng._prefill.n_chunk_calls, jeng._prefill.n_tail_calls)
    assert outs[2] == outs[1] and outs[8] == outs[1]
    for i, p in enumerate(prompts):
        assert len(outs[1][i]) == budgets[i]
        check_tokens(jmodel, jparams, p, outs[1][i], want[i])


def test_slot_cache_bytes_from_meta_shapes(jamba):
    """Sized from ``device="meta"`` tensors, nothing allocated: dense rows
    cost JAX's KV bytes, and the paged pool JAX's plus its trash page."""
    from repro.serve import slot_cache_bytes as jax_bytes
    from repro_torch.serve import slot_cache_bytes

    jmodel, _, model = jamba
    dense, jdense = slot_cache_bytes(model, 3, 40), jax_bytes(jmodel, 3, 40)
    assert dense["kv_pages"] == jdense["kv_pages"] > 0
    paged = slot_cache_bytes(model, 3, 40, page_size=8, cache_pages=4)
    jpaged = jax_bytes(jmodel, 3, 40, page_size=8, cache_pages=4)
    n_pages = 3 * 5 + 4
    assert paged["kv_pages"] * n_pages == jpaged["kv_pages"] * (n_pages + 1)
    assert paged["total"] == paged["kv_pages"] + paged["recurrent"]
    assert paged["per_slot"] == paged["total"] // 3
