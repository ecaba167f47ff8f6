"""The port's fused k-step decode against the JAX Engine, on the CPU.

goom-rnn-124m's smoke config in both scan variants at f32 compute, on the
JAX model's weights (``params_from_jax``).  Five requests through two slots,
joining and leaving mid-batch:

  * tokens at ``eos_scan_every`` in {1, 2, 8} x chunk in {1, 7, 64} against
    JAX's Engine (equal, or diverging only after a near tie: top-2 margin
    below 1e-4·std(logits));
  * the port's k=2 and k=8 tokens and final slot caches ``torch.equal`` to
    its k=1 run;
  * EOS and budgets that end mid-horizon, bit-identical to k=1;
  * ``decode_stats()`` (dispatches, decode steps, host syncs) and the
    prefill's chunk and tail call counts equal to JAX's on the same traffic,
    and at most 1/8 host sync per token at k=8;
  * the stream events' order and contents equal to JAX's.

JAX runs are shared through module fixtures and run jitted.
"""

import numpy as np
import pytest
import torch

from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import Engine, Request
from torch_parity import cache_leaves, check_tokens, serve_pair

torch.set_num_threads(2)

PROMPT_LENS = [1, 7, 19, 64, 70]
BUDGETS = [9, 4, 12, 6, 3]
SERVE = dict(max_slots=2, page_len=96)
CHUNKS = [1, 7, 64]
HORIZONS = [1, 2, 8]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=p).tolist() for p in PROMPT_LENS]


def _reqs(cls, prompts, budgets=BUDGETS, **kw):
    return [cls(uid=i, prompt=p, max_new_tokens=b, **kw)
            for i, (p, b) in enumerate(zip(prompts, budgets))]


def _stats(eng):
    s = eng.decode_stats()
    return (s["dispatches"], s["decode_steps"], s["host_syncs"], s["last_horizon"],
            eng._prefill.n_chunk_calls, eng._prefill.n_tail_calls)


@pytest.fixture(scope="module", params=["shared_a", "generic"])
def runs(request):
    """The model pair and JAX's Engine on the traffic: tokens at k=8 for
    every chunk, and stats at every horizon for chunk 7."""
    jmodel, jparams, model = serve_pair("goom-rnn-124m", request.param)
    prompts = _prompts(model.cfg.vocab)
    tokens, stats = {}, {}
    for chunk in CHUNKS:
        for k in HORIZONS if chunk == 7 else [8]:
            eng = JaxEngine(jmodel, jparams, chunk=chunk, eos_scan_every=k,
                            backend="reference", **SERVE)
            out = eng.run(_reqs(JaxRequest, prompts))
            if k == 8:
                tokens[chunk] = out
            stats[(chunk, k)] = _stats(eng)
    return dict(jmodel=jmodel, jparams=jparams, model=model, prompts=prompts,
                tokens=tokens, stats=stats)


def _port(model, prompts, chunk, k, **kw):
    eng = Engine(model, chunk=chunk, eos_scan_every=k, **SERVE)
    return eng, eng.run(_reqs(Request, prompts, **kw))


@pytest.mark.parametrize("chunk", CHUNKS)
def test_tokens_match_jax_at_every_horizon(runs, chunk):
    model, prompts = runs["model"], runs["prompts"]
    base_eng, base = _port(model, prompts, chunk, 1)
    for k in HORIZONS:
        eng, got = (base_eng, base) if k == 1 else _port(model, prompts, chunk, k)
        assert got == base, f"horizon {k} diverged from horizon 1"
        for (name, a), (_, b) in zip(cache_leaves(eng._caches), cache_leaves(base_eng._caches)):
            assert torch.equal(a, b), f"horizon {k}: final cache {name}"
        assert torch.equal(eng._tokens, base_eng._tokens)
        assert torch.equal(eng._pos, base_eng._pos)
        if (chunk, k) in runs["stats"]:
            assert _stats(eng) == runs["stats"][(chunk, k)], f"k={k}"
    for i, p in enumerate(prompts):
        assert len(base[i]) == BUDGETS[i]
        check_tokens(runs["jmodel"], runs["jparams"], p, base[i], runs["tokens"][chunk][i])


def test_eos_and_budget_mid_horizon_bit_identical(runs):
    """An EOS that a request first generates at its third token or later,
    and budgets of 6 and 10, end inside a horizon of 8: the device freezes
    the slot, the host trims, and the output is k=1's."""
    model, prompts = runs["model"], runs["prompts"]
    budgets = [6, 10, 12, 12, 12]
    _, base = _port(model, prompts, 7, 1, budgets=budgets)
    uid, cut = next((i, j) for i in (2, 3, 4) for j in range(2, 8)
                    if base[i][j] not in base[i][:j])
    eos = base[uid][cut]
    outs = {}
    for k in (1, 8):
        eng = Engine(model, chunk=7, eos_scan_every=k, **SERVE)
        reqs = _reqs(Request, prompts, budgets=budgets)
        reqs[uid].eos_id = eos
        for r in reqs:
            eng.submit(r)
        while eng.has_work:
            eng.step()
        outs[k] = [eng.result(i) for i in range(len(reqs))]
        assert eng.finish_reason(uid) == "stop"
        assert eng._alloc.n_used == 0
    assert outs[8] == outs[1]
    assert outs[1][uid] == base[uid][:cut + 1]
    assert [len(o) for o in outs[1][:2]] == [6, 10]


def test_host_syncs_per_token_at_most_an_eighth(runs):
    """Non-streaming, EOS-free traffic at k=8: one host read per (8, slots)
    token block at most (JAX's ``test_serve_engine.py`` bound)."""
    model = runs["model"]
    eng = Engine(model, chunk=4, eos_scan_every=8, max_slots=2, page_len=64)
    res = eng.run([Request(uid=i, prompt=list(range(3, 7 + i)), max_new_tokens=48)
                   for i in range(2)])
    assert all(len(res[i]) == 48 for i in range(2))
    stats = eng.decode_stats()
    assert stats["host_syncs"] * 8 <= stats["decode_steps"], stats
    assert stats["syncs_per_token"] <= 1.0 / 8
    assert stats["tokens_per_dispatch"] > 4.0


def test_stream_events_match_jax(runs):
    """Request 2 streams at k=8 beside two others: the (uid, tokens,
    finish_reason) events come in JAX's order with JAX's sizes, the
    concatenation is the non-streamed output, and one terminal event ends
    it."""
    model, prompts = runs["model"], runs["prompts"]
    events = {}
    for name, eng_cls, req_cls, kw in (
            ("jax", JaxEngine, JaxRequest, dict(backend="reference")),
            ("port", Engine, Request, {})):
        got = []
        args = (runs["jmodel"], runs["jparams"]) if name == "jax" else (model,)
        eng = eng_cls(*args, chunk=7, eos_scan_every=8,
                      stream_callback=lambda uid, toks, reason: got.append(
                          (uid, list(toks), reason)), **SERVE, **kw)
        reqs = _reqs(req_cls, prompts[:3], budgets=[5, 3, 20])
        reqs[2].stream = True
        out = eng.run(reqs)
        events[name] = (got, out)
    (jev, jout), (pev, pout) = events["jax"], events["port"]
    assert [(u, len(t), r) for u, t, r in pev] == [(u, len(t), r) for u, t, r in jev]
    assert [r for _, _, r in pev].count(None) == len(pev) - 1 and pev[-1][2] == "length"
    assert [t for _, toks, _ in pev for t in toks] == pout[2]
    check_tokens(runs["jmodel"], runs["jparams"], prompts[2], pout[2], jout[2])
