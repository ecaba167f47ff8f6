"""Request control in the port's Engine against the JAX Engine, on the CPU.

goom-rnn-124m's smoke config (``shared_a``) at f32 compute on the JAX
model's weights.  Each scenario drives the port's and JAX's Engine with the
same script: cancel of a queued and of an active request, the result and
``KeyError`` contract with ``pop_result``, deadlines that pass in the queue
and mid-decode (at horizons 1 and 8) under a monkeypatched clock, and a
deadline-free loop that never reads the clock.  Finish reasons, output
lengths, decode counters and slot occupancy must be JAX's, tokens JAX's up
to a near tie.  ``ServeMetrics.snapshot()`` must equal JAX's on one
recorded event sequence.  The serving loop reads the card only through its
token lane, and the lockstep ``generate`` gives JAX's tokens.
"""

import numpy as np
import pytest
import torch

from repro.serve import CANCELLED as JAX_CANCELLED
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro.serve import metrics as jax_metrics
from repro.serve import scheduler as jax_scheduler
from repro_torch import CANCELLED, Engine, Request
from repro_torch.serve import ServeMetrics
from repro_torch.serve import metrics as port_metrics
from repro_torch.serve import scheduler as port_scheduler
from torch_parity import check_tokens, serve_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return serve_pair("goom-rnn-124m", "shared_a")


def _prompt(vocab, n, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=n).tolist()


class _FakeClock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _engines(pair, **kw):
    """(JAX engine, Request class) and (port engine, Request class)."""
    jmodel, jparams, model = pair
    return ((JaxEngine(jmodel, jparams, backend="reference", **kw), JaxRequest),
            (Engine(model, **kw), Request))


def _drain(eng):
    while eng.has_work:
        eng.step()


def test_cancel_active_and_queued_requests(pair):
    """Cancel the active request (its slot frees at once and the queued one
    runs in it) and a queued one (it never runs), in both engines."""
    jmodel, jparams, model = pair
    p0, p1, p2 = (_prompt(model.cfg.vocab, n, s) for n, s in ((6, 30), (5, 31), (4, 32)))
    seen = []
    for eng, req in _engines(pair, max_slots=1, page_len=64, chunk=4):
        eng.submit(req(uid="a", prompt=p0, max_new_tokens=30))
        eng.submit(req(uid="b", prompt=p1, max_new_tokens=4))
        eng.submit(req(uid="c", prompt=p2, max_new_tokens=4))
        eng.step()
        eng.step()
        assert eng.n_active == 1 and eng.n_waiting == 2
        assert eng.cancel("c") is True and eng.n_waiting == 1
        assert eng.cancel("a") is True
        assert eng.n_active == 0 and eng._alloc.n_used == 0
        assert eng.finish_reason("a") == eng.finish_reason("c") == "cancelled"
        _drain(eng)
        assert eng._alloc.n_used == 0 and eng._pool.n_used == eng._index.n_nodes
        assert eng.cancel("a") is False and eng.cancel("b") is False
        assert eng.cancel("never-submitted") is False
        seen.append((eng.result("a"), eng.result("c"), eng.result("b"),
                     eng.decode_stats()))
    (ja, jc, jb, jstats), (pa, pc, pb, pstats) = seen
    assert ja is JAX_CANCELLED and jc is JAX_CANCELLED
    assert pa is CANCELLED and pc is CANCELLED
    assert pstats == jstats
    check_tokens(jmodel, jparams, p1, pb, jb)


def test_result_contract_and_pop_result(pair):
    _, _, model = pair
    eng = Engine(model, max_slots=1, page_len=32, chunk=4)
    with pytest.raises(KeyError):
        eng.result("never-submitted")
    eng.submit(Request(uid="c", prompt=[1, 2, 3], max_new_tokens=8))
    assert eng.cancel("c") is True
    assert eng.result("c") is CANCELLED
    assert not CANCELLED and repr(CANCELLED) == "CANCELLED"
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(Request(uid="c", prompt=[1, 2], max_new_tokens=2))
    assert eng.pop_result("c") is CANCELLED
    with pytest.raises(KeyError):
        eng.result("c")
    eng.submit(Request(uid="d", prompt=[4, 5], max_new_tokens=3))
    _drain(eng)
    out = eng.pop_result("d")
    assert len(out) == 3
    with pytest.raises(KeyError):
        eng.finish_reason("d")
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.submit(Request(uid="e", prompt=[1], max_new_tokens=2, deadline_ms=0))


@pytest.mark.parametrize("horizon", [1, 8])
def test_deadline_mid_decode_matches_jax(pair, monkeypatch, horizon):
    """A 50 ms deadline passes after three steps on a frozen fake clock: the
    request ends "timeout" with its partial output, and the follow-up
    request runs in the freed slot.  Lengths, stats and horizons are JAX's."""
    jmodel, jparams, model = pair
    p0, p1 = _prompt(model.cfg.vocab, 6, 40), _prompt(model.cfg.vocab, 5, 41)
    seen = []
    for eng, req in _engines(pair, max_slots=1, page_len=64, chunk=4,
                             eos_scan_every=horizon):
        clock = _FakeClock()
        monkeypatch.setattr(jax_scheduler, "time", clock)
        monkeypatch.setattr(port_scheduler, "time", clock)
        eng.submit(req(uid="t", prompt=p0, max_new_tokens=40, deadline_ms=50.0))
        horizons = []
        for _ in range(3):
            eng.step()
            horizons.append(eng.decode_stats()["last_horizon"])
        clock.now += 0.2
        finished = eng.step()
        assert "t" in finished and eng.finish_reason("t") == "timeout"
        got = eng.result("t")
        assert 0 < len(got) < 40
        eng.submit(req(uid="u", prompt=p1, max_new_tokens=4))
        _drain(eng)
        assert eng._alloc.n_used == 0 and eng._n_deadlines == 0
        seen.append((got, eng.result("u"), horizons, eng.decode_stats()))
    (jt, ju, jh, js), (pt, pu, ph, ps) = seen
    assert len(pt) == len(jt) and ph == jh and ps == js
    assert ph[-1] == horizon
    check_tokens(jmodel, jparams, p0, pt, jt)
    check_tokens(jmodel, jparams, p1, pu, ju)


def test_deadline_in_queue_matches_jax(pair, monkeypatch):
    jmodel, jparams, model = pair
    p0 = _prompt(model.cfg.vocab, 6, 42)
    seen = []
    for eng, req in _engines(pair, max_slots=1, page_len=64, chunk=4):
        clock = _FakeClock()
        monkeypatch.setattr(jax_scheduler, "time", clock)
        monkeypatch.setattr(port_scheduler, "time", clock)
        events = []
        eng.stream_callback = lambda uid, toks, reason: events.append((uid, list(toks), reason))
        eng.submit(req(uid="long", prompt=p0, max_new_tokens=6))
        eng.submit(req(uid="q", prompt=[1, 2, 3], max_new_tokens=4, deadline_ms=10.0,
                       stream=True))
        eng.step()
        clock.now += 1.0
        _drain(eng)
        assert eng.result("q") == [] and eng.finish_reason("q") == "timeout"
        assert eng._alloc.n_used == 0 and eng._n_deadlines == 0
        seen.append((eng.result("long"), events, eng.decode_stats()))
    (jl, jev, js), (pl, pev, ps) = seen
    assert pev == jev == [("q", [], "timeout")]
    assert ps == js and len(pl) == len(jl) == 6
    check_tokens(jmodel, jparams, p0, pl, jl)


def test_no_clock_read_without_deadlines(pair, monkeypatch):
    """Deadline support costs nothing unused: a deadline-free loop reads no
    clock, and the two requests, finishing together, take one flush."""
    _, _, model = pair
    reads = {"n": 0}
    real = port_scheduler.time

    class _Counting:
        @staticmethod
        def monotonic():
            reads["n"] += 1
            return real.monotonic()

    flushes = {"n": 0}
    real_flush = Engine._flush

    def counting_flush(self):
        flushes["n"] += 1
        return real_flush(self)

    monkeypatch.setattr(port_scheduler, "time", _Counting)
    monkeypatch.setattr(Engine, "_flush", counting_flush)
    eng = Engine(model, max_slots=2, page_len=32, chunk=4)
    eng.submit(Request(uid=0, prompt=[5, 6, 7], max_new_tokens=6))
    eng.submit(Request(uid=1, prompt=[8, 9], max_new_tokens=6))
    _drain(eng)
    assert reads["n"] == 0, "a deadline-free step loop read the clock"
    assert flushes["n"] == 1
    assert len(eng.result(0)) == 6 and len(eng.result(1)) == 6


def test_serve_metrics_snapshot_matches_jax(monkeypatch):
    """One recorded event sequence into both packages' ``ServeMetrics``
    under the same fake clock: equal snapshots, percentiles included."""
    clock = _FakeClock()
    monkeypatch.setattr(jax_metrics, "time", clock)
    monkeypatch.setattr(port_metrics, "time", clock)
    rng = np.random.default_rng(3)
    events = []
    for i in range(300):
        kind = rng.integers(0, 7)
        events.append((kind, float(rng.random()), int(rng.integers(0, 9))))
    snaps = []
    for cls in (jax_metrics.ServeMetrics, ServeMetrics):
        clock.now = 1000.0
        m = cls(window=64)
        for kind, x, n in events:
            clock.now += 0.01
            if kind == 0:
                m.record_submitted()
            elif kind == 1:
                m.record_rejected()
            elif kind == 2:
                m.record_step(x, n)
            elif kind == 3:
                m.record_first_token(x)
            elif kind == 4:
                m.record_tokens(n)
            elif kind == 5:
                m.record_finished(["length", "stop", "timeout", "cancelled"][n % 4], n,
                                  x if n % 3 else None)
            else:
                m.record_prefix_stats({"hits": n, "hit_rate": x})
                m.record_decode_stats({"dispatches": n, "tokens_per_dispatch": x})
        snaps.append(m.snapshot())
    assert snaps[1] == snaps[0]
    assert port_metrics.percentiles([3.0, 1.0, 2.0]) == jax_metrics.percentiles([3.0, 1.0, 2.0])


def test_engine_reads_the_card_only_through_the_token_lane():
    """Every device-to-host read of the serving loop (``.item``, ``.tolist``,
    ``.cpu``, ``.numpy``, a synchronize) sits inside ``_TokenFlight``; the
    prompt's ``tolist`` is of a host array.  The counterpart of the JAX
    package's host-sync rule for its scheduler and steps."""
    import ast
    import pathlib

    import repro_torch.serve as serve

    root = pathlib.Path(serve.__file__).parent
    reads = {"item", "tolist", "cpu", "numpy", "synchronize"}
    for name in ("scheduler.py", "steps.py", "prefill.py", "state_cache.py"):
        tree = ast.parse((root / name).read_text())
        lane = next((n for n in tree.body if isinstance(n, ast.ClassDef)
                     and n.name == "_TokenFlight"), None)
        inside = {id(n) for n in ast.walk(lane)} if lane else set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in reads and id(node) not in inside):
                target = node.func.value
                assert isinstance(target, ast.Name) and target.id == "prompt", (
                    f"{name}:{node.lineno} reads the device outside _TokenFlight")


def test_generate_matches_jax(pair):
    """The lockstep ``generate`` driver of ``serve/steps.py``."""
    import jax.numpy as jnp

    from repro.serve import generate as jax_generate
    from repro_torch.serve import generate

    jmodel, jparams, model = pair
    prompt = np.random.default_rng(5).integers(0, model.cfg.vocab, size=(2, 9))
    want = np.asarray(jax_generate(jmodel, jparams, jnp.asarray(prompt, jnp.int32), 6, 32,
                                   backend="reference"))
    got = generate(model, torch.tensor(prompt), 6, 32).numpy()
    assert got.shape == (2, 6)
    for i in range(2):
        check_tokens(jmodel, jparams, prompt[i].tolist(), got[i].tolist(), want[i].tolist())
