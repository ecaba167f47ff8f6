"""The port's HTTP front door, on the CPU.

  * the SSE bytes of ``repro_torch.serve.api.sse`` equal the JAX package's
    (``encode_event``, ``completion_chunk``, the ``[DONE]`` frame) and its
    decoder survives any re-chunking;
  * a ``BackgroundServer`` over goom-rnn-124m's smoke config on the CPU
    (``build_engine(device="cpu")``, 2 slots, queue watermark 3): streamed
    and non-streamed completions equal a solo Engine's tokens, ``/status``
    carries its ``decode`` and ``prefix_cache`` sections, 400 for bad
    requests, 429 with ``Retry-After`` at saturation, a ``deadline_ms`` of 1
    gives a "timeout" with a prefix of the reference, and a client that
    hangs up mid-stream frees its slot as "cancelled".
"""

import json
import socket
import threading
import time

import pytest

from repro.serve.api import sse as jax_sse
from repro_torch.serve import Engine, Request
from repro_torch.serve.api import BackgroundServer, Gateway, build_engine
from repro_torch.serve.api import client as api_client
from repro_torch.serve.api import sse

MAX_SLOTS = 2
PAGE_LEN = 64
MAX_QUEUE = 3
LONG = 40
PROMPT = [3, 1, 4, 1, 5, 9]


def test_sse_bytes_equal_jax():
    for uid, tok, idx, reason in (("cmpl-0", 7, 0, None), ("u", 8, 3, "length"),
                                  (12, None, 5, "timeout"), ("c", 0, 1, "cancelled")):
        mine = sse.completion_chunk(uid, tok, idx, reason)
        assert mine == jax_sse.completion_chunk(uid, tok, idx, reason)
        assert sse.encode_event(mine) == jax_sse.encode_event(mine)
    assert sse.encode_event("[DONE]") == jax_sse.encode_event("[DONE]") == sse.DONE_EVENT
    events = [sse.completion_chunk("u", 7, 0), sse.completion_chunk("u", 8, 1, "length")]
    wire = b"".join(sse.encode_event(e) for e in events) + sse.DONE_EVENT
    for size in (1, 3, 7, len(wire)):
        dec = sse.SSEDecoder()
        got = [p for lo in range(0, len(wire), size) for p in dec.feed(wire[lo:lo + size])]
        assert got[-1] == sse.DONE_PAYLOAD
        assert [json.loads(p)["choices"][0]["token"] for p in got[:-1]] == [7, 8]


class _Server:
    def __init__(self):
        self.engine, self.cfg = build_engine(
            "goom-rnn-124m", smoke=True, max_slots=MAX_SLOTS, page_len=PAGE_LEN,
            chunk=4, device="cpu")
        self.gateway = Gateway(self.engine, max_queue=MAX_QUEUE)
        self.srv = BackgroundServer(self.gateway).start()
        self.host, self.port = self.srv.host, self.srv.port
        self.solo = Engine(self.engine.model, max_slots=1, page_len=PAGE_LEN, chunk=4)
        self._refs = {}

    def ref(self, prompt, n):
        key = (tuple(prompt), n)
        if key not in self._refs:
            uid = f"ref{len(self._refs)}"
            self._refs[key] = self.solo.run(
                [Request(uid=uid, prompt=list(prompt), max_new_tokens=n)])[uid]
        return self._refs[key]

    def wait_idle(self, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.engine.has_work and self.gateway.queue_depth() == 0:
                return
            time.sleep(0.01)
        raise TimeoutError("server did not drain")


@pytest.fixture(scope="module")
def server():
    s = _Server()
    api_client.completion(s.host, s.port, {"prompt": [1, 2, 3], "max_tokens": 2})
    yield s
    s.srv.stop()


def test_stream_equals_nonstream_equals_solo_engine(server):
    server.wait_idle()
    ref = server.ref(PROMPT, 8)
    out = api_client.completion(server.host, server.port, {"prompt": PROMPT, "max_tokens": 8})
    choice = out["choices"][0]
    assert choice["tokens"] == ref and choice["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": len(PROMPT), "completion_tokens": 8,
                            "total_tokens": len(PROMPT) + 8}
    events = list(api_client.stream_completion(server.host, server.port,
                                               {"prompt": PROMPT, "max_tokens": 8}))
    assert [e["choices"][0]["token"] for e in events] == ref
    assert [e["choices"][0]["finish_reason"] for e in events] == [None] * 7 + ["length"]
    assert [e["token_index"] for e in events] == list(range(8))


def test_raw_sse_wire(server):
    server.wait_idle()
    body = json.dumps({"prompt": PROMPT, "max_tokens": 4, "stream": True}).encode()
    with socket.create_connection((server.host, server.port), 10) as sock:
        sock.settimeout(30)
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                     b"Content-Length: %d\r\nConnection: close\r\n\r\n" % len(body) + body)
        raw = b""
        while (got := sock.recv(65536)):
            raw += got
    head, _, payload = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 OK")
    assert b"content-type: text/event-stream" in head.lower()
    assert payload.endswith(sse.DONE_EVENT)
    frames = payload.split(b"\n\n")[:-2]
    ref = server.ref(PROMPT, 4)
    want = b"".join(sse.encode_event(sse.completion_chunk(
        json.loads(frames[0][6:])["id"], tok, i, "length" if i == 3 else None))
        for i, tok in enumerate(ref))
    assert payload == want + sse.DONE_EVENT


def test_status_has_decode_and_prefix_sections(server):
    server.wait_idle()
    shared = list(range(1, 13))
    api_client.completion(server.host, server.port, {"prompt": shared + [40], "max_tokens": 2})
    api_client.completion(server.host, server.port,
                          {"prompt": shared + [50, 51], "max_tokens": 2})
    server.wait_idle()
    assert api_client.request_json(server.host, server.port, "GET", "/healthz") == {"ok": True}
    snap = api_client.get_status(server.host, server.port)
    assert set(snap) >= {"uptime_s", "requests", "throughput", "latency_ms", "busy_slots",
                         "engine", "prefix_cache", "decode"}
    dec, pc = snap["decode"], snap["prefix_cache"]
    assert set(dec) == {"dispatches", "decode_steps", "tokens_per_dispatch", "host_syncs",
                        "syncs_per_token", "horizon_max", "last_horizon"}
    assert dec["dispatches"] >= 1 and dec["decode_steps"] >= dec["dispatches"]
    assert dec["horizon_max"] == 8
    assert pc["enabled"] is True and pc["hits"] >= 1 and pc["prefill_tokens_saved"] >= 8
    assert pc["pages"]["used"] + pc["pages"]["free"] == pc["pages"]["total"]
    eng = snap["engine"]
    assert (eng["max_slots"], eng["queue_limit"], eng["page_len"], eng["n_active"]) == \
        (MAX_SLOTS, MAX_QUEUE, PAGE_LEN, 0)
    assert snap["requests"]["finished"] >= 1 and snap["latency_ms"]["decode_step"]["p50"] > 0


def test_error_paths(server):
    server.wait_idle()
    host, port = server.host, server.port
    for payload in ({"prompt": [], "max_tokens": 4}, {"prompt": PROMPT, "max_tokens": PAGE_LEN},
                    {"max_tokens": 4}):
        with pytest.raises(api_client.APIError) as e:
            api_client.completion(host, port, payload)
        assert e.value.status == 400
    with pytest.raises(api_client.APIError) as e:
        api_client.request_json(host, port, "GET", "/v1/completions")
    assert e.value.status == 405
    with pytest.raises(api_client.APIError) as e:
        api_client.request_json(host, port, "GET", "/nope")
    assert e.value.status == 404


def test_deadline_gives_timeout_with_partial_output(server):
    server.wait_idle()
    out = api_client.completion(server.host, server.port,
                                {"prompt": PROMPT, "max_tokens": LONG, "deadline_ms": 1})
    choice = out["choices"][0]
    assert choice["finish_reason"] == "timeout" and len(choice["tokens"]) < LONG
    assert choice["tokens"] == server.ref(PROMPT, LONG)[:len(choice["tokens"])]


def test_disconnect_mid_stream_cancels(server):
    server.wait_idle()
    before = server.gateway.metrics.snapshot()["requests"]["by_finish_reason"].get(
        "cancelled", 0)
    gen = api_client.stream_completion(server.host, server.port,
                                       {"prompt": PROMPT, "max_tokens": LONG})
    first = next(gen)
    assert first["choices"][0]["token"] == server.ref(PROMPT, LONG)[0]
    gen.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and server.engine.n_active:
        time.sleep(0.005)
    assert server.engine.n_active == 0
    server.wait_idle()
    snap = api_client.get_status(server.host, server.port)
    assert snap["requests"]["by_finish_reason"].get("cancelled", 0) == before + 1
    assert snap["engine"]["n_active"] == 0


def _hold(server, results, i):
    try:
        results[i] = [e["choices"][0]["token"] for e in api_client.stream_completion(
            server.host, server.port, {"prompt": PROMPT, "max_tokens": LONG})]
    except Exception as e:
        results[i] = e


def test_saturation_answers_429_with_retry_after(server, monkeypatch):
    """With the engine thread held before its next step, ``MAX_QUEUE``
    waiting streams fill the queue and the next request bounces with 429
    and ``Retry-After``; released, the held streams finish with the solo
    Engine's tokens."""
    server.wait_idle()
    gate = threading.Event()
    step = server.engine.step
    monkeypatch.setattr(server.engine, "step", lambda: (gate.wait(60), step())[1])
    base = server.gateway.metrics.snapshot()["requests"]["submitted"]
    results = [None] * MAX_QUEUE
    threads = [threading.Thread(target=_hold, args=(server, results, i), daemon=True)
               for i in range(MAX_QUEUE)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 30
    while (time.monotonic() < deadline and
           server.gateway.metrics.snapshot()["requests"]["submitted"] < base + MAX_QUEUE):
        time.sleep(0.002)
    assert server.gateway.queue_depth() == MAX_QUEUE
    with pytest.raises(api_client.RetryLater) as e:
        api_client.completion(server.host, server.port, {"prompt": PROMPT, "max_tokens": 2})
    assert e.value.retry_after >= 1
    assert server.gateway.metrics.snapshot()["requests"]["rejected"] >= 1
    gate.set()
    for th in threads:
        th.join(timeout=120)
    ref = server.ref(PROMPT, LONG)
    assert all(r == ref for r in results)
