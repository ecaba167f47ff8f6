#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA Hopper card and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

  1. build   — compile every CUDA kernel source with nvcc (sm_90a), in parallel;
  2. kernels — hold each kernel against its plain PyTorch version on the card
               at the serving path's shapes and more, on inputs spread to
               e±200 with exact-zero rows and columns, and time both;
  3. serve   — serve goom-rnn-124m at full width (24 layers, d=768, vocab
               50257, seeded random weights, bf16 compute) through
               ``Engine(max_slots=4, page_len=512, chunk=64)``: 6 requests,
               two of which wait for a slot and join mid-batch.  Every
               engine LMME call must have launched the CUDA kernel;
  4. parity  — serve the same requests at f32 compute on the kernel and under
               ``use_backend("torch_reference")``; tokens must agree except
               after a near tie (top-2 margin below 1e-4·std(logits)).

The last lines are a JSON object of per-kernel numbers, the card's name and
power limit (from nvidia-smi), and ``{"ok": true, "device": {...}}``.
TF32 is off for every float32 product (the default, set here explicitly).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s outside the
# tensor cores, which is where the LMME kernel's FMAs and expf run
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

SEED = 0
# the 1-token prompt with a budget of 1 comes last: it and the 333-token
# prompt wait for a slot and join mid-batch
PROMPT_LENS = [63, 64, 65, 200, 333, 1]
BUDGETS = [8, 16, 32, 32, 32, 1]
SERVE = dict(max_slots=4, page_len=512, chunk=64)
DEVICE = "cuda"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel against plain version
# ---------------------------------------------------------------------------
def goom_close(got, want, scale_log, *, atol=1e-4, margin=12.0):
    """The parity test's ``assert_goom_close`` on the card: values over their
    scale (row max, or the entry's own absolute contraction where larger)
    within ``atol``; away from cancellation logs within rtol 1e-4 / atol
    1e-3 and signs equal.  Returns (ok, max normalised value error)."""
    import torch

    m = torch.maximum(want.log_abs.amax(-1, keepdim=True),
                      got.log_abs.amax(-1, keepdim=True))
    m = torch.maximum(m, scale_log)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    gv = got.sign * torch.exp(got.log_abs - m)
    wv = want.sign * torch.exp(want.log_abs - m)
    err = float((gv - wv).abs().max())
    ok = want.log_abs > m - margin
    gl, wl = got.log_abs[ok], want.log_abs[ok]
    logs_ok = bool(((gl - wl).abs() <= 1e-3 + 1e-4 * wl.abs()).all())
    signs_ok = bool((got.sign[ok] == want.sign[ok]).all())
    return err <= atol and logs_ok and signs_ok, err


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    (and memsets or copies) that ``iters`` calls put on the card, from a
    profiler trace.  Host time and the gaps between kernels are left out,
    so a call that launches many small kernels is not timed at the host's
    launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return _device_ms(prof) / iters


def _device_ms(prof, name: str = "") -> float:
    """Summed device time of the profiled events whose name holds ``name``;
    fails when the profiler saw no device work at all."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(events, "the profiler saw no device work; device times not measured")
    return sum(e.time_range.elapsed_us() for e in events if name in e.name) / 1e3


def host_ms(fn, iters: int) -> float:
    """Wall time per call including Python and launch overhead: what a
    caller in an eager loop pays."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def lmme_operands(a_shape, b_shape, gen):
    """e±200 operands: rows of A and columns of B shifted by up to ±200 in
    log space, random signs, one exact-zero row of A and column of B."""
    import torch

    from repro_torch.core.goom import Goom

    def planes(shape, off_shape):
        log = torch.randn(shape, generator=gen, device="cuda")
        log = log + (torch.rand(off_shape, generator=gen, device="cuda") * 400 - 200)
        sign = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5,
                           -1.0, 1.0)
        return log, sign

    al, asn = planes(a_shape, a_shape[:-1] + (1,))
    bl, bsn = planes(b_shape, b_shape[:-2] + (1, b_shape[-1]))
    al[(0,) * (len(a_shape) - 2) + (1,)] = -float("inf")
    bl[(0,) * (len(b_shape) - 2) + (slice(None), 0)] = -float("inf")
    return Goom(al, asn), Goom(bl, bsn)


def lmme_bound(a_shape, b_shape):
    """(bound ms, bound_by): each input plane read once, each output plane
    written once; one exp per input element, 2 flops per multiply-add and
    one log per output element."""
    import math

    import torch

    batch = torch.broadcast_shapes(a_shape[:-2], b_shape[:-2])
    n, d = a_shape[-2:]
    m = b_shape[-1]
    n_out = math.prod(batch) * n * m
    n_in = math.prod(a_shape) + math.prod(b_shape)
    nbytes = 4 * (2 * n_in + 2 * n_out)
    ops = n_in + 2 * math.prod(batch) * n * d * m + n_out
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase():
    import torch

    from repro_torch.core.goom import Goom
    from repro_torch.kernels.lmme import lmme_cuda, lmme_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [  # name, A shape, B shape
        ("decode (H,16,16)x(S*B=4,H,16,1)", (48, 16, 16), (4, 48, 16, 1)),
        ("admit fold (H,16,16)x(1,H,16,1)", (48, 16, 16), (1, 48, 16, 1)),
        ("prefill chunk 64 (H,16,16)x(64,1,H,16,1)", (48, 16, 16), (64, 1, 48, 16, 1)),
        ("A doubling (H,16,16)x(H,16,16)", (48, 16, 16), (48, 16, 16)),
        ("2-D (130,70)x(70,50)", (130, 70), (70, 50)),
        ("d=256 (4,8,256)x(4,256,16)", (4, 8, 256), (4, 256, 16)),
    ]
    rows, max_err = [], 0.0
    for name, sa, sb in cases:
        a, b = lmme_operands(sa, sb, gen)
        got = lmme_cuda(a, b)
        torch.cuda.synchronize()
        want = Goom(*lmme_ref(a.log_abs, a.sign, b.log_abs, b.sign))
        scale = lmme_ref(a.log_abs, torch.ones_like(a.sign),
                         b.log_abs, torch.ones_like(b.sign))[0]
        check(tuple(got.log_abs.shape) == tuple(want.log_abs.shape),
              f"{name}: shape {tuple(got.log_abs.shape)}")
        ok, err = goom_close(got, want, scale)
        check(ok, f"LMME kernel disagrees with its plain version at {name}: "
                  f"max normalised error {err:.3e}")
        max_err = max(max_err, err)
        iters = 200
        k_ms = device_ms(lambda: lmme_cuda(a, b), iters)
        p_ms = device_ms(lambda: lmme_ref(a.log_abs, a.sign, b.log_abs, b.sign), iters)
        k_call = host_ms(lambda: lmme_cuda(a, b), iters)
        bound, bound_by = lmme_bound(sa, sb)
        rows.append(dict(shape=name, ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                         bound_ms=bound, bound_by=bound_by, max_abs_err=err))
        print(f"lmme {name}: kernel {k_ms:.4f} ms (per call incl. host "
              f"{k_call:.4f} ms), plain {p_ms:.4f} ms, bound {bound:.6f} ms "
              f"({bound_by}), max normalised error {err:.2e}", flush=True)

    # backward: autograd of the plain version, reached through the kernel
    a, b = lmme_operands((48, 16, 16), (8, 48, 16, 1), gen)
    grads = []
    for fn in (lmme_cuda, lambda x, y: Goom(*lmme_ref(x.log_abs, x.sign,
                                                      y.log_abs, y.sign))):
        al = a.log_abs.clone().requires_grad_()
        bl = b.log_abs.clone().requires_grad_()
        out = fn(Goom(al, a.sign), Goom(bl, b.sign)).log_abs
        torch.where(torch.isfinite(out), out, torch.zeros_like(out)).sum().backward()
        grads.append((al.grad, bl.grad))
    for g_k, g_p in zip(*grads):
        check(torch.equal(torch.nan_to_num(g_k), torch.nan_to_num(g_p)),
              "LMME backward through the kernel differs from the plain one")
    print("lmme backward: gradients equal to the plain version's", flush=True)
    return rows, max_err


# ---------------------------------------------------------------------------
# phases 3 and 4: serving
# ---------------------------------------------------------------------------
def requests(vocab, eos=None):
    """The 6 requests; ``eos=(uid, token)`` gives request ``uid`` an EOS."""
    import numpy as np

    from repro_torch import Request

    rng = np.random.default_rng(SEED)
    return [Request(uid=i, prompt=rng.integers(0, vocab, size=p).tolist(),
                    max_new_tokens=n,
                    eos_id=eos[1] if eos and eos[0] == i else None)
            for i, (p, n) in enumerate(zip(PROMPT_LENS, BUDGETS))]


def pick_eos(outputs):
    """(uid, token) such that the request generates ``token`` for the first
    time at its third token or later: with it as EOS, the request stops
    mid-decode."""
    for uid in sorted(outputs):
        out = outputs[uid]
        for i in range(2, len(out)):
            if out[i] not in out[:i]:
                return uid, out[i]
    raise RuntimeError("no request generated a fresh token to stop at")


def serve(model, reqs, timed=False):
    """Run ``reqs`` through a fresh Engine; returns (results, finish
    reasons, stats).  All requests arrive at once; with 4 slots the last
    ones wait and join mid-batch."""
    import torch

    from repro_torch import Engine

    eng = Engine(model, **SERVE)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, decode_ms, results, reasons = {}, [], {}, {}
    joined_late, n_steps = 0, 0
    while eng.has_work:
        admitted_before = len(reqs) - eng.n_waiting
        t_step = time.perf_counter()
        done = eng.step()
        n_steps += 1
        if timed:
            torch.cuda.synchronize()
        now = time.perf_counter()
        admitted = len(reqs) - eng.n_waiting
        if n_steps > 1:
            joined_late += admitted - admitted_before
        for r in reqs[:admitted]:
            ttft.setdefault(r.uid, now - t0)
        if admitted == admitted_before and eng.n_decode_steps:
            decode_ms.append((now - t_step) * 1e3)
        for uid in done:
            results[uid] = eng.result(uid)
            reasons[uid] = eng.finish_reason(uid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    stats = dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                 ttft_ms={u: 1e3 * s for u, s in ttft.items()},
                 decode_step_ms=statistics.median(decode_ms) if decode_ms else None,
                 decode_steps=eng.n_decode_steps, joined_late=joined_late)
    return results, reasons, stats


def check_finished(reqs, results, reasons):
    for r in reqs:
        out = results.get(r.uid)
        check(out is not None, f"request {r.uid} never finished")
        if reasons[r.uid] == "stop":
            check(r.eos_id is not None and out[-1] == r.eos_id
                  and len(out) <= r.max_new_tokens, f"request {r.uid}: bad stop")
        else:
            check(reasons[r.uid] == "length" and len(out) == r.max_new_tokens,
                  f"request {r.uid}: {len(out)} tokens of {r.max_new_tokens}")


def serve_phase(cfg):
    import torch

    from repro_torch import DecoderLM
    from repro_torch.core import engine
    from repro_torch.kernels.lmme import lmme_cuda

    t0 = time.perf_counter()
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"vocab={cfg.vocab}, {n_params / 1e6:.1f}M params, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # warm-up pass (allocator, cuBLAS); it also picks the EOS token, one a
    # request first generates mid-decode
    warm, _, _ = serve(model, requests(cfg.vocab))
    eos = pick_eos(warm)
    reqs = requests(cfg.vocab, eos=eos)

    engine.reset_calls()
    lmme_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    results, reasons, stats = serve(model, reqs, timed=True)
    launches, calls = lmme_cuda.launches, engine.calls["lmme"]
    peak = torch.cuda.max_memory_allocated()
    check(calls > 0 and launches == calls,
          f"LMME kernel launches {launches} != engine lmme calls {calls}")
    check_finished(reqs, results, reasons)
    check(stats["joined_late"] >= 2, f"only {stats['joined_late']} requests "
          "waited for a slot and joined mid-batch")
    check(reasons[eos[0]] == "stop" and results[eos[0]] == warm[eos[0]][
        :len(results[eos[0]])], f"request {eos[0]} did not stop at EOS {eos[1]}")
    check(all(0 <= t < cfg.vocab for v in results.values() for t in v),
          "token id out of vocabulary")

    # what one decode step and one prefill chunk cost in launches, and a
    # look at the logits themselves
    engine.reset_calls()
    before = lmme_cuda.launches
    with torch.no_grad():
        logits, _ = model.decode_step(torch.zeros(4, 1, dtype=torch.long, device=DEVICE),
                                      model.init_caches(4))
        per_decode = lmme_cuda.launches - before
        before = lmme_cuda.launches
        tok = torch.tensor([max((r.prompt for r in reqs), key=len)[:64]],
                           device=DEVICE)
        chunk_logits, _ = model.prefill(tok, model.init_caches(1))
        per_chunk = lmme_cuda.launches - before
    check(tuple(logits.shape) == (4, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(chunk_logits).all()), "non-finite or misshapen logits")

    ttft = stats["ttft_ms"]
    print(f"serve: {stats['tokens']} tokens in {stats['wall_s']:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s; TTFT ms by request "
          + ", ".join(f"{u}:{ttft[u]:.1f}" for u in sorted(ttft))
          + f"; decode step {stats['decode_step_ms']:.2f} ms (median, 4 slots); "
          f"{stats['decode_steps']} decode steps; {stats['joined_late']} "
          f"requests joined mid-batch; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"serve: finish reasons {reasons}; LMME launches {launches} == engine "
          f"calls {calls}; per decode step {per_decode}, per 64-token prefill "
          f"chunk {per_chunk}", flush=True)
    return model, reqs, dict(stats, launches=launches, peak_bytes=peak,
                             per_decode=per_decode, per_chunk=per_chunk)


def trace_phase(model):
    """A profiler trace of steady decode steps over 4 busy slots: device
    busy ms per step, the LMME kernel's part of it, kernels per step, and
    the card's idle share against the step's unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch import Engine, Request

    n_steps = 8
    eng = Engine(model, **SERVE)
    for i in range(SERVE["max_slots"]):
        eng.submit(Request(uid=i, prompt=[i + 1], max_new_tokens=3 * n_steps + 4))
    for _ in range(4):  # admission, then warm decode steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    n_dev = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    busy = _device_ms(prof) / n_steps
    lmme = _device_ms(prof, "lmme") / n_steps
    print(f"trace: decode step (4 slots) {step_ms:.3f} ms wall, device busy "
          f"{busy:.3f} ms in {n_dev / n_steps:.0f} kernels, of which "
          f"LMME {lmme:.3f} ms; device idle share {1 - busy / step_ms:.3f}",
          flush=True)


def parity_phase(model, cfg, reqs):
    """f32 serving on the kernel vs under the plain version: tokens equal up
    to the first near tie of the reference's logits."""
    import torch

    from repro_torch import DecoderLM
    from repro_torch.core import engine

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    m32 = DecoderLM(cfg32, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    m32.load_state_dict(model.state_dict())
    got, _, _ = serve(m32, reqs)
    seq = torch.tensor([max((list(r.prompt) for r in reqs), key=len)],
                       device=DEVICE)
    with torch.no_grad():
        lg_kernel, _ = m32.prefill(seq, m32.init_caches(1))
        with engine.use_backend("torch_reference"):
            lg_plain, _ = m32.prefill(seq, m32.init_caches(1))
    print(f"parity (f32): prefill logits of a {seq.shape[1]}-token prompt, "
          f"kernel vs plain: max |diff| "
          f"{float((lg_kernel - lg_plain).abs().max()):.3e}, std "
          f"{float(lg_plain.std()):.3e}", flush=True)
    with engine.use_backend("torch_reference"):
        want, _, _ = serve(m32, reqs)
        compared, stopped = 0, []
        for r in reqs:
            g, w = got[r.uid], want[r.uid]
            for i, (x, y) in enumerate(zip(g, w)):
                if x != y:
                    with torch.no_grad():
                        seq = torch.tensor([list(r.prompt) + w[:i]], device=DEVICE)
                        lg, _ = m32.prefill(seq, m32.init_caches(1))
                    lg = lg[0, -1].float()
                    top2 = torch.topk(lg, 2).values
                    margin = float(top2[0] - top2[1])
                    check(margin < 1e-4 * float(lg.std()),
                          f"request {r.uid} token {i}: kernel {x} vs plain {y} "
                          f"at margin {margin:.3e}")
                    stopped.append((r.uid, i))
                    break
                compared += 1
            else:
                check(len(g) == len(w), f"request {r.uid}: lengths {len(g)} != {len(w)}")
    print(f"parity (f32): {compared} tokens compared equal; stopped at near "
          f"ties {stopped or 'none'}", flush=True)
    return compared


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    from repro_torch import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs().items():
        print(f"build {name}: {(log or 'loaded from an earlier build').strip()}",
              flush=True)

    rows, max_err = kernel_phase()
    cfg = get_config("goom-rnn-124m")
    model, reqs, stats = serve_phase(cfg)
    trace_phase(model)
    parity_phase(model, cfg, reqs)

    # the decode step's shape: the one the serving path launches most
    main_row = next(r for r in rows if r["shape"].startswith("decode"))
    print(json.dumps({"kernels": [{
        "name": "lmme",
        "route": "cuda",
        "source": "src/repro_torch/kernels/lmme/csrc/lmme.cu",
        "replaces": "src/repro/kernels/lmme/lmme.py:36",
        "launches": stats["launches"],
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
