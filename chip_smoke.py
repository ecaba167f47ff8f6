#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--kernels]

from the root of a checkout, on a machine with an NVIDIA Hopper card and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

  1. build    — compile every CUDA kernel source with nvcc (sm_90a), in
                parallel;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card, and time both: the LMME kernel on e±200 inputs with
                exact-zero rows and columns, at the serving path's shapes,
                the chains' square d = 8, 32, 128 and the spectrum's reset
                products; the matrix scan with B (one kernel a call, timed
                also by CUDA events, and at the 64-token chunk also as the
                one-chunk walk) at the generic layer's shapes, a
                time-varying A, d = 128, on e±200 and odd signed shapes, and
                its zero-B form from X_0 = I (three passes, 4–5 kernels a
                call, timed as their sum and by CUDA events) on the chains'
                and the LLE's lengths, each also against float64; the
                diagonal-scan kernel at Mamba's decode, prefill-chunk and
                tail shapes, on e±200 signed inputs with exact zeros and
                cancellations, T=1, odd C and the autotune shape (4096,
                512), each also against float64, with its backward;
  3. serve    — serve goom-rnn-124m at full width (24 layers, d=768, vocab
                50257, seeded random weights, bf16 compute) through
                ``Engine(max_slots=4, page_len=512, chunk=64)``: 6 requests,
                two of which wait for a slot and join mid-batch.  Every
                engine LMME and matrix-scan call must have launched its CUDA
                kernel.  Once with ``scan_variant="shared_a"`` (every GOOM op
                an LMME) and once with the paper-literal ``"generic"`` (B·u on
                the LMME kernel, the recurrence one matrix-scan launch per
                layer), each with a profiler trace of steady decode steps;
  4. parity   — serve the same requests at f32 compute on the kernels and
                under ``use_backend("torch_reference")``; tokens must agree
                except after a near tie (top-2 margin below 1e-4·std(logits)).
                For ``generic`` also the prefill-logit gap to ``shared_a`` on
                the same weights;
  5. experiments — the paper's experiments 1 and 2 on the card: float
                chains fail, GOOM chains complete, the parallel chain (zero-B
                kernel) equals a loop of LMME launches; Lyapunov spectra and
                LLE of the four in-repo systems at 4096 steps, parallel
                against sequential and λ1 against the literature;
  6. jamba    — serve jamba-v0.1 at full width (d=4096, vocab 65536, GQA
                32/8 heads, 16-expert top-2 MoE) cut to two of its four
                8-layer periods (16 layers, 26.1B parameters, 52 GB in bf16:
                the most whole periods one 80 GB card holds), seeded random
                bf16 weights built on the card, bf16 compute, f32 recurrent
                state, through the same Engine and requests.  Every engine
                diagonal_scan call must have launched the diagonal-scan
                kernel, and no other GOOM op may run; a profiler trace of
                steady decode steps; then the parity check of phase 4 at f32
                compute on the same weights.

``--kernels`` runs phases 1 and 2 without the diagonal scan and stops: the
loop for kernel work (``tools/kernels_ab.sh`` runs it on two checkouts in
turns).

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
# jamba-v0.1 is cut to this many of its four 8-layer periods (depth only)
JAMBA_PERIODS = 2


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


def _profile(fn, iters: int):
    """A profiler trace of ``iters`` calls of ``fn`` after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return prof


def device_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    (and memsets or copies) that ``iters`` calls put on the card, from a
    profiler trace.  Host time and the gaps between kernels are left out,
    so a call that launches many small kernels is not timed at the host's
    launch rate."""
    return _device_ms(_profile(fn, iters)) / iters


def event_ms(fn, iters: int) -> float:
    """Per-call time between CUDA events around ``iters`` calls.  Right for
    a call of one long kernel, where the launches queue up ahead of the
    device; a call of many tiny kernels would time the host's launch rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(fn, iters: int, kernel: str):
    """(ms, kernels, how) per call of ``fn``: the sum, over the kernels of
    distinct names holding ``kernel`` in a profiler trace of ``iters`` calls,
    of each one's mean device duration, and the number of such kernels.  The
    profiler has been seen to drop launch records on an H100 (it kept 46 of
    50 short ones, and none of 3 that ran 70 ms), so each mean is over the
    launches it kept; the gaps between a call's kernels are left out
    (``event_ms`` counts them).  CUDA events time the call when the profiler
    kept no record at all, and the kernel count is then not measured."""
    from torch.autograd import DeviceType

    parts = {}
    for e in _profile(fn, iters).events():
        if e.device_type == DeviceType.CUDA and kernel in e.name:
            parts.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    if not parts:
        return event_ms(fn, iters), None, f"events; the profiler kept none of {iters} calls"
    means = {k: sum(v) / len(v) for k, v in parts.items()}
    kept = sum(len(v) for v in parts.values())
    split = ", ".join(f"{_short(k)} {v:.4f}" for k, v in means.items())
    how = f"profiler, {kept} launches over {iters} calls"
    if len(means) > 1:
        how = f"sum of {len(means)} kernels' mean ({how}): {split}"
    return sum(means.values()), len(means), how


def _short(name: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0]


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
        ("chain square d=8 (8,8)x(8,8)", (8, 8), (8, 8)),
        ("chain square d=32 (32,32)x(32,32)", (32, 32), (32, 32)),
        ("chain square d=128 (128,128)x(128,128)", (128, 128), (128, 128)),
        ("spectrum reset (128,3,3)x(128,3,3)", (128, 3, 3), (128, 3, 3)),
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
        k_ms, per_call, _ = call_ms(lambda: lmme_cuda(a, b), iters, "lmme")
        p_ms = device_ms(lambda: lmme_ref(a.log_abs, a.sign, b.log_abs, b.sign), iters)
        k_call = host_ms(lambda: lmme_cuda(a, b), iters)
        bound, bound_by = lmme_bound(sa, sb)
        rows.append(dict(shape=name, ms=k_ms, plain_ms=p_ms, call_ms=k_call,
                         bound_ms=bound, bound_by=bound_by, max_abs_err=err,
                         kernels_per_call=per_call))
        print(f"lmme {name}: kernel {k_ms:.4f} ms ({per_call} kernel a call; "
              f"per call incl. host {k_call:.4f} ms), plain {p_ms:.4f} ms, bound "
              f"{bound:.6f} ms ({bound_by}), max normalised error {err:.2e}",
              flush=True)

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


# name, T, batch, d, m, kind: the generic layer's decode and 64-token chunk
# (48 heads of 16; A time-invariant, passed as a stride-0 view), a
# time-varying A over 256 steps at the layer's widths, the block kernel's d =
# 128, the JAX tests' e±200 and odd signed shapes
SCAN_CASES = [
    ("decode (G=48,T=1,d=16,m=4)", 1, (48,), 16, 4, "shared_a"),
    ("64-token chunk (G=48,T=64,d=16,m=1)", 64, (48,), 16, 1, "shared_a"),
    ("time-varying A (G=48,T=256,d=16,m=4)", 256, (48,), 16, 4, "signed"),
    ("d=128 (T=33,d=128,m=3)", 33, (), 128, 3, "signed"),
    ("positive e±200 (T=150,d=4,m=1)", 150, (), 4, 1, "positive"),
    ("signed (T=13,d=4,m=1)", 13, (), 4, 1, "signed"),
    ("signed (T=9,G=2,d=5,m=3)", 9, (2,), 5, 3, "signed"),
    ("signed (T=16,G=2x2,d=3,m=1)", 16, (2, 2), 3, 1, "signed"),
    ("signed (T=5,d=8,m=8)", 5, (), 8, 8, "signed"),
    ("signed e±200 (T=17,d=4,m=2)", 17, (), 4, 2, "e200_signed"),
]
# zero-B from X_0 = I (cumulative_lmme): the quickstart's chain, the d=128
# chain of fig. 1 (2000 steps after S_0), the LLE's 4096 steps after u_0
ZERO_B_CASES = [
    ("zero-B (1000,16,16)", 1000, 16, 20),
    ("zero-B d=128 chain (2001,128,128)", 2001, 128, 3),
    ("zero-B LLE (4097,3,3)", 4097, 3, 5),
]


def _goom(x):
    import torch

    from repro_torch.core.goom import Goom

    return Goom(torch.log(x.abs()), torch.where(x >= 0, 1.0, -1.0).to(x.dtype))


def _as(g, dtype=None, positive=False):
    """``g`` in ``dtype`` (None keeps it), with all signs +1 if ``positive``."""
    import torch

    from repro_torch.core.goom import Goom

    if g is None:
        return None
    log = g.log_abs if dtype is None else g.log_abs.to(dtype)
    sign = g.sign if dtype is None else g.sign.to(dtype)
    return Goom(log, torch.ones_like(sign) if positive else sign)


def goom_dist(x, exact, scale_log) -> float:
    """max |x - exact| over each entry's scale, in float64."""
    import torch

    sc = scale_log.double()
    sc = torch.where(torch.isfinite(sc), sc, torch.zeros_like(sc))
    xv = x.sign.double() * torch.exp(x.log_abs.double() - sc)
    ev = exact.sign.double() * torch.exp(exact.log_abs.double() - sc)
    return float((xv - ev).abs().max())


def scan_operands(t, batch, d, m, kind, gen):
    """(a, b, x0) on the card; ``shared_a`` gives a near-identity A that is a
    stride-0 view over time, as the generic layer passes it."""
    import torch

    from repro_torch.core.goom import Goom

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    if kind == "shared_a":
        a = _goom(0.9 * torch.eye(d, device=DEVICE) + 0.3 * normal(*batch, d, d) / d ** 0.5)
        a = Goom(a.log_abs.expand((t,) + a.shape), a.sign.expand((t,) + a.shape))
        return a, _goom(normal(t, *batch, d, m)), _goom(normal(*batch, d, m))
    if kind == "positive":
        return (_goom(normal(t, *batch, d, d).abs() * 4.0),
                _goom(normal(t, *batch, d, m).abs()), None)
    k = 1.0 if kind == "e200_signed" else 0.6
    a = _goom(normal(t, *batch, d, d) * k)
    if kind == "e200_signed":
        shift = 200.0 * torch.where(torch.rand(t, 1, 1, generator=gen, device=DEVICE) < 0.5,
                                    -1.0, 1.0)
        a = Goom(a.log_abs + shift, a.sign)
    return a, _goom(normal(t, *batch, d, m) * k), _goom(normal(*batch, d, m))


def scan_bound(t, g, d, m, *, has_b, a_fixed):
    """(bound ms, bound_by): each input plane read once (a stride-0 A once
    per g), each output plane written once; exps of A and of the carry, 2
    flops per multiply-add, a log per output, and 2 exps and a log more per
    output for the LSE with B."""
    a_reads = (1 if a_fixed else t) * g * d * d
    outs = t * g * d * m
    n_in = a_reads + (outs if has_b else 0) + g * d * m
    nbytes = 4 * 2 * (n_in + outs)
    ops = a_reads + outs + 2 * t * g * d * d * m + outs + (3 * outs if has_b else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scan_kernel_phase():
    """The matrix-scan kernels (with B and zero-B) against their plain
    versions.  The kernels walk time in order (the zero-B one chunk by chunk)
    and the plain version brackets as a tree, so besides the f32 comparison
    each is held to the float64 plain version:
    the kernel's distance to it must be at most twice the f32 plain
    version's (floor 1e-6)."""
    import math

    import torch

    from repro_torch.core.chains import goom_log_norm
    from repro_torch.core.goom import Goom
    from repro_torch.kernels.goom_scan import (
        matrix_scan_cuda,
        matrix_scan_ref,
        matrix_scan_zero_b_ref,
    )
    from repro_torch.kernels.goom_scan import ops as scan_ops

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows, errs = {}, {"matrix_scan": 0.0, "matrix_scan_zero_b": 0.0}
    f64 = torch.float64
    for name, t, batch, d, m, kind in SCAN_CASES:
        a, b, x0 = scan_operands(t, batch, d, m, kind, gen)
        copies = matrix_scan_cuda.copies
        got = matrix_scan_cuda(a, b, x0)
        torch.cuda.synchronize()
        check(matrix_scan_cuda.copies == copies, f"{name}: an operand was copied")
        plain = matrix_scan_ref(a, b, x0)
        exact = matrix_scan_ref(_as(a, f64), _as(b, f64), _as(x0, f64))
        scale = matrix_scan_ref(_as(a, f64, True), _as(b, f64, True),
                                _as(x0, f64, True)).log_abs
        check(tuple(got.shape) == tuple(plain.shape)
              and not bool(torch.isnan(got.log_abs).any()), f"{name}: bad output")
        d_k, d_p = goom_dist(got, exact, scale), goom_dist(plain, exact, scale)
        check(d_k <= 2.0 * d_p + 1e-6, f"matrix-scan kernel at {name}: distance "
              f"to float64 {d_k:.3e} > twice the plain version's {d_p:.3e}")
        err = goom_dist(got, plain, scale)
        if kind == "positive":
            w = plain.log_abs
            rel = float(((got.log_abs - w).abs() / w.abs().clamp_min(1.0)).max())
            check(float(w.abs().max()) > 200.0 and rel <= 1e-4,
                  f"{name}: relative log error {rel:.3e} > 1e-4")
        elif kind != "e200_signed":
            ok, _ = goom_close(got, plain, scale.float(), margin=8.0)
            check(ok, f"matrix-scan kernel disagrees with its plain version at {name}")
        errs["matrix_scan"] = max(errs["matrix_scan"], err)
        g = math.prod(batch)
        iters = 50 if t <= 64 else 10
        k_ms, per_call, k_how = call_ms(lambda: matrix_scan_cuda(a, b, x0), iters,
                                        "matrix_scan")
        k_ev = event_ms(lambda: matrix_scan_cuda(a, b, x0), iters)
        p_ms = device_ms(lambda: matrix_scan_ref(a, b, x0), iters)
        bound, bound_by = scan_bound(t, g, d, m, has_b=True, a_fixed=kind == "shared_a")
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                          max_abs_err=err, kernels_per_call=per_call, event_ms=k_ev,
                          dist=d_k, plain_dist=d_p)
        print(f"matrix_scan {name}: kernel {k_ms:.4f} ms ({k_how}), by CUDA events "
              f"{k_ev:.4f} ms a call; plain {p_ms:.4f} ms, "
              f"bound {bound:.6f} ms ({bound_by}); error vs plain {err:.2e}; "
              f"distance to float64: kernel {d_k:.2e}, plain {d_p:.2e}", flush=True)
        if kind == "shared_a" and t > 1 and hasattr(scan_ops, "with_b_chunk_len"):
            # the design the chunked time axis is measured against: the same
            # kernel walking all T steps in one chunk (a checkout from before
            # the chunked axis, tools/kernels_ab.sh's base, has only the walk)
            def walk():
                return Goom(*scan_ops._launch(a.log_abs, a.sign, b.log_abs, b.sign,
                                              x0.log_abs, x0.sign, ell=t))
            w_got = walk()
            d_w = goom_dist(w_got, exact, scale)
            check(d_w <= 2.0 * d_p + 1e-6, f"walk design at {name}: distance to "
                  f"float64 {d_w:.3e} > twice the plain version's {d_p:.3e}")
            w_ms, _, w_how = call_ms(walk, iters, "matrix_scan")
            w_ev = event_ms(walk, iters)
            rows[name].update(walk_ms=w_ms, walk_event_ms=w_ev)
            print(f"matrix_scan {name}, walk design (L = T = {t}; chunked L = "
                  f"{scan_ops.with_b_chunk_len(t, d)}): kernel {w_ms:.4f} ms ({w_how}), "
                  f"by CUDA events {w_ev:.4f} ms a call; distance to float64 "
                  f"{d_w:.2e}", flush=True)

    for name, t, d, iters in ZERO_B_CASES:
        a = _goom(torch.randn(t, d, d, generator=gen, device=DEVICE))
        eye = torch.eye(d, dtype=torch.bool, device=DEVICE)
        x0 = Goom(torch.zeros(d, d, device=DEVICE).masked_fill(~eye, -math.inf),
                  torch.ones(d, d, device=DEVICE))
        got = matrix_scan_cuda(a, None, x0)
        torch.cuda.synchronize()
        plain = matrix_scan_zero_b_ref(a, x0)
        exact = matrix_scan_zero_b_ref(_as(a, f64), _as(x0, f64))
        # long products turn rank-1: values over each matrix's largest entry
        scale = exact.log_abs.amax((-2, -1), keepdim=True).expand_as(exact.log_abs)
        check(tuple(got.shape) == (t, d, d) and bool(torch.isfinite(got.log_abs).all()),
              f"{name}: non-finite or misshapen output")
        d_k, d_p = goom_dist(got, exact, scale), goom_dist(plain, exact, scale)
        check(d_k <= 2.0 * d_p + 1e-6, f"zero-B kernel at {name}: distance to "
              f"float64 {d_k:.3e} > twice the plain version's {d_p:.3e}")
        fro_k, fro_x = float(goom_log_norm(got[-1])), float(goom_log_norm(exact[-1]))
        check(abs(fro_k - fro_x) <= 1e-5 * abs(fro_x), f"{name}: final log "
              f"Frobenius norm {fro_k} vs float64 {fro_x}")
        err = goom_dist(got, plain, scale)
        errs["matrix_scan_zero_b"] = max(errs["matrix_scan_zero_b"], err)
        k_ms, per_call, k_how = call_ms(lambda: matrix_scan_cuda(a, None, x0), iters,
                                        "matrix_scan")
        k_ev = event_ms(lambda: matrix_scan_cuda(a, None, x0), iters)
        p_ms = device_ms(lambda: matrix_scan_zero_b_ref(a, x0), iters)
        bound, bound_by = scan_bound(t, 1, d, d, has_b=False, a_fixed=False)
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                          max_abs_err=err, kernels_per_call=per_call, event_ms=k_ev,
                          dist=d_k, plain_dist=d_p)
        print(f"matrix_scan {name}: kernel {k_ms:.4f} ms ({k_how}), by CUDA events "
              f"{k_ev:.4f} ms a call; plain {p_ms:.4f} ms, "
              f"bound {bound:.6f} ms ({bound_by}); error vs plain {err:.2e}; "
              f"distance to float64: kernel {d_k:.2e}, plain {d_p:.2e}; final "
              f"log Frobenius norm {fro_k:.4f} (float64 {fro_x:.4f})", flush=True)

    # backward: autograd of the plain version, reached through the kernel
    a, b, x0 = scan_operands(9, (2,), 5, 3, "signed", gen)
    for with_b in (True, False):
        grads = []
        for fn in (matrix_scan_cuda, None):
            al, bl, xl = (x.log_abs.clone().requires_grad_() for x in (a, b, x0))
            ga, gb, gx = Goom(al, a.sign), Goom(bl, b.sign) if with_b else None, Goom(xl, x0.sign)
            if fn is not None:
                out = fn(ga, gb, gx)
            else:
                out = matrix_scan_ref(ga, gb, gx) if with_b else matrix_scan_zero_b_ref(ga, gx)
            out.log_abs.sum().backward()
            grads.append((al.grad, bl.grad, xl.grad))
        for g_k, g_p in zip(*grads):
            check((g_k is None and g_p is None) or torch.equal(g_k, g_p),
                  "matrix-scan backward through the kernel differs from the plain one")
    print("matrix_scan backward (with B and zero-B): gradients equal to the "
          "plain version's", flush=True)
    return rows, errs


# name, T, trailing shape, kind: Mamba's decode step over 4 slots, its
# 64-token prefill chunk and a batch-1 tail token (d_inner=8192, d_state=16),
# signed e±200 inputs with exact zeros and cancellations, T=1, odd C, and
# the JAX package's autotune shape (4096, 512)
DIAG_CASES = [
    ("decode (T=1, C=4x8192x16)", 1, (4, 8192, 16), "mamba"),
    ("64-token chunk (T=64, C=8192x16)", 64, (1, 8192, 16), "mamba"),
    ("tail token (T=1, C=8192x16)", 1, (1, 8192, 16), "mamba"),
    ("signed e±200, zeros, cancellations (T=64, C=4x33)", 64, (4, 33), "e200"),
    ("signed e±200 T=1 (C=1000)", 1, (1000,), "e200"),
    ("signed e±200 odd C (T=37, C=3x7x5)", 37, (3, 7, 5), "e200"),
    ("autotune shape (T=4096, C=512)", 4096, (512,), "mamba"),
]
N_CANCEL = 8   # channels of an e200 case whose first state cancels exactly


def diag_operands(t, trail, kind, gen):
    """(a, b, x0) on the card.  ``mamba``: decays log a = Δ·A with Δ in
    [1e-3, 0.1] and A in -[1, 16], sign +1, and inputs Δ·x·B, as Mamba's
    segment_states makes them.  ``e200``: signed decays, inputs shifted by up
    to e±200, a tenth of them exact zeros, and the first ``N_CANCEL``
    channels cancelling exactly at t=0 (a_0 = 1, x0 = 1, b_0 = -1)."""
    import torch

    from repro_torch.core.goom import Goom

    shape = (t,) + tuple(trail)

    def rand(*sh):
        return torch.rand(sh, generator=gen, device=DEVICE)

    def normal(*sh):
        return torch.randn(sh, generator=gen, device=DEVICE)

    if kind == "mamba":
        dt = 1e-3 + 0.099 * rand(*shape)
        a = Goom(-dt * (1.0 + torch.floor(16 * rand(*shape))), torch.ones(shape, device=DEVICE))
        return a, _goom(dt * normal(*shape)), _goom(normal(*trail))
    a = _goom(1.5 * normal(*shape))
    b = _goom(normal(*shape))
    zero = rand(*shape) < 0.1
    b = Goom((b.log_abs + 400 * rand(*shape) - 200).masked_fill(zero, -float("inf")),
             b.sign.masked_fill(zero, 1.0))
    x0 = _goom(normal(*trail))
    k = min(N_CANCEL, x0.log_abs.numel())
    for g, (log, sign) in ((a, (0.0, 1.0)), (b, (0.0, -1.0))):
        g.log_abs[0].view(-1)[:k], g.sign[0].view(-1)[:k] = log, sign
    x0.log_abs.view(-1)[:k], x0.sign.view(-1)[:k] = 0.0, 1.0
    return a, b, x0


def diag_bound(t, c):
    """(bound ms, bound_by): a and b read once (log and sign, 16 B), the
    states written once (8 B) per element, x0 read once (8 B) per channel;
    some ten f32 operations per element (two exps, a log, adds, a max)."""
    nbytes = 24 * t * c + 8 * c
    ops = 10 * t * c
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def diag_kernel_phase():
    """The diagonal-scan kernel against its plain version on the card, and
    both against float64: the kernel walks time in order and the plain
    version brackets as a tree, so the kernel's distance to the float64
    plain version must be at most twice the f32 plain version's (floor
    1e-6)."""
    import math

    import torch

    from repro_torch.core.goom import Goom
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda, goom_diag_scan_ref

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows, max_err = {}, 0.0
    f64 = torch.float64
    for name, t, trail, kind in DIAG_CASES:
        a, b, x0 = diag_operands(t, trail, kind, gen)
        copies = diagonal_scan_cuda.copies
        got = diagonal_scan_cuda(a, b, x0)
        torch.cuda.synchronize()
        check(diagonal_scan_cuda.copies == copies, f"{name}: an operand was copied")
        plain = goom_diag_scan_ref(a, b, x0)
        exact = goom_diag_scan_ref(_as(a, f64), _as(b, f64), _as(x0, f64))
        scale = goom_diag_scan_ref(_as(a, f64, True), _as(b, f64, True),
                                   _as(x0, f64, True)).log_abs
        check(tuple(got.shape) == tuple(plain.shape)
              and not bool(torch.isnan(got.log_abs).any()), f"{name}: bad output")
        d_k, d_p = goom_dist(got, exact, scale), goom_dist(plain, exact, scale)
        check(d_k <= 2.0 * d_p + 1e-6, f"diagonal-scan kernel at {name}: distance "
              f"to float64 {d_k:.3e} > twice the plain version's {d_p:.3e}")
        ok, _ = goom_close(got, plain, scale.float(), margin=8.0)
        check(ok, f"diagonal-scan kernel disagrees with its plain version at {name}")
        if kind == "e200":
            k = min(N_CANCEL, x0.log_abs.numel())
            for out in (got, plain):
                check(bool((out.log_abs[0].reshape(-1)[:k] == -math.inf).all())
                      and bool((out.sign[0].reshape(-1)[:k] == 1.0).all()),
                      f"{name}: an exact cancellation is not (-inf, +1)")
        err = goom_dist(got, plain, scale)
        max_err = max(max_err, err)
        c = math.prod(trail)
        iters = 50 if t <= 64 else 10
        k_ms, _, k_how = call_ms(lambda: diagonal_scan_cuda(a, b, x0), iters, "diag_scan")
        p_ms = device_ms(lambda: goom_diag_scan_ref(a, b, x0), iters)
        bound, bound_by = diag_bound(t, c)
        rows[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                          max_abs_err=err)
        print(f"diag_scan {name}: kernel {k_ms:.4f} ms ({k_how}), plain "
              f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}), "
              f"{bound / k_ms:.2f} of the bound; error vs plain {err:.2e}; "
              f"distance to float64: kernel {d_k:.2e}, plain {d_p:.2e}", flush=True)

    # backward: autograd of the plain version, reached through the kernel
    a, b, x0 = diag_operands(9, (2, 5), "mamba", gen)
    grads = []
    for fn in (diagonal_scan_cuda, goom_diag_scan_ref):
        logs = [g.log_abs.clone().requires_grad_() for g in (a, b, x0)]
        fn(Goom(logs[0], a.sign), Goom(logs[1], b.sign), Goom(logs[2], x0.sign)
           ).log_abs.sum().backward()
        grads.append([x.grad for x in logs])
    for g_k, g_p in zip(*grads):
        check(torch.equal(g_k, g_p),
              "diagonal-scan backward through the kernel differs from the plain one")
    print("diag_scan backward: gradients equal to the plain version's", flush=True)
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


def with_scan_variant(cfg, variant: str):
    """``cfg`` with every goom layer's ``scan_variant`` set to ``variant``
    (the package names no config for ``generic``)."""
    def block(b):
        return dataclasses.replace(b, goom=dataclasses.replace(b.goom, scan_variant=variant))

    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, period=tuple(block(b) for b in g.period))
        for g in cfg.groups))


def reset_counts():
    """Every kernel's launch count and every engine call count to 0."""
    from repro_torch.core import engine
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda, matrix_scan_cuda
    from repro_torch.kernels.lmme import lmme_cuda

    engine.reset_calls()
    lmme_cuda.launches = 0
    lmme_cuda.launches_batched = 0
    matrix_scan_cuda.launches = 0
    matrix_scan_cuda.launches_zero_b = 0
    matrix_scan_cuda.kernels_zero_b = 0
    diagonal_scan_cuda.launches = 0


def read_counts():
    """(launches by kernel, engine calls by op) since ``reset_counts``."""
    from repro_torch.core import engine
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda, matrix_scan_cuda
    from repro_torch.kernels.lmme import lmme_cuda

    return ({"lmme": lmme_cuda.launches, "matrix_scan": matrix_scan_cuda.launches,
             "matrix_scan_zero_b": matrix_scan_cuda.launches_zero_b,
             "diag_scan": diagonal_scan_cuda.launches}, dict(engine.calls))


def check_launches(launches, calls, path, used):
    """Every engine call of the path reached its kernel, and each kernel in
    ``used`` launched at least once; the others not at all."""
    for kernel, op in (("lmme", "lmme"), ("matrix_scan", "matrix_scan"),
                       ("matrix_scan_zero_b", "cumulative_lmme"),
                       ("diag_scan", "diagonal_scan")):
        check(launches[kernel] == calls[op], f"{path}: {kernel} launches "
              f"{launches[kernel]} != engine {op} calls {calls[op]}")
        check((launches[kernel] > 0) == (kernel in used),
              f"{path}: {kernel} launched {launches[kernel]} times")


def path_label(cfg) -> str:
    """goom-rnn's scan variant, or the config's name."""
    blk = cfg.layer_list[0]
    return blk.goom.scan_variant if blk.mixer == "goom_ssm" else cfg.name


#: the kernels each served path launches (the others must not launch at all)
USED = {"shared_a": {"lmme"}, "generic": {"lmme", "matrix_scan"},
        "jamba-v0.1": {"diag_scan"}}


def serve_phase(cfg, model=None):
    import torch

    from repro_torch import DecoderLM

    variant = path_label(cfg)
    t0 = time.perf_counter()
    if model is None:
        model = DecoderLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"serve [{variant}]: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"vocab={cfg.vocab}, {n_params / 1e6:.1f}M params ({n_bytes / 1e9:.2f} GB "
          f"in {cfg.param_dtype}), built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # warm-up pass (allocator, cuBLAS); it also picks the EOS token, one a
    # request first generates mid-decode
    warm, _, _ = serve(model, requests(cfg.vocab))
    eos = pick_eos(warm)
    reqs = requests(cfg.vocab, eos=eos)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    results, reasons, stats = serve(model, reqs, timed=True)
    launches, calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches, calls, f"serve [{variant}]", USED[variant])
    check_finished(reqs, results, reasons)
    check(stats["joined_late"] >= 2, f"only {stats['joined_late']} requests "
          "waited for a slot and joined mid-batch")
    check(reasons[eos[0]] == "stop" and results[eos[0]] == warm[eos[0]][
        :len(results[eos[0]])], f"request {eos[0]} did not stop at EOS {eos[1]}")
    check(all(0 <= t < cfg.vocab for v in results.values() for t in v),
          "token id out of vocabulary")

    # what one decode step and one prefill chunk cost in launches, and a
    # look at the logits themselves
    with torch.no_grad():
        reset_counts()
        logits, _ = model.decode_step(torch.zeros(4, 1, dtype=torch.long, device=DEVICE),
                                      model.init_caches(4, SERVE["page_len"]),
                                      torch.zeros(4, dtype=torch.long, device=DEVICE))
        per_decode = read_counts()[0]
        reset_counts()
        tok = torch.tensor([max((r.prompt for r in reqs), key=len)[:64]],
                           device=DEVICE)
        chunk_logits, _ = model.prefill(tok, model.init_caches(1, SERVE["page_len"]))
        per_chunk = read_counts()[0]
    check(tuple(logits.shape) == (4, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(chunk_logits).all()), "non-finite or misshapen logits")

    ttft = stats["ttft_ms"]
    print(f"serve [{variant}]: {stats['tokens']} tokens in {stats['wall_s']:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s; TTFT ms by request "
          + ", ".join(f"{u}:{ttft[u]:.1f}" for u in sorted(ttft))
          + f"; decode step {stats['decode_step_ms']:.2f} ms (median, 4 slots); "
          f"{stats['decode_steps']} decode steps; {stats['joined_late']} "
          f"requests joined mid-batch; peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"serve [{variant}]: finish reasons {reasons}; launches {launches} == "
          f"engine calls {calls}; launches per decode step (4 slots) {per_decode}, "
          f"per 64-token prefill chunk {per_chunk}", flush=True)
    return model, reqs, dict(stats, launches=launches, peak_bytes=peak,
                             per_decode=per_decode, per_chunk=per_chunk)


def trace_phase(model):
    """A profiler trace of steady decode steps over 4 busy slots: device
    busy ms per step, each kernel's part of it, kernels per step, and the
    card's idle share against the step's unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch import Engine, Request

    variant = path_label(model.cfg)
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
    parts = {k: _device_ms(prof, k) / n_steps for k in ("lmme", "matrix_scan", "diag_scan")}
    print(f"trace [{variant}]: decode step (4 slots) {step_ms:.3f} ms wall, device "
          f"busy {busy:.3f} ms in {n_dev / n_steps:.0f} kernels, of which LMME "
          f"{parts['lmme']:.3f} ms, matrix scan {parts['matrix_scan']:.3f} ms and "
          f"diagonal scan {parts['diag_scan']:.3f} ms; device idle share "
          f"{1 - busy / step_ms:.3f}", flush=True)
    return dict(step_ms=step_ms, busy_ms=busy, kernels=n_dev / n_steps,
                idle=1 - busy / step_ms, **parts)


def parity_phase(model, cfg, reqs, compare_variant=None):
    """f32 serving on the kernels vs under the plain versions: tokens equal
    up to the first near tie of the reference's logits.  With
    ``compare_variant``, also the f32 prefill-logit gap to that scan variant
    on the same weights.  ``model`` itself runs at f32 compute on its own
    weights (a second copy of jamba's 52 GB would not fit): each product
    casts its weight to f32 on the fly."""
    import torch

    variant = path_label(cfg)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    m32, model.cfg = model, cfg32
    try:
        return _parity(m32, cfg32, reqs, variant, compare_variant)
    finally:
        model.cfg = cfg


def _parity(m32, cfg32, reqs, variant, compare_variant):
    import torch

    from repro_torch import DecoderLM
    from repro_torch.core import engine

    page_len = SERVE["page_len"]
    torch.cuda.reset_peak_memory_stats()
    got, _, _ = serve(m32, reqs)
    seq = torch.tensor([max((list(r.prompt) for r in reqs), key=len)],
                       device=DEVICE)
    with torch.no_grad():
        lg_kernel, _ = m32.prefill(seq, m32.init_caches(1, page_len))
        with engine.use_backend("torch_reference"):
            lg_plain, _ = m32.prefill(seq, m32.init_caches(1, page_len))
    print(f"parity [{variant}] (f32): prefill logits of a {seq.shape[1]}-token "
          f"prompt, kernel vs plain: max |diff| "
          f"{float((lg_kernel - lg_plain).abs().max()):.3e}, std "
          f"{float(lg_plain.std()):.3e}", flush=True)
    if compare_variant:
        other = DecoderLM(with_scan_variant(cfg32, compare_variant), device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        other.load_state_dict(m32.state_dict())
        with torch.no_grad():
            lg_other, _ = other.prefill(seq, other.init_caches(1, page_len))
        del other
        print(f"parity [{variant}] (f32): prefill logits {variant} vs "
              f"{compare_variant} on the same weights: max |diff| "
              f"{float((lg_kernel - lg_other).abs().max()):.3e}", flush=True)
    with engine.use_backend("torch_reference"):
        want, _, _ = serve(m32, reqs)
        compared, stopped = 0, []
        for r in reqs:
            g, w = got[r.uid], want[r.uid]
            for i, (x, y) in enumerate(zip(g, w)):
                if x != y:
                    with torch.no_grad():
                        seq = torch.tensor([list(r.prompt) + w[:i]], device=DEVICE)
                        lg, _ = m32.prefill(seq, m32.init_caches(1, page_len))
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
    print(f"parity [{variant}] (f32, {cfg32.n_layers} layers): {compared} tokens "
          f"compared equal; stopped at near ties {stopped or 'none'}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return compared


# ---------------------------------------------------------------------------
# phase 5: the paper's experiments 1 and 2
# ---------------------------------------------------------------------------
def _wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def experiments_phase():
    """Chains (fig. 1) and Lyapunov spectra (fig. 3) on the card, through
    the engine: the parallel chain and the LLE on the zero-B kernel, the
    spectrum's reset scan on the LMME kernel.  The rollouts of the systems
    (a sequential loop of 3-vector steps, on no kernel path) run on the CPU,
    and their Jacobians move to the card."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.chains import (
        chain_matrices,
        float_chain_survival,
        goom_chain,
        goom_log_norm,
    )
    from repro_torch.core.goom import to_goom
    from repro_torch.core.lyapunov import (
        SYSTEMS,
        lle_parallel,
        lle_sequential,
        spectrum_parallel,
        spectrum_sequential,
        trajectory_and_jacobians,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    reset_counts()
    for d in (8, 32, 128):
        res = float_chain_survival(gen, d, 20_000, device=DEVICE)
        check(res.steps_survived < 20_000, f"float chain d={d} did not fail")
        g, ms = _wall_ms(lambda: goom_chain(gen, d, 2_000, device=DEVICE))
        check(g.steps_survived == 2_000, f"GOOM chain d={d} did not complete")
        print(f"chains d={d}: float32 fails after {res.steps_survived} steps; "
              f"GOOM chain completes 2000 steps, final log Frobenius norm "
              f"{g.final_log_norm:.4f} ({ms:.1f} ms, a loop of LMME launches)",
              flush=True)
    mats = chain_matrices(gen, 128, 2_000, device=DEVICE)
    par, par_ms = _wall_ms(lambda: engine.cumulative_lmme(to_goom(mats)))

    def loop():
        s = to_goom(mats[0])
        for a in mats[1:]:
            s = engine.lmme(to_goom(a), s)
        return s

    seq, loop_ms = _wall_ms(loop)
    f_par, f_seq = float(goom_log_norm(par[-1])), float(goom_log_norm(seq))
    check(abs(f_par - f_seq) <= 1e-5 * abs(f_seq), f"parallel chain log norm "
          f"{f_par} vs LMME loop {f_seq}")
    print(f"chains d=128, 2000 steps: goom_chain_parallel (zero-B kernel) "
          f"{par_ms:.1f} ms, log Frobenius norm {f_par:.4f}; loop of LMME "
          f"launches {loop_ms:.1f} ms, {f_seq:.4f}; relative gap "
          f"{abs(f_par - f_seq) / abs(f_seq):.2e}", flush=True)
    q = engine.cumulative_lmme(to_goom(torch.randn(1000, 16, 16, generator=gen,
                                                   device=DEVICE)))
    check(bool(torch.isfinite(q.log_abs).all()) and float(q.log_abs[-1].max()) > 88.0,
          "the quickstart's (1000,16,16) chain is not finite beyond f32")
    print(f"chains (1000,16,16): final log-magnitudes "
          f"{float(q.log_abs[-1].min()):.1f} .. {float(q.log_abs[-1].max()):.1f}, "
          "all finite", flush=True)

    results = {}
    for name, sys_ in SYSTEMS.items():
        _, js = trajectory_and_jacobians(sys_, 4096, device="cpu")
        js = js.to(DEVICE)
        seq_s, t_seq = _wall_ms(lambda: spectrum_sequential(js, sys_.dt))
        par_s, t_par = _wall_ms(lambda: spectrum_parallel(js, sys_.dt, chunk_size=256))
        lle_s, t_lle_s = _wall_ms(lambda: lle_sequential(js, sys_.dt))
        lle_p, t_lle_p = _wall_ms(lambda: lle_parallel(js, sys_.dt))
        check(bool(torch.isfinite(par_s).all()), f"{name}: non-finite spectrum")
        check(bool(torch.allclose(par_s, seq_s, rtol=1e-3, atol=1e-3)),
              f"{name}: parallel spectrum {par_s.tolist()} vs sequential {seq_s.tolist()}")
        gap = abs(float(lle_p) - float(lle_s))
        check(gap <= max(0.05, 0.05 * abs(float(lle_s))),
              f"{name}: LLE parallel {float(lle_p)} vs sequential {float(lle_s)}")
        est = sorted(par_s.tolist(), reverse=True)[0]
        ref = sorted(sys_.ref_spectrum, reverse=True)[0]
        check(abs(est - ref) < max(0.15, 0.2 * abs(ref) + 0.05),
              f"{name}: lambda_1 {est} vs literature {ref}")
        results[name] = dict(seq=seq_s.tolist(), par=par_s.tolist(), lle_seq=float(lle_s),
                             lle_par=float(lle_p), ms=(t_seq, t_par, t_lle_s, t_lle_p))
        print(f"lyapunov {name} (4096 steps): sequential "
              f"{[round(v, 4) for v in seq_s.tolist()]} {t_seq:.1f} ms; parallel "
              f"{[round(v, 4) for v in par_s.tolist()]} {t_par:.1f} ms; LLE "
              f"sequential {float(lle_s):.4f} {t_lle_s:.1f} ms, parallel "
              f"{float(lle_p):.4f} {t_lle_p:.1f} ms; literature lambda_1 {ref}",
              flush=True)
    launches, calls = read_counts()
    check_launches(launches, calls, "experiments", {"lmme", "matrix_scan_zero_b"})
    from repro_torch.kernels.goom_scan import matrix_scan_cuda
    from repro_torch.kernels.lmme import lmme_cuda

    print(f"experiments: launches {launches} == engine calls {calls}; "
          f"{matrix_scan_cuda.kernels_zero_b} zero-B kernels over "
          f"{launches['matrix_scan_zero_b']} calls; LMME launches in the batched "
          f"shape {lmme_cuda.launches_batched}", flush=True)
    return launches


def layer_breakdown(model):
    """Device ms per decode step (4 slots) by layer kind: one layer of each
    kind timed alone at the decode shape (its pre-norm included), times the
    model's count of that kind, and the lm_head; against the step's weight
    bytes at 3.35 TB/s."""
    import torch

    cfg, cd = model.cfg, model.cfg.compute_dtype
    b, page_len = SERVE["max_slots"], SERVE["page_len"]
    caches = model.init_caches(b, page_len)
    pos = torch.zeros(b, 1, dtype=torch.long, device=DEVICE)
    x = torch.randn(b, 1, cfg.d_model, device=DEVICE).to(cd)
    kinds = {}
    for i, blk in enumerate(cfg.layer_list):
        for part, kind in (("mixer", blk.mixer), ("channel", blk.channel)):
            if kind != "none":
                kinds.setdefault(kind, [part, i, 0])[2] += 1
    out = {}
    with torch.no_grad():
        for kind, (part, i, count) in kinds.items():
            layer = model.layers[i]
            norm, mod = getattr(layer, f"{part}_norm"), getattr(layer, part)
            if kind == "attention":
                fn = lambda: mod(norm(x), positions=pos, cache=caches[i], compute_dtype=cd)  # noqa: E731
            elif kind == "moe":
                fn = lambda: mod(norm(x), compute_dtype=cd, dropless=True)  # noqa: E731
            elif part == "mixer":
                fn = lambda: mod(norm(x), state=caches[i], compute_dtype=cd)  # noqa: E731
            else:
                fn = lambda: mod(norm(x), compute_dtype=cd)  # noqa: E731
            out[kind] = count * device_ms(fn, 5)
        out["lm_head"] = device_ms(lambda: model.logits(model.final_norm(x)), 5)
    weights_ms = 1e3 * sum(p.numel() * p.element_size() for p in model.parameters()) \
        / HBM_BYTES_PER_S
    print(f"layers [{path_label(cfg)}]: device ms per decode step (4 slots) by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
          + f"; sum {sum(out.values()):.3f}; reading every weight once takes "
          f"{weights_ms:.3f} ms at 3.35 TB/s", flush=True)
    return out


def jamba_config():
    """jamba-v0.1 at full width, cut to ``JAMBA_PERIODS`` whole 8-layer
    periods, parameters in bf16."""
    import torch

    from repro_torch import get_config

    cfg = get_config("jamba-v0.1")
    return dataclasses.replace(
        cfg, n_layers=8 * JAMBA_PERIODS, param_dtype=torch.bfloat16,
        groups=tuple(dataclasses.replace(g, n_periods=JAMBA_PERIODS) for g in cfg.groups))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    from repro_torch import DecoderLM, get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t_start = t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs().items():
        print(f"build {name}: {(log or 'loaded from an earlier build').strip()}",
              flush=True)

    def elapsed(phase):
        print(f"[{phase} done at {time.perf_counter() - t_start:.1f} s]", flush=True)

    rows, max_err = kernel_phase()
    scan_rows, scan_errs = scan_kernel_phase()
    if "--kernels" in sys.argv[1:]:  # the kernel phases alone
        print(card)
        return 0
    diag_rows, diag_err = diag_kernel_phase()
    elapsed("kernels")
    cfg = get_config("goom-rnn-124m")
    model, reqs, stats = serve_phase(cfg)
    trace_phase(model)
    parity_phase(model, cfg, reqs)
    elapsed("shared_a")
    cfg_g = with_scan_variant(cfg, "generic")
    model_g = DecoderLM(cfg_g, device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    model_g.load_state_dict(model.state_dict())
    del model
    model_g, _, stats_g = serve_phase(cfg_g, model_g)
    trace_phase(model_g)
    parity_phase(model_g, cfg_g, reqs, compare_variant="shared_a")
    del model_g
    elapsed("generic")
    exp_launches = experiments_phase()
    elapsed("experiments")
    cfg_j = jamba_config()
    model_j, reqs_j, stats_j = serve_phase(cfg_j)
    trace_j = trace_phase(model_j)
    layer_breakdown(model_j)
    parity_phase(model_j, cfg_j, reqs_j)
    del model_j
    elapsed("jamba")

    # each kernel's row: the shape its main path launches most, and the
    # launches of the run of that path (the other paths' beside them)
    by_path = {k: {"serve shared_a": stats["launches"][k], "serve generic":
                   stats_g["launches"][k], "experiments": exp_launches[k],
                   "serve jamba": stats_j["launches"][k]}
               for k in ("lmme", "matrix_scan", "matrix_scan_zero_b", "diag_scan")}
    lmme_row = next(r for r in rows if r["shape"].startswith("decode"))
    scan_row = next(v for k, v in scan_rows.items() if k.startswith("decode"))
    zb_row = next(v for k, v in scan_rows.items() if k.startswith("zero-B d=128"))
    diag_row = next(v for k, v in diag_rows.items() if k.startswith("decode"))
    src = "src/repro_torch/kernels"
    entries = [
        ("lmme", f"{src}/lmme/csrc/lmme.cu", "src/repro/kernels/lmme/lmme.py:36",
         stats["launches"]["lmme"], max_err, lmme_row, lmme_row["shape"],
         "serve shared_a"),
        ("matrix_scan", f"{src}/goom_scan/csrc/matrix_scan.cu",
         "src/repro/kernels/goom_scan/matrix_scan.py:75",
         stats_g["launches"]["matrix_scan"], scan_errs["matrix_scan"], scan_row,
         "decode (G=48,T=1,d=16,m=4)", "serve generic"),
        ("matrix_scan_zero_b", f"{src}/goom_scan/csrc/matrix_scan_zero_b.cu",
         "src/repro/kernels/goom_scan/matrix_scan.py:124",
         exp_launches["matrix_scan_zero_b"], scan_errs["matrix_scan_zero_b"], zb_row,
         "zero-B d=128 chain (2001,128,128)", "experiments"),
        ("diag_scan", f"{src}/goom_scan/csrc/diag_scan.cu",
         "src/repro/kernels/goom_scan/goom_scan.py:62",
         stats_j["launches"]["diag_scan"], diag_err, diag_row,
         "decode (T=1, C=4x8192x16)", "serve jamba"),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None, "shape": shape,
        "main_path": path, "launches_by_path": by_path[name],
        "kernels_per_call": row.get("kernels_per_call"), "event_ms": row.get("event_ms"),
    } for name, source, replaces, launches, err, row, shape, path in entries]}))
    print(f"jamba: decode step device busy {trace_j['busy_ms']:.3f} ms, of which the "
          f"diagonal scan {trace_j['diag_scan']:.3f} ms; {card}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
