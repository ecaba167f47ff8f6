#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--kernels]

from the root of a checkout, on a machine with an NVIDIA Hopper card and the
CUDA toolkit.  Phases, in order; any failure exits non-zero:

  1. build    — compile every CUDA kernel source with nvcc (sm_90a), in
                parallel; check that this torch's ``torch.bmm`` takes
                ``out_dtype`` (decode attention contracts a bf16 cache with
                f32 products out, as JAX's ``preferred_element_type``);
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card, and time both: the LMME kernel on e±200 inputs with
                exact-zero rows and columns, at the serving path's shapes,
                the chains' square d = 8, 32, 128 and the spectrum's reset
                products, and at RWKV6's WKV score shapes (decode
                (4,64,1,64)x(4,64,64,1), the 64-token chunk (1,64,64,64)²
                and the tail (1,64,1,64)x(1,64,64,1), the second operand a
                transposed view) on e±200 operands, at a decay of e^-60 a
                step and at e^-60·u a step, u ~ U[0.25, 1] per channel, each
                with the launch shape ``batched_plan`` picked; the matrix
                scan with B (one kernel a call, timed also by CUDA events,
                and at the 64-token chunk also as the one-chunk walk) at the
                generic layer's shapes, a time-varying A, d = 128, on e±200
                and odd signed shapes, and
                its zero-B form from X_0 = I (three passes, 4–5 kernels a
                call, timed as their sum and by CUDA events) on the chains'
                and the LLE's lengths, each also against float64; the
                diagonal-scan kernel at Mamba's decode, prefill-chunk and
                tail shapes, on e±200 signed inputs with exact zeros and
                cancellations, T=1, odd C and the autotune shape (4096,
                512), each also against float64, with its backward;
  3. serve    — serve goom-rnn-124m at full width (24 layers, d=768, vocab
                50257, seeded random weights, bf16 compute) through
                ``Engine(max_slots=4, page_len=512, chunk=64)``, its steps
                CUDA graphs captured at first use and replayed: 6 requests,
                two of which wait for a slot and join mid-batch, one stopping
                at an EOS.  A warm-up pass on the same Engine captures the
                graphs; the timed pass runs on replays.  Every engine LMME
                and matrix-scan call, counted over captures and replays,
                must have launched its CUDA kernel, and each replayed k-step
                decode must stand for k eager steps' launches.  The same
                requests at horizon 1 must give the same tokens.  Once with
                ``scan_variant="shared_a"`` (every GOOM op an LMME) and once
                with the paper-literal ``"generic"`` (B·u on the LMME kernel,
                the recurrence one matrix-scan launch per layer).  Then:
                trace — steady decode over 4 busy slots, graphed (horizon 8)
                and eager (``decode_step`` and ``merge_frozen`` called as the
                Engine before graphs did), each timed and profiled, and the
                profiler's count of LMME, with-B and diagonal-scan kernels in
                a replayed k=1 decode held to the eager step's launches;
                prefix — 6 requests sharing a 256-token prefix (4 pages of
                64), with and without prefix reuse: equal tokens, the hit
                rate and the TTFT of hits and miss; for ``shared_a`` also
                control — cancel, a deadline, streaming — and http — a
                ``BackgroundServer`` with 4 concurrent clients (2 streaming
                what the other 2 ask), ``/status``, and a client that hangs
                up mid-stream;
  4. parity   — serve the same requests at f32 compute on the kernels and
                under ``backend="torch_reference"``; tokens must agree
                except after a near tie (top-2 margin below 1e-4·std(logits)).
                For ``generic`` also the prefill-logit gap to ``shared_a`` on
                the same weights;
  5. train    — train goom-rnn-124m at full width (f32 weights, bf16
                compute) in ``shared_a`` and ``generic`` (8 of its 24
                layers, ``TRAIN_LAYERS``) through
                ``make_train_step``: Copy-Memory, B=16, S=128, AdamW at a
                cosine lr of 3e-3 with 20 warm-up steps, 2 steps with finite
                losses under ``remat="none"``, launches equal to the
                forward's engine calls (the backward, autograd of the plain
                versions, launches no kernel); forward, backward and
                optimizer ms by CUDA events, one step profiled (device busy,
                idle share, the backward's device ms in the plain versions'
                autograd), and one f32 step on the kernels held to the same
                step under the plain versions and to the same step under
                ``remat="full"``; then each of ``none``, ``full`` and
                ``dots`` alike from a fresh optimizer state: wall, device
                busy, peak GiB over the floor allocated at the reset, and
                launches a step (twice the forward's under remat);
  5a. dry-run — (started before the build, in a child process with one
                thread and no card, joined before phase 3) the dry-run of
                goom-rnn-124m's train step at phase 5's shape on a (1, 1)
                mesh (``launch.dryrun.lower_cell``: the port's step on fake
                tensors) in both variants under ``none`` and ``full``, and
                on (2, 1) and (4, 1) meshes for phase 13's ranks, and
                phase 13b's (1, 2) train and prefill cells; after
                the remat measurements, the predicted GOOM launches a step
                must equal the measured, the roofline step time must not
                pass the measured device busy, and the predicted peak above
                the parameters and optimizer state must be within 1.5× of
                the measured peak above the floor;
  5b. float, layouts — Jamba smoke with Mamba's ``scan_impl="float"``
                against ``"goom"`` and the CPU; goom-rnn-124m's f32 train
                step with DTensor parameters on a 1-rank ``DeviceMesh``
                against the plain path (loss and launches; several ranks
                run in phase 13);
  5c. goomcheck — (started with the dry-run, in a child process with one
                thread and the card visible, joined after phase 14)
                ``python -m repro_torch.analysis --ci --device cuda``: the
                port's goomcheck over fake CUDA tensors (its 16 graph
                targets: the 8 registered engine impls and goom-rnn-124m's
                and olmo-1b's smoke decode step and prefill under both
                backends) and its AST rules; it must exit 0 with no active
                finding and no skipped target;
  6. experiments — the paper's experiments 1 and 2 on the card: float
                chains fail, GOOM chains complete, the parallel chain (zero-B
                kernel) equals a loop of LMME launches; Lyapunov spectra and
                LLE of the four in-repo systems at 4096 steps, parallel
                against sequential and λ1 against the literature;
  7. jamba    — serve jamba-v0.1 at full width (d=4096, vocab 65536, GQA
                32/8 heads, 16-expert top-2 MoE) cut to one of its four
                8-layer periods (8 layers, 13.3B parameters, 26.6 GB in
                bf16; two periods, 52 GB, fit but cost the run's time),
                seeded random bf16 weights built on the card, bf16 compute,
                f32 recurrent state, through the same Engine and requests.
                Every engine diagonal_scan call must have launched the
                diagonal-scan kernel, and no other GOOM op may run; the
                horizon, trace and
                prefix checks of phase 3, a decode step's device time by
                layer kind, then the parity check of phase 4 at f32 compute
                on the same weights;
  8. rwkv6    — serve rwkv6-7b at full width (d=4096, 64 heads of 64, d_ff
                14336, vocab 65536) cut to 4 of its 32 layers (1.9 GB in
                bf16) with the phases of 7: every engine LMME
                call (one a layer and WKV chunk, at decode too) must have
                launched the LMME kernel, and no other GOOM op may run;
                prefix reuse goes through carry checkpoints alone (no layer
                is paged); the decode step's LMME share of busy time;
  9. families — olmo-1b, codeqwen1.5-7b, phi3.5-moe, mixtral-8x7b,
                glm4-9b and gemma3-1b at full width, bf16 weights, each at
                full depth where its weights fit in 40 GB, else the most
                whole layers that do, and cut to ``DEPTH_CUTS`` and
                ``PERIOD_CUTS`` (below), one at a time: the closed batch through the graphed
                Engine at horizons 8 and 1 (tokens equal), the graphed
                decode step traced, and at f32 compute with f32 KV the
                Engine's tokens against the argmax of a no-cache forward at
                every generated position (paged, dense and rolling caches
                against the cache-free path), and for the windowed models
                (gemma3-1b, mixtral-8x7b) a prompt of window + 600 tokens
                prefilled in two chunks and decoded through rings of window
                rows that wrap, held to the no-cache forward; gemma3-1b
                (paged global layers beside dense rings) also prefix reuse;
 10. frontends — musicgen-large (48 layers, d=2048, 2.42B parameters, 4.85
                GB in bf16; sinusoidal positions, LayerNorm) and qwen2-vl-7b
                (28 layers, d=3584, M-RoPE (16, 24, 24), qkv biases, 7.62B
                parameters, 15.23 GB) at full width and depth, bf16 weights,
                one at a time: the Engine refuses them, as JAX's does;
                ``generate`` serves 4 prompts (128 tokens with 64 prefix
                embeddings; 320 tokens with a 16x16 patch grid of 256 and its
                M-RoPE positions) for 32 tokens: the single-shot prefill,
                the decode step as one CUDA graph traced, device time by
                layer kind, and at f32 compute with f32 KV the tokens against
                a no-cache forward's argmax; then banded sliding-window
                attention against the dense windowed path (gemma3-1b's smoke
                config, f32, logits within 1e-5·std);
 10b. flash   — blockwise flash attention where it matters, no fallback:
                gemma3-1b at full width and depth (bf16 weights) through
                ``generate`` on 2 prompts of its published 32768-token
                context, 8 tokens each: the fresh single-shot prefill (32
                key blocks on each of 26 layers) timed and traced, its peak
                above the floor held within 1.05x of the dry-run cell's
                (computed in the dry-run child), the graphed decode step at
                that context; at f32 a 4096-token prompt at 4 key blocks
                against one block (last logits within 1e-4·std, tokens
                equal but after a near tie); olmo-1b trained at its 2048-token
                context (B=8, bf16, remat full): step wall, busy and peak,
                one f32 step at 2 blocks against one (loss within 1e-4), and
                each leaf's gradient at 2 blocks within twice one block's
                distance to the same step in float64 on one process
                (``f64_step``: a float64 copy of the model through the plain
                versions, on the card); Jamba's smoke
                config trained 3 f32 steps (capacity routing) on the card
                against the CPU (loss, grad norm and lr within rtol 1e-3),
                every diagonal_scan call on the kernel;
 11. examples — ``examples/quickstart_torch.py``,
                ``lyapunov_spectra_torch.py`` and ``serve_lm_torch.py`` run
                in-process (their ``main()``) at their default sizes, each
                checked, their LMME and zero-B launches counted;
 12. sharded  — after training: sequence-sharded engine ops on P = 2 and 4
                gloo ranks that share the card (``launch.mesh.spawn_ranks``,
                the kernels built before): the with-B matrix scan at
                goom-rnn's training shape (T=128, G=48, d=16, m=16, signed,
                e±200 steps), ``cumulative_lmme`` on the d=128 chain (T=2001,
                padded at P=4), the diagonal scan at T=512 over Mamba's
                8192x16 channels, and the reset scan of the lorenz63
                spectrum over 4096 steps; every rank's states equal, within
                twice the single-process kernel call's or plain version's
                distance to float64 (the reset scan: within 1e-4 of the plain
                version at the same P, flags equal), each rank's launches
                those of the algebra; the calls' ms at P = 1, 2, 4 (the
                least of a rank's 3 timed calls);
 13. launcher ranks — ``python -m torch.distributed.run --nproc-per-node P
                -m repro_torch.launch.train``, all runs at once, gloo ranks
                sharing the card, goom-rnn-124m at full width:
                ``--seq-shards 2`` on 2 ranks, 3 bf16 steps; ``--seq-shards
                2`` on 4 ranks ((2, 2): data parallel beside the
                full-length scans), one f32 step; FSDP, ``--mesh host`` on
                (P, 1), its parameters laid out and gathered a period at a
                time: 2 bf16 steps (remat full, B=16, S=128) at P = 1, 2 and
                4, each rank's peak above its floor within 1.05x of the
                dry-run's (P, 1) cell's above the state and its floor at most
                80 MiB above that state, the peaks falling with P, each
                rank's LMME launches equal to its engine calls; one f32 FSDP
                step at P = 2; ``--model-shards 2`` on 2 ranks (phase 13b).
                The two f32 runs' first step (loss, gradient norm, and each
                leaf's first moment in the launcher's checkpoint of step 1)
                within twice one f32 process's distance to the same step in
                float64 on one process (floors: one f32 ulp of the loss,
                eight of the norm), and that process's worst leaf below the
                bf16 one's; while the ranks run, the one processes' steps
                (f32 on both data slices, bf16 on the model-axis batch, each
                beside its float64 step) and ``python -m
                repro_torch.launch.train`` in this process at full width:
                a step, a checkpoint, a restart that resumes;
 13b. model axis — heads, channels and the vocabulary split across 2 gloo
                ranks sharing the card, a (1, 2) mesh, the default rules:
                the ``--model-shards 2`` run (goom-rnn-124m, 24 of 48 heads a
                rank, bf16, remat full, B=16, S=128, 2 steps): its first
                step against float64 within twice one bf16 process's
                distance, each rank's LMME launches equal to its engine
                calls, its peak above the floor within 1.05x of the
                dry-run's (1, 2) cell; olmo-1b (f32 compute) prefilled fresh
                with 2 x 4096 tokens on 2 ranks: each rank's KV caches half
                of one process's and its heads' block of them (within a bf16
                step and 1e-4 of the largest entry), the last logits within
                1e-4·std and the next tokens equal, the peak above the floor
                within 1.05x of the dry-run's (1, 2) prefill cell; the LMME
                and with-B scan kernels at 24 heads and the diagonal scan at
                Jamba smoke's 64 of 128 channels held to float64 on the
                operands the split layers handed them;
 14. autotune — (last) ``engine.autotune()`` on ``DEFAULT_SHAPES`` and
                goom-rnn's with-B decode and 64-token chunk (twice, the
                same winner): every candidate's ms (a replayed CUDA graph);
                the next engine call launches with the
                cached winner's L, and with no cache with the default L.
                The run's cache is a file of its own (``AUTOTUNE_CACHE``),
                deleted after, so no earlier cache moves a launch.

Cut for the run's time (``DEPTH_CUTS``, ``PERIOD_CUTS``): codeqwen1.5-7b and
glm4-9b run 2 of their layers (their attention runs olmo-1b's code),
phi3.5-moe and mixtral-8x7b 2, rwkv6-7b 4 of 32, olmo-1b's families phase
8 of 16 (whole in phases 10b and 13b), gemma3-1b's
families phase one period of each group (8 of its 26 layers, which run
whole in phase 10b; its 32768-token ``generate`` is the prefill and
decode step timed there, ``generate`` itself running at 4096 tokens),
the launcher's seq-sharded bf16 run 2 steps, training 2 steps a
variant (its parts timed over 2 more, 1 a remat setting; ``generic`` at 8
of goom-rnn-124m's 24 layers, ``TRAIN_LAYERS``, so its launches on the
``kernels`` line are a third of a 24-layer run's) and the launcher
ranks' FSDP runs 2 steps, its f32 runs one (held to float64);
RWKV6's LMME shapes are timed once a shape, and the scans' odd signed
shapes are checked, not timed.

``--kernels`` runs phases 1 and 2 without the diagonal scan and stops: the
loop for kernel work (``tools/kernels_ab.sh`` runs it on two checkouts in
turns).

Before the last lines, one summary line a served path (graphed and eager
decode step, tokens/s at horizons 8 and 1, tokens a dispatch, host syncs a
token, prefix hit rate and TTFT; for the frontend models generate's graphed
decode step, tokens/s and prefill), and each phase's seconds.  The last lines are a JSON object of
per-kernel numbers, the card's name and power limit (from nvidia-smi), and
``{"ok": true, "device": {...}}``.
TF32 is off for every float32 product (the default, set here explicitly).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# the 1-token prompt with a budget of 1 comes last: it and the 333-token
# prompt wait for a slot and join mid-batch
PROMPT_LENS = [63, 64, 65, 200, 333, 1]
BUDGETS = [8, 16, 32, 32, 32, 1]
SERVE = dict(max_slots=4, page_len=512, chunk=64)
DEVICE = "cuda"
# jamba-v0.1 is cut to this many of its four 8-layer periods (depth only)
JAMBA_PERIODS = 1
#: this run's autotune cache: empty until the autotune phase, deleted after,
#: so that no cache of an earlier run moves a launch of the other phases
AUTOTUNE_CACHE = str(ROOT / "build" / "chip_smoke_autotune.json")


def out_dtype_probe() -> str:
    """Whether this torch's ``torch.bmm`` takes ``out_dtype`` on the card
    (``aten::bmm.dtype``): decode attention contracts a bf16 KV cache with
    it, f32 products out, as JAX's ``preferred_element_type``
    (``models/attention.py::_attend``); fails without it."""
    import torch

    a = torch.full((1, 2, 3), 1.5, device=DEVICE, dtype=torch.bfloat16)
    out = torch.bmm(a, a.transpose(1, 2), out_dtype=torch.float32)
    check(out.dtype == torch.float32 and float(out[0, 0, 0]) == 6.75,
          f"torch.bmm(out_dtype=torch.float32): {out.dtype} {out}")
    return (f"torch.bmm(bf16, bf16, out_dtype=torch.float32) present in torch "
            f"{torch.__version__} ({sorted(torch.ops.aten.bmm.overloads())}), gives "
            f"{out.dtype}")


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
    return _profiled(fn, iters)


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
    """(bound ms, bound_by) of one LMME call (``launch.roofline.lmme_work``:
    each plane read or written once; an exp per input, 2 flops per
    multiply-add, a log per output) on the H100's peaks."""
    from repro_torch.launch.roofline import kernel_bound, lmme_work

    return kernel_bound(*lmme_work(a_shape, b_shape))


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
        # the model axis's B·u: 24 of goom-rnn's 48 heads, at the shape
        # ``model_axis_phase``'s split forward hands it (B=2, S=64)
        ("model axis B·u (24,16,16)x(64,2,24,16,1)", (24, 16, 16), (64, 2, 24, 16, 1)),
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


# RWKV6's WKV score products (models/ssm.py::rwkv6_scan): 64 heads of 64,
# (B, H, L, D) ∘ (B, H, D, L) with the second operand k's transposed view;
# name, B, L, H; the model axis's cases are a (1, 2) rank's 32 heads at
# ``model_axis_rest``'s prefill chunk (B=2, rwkv6-7b's chunk of 128) and decode
RWKV6_LMME_CASES = [
    ("rwkv6 decode (4,64,1,64)x(4,64,64,1)", 4, 1, 64),
    ("rwkv6 chunk (1,64,64,64)x(1,64,64,64)", 1, 64, 64),
    ("rwkv6 tail (1,64,1,64)x(1,64,64,1)", 1, 1, 64),
    ("rwkv6 model axis chunk (2,32,128,64)x(2,32,64,128)", 2, 128, 32),
    ("rwkv6 model axis decode (2,32,1,64)x(2,32,64,1)", 2, 1, 32),
]
RWKV6_STRONG_DECAY = -60.0   # log a every step and dim: e^-60
#: the operand kinds each RWKV6 shape runs on (``rwkv6_lmme_operands``)
RWKV6_LMME_KINDS = ("e200", "decay", "decay_spread")


def rwkv6_lmme_operands(b, length, kind, gen, heads=64):
    """The WKV's score operands as ``rwkv6_scan`` builds them from r, k ~
    N(0, 1): log r~ = log|r| + cum_prev and log k~ = log|k| - cum, the second
    passed as the (B, H, D, L) transposed view.  ``kind="e200"``: no decay,
    each row of r~ and of k~ shifted by up to ±200 in log space, with an
    exact-zero row of r; ``kind="decay"``: log a = -60 every step and
    channel, so that a 64-token chunk's logs reach ±3780 (a shift constant
    along each row of r~ and column of k~); ``kind="decay_spread"``: log a =
    -60·u_d per channel d of each head, u_d ~ U[0.25, 1], as RWKV6's
    per-channel decay spreads it, so that the terms of one contraction over
    d lie thousands of e-folds apart."""
    import torch

    from repro_torch.core.goom import Goom, nonzero_sign

    shape = (b, heads, length, 64)
    r = torch.randn(shape, generator=gen, device="cuda")
    k = torch.randn(shape, generator=gen, device="cuda")
    if kind in ("decay", "decay_spread"):
        la = torch.full(shape, RWKV6_STRONG_DECAY, device="cuda")
        if kind == "decay_spread":
            la = la * (0.25 + 0.75 * torch.rand((b, heads, 1, 64), generator=gen,
                                                device="cuda"))
        cum = torch.cumsum(la, dim=-2)
        rl, kl = r.abs().log() + (cum - la), k.abs().log() - cum
    else:
        def shift():
            return torch.rand(shape[:-1] + (1,), generator=gen, device="cuda") * 400 - 200

        rl, kl = r.abs().log() + shift(), k.abs().log() + shift()
        rl[0, 0, 0] = -float("inf")
    return Goom(rl, nonzero_sign(r)), Goom(kl.mT, nonzero_sign(k).mT)


def rwkv6_lmme_phase():
    """The LMME kernel at RWKV6's decode, chunk and tail shapes, on e±200 and
    on strong-decay operands (uniform and spread over channels), against its
    plain version on the same card: the error by ``goom_close``, the
    kernel's and the plain version's device times, the bound, and the
    launch shape ``batched_plan`` picked.  Both compute the paper's
    compromise LMME (exact row max of A, column max of B): where a spread
    decay puts a row's and a column's maxima on different channels, every
    term of an entry can underflow and the entry comes out zero (log -inf)
    in both.  Such entries are counted against a float64 log-sum-exp of the
    magnitudes, and only NaN or +inf logs fail the case."""
    import torch

    from repro_torch.core.goom import Goom
    from repro_torch.kernels.lmme import lmme_cuda, lmme_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    rows = {}
    for name, b, length, heads in RWKV6_LMME_CASES:
        for kind in RWKV6_LMME_KINDS:
            a, bk = rwkv6_lmme_operands(b, length, kind, gen, heads)
            batched = lmme_cuda.launches_batched
            got = lmme_cuda(a, bk)
            torch.cuda.synchronize()
            plan = "batched" if lmme_cuda.launches_batched > batched else "tiled"
            want = Goom(*lmme_ref(a.log_abs, a.sign, bk.log_abs, bk.sign))
            scale = lmme_ref(a.log_abs, torch.ones_like(a.sign),
                             bk.log_abs, torch.ones_like(bk.sign))[0]
            ok, err = goom_close(got, want, scale)
            check(ok, f"LMME kernel disagrees with its plain version at {name}, "
                      f"{kind}: max normalised error {err:.3e}")
            finite = torch.isfinite(got.log_abs)
            lost = None
            if kind == "e200":
                finite[0, 0, 0] = True   # the zero row of r: log 0 = -inf
            elif kind == "decay_spread":
                finite |= got.log_abs == -math.inf
                exact = torch.logsumexp(a.log_abs.double()[..., :, None, :]
                                        + bk.log_abs.double().mT[..., None, :, :], -1)
                kept = exact > -80
                if length > 1:   # the strictly causal entries, the ones the scan keeps
                    kept &= torch.ones(length, length, dtype=torch.bool,
                                       device="cuda").tril(-1)
                lost = tuple(float(((x.log_abs == -math.inf) & kept).sum() / kept.sum())
                             for x in (got, want))
            check(bool(finite.all()), f"LMME at {name}, {kind}: NaN or non-finite logs")
            # timed once a shape: the operands' values do not change the work
            k_ms = p_ms = None
            if kind == RWKV6_LMME_KINDS[0]:
                k_ms, _, _ = call_ms(lambda: lmme_cuda(a, bk), 100, "lmme")
                p_ms = device_ms(lambda: lmme_ref(a.log_abs, a.sign, bk.log_abs, bk.sign),
                                 100)
            bound, bound_by = lmme_bound(tuple(a.shape), tuple(bk.shape))
            rows[f"{name} {kind}"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                          bound_by=bound_by, max_abs_err=err, plan=plan)
            zeros = ("" if lost is None else f"; of the {'causal ' * (length > 1)}entries "
                     f"above e^-80 in float64, zero in the kernel {lost[0]:.4f}, in the "
                     f"plain version {lost[1]:.4f}")
            timed = ("timed at e200" if k_ms is None else
                     f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            print(f"lmme {name} {kind}: {plan} launch shape, {timed}, bound {bound:.6f} ms "
                  f"({bound_by}), max normalised error {err:.2e}{zeros}", flush=True)
    check(all(r["plan"] == ("tiled" if "chunk" in n else "batched") for n, r in rows.items()
              if "model axis" not in n),
          f"LMME launch shapes at RWKV6's shapes: {[(n, r['plan']) for n, r in rows.items()]}")
    return rows


# name, T, batch, d, m, kind: the generic layer's decode and 64-token chunk
# (48 heads of 16; A time-invariant, passed as a stride-0 view), a
# time-varying A over 256 steps at the layer's widths, the block kernel's d =
# 128, the JAX tests' e±200 and odd signed shapes
SCAN_CASES = [
    ("decode (G=48,T=1,d=16,m=4)", 1, (48,), 16, 4, "shared_a"),
    ("64-token chunk (G=48,T=64,d=16,m=1)", 64, (48,), 16, 1, "shared_a"),
    # the model axis: ``generic`` on 24 of 48 heads at the shape
    # ``model_axis_phase``'s split forward hands it (B=2 in the state columns)
    ("model axis (G=24,T=64,d=16,m=2)", 64, (24,), 16, 2, "shared_a"),
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
    """(bound ms, bound_by) of one matrix-scan call
    (``launch.roofline.scan_work``) on the H100's peaks."""
    from repro_torch.launch.roofline import kernel_bound, scan_work

    return kernel_bound(*scan_work(t, g, d, m, has_b=has_b, a_fixed=a_fixed))


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
        bound, bound_by = scan_bound(t, g, d, m, has_b=True, a_fixed=kind == "shared_a")
        if name.startswith("signed"):   # the JAX tests' odd shapes: checked, not timed
            print(f"matrix_scan {name}: error vs plain {err:.2e}; distance to float64: "
                  f"kernel {d_k:.2e}, plain {d_p:.2e} (not timed)", flush=True)
            continue
        iters = 50 if t <= 64 else 10
        k_ms, per_call, k_how = call_ms(lambda: matrix_scan_cuda(a, b, x0), iters,
                                        "matrix_scan")
        k_ev = event_ms(lambda: matrix_scan_cuda(a, b, x0), iters)
        p_ms = device_ms(lambda: matrix_scan_ref(a, b, x0), iters)
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
    ("model axis decode (T=1, C=4x4096x16)", 1, (4, 4096, 16), "mamba"),
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
    """(bound ms, bound_by) of one diagonal-scan call
    (``launch.roofline.diag_work``) on the H100's peaks."""
    from repro_torch.launch.roofline import diag_work, kernel_bound

    return kernel_bound(*diag_work(t, c))


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
        if name.startswith("signed"):   # odd shapes and values: checked, not timed
            print(f"diag_scan {name}: error vs plain {err:.2e}; distance to float64: "
                  f"kernel {d_k:.2e}, plain {d_p:.2e} (not timed)", flush=True)
            continue
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


def serve(model, reqs, timed=False, eng=None, **engine_kw):
    """Run ``reqs`` through ``eng`` (default: a fresh Engine with ``SERVE``
    and ``engine_kw``); returns (results, finish reasons, stats).  All
    requests arrive at once; with 4 slots the last ones wait and join
    mid-batch.  ``decode_step_ms`` is the median, over dispatches that
    admitted nobody, of a dispatch's wall time over its horizon."""
    import torch

    from repro_torch import Engine

    if eng is None:
        free_memory()
        eng = Engine(model, **dict(SERVE, **engine_kw))
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ttft, decode_ms, results, reasons = {}, [], {}, {}
    joined_late, n_steps = 0, 0
    steps0, d0 = eng.n_decode_steps, eng.decode_stats()
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
        if admitted == admitted_before and eng.n_decode_steps > steps0:
            decode_ms.append((now - t_step) * 1e3 / eng.decode_stats()["last_horizon"])
        for uid in done:
            reasons[uid] = eng.finish_reason(uid)
            results[uid] = eng.pop_result(uid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(v) for v in results.values())
    stats = dict(wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                 ttft_ms={u: 1e3 * s for u, s in ttft.items()},
                 decode_step_ms=statistics.median(decode_ms) if decode_ms else None,
                 decode_steps=eng.n_decode_steps - steps0, joined_late=joined_late,
                 decode=_decode_delta(d0, eng.decode_stats()),
                 prefix=eng.prefix_stats(), graphs=eng.graphs.n_graphs)
    return results, reasons, stats


def _decode_delta(before, after):
    """``Engine.decode_stats()`` of the requests served between two reads."""
    d = {k: after[k] - before[k] for k in ("dispatches", "decode_steps", "host_syncs")}
    return dict(d, tokens_per_dispatch=d["decode_steps"] / max(d["dispatches"], 1),
                syncs_per_token=d["host_syncs"] / max(d["decode_steps"], 1))


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
    """Every kernel's launch count, every engine call count and the graph
    replays' tallies to 0."""
    from repro_torch.core import engine
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda, matrix_scan_cuda
    from repro_torch.kernels.lmme import lmme_cuda
    from repro_torch.serve import graphs

    engine.reset_calls()
    graphs.reset_replays()
    lmme_cuda.launches = 0
    lmme_cuda.launches_batched = 0
    matrix_scan_cuda.launches = 0
    matrix_scan_cuda.launches_zero_b = 0
    matrix_scan_cuda.kernels_zero_b = 0
    diagonal_scan_cuda.launches = 0


def read_counts():
    """(launches by kernel, engine calls by op) since ``reset_counts``, over
    eager calls, graph captures and graph replays: a replay moves no wrapper
    count, so each adds its graph's captured launches and calls."""
    from repro_torch.core import engine
    from repro_torch.serve import graphs

    launches = {k: v + graphs.replayed["launches"].get(k, 0)
                for k, v in graphs.kernel_launches().items()}
    calls = {k: v + graphs.replayed["calls"].get(k, 0) for k, v in engine.calls.items()}
    return launches, calls


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


#: the attention families served at full width (no GOOM kernel on their path)
FAMILIES = ["olmo-1b", "codeqwen1.5-7b", "phi3.5-moe", "mixtral-8x7b", "glm4-9b",
            "gemma3-1b"]
#: the kernels each served path launches (the others must not launch at all)
USED = {"shared_a": {"lmme"}, "generic": {"lmme", "matrix_scan"},
        "jamba-v0.1": {"diag_scan"}, "rwkv6-7b": {"lmme"},
        **{arch: set() for arch in FAMILIES}}


def serve_phase(cfg, model=None):
    """Serve the 6 requests through the graphed Engine at its default
    horizon (8): a warm-up pass on the same Engine captures its graphs and
    picks an EOS token, the prefix index is cleared, and the timed pass
    runs on replays alone.  Then the same requests through a k=1 Engine:
    tokens must be equal."""
    import torch

    from repro_torch import DecoderLM, Engine

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

    # warm-up pass: captures every graph (allocator, cuBLAS, the kernels'
    # libraries at their first warm-up run); it also picks the EOS token,
    # one a request first generates mid-decode
    eng = Engine(model, **SERVE)
    t0 = time.perf_counter()
    warm, _, _ = serve(model, requests(cfg.vocab), eng=eng)
    t_warm = time.perf_counter() - t0
    eos = pick_eos(warm)
    reqs = requests(cfg.vocab, eos=eos)
    eng._index.clear()   # the timed pass runs cold, as the warm-up did

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    results, reasons, stats = serve(model, reqs, timed=True, eng=eng)
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
    captured = eng.graphs.captured()
    del eng

    # the same requests at horizon 1: equal tokens
    res1, reasons1, stats1 = serve(model, requests(cfg.vocab, eos=eos), eos_scan_every=1)
    check(res1 == results and reasons1 == reasons,
          f"serve [{variant}]: horizon 1 and horizon 8 tokens differ")

    # what one eager decode step and one prefill chunk cost in launches,
    # and a look at the logits themselves
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
    # a replayed k-step decode stands for k eager steps' launches (the CPU
    # of a rehearsal captures nothing)
    check(DEVICE == "cpu" or {"prefill_chunk", "prefill_tail", "admit_chunk",
                              "admit_tail", "decode_k1", "decode_k8"} <= set(captured),
          f"serve [{variant}]: graphs captured {sorted(captured)}")
    for k in (1, 8) if captured else ():
        got = captured[f"decode_k{k}"]["launches"]
        check(all(got.get(n, 0) == k * v for n, v in per_decode.items()),
              f"serve [{variant}]: decode_k{k} graph launches {got}, eager step {per_decode}")

    ttft = stats["ttft_ms"]
    d8, d1 = stats["decode"], stats1["decode"]
    print(f"serve [{variant}]: {stats['tokens']} tokens in {stats['wall_s']:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s (graphed, horizon 8; warm-up pass with "
          f"{len(captured)} captures {t_warm:.1f} s); TTFT ms by request "
          + ", ".join(f"{u}:{ttft[u]:.1f}" for u in sorted(ttft))
          + f"; decode step {stats['decode_step_ms']:.3f} ms (median a token step, "
          f"4 slots); {stats['decode_steps']} decode steps; {stats['joined_late']} "
          f"requests joined mid-batch; peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"serve [{variant}]: horizon 8: {d8['dispatches']} dispatches, "
          f"{d8['tokens_per_dispatch']:.2f} tokens a dispatch, {d8['host_syncs']} host "
          f"syncs = {d8['syncs_per_token']:.3f} a token; horizon 1: {d1['dispatches']} "
          f"dispatches, {d1['host_syncs']} host syncs = {d1['syncs_per_token']:.3f} a "
          f"token, {stats1['tokens_per_s']:.1f} tokens/s (capture included); tokens "
          f"equal", flush=True)
    print(f"serve [{variant}]: finish reasons {reasons}; launches {launches} == "
          f"engine calls {calls} (captures and replays); launches per eager decode "
          f"step (4 slots) {per_decode}, per 64-token prefill chunk {per_chunk}; per "
          f"graph replay " + ", ".join(f"{n} {c['launches']}" for n, c in captured.items()),
          flush=True)
    return model, reqs, dict(stats, launches=launches, peak_bytes=peak,
                             per_decode=per_decode, per_chunk=per_chunk,
                             decode_k1=d1, tokens_per_s_k1=stats1["tokens_per_s"])


def _kernel_kinds(prof):
    """Kernels by kind in a profiler trace: the LMME, with-B matrix scan and
    diagonal scan kernels (by their names in csrc/), and all."""
    from torch.autograd import DeviceType

    kinds = {"lmme": 0, "matrix_scan": 0, "diag_scan": 0, "all": 0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kinds["all"] += 1
        if "lmme_" in e.name and "kernel" in e.name:
            kinds["lmme"] += 1
        elif "matrix_scan_" in e.name and "zero_b" not in e.name:
            kinds["matrix_scan"] += 1
        elif "diag_scan_kernel" in e.name:
            kinds["diag_scan"] += 1
    return kinds


#: profiler traces taken of a call before one that kept no device event stands
PROFILE_TRIES = 4


def _profiled(fn, iters):
    """A profiler trace of ``iters`` calls of ``fn``.  The profiler has been
    seen on an H100 to keep no device event at all in a trace (late in a
    long run: an eager step of some 5000 kernels, five calls of one
    product), so such a trace is taken again with a new profiler, up to
    ``PROFILE_TRIES`` in all; a trace still empty then is returned as it is,
    and every reader of device time fails on it (``_device_ms``,
    ``trace_phase``)."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            break
        print(f"profiler: no device event kept in {iters} calls (try {attempt + 1} of "
              f"{PROFILE_TRIES})", flush=True)
    return prof


def _timed(fn, iters):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def trace_phase(model, per_decode, eager=True):
    """Steady decode over 4 busy slots, graphed and (unless ``eager`` is
    False) eager, in one run.

    Graphed: the Engine's horizon-8 dispatches (a replayed graph each),
    timed by wall clock and profiled: per token step the wall, the device
    busy ms, kernels and idle share.  The profiler's count of LMME, with-B
    scan and diagonal-scan kernels in one replayed k=1 decode must equal the
    eager step's launches.  Eager: ``model.decode_step`` plus
    ``merge_frozen`` called directly, as the Engine before graphs ran it
    (with its per-step token read)."""
    import torch

    from repro_torch import Engine, Request
    from repro_torch.serve import merge_frozen

    variant = path_label(model.cfg)
    n_disp, k = 6, 8
    eng = Engine(model, **SERVE)
    for i in range(SERVE["max_slots"]):
        eng.submit(Request(uid=i, prompt=[i + 1], max_new_tokens=SERVE["page_len"] - 8))
    for _ in range(3):  # admission and the captures, then a warm dispatch
        eng.step()
    check(eng.decode_stats()["last_horizon"] == k, "trace: the horizon is not 8")
    wall = _timed(eng.step, n_disp) / k
    prof = _profiled(eng.step, n_disp)
    busy = _device_ms(prof) / (n_disp * k)
    kinds = _kernel_kinds(prof)
    parts = {n: _device_ms(prof, n) / (n_disp * k) for n in ("lmme", "matrix_scan", "diag_scan")}
    graphed = dict(step_ms=wall, busy_ms=busy, kernels=kinds["all"] / (n_disp * k),
                   idle=1 - busy / wall, **parts)
    for i in range(SERVE["max_slots"]):
        eng.cancel(i)

    # one replayed k=1 decode: its kernels, counted by the profiler
    fn = eng._decode_fn(1)
    args = (eng._tokens, eng._caches, eng._pos, eng._term, eng._blocks[1])
    eng.graphs.run("decode_k1", fn, *args)
    reps = 4
    names = ("lmme", "matrix_scan", "diag_scan")
    # the profiler drops a launch record now and then (182 of 192 LMME
    # kernels kept once): a trace short of kernels is taken again, and the
    # count must be exact in one of PROFILE_TRIES traces
    for attempt in range(PROFILE_TRIES):
        kinds1 = _kernel_kinds(_profiled(lambda: eng.graphs.run("decode_k1", fn, *args),
                                         reps))
        check(kinds1["all"], f"trace [{variant}]: the profiler kept no kernel of {reps} "
              f"replayed decode steps in {PROFILE_TRIES} tries")
        if all(kinds1[n] == reps * per_decode[n] for n in names):
            break
        print(f"trace [{variant}]: the profiler kept {[kinds1[n] for n in names]} of "
              f"{[reps * per_decode[n] for n in names]} kernels (try {attempt + 1} of "
              f"{PROFILE_TRIES})", flush=True)
    for name in names:
        check(kinds1[name] == reps * per_decode[name],
              f"trace [{variant}]: the profiler saw {kinds1[name]} {name} kernels in "
              f"{reps} replayed decode steps; an eager step launches {per_decode[name]}")
    del eng
    if not eager:
        print(f"trace [{variant}]: graphed (horizon 8) decode step (4 slots) "
              f"{wall:.3f} ms wall, device busy {busy:.3f} ms in {graphed['kernels']:.0f} "
              f"kernels; device idle share {graphed['idle']:.3f}", flush=True)
        return graphed

    # the eager step, as the Engine ran it before graphs
    b = SERVE["max_slots"]
    state = dict(caches=model.init_caches(b, SERVE["page_len"]),
                 tok=torch.arange(1, b + 1, device=DEVICE), pos=torch.zeros(
                     b, dtype=torch.long, device=DEVICE))
    live = torch.ones(b, dtype=torch.bool, device=DEVICE)

    @torch.no_grad()
    def eager_step():
        logits, stepped = model.decode_step(state["tok"][:, None], state["caches"],
                                            state["pos"])
        state["caches"] = merge_frozen(stepped, state["caches"], live)
        state["tok"] = torch.where(live, torch.argmax(logits[:, -1, :], dim=-1), state["tok"])
        state["pos"] = torch.where(live, state["pos"] + 1, state["pos"])
        state["tok"].tolist()

    eager_step()
    n_eager, n_prof = 8, 2   # timed steps; profiled steps (thousands of kernels each)
    e_wall = _timed(eager_step, n_eager)
    e_prof = _profiled(eager_step, n_prof)
    e_busy = _device_ms(e_prof) / n_prof
    eager = dict(step_ms=e_wall, busy_ms=e_busy,
                 kernels=_kernel_kinds(e_prof)["all"] / n_prof, idle=1 - e_busy / e_wall)
    for name, r in (("graphed (horizon 8)", graphed), ("eager", eager)):
        print(f"trace [{variant}]: {name} decode step (4 slots) {r['step_ms']:.3f} ms "
              f"wall, device busy {r['busy_ms']:.3f} ms in {r['kernels']:.0f} kernels; "
              f"device idle share {r['idle']:.3f}", flush=True)
    print(f"trace [{variant}]: graphed step's LMME {parts['lmme']:.3f} ms, matrix scan "
          f"{parts['matrix_scan']:.3f} ms, diagonal scan {parts['diag_scan']:.3f} ms; "
          f"a replayed k=1 decode holds {kinds1['lmme'] // reps} LMME, "
          f"{kinds1['matrix_scan'] // reps} with-B scan and {kinds1['diag_scan'] // reps} "
          f"diagonal-scan kernels (the eager step's launches)", flush=True)
    return dict(graphed, eager=eager)


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
        want, _, _ = serve(m32, reqs, backend="torch_reference")
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
# serving: prefix reuse, request control, the HTTP front door
# ---------------------------------------------------------------------------
PREFIX_LEN = 256            # 4 pages of 64, shared by the prefix requests
PREFIX_SUFFIXES = [17, 40, 64, 5, 33, 1]


def _streamed_ttft(eng, reqs):
    """Serve ``reqs`` one at a time through ``eng``, each streamed: TTFT ms
    (submit to the first token's event) and the tokens, by uid."""
    import torch

    from repro_torch import Request

    first, toks = {}, {}

    def on_event(uid, new, reason):
        first.setdefault(uid, time.perf_counter())
        toks.setdefault(uid, []).extend(new)

    eng.stream_callback = on_event
    ttft = {}
    for r in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                           stream=True))
        while eng.has_work:
            eng.step()
        ttft[r.uid] = (first[r.uid] - t0) * 1e3
        check(eng.pop_result(r.uid) == toks[r.uid], f"request {r.uid}: streamed tokens "
              "differ from the result")
    eng.stream_callback = None
    return ttft, toks


def prefix_phase(model):
    """Requests sharing a 256-token prefix (4 pages of 64), served one at a
    time through an Engine with prefix reuse and one without, both graphed
    and warmed on other prompts first: tokens equal, a hit rate above 0,
    and the TTFT of the hits against the miss."""
    import numpy as np

    from repro_torch import Engine, Request

    variant = path_label(model.cfg)
    rng = np.random.default_rng(SEED + 7)
    vocab = model.cfg.vocab
    shared = rng.integers(0, vocab, size=PREFIX_LEN).tolist()
    reqs = [Request(uid=i, prompt=shared + rng.integers(0, vocab, size=n).tolist(),
                    max_new_tokens=8) for i, n in enumerate(PREFIX_SUFFIXES)]
    warm = [Request(uid=f"w{n}", prompt=rng.integers(0, vocab, size=n).tolist(),
                    max_new_tokens=4) for n in (64, 65)]
    out = {}
    for reuse in (True, False):
        eng = Engine(model, prefix_reuse=reuse, **SERVE)
        _streamed_ttft(eng, warm)
        eng._index.clear()
        base = eng.prefix_stats()
        ttft, toks = _streamed_ttft(eng, reqs)
        st = eng.prefix_stats()
        out[reuse] = dict(ttft=ttft, toks=toks, hits=st["hits"] - base["hits"],
                          lookups=st["lookups"] - base["lookups"],
                          saved=st["prefill_tokens_saved"] - base["prefill_tokens_saved"])
        del eng
    on, off = out[True], out[False]
    check(on["toks"] == off["toks"], f"prefix [{variant}]: tokens with prefix reuse "
          "differ from those without")
    check(on["hits"] == len(reqs) - 1 and on["saved"] > 0 and off["hits"] == 0,
          f"prefix [{variant}]: hits {on['hits']}, tokens saved {on['saved']}")
    hits = range(1, len(reqs))
    hit_ttft = statistics.median(on["ttft"][i] for i in hits)
    res = dict(hit_rate=on["hits"] / on["lookups"], saved=on["saved"],
               ttft_miss_ms=on["ttft"][0], ttft_hit_ms=hit_ttft,
               ttft_no_reuse_ms=statistics.median(off["ttft"][i] for i in hits))
    print(f"prefix [{variant}]: {len(reqs)} requests sharing a {PREFIX_LEN}-token "
          f"prefix: hit rate {res['hit_rate']:.3f}, prefill tokens saved {on['saved']}; "
          f"TTFT ms: the miss {res['ttft_miss_ms']:.2f} ({off['ttft'][0]:.2f} without "
          f"reuse), the hits (median) {hit_ttft:.2f} ({res['ttft_no_reuse_ms']:.2f} for "
          f"the same requests without reuse); by request with / without reuse "
          + ", ".join(f"{i}:{on['ttft'][i]:.1f}/{off['ttft'][i]:.1f}" for i in on["ttft"])
          + "; tokens equal to the no-reuse engine's", flush=True)
    return res


def control_phase(model):
    """Cancel, deadline and streaming on the graphed Engine at full width."""
    from repro_torch import CANCELLED, Engine, Request

    vocab = model.cfg.vocab
    reqs = requests(vocab)
    eng = Engine(model, **SERVE)
    base = eng.run([Request(uid=r.uid, prompt=r.prompt, max_new_tokens=32)
                    for r in reqs[:3]])
    # cancel an active request: its slot frees at once
    for r in reqs[:3]:
        eng.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=32))
    eng.step()
    eng.step()
    check(eng.n_active == 3, f"control: {eng.n_active} active")
    check(eng.cancel(1) and eng.n_active == 2 and eng._alloc.n_used == 2,
          "control: cancel did not free the slot")
    while eng.has_work:
        eng.step()
    check(eng.result(1) is CANCELLED and eng.finish_reason(1) == "cancelled",
          "control: the cancelled request's result")
    check(eng.result(0) == base[0] and eng.result(2) == base[2],
          "control: the others' tokens changed when one was cancelled")
    for uid in range(3):
        eng.pop_result(uid)
    # a deadline passes mid-decode: "timeout" with partial output
    budget = SERVE["page_len"] - len(reqs[3].prompt)
    eng.submit(Request(uid="t", prompt=reqs[3].prompt, max_new_tokens=budget,
                       deadline_ms=40.0))
    while eng.has_work:
        eng.step()
    part, why = eng.result("t"), eng.finish_reason("t")
    eng.pop_result("t")
    full = eng.run([Request(uid="f", prompt=reqs[3].prompt, max_new_tokens=budget)])["f"]
    check(why == "timeout" and 0 < len(part) < budget and part == full[:len(part)],
          f"control: deadline gave {why} with {len(part)} tokens")
    # streamed tokens equal non-streamed ones
    _, toks = _streamed_ttft(eng, reqs[:3])
    check(all(toks[r.uid] == base[r.uid][:r.max_new_tokens] for r in reqs[:3]),
          "control: streamed tokens differ")
    print(f"control: cancel freed its slot (result CANCELLED), the others' tokens "
          f"unchanged; a 40 ms deadline gave \"timeout\" after {len(part)} of {budget} "
          f"tokens, a prefix of the full run; streamed tokens equal", flush=True)


def http_phase(model):
    """``BackgroundServer`` over the model on the card: 4 concurrent clients,
    2 streaming the prompts the other 2 ask without streaming; then one
    client hangs up mid-stream."""
    import threading

    import numpy as np

    from repro_torch import Engine
    from repro_torch.serve.api import BackgroundServer, Gateway
    from repro_torch.serve.api import client as api_client

    eng = Engine(model, **SERVE)
    srv = BackgroundServer(Gateway(eng, max_queue=16)).start()
    host, port = srv.host, srv.port
    try:
        rng = np.random.default_rng(SEED + 3)
        prompts = [rng.integers(0, model.cfg.vocab, size=min(n, SERVE["page_len"] // 4)).tolist()
                   for n in (70, 130)]
        api_client.completion(host, port, {"prompt": prompts[0][:65], "max_tokens": 4})
        out = [None] * 4

        def client(i):
            payload = {"prompt": prompts[i % 2], "max_tokens": 24}
            try:
                if i < 2:
                    out[i] = [e["choices"][0]["token"]
                              for e in api_client.stream_completion(host, port, payload)]
                else:
                    out[i] = api_client.completion(host, port, payload)["choices"][0]["tokens"]
            except Exception as e:  # reported by the check below
                out[i] = e

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        check(all(isinstance(o, list) and len(o) == 24 for o in out),
              f"http: client results {out}")
        check(out[0] == out[2] and out[1] == out[3],
              "http: streamed tokens differ from non-streamed ones")
        status = api_client.get_status(host, port)
        check("decode" in status and "prefix_cache" in status
              and status["decode"]["dispatches"] > 0, "http: /status sections")
        gen = api_client.stream_completion(host, port, {
            "prompt": prompts[1], "max_tokens": SERVE["page_len"] - len(prompts[1])})
        next(gen)
        gen.close()
        t_end = time.monotonic() + 30
        while time.monotonic() < t_end and (eng.has_work or srv.gateway.queue_depth()):
            time.sleep(0.01)
        status = api_client.get_status(host, port)
        cancelled = status["requests"]["by_finish_reason"].get("cancelled", 0)
        check(cancelled >= 1 and status["engine"]["n_active"] == 0,
              f"http: after a disconnect cancelled={cancelled}, "
              f"n_active={status['engine']['n_active']}")
    finally:
        srv.stop()
    dec = status["decode"]
    print(f"http: 4 concurrent clients (2 streaming) in {wall:.3f} s, streamed == "
          f"non-streamed; /status decode {dec['dispatches']} dispatches, "
          f"{dec['tokens_per_dispatch']:.2f} tokens a dispatch, prefix hits "
          f"{status['prefix_cache']['hits']}; a disconnect mid-stream: cancelled "
          f"{cancelled}, n_active 0; TTFT p50 {status['latency_ms']['ttft']['p50']:.2f} "
          f"ms", flush=True)
    return dict(wall_s=wall, status=status)


# ---------------------------------------------------------------------------
# phase 6: the paper's experiments 1 and 2
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


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------
# examples/train_goom_rnn_torch.py --full: Copy-Memory, B=16, S=128, AdamW
# at a cosine lr of peak 3e-3 over the example's 200 steps with 20 warm-up
# steps; of which this phase runs TRAIN_STEPS
TRAIN = dict(batch=16, seq_len=128, lr=3e-3, warmup=20, total=200)
TRAIN_STEPS = 2
#: goom-rnn-124m's layers in the train and remat phases by scan variant:
#: ``generic`` cut to 8 of 24 for the run's time (its dry-run cells alike)
TRAIN_LAYERS = {"shared_a": 24, "generic": 8}


def train_config(cfg, variant: str):
    """``cfg`` (goom-rnn-124m) in ``variant`` at TRAIN_LAYERS[variant]
    layers."""
    from repro_torch.launch.cost import with_periods

    return with_periods(with_scan_variant(cfg, variant), [TRAIN_LAYERS[variant]])
# f32 step on the kernels against the same step under the plain versions,
# from the seed weights: the loss within TRAIN_LOSS_RTOL; each leaf's
# max-normalised gradient gap max |g_kernel - g_plain| / max |g_plain|, at
# its worst leaf, within TRAIN_SPREAD_FACTOR times the larger of the two
# paths' own spread: the worst gap between a path's gradients at the seed
# weights and at weights moved one f32 ulp.  At full width the gradients of
# the first layers' A and B are that ill-conditioned: the plain version
# against itself one ulp apart differs by up to 1.3e-2 (a wrong backward is
# off by O(1)).
TRAIN_LOSS_RTOL = 1e-4
TRAIN_SPREAD_FACTOR = 2.0


def _train_setup(model):
    from repro_torch.train import AdamW, cosine_schedule, init_train_state

    opt = AdamW(cosine_schedule(TRAIN["lr"], TRAIN["warmup"], TRAIN["total"]))
    return opt, init_train_state(model, opt)


def _train_batches(cfg, n, batch=TRAIN["batch"], seq_len=TRAIN["seq_len"]):
    """``n`` Copy-Memory batches of ``cfg``'s vocab on the card."""
    import itertools

    from repro_torch.train import DataConfig, Prefetcher, SyntheticStream

    stream = SyntheticStream(DataConfig(task="copy", vocab=cfg.vocab, seq_len=seq_len,
                                        global_batch=batch, seed=SEED))
    return Prefetcher(itertools.islice(stream, n), DEVICE)


def _grads(model, batch):
    """(loss, gradients by parameter name) of one forward and backward."""
    import torch

    loss, _ = model.loss(batch["tokens"], batch["labels"])
    params = dict(model.named_parameters())
    return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _split_steps(model, state, opt, decay, batches, variant):
    """Train steps over ``batches``, each part timed by CUDA events: (ms
    lists by part, the forward's launches).  The backward and the update
    must launch no kernel."""
    import torch

    from repro_torch.train import clip_by_global_norm

    parts = {"forward": [], "backward": [], "optimizer": [], "wall": []}
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        reset_counts()
        t_wall = time.perf_counter()
        ev[0].record()
        loss, _ = model.loss(b["tokens"], b["labels"])
        ev[1].record()
        fwd_launches = read_counts()[0]
        grads = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
        ev[2].record()
        bwd_launches = read_counts()[0]
        grads, _ = clip_by_global_norm(grads, 1.0)
        opt.update(grads, state.opt_state, state.params, decay)
        ev[3].record()
        torch.cuda.synchronize()
        parts["wall"].append((time.perf_counter() - t_wall) * 1e3)
        for k, (a, z) in zip(("forward", "backward", "optimizer"), zip(ev, ev[1:])):
            parts[k].append(a.elapsed_time(z))
        check(bwd_launches == fwd_launches == read_counts()[0],
              f"train [{variant}]: launches after the forward {fwd_launches}, the "
              f"backward {bwd_launches}, the update {read_counts()[0]}")
    return parts, fwd_launches


def _profiled_device(fn):
    """(result, device ms, kernels, profiler) of one call of ``fn``."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    n_dev = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    return out, _device_ms(prof), n_dev, prof


def plain_backward_ms(prof) -> float:
    """Device ms under the autograd engine's evaluation of the LMME and
    matrix-scan wrappers' nodes, whose backward is autograd of the plain
    versions (each node's own record sits inside its evaluation: only the
    evaluation is counted)."""
    keys = tuple(f"autograd::engine::evaluate_function: {n}"
                 for n in ("_LmmeFnBackward", "_MatrixScanFnBackward"))
    return sum(e.device_time_total for e in prof.key_averages() if e.key in keys) / 1e3


def train_phase(cfg, model):
    """goom-rnn-124m trained at full width through ``make_train_step``:
    TRAIN_STEPS steps of the 124M model (loss finite, launches == the
    forward's engine calls), then each part of a step timed by CUDA events
    (median of 2), one step profiled part by part, and one step at f32 on
    the kernels against the same step under the plain versions."""
    import torch

    from repro_torch.core import engine
    from repro_torch.train import clip_by_global_norm, make_train_step

    variant = path_label(cfg)
    t_phase = time.perf_counter()
    gap = _train_parity(model, cfg, next(iter(_train_batches(cfg, 1))))
    parity_s = time.perf_counter() - t_phase
    opt, state = _train_setup(model)
    step_fn = make_train_step(model, opt)
    decay = opt.decay_mask(cfg, list(state.params))
    warm, n_split = 2, 2
    batches = list(_train_batches(cfg, warm + TRAIN_STEPS + 2 * n_split + 1))
    t0 = time.perf_counter()
    for b in batches[:warm]:   # allocator, cuBLAS, the kernels' first calls
        state, _ = step_fn(state, b)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for b in batches[warm:warm + TRAIN_STEPS]:
        state, metrics = step_fn(state, b)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches, calls = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches, calls, f"train [{variant}]", USED[variant])
    losses = [float(v) for v in losses]
    check(all(map(math.isfinite, losses)), f"train [{variant}]: a loss is not finite: {losses}")

    # each part of a step by CUDA events; launches of the forward alone, and
    # none in the backward or the update
    split = batches[warm + TRAIN_STEPS:]
    parts, fwd_launches = _split_steps(model, state, opt, decay, split[:n_split], variant)
    # the same under the plain versions: forward and backward both plain
    # autograd, the kernels' forward not recomputed in the backward
    with engine.use_backend("torch_reference"):
        plain_parts, _ = _split_steps(model, state, opt, decay, split[n_split:2 * n_split],
                                      variant)
    med = {k: statistics.median(v) for k, v in parts.items()}
    plain_med = {k: statistics.median(v) for k, v in plain_parts.items()}
    per_step = {k: v // TRAIN_STEPS for k, v in launches.items()}
    check(per_step == fwd_launches and all(v % TRAIN_STEPS == 0 for v in launches.values()),
          f"train [{variant}]: {launches} over {TRAIN_STEPS} steps != {TRAIN_STEPS} x the "
          f"forward's {fwd_launches}")

    # one step profiled part by part: device busy, kernels, and the device
    # time the backward spends in the plain versions' autograd
    b = batches[-1]
    (loss, _), f_ms, f_n, _ = _profiled_device(lambda: model.loss(b["tokens"], b["labels"]))
    params = list(state.params.values())
    grads, b_ms, b_n, b_prof = _profiled_device(lambda: torch.autograd.grad(loss, params))
    plain_ms = plain_backward_ms(b_prof)
    grads = dict(zip(state.params, grads))

    def update():
        g, _ = clip_by_global_norm(grads, 1.0)
        return opt.update(g, state.opt_state, state.params, decay)

    _, o_ms, o_n, _ = _profiled_device(update)
    busy = f_ms + b_ms + o_ms
    idle = 1 - busy / med["wall"]
    print(f"train [{variant}]: {cfg.name} ({cfg.n_layers} layers) B={TRAIN['batch']} "
          f"S={TRAIN['seq_len']}, "
          f"{TRAIN_STEPS} steps at {step_ms:.1f} ms a step (wall; warm-up "
          f"{warm} steps {warm_s:.1f} s); loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"all finite; peak memory {peak / 2**30:.2f} GiB", flush=True)
    for label, m in (("kernels", med), ("plain versions", plain_med)):
        print(f"train [{variant}]: median of {n_split} steps by CUDA events, {label}: "
              f"step {m['wall']:.1f} ms wall, forward {m['forward']:.1f} ms, backward "
              f"{m['backward']:.1f} ms, optimizer {m['optimizer']:.1f} ms", flush=True)
    print(f"train [{variant}]: one step profiled: device busy {busy:.3f} ms (forward "
          f"{f_ms:.3f} in {f_n} kernels, backward {b_ms:.3f} in {b_n}, optimizer "
          f"{o_ms:.3f} in {o_n}), idle share {idle:.3f}; backward in the plain "
          f"versions' autograd (LMME, matrix scan) {plain_ms:.3f} ms", flush=True)
    print(f"train [{variant}]: launches {launches} == engine calls {calls}; per "
          f"step {per_step} (the forward's; backward and update launch none); "
          f"phase {time.perf_counter() - t_phase:.1f} s, of which the parity "
          f"steps {parity_s:.1f} s", flush=True)

    return dict(launches=launches, per_step=per_step, step_ms=step_ms, parts=med,
                kernels=f_n + b_n + o_n,
                plain_parts=plain_med,
                busy_ms=busy, idle=idle, plain_bwd_ms=plain_ms, peak_bytes=peak,
                losses=losses, **gap)


def _grad_gaps(got, want):
    """Each leaf's max |got - want| / max |want|."""
    return {n: float((got[n] - want[n]).abs().max() / want[n].abs().max().clamp_min(1e-30))
            for n in want}


def _worst(gaps):
    return max(gaps.items(), key=lambda kv: kv[1])


def _train_parity(model, cfg, batch):
    """One f32 step's loss and gradients on the kernels against the same
    under ``use_backend("torch_reference")``, same weights and batch, held to
    each path's own spread (module constants above); and on the kernels
    under ``remat="full"`` against ``cfg``'s ``"none"``, held to the
    kernels' spread (``remat_phase`` reports it)."""
    import torch

    from repro_torch.core import engine

    variant = path_label(cfg)
    params = dict(model.named_parameters())
    seed_weights = {n: p.detach().clone() for n, p in params.items()}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)

    def both():
        out = {}
        for path, backend in (("kernels", "auto"), ("plain", "torch_reference")):
            with engine.use_backend(backend):
                loss, grads = _grads(model, batch)
            out[path] = (float(loss.detach()), grads)
        return out

    f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    try:
        model.cfg = dataclasses.replace(f32, remat="full")
        loss_r, g_r = _grads(model, batch)
        remat_full = (float(loss_r.detach()), g_r)
        del loss_r, g_r
        model.cfg = f32
        at_seed = both()
        with torch.no_grad():   # every weight one f32 ulp up or down
            for p in params.values():
                up = torch.rand(p.shape, generator=gen, device=DEVICE) < 0.5
                p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
        moved = both()
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(seed_weights[n])
    finally:
        model.cfg = cfg
    (loss_k, g_k), (loss_p, g_p) = at_seed["kernels"], at_seed["plain"]
    loss_gap = abs(loss_k - loss_p) / abs(loss_p)
    worst = _worst(_grad_gaps(g_k, g_p))
    spread = {path: _worst(_grad_gaps(moved[path][1], at_seed[path][1]))
              for path in at_seed}
    bound = TRAIN_SPREAD_FACTOR * max(v for _, v in spread.values())
    print(f"train [{variant}] parity (f32, seed weights, kernels vs plain versions on "
          f"the card): loss {loss_k:.6f} vs {loss_p:.6f} (relative gap {loss_gap:.2e}, "
          f"bound {TRAIN_LOSS_RTOL:.0e}); worst max-normalised grad gap {worst[1]:.2e} "
          f"at {worst[0]}; each path's spread, weights one ulp apart: plain "
          f"{spread['plain'][1]:.2e} at {spread['plain'][0]}, kernels "
          f"{spread['kernels'][1]:.2e} at {spread['kernels'][0]}; bound {bound:.2e}",
          flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
          f"train [{variant}]: a kernel gradient is not finite")
    check(loss_gap <= TRAIN_LOSS_RTOL, f"train [{variant}]: f32 loss on the kernels "
          f"{loss_k} vs plain {loss_p}")
    check(worst[1] <= bound, f"train [{variant}]: grad of {worst[0]} on the kernels off "
          f"the plain version's by {worst[1]:.3e} > {bound:.3e}")

    r_gap = abs(remat_full[0] - loss_k) / abs(loss_k)
    r_worst = _worst(_grad_gaps(remat_full[1], g_k))
    r_bound = TRAIN_SPREAD_FACTOR * spread["kernels"][1]
    print(f"remat [{variant}] parity (f32, seed weights, kernels): full loss "
          f"{remat_full[0]:.6f} vs none {loss_k:.6f} (relative gap {r_gap:.2e}); worst "
          f"max-normalised grad gap {r_worst[1]:.2e} at {r_worst[0]}; none's spread one ulp "
          f"apart {spread['kernels'][1]:.2e} at {spread['kernels'][0]}; bound {r_bound:.2e}",
          flush=True)
    check(r_gap <= TRAIN_LOSS_RTOL, f"remat [{variant}]: f32 loss full {remat_full[0]} vs "
          f"none {loss_k}")
    check(r_worst[1] <= r_bound, f"remat [{variant}]: grad of {r_worst[0]} under full off "
          f"none's by {r_worst[1]:.3e} > {r_bound:.3e}")
    return dict(loss_gap=loss_gap, grad_err=worst[1], grad_err_at=worst[0],
                plain_spread=spread["plain"][1], kernel_spread=spread["kernels"][1],
                remat_loss_gap=r_gap, remat_grad_err=r_worst[1])


# ---------------------------------------------------------------------------
# phase 5b: remat (LMConfig.remat) on the train step
# ---------------------------------------------------------------------------
REMATS = ("none", "full", "dots")
#: steps a remat setting is timed over, after one warm-up step
REMAT_STEPS = 1


def _busy_ms(fn):
    """(device ms, kernels) of one call of ``fn`` from a trace of the card's
    activity alone: goom-rnn-124m's train step (29.8k kernels) traced in
    5.3 s this way against 15.6 s with the host's ops (``_profiled_device``),
    busy ms within 0.2 % (``tools/train_card_probe.py``; NVIDIA H100 80GB
    HBM3, 700.00 W).  A trace that kept no device event is taken again, as
    ``_profiled`` does, up to PROFILE_TRIES in all."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
    check(events, "the profiler saw no device work; device times not measured")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events)


def remat_phase(cfg, model, train):
    """goom-rnn-124m's train step at full width (B=16, S=128, bf16) under
    ``none``, ``full`` and ``dots``, each alike from a fresh optimizer state:
    one warm-up step, then the memory allocated after ``free_memory`` and a
    peak reset (the floor: weights and state), the wall ms a step (median of
    REMAT_STEPS), the peak GiB over those steps (``max_memory_allocated``)
    and the kernels' launches a step (``full`` and ``dots`` re-run the
    forward's GOOM kernels in the backward: twice ``none``'s), then one
    step's device-busy ms (``_busy_ms``).  The f32 gradients under ``full``
    against ``none`` were held in ``train_phase`` (``train``)."""
    import torch

    from repro_torch.train import make_train_step

    variant = path_label(cfg)
    out = {}
    batches = list(_train_batches(cfg, 1 + REMAT_STEPS + 1))
    try:
        for remat in REMATS:
            model.cfg = dataclasses.replace(cfg, remat=remat)
            opt, state = _train_setup(model)
            step_fn = make_train_step(model, opt)
            state, _ = step_fn(state, batches[0])
            torch.cuda.synchronize()
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            floor = torch.cuda.memory_allocated()
            reset_counts()
            walls = []
            for b in batches[1:1 + REMAT_STEPS]:
                t0 = time.perf_counter()
                state, metrics = step_fn(state, b)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            launches, calls = read_counts()
            check_launches(launches, calls, f"remat {remat} [{variant}]", USED[variant])
            per_step = {k: v // REMAT_STEPS for k, v in launches.items()}
            busy, n_dev = _busy_ms(lambda: step_fn(state, batches[-1]))
            check(math.isfinite(float(metrics["loss"])), f"remat {remat} [{variant}]: loss")
            out[remat] = dict(step_ms=statistics.median(walls), busy_ms=busy, kernels=n_dev,
                              peak_gib=peak / 2**30, floor_gib=floor / 2**30,
                              per_step=per_step, launches=launches)
            del state, opt, step_fn
            free_memory()
    finally:
        model.cfg = cfg
    none = out["none"]["per_step"]
    check(none == train["per_step"], f"remat none [{variant}]: launches a step {none} != "
          f"train_phase's {train['per_step']}")
    for remat in ("full", "dots"):
        check(out[remat]["per_step"] == {k: 2 * v for k, v in none.items()},
              f"remat {remat} [{variant}]: launches a step {out[remat]['per_step']} != "
              f"twice none's {none}")
    check(out["full"]["peak_gib"] < out["none"]["peak_gib"],
          f"remat [{variant}]: full's peak {out['full']['peak_gib']:.2f} GiB is not below "
          f"none's {out['none']['peak_gib']:.2f}")
    for remat, r in out.items():
        print(f"remat {remat} [{variant}]: step {r['step_ms']:.1f} ms wall (median of "
              f"{REMAT_STEPS}), {r['busy_ms']:.3f} ms device busy in {r['kernels']} kernels, "
              f"peak {r['peak_gib']:.2f} GiB over {r['floor_gib']:.2f} allocated at the "
              f"reset, launches a step {r['per_step']}; {card_line()}", flush=True)
    return dict(out, remat_grad_err=train["remat_grad_err"],
                remat_spread=train["kernel_spread"])


# ---------------------------------------------------------------------------
# phase 5a: the dry-run's prediction of the train step against the card
# ---------------------------------------------------------------------------
#: the dry-run's train cells: goom-rnn-124m at train_phase's shape, each
#: variant under these remat settings, on a (1, 1) mesh
DRYRUN_REMATS = ("none", "full")
#: the predicted peak above the parameters and optimizer state, against
#: the measured peak above the floor: within this factor either way (the
#: card read ratios of 0.995-1.000 at PR 22)
DRYRUN_PEAK_FACTOR = 1.05
#: the measured device-busy ms over the roofline step (the largest term):
#: within this band (the card read 5.4-9.2 at PR 22: a step of some 30-46k
#: small kernels sits well above its floor), so that a count wrong by a
#: large factor either way fails
DRYRUN_BUSY_BAND = (3.0, 15.0)
DRYRUN_OUT = str(ROOT / "build" / "chip_smoke_dryrun.json")


def dryrun_cells(out: str) -> None:
    """The dry-run of goom-rnn-124m's train step (``launch.dryrun.lower_cell``
    on fake tensors: no device) at train_phase's B and S, bf16 compute, on a
    (1, 1) mesh, for both variants (``train_config``) under
    ``DRYRUN_REMATS``, of ``long_attention_phase``'s prefill
    (``long_dryrun_cell``), of ``dist_launcher_phase``'s FSDP ranks
    (``fsdp_dryrun_cells``) and of ``model_axis_phase``'s (1, 2) ranks
    (``model_axis_dryrun_cells``); written to ``out`` as {"train": {variant:
    {remat: Roofline dict}}, "long_prefill": Roofline dict, "fsdp": {P:
    Roofline dict}, "model_axis": {"train", "prefill": Roofline dict}}.  Run in a process of its own with one thread and no
    card (``start_dryrun``)."""
    import torch

    from repro_torch import get_config
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.sharding import NamedMesh

    torch.set_num_threads(1)
    cfg = get_config("goom-rnn-124m")
    shape = ShapeCfg("chip_train", TRAIN["seq_len"], TRAIN["batch"], "train")
    mesh = NamedMesh((1, 1), ("data", "model"))
    train = {v: {r: lower_cell(train_config(cfg, v), shape, mesh, verbose=False,
                               perf={"remat": r, "microbatches": 1}).to_dict()
                 for r in DRYRUN_REMATS}
             for v in ("shared_a", "generic")}
    res = {"train": train, "long_prefill": long_dryrun_cell(), "fsdp": fsdp_dryrun_cells(),
           "model_axis": model_axis_dryrun_cells()}
    with open(out, "w") as f:
        json.dump(res, f)


def start_dryrun():
    """``dryrun_cells`` in a child process on the host alone (no card
    visible, one thread), started before the build so that it overlaps the
    build and kernel phases."""
    import atexit
    import os

    (ROOT / "build").mkdir(exist_ok=True)
    if os.path.exists(DRYRUN_OUT):
        os.remove(DRYRUN_OUT)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    log = open(DRYRUN_OUT + ".log", "w")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-cells",
                             DRYRUN_OUT], env=env, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def join_dryrun(proc, timeout: float = 600.0) -> dict:
    """The child's cells; its output goes to ours, and a failure fails here."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"dryrun: the dry-run took over {timeout:.0f} s")
    with open(DRYRUN_OUT + ".log") as f:
        print(f.read().strip(), flush=True)
    check(proc.returncode == 0, f"dryrun: the dry-run exited with {proc.returncode}")
    with open(DRYRUN_OUT) as f:
        return json.load(f)


GOOMCHECK_OUT = str(ROOT / "build" / "goomcheck_torch.json")
#: the graph targets of goomcheck's repo mode (analysis/targets.py)
GOOMCHECK_TARGETS = 16


def start_goomcheck():
    """``python -m repro_torch.analysis --ci --device cuda`` in a child
    process (the card visible, one thread), started with the dry-run so
    that it overlaps the build and kernel phases; it walks fake CUDA
    tensors and launches nothing.  The process's ``started`` and, once it
    has ended, ``ended`` are ``time.perf_counter()`` readings."""
    import atexit
    import os
    import threading

    (ROOT / "build").mkdir(exist_ok=True)
    if os.path.exists(GOOMCHECK_OUT):
        os.remove(GOOMCHECK_OUT)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    log = open(GOOMCHECK_OUT + ".log", "w")
    started = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.analysis", "--ci",
                             "--device", "cuda", "--json", GOOMCHECK_OUT], cwd=ROOT,
                            env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.started = started
    atexit.register(lambda: proc.poll() is None and proc.kill())

    def watch():
        proc.wait()
        proc.ended = time.perf_counter()

    threading.Thread(target=watch, daemon=True).start()
    return proc


def join_goomcheck(proc, timeout: float = 300.0) -> dict:
    """The child's counts; it must exit 0 with no active finding, no skip
    and every target walked."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"goomcheck: the child took over {timeout:.0f} s")
    with open(GOOMCHECK_OUT + ".log") as f:
        out = f.read().strip()
    check(proc.returncode == 0, f"goomcheck: exited with {proc.returncode}:\n{out}")
    with open(GOOMCHECK_OUT) as f:
        rep = json.load(f)
    active = [x for x in rep["findings"] if not x["suppressed"]]
    counts = {"targets": len(rep["targets"]), "findings": len(active),
              "suppressed": len(rep["findings"]) - len(active),
              "skips": len(rep["skips"]), "ops": sum(t["ops"] for t in rep["targets"]),
              "seconds": getattr(proc, "ended", time.perf_counter()) - proc.started}
    check(rep["ok"] and not active, f"goomcheck: active findings {active}")
    check(not rep["skips"], f"goomcheck: skipped targets {rep['skips']}")
    check(counts["targets"] == GOOMCHECK_TARGETS and
          all(t["ops"] > 0 for t in rep["targets"]),
          f"goomcheck: walked {rep['targets']}")
    print("goomcheck: --device cuda, {targets} targets ({ops} aten ops walked), "
          "{findings} findings, {suppressed} suppressed, {skips} skips, "
          "{seconds:.1f} s".format(**counts), flush=True)
    return counts


def dryrun_phase(dry: dict, remat: dict) -> dict:
    """The dry-run's train cells against ``remat_phase``'s measurements, per
    variant and remat setting: the predicted GOOM launches a step equal the
    measured; the measured device-busy ms over the roofline step time (the
    largest of the three terms) lies in DRYRUN_BUSY_BAND; the predicted peak
    above the parameters and optimizer state is within DRYRUN_PEAK_FACTOR
    either way of the measured peak above the floor.  Beside busy it prints
    the memory term of every op's reads and writes (``hlo_bytes_upper``),
    which the roofline's memory term (bytes written) replaced.  Returns the
    ratios."""
    from repro_torch.launch.roofline import HBM_BW

    out = {}
    for variant, cells in dry.items():
        for r, cell in cells.items():
            got = remat[variant][r]
            where = f"dryrun {r} [{variant}]"
            predicted = {k: int(v) for k, v in cell["launches"].items()}
            measured = {k: int(got["per_step"].get(k, 0)) for k in predicted}
            check(predicted == measured, f"{where}: predicted launches a step {predicted} != "
                  f"measured {measured}")
            roof_ms = 1e3 * max(cell["compute_s"], cell["memory_s"], cell["collective_s"])
            upper_ms = 1e3 * cell["hlo_bytes_upper"] / (cell["chips"] * HBM_BW)
            lo, hi = DRYRUN_BUSY_BAND
            check(lo <= got["busy_ms"] / roof_ms <= hi,
                  f"{where}: busy {got['busy_ms']:.3f} ms over the roofline step "
                  f"{roof_ms:.3f} ms is {got['busy_ms'] / roof_ms:.2f}, outside [{lo}, {hi}]: "
                  "a count is wrong")
            above = cell["memory_per_device"]["above_state_bytes"] / 2**30
            measured_above = got["peak_gib"] - got["floor_gib"]
            ratio = above / measured_above
            check(1 / DRYRUN_PEAK_FACTOR <= ratio <= DRYRUN_PEAK_FACTOR,
                  f"{where}: predicted {above:.2f} GiB above the state against the measured "
                  f"{measured_above:.2f} above the floor (ratio {ratio:.3f})")
            out[(variant, r)] = dict(busy_over_roofline=got["busy_ms"] / roof_ms,
                                     busy_over_upper=got["busy_ms"] / upper_ms,
                                     peak_ratio=ratio)
            print(f"{where}: roofline compute {1e3 * cell['compute_s']:.3f} ms, memory "
                  f"{1e3 * cell['memory_s']:.3f} ms, collective {1e3 * cell['collective_s']:.3f}"
                  f" ms -> step {roof_ms:.3f} ms ({cell['bottleneck']}) against "
                  f"{got['busy_ms']:.3f} ms busy: busy / roofline {got['busy_ms'] / roof_ms:.2f};"
                  f" memory of reads and writes {upper_ms:.3f} ms (busy / it "
                  f"{got['busy_ms'] / upper_ms:.2f});"
                  f" predicted {above:.3f} GiB above the state against {measured_above:.3f} "
                  f"measured above the floor (ratio {ratio:.3f}); launches a step {predicted} "
                  f"equal; dry-run host {cell['host_s']:.1f} s; {card_line()}", flush=True)
    return out


def dryrun_summary(ratios: dict, card: str) -> str:
    """The summary line of ``dryrun_phase``'s ratios."""
    return ("summary [dryrun]: goom-rnn-124m train step (B={batch}, S={seq}) against its "
            "dry-run: ".format(batch=TRAIN["batch"], seq=TRAIN["seq_len"])
            + "; ".join(f"{v} {r} busy / roofline {x['busy_over_roofline']:.2f} (over reads "
                        f"and writes {x['busy_over_upper']:.2f}), predicted / "
                        f"measured peak above the state {x['peak_ratio']:.3f}"
                        for (v, r), x in ratios.items())
            + f"; launches a step equal; {card}")


def jamba_float_phase():
    """Jamba smoke at f32 on the card with Mamba's ``scan_impl="float"``
    (the conventional baseline: no diagonal-scan launch, by design) and
    ``"goom"`` (the diagonal-scan kernel) on the same weights: logits
    finite, float within 1e-4·std of goom's, and within 1e-5·std of the
    float path on the CPU."""
    import torch

    from repro_torch import DecoderLM
    from repro_torch.configs import jamba_v01

    args = (64, 8, 4, 2, 128, 256, 4, "jamba-v0.1-smoke")
    out, launches = {}, {}
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, 256, (2, 40), generator=gen)
    weights = None
    for impl in ("float", "goom"):
        cfg = dataclasses.replace(jamba_v01._make(*args, d_state=4, chunk=8, scan_impl=impl),
                                  compute_dtype=torch.float32)
        model = DecoderLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        if weights is None:
            weights = model.state_dict()
        model.load_state_dict(weights)
        reset_counts()
        with torch.no_grad():
            out[impl] = model(tokens.to(DEVICE)).float()
        torch.cuda.synchronize()
        launches[impl] = read_counts()[0]
        if impl == "float":
            cpu = DecoderLM(cfg, device="cpu")
            cpu.load_state_dict({k: v.cpu() for k, v in weights.items()})
            with torch.no_grad():
                ref = cpu(tokens)
    std = float(out["goom"].std())
    vs_goom = float((out["float"] - out["goom"]).abs().max()) / std
    vs_cpu = float((out["float"].cpu() - ref).abs().max()) / std
    check(all(bool(torch.isfinite(v).all()) for v in out.values()), "jamba float: logits")
    check(launches["float"]["diag_scan"] == 0 and launches["goom"]["diag_scan"] > 0,
          f"jamba float: diagonal-scan launches {launches}")
    check(vs_goom <= 1e-4 and vs_cpu <= 1e-5, f"jamba float: {vs_goom:.2e}·std from goom, "
          f"{vs_cpu:.2e}·std from the CPU")
    print(f"jamba float (smoke, f32, on the card): logits {vs_goom:.2e}·std from the goom "
          f"scan's, {vs_cpu:.2e}·std from the float path on the CPU; diagonal-scan launches "
          f"float {launches['float']['diag_scan']}, goom {launches['goom']['diag_scan']}",
          flush=True)
    return launches["goom"]


# ---------------------------------------------------------------------------
# phase 5c: DTensor layouts on the card
# ---------------------------------------------------------------------------
def layouts_phase():
    """goom-rnn-124m's full-width f32 train step with its parameters laid
    out as DTensors (``distribute_model``) over a 1-rank ("data", "model")
    ``DeviceMesh`` on the card, under the rules, against the plain path on
    the same weights and batch: the same loss and the same kernel launches,
    both variants.  Several ranks, gloo's sharing the card, run in
    ``dist_launcher_phase`` (NCCL takes one rank a card)."""
    import torch
    import torch.distributed as dist

    from repro_torch import DecoderLM, get_config
    from repro_torch.launch.mesh import free_port, make_host_mesh
    from repro_torch.sharding import distribute_model, make_rules, use_rules
    from repro_torch.train import make_train_step

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = make_host_mesh(device_type="cuda")
        rules = make_rules(mesh)
        base = dataclasses.replace(get_config("goom-rnn-124m"), compute_dtype=torch.float32)
        batch = next(iter(_train_batches(base, 1)))
        for variant in ("shared_a", "generic"):
            cfg = with_scan_variant(base, variant)
            res = {}
            for laid in (False, True):
                model = DecoderLM(cfg, device=DEVICE,
                                  generator=torch.Generator(device=DEVICE).manual_seed(SEED))
                if laid:
                    distribute_model(model, rules)
                opt, state = _train_setup(model)
                step = make_train_step(model, opt, rules=rules if laid else None)
                reset_counts()
                with use_rules(rules if laid else None):
                    state, m = step(state, batch)
                torch.cuda.synchronize()
                res[laid] = (float(m["loss"]), float(m["grad_norm"]), read_counts()[0])
                del model, opt, state, step
                free_memory()
            (l0, g0, k0), (l1, g1, k1) = res[False], res[True]
            check(abs(l1 - l0) <= 1e-6 * abs(l0) and k1 == k0,
                  f"layouts [{variant}]: loss {l1!r} vs plain {l0!r}, launches {k1} vs {k0}")
            print(f"layouts [{variant}] (1-rank DeviceMesh on the card, f32, full width, "
                  f"remat full): loss {l1!r} vs plain {l0!r}, grad norm {g1!r} vs {g0!r}; "
                  f"launches {k1} == plain's", flush=True)
            out[variant] = k1
    finally:
        dist.destroy_process_group()
    return out


def launcher_phase():
    """The user's command, ``python -m repro_torch.launch.train``, at full
    width: a step and a checkpoint, then a restart that resumes from it and
    takes a second; the checkpoint is deleted after."""
    import shutil

    from repro_torch.launch import train as launch_train

    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "goom-rnn-124m", "--task", "copy", "--seq-len",
            str(TRAIN["seq_len"]), "--batch", str(TRAIN["batch"]), "--lr",
            str(TRAIN["lr"]), "--log-every", "1", "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    try:
        _, s1, _ = launch_train.main(argv + ["--steps", "1"])
        t1 = time.perf_counter()
        _, s2, m2 = launch_train.main(argv + ["--steps", "2"])
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(s1.step == 1 and s2.step == 2 and math.isfinite(float(m2["loss"])),
          f"launcher: steps {s1.step}, {s2.step}, loss {float(m2['loss'])}")
    print(f"launcher: a step and a checkpoint in {t1 - t0:.1f} s; resumed and took "
          f"step 2 in {t2 - t1:.1f} s (model build and checkpoint I/O included)",
          flush=True)


# ---------------------------------------------------------------------------
# phase 12: sequence-sharded scans on gloo ranks that share the card
# ---------------------------------------------------------------------------
SHARDED_P = (2, 4)
#: name, op: goom-rnn's training shape with B, the d = 128 chain (T = 2001
#: pads at P = 4), Mamba's d_inner x d_state over 512 steps, and the
#: Lorenz spectrum's reset scan over 4096 steps
SHARDED_CASES = ("with-B (T=128,G=48,d=16,m=16) e±200 signed",
                 "cumulative_lmme d=128 chain (T=2001)",
                 "diagonal (T=512, C=8192x16)",
                 "selective_reset lorenz63 spectrum (T=4096, d=3)")
#: cases 0-2 are signed: each rank's distance to float64 (over each entry's
#: cancellation-free scale) within twice the single-process kernel call's or
#: the plain version's, floor 1e-6, as the kernel phases hold signed scans;
#: the reset scan's states within SHARDED_BAR relative log error of the
#: plain version's at the same shard count (test_sharded's bar for it)
SHARDED_BAR = 1e-4
#: each case's sizes: (T, G, d, m), (T, d), (T, C, state), T
SHARDED_SHAPES = ((128, 48, 16, 16), (2001, 128), (512, 8192, 16), 4096)


def _sharded_operands(case, gen, shapes):
    """The operands of one sharded case, made alike on every rank."""
    import torch

    from repro_torch.core.goom import Goom, to_goom

    size = shapes[case]
    if case == 0:   # signed, each step's A shifted by e^+200 or e^-200
        t, g, d, m = size
        a = to_goom(torch.randn(t, g, d, d, generator=gen, device=DEVICE))
        shift = 200.0 * torch.where(
            torch.rand(t, 1, 1, 1, generator=gen, device=DEVICE) < 0.5, -1.0, 1.0)
        return (Goom(a.log_abs + shift, a.sign),
                to_goom(torch.randn(t, g, d, m, generator=gen, device=DEVICE)),
                to_goom(torch.randn(g, d, m, generator=gen, device=DEVICE)))
    if case == 1:
        from repro_torch.core.chains import chain_matrices

        t, d = size
        return (to_goom(chain_matrices(gen, d, t, device=DEVICE)),)
    if case == 2:
        t, c, n = size
        dt = torch.rand(t, c, 1, generator=gen, device=DEVICE) * 0.1
        a_log = -dt * torch.arange(1, n + 1, device=DEVICE, dtype=torch.float32)
        b = torch.randn(t, c, n, generator=gen, device=DEVICE)
        x0 = torch.randn(c, n, generator=gen, device=DEVICE)
        return Goom(a_log, torch.ones_like(a_log)), to_goom(b), to_goom(x0)
    from repro_torch.core.lyapunov import SYSTEMS, trajectory_and_jacobians

    _, js = trajectory_and_jacobians(SYSTEMS["lorenz63"], size, device="cpu")
    return (js.to(DEVICE),)


def _sharded_call(case, args):
    """The engine op of one case: the states (and the reset flags)."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.goom import to_goom
    from repro_torch.core.scan import colinearity_select, orthonormal_reset

    if case == 0:
        return engine.matrix_scan(*args), None
    if case == 1:
        return engine.cumulative_lmme(*args), None
    if case == 2:
        return engine.diagonal_scan(*args), None
    js = args[0]
    eye = torch.eye(3, dtype=js.dtype, device=js.device)
    return engine.selective_reset_scan(to_goom(torch.cat([eye[None], js[:-1]])),
                                       colinearity_select(0.99), orthonormal_reset())


def _assoc_combines(n: int) -> int:
    """Combines ``core.scan.associative_scan`` makes over n elements."""
    return 0 if n < 2 else 1 + _assoc_combines(n // 2) + (n > 2)


def sharded_launches(case, t, p):
    """The kernel launches one sharded call makes on a rank, by the algebra:
    with B, one local with-B scan, one local zero-B scan (A*) and one LMME
    (the stitch); prefix products, one zero-B scan and one LMME; the diagonal
    scan, one local scan; the reset scan, two LMMEs a combine of the local
    scan over T/P, of the P-carry scan and of the stitch."""
    zero = {"lmme": 0, "matrix_scan": 0, "matrix_scan_zero_b": 0, "diag_scan": 0}
    if case == 0:
        return dict(zero, lmme=1, matrix_scan=1, matrix_scan_zero_b=1)
    if case == 1:
        return dict(zero, lmme=1, matrix_scan_zero_b=1)
    if case == 2:
        return dict(zero, diag_scan=1)
    return dict(zero, lmme=2 * (_assoc_combines(t // p) + _assoc_combines(p) + 1))


def log_rel_err(got, want, margin=12.0):
    """(max |log got - log want| / max(|log want|, 1) over the entries within
    ``margin`` of their row's largest log, signs equal there, the same
    entries finite): test_sharded's measure, kept off entries that signed
    sums cancel."""
    import torch

    w, g = want.log_abs, got.log_abs
    same_finite = bool((torch.isfinite(w) == torch.isfinite(g)).all())
    row = w.amax(-1, keepdim=True)
    keep = torch.isfinite(w) & (w > torch.where(torch.isfinite(row), row, 0.0) - margin)
    rel = float(((g - w).abs() / w.abs().clamp_min(1.0))[keep].max())
    signs = bool((got.sign[keep] == want.sign[keep]).all())
    return rel, same_finite and signs


def _digest(g) -> float:
    """A float64 checksum of the finite logs and the signs: equal on every
    rank when the ranks return the same states."""
    import torch

    fin = torch.isfinite(g.log_abs)
    return float(g.log_abs[fin].double().sum() + (g.sign.double() * 1e-3).sum())


def _sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _sharded_exact(case, args):
    """(float64 states, each entry's scale) of cases 0-2: the plain version in
    float64, and on all-positive operands (the sum without cancellation);
    the chain's scale is each product's largest entry (long products turn
    rank-1), the diagonal case a float64 loop in linear space (its decays
    are at most 1, its sums bounded)."""
    import torch

    from repro_torch.core.goom import to_goom
    from repro_torch.core.ops import lmme_reference
    from repro_torch.core.scan import cumulative_lmme
    from repro_torch.kernels.goom_scan import matrix_scan_ref

    f64 = torch.float64
    if case == 0:
        exact = matrix_scan_ref(*(_as(x, f64) for x in args))
        return exact, matrix_scan_ref(*(_as(x, f64, True) for x in args)).log_abs
    if case == 1:
        exact = cumulative_lmme(_as(args[0], f64), matmul=lmme_reference)
        return exact, exact.log_abs.amax((-2, -1), keepdim=True).expand_as(exact.log_abs)
    a, b, x0 = args

    def loop(positive):
        lin = lambda g: (1.0 if positive else g.sign.double()) * torch.exp(g.log_abs.double())
        x, av, bv = lin(x0), lin(a), lin(b)
        out = torch.empty_like(bv)
        for t in range(bv.shape[0]):
            x = av[t] * x + bv[t]
            out[t] = x
        return out

    return to_goom(loop(False)), torch.log(loop(True))


def _sharded_rank(rank, p, device, shapes):
    """One rank of the sharded phase: each case's sharded call under the host
    mesh, its launches, ms (host clock, time-sliced with the other ranks),
    its distance to the single-process kernel call and (rank 0) to the plain
    version, and a digest of what it returned."""
    import torch

    global DEVICE
    DEVICE = device
    from repro_torch.core import engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import graphs

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh(seq_shards=p)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    out = []
    for case in range(len(SHARDED_CASES)):
        args = _sharded_operands(case, gen, shapes)
        with torch.no_grad():
            before = graphs.kernel_launches()
            with engine.use_mesh(mesh):
                check(engine.active_seq_shards() == p, f"{p} shards not active")
                got, flags = _sharded_call(case, args)
            _sync()
            launches = {k: v - before[k] for k, v in graphs.kernel_launches().items()}
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                with engine.use_mesh(mesh):
                    _sharded_call(case, args)
                _sync()
                times.append((time.perf_counter() - t0) * 1e3)
            row = dict(launches=launches, ms=min(times), digest=_digest(got))
            # every rank's states are rank 0's (the digests): rank 0 holds
            # them to one process's kernel call and plain version
            if rank == 0:
                local, lflags = _sharded_call(case, args)
                row["err_kernel"], row["ok_kernel"] = log_rel_err(got, local)
            if rank == 0 and case < 3:
                # distances to float64 over each entry's cancellation-free scale,
                # as the kernel phases judge signed scans
                exact, scale = _sharded_exact(case, args)
                with engine.use_backend("torch_reference"):
                    plain, _ = _sharded_call(case, args)
                row.update(dist=goom_dist(got, exact, scale),
                           dist_local=goom_dist(local, exact, scale),
                           dist_plain=goom_dist(plain, exact, scale))
                row["err_plain"], row["ok_plain"] = log_rel_err(got, plain)
                del exact, scale, plain
            if case == 3:
                # the reset positions depend on the bracketing: the kernel run
                # is held to the plain version at the same shard count
                with engine.use_mesh(mesh), engine.use_backend("torch_reference"):
                    plain, pflags = _sharded_call(case, args)
                row.update(resets=int(flags.sum()), resets_plain=int(pflags.sum()),
                           flags_equal=bool((flags == pflags).all()))
                row["err_plain"], row["ok_plain"] = log_rel_err(got, plain)
                from repro_torch.core.lyapunov import SYSTEMS, spectrum_parallel

                dt = SYSTEMS["lorenz63"].dt
                with engine.use_mesh(mesh):   # the spectrum of the sharded reset scan
                    spec = spectrum_parallel(args[0], dt, chunk_size=None)
                row.update(spectrum=spec.tolist(), ref=SYSTEMS["lorenz63"].ref_spectrum[0])
                if rank == 0:
                    row.update(resets_local=int(lflags.sum()), spectrum_local=spectrum_parallel(
                        args[0], dt, chunk_size=None).tolist())
                del plain
            del got
            torch.cuda.empty_cache()
        out.append(row)
    return out


def sharded_phase():
    """Sequence-sharded engine ops on P = 2 and 4 gloo ranks that share the
    card (``launch.mesh.spawn_ranks``; the kernels built once before): every
    rank's states equal rank 0's, which are held to one process's kernel
    call and plain version (``SHARDED_BAR``), each rank's launches equal to
    the algebra's count; the calls' ms at P = 1, 2, 4 are time-sliced ranks
    on one card, not a speed.  Returns the launches summed over ranks and
    both P, and the ms."""
    import torch

    from repro_torch.core import engine
    from repro_torch.launch.mesh import spawn_ranks

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    ms1 = []
    with torch.no_grad():
        for case in range(len(SHARDED_CASES)):
            args = _sharded_operands(case, gen, SHARDED_SHAPES)
            _sharded_call(case, args)
            _sync()
            ms1.append(1e3 * min(_wall_s(lambda: _sharded_call(case, args)) for _ in range(3)))
            del args
    torch.cuda.empty_cache()
    total = {"lmme": 0, "matrix_scan": 0, "matrix_scan_zero_b": 0, "diag_scan": 0}
    ms = {1: ms1}
    for p in SHARDED_P:
        t0 = time.perf_counter()
        ranks = spawn_ranks(_sharded_rank, p, p, DEVICE, SHARDED_SHAPES, timeout=600)
        ms[p] = [max(r[c]["ms"] for r in ranks) for c in range(len(SHARDED_CASES))]
        for case, name in enumerate(SHARDED_CASES):
            rows = [r[case] for r in ranks]
            bar = SHARDED_BAR
            size = SHARDED_SHAPES[case]
            want = sharded_launches(case, size if case == 3 else size[0], p)
            for rank, row in enumerate(rows):
                check(row["launches"] == want, f"sharded {name}, P={p}, rank {rank}: "
                      f"launches {row['launches']}, the algebra gives {want}")
                for k, v in row["launches"].items():
                    total[k] += v
                if case < 3 and rank == 0:
                    lim = 2.0 * max(row["dist_local"], row["dist_plain"]) + 1e-6
                    check(row["dist"] <= lim, f"sharded {name}, P={p}: distance to "
                          f"float64 {row['dist']:.3e} > {lim:.3e}, twice the single-process "
                          f"kernel call's {row['dist_local']:.3e} or the plain version's "
                          f"{row['dist_plain']:.3e}")
                elif case == 3:
                    # the reset scan's flags depend on the bracketing: it is held
                    # to the plain version at the same shard count instead
                    check(row["ok_plain"] and row["err_plain"] <= bar,
                          f"sharded {name}, P={p}, rank {rank}: {row['err_plain']:.3e} from "
                          f"the plain version at P={p} (bar {SHARDED_BAR})")
                check(row["digest"] == rows[0]["digest"],
                      f"sharded {name}, P={p}: rank {rank} returned other states than rank 0")
            r0 = rows[0]
            extra = (f"; distance to float64 {r0['dist']:.2e} (one process: kernel "
                     f"{r0['dist_local']:.2e}, plain {r0['dist_plain']:.2e})"
                     if case < 3 else "")
            if case == 3:
                check(all(r["flags_equal"] for r in rows),
                      f"sharded {name}, P={p}: reset flags differ from the plain version's")
                spec, ref = r0["spectrum"], r0["ref"]
                check(all(math.isfinite(v) for v in spec)
                      and abs(max(spec) - ref) < max(0.15, 0.2 * abs(ref) + 0.05),
                      f"sharded lorenz63 spectrum {spec}: lambda_1 vs literature {ref}")
                extra += (f"; resets {r0['resets']} (plain at P={p} {r0['resets_plain']}, "
                         f"one process {r0['resets_local']}); spectrum (one scan of "
                         f"4096) {[round(v, 4) for v in spec]}, one process "
                         f"{[round(v, 4) for v in r0['spectrum_local']]}, literature "
                         f"lambda_1 {ref}")
            print(f"sharded [{name}] P={p}: ranks' states equal; relative log error "
                  f"from one process's kernel call {r0['err_kernel']:.2e}, from the plain "
                  f"version {r0['err_plain']:.2e}; launches a rank {want}{extra}", flush=True)
        print(f"sharded P={p}: {time.perf_counter() - t0:.1f} s with the ranks' start",
              flush=True)
    for case, name in enumerate(SHARDED_CASES):
        print(f"sharded [{name}] ms a call, P=1 {ms[1][case]:.3f}, P=2 {ms[2][case]:.3f}, "
              f"P=4 {ms[4][case]:.3f} (time-sliced ranks on one card, gloo's "
              f"collectives: not a speed); {card_line()}", flush=True)
    engine.reset_calls()
    return total, ms


def _wall_s(fn) -> float:
    t0 = time.perf_counter()
    fn()
    _sync()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 13: the launcher on ranks (torch.distributed.run)
# ---------------------------------------------------------------------------
DIST_STEPS = 2
#: the f32 runs held to the float64 step on one process (``f64_step``): the
#: FSDP pair at P = 2 and the data-parallel seq-sharded (2, 2).  One step:
#: the first step's loss, gradient norm and every leaf's gradient against
#: float64 make the later steps' norms, which drift apart after Adam's first
#: sign-of-gradient update (PERF.md), no tighter a measure
DIST_F32_STEPS = 1
#: a multi-rank run's first step against float64: its distance within this
#: factor of one process's at the same compute dtype (the loss, the
#: gradient norm, and each leaf's first moment against one process's worst
#: leaf).  Rounding moves both alike; a reduction a rank misses puts a leaf
#: ~0.5 of itself away (0.63-0.77 mutated in on CPU ranks)
F64_SPREAD = 2.0
#: the floors of that distance, relative: the loss one f32 ulp (2^-23), the
#: gradient norm eight (2^-20: one f32 sum over 1.2e8 squares, reassociated
#: by the ranks, spreads by several ulps whatever the gradients)
F64_LOSS_FLOOR = 2.0 ** -23
F64_NORM_FLOOR = 2.0 ** -20
#: the FSDP runs' rank counts (P = 1 is the single process, no mesh), and
#: their steps (the peak is read over those after the first)
FSDP_P = (1, 2, 4)
FSDP_STEPS = 2
#: a rank's measured peak above its floor against the dry-run's (P, 1) cell's
#: above the state: within this
#: factor either way (``DRYRUN_PEAK_FACTOR``'s bar and measure)
FSDP_PEAK_FACTOR = 1.05
#: a rank's floor (the bytes allocated after its first step) above the
#: dry-run's state (parameter blocks and moments): at most cuBLAS's
#: workspace, 0.063-0.067 GiB in the first card runs, and this margin; a
#: gathered period, a gradient or a moment kept across steps passes it
FSDP_FLOOR_SLACK = 80 * 2 ** 20


def fsdp_dryrun_cells() -> dict:
    """The dry-run of ``dist_launcher_phase``'s FSDP runs: goom-rnn-124m
    (``shared_a``, bf16 compute, f32 parameters, remat full, one
    microbatch) at train_phase's B and S on a (P, 1) mesh for each P > 1;
    P = 1 is the (1, 1) train cell."""
    from repro_torch import get_config
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.sharding import NamedMesh

    cfg = with_scan_variant(get_config("goom-rnn-124m"), "shared_a")
    shape = ShapeCfg("chip_train", TRAIN["seq_len"], TRAIN["batch"], "train")
    return {p: lower_cell(cfg, shape, NamedMesh((p, 1), ("data", "model")), verbose=False,
                          perf={"remat": "full", "microbatches": 1}).to_dict()
            for p in FSDP_P if p > 1}


def _torchrun_start(nproc, argv, out_json):
    """Start ``python -m torch.distributed.run --nproc-per-node nproc -m
    repro_torch.launch.train argv``; ``_torchrun_wait`` ends it."""
    import os

    from repro_torch.launch.mesh import free_port

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
           "--master-addr", "localhost", "--master-port", str(free_port()),
           "-m", "repro_torch.launch.train", *argv, "--metrics-out", str(out_json)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, argv, out_json


def _torchrun_wait(runs, timeout=600):
    """What rank 0 of each ``_torchrun_start`` run in ``runs`` (by name)
    wrote to ``--metrics-out``, once every run has ended; fails when one
    does not exit 0 within ``timeout`` s (it is killed)."""
    ended = {}
    for name, (proc, argv, out_json) in runs.items():
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        ended[name] = (proc.returncode, out, err, argv, out_json)
    for rc, out, err, argv, _ in ended.values():
        if rc != 0:
            print(out[-4000:], err[-8000:], sep="\n", flush=True)
        check(rc == 0, f"torch.distributed.run {' '.join(argv)}: exit {rc}")
    got = {}
    for name, (_, _, _, _, out_json) in ended.items():
        with open(out_json) as f:
            got[name] = json.load(f)
    return got


def f64_step(model, batch):
    """The float64 yardstick: ``model``'s train step on ``batch`` in float64 on
    one process, on the card, through the plain versions (the kernels are
    f32 only): a copy of its weights cast to float64, float64 compute.
    Returns (loss, gradients by name, their global norm, and the first
    moments AdamW's first update keeps, ``(1 - b1)`` times the gradients
    clipped to norm 1, as ``make_train_step`` clips them), all on the card."""
    import copy

    import torch

    from repro_torch.core import engine
    from repro_torch.train import AdamW

    m64 = copy.deepcopy(model).double()
    m64.cfg = dataclasses.replace(model.cfg, compute_dtype=torch.float64,
                                  param_dtype=torch.float64)
    with engine.use_backend("torch_reference"):
        loss, grads = _grads(m64, batch)
    del m64
    grads = {n: g.detach() for n, g in grads.items()}
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    b1 = AdamW(lambda step: 0.0).b1
    mu = {n: (1 - b1) * g * torch.clamp(1.0 / norm, max=1.0) for n, g in grads.items()}
    free_memory()
    return float(loss), grads, float(norm), mu


def leaf_distance(got, exact) -> float:
    """The norm of ``got - exact`` over the norm of ``exact``, in float64."""
    import numpy as np

    got, exact = (np.asarray(x.detach().double().cpu() if hasattr(x, "detach") else x,
                             dtype=np.float64) for x in (got, exact))
    ref = np.linalg.norm(exact.ravel())
    return float(np.linalg.norm((got - exact).ravel()) / ref) if ref else 0.0


def _one_process(argv, p):
    """The launcher's model (same seed) for one step in this process on the
    concatenation of the ``p`` data ranks' slices of its first batch, at the
    launcher's compute dtype on the kernels, and the same step in float64
    (``f64_step``): each one's loss, gradient norm and first moments (numpy)."""
    import numpy as np
    import torch

    from repro_torch import DecoderLM, get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train import (AdamW, DataConfig, SyntheticStream, cosine_schedule,
                                   init_train_state, make_train_step)
    from repro_torch.train.data import to_device

    args = launch_train.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=getattr(torch, args.compute_dtype))
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(args.seed))
    streams = [SyntheticStream(DataConfig(task=args.task, vocab=cfg.vocab, seq_len=args.seq_len,
                                          global_batch=args.batch, seed=args.seed,
                                          process_index=i, process_count=p)) for i in range(p)]
    parts = [s.generate(0) for s in streams]
    batch = to_device({k: np.concatenate([x[k] for x in parts]) for k in parts[0]}, DEVICE)
    loss64, _, norm64, mu64 = f64_step(model, batch)
    opt = AdamW(cosine_schedule(args.lr, args.warmup, args.steps))
    state, m = make_train_step(model, opt)(init_train_state(model, opt), batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "cfg": cfg,
           "mu": {n: v.detach().cpu().numpy().copy() for n, v in state.opt_state["mu"].items()},
           "f64": {"loss": loss64, "grad_norm": norm64,
                   "mu": {n: v.cpu().numpy() for n, v in mu64.items()}}}
    del model, opt, state, mu64
    free_memory()
    return out


def _first_moments(directory, cfg, like):
    """The first moments of the launcher's checkpoint of step 1 in
    ``directory`` (JAX's layout) by the port's names, as numpy."""
    from repro_torch.convert import params_from_jax, params_to_jax
    from repro_torch.train.checkpoint import CheckpointManager

    tree, _ = CheckpointManager(directory).restore(
        1, {"opt_state": {"mu": params_to_jax(cfg, like)}})
    return {n: v.numpy() for n, v in params_from_jax(cfg, tree["opt_state"]["mu"]).items()}


def f64_gaps(run, got_mu, one):
    """A run's first step (its metrics' loss and gradient norm, and its first
    moments by name) and the one process's at the same compute dtype, each
    as its distance to the float64 step (``one["f64"]``)."""
    f = one["f64"]
    rel = lambda x, ref: abs(x - ref) / abs(ref)  # noqa: E731
    step = run["steps"][0]
    return {"loss": (rel(step["loss"], f["loss"]), rel(one["loss"], f["loss"])),
            "norm": (rel(step["grad_norm"], f["grad_norm"]),
                     rel(one["grad_norm"], f["grad_norm"])),
            "leaves": {n: leaf_distance(got_mu[n], f["mu"][n]) for n in f["mu"]},
            "one_leaves": {n: leaf_distance(one["mu"][n], f["mu"][n]) for n in f["mu"]}}


def check_f64(gaps, label, leaves_are="first moments"):
    """``f64_gaps`` printed, then held: the run's loss and gradient norm
    within F64_SPREAD times one process's distance to float64 (floored at
    F64_LOSS_FLOOR and F64_NORM_FLOOR), every leaf within F64_SPREAD times one
    process's worst leaf (``leaves_are``: what the leaves hold)."""
    leaves, one = gaps["leaves"], gaps["one_leaves"]
    worst, one_worst = max(leaves, key=leaves.get), max(one, key=one.get)
    bars = {"loss": F64_SPREAD * max(gaps["loss"][1], F64_LOSS_FLOOR),
            "norm": F64_SPREAD * max(gaps["norm"][1], F64_NORM_FLOOR),
            "leaf": F64_SPREAD * one[one_worst]}
    print(f"{label}: first step against the float64 step on one process (same weights "
          f"and batch; the run / one process at its dtype): loss {gaps['loss'][0]:.3e} / "
          f"{gaps['loss'][1]:.3e} (bar {bars['loss']:.3e}), gradient norm "
          f"{gaps['norm'][0]:.3e} / {gaps['norm'][1]:.3e} (bar {bars['norm']:.3e}); "
          f"{len(leaves)} leaves' {leaves_are}, the run's worst {worst} {leaves[worst]:.3e}, "
          f"one process's worst {one_worst} {one[one_worst]:.3e} (bar {bars['leaf']:.3e})",
          flush=True)
    check(gaps["loss"][0] <= bars["loss"], f"{label}: loss {gaps['loss']} from float64")
    check(gaps["norm"][0] <= bars["norm"], f"{label}: gradient norm {gaps['norm']} "
          "from float64")
    check(leaves[worst] <= bars["leaf"], f"{label}: leaf {worst} {leaves[worst]:.3e} from "
          f"float64, one process's worst {one[one_worst]:.3e}")
    return {"worst": leaves[worst], "one_worst": one[one_worst], "loss": gaps["loss"],
            "norm": gaps["norm"]}


def dist_launcher_phase(fsdp_cells: dict):
    """The launcher under ``torch.distributed.run``, gloo ranks sharing the
    card, every run at once, goom-rnn-124m at full width, ``shared_a``:
    ``--seq-shards 2`` on 2 ranks ((1, 2), the plain layout, full-length
    scans), DIST_STEPS bf16 steps with finite losses; ``--seq-shards 2`` on
    4 ranks ((2, 2): the data-parallel branch, ``data_group``, beside the
    full-length scans; the attention-free model splits its vocabulary on
    "model"), one f32 step; FSDP on ``--mesh host`` (P, 1), parameters laid
    out and gathered a period at a time, FSDP_STEPS bf16 steps at each P of
    FSDP_P (P = 1: one process): each rank's peak over the steps after the
    first above the bytes allocated then (its floor: its state and what the
    first calls keep, cuBLAS's workspace among them) within FSDP_PEAK_FACTOR
    of the dry-run's (P, 1) cell's peak above the state (``fsdp_cells``;
    P = 1 the (1, 1) train cell; ``dryrun_phase``'s measure), the floor at
    most FSDP_FLOOR_SLACK above the dry-run's state, the whole peaks falling
    with P, each rank's LMME launches equal to its engine calls; one f32
    FSDP step at P = 2; and ``--model-shards 2`` on 2 ranks (the model axis,
    MODEL_AXIS_STEPS bf16 steps, checked by ``model_axis_phase``).  The two
    f32 runs' first steps are held to the float64 step on one process on
    both data ranks' slices (``check_f64``: loss, gradient norm, and each
    leaf's first moment in the launcher's checkpoint of step 1, each within
    F64_SPREAD of the one f32 process's distance), and that one process's
    worst leaf below the one bf16 process's (f32 carries 16 more mantissa
    bits: an f32 step that lost them to a narrower cast shows).  While the
    ranks run, this process runs the one processes' steps (f32 on both data
    slices, bf16 on the model-axis run's batch, each beside its float64
    step) and ``launcher_phase``.  Returns rank 0's launches of the bf16
    seq-sharded run, each FSDP run's (summed over its ranks), each rank's
    peak, and the model-axis run with its first moments and its one
    process."""
    import shutil

    tmp = ROOT / "build"
    tmp.mkdir(exist_ok=True)
    ckpts = {k: tmp / f"chip_smoke_{k}_ckpt" for k in ("dp32", "fsdp32", "model")}
    for d in ckpts.values():
        shutil.rmtree(d, ignore_errors=True)
    full = ["--arch", "goom-rnn-124m", "--task", "copy", "--seq-len", str(TRAIN["seq_len"]),
            "--batch", str(TRAIN["batch"]), "--lr", str(TRAIN["lr"]), "--log-every", "1",
            "--dist-backend", "gloo"]
    f32 = full + ["--compute-dtype", "float32", "--steps", str(DIST_F32_STEPS)]
    fsdp = full + ["--mesh", "host"]
    model_axis = full + ["--steps", str(MODEL_AXIS_STEPS), "--model-shards", "2",
                         "--ckpt-every", "1", "--ckpt-dir", str(ckpts["model"])]
    t0 = time.perf_counter()
    runs = {"bf16": _torchrun_start(2, full + ["--steps", str(DIST_STEPS), "--seq-shards", "2"],
                                    tmp / "chip_smoke_dist.json"),
            "f32": _torchrun_start(4, f32 + ["--seq-shards", "2", "--ckpt-every", "1",
                                             "--ckpt-dir", str(ckpts["dp32"])],
                                   tmp / "chip_smoke_dist32.json"),
            "fsdp f32": _torchrun_start(2, f32 + ["--mesh", "host", "--ckpt-every", "1",
                                                  "--ckpt-dir", str(ckpts["fsdp32"])],
                                        tmp / "chip_smoke_fsdp32.json"),
            "model": _torchrun_start(2, model_axis, tmp / "chip_smoke_model.json"),
            **{f"fsdp {p}": _torchrun_start(p, fsdp + ["--steps", str(FSDP_STEPS)],
                                            tmp / f"chip_smoke_fsdp{p}.json")
               for p in FSDP_P}}
    try:
        ones = {"f32": _one_process(f32, 2), "bf16": _one_process(model_axis, 1)}
        launcher_phase()
    finally:
        runs = _torchrun_wait(runs)
    ranks_s = time.perf_counter() - t0
    try:
        f64 = _launcher_checks(runs, ones["f32"], fsdp_cells, ckpts)
        one = ones["bf16"]
        model_mu = _first_moments(ckpts["model"], one["cfg"], one["mu"])
    finally:
        for d in ckpts.values():
            shutil.rmtree(d, ignore_errors=True)
    f32_worst = max(leaf_distance(ones["f32"]["mu"][n], ones["f32"]["f64"]["mu"][n])
                    for n in one["mu"])
    bf16_worst = max(leaf_distance(one["mu"][n], one["f64"]["mu"][n]) for n in one["mu"])
    print(f"one process, goom-rnn-124m's first step against float64 on the card, worst leaf's "
          f"first moment: f32 {f32_worst:.3e} (both data slices), bf16 {bf16_worst:.3e} "
          f"(the model-axis run's batch); f32 below bf16", flush=True)
    check(f32_worst < bf16_worst, f"one process f32 {f32_worst:.3e} from "
          f"float64 against bf16 {bf16_worst:.3e}")
    print(f"launcher ranks: the runs at once in {ranks_s:.1f} s with their start", flush=True)
    return {"seq": runs["bf16"]["launches"],
            "peaks": {p: [r["peak_bytes"] for r in runs[f"fsdp {p}"]["ranks"]] for p in FSDP_P},
            **{f"fsdp {p}": {k: sum(r["launches"][k] for r in runs[f"fsdp {p}"]["ranks"])
                             for k in runs[f"fsdp {p}"]["launches"]} for p in FSDP_P},
            "f64": dict(f64, one_f32=f32_worst, one_bf16=bf16_worst),
            "model_axis": {"run": runs["model"], "mu": model_mu, "one": one}}


def _launcher_checks(runs, one, fsdp_cells, ckpts):
    """``dist_launcher_phase``'s checks of its runs, each result printed
    before it is held; returns the f32 runs' distances to float64."""
    run = runs["bf16"]
    losses = [s["loss"] for s in run["steps"]]
    print(f"launcher --seq-shards 2 (2 gloo ranks on one card, (1, 2), full width, bf16, the "
          f"plain layout): {DIST_STEPS} steps, losses {[round(v, 4) for v in losses]}; "
          f"rank 0 launches {run['launches']}", flush=True)
    check(len(losses) == DIST_STEPS and all(math.isfinite(v) for v in losses)
          and run["layouts"] is False, f"launcher --seq-shards 2: losses {losses}, "
          f"layouts {run['layouts']}")

    peaks = {}
    for p in FSDP_P:
        run = runs[f"fsdp {p}"]
        cell = fsdp_cells[str(p)]["memory_per_device"]
        state = cell["peak_bytes"] - cell["above_state_bytes"]
        losses = [s["loss"] for s in run["steps"]]
        ranks = run["ranks"]
        peaks[p] = [r["peak_bytes"] for r in ranks]
        ratios = [cell["above_state_bytes"] / (r["peak_bytes"] - r["floor_bytes"]) for r in ranks]
        print(f"launcher FSDP P={p} ({p} gloo rank(s) on one card, --mesh host ({p}, 1), "
              f"full width, bf16, remat full, B={TRAIN['batch']}, S={TRAIN['seq_len']}): "
              f"{FSDP_STEPS} steps, losses {[round(v, 4) for v in losses]}; each rank's peak "
              f"after the first step {[round(b / 2**30, 3) for b in peaks[p]]} GiB over a "
              f"floor of {[round(r['floor_bytes'] / 2**30, 4) for r in ranks]} (the "
              f"dry-run's peak {cell['peak_bytes'] / 2**30:.3f}, its state "
              f"{state / 2**30:.4f}: predicted / measured above it "
              f"{[round(x, 4) for x in ratios]}, whole peaks "
              f"{[round(cell['peak_bytes'] / b, 4) for b in peaks[p]]}; gathered parameters "
              f"at most {cell['gathered_param_bytes'] / 2**30:.3f} GiB, parameter blocks "
              f"{cell['param_shard_bytes'] / 2**30:.3f}); LMME launches a rank "
              f"{[r['launches']['lmme'] for r in ranks]}, engine calls "
              f"{[r['calls']['lmme'] for r in ranks]}; {card_line()}", flush=True)
        check(run["world"] == p and run["layouts"] is (p > 1) and len(ranks) == p,
              f"launcher FSDP P={p}: world {run['world']}, layouts {run['layouts']}")
        check(len(losses) == FSDP_STEPS and all(map(math.isfinite, losses)),
              f"launcher FSDP P={p}: losses {losses}")
        for rank, (r, ratio) in enumerate(zip(ranks, ratios)):
            check(r["launches"]["lmme"] == r["calls"]["lmme"] > 0,
                  f"launcher FSDP P={p}, rank {rank}: LMME launches {r['launches']['lmme']} "
                  f"!= engine calls {r['calls']['lmme']}")
            check(1 / FSDP_PEAK_FACTOR <= ratio <= FSDP_PEAK_FACTOR,
                  f"launcher FSDP P={p}, rank {rank}: peak above the floor against the "
                  f"dry-run's above the state, ratio {ratio:.3f}")
            check(0 <= r["floor_bytes"] - state <= FSDP_FLOOR_SLACK,
                  f"launcher FSDP P={p}, rank {rank}: floor {r['floor_bytes'] / 2**30:.4f} GiB "
                  f"against the dry-run's state {state / 2**30:.4f} (at most "
                  f"{FSDP_FLOOR_SLACK / 2**30:.4f} above it)")
    for small, big in zip(FSDP_P, FSDP_P[1:]):
        check(max(peaks[big]) < min(peaks[small]),
              f"launcher FSDP: peaks at P={big} {peaks[big]} do not fall below P={small}'s "
              f"{peaks[small]}")

    run = runs["f32"]
    check(run["world"] == 4 and run["layouts"] is False,
          f"launcher --seq-shards 2 on 4 ranks: world {run['world']}, layouts {run['layouts']}")
    label = ("launcher --seq-shards 2 (4 gloo ranks on one card, (2, 2): data parallel over 2 "
             "beside the full-length scans; full width, f32)")
    out = {"seq": check_f64(f64_gaps(run, _first_moments(ckpts["dp32"], one["cfg"], one["mu"]),
                                     one), label)}
    run = runs["fsdp f32"]
    check(run["world"] == 2 and run["layouts"] is True,
          f"launcher FSDP f32 P=2: world {run['world']}, layouts {run['layouts']}")
    label = "launcher FSDP f32 P=2 (--mesh host (2, 1), full width)"
    out["fsdp"] = check_f64(f64_gaps(run, _first_moments(ckpts["fsdp32"], one["cfg"],
                                                          one["mu"]), one), label)
    return out


# ---------------------------------------------------------------------------
# phase 13b: the model axis (heads, channels and the vocabulary across ranks)
# ---------------------------------------------------------------------------
#: the launcher's model-axis run: bf16 steps on a (1, 2) mesh
MODEL_AXIS_STEPS = 2
#: olmo-1b's fresh-cache prefill on the (1, 2) ranks: rows and tokens
MODEL_AXIS_PREFILL = (2, 4096)
#: the prefill's last logits against one process's, both at f32 compute
#: (the fresh prefill attends over the prompt's own f32 K/V): the port's
#: uncached parity bar, ``tests/test_torch_families.py``
MODEL_AXIS_LOGIT_STD = 1e-4
#: the rank's bf16 caches against its block of one process's: the gap left
#: beyond one bf16 step of the larger entry (an f32 K/V entry the two paths
#: compute a rounding apart lands on either side of a step), over the
#: tensor's largest entry; what is left is the f32 rounding of the K/V
#: products, held to the logits' bar (near zero the two sides of a sign
#: can be a rounding apart, so a count of bf16 steps is no measure there)
MODEL_AXIS_CACHE_EXCESS = 1e-4
MODEL_AXIS_REF = str(ROOT / "build" / "chip_smoke_model_axis_ref.pt")


def model_axis_dryrun_cells() -> dict:
    """The dry-run's (1, 2) rank of ``model_axis_phase``'s runs: goom-rnn-124m's
    train step (``fsdp_dryrun_cells``' shape, ``shared_a``, remat full),
    olmo-1b's fresh-cache prefill of MODEL_AXIS_PREFILL and gemma3-1b's of
    REST_GEMMA_PREFILL (``rest_dryrun_cell``)."""
    from repro_torch import get_config
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.sharding import NamedMesh

    mesh = NamedMesh((1, 2), ("data", "model"))
    cfg = with_scan_variant(get_config("goom-rnn-124m"), "shared_a")
    train = ShapeCfg("chip_train", TRAIN["seq_len"], TRAIN["batch"], "train")
    rows, n = MODEL_AXIS_PREFILL
    return {"train": lower_cell(cfg, train, mesh, verbose=False,
                                perf={"remat": "full", "microbatches": 1}).to_dict(),
            "prefill": lower_cell(model_axis_olmo(), ShapeCfg("chip_prefill", n, rows,
                                                              "prefill"),
                                  mesh, verbose=False).to_dict(),
            "rest_prefill": rest_dryrun_cell()}


def model_axis_olmo():
    """olmo-1b at full width and depth, f32 compute (its caches bf16)."""
    import torch

    from repro_torch import get_config

    return dataclasses.replace(get_config("olmo-1b"), compute_dtype=torch.float32)


def bf16_excess(a, b) -> float:
    """The largest gap between two bf16 tensors' entries beyond one bf16 step
    (8 significant bits) of the larger of the two, over ``b``'s largest
    magnitude."""
    import torch

    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), e - 8)
    return float(((a - b).abs() - step).clamp_min(0).max() / b.abs().max())


def _record_engine(calls):
    """Wrap the engine ops the split layers call so that each op's first
    call keeps its operands (``calls[op]``); returns the restore."""
    from repro_torch.core import engine

    saved = {}
    for op in ("lmme", "matrix_scan_carry", "diagonal_scan_carry"):
        fn = saved[op] = getattr(engine, op)

        def wrapped(*args, _fn=fn, _op=op, **kw):
            if _op not in calls:
                calls[_op] = [None if a is None else type(a)(a.log_abs.clone(), a.sign.clone())
                              for a in args]
            return _fn(*args, **kw)

        setattr(engine, op, wrapped)
    return lambda: [setattr(engine, op, fn) for op, fn in saved.items()]


def _kernel_at_split_shapes(rules):
    """On a (1, 2) rank: goom-rnn-124m at full width, 2 of its layers, in
    ``shared_a`` and ``generic``, and Jamba's smoke config, each one no-grad
    forward under ``rules``; the kernels' launches and the engine's calls
    over them, and for the first LMME, with-B scan and diagonal-scan call
    its operands' shapes, and the kernel's and the f32 plain version's
    distances to the float64 plain version on them (``goom_dist``, as the
    kernel phases measure), and whether both have the same finite entries."""
    import torch

    from repro_torch import DecoderLM, get_config
    from repro_torch.core import engine
    from repro_torch.sharding import use_rules

    cfg = get_config("goom-rnn-124m")
    cfg = dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0], n_periods=2),),
                              n_layers=2)
    models = [with_scan_variant(cfg, "shared_a"), with_scan_variant(cfg, "generic"),
              get_config("jamba-v0.1", smoke=True)]
    calls, out = {}, {}
    reset_counts()
    restore = _record_engine(calls)
    try:
        for c in models:
            model = DecoderLM(c, device=DEVICE,
                              generator=torch.Generator(device=DEVICE).manual_seed(SEED))
            tokens = torch.randint(0, c.vocab, (2, 64), device=DEVICE,
                                   generator=torch.Generator(device=DEVICE).manual_seed(SEED))
            with torch.no_grad(), use_rules(rules), engine.use_backend("cuda"):
                model(tokens)
            del model
    finally:
        restore()
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    out["launches"], out["calls"] = read_counts()
    for op, args in calls.items():
        fn = getattr(engine, op)
        with torch.no_grad():
            with engine.use_backend("cuda"):
                got = fn(*args)
            with engine.use_backend("torch_reference"):
                plain = fn(*args)
                exact = fn(*(_as(a, torch.float64) for a in args))
                scale = fn(*(_as(a, torch.float64, True) for a in args))
        got, plain, exact, scale = (x[0] if isinstance(x, tuple) else x
                                    for x in (got, plain, exact, scale))
        d_k = goom_dist(got, exact, scale.log_abs)
        d_p = goom_dist(plain, exact, scale.log_abs)
        out[op] = {"shapes": [None if a is None else tuple(a.shape) for a in args],
                   "dist": d_k, "plain_dist": d_p,
                   "finite": bool(torch.isfinite(got.log_abs).eq(
                       torch.isfinite(plain.log_abs)).all())}
    return out


def _model_axis_rank(rank, device):
    """One rank of ``model_axis_phase`` on the (1, 2) mesh under the default
    rules: olmo-1b laid out, its caches (the rank's KV heads) and a fresh
    prefill of MODEL_AXIS_PREFILL, the peak above the floor (a warm-up
    prefill first), the last logits and each layer's cache against the
    rank's block of one process's (``MODEL_AXIS_REF``); then
    ``_kernel_at_split_shapes``; then ``_model_axis_rest_rank`` (one spawn
    for both: a rank's start costs seconds)."""
    import torch

    global DEVICE
    DEVICE = device
    from repro_torch import DecoderLM
    from repro_torch.launch.mesh import _device_mesh
    from repro_torch.serve.steps import make_prefill_step
    from repro_torch.sharding import distribute_model, make_rules, use_rules

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = _device_mesh((1, 2), ("data", "model"), DEVICE)
    rules = make_rules(mesh)
    cfg = model_axis_olmo()
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    distribute_model(model, rules)
    model.requires_grad_(False)
    ref = torch.load(MODEL_AXIS_REF, map_location=DEVICE)
    rows, n = MODEL_AXIS_PREFILL
    step = make_prefill_step(model, backend="cuda", fresh_caches=True)
    with use_rules(rules):
        caches = model.init_caches(rows, n)
        step(ref["prompt"], caches)           # warm-up: cuBLAS and the allocator
        torch.cuda.synchronize()
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        floor = torch.cuda.memory_allocated()
        logits, caches = step(ref["prompt"], caches)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    kv = cfg.layer_list[0].attn.n_kv_heads
    half = kv // 2
    cache_excess, cache_bytes = 0.0, 0
    for layer, want in zip(caches, ref["caches"]):
        for key in ("k", "v"):
            mine = layer[key]
            cache_bytes += mine.numel() * mine.element_size()
            cache_excess = max(cache_excess, bf16_excess(
                mine, want[key][:, :, rank * half:(rank + 1) * half]))
    lg = logits.float()
    out = {"peak": peak, "floor": floor, "cache_bytes": cache_bytes, "cache_excess": cache_excess,
           "logit_gap": float((lg - ref["logits"]).abs().max() / ref["logits"].std()),
           "tokens": lg[:, -1].argmax(-1).tolist(), "kv_shape": tuple(caches[0]["k"].shape)}
    del model, caches, ref
    free_memory()
    out["kernels"] = _kernel_at_split_shapes(rules)
    free_memory()
    out["rest"] = _model_axis_rest_rank(rank, mesh)
    return out


def model_axis_reference():
    """olmo-1b's (``model_axis_olmo``) fresh prefill of MODEL_AXIS_PREFILL in
    this process, saved to MODEL_AXIS_REF for the ranks: (its KV cache bytes,
    its last logits)."""
    import torch

    from repro_torch import DecoderLM
    from repro_torch.serve.steps import make_prefill_step

    free_memory()
    rows, n = MODEL_AXIS_PREFILL
    cfg = model_axis_olmo()
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    model.requires_grad_(False)
    prompt = torch.randint(0, cfg.vocab, (rows, n), device=DEVICE,
                           generator=torch.Generator(device=DEVICE).manual_seed(SEED + 53))
    logits, caches = make_prefill_step(model, backend="cuda", fresh_caches=True)(
        prompt, model.init_caches(rows, n))
    one_bytes = sum(layer[k].numel() * layer[k].element_size()
                    for layer in caches for k in ("k", "v"))
    torch.save({"prompt": prompt, "logits": logits.float(),
                "caches": [{k: layer[k] for k in ("k", "v")} for layer in caches]},
               MODEL_AXIS_REF)
    ref_logits = logits.float()[:, -1]
    del model, caches, logits
    free_memory()
    return one_bytes, ref_logits


def model_axis_phase(cells: dict, launcher: dict):
    """The model axis on 2 gloo ranks sharing the card, a (1, 2) mesh under
    the default rules.  goom-rnn-124m at full width (24 layers, 24 of its 48
    heads a rank, ``shared_a``, bf16, remat full, B=16, S=128,
    MODEL_AXIS_STEPS steps: ``dist_launcher_phase``'s ``--model-shards 2``
    run): finite losses, the first loss and each leaf's first-step gradient
    against the float64 step within F64_SPREAD of one bf16 process's
    distance (``check_f64``), LMME launches equal to engine calls on each
    rank, each rank's peak above its floor within FSDP_PEAK_FACTOR of the
    dry-run's (1, 2) cell's above the state.  olmo-1b at full width
    (``_model_axis_rank``, f32 compute, bf16 caches): a fresh prefill of
    MODEL_AXIS_PREFILL, each rank's KV cache bytes half of one process's, its
    caches its heads' block of one process's within a bf16 step and
    MODEL_AXIS_CACHE_EXCESS,
    the last logits within MODEL_AXIS_LOGIT_STD·std and the next tokens
    equal to one process's but at a near tie (``_near_tie``), the
    peak above the floor within FSDP_PEAK_FACTOR of the dry-run's (1, 2)
    prefill cell.  The LMME and with-B scan kernels at 24 heads and the
    diagonal scan at Jamba smoke's di/2 = 64 channels, on the operands the
    split layers handed them: each kernel's distance to the float64 plain
    version within twice the f32 plain version's (the kernel phases' bar),
    and every launch an engine call.  Then ``model_axis_rest``: RWKV6,
    the MoE experts and gemma3's sequence-split caches on the same ranks."""
    ma = launcher["model_axis"]
    run, one = ma["run"], ma["one"]
    label = ("model axis: goom-rnn-124m --model-shards 2 (2 gloo ranks on one card, (1, 2), "
             "24 of 48 heads a rank, bf16, remat full)")
    cell = cells["train"]["memory_per_device"]
    state = cell["peak_bytes"] - cell["above_state_bytes"]
    losses = [st["loss"] for st in run["steps"]]
    ranks = run["ranks"]
    ratios = [cell["above_state_bytes"] / (r["peak_bytes"] - r["floor_bytes"]) for r in ranks]
    print(f"{label}: {MODEL_AXIS_STEPS} steps, losses {losses} (one process {one['loss']}); "
          f"each rank's peak {[round(r['peak_bytes'] / 2**30, 3) for r in ranks]} GiB over a "
          f"floor of {[round(r['floor_bytes'] / 2**30, 4) for r in ranks]} (the dry-run's "
          f"(1, 2) peak {cell['peak_bytes'] / 2**30:.3f}, state {state / 2**30:.4f}: "
          f"predicted / measured above it {[round(x, 4) for x in ratios]}); LMME launches "
          f"{[r['launches']['lmme'] for r in ranks]}, engine calls "
          f"{[r['calls']['lmme'] for r in ranks]}; {card_line()}", flush=True)
    check(run["world"] == 2 and run["layouts"] is True and len(ranks) == 2,
          f"{label}: world {run['world']}, layouts {run['layouts']}")
    check(len(losses) == MODEL_AXIS_STEPS and all(map(math.isfinite, losses)),
          f"{label}: losses {losses}")
    for rank, (r, ratio) in enumerate(zip(ranks, ratios)):
        check(r["launches"]["lmme"] == r["calls"]["lmme"] > 0, f"{label}, rank {rank}: LMME "
              f"launches {r['launches']['lmme']} != engine calls {r['calls']['lmme']}")
        check(1 / FSDP_PEAK_FACTOR <= ratio <= FSDP_PEAK_FACTOR, f"{label}, rank {rank}: peak "
              f"above the floor against the dry-run's above the state, ratio {ratio:.3f}")
    f64 = check_f64(f64_gaps(run, ma["mu"], one), label)
    return dict(model_axis_ranks(cells), f64=f64, ratios=ratios)


def model_axis_ranks(cells: dict):
    """``model_axis_phase``'s 2 ranks: olmo-1b's prefill against one
    process's, the kernels at the split layers' shapes and
    ``model_axis_rest``'s cases."""
    from repro_torch.launch.mesh import spawn_ranks

    # one process's runs first (olmo-1b's prefill, model_axis_rest's), the
    # ranks' against them
    one_bytes, ref_logits = model_axis_reference()
    tokens = ref_logits.argmax(-1).tolist()
    rows, n = MODEL_AXIS_PREFILL
    t0 = time.perf_counter()
    try:
        rest_one = model_axis_rest_reference()
        t1 = time.perf_counter()
        got = spawn_ranks(_model_axis_rank, 2, DEVICE, timeout=900)
    finally:
        pathlib.Path(MODEL_AXIS_REF).unlink(missing_ok=True)
        pathlib.Path(MODEL_AXIS_REST_REF).unlink(missing_ok=True)
    print(f"model axis rest: one process's runs {t1 - t0:.1f} s, the ranks' both parts "
          f"{time.perf_counter() - t1:.1f} s (rank 0's rest parts, s: "
          f"{ {k: round(v, 1) for k, v in got[0]['rest']['seconds'].items()} }; the float64 "
          f"checks' parts on each rank: "
          f"{[{a: f['seconds'] for a, f in r['rest']['f64'].items()} for r in got]})",
          flush=True)
    rest = model_axis_rest(cells["rest_prefill"], rest_one, [r.pop("rest") for r in got])
    pcell = cells["prefill"]["memory_per_device"]
    for rank, r in enumerate(got):
        ratio = pcell["above_state_bytes"] / (r["peak"] - r["floor"])
        print(f"model axis: olmo-1b fresh prefill {rows}x{n} on rank {rank} of (1, 2): KV "
              f"caches {r['kv_shape']} a layer, {r['cache_bytes'] / 2**30:.4f} GiB against one "
              f"process's {one_bytes / 2**30:.4f}, its heads' block within one bf16 step and "
              f"{r['cache_excess']:.3e} of the largest entry (bar {MODEL_AXIS_CACHE_EXCESS}); "
              f"last logits "
              f"{r['logit_gap']:.3e}·std from one process's (bar {MODEL_AXIS_LOGIT_STD}), "
              f"next tokens {r['tokens']} vs {tokens}; peak above the floor "
              f"{(r['peak'] - r['floor']) / 2**30:.4f} GiB, the dry-run's (1, 2) cell "
              f"{pcell['above_state_bytes'] / 2**30:.4f} (ratio {ratio:.4f}); "
              f"{card_line()}", flush=True)
        check(2 * r["cache_bytes"] == one_bytes, f"model axis prefill rank {rank}: cache "
              f"bytes {r['cache_bytes']} not half of {one_bytes}")
        check(r["cache_excess"] <= MODEL_AXIS_CACHE_EXCESS, f"model axis prefill rank "
              f"{rank}: caches {r['cache_excess']:.3e} past a bf16 step from one process's")
        check(r["logit_gap"] <= MODEL_AXIS_LOGIT_STD, f"model axis prefill rank {rank}: "
              f"logits {r['logit_gap']:.3e}·std")
        for i, (x, y) in enumerate(zip(r["tokens"], tokens)):
            _near_tie(ref_logits, i, x, y, f"model axis prefill rank {rank}")
        check(1 / FSDP_PEAK_FACTOR <= ratio <= FSDP_PEAK_FACTOR, f"model axis prefill rank "
              f"{rank}: peak above the floor against the dry-run's, ratio {ratio:.3f}")
    local = {"lmme": 24, "matrix_scan_carry": 24, "diagonal_scan_carry": 64}
    kernels = {}
    for rank, r in enumerate(got):
        ln, cl = r["kernels"].pop("launches"), r["kernels"].pop("calls")
        print(f"model axis: rank {rank}'s split forwards launched {ln} for engine calls "
              f"{cl}", flush=True)
        check_launches(ln, cl, f"model axis rank {rank}", {"lmme", "matrix_scan", "diag_scan"})
        kernels["launches"] = ln
        for op, k in r["kernels"].items():
            print(f"model axis: rank {rank}'s first {op} call (shapes {k['shapes']}): distance "
                  f"to float64 on the kernel {k['dist']:.3e}, of the f32 plain version "
                  f"{k['plain_dist']:.3e} (the kernel within twice it, floor 1e-6), finite "
                  f"entries alike {k['finite']}", flush=True)
            check(k["dist"] <= 2.0 * k["plain_dist"] + 1e-6 and k["finite"],
                  f"model axis rank {rank}: {op} {k}")
            kernels[op] = k
        a = r["kernels"]
        check(a["lmme"]["shapes"][0][0] == local["lmme"]
              and a["matrix_scan_carry"]["shapes"][0][1] == local["matrix_scan_carry"]
              and a["diagonal_scan_carry"]["shapes"][1][2] == local["diagonal_scan_carry"],
              f"model axis rank {rank}: kernel shapes {a}")
    return {"prefill": got, "one_cache_bytes": one_bytes, "kernels": kernels, "rest": rest}


# ---------------------------------------------------------------------------
# phase 13c: the rest of the model axis (RWKV6, MoE experts, sequence-split
# KV caches) on the same 2 gloo ranks, a (1, 2) mesh
# ---------------------------------------------------------------------------
#: rwkv6-7b at the serving phase's depth, and at 2 layers for the train step
REST_RWKV_LAYERS, REST_RWKV_TRAIN_LAYERS = 4, 2
#: mixtral-8x7b at the families phase's depth, and at 1 layer for the train
#: step: at 2 its float64 parameters and gradients (3.2e9 of each, 51 GB)
#: beside one process's f32 gradients ran the card out of memory (rank 0
#: held 59.4 GiB of 79.18, the other rank and the parent the rest)
REST_MIXTRAL_LAYERS, REST_MIXTRAL_TRAIN_LAYERS = 2, 1
#: rwkv6's and mixtral's fresh prefill (rows, tokens), then REST_DECODES
#: decode steps (rwkv6, gemma3)
REST_PREFILL = (2, 512)
REST_DECODES = 8
#: gemma3-1b's fresh prefill (rows, tokens), its caches' sequence on "model"
REST_GEMMA_PREFILL = (2, 8192)
#: the first train step's batch (rows, tokens): one of rwkv6's 128-token chunks
REST_TRAIN = (2, 128)
MODEL_AXIS_REST_REF = str(ROOT / "build" / "chip_smoke_model_axis_rest_ref.pt")


def rest_config(arch, layers=None):
    """``arch`` at full width, f32 compute, cut to ``layers`` of its one
    repeated layer (None: whole)."""
    import torch

    from repro_torch import get_config

    cfg = dataclasses.replace(get_config(arch), compute_dtype=torch.float32)
    if layers is None:
        return cfg
    check(len(cfg.groups) == 1 and len(cfg.groups[0].period) == 1, f"{arch}: one layer a period")
    return dataclasses.replace(cfg, n_layers=layers, groups=(
        dataclasses.replace(cfg.groups[0], n_periods=layers),))


def rest_dryrun_cell() -> dict:
    """The dry-run's (1, 2) rank of gemma3-1b's fresh prefill of
    REST_GEMMA_PREFILL (f32 compute; one KV head: the caches' sequence on
    "model", ``_serve_overrides``)."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.sharding import NamedMesh

    rows, n = REST_GEMMA_PREFILL
    return lower_cell(rest_config("gemma3-1b"), ShapeCfg("chip_prefill", n, rows, "prefill"),
                      NamedMesh((1, 2), ("data", "model")), verbose=False).to_dict()


def _build(cfg):
    import torch

    from repro_torch import DecoderLM

    return DecoderLM(cfg, device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(SEED))


def _prompt(cfg, rows, n, salt):
    import torch

    return torch.randint(0, cfg.vocab, (rows, n), device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(SEED + salt))


def _prefill_decode(model, prompt, max_len, feed=None, f32_kv=False, decodes=REST_DECODES):
    """A fresh prefill of ``prompt`` into ``init_caches(rows, max_len)``
    (under the caller's rules) and ``decodes`` decode steps on the card
    (``_decode_steps``): (logits of each step's last position (steps, B, V)
    f32, the caches after the prefill, the caches at the end).  ``f32_kv``:
    the K/V caches in f32."""
    from repro_torch.serve.steps import make_prefill_step

    rows, n = prompt.shape
    caches = model.init_caches(rows, max_len)
    if f32_kv:
        caches = [{k: v.float() if k in ("k", "v") else v for k, v in c.items()} for c in caches]
    logits, first = make_prefill_step(model, backend="cuda", fresh_caches=True)(prompt, caches)
    steps, caches = _decode_steps(model, first, logits[:, -1].float(), n, decodes, feed)
    return steps, first, caches


def _decode_steps(model, caches, logits, n, decodes, feed=None):
    """``decodes`` decode steps from the caches of an ``n``-token prefill whose
    last logits are ``logits`` (B, V), each fed ``feed[i]`` (B,) or else the
    last step's argmax: (every step's logits (decodes + 1, B, V), caches)."""
    import torch

    from repro_torch.core import engine

    steps = [logits]
    index = torch.full((logits.shape[0],), n, dtype=torch.long, device=logits.device)
    with torch.no_grad(), engine.use_backend("cuda"):
        for i in range(decodes):
            tok = steps[-1].argmax(-1) if feed is None else feed[i]
            out, caches = model.decode_step(tok[:, None], caches, index)
            steps.append(out[:, -1].float())
            index = index + 1
    return torch.stack(steps), caches


def _state_bytes(caches, keys):
    return sum(c[k].numel() * c[k].element_size() for c in caches for k in keys if k in c)


def model_axis_rest_reference():
    """One process's runs of ``model_axis_rest`` (same seeds), saved to
    MODEL_AXIS_REST_REF for the ranks: rwkv6-7b's prefill and decode steps
    and its ``wkv`` bytes; mixtral-8x7b's dropless prefill and its experts'
    bytes; gemma3-1b's bf16 prefill (logits, caches, their bytes) and its
    f32-KV prefill and decode steps."""
    import torch

    free_memory()
    ref = {}
    rows, n = REST_PREFILL
    with torch.no_grad():
        cfg = rest_config("rwkv6-7b", REST_RWKV_LAYERS)
        model = _build(cfg)
        prompt = _prompt(cfg, rows, n, 71)
        steps, _, caches = _prefill_decode(model, prompt, n + REST_DECODES)
        ref["rwkv6"] = {"prompt": prompt, "logits": steps, "feed": steps[:-1].argmax(-1),
                        "wkv_bytes": _state_bytes(caches, ("wkv",))}
        del model, caches
        free_memory()
        cfg = rest_config("mixtral-8x7b", REST_MIXTRAL_LAYERS)
        model = _build(cfg)
        prompt = _prompt(cfg, rows, n, 72)
        steps, _, _ = _prefill_decode(model, prompt, n, decodes=0)
        ref["mixtral"] = {"prompt": prompt, "logits": steps, "expert_bytes": sum(
            p.numel() * p.element_size() for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] in ("gate", "up", "down"))}
        del model
        free_memory()
        cfg = rest_config("gemma3-1b")
        model = _build(cfg)
        g_rows, g_n = REST_GEMMA_PREFILL
        prompt = _prompt(cfg, g_rows, g_n, 73)
        steps, _, _ = _prefill_decode(model, prompt, g_n + REST_DECODES, f32_kv=True)
        feed = steps[:-1].argmax(-1)
        bf16, first, _ = _prefill_decode(model, prompt, g_n + REST_DECODES, feed=feed)
        ref["gemma3"] = {"prompt": prompt, "logits": bf16[:1], "f32_logits": steps,
                         "feed": feed, "bf16_logits": bf16,
                         "caches": [{k: c[k] for k in ("k", "v")} for c in first],
                         "cache_bytes": _state_bytes(first, ("k", "v"))}
        del model, first
    torch.save(ref, MODEL_AXIS_REST_REF)
    free_memory()
    return {k: {n: v.cpu() if n.endswith("logits") else v for n, v in r.items()
                if n.endswith(("bytes", "logits"))} for k, r in ref.items()}


def _record_lmme(calls):
    """Wrap ``engine.lmme`` so that its first call at each pair of operand
    shapes keeps its operands (``calls[shapes]``); returns the restore."""
    from repro_torch.core import engine

    fn = engine.lmme

    def wrapped(a, b, *args, **kw):
        key = (tuple(a.log_abs.shape), tuple(b.log_abs.shape))
        if key not in calls:
            calls[key] = [type(x)(x.log_abs.clone(), x.sign.clone()) for x in (a, b)]
        return fn(a, b, *args, **kw)

    engine.lmme = wrapped
    return lambda: setattr(engine, "lmme", fn)


def _kernel_hold(args):
    """The LMME kernel on ``args`` against the float64 plain version, beside
    the f32 plain version (``_kernel_at_split_shapes``' measure)."""
    import torch

    from repro_torch.core import engine

    with torch.no_grad():
        with engine.use_backend("cuda"):
            got = engine.lmme(*args)
        with engine.use_backend("torch_reference"):
            plain = engine.lmme(*args)
            exact = engine.lmme(*(_as(a, torch.float64) for a in args))
            scale = engine.lmme(*(_as(a, torch.float64, True) for a in args))
    return {"dist": goom_dist(got, exact, scale.log_abs),
            "plain_dist": goom_dist(plain, exact, scale.log_abs),
            "finite": bool(torch.isfinite(got.log_abs).eq(torch.isfinite(plain.log_abs)).all())}


def _gaps(steps, want):
    """Each step's largest logit gap over the reference step's std, and the
    argmax tokens (steps, B)."""
    gaps = [float((a - b).abs().max() / b.std()) for a, b in zip(steps, want)]
    return max(gaps), steps.argmax(-1).tolist()


def _block_bytes(model, leaves):
    """The bytes of ``model``'s parameters named ``leaves`` as this rank holds them."""
    total = 0
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in leaves:
            local = p.to_local() if hasattr(p, "to_local") else p
            total += local.numel() * local.element_size()
    return total


def _rest_rank_serve(rank, rules, ref):
    """rwkv6-7b's and mixtral-8x7b's prefill (and rwkv6's decode steps) laid
    out on this rank, fed the reference's tokens; gemma3-1b's under
    ``cache_seq="model"``: its bf16 prefill with the peak above the floor
    (a warm-up prefill first), its f32-KV prefill and decode steps."""
    import torch

    from repro_torch.serve.steps import make_prefill_step
    from repro_torch.sharding import distribute_model, make_rules, use_rules

    out = {}
    rows, n = REST_PREFILL
    t0 = time.perf_counter()
    # rwkv6-7b: the kernels' launches over the run, the LMME operands kept
    cfg = rest_config("rwkv6-7b", REST_RWKV_LAYERS)
    model = _build(cfg)
    distribute_model(model, rules)
    model.requires_grad_(False)
    calls = {}
    restore = _record_lmme(calls)
    reset_counts()
    try:
        with use_rules(rules):
            steps, _, caches = _prefill_decode(model, ref["rwkv6"]["prompt"], n + REST_DECODES,
                                               feed=ref["rwkv6"]["feed"])
        torch.cuda.synchronize()
    finally:
        restore()
    launches, engine_calls = read_counts()
    gap, tokens = _gaps(steps, ref["rwkv6"]["logits"])
    out["rwkv6"] = {"gap": gap, "tokens": tokens, "wkv_bytes": _state_bytes(caches, ("wkv",)),
                    "wkv_shape": tuple(caches[0]["wkv"].shape), "launches": launches,
                    "calls": engine_calls,
                    "lmme": {str(k): dict(_kernel_hold(a), shapes=k) for k, a in calls.items()}}
    del model, caches, calls
    free_memory()
    t1 = time.perf_counter()
    # mixtral-8x7b: dropless prefill
    cfg = rest_config("mixtral-8x7b", REST_MIXTRAL_LAYERS)
    model = _build(cfg)
    distribute_model(model, rules)
    model.requires_grad_(False)
    with use_rules(rules):
        steps, _, _ = _prefill_decode(model, ref["mixtral"]["prompt"], n, decodes=0)
    gap, tokens = _gaps(steps, ref["mixtral"]["logits"])
    out["mixtral"] = {"gap": gap, "tokens": tokens,
                      "expert_bytes": _block_bytes(model, ("gate", "up", "down"))}
    del model
    free_memory()
    t2 = time.perf_counter()
    # gemma3-1b whole, its caches' sequence on "model": f32 K/V first (the
    # decode steps held to one process's; it warms cuBLAS and the allocator
    # up), then bf16 K/V, the prefill's peak measured, then bf16 decode steps
    g_rows, g_n = REST_GEMMA_PREFILL
    seq_rules = make_rules(rules.mesh, {"cache_seq": "model"})
    model = _build(rest_config("gemma3-1b"))
    distribute_model(model, seq_rules)
    model.requires_grad_(False)
    g = ref["gemma3"]
    step = make_prefill_step(model, backend="cuda", fresh_caches=True)
    with use_rules(seq_rules):
        steps, _, _ = _prefill_decode(model, g["prompt"], g_n + REST_DECODES, f32_kv=True,
                                      feed=g["feed"])
        gap, tokens = _gaps(steps, g["f32_logits"])
        del steps
        caches = model.init_caches(g_rows, g_n + REST_DECODES)
        torch.cuda.synchronize()
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        floor = torch.cuda.memory_allocated()
        logits, first = step(g["prompt"], caches)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del caches
        excess = 0.0
        for mine, want in zip(first, g["caches"]):
            for key in ("k", "v"):
                half = want[key].shape[1] // 2
                excess = max(excess, bf16_excess(mine[key],
                                                 want[key][:, rank * half:(rank + 1) * half]))
        prefill_gap, _ = _gaps(logits[:, -1:].float().transpose(0, 1), g["logits"])
        cache_bytes = _state_bytes(first, ("k", "v"))
        k_shapes = sorted({tuple(c["k"].shape) for c in first})
        bf16, _ = _decode_steps(model, first, logits[:, -1].float(), g_n, REST_DECODES,
                                g["feed"])
    want = g["f32_logits"]
    out["gemma3"] = {"peak": peak, "floor": floor, "cache_excess": excess,
                     "prefill_gap": prefill_gap, "cache_bytes": cache_bytes,
                     "k_shapes": k_shapes, "gap": gap, "tokens": tokens,
                     "bf16_gap": max(float((a - b).abs().max() / b.std())
                                     for a, b in zip(bf16, want)),
                     "one_bf16_gap": max(float((a - b).abs().max() / b.std())
                                         for a, b in zip(g["bf16_logits"], want))}
    del model, first, logits, bf16
    free_memory()
    out["seconds"] = {"rwkv6": t1 - t0, "mixtral": t2 - t1,
                      "gemma3": time.perf_counter() - t2}
    return out


def _rest_batch(cfg):
    """The train step's batch: REST_TRAIN tokens from the seed, labels the
    next token (the last masked)."""
    import torch

    rows, n = REST_TRAIN
    tokens = _prompt(cfg, rows, n, 74)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    return {"tokens": tokens, "labels": labels}


def _rest_f64(rank, rules, cfg):
    """The first train step (f32) split on the two ranks, and on rank 0 the
    same step on one process in float64 (``f64_step``'s yardstick, the seed's
    weights cast in place) and in f32: rank 1 sends its gradient blocks to
    rank 0 (CPU tensors over gloo), which sets each block against its block
    of the float64 gradients.  Returns on rank 0
    ``check_f64``'s gaps; on both the rank's expert bytes and the parts'
    seconds."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import engine
    from repro_torch.sharding import distribute_model, use_rules
    from repro_torch.sharding.gather import ParamGather

    clock = [time.perf_counter()]
    secs = {}

    def lap(what):
        clock.append(time.perf_counter())
        secs[what] = round(clock[-1] - clock[-2], 2)

    batch = _rest_batch(cfg)
    model = _build(cfg)
    distribute_model(model, rules)
    named = list(model.named_parameters())
    model_dim = list(rules.mesh.axis_names).index("model")
    lap("build")
    with use_rules(rules), engine.use_backend("cuda"):
        loss, _ = model.loss(batch["tokens"], batch["labels"], param_gather=ParamGather((0,)))
        grads = torch.autograd.grad(loss, [p for _, p in named])
    split_loss = float(loss.detach())
    # the split gradients' sum of squares: a split leaf's blocks on both
    # ranks, a replicated leaf once
    blocks, sq = {}, 0.0
    for (name, p), g in zip(named, grads):
        pl = p.placements[model_dim]
        dim = pl.dim if pl.is_shard() else None
        local = g.to_local().detach()
        if dim is not None or rank == 0:
            sq += float(local.double().square().sum())
        blocks[name] = (local.cpu(), dim)
    expert_bytes = _block_bytes(model, ("gate", "up", "down"))
    del model, grads, named, loss
    free_memory()
    lap("split step")
    if rank == 1:
        dist.send(torch.tensor([sq], dtype=torch.float64), 0)
        for blk, dim in blocks.values():
            if dim is not None:
                dist.send(blk.contiguous(), 0)
        dist.barrier()
        lap("send")
        return {"expert_bytes": expert_bytes, "seconds": secs}
    # float64 first: its parameters and gradients, then only its gradients
    # beside one process's f32 model and gradients (the peak is 4x the f32
    # parameters, not 5x)
    model = _build(cfg).double()
    model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float64, param_dtype=torch.float64)
    with engine.use_backend("torch_reference"):
        loss64, g64 = _grads(model, batch)
    loss64 = float(loss64.detach())
    g64 = {n: g.detach() for n, g in g64.items()}
    del model
    free_memory()
    lap("float64")
    model = _build(cfg)
    with engine.use_backend("cuda"):
        one_loss, one = _grads(model, batch)
    one_loss = float(one_loss.detach())
    one = {n: g.detach() for n, g in one.items()}
    del model
    free_memory()
    lap("one process f32")

    def sq_gap(got, exact):
        return float((got.to(exact.device, torch.float64) - exact).square().sum())

    other = torch.empty(1, dtype=torch.float64)
    dist.recv(other, 1)
    sq += float(other)
    leaves, one_leaves = {}, {}
    for name, exact in g64.items():
        blk, dim = blocks.pop(name)
        if dim is None:
            gap = sq_gap(blk, exact)
        else:
            k = blk.shape[dim]
            rest = torch.empty_like(blk)
            dist.recv(rest, 1)
            gap = sq_gap(blk, exact.narrow(dim, 0, k)) + sq_gap(rest, exact.narrow(dim, k, k))
        ref = float(exact.square().sum())
        leaves[name] = math.sqrt(gap / ref) if ref else math.sqrt(gap)
        gap1 = sq_gap(one[name], exact)
        one_leaves[name] = math.sqrt(gap1 / ref) if ref else math.sqrt(gap1)
    norm64 = math.sqrt(sum(float(g.square().sum()) for g in g64.values()))
    norm1 = math.sqrt(sum(float(g.double().square().sum()) for g in one.values()))
    del g64, one
    free_memory()
    dist.barrier()
    lap("distances")
    rel = lambda x, ref: abs(x - ref) / abs(ref)  # noqa: E731
    return {"expert_bytes": expert_bytes, "seconds": secs,
            "gaps": {"loss": (rel(split_loss, loss64), rel(one_loss, loss64)),
                     "norm": (rel(math.sqrt(sq), norm64), rel(norm1, norm64)),
                     "leaves": leaves, "one_leaves": one_leaves}}


def _model_axis_rest_rank(rank, mesh):
    """``model_axis_rest``'s part of a (1, 2) rank under the default rules on
    ``mesh``: ``_rest_rank_serve``, then the float64 train checks of
    rwkv6-7b at REST_RWKV_TRAIN_LAYERS and mixtral-8x7b at
    REST_MIXTRAL_TRAIN_LAYERS (``_rest_f64``)."""
    import torch

    from repro_torch.sharding import make_rules

    rules = make_rules(mesh)
    ref = torch.load(MODEL_AXIS_REST_REF, map_location=DEVICE)
    out = _rest_rank_serve(rank, rules, ref)
    del ref
    free_memory()
    out["f64"] = {"rwkv6": _rest_f64(rank, rules, rest_config("rwkv6-7b",
                                                               REST_RWKV_TRAIN_LAYERS)),
                  "mixtral": _rest_f64(rank, rules, rest_config("mixtral-8x7b",
                                                                REST_MIXTRAL_TRAIN_LAYERS))}
    return out


def _near_ties(want, got, what):
    """``_near_tie`` over every step and row of ``got`` tokens (steps, B)
    against the reference logits ``want`` (steps, B, V)."""
    for step, row in enumerate(got):
        for i, tok in enumerate(row):
            _near_tie(want[step], i, tok, int(want[step, i].argmax()), f"{what} step {step}")


def model_axis_rest(cell: dict, one: dict, got: list):
    """The rest of the model axis on 2 gloo ranks sharing the card, a (1, 2)
    mesh under the default rules (gemma3 with ``cache_seq="model"``), at
    full width and f32 compute.  rwkv6-7b at REST_RWKV_LAYERS (32 of 64
    heads and 7168 of 14336 channels a rank): a fresh prefill of
    REST_PREFILL and REST_DECODES decode steps, each rank's ``wkv`` bytes
    half of one process's, every step's logits within MODEL_AXIS_LOGIT_STD·std
    of one process's and its tokens equal but at a near tie, LMME launches
    equal to engine calls, the LMME kernel at the split chunk and decode
    shapes on the layer's operands within twice the f32 plain version's
    distance to float64.  mixtral-8x7b at REST_MIXTRAL_LAYERS: a dropless
    prefill of REST_PREFILL against one process's, each rank's expert bytes
    half of one process's.  gemma3-1b whole (one KV head, its caches'
    sequence on "model"): a fresh bf16 prefill of REST_GEMMA_PREFILL, each
    rank's cache bytes half of one process's and its caches its row block
    within a bf16 step and MODEL_AXIS_CACHE_EXCESS, the prefill's logits as
    above, the peak above the floor within FSDP_PEAK_FACTOR of the dry-run's
    (1, 2) cell; with f32 K/V (a bf16 write can round K/V a step apart)
    REST_DECODES decode steps, logits and tokens as rwkv6's; with bf16 K/V
    the same steps (bf16 products, f32 outputs) within F64_SPREAD times one
    bf16 process's distance to the f32-KV logits.  rwkv6-7b at
    REST_RWKV_TRAIN_LAYERS and mixtral-8x7b at REST_MIXTRAL_TRAIN_LAYERS
    (capacity routing): the first f32 train step's loss, norm and each
    leaf's gradient against float64
    within F64_SPREAD of one f32 process's distance (``check_f64``).  ``one``
    is ``model_axis_rest_reference``'s, ``got`` each rank's
    ``_model_axis_rest_rank``, ``cell`` ``rest_dryrun_cell``'s."""
    pm = cell["memory_per_device"]
    heads = rest_config("rwkv6-7b").layer_list[0].rwkv.n_heads // 2
    for rank, r in enumerate(got):
        w, m, g = r["rwkv6"], r["mixtral"], r["gemma3"]
        ratio = pm["above_state_bytes"] / (g["peak"] - g["floor"])
        print(f"model axis rest, rank {rank} of (1, 2): rwkv6-7b {REST_RWKV_LAYERS} layers "
              f"prefill {REST_PREFILL[0]}x{REST_PREFILL[1]} + {REST_DECODES} decode steps: "
              f"wkv {w['wkv_shape']} a layer, {w['wkv_bytes']} bytes of one process's "
              f"{one['rwkv6']['wkv_bytes']}, logits {w['gap']:.3e}·std (bar "
              f"{MODEL_AXIS_LOGIT_STD}), LMME launches {w['launches']['lmme']}, engine calls "
              f"{w['calls']['lmme']}; mixtral-8x7b {REST_MIXTRAL_LAYERS} layers dropless "
              f"prefill logits {m['gap']:.3e}·std, expert bytes {m['expert_bytes']} of "
              f"{one['mixtral']['expert_bytes']}; gemma3-1b prefill "
              f"{REST_GEMMA_PREFILL[0]}x{REST_GEMMA_PREFILL[1]} (cache_seq on model): K "
              f"{g['k_shapes']}, {g['cache_bytes'] / 2**30:.4f} GiB of one process's "
              f"{one['gemma3']['cache_bytes'] / 2**30:.4f}, its rows within a bf16 step and "
              f"{g['cache_excess']:.3e} (bar {MODEL_AXIS_CACHE_EXCESS}), prefill logits "
              f"{g['prefill_gap']:.3e}·std, f32-KV decode logits {g['gap']:.3e}·std, bf16 "
              f"decode logits {g['bf16_gap']:.3e}·std from one process's f32-KV (one "
              f"process's bf16 {g['one_bf16_gap']:.3e}), peak "
              f"above the floor {(g['peak'] - g['floor']) / 2**30:.4f} GiB, the dry-run's "
              f"(1, 2) cell {pm['above_state_bytes'] / 2**30:.4f} (ratio {ratio:.4f}); "
              f"{card_line()}", flush=True)
        check(2 * w["wkv_bytes"] == one["rwkv6"]["wkv_bytes"], f"rwkv6 rank {rank}: wkv bytes "
              f"{w['wkv_bytes']}")
        check(2 * m["expert_bytes"] == one["mixtral"]["expert_bytes"],
              f"mixtral rank {rank}: expert bytes {m['expert_bytes']}")
        check(2 * g["cache_bytes"] == one["gemma3"]["cache_bytes"],
              f"gemma3 rank {rank}: cache bytes {g['cache_bytes']}")
        check(g["cache_excess"] <= MODEL_AXIS_CACHE_EXCESS,
              f"gemma3 rank {rank}: caches {g['cache_excess']:.3e} past a bf16 step")
        for what, gap in (("rwkv6", w["gap"]), ("mixtral", m["gap"]),
                          ("gemma3 prefill", g["prefill_gap"]), ("gemma3 decode", g["gap"])):
            check(gap <= MODEL_AXIS_LOGIT_STD, f"model axis rest rank {rank}: {what} logits "
                  f"{gap:.3e}·std")
        for what, tokens, want in (("rwkv6", w["tokens"], one["rwkv6"]["logits"]),
                                   ("mixtral", m["tokens"], one["mixtral"]["logits"]),
                                   ("gemma3", g["tokens"], one["gemma3"]["f32_logits"])):
            _near_ties(want, tokens, f"model axis rest rank {rank} {what}")
        check(g["bf16_gap"] <= F64_SPREAD * max(g["one_bf16_gap"], MODEL_AXIS_LOGIT_STD),
              f"gemma3 rank {rank}: bf16 decode logits {g['bf16_gap']:.3e}·std, one "
              f"process's {g['one_bf16_gap']:.3e}")
        check(w["launches"]["lmme"] == w["calls"]["lmme"] > 0, f"rwkv6 rank {rank}: LMME "
              f"launches {w['launches']['lmme']} != engine calls {w['calls']['lmme']}")
        check(1 / FSDP_PEAK_FACTOR <= ratio <= FSDP_PEAK_FACTOR, f"gemma3 rank {rank}: peak "
              f"above the floor against the dry-run's, ratio {ratio:.3f}")
        seen = set()
        for k in w["lmme"].values():
            a, b = k["shapes"]
            print(f"model axis rest: rank {rank}'s rwkv6 LMME at {a} x {b}: distance to "
                  f"float64 on the kernel {k['dist']:.3e}, of the f32 plain version "
                  f"{k['plain_dist']:.3e} (the kernel within twice it, floor 1e-6), finite "
                  f"entries alike {k['finite']}", flush=True)
            check(a[1] == b[1] == heads, f"rwkv6 rank {rank}: LMME at {a} x {b}")
            check(k["dist"] <= 2.0 * k["plain_dist"] + 1e-6 and k["finite"],
                  f"rwkv6 rank {rank}: LMME {k}")
            seen.add("decode" if a[2] == 1 else "chunk")
        check(seen == {"decode", "chunk"}, f"rwkv6 rank {rank}: LMME shapes {seen}")
    f64 = {arch: check_f64(got[0]["f64"][arch]["gaps"], f"model axis rest: {label} first f32 "
                           f"step on (1, 2), {card_line()}", "gradients")
           for arch, label in (("rwkv6", f"rwkv6-7b {REST_RWKV_TRAIN_LAYERS} layers"),
                               ("mixtral", f"mixtral-8x7b {REST_MIXTRAL_TRAIN_LAYERS} layer, "
                                           "capacity routing"))}
    return {"one": {k: {n: v for n, v in r.items() if n.endswith("bytes")}
                    for k, r in one.items()},
            "ranks": got, "f64": f64,
            "lmme_launches": [r["rwkv6"]["launches"]["lmme"] for r in got]}


# ---------------------------------------------------------------------------
# phase 14: autotune on the card
# ---------------------------------------------------------------------------
#: DEFAULT_SHAPES, then goom-rnn's with-B decode (T=1, d=16, m=4) and its
#: 64-token prefill chunk (T=64, d=16, m=1), swept twice: the two sweeps,
#: timed by the kernels' device time, must pick the same winner
AUTOTUNE_CHUNK = (64, 16, 1)
AUTOTUNE_SHAPES = [None, {"matrix_scan": (1, 16, 4)}, {"matrix_scan": AUTOTUNE_CHUNK},
                   {"matrix_scan": AUTOTUNE_CHUNK}]


def autotune_phase():
    """``engine.autotune()`` on the card: every candidate's ms; then the next
    engine call at each tuned scan shape launches with the cached winner's
    L, and with the cache gone with the default L.  The cache is a file of
    this run's (``REPRO_TORCH_AUTOTUNE_CACHE``), deleted after.  Returns
    the phase's launches."""
    import os

    import torch

    from repro_torch.core import engine
    from repro_torch.core.goom import to_goom
    from repro_torch.kernels import autotune
    from repro_torch.kernels.goom_scan import matrix_scan_cuda
    from repro_torch.kernels.goom_scan.ops import with_b_chunk_len, zero_b_chunk_len
    from repro_torch.serve import graphs

    card = card_line()
    before = graphs.kernel_launches()
    reports = []
    for shapes in AUTOTUNE_SHAPES:
        ops = None if shapes is None else tuple(shapes)
        reports += list(engine.autotune(ops, shapes=shapes, reps=20).values())
    for r in reports:
        cells = ", ".join(
            f"{'/'.join(f'{k}={v}' for k, v in row['blocks'].items()) or 'default'}: "
            + (f"{row['ms']:.4f}" if "ms" in row else f"error {row['error']}")
            for row in r["table"])
        print(f"autotune [{r['op']} {tuple(r['shapes'])}] ms a call: {cells}; winner "
              f"{r['blocks'] or 'default'} {r['ms']:.4f} ms; {card}", flush=True)
    twice = [r for r in reports if r["op"] == "matrix_scan"
             and tuple(r["shapes"]) == AUTOTUNE_CHUNK]
    check(len(twice) == 2 and twice[0]["blocks"] == twice[1]["blocks"],
          f"autotune [matrix_scan {AUTOTUNE_CHUNK}]: two sweeps picked "
          f"{[r['blocks'] for r in twice]}")
    print(f"autotune [matrix_scan {AUTOTUNE_CHUNK}]: two sweeps on device time picked "
          f"{twice[0]['blocks']} both ({twice[0]['ms']:.4f} and {twice[1]['ms']:.4f} ms)",
          flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    for r in reports:
        if r["op"] not in ("matrix_scan", "cumulative_lmme"):
            continue
        t, d = r["shapes"][:2]
        a = to_goom(torch.randn(t, d, d, generator=gen, device=DEVICE))
        if r["op"] == "matrix_scan":
            b = to_goom(torch.randn(t, d, r["shapes"][2], generator=gen, device=DEVICE))
            call, default = (lambda: engine.matrix_scan(a, b)), with_b_chunk_len(t, d)
        else:
            call, default = (lambda: engine.cumulative_lmme(a)), zero_b_chunk_len(t, d)
        want = t if r["blocks"].get("algo") == "seq" else r["blocks"].get("block_t", default)
        call()
        tuned = matrix_scan_cuda.last_chunk[3]
        check(tuned == want, f"autotune [{r['op']} {tuple(r['shapes'])}]: the next call "
              f"launched with L={tuned}, the cached winner is L={want}")
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(ROOT / "build" / "no_such_cache.json")
        autotune.load_cache(os.environ["REPRO_TORCH_AUTOTUNE_CACHE"], reload=True)
        call()
        plain = matrix_scan_cuda.last_chunk[3]
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = AUTOTUNE_CACHE
        autotune.load_cache(AUTOTUNE_CACHE, reload=True)
        check(plain == default, f"autotune [{r['op']}]: with no cache L={plain}, "
              f"the default is {default}")
        print(f"autotune [{r['op']} {tuple(r['shapes'])}]: the next engine call launched "
              f"with the cached L={tuned}; with no cache L={plain} (the default)",
              flush=True)
    _sync()
    launches = {k: v - before[k] for k, v in graphs.kernel_launches().items()}
    os.remove(AUTOTUNE_CACHE)
    autotune.load_cache(reload=True)
    return launches, reports


def max_d_phase():
    """``MAX_D``: on the card the matrix scan and the prefix products at
    d = 129 raise the wrapper's ValueError (``kernels/goom_scan/ops.py``)."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core.goom import to_goom

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    a = to_goom(torch.randn(4, 129, 129, generator=gen, device=DEVICE))
    b = to_goom(torch.randn(4, 129, 1, generator=gen, device=DEVICE))
    for name, fn in (("matrix_scan", lambda: engine.matrix_scan(a, b)),
                     ("cumulative_lmme", lambda: engine.cumulative_lmme(a))):
        try:
            fn()
        except ValueError as e:
            check("d <= 128" in str(e), f"{name} at d=129 raised {e!r}")
            continue
        raise RuntimeError(f"{name} at d=129 on the card did not raise")
    print("MAX_D: engine.matrix_scan and cumulative_lmme at d=129 raise ValueError "
          "(the kernels take d <= 128)", flush=True)


def layer_breakdown(model):
    """Device ms per decode step (4 slots) by layer kind: one layer of each
    kind timed alone at the decode shape (its pre-norm included; attention
    over dense caches of ``page_len`` rows, windowed attention apart), times
    the model's count of that kind, and the lm_head; against the step's
    weight bytes at 3.35 TB/s."""
    import torch

    cfg, cd = model.cfg, model.cfg.compute_dtype
    b, page_len = SERVE["max_slots"], SERVE["page_len"]
    caches = model.init_caches(b, page_len)
    pos = torch.zeros(b, 1, dtype=torch.long, device=DEVICE)
    x = torch.randn(b, 1, cfg.d_model, device=DEVICE).to(cd)
    kinds = {}
    for i, blk in enumerate(cfg.layer_list):
        for part, kind in (("mixer", blk.mixer), ("channel", blk.channel)):
            if kind == "attention" and blk.attn.window is not None:
                kind = "windowed attention"
            if kind != "none":
                kinds.setdefault(kind, [part, i, 0])[2] += 1
    out = {}
    with torch.no_grad():
        for kind, (part, i, count) in kinds.items():
            layer = model.layers[i]
            norm, mod = getattr(layer, f"{part}_norm"), getattr(layer, part)
            if kind.endswith("attention"):
                fn = lambda: mod(norm(x), positions=pos, cache=caches[i], compute_dtype=cd)  # noqa: E731
            elif kind == "moe":
                fn = lambda: mod(norm(x), compute_dtype=cd, dropless=True)  # noqa: E731
            elif part == "mixer":
                fn = lambda: mod(norm(x), state=caches[i], compute_dtype=cd)  # noqa: E731
            else:
                fn = lambda: mod(norm(x), compute_dtype=cd)  # noqa: E731
            out[kind] = count * device_ms(fn, 5)
        out["lm_head"] = device_ms(lambda: model.logits(model.final_norm(x)), 5)
    from repro_torch.launch.roofline import HBM_BW

    weights_ms = 1e3 * sum(p.numel() * p.element_size() for p in model.parameters()) / HBM_BW
    print(f"layers [{path_label(cfg)}]: device ms per decode step (4 slots) by kind "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
          + f"; sum {sum(out.values()):.3f}; reading every weight once takes "
          f"{weights_ms:.3f} ms at 3.35 TB/s", flush=True)
    return out


# a family's bf16 weights at most: full depth where they fit, else the
# most whole layers that do (depth only; widths are the published ones)
FAMILY_WEIGHT_BYTES = 40e9
def weight_bytes(cfg):
    """(bytes of each layer, bytes outside the layers) of ``cfg``'s weights,
    sized on the meta device (nothing allocated)."""
    import torch

    from repro_torch import DecoderLM

    m = DecoderLM(cfg, device="meta", generator=torch.Generator())
    layers = [sum(p.numel() * p.element_size() for p in blk.parameters())
              for blk in m.layers]
    total = sum(p.numel() * p.element_size() for p in m.parameters())
    return layers, total - sum(layers)


#: cuts in depth for the run's time: codeqwen1.5-7b's and glm4-9b's attention
#: runs olmo-1b's code, which runs at full depth; the MoE families' layers
#: are all alike (2 of them still route over all 16 or 8 experts);
#: rwkv6-7b's layers are all alike, and 4 of them read 1.9 GB a decode step;
#: olmo-1b runs whole in the long-attention and model-axis phases, so 8 of
#: its 16 layers serve here
DEPTH_CUTS = {"codeqwen1.5-7b": 2, "glm4-9b": 2, "phi3.5-moe": 2, "mixtral-8x7b": 2,
              "rwkv6-7b": 4, "olmo-1b": 8}
#: cuts in periods: gemma3-1b serves one period of each group (5 local and 1
#: global layer, then its 2 local ones: paged global KV beside rings); its
#: 26 layers run whole in ``long_attention_phase``
PERIOD_CUTS = {"gemma3-1b": 1}


def family_config(arch):
    """``arch`` at full width with bf16 weights, cut in depth to the most
    whole layers whose weights fit in ``FAMILY_WEIGHT_BYTES``, and to
    ``DEPTH_CUTS``; each group to at most ``PERIOD_CUTS`` periods."""
    import torch

    from repro_torch import get_config

    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16)
    if arch in PERIOD_CUTS:
        groups = tuple(dataclasses.replace(g, n_periods=min(g.n_periods, PERIOD_CUTS[arch]))
                       for g in cfg.groups)
        cfg = dataclasses.replace(cfg, groups=groups, n_layers=sum(
            len(g.period) * g.n_periods for g in groups))
    layers, rest = weight_bytes(cfg)
    depth = cfg.n_layers
    if rest + sum(layers) > FAMILY_WEIGHT_BYTES:
        depth = int((FAMILY_WEIGHT_BYTES - rest) // layers[0])
    depth = min(depth, DEPTH_CUTS.get(arch, depth))
    if depth == cfg.n_layers:
        return cfg
    check(len(cfg.groups) == 1 and len(cfg.groups[0].period) == 1,
          f"{arch}: only a config of one repeated layer is cut in depth here")
    return dataclasses.replace(cfg, n_layers=depth, groups=(
        dataclasses.replace(cfg.groups[0], n_periods=depth),))


@contextlib.contextmanager
def f32_kv(model):
    """Within: every cache ``model`` builds (``init_caches``, and through it
    ``init_slot_caches``) holds its attention K/V in f32, where the model
    keeps bf16 as the JAX package does."""
    build = model.init_caches

    def init_caches(*args, **kw):
        return [{k: v.float() if k in ("k", "v") and "index" in c else v
                 for k, v in c.items()} for c in build(*args, **kw)]

    model.init_caches = init_caches
    try:
        yield model
    finally:
        del model.init_caches


def _near_tie(logits, i, got, want, what):
    """Fails unless the top-2 margin of ``logits[i]`` is below 1e-4·std;
    True when ``got`` and ``want`` differ there (a near tie)."""
    import torch

    if got == want:
        return False
    top2 = torch.topk(logits[i], 2).values
    margin = float(top2[0] - top2[1])
    check(margin < 1e-4 * float(logits[i].std()),
          f"{what} token {i}: cached {got} vs uncached {want} at margin {margin:.3e}")
    return True


#: the rolling-buffer check: prefill chunks of window + RING_FIRST (the chunk
#: fills the buffer: the roll) and RING_SECOND tokens (a scatter at (start +
#: i) % length that wraps), then RING_DECODE greedy decode steps at index %
#: length; the buffer is window rows (max_len is above the window)
RING_FIRST, RING_SECOND, RING_DECODE = 200, 400, 16


def ring_phase(model, cfg):
    """At f32 compute with f32 KV: windowed layers' rolling buffers wrapping
    on the card.  One prompt of window + RING_FIRST + RING_SECOND tokens
    through ``init_caches(1, L)`` with L above the window (so each windowed
    layer keeps a ring of ``window`` rows), prefilled in two chunks, then
    RING_DECODE greedy decode steps.  Against one no-cache forward over the
    prompt and the decoded tokens: each chunk's last logits and each decode
    step's within 1e-4·std, and the decoded tokens equal to its argmax,
    except after a near tie.  The sequence outruns the window, so the mask
    drops positions."""
    import torch

    variant = path_label(cfg)
    window = max(b.attn.window for b in cfg.layer_list
                 if b.mixer == "attention" and b.attn.window is not None)
    n1, n2 = window + RING_FIRST, RING_SECOND
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    seq = torch.randint(0, cfg.vocab, (1, n1 + n2), generator=gen, device=DEVICE)
    with torch.no_grad(), f32_kv(model):
        caches = model.init_caches(1, n1 + n2 + RING_DECODE)
        rows = {c["k"].shape[1] for c, b in zip(caches, cfg.layer_list)
                if b.mixer == "attention" and b.attn.window is not None}
        check(rows == {window}, f"ring [{variant}]: windowed buffers of {rows} rows")
        lg1, caches = model.prefill(seq[:, :n1], caches)
        pos = torch.arange(n1, n1 + n2, device=DEVICE)[None]
        lg2, caches = model.prefill(seq[:, n1:], caches, pos)
        got = [(n1 - 1, lg1[0, -1]), (n1 + n2 - 1, lg2[0, -1])]
        out = [int(lg2[0, -1].argmax())]
        for i in range(RING_DECODE - 1):
            idx = torch.tensor([n1 + n2 + i], device=DEVICE)
            lg, caches = model.decode_step(torch.tensor([[out[-1]]], device=DEVICE),
                                           caches, idx)
            got.append((n1 + n2 + i, lg[0, -1]))
            out.append(int(lg[0, -1].argmax()))
        full = model(torch.cat([seq, torch.tensor([out[:-1]], device=DEVICE)], 1))[0].float()
    gaps = [float((row.float() - full[p]).abs().max() / full[p].std()) for p, row in got]
    check(max(gaps) < 1e-4, f"ring [{variant}]: logits through the rings "
          f"{max(gaps):.3e}·std from the no-cache forward's (chunks {gaps[:2]})")
    tail = full[n1 + n2 - 1:]
    compared, stopped = 0, None
    for i, (x, y) in enumerate(zip(out, tail.argmax(-1).tolist())):
        if _near_tie(tail, i, x, y, f"ring [{variant}]: decode"):
            stopped = i
            break
        compared += 1
    print(f"ring [{variant}] (f32, f32 KV): {n1 + n2}-token prompt in chunks of {n1} and "
          f"{n2} and {RING_DECODE} decode steps over rings of {window} rows; chunks' last "
          f"logits {gaps[0]:.3e} and {gaps[1]:.3e}·std, decode steps' at most "
          f"{max(gaps[2:]):.3e}·std from the no-cache forward's; "
          f"{compared} decoded tokens equal to its argmax; stopped at a near tie "
          f"{stopped if stopped is not None else 'none'}", flush=True)
    return dict(gaps=gaps, compared=compared, stopped=stopped)


def cached_vs_uncached_phase(model, cfg, reqs):
    """At f32 compute and with f32 KV caches, on the same weights (each
    product casts its bf16 weight): the Engine's greedy tokens, served
    through paged global KV and dense rolling buffers, against the argmax
    of one no-cache forward over prompt + generated tokens at each
    generated position; tokens equal except after a near tie (top-2 margin
    of the uncached logits below 1e-4·std).  Also a prefill's last logits
    through dense caches against the forward's, within 1e-4·std.  The KV
    is f32 here because bf16 KV rounding parts the two paths by ~2e-2·std
    (measured on the card), and an MoE's top-2 routing then flips for some
    token, a difference of whole experts.  An MoE's capacity factor is set
    to E/k for the run, so that the no-cache forward gives every token all
    its experts: the serving (dropless) routing."""
    import torch

    variant = path_label(cfg)
    moes = [layer.channel for layer in model.layers if layer.blk.channel == "moe"]
    moe_cfgs = [m.cfg for m in moes]
    model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    for m in moes:
        m.cfg = dataclasses.replace(m.cfg, capacity_factor=m.cfg.n_experts / m.cfg.top_k)
    try:
        torch.cuda.reset_peak_memory_stats()
        with f32_kv(model):
            got, _, _ = serve(model, reqs)
        compared, stopped = 0, []
        with torch.no_grad():
            for r in reqs:
                out, p = got[r.uid], len(r.prompt)
                seq = torch.tensor([list(r.prompt) + out[:-1]], device=DEVICE)
                lg = model(seq)[0, p - 1:].float()            # (len(out), vocab)
                for i, (x, y) in enumerate(zip(out, lg.argmax(-1).tolist())):
                    if _near_tie(lg, i, x, y, f"{variant}: request {r.uid}"):
                        stopped.append((r.uid, i))
                        break
                    compared += 1
            seq = torch.tensor([max((list(r.prompt) for r in reqs), key=len)],
                               device=DEVICE)
            with f32_kv(model):
                lg_cached, _ = model.prefill(seq, model.init_caches(1, SERVE["page_len"]))
            lg_full = model(seq)[:, -1:]
        gap = float((lg_cached - lg_full).abs().max() / lg_full.float().std())
        check(gap < 1e-4, f"{variant}: prefill logits through the caches "
              f"{gap:.3e}·std from the no-cache forward's")
        ring = (ring_phase(model, cfg) if any(
            b.mixer == "attention" and b.attn.window is not None for b in cfg.layer_list)
            else None)
    finally:
        model.cfg = cfg
        for m, c in zip(moes, moe_cfgs):
            m.cfg = c
    print(f"cached [{variant}] (f32, f32 KV): {compared} Engine tokens equal to the no-cache "
          f"forward's argmax; stopped at near ties {stopped or 'none'}; a "
          f"{seq.shape[1]}-token prefill's last logits through the caches "
          f"{gap:.3e}·std from the no-cache forward's; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return dict(compared=compared, stopped=stopped, gap=gap, ring=ring)


def families_phase():
    """Each attention family at full width, bf16 weights, depth cut only to
    fit ``FAMILY_WEIGHT_BYTES``: the closed batch through the graphed Engine
    at horizons 8 and 1 (``serve_phase``), the graphed decode step
    (``trace_phase``) and its device time by layer kind
    (``layer_breakdown``), the f32 cached-against-uncached check (with the
    wrapping rings of ``ring_phase`` for windowed models), and for gemma3-1b
    (paged global layers beside dense rings) prefix reuse.  Each
    model is freed before the next is built."""
    import torch

    from repro_torch import get_config

    out = {}
    for arch in FAMILIES:
        t_arch = time.perf_counter()
        free_memory()
        cfg = family_config(arch)
        model, reqs, stats = serve_phase(cfg)
        trace = trace_phase(model, stats["per_decode"], eager=False)
        layers = layer_breakdown(model)
        prefix = prefix_phase(model) if arch == "gemma3-1b" else None
        free_memory()
        cached = cached_vs_uncached_phase(model, cfg, reqs)
        n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        del model
        out[arch] = dict(stats=stats, trace=trace, layers=layers, prefix=prefix,
                         cached=cached)
        print(f"family [{arch}]: {cfg.n_layers} of {get_config(arch).n_layers} layers "
              f"({n_bytes / 1e9:.2f} GB of bf16 weights); graphed decode step (4 slots) "
              f"{trace['step_ms']:.3f} ms wall / {trace['busy_ms']:.3f} ms busy, idle "
              f"{trace['idle']:.3f}; {stats['tokens_per_s']:.1f} tokens/s at horizon 8, "
              f"{stats['tokens_per_s_k1']:.1f} at 1 (tokens equal); peak memory "
              f"{stats['peak_bytes'] / 2**30:.2f} GiB serving; "
              f"{time.perf_counter() - t_arch:.1f} s", flush=True)
    free_memory()
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 10: the frontend models through generate
# ---------------------------------------------------------------------------
#: per model: B prompts of this many tokens; for M-RoPE the patch grid's side
FRONTENDS = {"musicgen-large": dict(batch=4, prompt=128, grid=None),
             "qwen2-vl-7b": dict(batch=4, prompt=320, grid=16)}
GEN_TOKENS, GEN_MAX_LEN = 32, 512
#: replays of generate's decode graph timed by wall clock, and profiled
FRONT_TIMED, FRONT_PROFILED = 16, 8


def frontend_inputs(cfg, batch, length, grid, gen):
    """(prompts (B, P), kw): ``prefix_embeds`` (B, n_prefix, d) at
    0.02·N(0, 1), standing in for EnCodec frames or patch embeddings, and
    for M-RoPE ``mrope_positions`` (3, B, P): the first n_prefix positions
    a grid of ``grid`` columns (t = 0, h = i // grid, w = i % grid), the
    text after it at its absolute index on all three streams, which is
    what ``decode_step`` continues."""
    import torch

    prompt = torch.randint(0, cfg.vocab, (batch, length), generator=gen, device=DEVICE)
    kw = {"prefix_embeds": 0.02 * torch.randn(batch, cfg.n_prefix, cfg.d_model,
                                              generator=gen, device=DEVICE)}
    if cfg.mrope:
        i = torch.arange(length, device=DEVICE)
        img = i < cfg.n_prefix
        kw["mrope_positions"] = torch.stack([
            torch.where(img, 0, i), torch.where(img, i // grid, i),
            torch.where(img, i % grid, i)])[:, None].expand(3, batch, length)
    return prompt, kw


def generate_trace(model, prompt, kw):
    """``generate``'s decode step over B rows: after a single-shot prefill,
    captured once (``StepGraphs``) over static token, index and cache
    tensors, then its replays timed by wall clock and profiled: wall, busy
    ms, kernels and idle share a step, as ``trace_phase`` reads the
    Engine's."""
    import torch

    from repro_torch.serve import StepGraphs, make_decode_in_place

    b, p = prompt.shape
    with torch.no_grad():
        logits, caches = model.prefill(prompt, model.init_caches(b, GEN_MAX_LEN), **kw)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    index = torch.full((b,), p, dtype=torch.long, device=DEVICE)
    graphs, step = StepGraphs(), make_decode_in_place(model)

    def run():
        graphs.run("generate_decode", step, tok, caches, index)

    run()   # the capture
    run()
    wall = _timed(run, FRONT_TIMED)
    prof = _profiled(run, FRONT_PROFILED)
    busy = _device_ms(prof) / FRONT_PROFILED
    check(DEVICE == "cpu" or graphs.n_graphs == 1,   # a CPU rehearsal captures nothing
          f"generate's decode: {graphs.n_graphs} graphs")
    return dict(step_ms=wall, busy_ms=busy,
                kernels=_kernel_kinds(prof)["all"] / FRONT_PROFILED, idle=1 - busy / wall)


def frontends_phase():
    """musicgen-large and qwen2-vl-7b at full width and depth, bf16 weights
    from seed 0, one at a time: the Engine refuses them (as JAX's does);
    ``generate`` with ``prefix_embeds`` (and ``mrope_positions``) serves B
    prompts: a single-shot prefill's time, ``GEN_TOKENS`` tokens with no
    GOOM kernel launched, the graphed decode step traced
    (``generate_trace``), the device time by layer kind; then at f32
    compute with f32 KV on the same weights, ``generate``'s tokens against
    the argmax of one no-cache forward over prompt + tokens with the same
    prefix and positions, at every generated position (``_near_tie``)."""
    import torch

    from repro_torch import DecoderLM, Engine, get_config
    from repro_torch.serve import generate

    out = {}
    for arch, shape in FRONTENDS.items():
        free_memory()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(get_config(arch), param_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        model = DecoderLM(cfg, device=DEVICE,
                          generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        try:
            Engine(model, **SERVE)
        except NotImplementedError as e:
            refused = str(e)
        else:
            raise RuntimeError(f"{arch}: the Engine took a frontend model")
        b, p = shape["batch"], shape["prompt"]
        prompt, kw = frontend_inputs(cfg, b, p, shape["grid"],
                                     torch.Generator(device=DEVICE).manual_seed(SEED + 23))

        with torch.no_grad():
            def prefill():
                return model.prefill(prompt, model.init_caches(b, GEN_MAX_LEN), **kw)
            prefill()
            prefill_ms = _timed(prefill, 3)
            prefill_busy = device_ms(prefill, 2)
        reset_counts()
        t0 = time.perf_counter()
        toks = generate(model, prompt, GEN_TOKENS, GEN_MAX_LEN, **kw)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches, calls = read_counts()
        check_launches(launches, calls, f"generate [{arch}]", set())
        check(tuple(toks.shape) == (b, GEN_TOKENS)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{arch}: generate gave {tuple(toks.shape)} tokens or ids out of vocabulary")
        trace = generate_trace(model, prompt, kw)
        peak = torch.cuda.max_memory_allocated()
        layers = layer_breakdown(model)

        free_memory()
        torch.cuda.reset_peak_memory_stats()
        model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        try:
            with f32_kv(model):
                toks32 = generate(model, prompt, GEN_TOKENS, GEN_MAX_LEN, **kw)
            full_kw = dict(kw)
            if cfg.mrope:
                tail = torch.arange(p, p + GEN_TOKENS - 1, device=DEVICE).expand(3, b, -1)
                full_kw["mrope_positions"] = torch.cat([kw["mrope_positions"], tail], 2)
            with torch.no_grad():
                seq = torch.cat([prompt, toks32[:, :-1]], 1)
                lg = model(seq, **full_kw)[:, p - 1:].float()    # (B, GEN_TOKENS, vocab)
        finally:
            model.cfg = cfg
        peak32 = torch.cuda.max_memory_allocated()
        compared, stopped = 0, []
        for r in range(b):
            for i, (x, y) in enumerate(zip(toks32[r].tolist(), lg[r].argmax(-1).tolist())):
                if _near_tie(lg[r], i, x, y, f"{arch}: row {r}"):
                    stopped.append((r, i))
                    break
                compared += 1
        del model, lg
        steady = b / trace["step_ms"] * 1e3
        grid = (f", M-RoPE grid {shape['grid']}x{cfg.n_prefix // shape['grid']} then text "
                "at its index" if cfg.mrope else ", sinusoidal positions")
        print(f"frontend [{arch}]: {cfg.n_layers} layers d={cfg.d_model} vocab={cfg.vocab}, "
              f"{n_params / 1e6:.1f}M params ({n_bytes / 1e9:.2f} GB in bf16), built in "
              f"{t_build:.1f} s; {b} prompts of {p} tokens, prefix_embeds on the first "
              f"{cfg.n_prefix}{grid}; single-shot prefill {prefill_ms:.3f} ms wall, "
              f"{prefill_busy:.3f} ms device busy (eager); generate "
              f"{GEN_TOKENS} tokens a row in {gen_s:.3f} s = {b * GEN_TOKENS / gen_s:.1f} "
              f"tokens/s (prefill and the decode graph's capture included); graphed decode "
              f"step ({b} rows) {trace['step_ms']:.3f} ms wall / {trace['busy_ms']:.3f} ms "
              f"busy in {trace['kernels']:.0f} kernels, idle {trace['idle']:.3f} = "
              f"{steady:.1f} tokens/s steady; peak {peak / 2**30:.2f} GiB; launches "
              f"{launches}; Engine refuses: {refused!r}", flush=True)
        print(f"frontend [{arch}] (f32, f32 KV): {compared} generate tokens equal to a "
              f"no-cache forward's argmax; stopped at near ties {stopped or 'none'}; peak "
              f"{peak32 / 2**30:.2f} GiB", flush=True)
        out[arch] = dict(prefill_ms=prefill_ms, prefill_busy_ms=prefill_busy, tokens_per_s=b * GEN_TOKENS / gen_s,
                         steady_tokens_per_s=steady, trace=trace, peak_bytes=peak,
                         layers=layers, launches=launches, compared=compared,
                         stopped=stopped, n_bytes=n_bytes)
    free_memory()
    return out


#: banded against dense: sequence lengths of at least two windows
BANDED_LENS = [32, 70, 200]


def banded_phase():
    """gemma3-1b's smoke config at f32 with every attention layer flipped to
    banded sliding windows (``transform_blocks``) against the same weights
    dense: the local layers' two-block band at S >= 2·window, logits within
    1e-5·std of the dense windowed path's."""
    import torch

    from repro_torch import DecoderLM, get_config
    from repro_torch.configs import transform_blocks

    cfg = dataclasses.replace(get_config("gemma3-1b", smoke=True), compute_dtype=torch.float32)
    banded_cfg = transform_blocks(cfg, lambda blk: dataclasses.replace(
        blk, attn=dataclasses.replace(blk.attn, use_banded=True)))
    window = max(blk.attn.window or 0 for blk in cfg.layer_list)
    dense = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    banded = DecoderLM(banded_cfg, device=DEVICE,
                       generator=torch.Generator(device=DEVICE).manual_seed(SEED + 1))
    banded.load_state_dict(dense.state_dict())
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 29)
    gaps = {}
    with torch.no_grad():
        for s in BANDED_LENS:
            check(s >= 2 * window, f"banded: S={s} below two windows of {window}")
            seq = torch.randint(0, cfg.vocab, (2, s), generator=gen, device=DEVICE)
            want = dense(seq)
            gaps[s] = float((banded(seq) - want).abs().max() / want.std())
    check(max(gaps.values()) < 1e-5, f"banded: logits {gaps} (·std) from the dense path's")
    print(f"banded (gemma3-1b smoke, f32, windows of {window}): logits at S = "
          + ", ".join(f"{s}: {g:.3e}" for s, g in gaps.items())
          + "·std from the dense windowed path's", flush=True)
    return gaps


# ---------------------------------------------------------------------------
# phase 10b: flash attention at long context, and Jamba's training, on the card
# ---------------------------------------------------------------------------
#: gemma3-1b's published context (Gemma 3 tech report, arXiv:2503.19786):
#: LONG_ROWS prompts of LONG_PROMPT tokens, LONG_NEW tokens each through
#: generate (the dry-run's prefill_32k slice of a device: 2 of its 32 rows)
LONG_ARCH, LONG_PROMPT, LONG_ROWS, LONG_NEW = "gemma3-1b", 32768, 2, 8
#: replays of the decode graph at that context, timed by wall clock and profiled
LONG_DECODE_ITERS = 8
#: the f32 check: a prompt of this many tokens at the default tiles (4 key
#: blocks) against one block of all of them (the parent's arithmetic)
LONG_F32_PROMPT = 4096
#: olmo-1b (arXiv:2402.00838) trained at its published context
FLASH_TRAIN = dict(arch="olmo-1b", batch=8, seq_len=2048, steps=3, lr=3e-4, warmup=2,
                   total=100)
#: the rows of FLASH_TRAIN's batch its f32 check (2 key blocks against one,
#: and both against float64) runs on: a quarter of the float64 step's time
FLASH_CHECK_ROWS = 2
#: Jamba's smoke config trained on the card against the CPU, step by step
JAMBA_TRAIN = dict(batch=2, seq_len=32, steps=3, rtol=1e-3)


def long_dryrun_cell():
    """The dry-run's cell of ``long_attention_phase``'s prefill: gemma3-1b
    with bf16 weights, LONG_ROWS prompts of LONG_PROMPT tokens on fresh
    caches of that length, a (1, 1) mesh (``lower_cell``, fake tensors)."""
    import torch

    from repro_torch import get_config
    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.sharding import NamedMesh

    cfg = dataclasses.replace(get_config(LONG_ARCH), param_dtype=torch.bfloat16)
    shape = ShapeCfg("prefill_32k", LONG_PROMPT, LONG_ROWS, "prefill")
    return lower_cell(cfg, shape, NamedMesh((1, 1), ("data", "model")), verbose=False).to_dict()


@contextlib.contextmanager
def attention_tiles(model, **tiles):
    """Within: every attention layer of ``model`` (and its config) runs
    flash attention with ``tiles`` (``block_q``, ``block_kv``)."""
    def retile(blk):
        return blk if blk.attn is None else dataclasses.replace(
            blk, attn=dataclasses.replace(blk.attn, **tiles))

    from repro_torch.configs import transform_blocks

    cfg = model.cfg
    mixers = [(layer.mixer, layer.mixer.cfg) for layer in model.layers
              if layer.blk.mixer == "attention"]
    model.cfg = transform_blocks(cfg, retile)
    for mixer, c in mixers:
        mixer.cfg = dataclasses.replace(c, **tiles)
    try:
        yield model
    finally:
        model.cfg = cfg
        for mixer, c in mixers:
            mixer.cfg = c


def _prefill_step(model):
    """The single-shot prefill on fresh caches (``generate``'s)."""
    from repro_torch.serve import make_prefill_step

    return make_prefill_step(model, fresh_caches=True)


def _prefill_logits(model, prompt, max_len):
    """Last logits (B, vocab) f32 of a single-shot prefill on fresh caches."""
    logits, _ = _prefill_step(model)(prompt, model.init_caches(prompt.shape[0], max_len))
    return logits[:, -1].float()


def _long_context(cfg, model, dry_cell):
    """gemma3-1b's generate path at LONG_ROWS x LONG_PROMPT: the fresh
    prefill's device busy (a trace of CUDA activity), the graphed decode
    step over its caches (``generate``'s), the prefill's wall and its peak
    over the floor at the dry-run's shape (caches of the prompt's length,
    peak reset just before), against the dry-run cell.  ``generate`` itself
    runs at LONG_F32_PROMPT tokens (``_blocks_vs_one``)."""
    import torch

    from repro_torch.serve import StepGraphs, make_decode_in_place

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    prompt = torch.randint(0, cfg.vocab, (LONG_ROWS, LONG_PROMPT), generator=gen,
                           device=DEVICE)
    attn = [b.attn for b in cfg.layer_list if b.attn is not None]
    n_blocks = {-(-LONG_PROMPT // a.block_kv) for a in attn}
    held = {}
    with torch.no_grad():
        def prefill_for_decode():
            held["out"] = _prefill_step(model)(prompt, model.init_caches(
                LONG_ROWS, LONG_PROMPT + LONG_NEW))
        busy, n_kernels = _busy_ms(prefill_for_decode)
        logits, caches = held.pop("out")
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        index = torch.full((LONG_ROWS,), LONG_PROMPT, dtype=torch.long, device=DEVICE)
        graphs, step = StepGraphs(), make_decode_in_place(model)

        def run():
            graphs.run("generate_decode", step, tok, caches, index)

        run()   # the capture
        step_ms = _timed(run, LONG_DECODE_ITERS)
        step_busy = _device_ms(_profiled(run, LONG_DECODE_ITERS)) / LONG_DECODE_ITERS
        del caches, logits, graphs
        free_memory()
        caches = model.init_caches(LONG_ROWS, LONG_PROMPT)     # the dry-run's slice
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        floor = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        logits, _ = _prefill_step(model)(prompt, caches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(logits).all()), f"long [{LONG_ARCH}]: prefill logits")
        del caches, logits
        free_memory()
    mem = dry_cell["memory_per_device"]
    predicted = mem["above_state_bytes"] / 2**30
    measured = (peak - floor) / 2**30
    ratio = predicted / measured
    check(1 / DRYRUN_PEAK_FACTOR <= ratio <= DRYRUN_PEAK_FACTOR,
          f"long [{LONG_ARCH}]: predicted {predicted:.3f} GiB above the state against the "
          f"measured {measured:.3f} above the floor (ratio {ratio:.3f})")
    print(f"long [{LONG_ARCH}]: {LONG_ROWS} prompts of {LONG_PROMPT} tokens, fresh single-shot "
          f"flash prefill ({sorted(n_blocks)} key blocks a layer, {len(attn)} layers): "
          f"{wall:.3f} ms wall, {busy:.3f} ms device busy in {n_kernels} kernels; peak "
          f"{peak / 2**30:.3f} GiB, {measured:.3f} above the {floor / 2**30:.3f} allocated at "
          f"the reset; the dry-run cell (prefill_32k at {LONG_ROWS} rows, (1, 1) mesh) "
          f"predicts {mem['peak_bytes'] / 2**30:.3f} GiB, {predicted:.3f} above the "
          f"parameters and caches (ratio {ratio:.3f}; the parent's cell read 120.0 GiB); "
          f"graphed decode step at {LONG_PROMPT} positions {step_ms:.3f} ms wall / "
          f"{step_busy:.3f} ms busy; {card_line()}", flush=True)
    return dict(prefill_ms=wall, prefill_busy_ms=busy, kernels=n_kernels,
                peak_gib=peak / 2**30, above_gib=measured, predicted_gib=predicted,
                predicted_peak_gib=mem["peak_bytes"] / 2**30, ratio=ratio,
                step_ms=step_ms, step_busy_ms=step_busy, n_blocks=sorted(n_blocks))


def _blocks_vs_one(cfg, model):
    """At f32 compute on the same weights: a LONG_F32_PROMPT-token prompt at
    the default tiles (several key blocks) against one block of all its
    keys (``block_kv = LONG_F32_PROMPT``): last prefill logits within
    1e-4·std, ``generate``'s tokens equal except after a near tie of the
    one-block path's logits."""
    import torch

    from repro_torch.serve import generate

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 37)
    prompt = torch.randint(0, cfg.vocab, (LONG_ROWS, LONG_F32_PROMPT), generator=gen,
                           device=DEVICE)
    max_len = LONG_F32_PROMPT + LONG_NEW
    blocks = {-(-LONG_F32_PROMPT // b.attn.block_kv) for b in cfg.layer_list if b.attn}
    out = {}
    model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    try:
        with torch.no_grad():
            for label, tiles in (("blocks", {}), ("one", {"block_kv": LONG_F32_PROMPT})):
                with attention_tiles(model, **tiles):
                    out[label] = (_prefill_logits(model, prompt, max_len),
                                  generate(model, prompt, LONG_NEW, max_len).tolist())
            (lg, toks), (lg1, toks1) = out["blocks"], out["one"]
            gap = float((lg - lg1).abs().max() / lg1.std())
            compared, stopped = 0, []
            with attention_tiles(model, block_kv=max_len):
                for r in range(LONG_ROWS):
                    for i, (x, y) in enumerate(zip(toks[r], toks1[r])):
                        if x != y:
                            seq = torch.cat([prompt[r:r + 1], torch.tensor(
                                [toks1[r][:i]], device=DEVICE, dtype=torch.long)], 1)
                            ref = _prefill_logits(model, seq, max_len)
                            _near_tie(ref, 0, x, y, f"long f32 [{LONG_ARCH}]: row {r}")
                            stopped.append((r, i))
                            break
                        compared += 1
    finally:
        model.cfg = cfg
    check(gap < 1e-4, f"long f32 [{LONG_ARCH}]: last logits at {sorted(blocks)} key blocks "
          f"{gap:.3e}·std from one block's")
    print(f"long f32 [{LONG_ARCH}]: {LONG_ROWS} prompts of {LONG_F32_PROMPT} tokens, "
          f"{sorted(blocks)} key blocks a layer against one block: last prefill logits "
          f"{gap:.3e}·std apart; {compared} generate tokens equal; stopped at near ties "
          f"{stopped or 'none'}", flush=True)
    return dict(gap=gap, compared=compared, stopped=stopped)


def _flash_train():
    """olmo-1b at full width and its published context: FLASH_TRAIN's steps
    of ``make_train_step`` (bf16 compute, f32 weights, AdamW,
    ``remat="full"``), each key block of 1024 keys: wall, device busy and
    peak; then one f32 step on FLASH_CHECK_ROWS of its rows at the default
    tiles (2 key blocks) against one block: the loss within
    ``_train_parity``'s TRAIN_LOSS_RTOL, and each
    leaf's gradient at 2 blocks against the same step in float64 on one
    process (``f64_step``) within F64_SPREAD of one block's worst leaf
    distance."""
    import torch

    from repro_torch import DecoderLM, get_config
    from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step

    t = FLASH_TRAIN
    cfg = dataclasses.replace(get_config(t["arch"]), remat="full")
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    batches = list(_train_batches(cfg, t["steps"] + 2, t["batch"], t["seq_len"]))
    opt = AdamW(cosine_schedule(t["lr"], t["warmup"], t["total"]))
    state = init_train_state(model, opt)
    step_fn = make_train_step(model, opt)
    state, _ = step_fn(state, batches[0])      # warm-up: the allocator, cuBLAS
    torch.cuda.synchronize()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    floor = torch.cuda.memory_allocated()
    walls, losses = [], []
    for b in batches[1:1 + t["steps"]]:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    busy, n_kernels = _busy_ms(lambda: step_fn(state, batches[-1]))
    check(all(map(math.isfinite, losses)), f"flash train [{t['arch']}]: losses {losses}")
    del state, opt, step_fn
    free_memory()

    # the f32 and float64 steps on the first rows: the same 2 key blocks a
    # layer, a quarter of the float64 step's time
    batch = {k: v[:FLASH_CHECK_ROWS] for k, v in batches[-1].items()}
    n_blocks = -(-t["seq_len"] // cfg.layer_list[0].attn.block_kv)
    grads, losses32 = {}, {}
    one = {"block_kv": t["seq_len"]}
    model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    try:
        for path, tiles in (("one", one), ("blocks", {})):
            with attention_tiles(model, **tiles):
                loss32, g = _grads(model, batch)
            losses32[path] = float(loss32.detach())
            grads[path] = {n: x.detach() for n, x in g.items()}
            del g, loss32
    finally:
        model.cfg = cfg
    loss_gap = abs(losses32["blocks"] - losses32["one"]) / abs(losses32["one"])
    check(loss_gap <= TRAIN_LOSS_RTOL and all(
        bool(torch.isfinite(g).all()) for g in grads["blocks"].values()),
          f"flash train [{t['arch']}]: f32 loss at {n_blocks} key blocks "
          f"{losses32['blocks']} vs one block's {losses32['one']}, or a gradient not finite")
    loss64, g64, _, _ = f64_step(model, batch)
    dist = {path: {n: leaf_distance(grads[path][n], g64[n]) for n in g64} for path in grads}
    worst = {path: max(d.items(), key=lambda kv: kv[1]) for path, d in dist.items()}
    bound = F64_SPREAD * worst["one"][1]
    out = dict(step_ms=statistics.median(walls), busy_ms=busy, kernels=n_kernels,
               peak_gib=peak / 2**30, floor_gib=floor / 2**30, losses=losses,
               loss_gap=loss_gap, grad_err=worst["blocks"][1], grad_err_at=worst["blocks"][0],
               one_err=worst["one"][1], bound=bound,
               loss64_gap={p: abs(v - loss64) / abs(loss64) for p, v in losses32.items()})
    print(f"flash train [{t['arch']}]: B={t['batch']} S={t['seq_len']}, bf16, remat full, "
          f"{n_blocks} key blocks a layer: step {out['step_ms']:.1f} ms wall (median of "
          f"{t['steps']}), {busy:.3f} ms device busy in {n_kernels} kernels, peak "
          f"{out['peak_gib']:.2f} GiB ({out['floor_gib']:.2f} allocated at the reset); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; f32 step ({FLASH_CHECK_ROWS} rows) at "
          f"{n_blocks} blocks against one: "
          f"loss {losses32['blocks']:.6f} vs {losses32['one']:.6f} (relative gap "
          f"{loss_gap:.2e}, bound {TRAIN_LOSS_RTOL:.0e}; float64 {loss64:.6f}); each leaf's "
          f"gradient against the float64 step on one process: {n_blocks} blocks' worst "
          f"{worst['blocks'][0]} {worst['blocks'][1]:.3e}, one block's worst "
          f"{worst['one'][0]} {worst['one'][1]:.3e}, bound {F64_SPREAD} x one block's "
          f"{bound:.3e}; {card_line()}", flush=True)
    check(worst["blocks"][1] <= bound, f"flash train [{t['arch']}]: {n_blocks} key blocks' "
          f"gradients {worst['blocks']} from float64, one block's {worst['one']}")
    del model, grads, g64
    free_memory()
    return out


def _jamba_train():
    """Jamba's smoke config (capacity routing in training, its attention
    through flash, its Mamba scans on the diagonal-scan kernel) trained
    JAMBA_TRAIN's f32 steps on the card and on the CPU from the same
    weights and batches: loss, grad norm and lr within rtol; every engine
    ``diagonal_scan`` call on the card launched the kernel."""
    import torch

    from repro_torch import DecoderLM, get_config
    from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step

    j = JAMBA_TRAIN
    cfg = dataclasses.replace(get_config("jamba-v0.1", smoke=True),
                              compute_dtype=torch.float32)
    batches = list(_train_batches(cfg, j["steps"], j["batch"], j["seq_len"]))
    rows = {}
    weights = None
    for device in (DEVICE, "cpu"):
        model = DecoderLM(cfg, device=device,
                          generator=torch.Generator(device=device).manual_seed(SEED))
        if weights is None:
            weights = {k: v.cpu() for k, v in model.state_dict().items()}
        model.load_state_dict(weights)
        opt = AdamW(cosine_schedule(3e-3, 2, 10))
        state = init_train_state(model, opt)
        step_fn = make_train_step(model, opt)
        reset_counts()
        got = []
        for b in batches:
            state, m = step_fn(state, {k: v.to(device) for k, v in b.items()})
            got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
        rows[device] = got
        if device == DEVICE:
            torch.cuda.synchronize()
            launches, calls = read_counts()
            check_launches(launches, calls, "train [jamba-v0.1 smoke]", USED["jamba-v0.1"])
    card, cpu = rows[DEVICE], rows["cpu"]
    gap = max(abs(a - b) / abs(b) for r, s in zip(card, cpu) for a, b in zip(r, s))
    check(gap <= j["rtol"], f"train [jamba-v0.1 smoke]: (loss, grad norm, lr) on the card "
          f"{card} against the CPU {cpu}")
    print(f"train [jamba-v0.1 smoke] (f32, capacity routing, B={j['batch']} S={j['seq_len']}): "
          f"{j['steps']} steps, (loss, grad norm, lr) on the card {card} against the CPU "
          f"{cpu}, largest relative gap {gap:.2e} (bound {j['rtol']:.0e}); launches "
          f"{launches} == engine calls {calls}", flush=True)
    return dict(rows=card, cpu=cpu, gap=gap, launches=launches)


def long_attention_phase(dry_cell):
    """Flash attention on the card where it matters (no path falls back to
    the CPU or to one key block when it fails): gemma3-1b at full width
    with bf16 weights at its published context through ``generate``
    (``_long_context``) and its f32 check of several key blocks against one
    (``_blocks_vs_one``); olmo-1b trained at its context (``_flash_train``);
    Jamba's smoke config trained against the CPU (``_jamba_train``)."""
    import torch

    from repro_torch import DecoderLM, get_config

    free_memory()
    cfg = dataclasses.replace(get_config(LONG_ARCH), param_dtype=torch.bfloat16)
    model = DecoderLM(cfg, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    out = {"long": _long_context(cfg, model, dry_cell),
           "f32": _blocks_vs_one(cfg, model)}
    del model
    free_memory()
    out["train"] = _flash_train()
    out["jamba"] = _jamba_train()
    free_memory()
    return out


def model_axis_summary(ma: dict, dist_runs: dict, card: str) -> str:
    """The summary line of ``model_axis_phase`` and the launcher's float64
    checks."""
    f, d = ma["f64"], dist_runs["f64"]
    pre = ma["prefill"]
    return (f"summary [model axis]: goom-rnn-124m (1, 2) bf16 first step worst leaf "
            f"{f['worst']:.3e} from float64 (one process {f['one_worst']:.3e}), peak above "
            f"the floor / dry-run {[round(1 / x, 4) for x in ma['ratios']]}; olmo-1b "
            f"{MODEL_AXIS_PREFILL[0]}x{MODEL_AXIS_PREFILL[1]} prefill KV bytes a rank "
            f"{[r['cache_bytes'] for r in pre]} of {ma['one_cache_bytes']}, logits "
            f"{[round(r['logit_gap'], 6) for r in pre]}·std; f32 launcher runs' worst leaf "
            f"from float64: (2, 2) seq {d['seq']['worst']:.3e}, FSDP {d['fsdp']['worst']:.3e} "
            f"(one process {d['seq']['one_worst']:.3e}); {rest_summary(ma['rest'])}; {card}")


def rest_summary(rest: dict) -> str:
    """``model_axis_rest``'s part of the model axis's summary line."""
    f, ranks = rest["f64"], rest["ranks"]
    return (f"rwkv6-7b and mixtral-8x7b first f32 steps' worst leaf from float64 "
            f"{f['rwkv6']['worst']:.3e}, {f['mixtral']['worst']:.3e} (one process "
            f"{f['rwkv6']['one_worst']:.3e}, {f['mixtral']['one_worst']:.3e}); rwkv6 logits "
            f"{[round(r['rwkv6']['gap'], 7) for r in ranks]}·std, LMME launches a rank "
            f"{rest['lmme_launches']}; gemma3-1b sequence-split caches "
            f"{[r['gemma3']['cache_bytes'] for r in ranks]} of "
            f"{rest['one']['gemma3']['cache_bytes']} bytes, decode logits "
            f"{[round(r['gemma3']['gap'], 7) for r in ranks]}·std, peak above the floor "
            f"{[round((r['gemma3']['peak'] - r['gemma3']['floor']) / 2**30, 4) for r in ranks]}"
            " GiB")


def long_summary(flash: dict, card: str) -> str:
    """The summary line of ``long_attention_phase``."""
    lg, tr, jb = flash["long"], flash["train"], flash["jamba"]
    return (f"summary [flash]: {LONG_ARCH} {LONG_ROWS}x{LONG_PROMPT} fresh prefill "
            f"{lg['prefill_ms']:.3f} ms wall / {lg['prefill_busy_ms']:.3f} ms busy, peak "
            f"{lg['peak_gib']:.3f} GiB ({lg['above_gib']:.3f} above the floor; the dry-run "
            f"{lg['predicted_gib']:.3f}, ratio {lg['ratio']:.3f}), decode step at "
            f"{LONG_PROMPT} {lg['step_ms']:.3f} ms wall / {lg['step_busy_ms']:.3f} ms busy; "
            f"f32 blocks vs one {flash['f32']['gap']:.2e}·std; {FLASH_TRAIN['arch']} train "
            f"B={FLASH_TRAIN['batch']} S={FLASH_TRAIN['seq_len']} {tr['step_ms']:.1f} ms wall / "
            f"{tr['busy_ms']:.3f} ms busy, peak {tr['peak_gib']:.2f} GiB, f32 loss gap "
            f"{tr['loss_gap']:.2e}, grads' worst leaf to float64 {tr['grad_err']:.2e} (one "
            f"block {tr['one_err']:.2e}, bound {tr['bound']:.2e}); jamba smoke train gap "
            f"{jb['gap']:.2e}; {card}")


# ---------------------------------------------------------------------------
# phase 11: the examples on the card
# ---------------------------------------------------------------------------
def load_example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: a near tie of the serving example's bf16 model: the top-2 margin of a
#: no-cache forward's logits below this many std (the JAX package's own bound
#: for bf16 KV rounding between serving paths, tests/test_serve_engine.py)
SERVE_EXAMPLE_TIE = 0.1


def examples_phase():
    """The three examples' ``main()`` in-process on the card, their default
    sizes: the quickstart (its LMME kernel within 1e-4 of the plain version
    over each row's scale, the chain finite), the Lyapunov spectra at 4096
    steps (sequential and parallel within rtol = atol = 0.12 of the
    literature for logistic, henon and lorenz63, as
    ``tests/test_lyapunov.py``, parallel within 1e-3 of sequential), and
    the serving demo (every client served its budget; ``generate``'s tokens
    equal to the HTTP stream's on the same prompts up to a near tie).
    Returns the kernels' launches over the three, each equal to its engine
    calls."""
    import numpy as np
    import torch

    reset_counts()
    t0 = time.perf_counter()
    quick = load_example("quickstart_torch").main([])
    check(quick["lmme_err"] <= 1e-4 and quick["chain_finite"] and quick["chain_max"] > 88.0,
          f"quickstart: {quick}")
    t_quick = time.perf_counter() - t0
    lyap = load_example("lyapunov_spectra_torch").main(["--steps", "4096", "--chunk", "256"])
    for name in ("logistic", "henon", "lorenz63"):
        r = lyap[name]
        for est in ("seq", "par"):
            check(np.allclose(r[est], r["ref"], rtol=0.12, atol=0.12),
                  f"lyapunov {name}: {est} {r[est]} vs literature {r['ref']}")
        check(np.allclose(r["par"], r["seq"], rtol=1e-3, atol=1e-3),
              f"lyapunov {name}: parallel {r['par']} vs sequential {r['seq']}")
    t_lyap = time.perf_counter() - t0 - t_quick
    demo = load_example("serve_lm_torch").main([])
    for i, (toks, reason, _) in enumerate(demo["http"]):
        check(reason == "length" and len(toks) == max(2, 32 - 4 * i),
              f"serve_lm: client {i} got {len(toks)} tokens ({reason})")
    model, compared, ties = demo["model"], 0, []
    for i in demo["rows"]:
        http, got = demo["http"][i][0], demo["generated"][i].tolist()
        for j, (x, y) in enumerate(zip(got, http)):
            if x != y:
                seq = torch.tensor([demo["prompts"][i] + http[:j]], device=DEVICE)
                with torch.no_grad():
                    lg = model(seq)[0, -1].float()
                top2 = torch.topk(lg, 2).values
                margin = float(top2[0] - top2[1])
                check(margin < SERVE_EXAMPLE_TIE * float(lg.std()),
                      f"serve_lm: row {i} token {j}: generate {x} vs HTTP {y} at margin "
                      f"{margin:.3e}")
                ties.append((i, j, margin / float(lg.std())))
                break
            compared += 1
    t_demo = time.perf_counter() - t0 - t_quick - t_lyap
    launches, calls = read_counts()
    check_launches(launches, calls, "examples", {"lmme", "matrix_scan_zero_b"})
    print(f"examples: quickstart {t_quick:.1f} s (LMME kernel {quick['lmme_err']:.3e} over "
          f"each row's scale from the plain version, log-mag {quick['lmme_log_err']:.3e}; "
          f"chain log-magnitudes {quick['chain_min']:.1f} .. {quick['chain_max']:.1f}); "
          f"lyapunov_spectra {t_lyap:.1f} s (logistic, henon, lorenz63 within 0.12 of the "
          f"literature, parallel within 1e-3 of sequential); serve_lm {t_demo:.1f} s "
          f"({len(demo['http'])} clients served; {compared} generate tokens equal to the "
          f"HTTP stream's on rows {demo['rows']}; near ties {ties or 'none'}); launches "
          f"{launches} == engine calls {calls}", flush=True)
    return launches



def free_memory():
    """Return dead Engines' graph pools and caches to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


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
    print(f"decode attention: {out_dtype_probe()}", flush=True)

    import os

    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = AUTOTUNE_CACHE   # ranks inherit it
    if os.path.exists(AUTOTUNE_CACHE):
        os.remove(AUTOTUNE_CACHE)
    t_start = t0 = time.perf_counter()
    dry_proc = None if "--kernels" in sys.argv[1:] else start_dryrun()
    gc_child = None if "--kernels" in sys.argv[1:] else start_goomcheck()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.build_logs().items():
        print(f"build {name}: {(log or 'loaded from an earlier build').strip()}",
              flush=True)

    phase_s = {}

    def elapsed(phase):
        at = time.perf_counter() - t_start
        phase_s[phase] = at - sum(phase_s.values())
        print(f"[{phase} done at {at:.1f} s]", flush=True)

    elapsed("build")

    rows, max_err = kernel_phase()
    rwkv6_rows = rwkv6_lmme_phase()
    elapsed("kernels lmme")
    scan_rows, scan_errs = scan_kernel_phase()
    max_d_phase()
    if "--kernels" in sys.argv[1:]:  # the kernel phases alone
        print(card)
        return 0
    elapsed("kernels scan")
    diag_rows, diag_err = diag_kernel_phase()
    elapsed("kernels diag")
    dry = join_dryrun(dry_proc)
    elapsed("dry-run join")
    cfg = get_config("goom-rnn-124m")
    model, reqs, stats = serve_phase(cfg)
    traces = {"shared_a": trace_phase(model, stats["per_decode"])}
    prefix = {"shared_a": prefix_phase(model)}
    control_phase(model)
    http = http_phase(model)
    parity_phase(model, cfg, reqs)
    elapsed("shared_a")
    cfg_g = with_scan_variant(cfg, "generic")
    model_g = DecoderLM(cfg_g, device=DEVICE,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED))
    model_g.load_state_dict(model.state_dict())
    del model
    model_g, _, stats_g = serve_phase(cfg_g, model_g)
    traces["generic"] = trace_phase(model_g, stats_g["per_decode"])
    prefix["generic"] = prefix_phase(model_g)
    parity_phase(model_g, cfg_g, reqs, compare_variant="shared_a")
    del model_g
    elapsed("generic")
    train, remat = {}, {}
    for variant in ("shared_a", "generic"):
        # the forward's launch counts are train_phase's checks: remat off
        cfg_t = dataclasses.replace(train_config(cfg, variant), remat="none")
        model_t = DecoderLM(cfg_t, device=DEVICE,
                            generator=torch.Generator(device=DEVICE).manual_seed(SEED))
        train[variant] = train_phase(cfg_t, model_t)
        remat[variant] = remat_phase(cfg_t, model_t, train[variant])
        del model_t
        free_memory()
    dry_ratios = dryrun_phase(dry["train"], remat)
    elapsed("train")
    jamba_float_launches = jamba_float_phase()
    layouts = layouts_phase()
    free_memory()
    elapsed("remat float layouts")
    free_memory()
    sharded, _ = sharded_phase()
    elapsed("sharded")
    fsdp_cells = dict(dry["fsdp"], **{"1": dry["train"]["shared_a"]["full"]})
    dist_runs = dist_launcher_phase(fsdp_cells)
    free_memory()
    elapsed("launcher ranks")
    model_axis = model_axis_phase(dry["model_axis"], dist_runs)
    free_memory()
    elapsed("model axis")
    exp_launches = experiments_phase()
    elapsed("experiments")
    cfg_j = jamba_config()
    model_j, reqs_j, stats_j = serve_phase(cfg_j)
    trace_j = traces["jamba-v0.1"] = trace_phase(model_j, stats_j["per_decode"])
    prefix["jamba-v0.1"] = prefix_phase(model_j)
    layer_breakdown(model_j)
    free_memory()
    parity_phase(model_j, cfg_j, reqs_j)
    del model_j
    free_memory()
    elapsed("jamba")
    cfg_r = family_config("rwkv6-7b")
    model_r, reqs_r, stats_r = serve_phase(cfg_r)
    trace_r = traces["rwkv6-7b"] = trace_phase(model_r, stats_r["per_decode"])
    prefix["rwkv6-7b"] = prefix_phase(model_r)
    layer_breakdown(model_r)
    free_memory()
    parity_phase(model_r, cfg_r, reqs_r)
    del model_r
    free_memory()
    elapsed("rwkv6")
    families = families_phase()
    elapsed("families")
    frontends = frontends_phase()
    banded_phase()
    elapsed("frontends")
    flash = long_attention_phase(dry["long_prefill"])
    elapsed("long attention")
    ex_launches = examples_phase()
    elapsed("examples")
    tune_launches, _ = autotune_phase()
    elapsed("autotune")
    join_goomcheck(gc_child)
    elapsed("goomcheck join")
    for (path, st), tr in zip((("shared_a", stats), ("generic", stats_g),
                               ("jamba-v0.1", stats_j), ("rwkv6-7b", stats_r)),
                              traces.values()):
        pf = prefix[path]
        print(f"summary [{path}]: decode step (4 slots) graphed {tr['step_ms']:.3f} ms "
              f"wall / {tr['busy_ms']:.3f} ms busy / idle {tr['idle']:.3f}, eager "
              f"{tr['eager']['step_ms']:.3f} / {tr['eager']['busy_ms']:.3f} / "
              f"{tr['eager']['idle']:.3f}; {st['tokens_per_s']:.1f} tokens/s at horizon "
              f"8, {st['tokens_per_s_k1']:.1f} at 1; {st['decode']['tokens_per_dispatch']:.2f}"
              f" tokens a dispatch, {st['decode']['syncs_per_token']:.3f} host syncs a "
              f"token; prefix hit rate {pf['hit_rate']:.3f}, TTFT hit "
              f"{pf['ttft_hit_ms']:.2f} ms vs miss {pf['ttft_miss_ms']:.2f} ms; peak "
              f"{st['peak_bytes'] / 2**30:.2f} GiB; {card}", flush=True)
    for arch, fr in frontends.items():
        tr = fr["trace"]
        print(f"summary [{arch}]: generate's decode step ({FRONTENDS[arch]['batch']} rows) "
              f"graphed {tr['step_ms']:.3f} ms wall / {tr['busy_ms']:.3f} ms busy / idle "
              f"{tr['idle']:.3f}; {fr['steady_tokens_per_s']:.1f} tokens/s steady, "
              f"{fr['tokens_per_s']:.1f} over a generate call; single-shot prefill "
              f"{fr['prefill_ms']:.3f} ms wall / {fr['prefill_busy_ms']:.3f} ms busy; peak "
              f"{fr['peak_bytes'] / 2**30:.2f} GiB; {card}",
              flush=True)
    for variant, r in remat.items():
        print(f"summary [remat {variant}]: goom-rnn-124m train step at "
              f"{TRAIN_LAYERS[variant]} layers (B={TRAIN['batch']}, "
              f"S={TRAIN['seq_len']}, bf16) " + "; ".join(
                  f"{k} {r[k]['step_ms']:.1f} ms wall / {r[k]['busy_ms']:.3f} ms busy, peak "
                  f"{r[k]['peak_gib']:.2f} GiB (floor {r[k]['floor_gib']:.2f})" for k in REMATS)
              + f"; f32 grads full vs none {r['remat_grad_err']:.2e} (spread "
              f"{r['remat_spread']:.2e}); {card}", flush=True)
    print(dryrun_summary(dry_ratios, card), flush=True)
    print(f"summary [fsdp]: goom-rnn-124m laid-out train step (B={TRAIN['batch']}, "
          f"S={TRAIN['seq_len']}, bf16, remat full) on P gloo ranks sharing the card, each "
          "rank's peak GiB: " + "; ".join(
              f"P={p} {[round(b / 2**30, 3) for b in dist_runs['peaks'][p]]}" for p in FSDP_P)
          + f"; {card}", flush=True)
    print(long_summary(flash, card), flush=True)
    print(model_axis_summary(model_axis, dist_runs, card), flush=True)
    print("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {sum(phase_s.values()):.1f}", flush=True)

    # each kernel's row: the shape its main path launches most, and the
    # launches of the run of that path (the other paths' beside them)
    by_path = {k: {"serve shared_a": stats["launches"][k], "serve generic":
                   stats_g["launches"][k], "train shared_a": train["shared_a"]["launches"][k],
                   "train generic": train["generic"]["launches"][k],
                   "experiments": exp_launches[k], "serve jamba": stats_j["launches"][k],
                   "serve rwkv6": stats_r["launches"][k],
                   "serve families": sum(f["stats"]["launches"][k] for f in families.values()),
                   "serve frontends": sum(f["launches"][k] for f in frontends.values()),
                   "examples": ex_launches[k], "sharded": sharded[k],
                   "train seq-shards 2": dist_runs["seq"][k],
                   **{f"train fsdp P={p} (ranks summed)": dist_runs[f"fsdp {p}"][k]
                      for p in FSDP_P},
                   "train model axis (1, 2) (ranks summed)": sum(
                       r["launches"][k] for r in dist_runs["model_axis"]["run"]["ranks"]),
                   "serve model axis rwkv6 (1, 2) (ranks summed)": sum(
                       r["rwkv6"]["launches"][k] for r in model_axis["rest"]["ranks"]),
                   "autotune": tune_launches[k],
                   **{f"train remat {r} {v}": remat[v][r]["per_step"][k]
                      for v in remat for r in ("full", "dots")},
                   **{f"train layouts {v}": layouts[v][k] for v in layouts},
                   "jamba smoke goom (float: 0)": jamba_float_launches[k],
                   "train jamba smoke": flash["jamba"]["launches"][k]}
               for k in ("lmme", "matrix_scan", "matrix_scan_zero_b", "diag_scan")}
    lmme_row = next(r for r in rows if r["shape"].startswith("decode"))
    split_rows = {"lmme": next(r for r in rows if r["shape"].startswith("model axis")),
                  **{k: next(dict(v, shape=n) for n, v in table.items()
                             if n.startswith("model axis"))
                     for k, table in (("matrix_scan", scan_rows), ("diag_scan", diag_rows))}}
    split_launches = {"lmme": [r["launches"]["lmme"]
                               for r in dist_runs["model_axis"]["run"]["ranks"]],
                      "matrix_scan": [model_axis["kernels"]["launches"]["matrix_scan"]],
                      "diag_scan": [model_axis["kernels"]["launches"]["diag_scan"]]}
    scan_row = next(v for k, v in scan_rows.items() if k.startswith("decode"))
    zb_row = next(v for k, v in scan_rows.items() if k.startswith("zero-B d=128"))
    diag_row = next(v for k, v in diag_rows.items() if k.startswith("decode"))
    src = "src/repro_torch/kernels"
    entries = [
        ("lmme", f"{src}/lmme/csrc/lmme.cu", "src/repro/kernels/lmme/lmme.py:36",
         stats["launches"]["lmme"],
         max([max_err] + [r["max_abs_err"] for r in rwkv6_rows.values()]), lmme_row,
         lmme_row["shape"],
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
        **({"rwkv6_shapes": rwkv6_rows} if name == "lmme" else {}),
        **({"model_axis": {"shape": split_rows[name]["shape"], "ms": split_rows[name]["ms"],
                           "plain_ms": split_rows[name]["plain_ms"],
                           "bound_ms": split_rows[name]["bound_ms"],
                           "launches_a_rank": split_launches[name]}}
           if name in split_rows else {}),
        **({"rwkv6_model_axis": {
            **{n: {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}
               for n, r in rwkv6_rows.items() if "model axis" in n and r["ms"] is not None},
            "launches_a_rank": model_axis["rest"]["lmme_launches"]}}
           if name == "lmme" else {}),
    } for name, source, replaces, launches, err, row, shape, path in entries]}))
    print(f"jamba: decode step device busy {trace_j['busy_ms']:.3f} ms, of which the "
          f"diagonal scan {trace_j['diag_scan']:.3f} ms; {card}", flush=True)
    print(f"rwkv6: decode step device busy {trace_r['busy_ms']:.3f} ms, of which the LMME "
          f"kernel {trace_r['lmme']:.3f} ms ({trace_r['lmme'] / trace_r['busy_ms']:.4f} of "
          f"busy, {stats_r['per_decode']['lmme']} launches a step); {card}", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-cells"]:   # start_dryrun's child: no card
        dryrun_cells(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
