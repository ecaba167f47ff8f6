"""The port's CUDA kernels (LMME, matrix scan, diagonal scan) against their
plain versions, on a card.

Every test here needs an NVIDIA card and ``nvcc``; elsewhere they skip.  On
a machine with a card run them with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The plain version (``lmme_reference``) is itself held to the JAX package in
``test_torch_lmme.py``; here the kernel is held to it on the same CUDA
inputs with ``assert_goom_close``'s tolerances, scaled by each entry's
absolute contraction so that matvec outputs are judged away from
cancellation.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.core.goom import Goom
from repro_torch.kernels import dispatch
from repro_torch.kernels.goom_scan import (
    matrix_scan_cuda,
    matrix_scan_ref,
    matrix_scan_zero_b_ref,
)
from repro_torch.kernels.lmme import lmme_cuda, lmme_ref
from torch_parity import assert_goom_close, goom_dist, goom_planes, lmme_abs_scale

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

# (a shape, b shape): the serving path's shapes, a broadcast on both sides,
# a ragged 2-D product and a long contraction
SHAPES = {
    "decode": ((48, 16, 16), (1, 4, 48, 16, 1)),
    "prefill_chunk": ((48, 16, 16), (64, 1, 48, 16, 1)),
    "a_doubling": ((48, 16, 16), (48, 16, 16)),
    "bcast_both": ((2, 1, 6, 5), (4, 5, 3)),
    "ragged": ((130, 70), (70, 50)),
    "d256": ((4, 8, 256), (4, 256, 16)),
    "admit_fold": ((48, 16, 16), (1, 48, 16, 1)),
    "square_d8": ((8, 8), (8, 8)),
    "square_d32": ((32, 32), (32, 32)),
    "square_d128": ((128, 128), (128, 128)),
    "spectrum_reset": ((128, 3, 3), (128, 3, 3)),
    "ragged_ndm": ((3, 37, 70), (70, 19)),
    "long_d300": ((2, 5, 300), (300, 3)),
}
# the launch shape each takes (csrc/lmme.cu): batched where A is broadcast
# over rows of B or the product is small, tiled for the rest
BATCHED = {"decode", "prefill_chunk", "a_doubling", "bcast_both", "admit_fold",
           "square_d8", "spectrum_reset"}


@pytest.fixture(scope="module")
def card():
    """Skip without a card; otherwise build the kernel once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU form)")
    from repro_torch.kernels import build

    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(shape_key, seed, dev, spread=200.0, zero_rows=True):
    sa, sb = SHAPES[shape_key]
    rng = np.random.default_rng(seed)
    a = goom_planes(rng, sa, spread=spread, zero_rows=zero_rows)
    b = goom_planes(rng, sb, spread=spread, along="col")
    if zero_rows:  # and one all-zero column of b
        b[0][..., :, 0] = -np.inf
        b[1][..., :, 0] = 1.0
    return a, b, (Goom(*(torch.tensor(x, device=dev) for x in a)),
                  Goom(*(torch.tensor(x, device=dev) for x in b)))


def _check(got, a, b, ga, gb):
    want = lmme_ref(ga.log_abs, ga.sign, gb.log_abs, gb.sign)
    assert tuple(got.log_abs.shape) == tuple(want[0].shape)
    assert not torch.isnan(got.log_abs).any()
    assert_goom_close(got.log_abs, got.sign, *want,
                      scale_log=lmme_abs_scale(a[0], b[0]))


@pytest.mark.parametrize("shape_key", sorted(SHAPES))
def test_kernel_matches_plain_version_e200(card, shape_key):
    a, b, (ga, gb) = _operands(shape_key, 0, card)
    before = (lmme_cuda.launches, lmme_cuda.launches_batched)
    got = lmme_cuda(ga, gb)
    torch.cuda.synchronize()
    assert (lmme_cuda.launches, lmme_cuda.launches_batched) == \
        (before[0] + 1, before[1] + (shape_key in BATCHED))
    _check(got, a, b, ga, gb)


def _bits(g: Goom):
    return g.log_abs.view(torch.int32), g.sign.view(torch.int32)


def _same_bits(x: Goom, y: Goom):
    for u, v in zip(_bits(x), _bits(y)):
        assert torch.equal(u, v)


def test_an_output_does_not_depend_on_the_call(card):
    """One output's bits depend only on its row of A, its column of B and d:
    the same rows and columns inside calls of other batch sizes, n and m,
    and of the other launch shape, give bit-equal outputs."""
    rng = np.random.default_rng(7)

    def planes(shape):
        return Goom(*(torch.tensor(x, device=card) for x in goom_planes(rng, shape, spread=50.0)))

    # the serving matvec: decode (N=4), a 64-row chunk holding the same 4
    # rows, and the tiled shape (m=17 > 256/n) holding row 0 as column 0
    a = planes((48, 16, 16))
    b = planes((64, 1, 48, 16, 1))
    dec = lmme_cuda(a, b[:4, 0])
    chunk = lmme_cuda(a, b)
    assert lmme_cuda(a, b[:4, 0]).log_abs.shape == (4, 48, 16, 1)
    _same_bits(dec, chunk[:4, 0])
    wide = planes((48, 16, 17))
    wide = Goom(torch.cat([b.log_abs[0, 0], wide.log_abs[..., 1:]], -1),
                torch.cat([b.sign[0, 0], wide.sign[..., 1:]], -1))
    before = lmme_cuda.launches_batched
    tiled = lmme_cuda(a, wide)
    assert lmme_cuda.launches_batched == before   # the tiled shape
    _same_bits(chunk[0, 0], tiled[..., :1])
    # long contractions (two and five 64-term chains): one row and column
    # alone, inside a square product, and inside a batch
    for d in (128, 300):
        a, b = planes((40, d)), planes((d, 33))
        full = lmme_cuda(a, b)
        one = lmme_cuda(a[5:6], b[:, 7:8])
        _same_bits(one, full[5:6, 7:8])
        batch = lmme_cuda(Goom(a.log_abs.expand(3, 40, d), a.sign.expand(3, 40, d)), b[:, 30:])
        _same_bits(batch[2], full[:, 30:])


def test_kernel_takes_strided_operands(card):
    """A transposed B and a sliced A go in by strides, not copies."""
    a, b, (ga, gb) = _operands("ragged", 1, card, zero_rows=False)
    bt = Goom(gb.log_abs.t().contiguous().t(), gb.sign.t().contiguous().t())
    a_wide = Goom(torch.cat([ga.log_abs, ga.log_abs], -1)[:, :70],
                  torch.cat([ga.sign, ga.sign], -1)[:, :70])
    assert not bt.log_abs.is_contiguous() and not a_wide.log_abs.is_contiguous()
    got = lmme_cuda(a_wide, bt)
    torch.cuda.synchronize()
    _check(got, a, b, ga, gb)


def test_kernel_backward_is_the_plain_versions(card):
    _, _, (ga, gb) = _operands("decode", 2, card, spread=20.0, zero_rows=False)
    grads = []
    for fn in (lmme_cuda,
               lambda x, y: Goom(*lmme_ref(x.log_abs, x.sign, y.log_abs, y.sign))):
        al = ga.log_abs.clone().requires_grad_()
        bl = gb.log_abs.clone().requires_grad_()
        fn(Goom(al, ga.sign), Goom(bl, gb.sign)).log_abs.sum().backward()
        grads.append((al.grad, bl.grad))
    for g_kernel, g_plain in zip(*grads):
        assert torch.equal(g_kernel, g_plain)


def test_engine_auto_launches_the_kernel_and_refuses_bf16(card):
    _, _, (ga, gb) = _operands("decode", 3, card, zero_rows=False)
    before = lmme_cuda.launches
    engine.lmme(ga, gb)
    assert lmme_cuda.launches == before + 1
    with engine.use_backend("torch_reference"):
        engine.lmme(ga, gb)
    assert lmme_cuda.launches == before + 1
    bf = Goom(ga.log_abs.bfloat16(), ga.sign.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        engine.lmme(bf, gb)
    with pytest.raises(TypeError, match="float32"):
        lmme_cuda(bf, gb)
    with pytest.raises(ValueError):
        lmme_cuda(ga, Goom(gb.log_abs.cpu(), gb.sign.cpu()))


# ---------------------------------------------------------------------------
# the matrix-scan kernel
# ---------------------------------------------------------------------------
# name: (T, batch, d, m, kind).  decode and chunk64 are the generic layer's
# shapes (G = 48 heads, d = 16; m = 4 slots, or one 64-token prompt chunk)
# with a time-invariant A passed as a stride-0 view.  The with-B kernel cuts
# time into chunks of L = ops.with_b_chunk_len(T, d) steps: T = 1 and T = 16
# are one chunk (L = T, up to T = 24), 63, 65 and 100 end in a ragged chunk
# (L = 8, 16, 16), the time-varying A walks its chunks' products beside B;
# d = 24 and 32 take the warp kernel's one-lane-per-row layout, d = 128 the
# block kernel; ``no_x0`` starts from exact zeros
SCAN_SHAPES = {
    "decode": (1, (48,), 16, 4, "shared_a"),
    "chunk64": (64, (48,), 16, 1, "shared_a"),
    "t1_signed": (1, (2,), 16, 3, "signed"),
    "t16_one_chunk": (16, (3,), 16, 2, "shared_a"),
    "t63_ragged": (63, (2,), 16, 2, "signed"),
    "t65_ragged": (65, (48,), 16, 1, "shared_a"),
    "t100_ragged": (100, (2,), 5, 3, "signed"),
    "time_varying_256": (256, (48,), 16, 4, "signed"),
    "d24_time_varying": (70, (), 24, 3, "signed"),
    "d32_shared_a": (100, (3,), 32, 2, "shared_a"),
    "d128": (33, (), 128, 3, "signed"),
    "no_x0": (40, (2,), 16, 2, "no_x0"),
    "e200_positive": (150, (), 4, 1, "positive"),
    "odd_13_4_1": (13, (), 4, 1, "signed"),
    "odd_9_2_5_3": (9, (2,), 5, 3, "signed"),
    "odd_16_2x2_3_1": (16, (2, 2), 3, 1, "signed"),
    "odd_5_8_8": (5, (), 8, 8, "signed"),
    "e200_signed": (17, (), 4, 2, "e200_signed"),
}
# zero-B with X_0 = I (cumulative_lmme): the quickstart's chain, the
# benchmark's d=128 chain over 2000 steps, the LLE's 4096 Lorenz-size steps
ZERO_B_SHAPES = {"quickstart": (1000, 16), "chain_d128": (2001, 128), "lle": (4097, 3)}


def _goom(x: torch.Tensor) -> Goom:
    return Goom(torch.log(x.abs()), torch.where(x >= 0, 1.0, -1.0).to(x.dtype))


def _abs(g: Goom) -> Goom:
    return Goom(g.log_abs, torch.ones_like(g.sign))


def _f64(g):
    return None if g is None else Goom(g.log_abs.double(), g.sign.double())


def scan_operands(name, dev, seed=0):
    """(a, b, x0) GOOMs of ``SCAN_SHAPES[name]`` on ``dev``, from a seed."""
    tlen, batch, d, m, kind = SCAN_SHAPES[name]
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    if kind == "shared_a":
        a = _goom(0.9 * torch.eye(d) + 0.3 * normal(*batch, d, d) / d ** 0.5)
        a = Goom(a.log_abs.to(dev).expand((tlen,) + a.shape),
                 a.sign.to(dev).expand((tlen,) + a.shape))
        b, x0 = _goom(normal(tlen, *batch, d, m)), _goom(normal(*batch, d, m))
    elif kind == "positive":  # tests/test_serve_engine.py's e±200 chain
        a = _goom(normal(tlen, *batch, d, d).abs() * 4.0)
        b, x0 = _goom(normal(tlen, *batch, d, m).abs()), None
    else:
        a = _goom(normal(tlen, *batch, d, d) * (1.0 if kind == "e200_signed" else 0.6))
        if kind == "e200_signed":  # tests/test_engine.py: per-step e^±200
            shift = 200.0 * torch.where(torch.rand(tlen, 1, 1, generator=gen) < 0.5, -1.0, 1.0)
            a = Goom(a.log_abs + shift, a.sign)
        b = _goom(normal(tlen, *batch, d, m) * (1.0 if kind == "e200_signed" else 0.6))
        x0 = None if kind == "no_x0" else _goom(normal(*batch, d, m))
    move = lambda g: None if g is None else Goom(g.log_abs.to(dev), g.sign.to(dev))  # noqa: E731
    return move(a), move(b), move(x0)


def assert_no_worse_than_plain(got, plain, exact, scale):
    """The kernel walks time in order; the plain version brackets as a tree.
    Hold the kernel to float64: its distance to the float64 plain version is
    at most twice the f32 plain version's (floor 1e-6, some sixteen f32
    roundings of a unit value)."""
    d_kernel, d_plain = goom_dist(got, exact, scale), goom_dist(plain, exact, scale)
    assert d_kernel <= 2.0 * d_plain + 1e-6, (d_kernel, d_plain)


@pytest.mark.parametrize("name", sorted(SCAN_SHAPES))
def test_matrix_scan_kernel_matches_plain_version(card, name):
    a, b, x0 = scan_operands(name, card)
    before = (matrix_scan_cuda.launches, matrix_scan_cuda.copies)
    got = matrix_scan_cuda(a, b, x0)
    torch.cuda.synchronize()
    # one launch; the stride-0 A and the strided operands were not copied
    assert (matrix_scan_cuda.launches, matrix_scan_cuda.copies) == (before[0] + 1, before[1])
    plain = matrix_scan_ref(a, b, x0)
    assert got.shape == plain.shape and not torch.isnan(got.log_abs).any()
    exact = matrix_scan_ref(_f64(a), _f64(b), _f64(x0))
    scale = matrix_scan_ref(_abs(_f64(a)), _abs(_f64(b)), _abs(_f64(x0)) if x0 is not None else None)
    assert_no_worse_than_plain(got, plain, exact, scale.log_abs)
    kind = SCAN_SHAPES[name][-1]
    if kind == "positive":  # no cancellation: 1e-4 relative in log space
        w = plain.log_abs
        assert float(w.abs().max()) > 200.0
        rel = (got.log_abs - w).abs() / w.abs().clamp_min(1.0)
        assert float(rel.max()) <= 1e-4
    elif kind != "e200_signed":  # test_engine.py's bar away from cancellation
        assert_goom_close(got.log_abs, got.sign, plain.log_abs, plain.sign,
                          scale_log=scale.log_abs.float(), cancel_margin=8.0)


@pytest.mark.parametrize("name", ["decode", "chunk64", "time_varying_256", "d128"])
def test_with_b_call_is_one_kernel(card, name):
    """A with-B call puts exactly one kernel on the card: the chunks' part,
    stitch and fix-up run inside one block.  The profiler drops some kernel
    records on this card (chip_smoke.call_ms), so over ten calls the trace
    must hold one kernel name, a matrix-scan kernel, at most once a call."""
    from torch.autograd import DeviceType

    a, b, x0 = scan_operands(name, card)
    matrix_scan_cuda(a, b, x0)
    torch.cuda.synchronize()
    calls = 10
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            matrix_scan_cuda(a, b, x0)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and "memset" not in e.name.lower()
               and "memcpy" not in e.name.lower()]
    assert 1 <= len(kernels) <= calls and len(set(kernels)) == 1, kernels
    assert "matrix_scan" in kernels[0], kernels


@pytest.mark.parametrize("name", sorted(ZERO_B_SHAPES))
def test_zero_b_kernel_matches_plain_version(card, name):
    """cumulative_lmme on the card: the zero-B kernel from X_0 = I.  Long
    products turn rank-1, so values are held over each matrix's largest
    entry, and the final log Frobenius norms to 1e-5 relative."""
    from repro_torch.core.chains import goom_log_norm

    tlen, d = ZERO_B_SHAPES[name]
    gen = torch.Generator().manual_seed(1)
    a = _goom(torch.randn(tlen, d, d, generator=gen).to(card))
    engine.reset_calls()
    before = (matrix_scan_cuda.launches_zero_b, matrix_scan_cuda.kernels_zero_b)
    got = engine.cumulative_lmme(a)
    torch.cuda.synchronize()
    assert matrix_scan_cuda.launches_zero_b == before[0] + 1 == \
        before[0] + engine.calls["cumulative_lmme"]
    # (exp above d = 16,) part, scale, stitch, fix-up
    assert matrix_scan_cuda.kernels_zero_b == before[1] + 4 + (d > 16)
    with engine.use_backend("torch_reference"):
        plain = engine.cumulative_lmme(a)
        exact = engine.cumulative_lmme(_f64(a))
    assert got.shape == plain.shape and torch.isfinite(got.log_abs).all()
    scale = exact.log_abs.amax((-2, -1), keepdim=True).expand_as(exact.log_abs)
    assert_no_worse_than_plain(got, plain, exact, scale)
    fro = [float(goom_log_norm(g[-1])) for g in (got, exact)]
    assert abs(fro[0] - fro[1]) <= 1e-5 * abs(fro[1])


# name: (T, A batch, x0 batch, d, m, kind).  L = zero_b_chunk_len(T, d) is
# the least power of two with 2 L^2 >= T (and more at d = 128), so T < L
# never occurs and only T = 1 is one whole chunk: T = 2 is two chunks of one
# step, T = 37 (L = 8) ends in a ragged chunk, T = 64 is a multiple of L.  ``fixed``: a time-invariant A as a stride-0 view; x0 of
# batch (3,) broadcasts over A's (2, 3).  ``e200``: every step shifted by
# e^±200, a tenth of A's entries exact zeros; x0's column 0 is exact zeros
ZERO_B_EDGES = {
    "t1": (1, (), (), 16, 16, "normal"),
    "two_steps": (2, (), (), 16, 4, "normal"),
    "ragged_chunks_d3": (37, (), (), 3, 3, "e200"),
    "multiple_of_l": (64, (), (), 16, 16, "e200"),
    "stride0_a": (300, (3,), (3,), 5, 2, "fixed"),
    "g_bcast_x0": (50, (2, 3), (3,), 8, 3, "normal"),
    "d37_m19": (33, (), (), 37, 19, "e200"),
    "d128_m5": (20, (), (), 128, 5, "e200"),
    "e200_long": (1000, (), (), 16, 16, "e200"),
}


def zero_b_operands(name, dev, seed=0):
    tlen, batch, xbatch, d, m, kind = ZERO_B_EDGES[name]
    gen = torch.Generator().manual_seed(seed)
    if kind == "fixed":
        a = _goom(torch.randn(*batch, d, d, generator=gen))
        a = Goom(a.log_abs.to(dev).expand((tlen,) + a.shape),
                 a.sign.to(dev).expand((tlen,) + a.shape))
    else:
        a = _goom(torch.randn(tlen, *batch, d, d, generator=gen))
        if kind == "e200":
            shift = 200.0 * torch.where(torch.rand(tlen, 1, 1, generator=gen) < 0.5, -1.0, 1.0)
            zero = torch.rand(a.shape, generator=gen) < 0.1
            a = Goom((a.log_abs + shift).masked_fill(zero, -torch.inf),
                     a.sign.masked_fill(zero, 1.0))
        a = Goom(a.log_abs.to(dev), a.sign.to(dev))
    x0 = _goom(torch.randn(*xbatch, d, m, generator=gen))
    x0.log_abs[..., 0], x0.sign[..., 0] = -torch.inf, 1.0
    return a, Goom(x0.log_abs.to(dev), x0.sign.to(dev))


@pytest.mark.parametrize("name", sorted(ZERO_B_EDGES))
def test_zero_b_kernel_edge_shapes(card, name):
    """The three passes at T = 1 and 2, ragged chunks, a stride-0 A,
    a broadcast x0 and e±200 signed inputs with exact zeros: held to float64
    (at most twice the f32 plain version's distance) and to the plain
    version; exact zeros stay (-inf, +1)."""
    from repro_torch.kernels.goom_scan.ops import zero_b_chunk_len, zero_b_kernels

    a, x0 = zero_b_operands(name, card)
    tlen, d = a.shape[0], a.shape[-1]
    before = (matrix_scan_cuda.launches_zero_b, matrix_scan_cuda.kernels_zero_b,
              matrix_scan_cuda.copies)
    got = matrix_scan_cuda(a, None, x0)
    torch.cuda.synchronize()
    # (exp above d = 16,) part, scale, stitch, fix-up; one chunk (T = 1)
    # needs only stitch and fix-up.  x0 broadcast over a leading batch dim has no one
    # batch stride: copied
    kernels = (4 if tlen > zero_b_chunk_len(tlen, d) else 2) + (d > 16)
    assert zero_b_kernels(tlen, d) == kernels
    copies = 1 if name == "g_bcast_x0" else 0
    assert (matrix_scan_cuda.launches_zero_b, matrix_scan_cuda.kernels_zero_b,
            matrix_scan_cuda.copies) == (before[0] + 1, before[1] + kernels,
                                         before[2] + copies)
    plain = matrix_scan_zero_b_ref(a, x0)
    assert got.shape == plain.shape and not torch.isnan(got.log_abs).any()
    exact = matrix_scan_zero_b_ref(_f64(a), _f64(x0))
    scale = matrix_scan_zero_b_ref(_abs(_f64(a)), _abs(_f64(x0))).log_abs
    assert_no_worse_than_plain(got, plain, exact, scale)
    assert_goom_close(got.log_abs, got.sign, plain.log_abs, plain.sign,
                      scale_log=scale.float(), cancel_margin=8.0)
    assert bool((got.log_abs[..., 0] == -torch.inf).all())
    assert bool((got.sign[..., 0] == 1.0).all())


def test_goom_rnn_chunked_prefill_equals_full_on_the_card(card):
    """goom-rnn (smoke widths, f32 compute) through the LMME and matrix-scan
    kernels, in both scan variants: chunked prefill gives full prefill's
    last logits (1e-4 of their std, as on the CPU)."""
    import dataclasses

    from repro_torch import DecoderLM, get_config
    from repro_torch.serve import ChunkedPrefill
    from torch_parity import with_scan_variant

    seq = np.random.default_rng(0).integers(0, 100, size=75).tolist()
    for variant in ("shared_a", "generic"):
        cfg = dataclasses.replace(
            with_scan_variant(get_config("goom-rnn-124m", smoke=True), variant),
            compute_dtype=torch.float32)
        model = DecoderLM(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))
        before = lmme_cuda.launches
        with torch.no_grad():
            full, _ = model.prefill(torch.tensor([seq], device=card), model.init_caches(1))
            for chunk in (7, 64):
                got, _, _ = ChunkedPrefill(model, chunk)(seq, model.init_caches(1))
                torch.testing.assert_close(got, full[:, -1], rtol=0,
                                           atol=1e-4 * float(full.std()))
        assert lmme_cuda.launches > before


def test_matrix_scan_kernel_starts_from_zeros_and_from_the_floor(card):
    """x0=None starts at exact zeros (-inf), a model state at the finite
    floor: both flow through as in the plain version."""
    from repro_torch.core.goom import finite_floor

    a, b, _ = scan_operands("chunk64", card, seed=2)
    floor = Goom(torch.full((48, 16, 1), finite_floor(torch.float32), device=card),
                 torch.ones(48, 16, 1, device=card))
    zeros_b = Goom(torch.full_like(b.log_abs, -torch.inf), torch.ones_like(b.sign))
    for bb, x0 in ((b, None), (b, floor), (zeros_b, floor)):
        got = matrix_scan_cuda(a, bb, x0)
        want = matrix_scan_ref(a, bb, x0)
        assert torch.equal(torch.isinf(got.log_abs), torch.isinf(want.log_abs))
        scale = matrix_scan_ref(_abs(a), _abs(bb), None if x0 is None else _abs(x0))
        assert_goom_close(got.log_abs, got.sign, want.log_abs, want.sign,
                          scale_log=scale.log_abs, cancel_margin=8.0)
    got = matrix_scan_cuda(a, zeros_b, None)  # zeros stay exact zeros
    assert bool((got.log_abs == -torch.inf).all()) and bool((got.sign == 1).all())


def test_matrix_scan_kernel_backward_is_the_plain_versions(card):
    a, b, x0 = scan_operands("odd_9_2_5_3", card, seed=3)
    for with_b in (True, False):
        grads = []
        for fn in (matrix_scan_cuda,
                   lambda a_, b_, x_: (matrix_scan_ref(a_, b_, x_) if b_ is not None
                                       else matrix_scan_zero_b_ref(a_, x_))):
            al = a.log_abs.clone().requires_grad_()
            bl = b.log_abs.clone().requires_grad_()
            xl = x0.log_abs.clone().requires_grad_()
            out = fn(Goom(al, a.sign), Goom(bl, b.sign) if with_b else None, Goom(xl, x0.sign))
            out.log_abs.sum().backward()
            grads.append((al.grad, bl.grad, xl.grad))
        for g_kernel, g_plain in zip(*grads):
            if g_plain is None:
                assert g_kernel is None
            else:
                assert torch.equal(g_kernel, g_plain)


def test_matrix_scan_kernel_raises_on_what_it_does_not_take(card):
    a, b, x0 = scan_operands("odd_13_4_1", card)
    big = Goom(torch.zeros(2, 129, 129, device=card), torch.ones(2, 129, 129, device=card))
    with pytest.raises(ValueError, match="d <= 128"):
        matrix_scan_cuda(big, None, Goom(big.log_abs[0], big.sign[0]))
    bf = Goom(a.log_abs.bfloat16(), a.sign.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        matrix_scan_cuda(bf, b, x0)
    with pytest.raises(TypeError, match="float32"):
        engine.matrix_scan(bf, b, x0)
    with pytest.raises(ValueError):
        matrix_scan_cuda(a, Goom(b.log_abs.cpu(), b.sign.cpu()), x0)


def test_engine_routes_scans_to_the_kernel(card):
    a, b, x0 = scan_operands("odd_9_2_5_3", card, seed=4)
    before = (matrix_scan_cuda.launches, matrix_scan_cuda.launches_zero_b)
    engine.matrix_scan(a, b, x0)
    engine.matrix_scan_carry(a, b, x0)
    engine.cumulative_lmme(a)
    with engine.use_backend("torch_reference"):
        engine.matrix_scan(a, b, x0)
        engine.cumulative_lmme(a)
    assert (matrix_scan_cuda.launches, matrix_scan_cuda.launches_zero_b) == \
        (before[0] + 2, before[1] + 1)
    assert dispatch.get_impl("cumulative_lmme", "cuda") is not None


# ---------------------------------------------------------------------------
# the diagonal-scan kernel
# ---------------------------------------------------------------------------
# name: (T, trailing shape, kind): Mamba's decode step over 4 slots and its
# 64-token chunk (d_inner=8192, d_state=16), e±200 signed inputs with exact
# zeros and cancellations, T=1, odd C, and the autotune shape (4096, 512)
DIAG_SHAPES = {
    "decode": (1, (4, 8192, 16), "mamba"),
    "chunk64": (64, (1, 8192, 16), "mamba"),
    "e200_signed": (64, (4, 33), "e200"),
    "t1": (1, (1000,), "e200"),
    "odd_c": (37, (3, 7, 5), "e200"),
    "autotune": (4096, (512,), "mamba"),
}


def diag_operands(name, dev, seed=0):
    """(a, b, x0) on ``dev``.  ``mamba``: decays a = Δ·A <= 0 with sign +1 and
    inputs Δ·x·B as Mamba's segment_states makes them; ``e200``: signed
    decays and inputs shifted by up to e±200, a tenth of the inputs exact
    zeros, and channel 0 cancelling exactly at t=0."""
    tlen, trail, kind = DIAG_SHAPES[name]
    gen = torch.Generator().manual_seed(seed)
    shape = (tlen,) + trail
    if kind == "mamba":
        a = Goom(-torch.rand(shape, generator=gen) * 0.2, torch.ones(shape))
        b = _goom(torch.randn(shape, generator=gen) * 0.1)
        x0 = _goom(torch.randn(trail, generator=gen))
    else:
        a = _goom(torch.randn(shape, generator=gen) * 1.5)
        b = _goom(torch.randn(shape, generator=gen))
        b = Goom(b.log_abs + (torch.rand(shape, generator=gen) * 400 - 200), b.sign)
        zero = torch.rand(shape, generator=gen) < 0.1
        b = Goom(b.log_abs.masked_fill(zero, -torch.inf), b.sign.masked_fill(zero, 1.0))
        x0 = _goom(torch.randn(trail, generator=gen))
        # x_0 = a_0 x0 + b_0 = 0 exactly in channel 0
        first = (0,) * len(shape)
        a.log_abs[first], a.sign[first] = 0.0, 1.0
        x0.log_abs[first[1:]], x0.sign[first[1:]] = 0.0, 1.0
        b.log_abs[first], b.sign[first] = 0.0, -1.0
    move = lambda g: Goom(g.log_abs.to(dev), g.sign.to(dev))  # noqa: E731
    return move(a), move(b), move(x0)


@pytest.mark.parametrize("name", sorted(DIAG_SHAPES))
def test_diagonal_scan_kernel_matches_plain_version(card, name):
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda, goom_diag_scan_ref

    a, b, x0 = diag_operands(name, card)
    before = (diagonal_scan_cuda.launches, diagonal_scan_cuda.copies)
    engine.reset_calls()
    got = engine.diagonal_scan(a, b, x0)
    torch.cuda.synchronize()
    assert (diagonal_scan_cuda.launches, diagonal_scan_cuda.copies) == (before[0] + 1, before[1])
    assert engine.calls["diagonal_scan"] == 1
    plain = goom_diag_scan_ref(a, b, x0)
    assert got.shape == plain.shape and not torch.isnan(got.log_abs).any()
    exact = goom_diag_scan_ref(_f64(a), _f64(b), _f64(x0))
    scale = goom_diag_scan_ref(_abs(_f64(a)), _abs(_f64(b)), _abs(_f64(x0)))
    assert_no_worse_than_plain(got, plain, exact, scale.log_abs)
    assert_goom_close(got.log_abs, got.sign, plain.log_abs, plain.sign,
                      scale_log=scale.log_abs.float(), cancel_margin=8.0)
    if DIAG_SHAPES[name][-1] == "e200":   # the exact cancellation
        assert float(got.log_abs.flatten()[0]) == -float("inf")
        assert float(got.sign.flatten()[0]) == 1.0


def test_diagonal_scan_kernel_broadcasts_by_strides(card):
    """A time-invariant ``a`` (stride 0 over time) and no x0 go in without a
    copy; an ``a`` broadcast over a middle dim is copied (and counted); zero
    inputs stay exact zeros."""
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda, goom_diag_scan_ref

    a, b, _ = diag_operands("odd_c", card, seed=4)
    for a1, copied in ((a[:1], 0), (a[:, :, :1], 1)):
        before = diagonal_scan_cuda.copies
        got = diagonal_scan_cuda(a1, b, None)
        assert diagonal_scan_cuda.copies == before + copied
        want = goom_diag_scan_ref(a1, b, None)
        scale = goom_diag_scan_ref(_abs(_f64(a1)), _abs(_f64(b)), None)
        assert_goom_close(got.log_abs, got.sign, want.log_abs, want.sign,
                          scale_log=scale.log_abs.float(), cancel_margin=8.0)
    zeros_b = Goom(torch.full_like(b.log_abs, -torch.inf), torch.ones_like(b.sign))
    got = diagonal_scan_cuda(a, zeros_b, None)
    assert bool((got.log_abs == -torch.inf).all()) and bool((got.sign == 1).all())


def test_diagonal_scan_kernel_backward_is_the_plain_versions(card):
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda, goom_diag_scan_ref

    a, b, x0 = diag_operands("odd_c", card, seed=5)
    b = Goom(torch.randn_like(b.log_abs), b.sign)   # no zeros: finite gradients
    grads = []
    for fn in (diagonal_scan_cuda, goom_diag_scan_ref):
        logs = [g.log_abs.clone().requires_grad_() for g in (a, b, x0)]
        out = fn(Goom(logs[0], a.sign), Goom(logs[1], b.sign), Goom(logs[2], x0.sign))
        out.log_abs.sum().backward()
        grads.append([x.grad for x in logs])
    for g_kernel, g_plain in zip(*grads):
        assert torch.equal(g_kernel, g_plain)


def test_diagonal_scan_kernel_raises_on_what_it_does_not_take(card):
    from repro_torch.kernels.goom_scan import diagonal_scan_cuda

    a, b, x0 = diag_operands("t1", card)
    bf = Goom(a.log_abs.bfloat16(), a.sign.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        diagonal_scan_cuda(bf, b, x0)
    with pytest.raises(TypeError, match="float32"):
        engine.diagonal_scan(bf, b, x0)
    with pytest.raises(ValueError):
        diagonal_scan_cuda(a, Goom(b.log_abs.cpu(), b.sign.cpu()), x0)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------
def _train_model(card, variant, smoke, compute_dtype=None, remat=None):
    import dataclasses

    from repro_torch import DecoderLM, get_config
    from torch_parity import with_scan_variant

    cfg = with_scan_variant(get_config("goom-rnn-124m", smoke=smoke), variant)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    return cfg, DecoderLM(cfg, device=card,
                          generator=torch.Generator(device=card).manual_seed(0))


def _copy_batch(card, vocab, seq, batch, step=0):
    from repro_torch.train import DataConfig, SyntheticStream
    from repro_torch.train.data import to_device

    stream = SyntheticStream(DataConfig(task="copy", vocab=vocab, seq_len=seq,
                                        global_batch=batch))
    return to_device(stream.generate(step), card)


def _launch_counts():
    return (lmme_cuda.launches, matrix_scan_cuda.launches, matrix_scan_cuda.launches_zero_b)


# kernels a forward launches at full width (24 layers, S=128, chunk 128):
# shared_a 15 LMME a layer (B·u, the carry fold, 7 doubling levels, 6
# squarings of A); generic 1 LMME (B·u) and 1 with-B matrix scan a layer
FULL_WIDTH_LAUNCHES = {"shared_a": (360, 0, 0), "generic": (24, 24, 0)}


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("variant", sorted(FULL_WIDTH_LAUNCHES))
def test_full_width_train_step_launches_the_forwards_kernels(card, variant, remat):
    """One train step of goom-rnn-124m at full width (B=16, S=128, bf16
    compute): a finite loss and gradient norm, and the step launches
    exactly the forward's kernels under ``remat="none"`` (the backward is
    autograd of the plain versions and launches none), twice them under
    ``"full"`` (the backward re-runs each period's forward)."""
    from repro_torch.train import AdamW, cosine_schedule, init_train_state, make_train_step

    cfg, model = _train_model(card, variant, smoke=False, remat=remat)
    opt = AdamW(cosine_schedule(3e-3, 20, 200))
    step = make_train_step(model, opt)
    batch = _copy_batch(card, cfg.vocab, 128, 16)
    state = init_train_state(model, opt)
    engine.reset_calls()
    before = _launch_counts()
    with torch.no_grad():
        model.loss(batch["tokens"], batch["labels"])
    forward = tuple(x - y for x, y in zip(_launch_counts(), before))
    assert forward == FULL_WIDTH_LAUNCHES[variant]
    assert engine.calls["lmme"] == forward[0] and engine.calls["matrix_scan"] == forward[1]
    before = _launch_counts()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    runs = 2 if remat == "full" else 1
    assert tuple(x - y for x, y in zip(_launch_counts(), before)) == \
        tuple(runs * v for v in forward)
    assert state.step == 1
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["tokens"]) == 16 * 16


@pytest.mark.parametrize("variant", ["shared_a", "generic"])
def test_train_grads_on_the_kernels_match_the_plain_versions(card, variant):
    """Smoke widths at f32 compute, B=4, S=64: loss and per-leaf
    max-normalised gradients on the kernels against the same under
    ``torch_reference`` on the card: loss rtol 1e-5, gradients 5e-4 (the
    CPU tests' bound for the plain path against JAX)."""
    cfg, model = _train_model(card, variant, smoke=True, compute_dtype=torch.float32)
    batch = _copy_batch(card, cfg.vocab, 64, 4)
    params = dict(model.named_parameters())
    out = []
    for backend in ("auto", "torch_reference"):
        before = lmme_cuda.launches
        with engine.use_backend(backend):
            loss, _ = model.loss(batch["tokens"], batch["labels"])
            grads = torch.autograd.grad(loss, list(params.values()))
        assert (lmme_cuda.launches > before) == (backend == "auto")
        out.append((float(loss.detach()), dict(zip(params, grads))))
    (loss_k, g_k), (loss_p, g_p) = out
    np.testing.assert_allclose(loss_k, loss_p, rtol=1e-5)
    for n in g_p:
        assert bool(torch.isfinite(g_k[n]).all()), n
        err = float((g_k[n] - g_p[n]).abs().max() / g_p[n].abs().max())
        assert err <= 5e-4, f"{n}: {err:.3e}"


def test_checkpoint_round_trip_from_the_card(card, tmp_path):
    """A train state on the card written, restored into a model built from
    other weights, equal bit for bit; the next step from both gives the
    same loss."""
    from repro_torch.train import (
        AdamW,
        CheckpointManager,
        constant_schedule,
        init_train_state,
        load_state_tree,
        make_train_step,
        state_tree,
    )

    cfg, model = _train_model(card, "shared_a", smoke=True)
    opt = AdamW(constant_schedule(1e-3))
    state = init_train_state(model, opt)
    state, _ = make_train_step(model, opt)(state, _copy_batch(card, cfg.vocab, 64, 4))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, state_tree(cfg, state), extra={"data": {"step": state.step}})

    from repro_torch import DecoderLM

    other = DecoderLM(cfg, device=card, generator=torch.Generator(device=card).manual_seed(1))
    restored = init_train_state(other, opt)
    step, tree, extra = mgr.restore_latest(state_tree(cfg, restored))
    restored = load_state_tree(cfg, restored, tree)
    assert step == restored.step == 1 and extra == {"data": {"step": 1}}
    for key in ("mu", "nu"):
        for n, v in state.opt_state[key].items():
            assert restored.opt_state[key][n].device.type == "cuda"
            assert torch.equal(restored.opt_state[key][n], v), (key, n)
    for n, p in state.params.items():
        assert torch.equal(restored.params[n], p), n
    batch = _copy_batch(card, cfg.vocab, 64, 4, step=1)
    _, m1 = make_train_step(model, opt)(state, batch)
    _, m2 = make_train_step(other, opt)(restored, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)


# ---------------------------------------------------------------------------
# the serving steps as CUDA graphs
# ---------------------------------------------------------------------------
def _serve_model(card, arch, variant=None):
    import dataclasses

    from repro_torch import DecoderLM, get_config
    from torch_parity import with_scan_variant

    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
    if variant is not None:
        cfg = with_scan_variant(cfg, variant)
    return DecoderLM(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))


def _serve_run(model, eager):
    from repro_torch import Engine, Request

    eng = Engine(model, max_slots=2, page_len=96, chunk=7)
    if eager:  # every step called directly, none captured
        def run(name, fn, *args):
            with engine.use_backend(eng.graphs.backend):
                fn(*args)
        eng.graphs.run = run
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab, size=p).tolist(),
                    max_new_tokens=b)
            for i, (p, b) in enumerate(zip([1, 7, 19, 64, 70], [9, 4, 12, 6, 3]))]
    return eng, eng.run(reqs)


@pytest.mark.parametrize("arch,variant", [("goom-rnn-124m", "shared_a"),
                                          ("goom-rnn-124m", "generic"),
                                          ("jamba-v0.1", None)])
def test_graphed_and_eager_steps_give_equal_tokens_and_caches(card, arch, variant):
    from torch_parity import cache_leaves

    model = _serve_model(card, arch, variant)
    eager, want = _serve_run(model, eager=True)
    graphed, got = _serve_run(model, eager=False)
    assert got == want
    assert graphed.graphs.n_graphs >= 4      # chunk, tail, an admission, decode
    for (name, a), (_, b) in zip(cache_leaves(graphed._caches), cache_leaves(eager._caches)):
        assert torch.equal(a, b), name
    assert torch.equal(graphed._tokens, eager._tokens)
    assert torch.equal(graphed._pos, eager._pos)


@pytest.mark.parametrize("variant", ["shared_a", "generic"])
def test_replays_move_the_replay_aware_counters(card, variant):
    """The wrappers' counts move only at warm-up and capture; each replay adds
    its graph's captured launches and calls, and launches equal calls."""
    from repro_torch.serve import graphs

    model = _serve_model(card, "goom-rnn-124m", variant)
    engine.reset_calls()
    graphs.reset_replays()
    before = graphs.kernel_launches()
    eng, _ = _serve_run(model, eager=False)
    torch.cuda.synchronize()
    launches = {k: v - before[k] + graphs.replayed["launches"].get(k, 0)
                for k, v in graphs.kernel_launches().items()}
    calls = {k: v + graphs.replayed["calls"].get(k, 0) for k, v in engine.calls.items()}
    assert launches["lmme"] == calls["lmme"] > 0
    assert launches["matrix_scan"] == calls["matrix_scan"]
    assert (launches["matrix_scan"] > 0) == (variant == "generic")
    cap = eng.graphs.captured()
    assert cap["decode_k8"]["replays"] >= 1 and cap["decode_k1"]["replays"] >= 1
    # one replayed k-step decode stands for k eager steps' calls
    assert cap["decode_k8"]["calls"]["lmme"] == 8 * cap["decode_k1"]["calls"]["lmme"]


def test_a_capture_failure_raises_and_does_not_fall_back(card):
    """A step that reads the card back to the host cannot be captured: the
    run raises, and so does the next (no eager fallback is kept)."""
    from repro_torch.serve import StepGraphs

    g = StepGraphs()
    x = torch.zeros(4, device=card)

    def step(t):
        t.add_(1.0)
        if float(t.sum()) > 1e9:   # a host sync: not capturable
            t.zero_()

    for _ in range(2):
        with pytest.raises(RuntimeError):
            g.run("bad", step, x)
    assert g.n_graphs == 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# generate: the decode step one CUDA graph, replayed a token
# ---------------------------------------------------------------------------
def _frontend_inputs(model, b, p, card):
    gen = torch.Generator(device=card).manual_seed(3)
    cfg = model.cfg
    kw = {"prefix_embeds": 0.5 * torch.randn(b, cfg.n_prefix, cfg.d_model, generator=gen,
                                             device=card)}
    if cfg.mrope:
        i = torch.arange(p, device=card)
        side, grid = cfg.n_prefix // 2, i < cfg.n_prefix
        kw["mrope_positions"] = torch.stack([
            torch.where(grid, 0, i), torch.where(grid, i // side, i),
            torch.where(grid, i % side, i)])[:, None].expand(3, b, p)
    return kw


@pytest.mark.parametrize("arch", ["musicgen-large", "qwen2-vl-7b", "goom-rnn-124m"])
def test_generate_graphed_decode_equals_eager(card, arch, monkeypatch):
    """``generate`` captures its decode step once and replays it a token; the
    tokens equal those of the same steps run eagerly (frontend inputs for
    the two frontend models)."""
    from repro_torch.serve import StepGraphs, generate, steps

    model = _serve_model(card, arch, "shared_a" if arch == "goom-rnn-124m" else None)
    b, p = 3, 12
    prompt = torch.randint(0, model.cfg.vocab, (b, p), device=card,
                           generator=torch.Generator(device=card).manual_seed(2))
    kw = _frontend_inputs(model, b, p, card) if model.cfg.frontend else {}
    made = []

    class Recorded(StepGraphs):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(steps, "StepGraphs", Recorded)
    got = generate(model, prompt, 9, 32, **kw)
    assert len(made) == 1 and made[0].n_graphs == 1
    assert made[0].captured()["generate_decode"]["replays"] == 8

    class Eager(StepGraphs):
        def run(self, name, fn, *args):
            with engine.use_backend(self.backend):
                fn(*args)

    monkeypatch.setattr(steps, "StepGraphs", Eager)
    want = generate(model, prompt, 9, 32, **kw)
    assert torch.equal(got, want)


def test_generate_capture_failure_raises(card, monkeypatch):
    """A decode step that reads the card back cannot be captured: generate
    raises rather than decode eagerly."""
    from repro_torch.serve import generate

    model = _serve_model(card, "qwen2-vl-7b")
    step = model.decode_step

    def reading_step(token, caches, index, **kw):
        if float(index.sum()) < 0:   # a host read: not capturable
            raise AssertionError
        return step(token, caches, index, **kw)

    monkeypatch.setattr(model, "decode_step", reading_step)
    prompt = torch.zeros(2, 10, dtype=torch.long, device=card)
    with pytest.raises(RuntimeError):
        generate(model, prompt, 4, 32, **_frontend_inputs(model, 2, 10, card))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# launch knobs, MAX_D, and the Engine under a mesh of ranks sharing the card
# ---------------------------------------------------------------------------
def test_max_d_is_refused_on_the_card(card):
    """The matrix-scan kernels take d <= MAX_D = 128: at d = 129 on the card
    the engine's matrix scan and prefix products raise the wrapper's
    ValueError (no silent fall back to the plain version)."""
    from repro_torch.kernels.goom_scan import MAX_D

    rng = np.random.default_rng(3)
    d = MAX_D + 1
    a = Goom(*(torch.tensor(x, device=card) for x in goom_planes(rng, (4, d, d))))
    b = Goom(*(torch.tensor(x, device=card) for x in goom_planes(rng, (4, d, 1))))
    with pytest.raises(ValueError, match=f"d <= {MAX_D}"):
        engine.matrix_scan(a, b)
    with pytest.raises(ValueError, match=f"d <= {MAX_D}"):
        engine.cumulative_lmme(a)


@pytest.mark.parametrize("blocks,want_l", [({"block_t": 4}, 4), ({"algo": "seq"}, 37),
                                           ({}, None)])
def test_use_blocks_sets_the_chunk_the_kernels_launch_with(card, blocks, want_l):
    """``use_blocks`` reaches the launch: the with-B and zero-B kernels run
    at the pinned L (``algo="seq"``: L = T), and the states stay the plain
    version's."""
    from repro_torch.kernels.goom_scan.ops import with_b_chunk_len, zero_b_chunk_len

    rng = np.random.default_rng(4)
    t, d = 37, 16

    def positive(shape):   # no cancellation: the states compare entry by entry
        log = torch.tensor(goom_planes(rng, shape)[0], device=card) - 2.0
        return Goom(log, torch.ones_like(log))

    a, b = positive((t, d, d)), positive((t, d, 2))
    with engine.use_blocks(matrix_scan=blocks, cumulative_lmme=blocks):
        got = engine.matrix_scan(a, b)
        assert matrix_scan_cuda.last_chunk[3] == (want_l or with_b_chunk_len(t, d))
        prod = engine.cumulative_lmme(a)
        assert matrix_scan_cuda.last_chunk[3] == (want_l or zero_b_chunk_len(t, d))
    plain = matrix_scan_ref(a, b)
    assert_goom_close(got.log_abs, got.sign, plain.log_abs, plain.sign)
    with engine.use_backend("torch_reference"):
        plain = engine.cumulative_lmme(a)
    assert_goom_close(prod.log_abs, prod.sign, plain.log_abs, plain.sign)


def _mesh_engine_rank(rank, variant):
    """A rank of a 2-rank mesh on the card: the smoke model's Engine under
    the mesh and without it, on the same requests."""
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    model = _serve_model(torch.device("cuda"), "goom-rnn-124m", variant)
    mesh = make_host_mesh(seq_shards=2)
    from repro_torch import Engine, Request

    rng = np.random.default_rng(0)
    reqs = lambda: [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab, size=p).tolist(),
                            max_new_tokens=6) for i, p in enumerate([19, 5])]
    sharded = Engine(model, max_slots=2, page_len=96, chunk=8, mesh=mesh)
    got = sharded.run(reqs())
    rng = np.random.default_rng(0)
    want = Engine(model, max_slots=2, page_len=96, chunk=8).run(reqs())
    modes = {k: v["mode"] for k, v in sharded.graphs.captured().items()}
    return got, want, modes


@pytest.mark.parametrize("variant", ["shared_a", "generic"])
def test_engine_under_a_mesh_captures_only_local_steps(card, variant):
    """Two gloo ranks on the card run one Engine under a (1, 2) mesh: the
    chunk steps (T = 8 >= 2, their scans time-sharded, collectives through
    the host) run eagerly, the decode and tail steps (T = 1, local) are
    graphs, and the tokens equal a local Engine's."""
    from repro_torch.launch.mesh import spawn_ranks

    for got, want, modes in spawn_ranks(_mesh_engine_rank, 2, variant, timeout=300):
        assert got == want
        assert any(name.startswith("decode") for name in modes)
        for name, mode in modes.items():   # chunk steps: prefill_chunk, admit_chunk
            assert mode == ("eager" if "chunk" in name else "graph"), (name, mode)
