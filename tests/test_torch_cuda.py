"""The port's CUDA LMME kernel against its plain version, on a card.

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
from repro_torch.kernels.lmme import lmme_cuda, lmme_ref
from torch_parity import assert_goom_close, goom_planes, lmme_abs_scale

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
}


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
    before = lmme_cuda.launches
    got = lmme_cuda(ga, gb)
    torch.cuda.synchronize()
    assert lmme_cuda.launches == before + 1
    _check(got, a, b, ga, gb)


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
