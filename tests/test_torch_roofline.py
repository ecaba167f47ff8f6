"""The port's roofline arithmetic and shape registry against the JAX package.

* ``count_params`` under its three flag settings and ``model_flops`` equal
  JAX's exactly, for every registered arch (full configs) at each of the
  four ``SHAPES``;
* ``shape_applicable`` and the shapes and dtypes of ``input_specs`` equal
  JAX's;
* ``CollectiveOp.ring_bytes`` equals JAX's for each kind at group sizes 1,
  2 and 16;
* ``dryrun.serve_cache_report`` rows equal JAX's ``slot_cache_bytes`` at 3
  slots of 40 rows, but for the attention layers' per-slot ``index``
  leaves, int64 in the port and int32 in JAX: 4 bytes a slot and attention
  layer more (``repro.launch.dryrun`` is not imported: it sets
  ``XLA_FLAGS`` at import, which would reach the later JAX tests of the
  same worker).
"""

import numpy as np
import pytest

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shape_applicable as jax_shape_applicable
from repro.launch import roofline as jroof
from repro.models.model import DecoderLM as JaxLM
from repro.serve import slot_cache_bytes as jax_slot_cache_bytes
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, input_specs, list_archs
from repro_torch.configs import shape_applicable
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import serve_cache_report

ARCHS = list_archs()
FLAGS = [dict(), dict(active_only=True), dict(active_only=True, flops_weighted=True)]


def test_registry_equals_jax():
    from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED

    assert ASSIGNED_ARCHS == JAX_ASSIGNED
    assert len(ARCHS) == 11
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()} == \
        {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in JAX_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for flags in FLAGS:
        assert roofline.count_params(cfg, **flags) == jroof.count_params(jcfg, **flags), flags
    for name in SHAPES:
        assert roofline.model_flops(cfg, SHAPES[name]) == \
            jroof.model_flops(jcfg, JAX_SHAPES[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_and_input_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert shape_applicable(cfg, SHAPES[name]) == \
            jax_shape_applicable(jcfg, JAX_SHAPES[name])
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1], v.device.type)
               for k, v in input_specs(cfg, SHAPES[name]).items()}
        want = {k: (tuple(v.shape), str(np.dtype(v.dtype)), "meta")
                for k, v in jax_input_specs(jcfg, JAX_SHAPES[name]).items()}
        assert got == want, name


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter",
                                  "all-to-all", "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 16])
def test_ring_bytes_equal_jax(kind, group):
    got = roofline.CollectiveOp(kind, 1 << 20, group).ring_bytes
    assert got == jroof.CollectiveOp(kind, 1 << 20, group).ring_bytes


def test_roofline_terms_use_the_h100_constants():
    rf = roofline.Roofline("a", "s", "1x1", 1, hlo_flops=2 * roofline.PEAK_FLOPS,
                           hlo_bytes=3 * roofline.HBM_BW, collective_bytes=roofline.LINK_BW,
                           collective_by_kind={}, model_flops=roofline.PEAK_FLOPS,
                           f32_flops=roofline.F32_FLOPS)
    # 2·peak FLOPs of which F32_FLOPS are f32: 1 s of each
    assert rf.compute_s == pytest.approx((2 * roofline.PEAK_FLOPS - roofline.F32_FLOPS)
                                         / roofline.PEAK_FLOPS + 1.0)
    assert rf.memory_s == pytest.approx(3.0) and rf.collective_s == pytest.approx(1.0)
    assert rf.bottleneck == "memory" and rf.step_time_s == pytest.approx(3.0)
    assert rf.mfu == pytest.approx(1 / 3)
    assert set(jroof.Roofline("a", "s", "m", 1, 0, 0, 0, {}, 0).to_dict()) <= set(rf.to_dict())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cache_report_equals_jax(arch, capsys):
    (row,) = serve_cache_report([arch], 3, 40)
    want = {k: int(v) for k, v in
            jax_slot_cache_bytes(JaxLM(jax_get_config(arch)), 3, 40).items()}
    n_attn = sum(blk.mixer == "attention" for blk in get_config(arch).layer_list)
    want["recurrent"] += 4 * 3 * n_attn           # the int64 index leaves
    want["total"] += 4 * 3 * n_attn
    want["per_slot"] = want["total"] // 3
    assert {k: int(v) for k, v in row.items() if k != "arch"} == want
    assert row["arch"] == arch
    assert arch in capsys.readouterr().out
