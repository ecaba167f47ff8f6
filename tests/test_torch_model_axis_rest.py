"""The rest of the model axis on gloo CPU ranks: RWKV6's heads and channels,
the MoE experts' channels, and KV caches split by sequence where the KV
heads do not divide the axis (``sharding/tensor_parallel.py``).

Under the default rules on a ("data", "model") mesh of (1, 2) and of
(2, 2) (one spawn each, shared by its cases: ``torch_dist_workers.
model_axis_rest_world``), each rank runs RWKV6's time mix on its H/M heads
(the WKV and its LMME calls among them) and its channel mix on its block of
d_ff, and each MoE expert on its block of channels.  Held here, on the smoke
configs of rwkv6-7b (``float`` and ``goom`` scans), mixtral-8x7b (capacity
routing) and jamba-v0.1 (Mamba and the MoE both split):

* the first step's f32 loss and each leaf's gradient, the parameters laid
  out, against one process's float64 step, within twice one f32 process's
  distance (``test_torch_model_axis.py``'s measure and bars), and the
  clip's norm over the layout;
* RWKV6's and mixtral's loss on (1, 2) against JAX's on the same weights
  (rtol 1e-5);
* each split weight whose dim the layout splits on "model" reaches its
  module as the block, 1/2 of its whole bytes, and RWKV6's LMME calls run
  on (B, H/2, L, D) operands;
* mixtral's dropless prefill logits against one process's (1e-4·std);
* gemma3 smoke (one KV head) with ``cache_seq="model"``: a fresh prefill
  and 3 decode steps across the rolling buffer's wrap: each rank's bf16
  caches after the prefill its block of one process's rows within one
  bf16 ulp, the tokens equal; with f32 K/V (bf16 writes of K/V computed a
  rounding apart can land a step apart, which moves a decode step's logits
  by ~1e-3·std), every step's logits within 1e-4·std and the caches after
  the decode steps the rank's rows of one process's;
* the two places a whole value must not enter the split: x entering at the
  top of the channel mix (its receptance) or of the MoE (its router) puts
  a leaf O(1) from float64;
* ``ln_x``'s RMSNorm over all d channels from the ranks' blocks: values
  and gradients equal to the whole norm's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.models.model import DecoderLM as JaxLM
from repro_torch.convert import params_to_jax
from repro_torch.launch.dryrun import _split_role
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.norms import rmsnorm_apply
from repro_torch.sharding import NamedMesh, make_rules, param_specs
from test_torch_model_axis import BF16_ULP, _check_against_f64, _distance, one_process

torch.set_num_threads(2)
MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def worlds():
    return {shape: spawn_ranks(workers.model_axis_rest_world, shape[0] * shape[1], shape,
                               timeout=600) for shape in MESHES}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", workers.MODEL_AXIS_REST_TRAIN,
                         ids=lambda c: "-".join(filter(None, c)))
def test_split_step_against_float64(worlds, shape, case):
    world = worlds[shape]
    for r in world:
        assert r["train"][case]["loss"] == world[0]["train"][case]["loss"]
    _check_against_f64(world[0]["train"][case], *case, shape)


@pytest.mark.parametrize("arch,variant", [("rwkv6-7b", "goom"), ("mixtral-8x7b", None)])
def test_split_loss_tracks_jax(worlds, arch, variant):
    model = workers.model_axis_model(arch, variant)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), compute_dtype=jnp.float32)
    jparams = jax.tree.map(jnp.asarray, params_to_jax(model.cfg, {
        n: p.detach() for n, p in model.named_parameters()}))
    b = workers.global_batch(0, 1)

    def loss(params, tokens, labels):
        with jax_engine.use_backend("reference"):
            return JaxLM(jcfg).loss(params, tokens, labels)[0]

    want = float(jax.jit(loss)(jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])))
    got = worlds[(1, 2)][0]["train"][(arch, variant)]["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (arch, got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_split_weights_reach_their_modules_as_blocks(worlds, shape):
    rules = make_rules(NamedMesh(shape, ("data", "model")))
    split = set()
    for case in workers.MODEL_AXIS_REST_TRAIN:
        run = worlds[shape][0]["train"][case]
        model = workers.model_axis_model(*case)
        specs = param_specs(rules, model)
        whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert run["roles"] == model.split_roles(rules)
        for name, role in run["roles"].items():
            want = list(whole[name])
            if _split_role(specs[name], role)[0] is not None:
                want[role[1]] //= 2
                split.add(name.split(".", 2)[-1])
            assert run["gathered"][name] == tuple(want), (case, name)
    # RWKV6's time and channel mix and the MoE experts among the blocks
    assert {"mixer.r.w", "mixer.out.w", "mixer.bonus", "channel.k.w", "channel.v.w",
            "channel.gate", "channel.up", "channel.down"} <= split, split


def test_rwkv6_lmme_at_half_the_heads(worlds):
    heads = workers.model_axis_model("rwkv6-7b").cfg.layer_list[0].rwkv.n_heads
    for r in worlds[(1, 2)]:
        assert r["lmme_shapes"]
        for a, b in r["lmme_shapes"]:
            assert a[1] == b[1] == heads // 2, r["lmme_shapes"]


def _one_prefill_moe():
    model = workers.model_axis_model("mixtral-8x7b").requires_grad_(False)
    rows, _, length = workers.MODEL_AXIS_PROMPT
    from repro_torch.serve.steps import make_prefill_step

    step = make_prefill_step(model, backend="torch_reference", fresh_caches=True)
    logits, _ = step(workers.model_axis_prompt(), model.init_caches(rows, length))
    return logits.numpy()


def test_dropless_moe_prefill_against_one_process(worlds):
    want = _one_prefill_moe()
    for r in worlds[(1, 2)]:
        np.testing.assert_allclose(r["moe_prefill"], want, rtol=0, atol=1e-4 * want.std())


@functools.lru_cache(maxsize=None)
def _one_seq_run(case, f32_kv):
    model = workers.model_axis_model("gemma3-1b").requires_grad_(False)
    return workers.seq_split_run(model, *case, f32_kv=f32_kv)


def _check_rows(want, got, rank, rtol, atol, what):
    """Each cache leaf of ``got`` (a rank's) against ``want`` (one
    process's), K and V as the rank's block of rows with every KV head."""
    for layer, mine in zip(want, got):
        assert set(layer) == set(mine)
        for key, whole in layer.items():
            if key in ("k", "v"):
                half = whole.shape[1] // 2
                whole = whole[:, rank * half:(rank + 1) * half]
            assert mine[key].shape == whole.shape, (what, key)
            np.testing.assert_allclose(mine[key], whole, rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", workers.SEQ_SPLIT_CASES, ids=lambda c: f"{c[0]}-of-{c[1]}")
def test_sequence_split_caches_are_the_ranks_rows(worlds, case):
    """bf16 caches: after the prefill each rank's its block of one process's
    rows (every KV head) within one bf16 ulp; the decoded tokens equal."""
    want = _one_seq_run(case, False)
    for rank, r in enumerate(worlds[(1, 2)]):
        got = r["seq_split"][(case, False)]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        _check_rows(want["prefill_caches"], got["prefill_caches"], rank, BF16_ULP, 1e-6, case)


@pytest.mark.parametrize("case", workers.SEQ_SPLIT_CASES, ids=lambda c: f"{c[0]}-of-{c[1]}")
def test_sequence_split_caches_decode_as_one_process(worlds, case):
    """f32 caches: every step's logits within 1e-4·std of one process's, the
    tokens equal, the caches after the decode steps the rank's rows of one
    process's (f32: 1e-5)."""
    want = _one_seq_run(case, True)
    std = want["logits"].std()
    for rank, r in enumerate(worlds[(1, 2)]):
        got = r["seq_split"][(case, True)]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=1e-4 * std)
        _check_rows(want["caches"], got["caches"], rank, 1e-5, 1e-5, case)


@pytest.mark.parametrize("case", [("rwkv6-7b", "float"), ("mixtral-8x7b", None)],
                         ids=lambda c: c[0])
def test_whole_input_entering_the_split_is_caught(worlds, case):
    """x entering at the top of the channel mix or the MoE sums the
    receptance's or the router's gradient over both ranks: O(1) off."""
    _, g64 = one_process(*case, 1, f64=True)
    got = worlds[(1, 2)][0]["mutated"][case]["grads"]
    worst = max(_distance(got[n], g64[n]) for n in g64)
    assert worst > 0.3, (case, worst)
    right = worlds[(1, 2)][0]["train"][case]["grads"]
    assert max(_distance(right[n], g64[n]) for n in g64) < 1e-3


def test_split_ln_x_is_the_whole_norm(worlds):
    y, scale, w = workers.ln_x_inputs()
    yt = torch.tensor(y, requires_grad=True)
    out = rmsnorm_apply(torch.tensor(scale), yt)
    (grad,) = torch.autograd.grad((out * torch.tensor(w)).sum(), [yt])
    blocks = []
    for r in worlds[(1, 2)]:
        lo, k = r["ln_x"]["block"]
        blocks.append((lo, k))
        np.testing.assert_allclose(r["ln_x"]["out"], out.detach().numpy()[:, lo:lo + k],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["ln_x"]["grad"], grad.numpy()[:, lo:lo + k],
                                   rtol=1e-5, atol=1e-6)
    assert blocks == [(0, 4), (4, 4)]
