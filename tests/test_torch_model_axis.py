"""The model axis on gloo CPU ranks: heads, MLP channels, Mamba channels
and the vocabulary split across ranks (``sharding/tensor_parallel.py``).

Under the default rules on a ("data", "model") mesh of (1, 2) and of
(2, 2) (one spawn each, shared by its cases: ``torch_dist_workers.
model_axis_world``), each rank runs its block of the attention heads, the
dense MLP's channels, the goom layer's heads, Mamba's channels and the
vocabulary.  Held here, on the smoke configs of goom-rnn-124m (both scan
variants), olmo-1b, gemma3-1b (one KV head: replicated, each rank reads
it) and jamba-v0.1 (Mamba and the MoE split):

* the first step's f32 loss and each leaf's gradient, the parameters laid
  out, against one process on the global batch, by their distance to the
  same step in float64 on one process (the same weights cast): the ranks'
  loss within twice one process's distance of the float64 loss (floored at
  one f32 ulp of the loss), and every leaf's gradient within twice the
  largest leaf distance of one process's (norm of the difference over the
  norm of the float64 gradient); the clip's global norm over the laid-out
  gradients (a split leaf counted once a block, a replicated one once)
  within 1e-5 of the whole gradients' norm.  A reduction the split misses
  puts a leaf O(1) away;
* goom-rnn's with plain parameters (the launcher's branch for gloo ranks
  sharing a card) the same way, and its loss against JAX's on the same
  weights (rtol 1e-5, ``tests/test_torch_fsdp.py``'s);
* the split modules' weights gathered over the batch axis only: each such
  weight whose dim the layout splits on "model" reaches its module as the
  block, 1/2 of its whole bytes;
* a fresh-cache prefill laid out on (1, 2): each rank's caches its block of
  one process's (olmo's KV heads halved; gemma3's one KV head whole on
  both ranks), within one bf16 ulp, and the last logits whole and within
  1e-4·std of one process's;
* the vocabulary-split NLL and embedding lookup against whole ones, values
  and gradients, on a vocabulary of 11 over two ranks (blocks of 6 and 5);
* Mamba's ``in_proj`` block: [x; z] split as both halves' blocks, where a
  contiguous block of the weight would hand rank 0 all of x;
* the backward on a thread that holds no rules (autograd's device thread,
  which runs a CUDA tensor's backward and the remat recomputation with it)
  gives the same gradients to the bit: the periods' recomputation takes
  the forward's rules with it (found on the card, where the recomputed
  periods ran unsplit and the gradients came out 0.31 away).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_workers as workers
from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.models.model import DecoderLM as JaxLM
from repro_torch.convert import params_to_jax
from repro_torch.core import engine
from repro_torch.launch.dryrun import _split_role
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.ssm import in_proj_block
from repro_torch.serve.steps import make_prefill_step
from repro_torch.sharding import NamedMesh, make_rules, param_specs
from repro_torch.sharding.tensor_parallel import Split

torch.set_num_threads(2)
MESHES = [(1, 2), (2, 2)]
#: the ranks' distance to float64 against one process's
SPREAD = 2.0
F32_ULP = 2.0 ** -23
#: one bf16 ulp, relative (7 explicit mantissa bits): a cache entry whose f32
#: value the two paths round apart lands one bf16 step away
BF16_ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def worlds():
    return {shape: spawn_ranks(workers.model_axis_world, shape[0] * shape[1], shape,
                               timeout=600) for shape in MESHES}


@functools.lru_cache(maxsize=None)
def one_process(arch, variant, count, f64=False):
    """One process's first-step loss and gradients on the global batch of
    ``count`` data ranks' slices, f32 or float64: the mean over the slices,
    each one a microbatch (the MoE's capacity and aux losses are per slice,
    as on the ranks)."""
    model = workers.model_axis_model(arch, variant, f64)
    b = workers.global_batch(0, count)
    k = len(b["tokens"]) // count
    loss, grads = 0.0, None
    for i in range(count):
        part = slice(i * k, (i + 1) * k)
        with engine.use_backend("torch_reference"):
            li, _ = model.loss(torch.as_tensor(b["tokens"][part]),
                               torch.as_tensor(b["labels"][part]))
            gi = torch.autograd.grad(li, list(model.parameters()))
        loss += float(li) / count
        gi = [g.double() / count for g in gi]
        grads = gi if grads is None else [a + g for a, g in zip(grads, gi)]
    return loss, {n: g.numpy() for (n, _), g in zip(model.named_parameters(), grads)}


def _distance(got, ref):
    """|got - ref| / |ref|; |got| where ref is zero (a leaf no loss reaches)."""
    norm = np.linalg.norm(ref)
    return float(np.linalg.norm(got - ref) / norm if norm else np.linalg.norm(got))


def _check_against_f64(run, arch, variant, shape):
    loss32, g32 = one_process(arch, variant, shape[0])
    loss64, g64 = one_process(arch, variant, shape[0], f64=True)
    assert set(run["grads"]) == set(g64)
    one = max(_distance(g32[n], g64[n]) for n in g64)
    ranks = {n: _distance(run["grads"][n], g64[n]) for n in g64}
    worst = max(ranks, key=ranks.get)
    assert ranks[worst] <= SPREAD * one, (arch, variant, shape, worst, ranks[worst], one)
    bar = SPREAD * max(abs(loss32 - loss64), F32_ULP * abs(loss64))
    assert abs(run["loss"] - loss64) <= bar, (arch, variant, shape, run["loss"], loss32, loss64)
    # the clip's sum of squares over the layout, a split leaf once a block and a
    # replicated one once, against the whole gradients' (f32 sums: 1e-5)
    whole = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                              for g in run["grads"].values())))
    assert abs(run["norm"] - whole) <= 1e-5 * whole, (arch, variant, shape, run["norm"], whole)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", workers.MODEL_AXIS_TRAIN, ids=lambda c: "-".join(filter(None, c)))
def test_split_step_against_float64(worlds, shape, case):
    world = worlds[shape]
    for r in world:
        assert r["train"][case]["loss"] == world[0]["train"][case]["loss"]
    _check_against_f64(world[0]["train"][case], *case, shape)


@pytest.mark.parametrize("shape", MESHES)
def test_plain_parameters_split_against_float64(worlds, shape):
    _check_against_f64(worlds[shape][0]["plain"], "goom-rnn-124m", "shared_a", shape)


def test_split_loss_tracks_jax(worlds):
    """goom-rnn smoke's loss on (1, 2) against JAX's on the same weights."""
    model = workers.model_axis_model("goom-rnn-124m", "shared_a")
    jcfg = dataclasses.replace(jax_get_config("goom-rnn-124m", smoke=True),
                               compute_dtype=jnp.float32)
    jparams = jax.tree.map(jnp.asarray, params_to_jax(model.cfg, {
        n: p.detach() for n, p in model.named_parameters()}))
    b = workers.global_batch(0, 1)

    def loss(params, tokens, labels):
        with jax_engine.use_backend("reference"):
            return JaxLM(jcfg).loss(params, tokens, labels)[0]

    want = float(jax.jit(loss)(jparams, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])))
    got = worlds[(1, 2)][0]["train"][("goom-rnn-124m", "shared_a")]["loss"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("shape", MESHES)
def test_split_weights_gathered_over_the_batch_axis_only(worlds, shape):
    rules = make_rules(NamedMesh(shape, ("data", "model")))
    kept_bytes = whole_bytes = 0
    for case in workers.MODEL_AXIS_TRAIN:
        run = worlds[shape][0]["train"][case]
        model = workers.model_axis_model(*case)
        specs = param_specs(rules, model)
        whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert run["roles"] == model.split_roles(rules) and run["roles"]
        for name, role in run["roles"].items():
            kept = _split_role(specs[name], role)[0]
            want = list(whole[name])
            if kept is not None:
                want[role[1]] //= 2
                kept_bytes += 4 * int(np.prod(want))
                whole_bytes += 4 * int(np.prod(whole[name]))
            assert run["gathered"][name] == tuple(want), (case, name)
        for name in set(whole) - set(run["roles"]):   # the rest gathered whole
            assert run["gathered"].get(name, whole[name]) == whole[name], (case, name)
    assert kept_bytes * 2 == whole_bytes > 0


def _one_prefill(arch):
    model = workers.model_axis_model(arch).requires_grad_(False)
    rows, _, length = workers.MODEL_AXIS_PROMPT
    step = make_prefill_step(model, backend="torch_reference", fresh_caches=True)
    logits, caches = step(workers.model_axis_prompt(), model.init_caches(rows, length))
    return logits.numpy(), [{k: v.float().numpy() for k, v in layer.items()}
                            for layer in caches]


@pytest.mark.parametrize("arch", workers.MODEL_AXIS_PREFILL)
def test_split_prefill_caches_are_the_ranks_blocks(worlds, arch):
    logits, caches = _one_prefill(arch)
    kv = workers.model_axis_model(arch).cfg.layer_list[0].attn.n_kv_heads
    for rank, r in enumerate(worlds[(1, 2)]):
        got = r["prefill"][arch]
        np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-4 * logits.std())
        for layer, mine in zip(caches, got["caches"]):
            assert set(layer) == set(mine)
            for key, want in layer.items():
                if key in ("k", "v") and kv % 2 == 0:   # the rank's KV heads
                    half = kv // 2
                    want = want[:, :, rank * half:(rank + 1) * half]
                assert mine[key].shape == want.shape, (arch, key)
                np.testing.assert_allclose(mine[key], want, rtol=BF16_ULP, atol=1e-6)
    assert kv in (1, 4)


def test_vocab_split_nll_and_embedding(worlds):
    logits, labels, tokens, table = workers.vocab_case_inputs()
    x = torch.tensor(logits, requires_grad=True)
    lab = torch.tensor(labels)
    mask = (lab >= 0).float()
    gold = x.gather(-1, lab.clamp_min(0)[..., None])[..., 0]
    nll = ((torch.logsumexp(x, -1) - gold) * mask).sum()
    (grad,) = torch.autograd.grad(nll, [x])
    w = torch.tensor(table, requires_grad=True)
    emb = F.embedding(torch.tensor(tokens), w)
    (emb_grad,) = torch.autograd.grad((emb * torch.arange(emb.numel()).view_as(emb)).sum(), [w])
    blocks = []
    for r in worlds[(1, 2)]:
        got = r["vocab"]
        lo, k = got["block"]
        blocks.append((lo, k))
        assert abs(got["nll"] - float(nll)) <= 1e-6 * float(nll)
        np.testing.assert_allclose(got["grad"], grad[..., lo:lo + k].numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(got["embed"], emb.detach().numpy())
        np.testing.assert_array_equal(got["embed_grad"], emb_grad.numpy())
    assert blocks == [(0, 6), (6, 5)]


@pytest.mark.parametrize("rank", [0, 1])
def test_mamba_in_proj_block_splits_both_halves(rank):
    d, di = 4, 6
    w = torch.randn(d, 2 * di, generator=torch.Generator().manual_seed(7))
    x = torch.randn(3, d, generator=torch.Generator().manual_seed(8))
    sp = Split("model", 1, 2, rank, None)
    xi, z = (x @ w).chunk(2, dim=-1)
    got_x, got_z = (x @ in_proj_block(w, sp, di)).chunk(2, dim=-1)
    cols = slice(rank * 3, rank * 3 + 3)
    torch.testing.assert_close(got_x, xi[:, cols], rtol=0, atol=1e-6)
    torch.testing.assert_close(got_z, z[:, cols], rtol=0, atol=1e-6)
    # the layout's contiguous block of the weight: all of x on rank 0, all
    # of z on rank 1, so one of its halves is not the rank's block
    naive_x, naive_z = (x @ w[:, rank * di:(rank + 1) * di]).chunk(2, dim=-1)
    assert not (torch.allclose(naive_x, xi[:, cols]) and torch.allclose(naive_z, z[:, cols]))


def test_backward_on_a_thread_without_rules(worlds):
    for r in worlds[(1, 2)]:
        assert r["other_thread"] == 0.0
