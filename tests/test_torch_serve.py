"""The serving slice of the PyTorch port against the JAX package.

``smoke_config()`` of goom-rnn-124m at f32 compute, in both scan variants
(``shared_a`` and the paper-literal ``generic``), with the JAX model's
weights carried over by ``params_from_jax``:

  * prefill logits against JAX's ``model.prefill`` under the reference
    backend, atol 1e-4·std (as ``tests/test_serve_engine.py`` holds chunked
    prefill to full prefill);
  * ``Engine`` tokens against JAX's ``Engine`` on the same requests, equal
    token for token.  A mismatch is allowed only at a step where the JAX
    model's top-2 logit margin is below 1e-4·std(logits), and the request
    is compared no further;

plus the faults that must raise and the package's import boundary.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import engine as jax_engine
from repro.models.common import unzip
from repro.models.model import DecoderLM as JaxLM
from repro.serve import Engine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import DecoderLM, Engine, Request, get_config, params_from_jax
from repro_torch.core import engine
from repro_torch.kernels.lmme import lmme_cuda
from repro_torch.kernels.goom_scan import matrix_scan_cuda
from repro_torch.serve import ChunkedPrefill, SlotAllocator, merge_frozen, read_slot, write_slot
from torch_parity import with_scan_variant

torch.set_num_threads(2)

PROMPT_LENS = [1, 7, 19, 64]
BUDGETS = [5, 4, 6, 3]


@pytest.fixture(scope="module", params=["shared_a", "generic"])
def pair(request):
    """(JAX model, JAX params, port model) sharing weights, f32 compute, in
    the scan variant the test is parametrised over."""
    jcfg = dataclasses.replace(
        with_scan_variant(jax_get_config("goom-rnn-124m", smoke=True), request.param),
        compute_dtype=jnp.float32)
    jmodel = JaxLM(jcfg)
    jparams, _ = unzip(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = dataclasses.replace(
        with_scan_variant(get_config("goom-rnn-124m", smoke=True), request.param),
        compute_dtype=torch.float32)
    model = DecoderLM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, tree))
    return jmodel, jparams, model


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=p).tolist() for p in PROMPT_LENS]


def _jax_last_logits(jmodel, jparams, seq):
    def prefill(params, tokens, caches):
        with jax_engine.use_backend("reference"):
            return jmodel.prefill(params, tokens, caches)[0]

    lg = jax.jit(prefill)(jparams, jnp.asarray(seq, jnp.int32)[None],
                          jmodel.init_caches(1, len(seq)))
    return np.asarray(lg[0, -1], np.float32)


def test_params_from_jax_loads_every_weight(pair):
    jmodel, jparams, model = pair
    sd = params_from_jax(model.cfg, jax.tree.map(np.asarray, jparams))
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(model.layers[1].mixer.A.detach().numpy(),
                                  np.asarray(jparams["group_0"]["b0"]["mixer"]["A"][1]))


@pytest.mark.parametrize("plen", PROMPT_LENS)
def test_prefill_logits_match_jax(pair, plen):
    jmodel, jparams, model = pair
    seq = _prompts(model.cfg.vocab)[PROMPT_LENS.index(plen)]
    want = _jax_last_logits(jmodel, jparams, seq)
    with torch.no_grad():
        got, caches = model.prefill(torch.tensor([seq]), model.init_caches(1))
    got = got[0, -1].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.std(want)))
    assert len(caches) == model.cfg.n_layers
    assert caches[0]["x_log"].shape == (1, 8, 8, 1)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_prefill_matches_full(pair, chunk):
    _, _, model = pair
    seq = _prompts(model.cfg.vocab)[2]
    with torch.no_grad():
        full, _ = model.prefill(torch.tensor([seq]), model.init_caches(1))
    cp = ChunkedPrefill(model, chunk)
    got, _, next_pos = cp(seq, model.init_caches(1))
    assert next_pos == len(seq)
    assert (cp.n_chunk_calls, cp.n_tail_calls) == divmod(len(seq), chunk)
    scale = float(full.std())
    np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(), rtol=0,
                               atol=1e-4 * scale)


def _first_divergence(jmodel, jparams, prompt, got, want):
    """Check port tokens ``got`` against JAX tokens ``want``: equal, or
    diverging only where the JAX logits' top-2 margin is a near tie."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        lg = _jax_last_logits(jmodel, jparams, list(prompt) + list(want[:i]))
        top2 = np.sort(lg)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < 1e-4 * float(np.std(lg)), (
            f"token {i}: port {g} vs JAX {w} with margin {margin}")
        return i
    assert len(got) == len(want)
    return None


@pytest.mark.parametrize("chunk", [7, 64])
def test_engine_tokens_match_jax_engine(pair, chunk):
    """6 slots' worth of traffic through 2 slots: requests join and leave
    mid-batch, one stops at an EOS; tokens must be JAX's."""
    jmodel, jparams, model = pair
    prompts = _prompts(model.cfg.vocab)
    jeng = JaxEngine(jmodel, jparams, max_slots=2, page_len=80, chunk=chunk,
                     backend="reference")
    want = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=n)
                     for i, (p, n) in enumerate(zip(prompts, BUDGETS))])
    eos = want[0][2]  # request 0 stops at its third token
    eng = Engine(model, max_slots=2, page_len=80, chunk=chunk)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n,
                    eos_id=eos if i == 0 else None)
            for i, (p, n) in enumerate(zip(prompts, BUDGETS))]
    for r in reqs:
        eng.submit(r)
    while eng.has_work:
        eng.step()
    assert eng.finish_reason(0) == "stop"
    assert eng.result(0) == want[0][:want[0].index(eos) + 1]
    for i in range(1, len(prompts)):
        assert eng.finish_reason(i) == "length"
        assert len(eng.result(i)) == BUDGETS[i]
        _first_divergence(jmodel, jparams, prompts[i], eng.result(i), want[i])


def test_engine_validation_and_slot_lifecycle(pair):
    _, _, model = pair
    eng = Engine(model, max_slots=1, page_len=16, chunk=4)
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=[1] * 12, max_new_tokens=8))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=1, prompt=[], max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=2, prompt=[1, 2], max_new_tokens=0))
    eng.submit(Request(uid=3, prompt=[1, 2], max_new_tokens=1))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=3, prompt=[3, 4], max_new_tokens=2))
    with pytest.raises(ValueError):
        Engine(model, max_slots=1, page_len=4, chunk=8)
    out = eng.run()
    assert len(out[3]) == 1 and not eng.has_work
    with pytest.raises(KeyError):
        eng.finish_reason(3)  # run() hands results over and forgets them


def test_slot_cache_ops():
    alloc = SlotAllocator(3)
    assert [alloc.allocate() for _ in range(3)] == [0, 1, 2]
    assert alloc.allocate() is None
    alloc.release(1)
    assert alloc.allocate() == 1
    with pytest.raises(ValueError):
        alloc.release(5)
    alloc.release(0)
    with pytest.raises(ValueError):
        alloc.release(0)
    slots = [{"x": torch.zeros(3, 2, 1)}]
    src = [{"x": torch.ones(1, 2, 1)}]
    write_slot(slots, src, 2)
    assert torch.equal(read_slot(slots, 2)[0]["x"], src[0]["x"])
    assert torch.equal(read_slot(slots, 1)[0]["x"], torch.zeros(1, 2, 1))
    merged = merge_frozen([{"x": torch.full((3, 2, 1), 7.0)}], slots,
                          torch.tensor([True, False, False]))
    assert merged[0]["x"][:, 0, 0].tolist() == [7.0, 0.0, 1.0]


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.kernels import dispatch

    monkeypatch.setattr(dispatch, "current_platform", lambda: "cpu")
    cfg = get_config("goom-rnn-124m", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderLM(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecoderLM(cfg)  # the default device is cuda


def _layer_state(tree):
    """One goom layer's JAX param tree as the port module's state dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _layer_state(v).items()})
        else:
            out[k] = v
    return out


def test_scan_variants_agree_and_match_jax():
    """The layer's ``generic`` (engine.matrix_scan) and ``shared_a`` paths
    compute the same recurrence (``tests/test_engine.py``'s 2e-3), and the
    port's ``generic`` layer is JAX's on the same weights."""
    from repro.models.common import KeyGen
    from repro.models.goom_layer import GoomSSMCfg as JCfg
    from repro.models.goom_layer import goom_ssm_apply, goom_ssm_init
    from repro_torch.configs import GoomSSMCfg
    from repro_torch.models import GoomSSM

    jcfg = JCfg(d_model=8, head_dim=4, chunk=4, scan_variant="generic")
    jp, _ = unzip(goom_ssm_init(KeyGen(jax.random.PRNGKey(3)), jcfg))
    x = np.random.default_rng(4).normal(size=(2, 8, 8)).astype(np.float32)
    with jax_engine.use_backend("reference"):
        want, _ = jax.jit(lambda p, v: goom_ssm_apply(p, v, jcfg, compute_dtype=jnp.float32))(
            jp, jnp.asarray(x))
    outs = {}
    for variant in ("shared_a", "generic"):
        layer = GoomSSM(GoomSSMCfg(d_model=8, head_dim=4, chunk=4, scan_variant=variant),
                        device="cpu")
        layer.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                               _layer_state(jax.tree.map(np.asarray, jp)).items()})
        with torch.no_grad():
            outs[variant], _ = layer(torch.tensor(x), compute_dtype=torch.float32)
    np.testing.assert_allclose(outs["generic"].numpy(), outs["shared_a"].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(outs["generic"].numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="scan_variant"):
        GoomSSM(GoomSSMCfg(d_model=8, head_dim=4, scan_variant="diagonal"), device="cpu")


def test_serving_on_cpu_routes_every_lmme_through_the_engine(pair):
    _, _, model = pair
    engine.reset_calls()
    before = (lmme_cuda.launches, matrix_scan_cuda.launches)
    Engine(model, max_slots=1, page_len=32, chunk=4).run(
        [Request(uid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=3)])
    n_layers = model.cfg.n_layers
    # one 4-token chunk, then single tokens: tail token 5 and one fused
    # decode dispatch of the default horizon, 8 steps (the slot freezes on
    # the device after tokens 2 and 3; the batch decodes the whole horizon)
    if model.cfg.layer_list[0].goom.scan_variant == "shared_a":
        # the chunk: B·u, fold, 2 doublings, 1 power; a token: B·u, fold
        assert engine.calls["lmme"] == n_layers * (5 + 2 * (1 + 8))
        assert engine.calls["matrix_scan"] == 0
    else:  # B·u and one matrix scan per layer per call
        assert engine.calls["lmme"] == n_layers * (2 + 8)
        assert engine.calls["matrix_scan"] == engine.calls["matrix_scan_carry"] == n_layers * 10
    # the CPU never launches a kernel
    assert (lmme_cuda.launches, matrix_scan_cuda.launches) == before


def test_port_imports_no_jax_and_nothing_of_repro():
    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "flax"), (
                    f"{f.relative_to(root)} imports {name}")
