"""The port's ``Engine`` serving the attention families against the JAX
package's paged ``Engine``, on the CPU.

olmo-1b (every layer paged, non-parametric LNs, tied embeddings) and
gemma3-1b (paged global layers beside dense rolling buffers of 16 rows for
the local ones, two groups) at their smoke sizes, f32 compute, weights
perturbed by N(0, 0.05²):

  * five requests through two slots at horizons 1 and 8 (equal tokens) and
    chunks 1, 7 and 64 against JAX's Engine: tokens equal up to a near tie,
    decode and prefix counters equal; windowed layers keep dense rings
    under the paged pool;
  * prefix hits bit-identical to misses: global layers resume from pool
    pages, the rings from the carry checkpoint;
  * with f32 KV caches, the Engine's tokens for olmo, gemma3, mixtral and
    phi3.5-moe equal the argmax of the no-cache forward at every position.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import DecoderLM, Engine, Request, get_config
from torch_parity import (
    ENGINE_BUDGETS,
    ENGINE_LENS,
    check_engine_against_jax,
    check_prefix_hits_bit_identical,
    f32_kv,
    serve_pair,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["olmo-1b", "gemma3-1b"])
def served(request):
    return serve_pair(request.param, perturb=0.05)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_engine_matches_jax_engine(served, chunk):
    jmodel, jparams, model = served
    caches = model.init_slot_caches(2, 96, page_size=chunk)
    paged = ["pages" in c for c in caches]
    windowed = [blk.attn.window is not None for blk in model.cfg.layer_list]
    assert paged == [not w for w in windowed]   # windowed layers keep dense rings
    check_engine_against_jax(jmodel, jparams, model, chunk)


@pytest.mark.parametrize("chunk", [7, 64])
def test_prefix_hits_bit_identical(served, chunk):
    """Global layers resume from pool pages, windowed rings from the carry
    checkpoint."""
    _, _, model = served
    check_prefix_hits_bit_identical(model, chunk)


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-1b", "mixtral-8x7b", "phi3.5-moe"])
def test_f32_kv_engine_tokens_equal_uncached_forward(arch):
    """With f32 KV caches (``f32_kv``) the Engine's paged global layers and
    dense rings hold the cache-free forward's function:
    every generated token is the argmax of one no-cache forward over prompt
    + tokens so far (chunk 7 over prompts of up to 70 tokens wraps the smoke
    windows of 16 and 32).  An MoE's capacity factor E/k makes the no-cache
    forward route every token to its experts, the serving routing."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=torch.float32)
    model = DecoderLM(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    for layer in model.layers:
        if layer.blk.channel == "moe":
            moe = layer.channel
            moe.cfg = dataclasses.replace(moe.cfg, capacity_factor=moe.cfg.n_experts
                                          / moe.cfg.top_k)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=p).tolist() for p in ENGINE_LENS]
    with f32_kv(model):
        eng = Engine(model, max_slots=2, page_len=96, chunk=7)
        assert all(c["k"].dtype == torch.float32 for c in eng._caches if "k" in c)
        out = eng.run([Request(uid=i, prompt=p, max_new_tokens=b)
                       for i, (p, b) in enumerate(zip(prompts, ENGINE_BUDGETS))])
    with torch.no_grad():
        for i, p in enumerate(prompts):
            seq = torch.tensor([p + out[i][:-1]])
            want = model(seq)[0, len(p) - 1:].argmax(-1).tolist()
            assert out[i] == want, i
