"""Serve steps as plain functions of tensors.

Counterpart of ``repro/serve/steps.py``.  ``make_prefill_step`` and
``make_decode_step`` wrap the model's serving API in a backend scope;
``generate`` is the lockstep whole-batch greedy driver for tests and
examples, and the one serve path for models with a frontend (the Engine
takes token prompts only): its prefill takes the frontend inputs, and its
decode step is one CUDA graph, captured once a call and replayed a token,
on the card (``graphs.StepGraphs``; eager on CPU tensors).  ``make_decode_multi`` is the engine's fused decode: ``horizon``
greedy steps over every slot with on-device termination, the body of JAX's
``lax.scan`` (``steps.py:138-148``) written as a Python loop.  Where JAX
returns new arrays (and donates the old), the fused decode updates its
tensors in place, so one CUDA graph of it replays over fixed addresses.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional

import torch

from ..core import engine
from ..models.model import Caches, DecoderLM
from .graphs import StepGraphs
from .state_cache import assign_caches, mask_frozen_pages, merge_frozen


Blocks = Optional[Mapping[str, Mapping[str, int]]]


def _engine_scope(backend: str, mesh, seq_shards, blocks: Blocks = None):
    """The engine scope of a serve step (JAX ``steps.py:37-47``): the backend,
    the mesh of sequence-sharded scans when there is one, and per-op launch
    knobs.  Without a mesh an explicit ``seq_shards`` count raises in the
    engine instead of serving locally."""
    stack = contextlib.ExitStack()
    if mesh is None:
        stack.enter_context(engine.use_backend(backend, seq_shards=seq_shards))
    else:
        stack.enter_context(engine.use_mesh(mesh, seq_shards=seq_shards, backend=backend))
    if blocks:
        stack.enter_context(engine.use_blocks(**dict(blocks)))
    return stack


def make_prefill_step(model: DecoderLM, *, backend: str = "auto", mesh=None,
                      seq_shards="auto", fresh_caches: bool = False,
                      blocks: Blocks = None) -> Callable:
    """``prefill_step(tokens (B, S), caches, positions=None, **kw) -> (last
    logits (B, 1, vocab), caches)`` in ``_engine_scope(backend, mesh,
    seq_shards, blocks)``: under a mesh the prompt's scans are time-sharded
    over its seq group; ``blocks`` (e.g. ``{"matrix_scan": {"block_t":
    8}}``) pins launch knobs.  ``kw`` are the frontend inputs
    (``prefix_embeds``, ``mrope_positions``).  ``fresh_caches`` promises
    that every call feeds empty caches: the single-shot prefill then scales
    with the prompt, not the caches' length (a chunked prefill leaves it
    False).  Under active sharding rules (``sharding.use_rules``) a laid-out
    model gathers its parameters a period at a time and, where the rules
    split heads, channels or the vocabulary, each rank runs its block (its
    caches, from ``model.init_caches`` under the same rules, hold its KV
    heads, or its block of the rows where the rules put ``cache_seq`` on
    the axis) and the logits come back whole; ``make_decode_step`` runs
    under the same rules and caches."""

    @torch.no_grad()
    def prefill_step(tokens, caches, **kw):
        with _engine_scope(backend, mesh, seq_shards, blocks):
            return model.prefill(tokens, caches, fresh_caches=fresh_caches, **kw)

    return prefill_step


def make_decode_step(model: DecoderLM, *, backend: str = "auto", mesh=None,
                     seq_shards="auto", blocks: Blocks = None) -> Callable:
    """``decode_step(token (B, 1), caches, index (B,)) -> (next (B, 1),
    caches)``: one greedy step, ``index`` the incoming tokens' positions."""

    @torch.no_grad()
    def decode_step(token, caches, index):
        with _engine_scope(backend, mesh, seq_shards, blocks):
            logits, caches = model.decode_step(token, caches, index)
        return torch.argmax(logits[:, -1, :], dim=-1)[:, None], caches

    return decode_step


def make_decode_multi(model: DecoderLM, horizon: int) -> Callable:
    """Fused multi-step slot decode: ``horizon`` greedy steps.

    ``decode_multi(tokens (S,), caches, pos (S,), term, block (horizon,
    S))`` advances every slot in place and writes each step's tokens into
    ``block``.  ``term`` is ``state_cache.init_term_state``'s dict.  Each
    step masks frozen slots' page tables (their KV writes go to the trash
    page), runs the batched ``model.decode_step`` and merges: frozen rows
    keep their token, position and cache bits, so a slot that hits EOS or
    its budget mid-horizon freezes on the device.  Frozen rows of ``block``
    repeat the slot's last token; the host trims at the first EOS or the
    budget edge as it does at horizon 1, which keeps outputs bit-identical
    across horizons.  The caller picks the backend scope."""
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")

    @torch.no_grad()
    def decode_multi(tokens: torch.Tensor, caches: Caches, pos: torch.Tensor,
                     term: Dict[str, torch.Tensor], block: torch.Tensor) -> None:
        active, remaining = term["active"], term["remaining"]
        for i in range(horizon):
            masked = mask_frozen_pages(caches, active)
            logits, stepped = model.decode_step(tokens[:, None], masked, pos)
            assign_caches(caches, merge_frozen(stepped, caches, active))
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            tok = torch.where(active, nxt, tokens)
            left = torch.where(active, remaining - 1, remaining)
            pos.copy_(torch.where(active, pos + 1, pos))
            tokens.copy_(tok)
            remaining.copy_(left)
            active.copy_(active & (left > 0) & (tok != term["eos"]))
            block[i].copy_(tok)

    return decode_multi


def make_decode_in_place(model: DecoderLM) -> Callable:
    """``step(token (B, 1), caches, index (B,))``: one greedy decode step
    that writes the next token, the advanced caches and index + 1 back into
    its arguments, so that one CUDA graph of it replays a token at a time.
    M-RoPE's streams are the index, broadcast inside the step."""

    @torch.no_grad()
    def step(token, caches, index):
        logits, stepped = model.decode_step(token, caches, index)
        assign_caches(caches, stepped)
        token.copy_(torch.argmax(logits[:, -1, :], dim=-1)[:, None])
        index.add_(1)

    return step


@torch.no_grad()
def generate(model: DecoderLM, prompt: torch.Tensor, n_tokens: int, max_len: int,
             backend: str = "auto", mesh=None, seq_shards="auto", blocks: Blocks = None,
             **kw) -> torch.Tensor:
    """Greedy lockstep-batch generation: prompt (B, P) -> (B, n_tokens).

    ``kw`` go to the single-shot prefill (``prefix_embeds`` (B, n_prefix,
    d), ``mrope_positions`` (3, B, P)), which runs on fresh caches
    (``fresh_caches=True``), as in JAX's ``generate``; decode
    positions continue at P, P + 1, ... on every M-RoPE stream.  On the card
    the decode step is captured once as a CUDA graph over static token,
    index and cache tensors and replayed for each token; a failed capture
    raises.  Under a ``mesh`` the prefill's scans are time-sharded and the
    decode step (T = 1, local) is still one graph.  For request-level
    batching use ``serve.Engine``."""
    b, p = prompt.shape
    prefill = make_prefill_step(model, backend=backend, mesh=mesh, seq_shards=seq_shards,
                                fresh_caches=True, blocks=blocks)
    logits, caches = prefill(prompt, model.init_caches(b, max_len), **kw)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    out = [tok.clone()]
    index = torch.full((b,), p, dtype=torch.long, device=prompt.device)
    graphs = StepGraphs(backend, mesh=mesh, seq_shards=seq_shards, blocks=blocks)
    step = make_decode_in_place(model)
    for _ in range(n_tokens - 1):
        graphs.run("generate_decode", step, tok, caches, index)
        out.append(tok.clone())
    return torch.cat(out, dim=1)
