"""Chunked prefill: prompt ingestion in fixed-size chunks with a threaded carry.

A prompt of length P runs as ``P // chunk`` full chunks through
``model.prefill`` (each GOOM layer one parallel scan over the chunk, its
entering state folded in from the cache, each attention layer writing its
KV at the row's index) and the ``P % chunk`` remainder token by token
through ``model.decode_step``.  Each call gets the tokens' absolute
positions.  Threading the caches through the calls is the recurrence's
exact chunking; the chunk boundaries set the reassociation, so this
schedule is the JAX package's (``repro/serve/prefill.py``) to the token.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..models.model import Caches, DecoderLM


class ChunkedPrefill:
    """Ingest prompts in chunks of ``chunk`` tokens."""

    def __init__(self, model: DecoderLM, chunk: int):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.chunk = chunk
        self.n_chunk_calls = 0
        self.n_tail_calls = 0

    @torch.no_grad()
    def __call__(self, prompt: Sequence[int], caches: Caches
                 ) -> Tuple[torch.Tensor, Caches]:
        """Ingest ``prompt`` (1-D tokens) into a fresh batch-1 cache list, its
        first token at position 0.

        Returns ``(last_logits (1, vocab), caches)``."""
        dev = self.model.device
        prompt = torch.as_tensor(prompt, dtype=torch.long).reshape(-1).to(dev)
        p = int(prompt.shape[0])
        if p == 0:
            raise ValueError("empty prompt: need at least one token")
        c = self.chunk
        n_full = p // c
        logits = None
        for j in range(n_full):
            logits, caches = self.model.prefill(
                prompt[None, j * c:(j + 1) * c], caches,
                positions=torch.arange(j * c, (j + 1) * c, device=dev)[None])
            self.n_chunk_calls += 1
        for t in range(n_full * c, p):
            logits, caches = self.model.decode_step(
                prompt[None, t:t + 1], caches, torch.full((1,), t, device=dev))
            self.n_tail_calls += 1
        return logits[:, -1, :], caches
