"""Chunked prefill: prompt ingestion in fixed-size chunks with a threaded carry.

A prompt of length P runs as ``P // chunk`` full chunks through
``model.prefill`` (each GOOM layer one parallel scan over the chunk, its
entering state folded in from the cache, each attention layer writing its
KV at the row's index) and the ``P % chunk`` remainder token by token
through ``model.decode_step``.  Each call gets the tokens' absolute
positions.  Threading the caches through the calls is the recurrence's
exact chunking; the chunk boundaries set the reassociation, so this
schedule is the JAX package's (``repro/serve/prefill.py``) to the token.

Two fixed shapes, ``(1, chunk)`` and ``(1, 1)``, serve any prompt: on the
card each is a CUDA graph (``graphs.StepGraphs``) over the batch-1 cache it
is given, its tokens and positions uploaded into a static buffer.  The
caches are updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.model import Caches, DecoderLM
from .graphs import StepGraphs
from .state_cache import assign_caches


def upload(dst: torch.Tensor, values) -> torch.Tensor:
    """Copy host ``values`` into the device tensor ``dst`` without a host
    sync: through pinned memory and a non-blocking copy on the card."""
    src = torch.as_tensor(np.asarray(values), dtype=dst.dtype).reshape(dst.shape)
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)
    return dst


class ChunkedPrefill:
    """Ingest prompts through two persistent steps, the chunk and the tail.

    ``graphs`` (default: a new ``StepGraphs(backend, mesh=mesh,
    seq_shards=seq_shards, blocks=blocks)``) holds their CUDA graphs and
    engine scope; an Engine passes its own so that all its graphs share one
    memory pool.  Under a mesh the chunk step (T >= P) runs eagerly, its
    scans time-sharded, and the tail step is a graph."""

    def __init__(self, model: DecoderLM, chunk: int, *, backend: str = "auto",
                 mesh=None, seq_shards="auto", blocks=None,
                 graphs: Optional[StepGraphs] = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.chunk = chunk
        self.graphs = graphs if graphs is not None else StepGraphs(
            backend, mesh=mesh, seq_shards=seq_shards, blocks=blocks)
        # dispatch counters: a prefix hit must run only its suffix's calls
        self.n_chunk_calls = 0
        self.n_tail_calls = 0
        dev = model.device
        # static step inputs (row 0 tokens, row 1 positions) and outputs
        self._chunk_in = torch.zeros(2, chunk, dtype=torch.long, device=dev)
        self._tail_in = torch.zeros(2, 1, dtype=torch.long, device=dev)
        self._logits = torch.zeros(1, 1, model.cfg.vocab, device=dev,
                                   dtype=model.cfg.compute_dtype)

    def _step(self, inputs: torch.Tensor, caches: Caches, logits: torch.Tensor) -> None:
        if inputs.shape[1] > 1:
            out, new = self.model.prefill(inputs[:1], caches, positions=inputs[1:])
        else:
            out, new = self.model.decode_step(inputs[:1], caches, inputs[1])
        assign_caches(caches, new)
        logits.copy_(out)

    @torch.no_grad()
    def __call__(self, prompt: Sequence[int], caches: Caches, *, start: int = 0,
                 capture_every: Optional[int] = None,
                 capture: Optional[Callable[[int, Caches], Any]] = None
                 ) -> Tuple[torch.Tensor, Caches, int]:
        """Ingest ``prompt`` (1-D tokens) into the batch-1 ``caches``, in place.

        ``start`` is the absolute position of its first token (nonzero when
        resuming past a cached prefix that ``state_cache.gather_prefix``
        restored).  ``capture(pos, caches)`` fires after each full chunk
        that ends on a multiple of ``capture_every``; it must copy what it
        keeps (the next call overwrites the caches).  Returns ``(last logits
        (1, vocab), caches, next_pos)``: the final token's logits and the
        position the first decode step runs at."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        p = int(prompt.shape[0])
        if p == 0:
            raise ValueError("empty prompt: need at least one token")
        c = self.chunk
        n_full = p // c
        pos = start
        for j in range(n_full):
            upload(self._chunk_in, [prompt[j * c:(j + 1) * c], np.arange(pos, pos + c)])
            self.graphs.run("prefill_chunk", self._step, self._chunk_in, caches,
                            self._logits)
            self.n_chunk_calls += 1
            pos += c
            if capture is not None and capture_every and pos % capture_every == 0:
                capture(pos, caches)
        for t in range(n_full * c, p):
            upload(self._tail_in, [[prompt[t]], [pos]])
            self.graphs.run("prefill_tail", self._step, self._tail_in, caches,
                            self._logits)
            self.n_tail_calls += 1
            pos += 1
        return self._logits[:, -1, :].clone(), caches, pos
