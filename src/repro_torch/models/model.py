"""DecoderLM: embed → blocks → final norm → lm_head.

Counterpart of ``repro/models/model.py`` for the port's models (goom-rnn,
Jamba).  The residual stream runs in ``cfg.compute_dtype`` (bf16 by
default); the parameters are ``cfg.param_dtype`` (f32 by default).  The
lm_head product stays a plain ``torch.matmul``, as the JAX package leaves it
to XLA outside any kernel.

Serving API (what ``serve.Engine`` drives): ``init_caches``, ``prefill`` and
``decode_step``.  Caches are a list with one dict per layer: the layer's
GOOM carry, Mamba state, or attention KV rows with a per-row index.
``positions`` are absolute, per row; attention layers rotate by them and
the recurrent layers ignore them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import LMConfig
from ..kernels.dispatch import resolve_device
from .blocks import Block, block_init_cache
from .common import Dense
from .norms import make_norm

Caches = List[Dict[str, torch.Tensor]]


class DecoderLM(nn.Module):
    """The decoder, built on ``device`` (default ``cuda``) with weights drawn
    from ``generator`` (default: seed 0 on that device)."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        kw = dict(device=dev, dtype=cfg.param_dtype)
        self.embed = nn.Parameter(0.02 * torch.randn(
            (cfg.vocab, cfg.d_model), generator=generator, **kw))
        self.layers = nn.ModuleList(
            [Block(blk, generator=generator, **kw) for blk in cfg.layer_list])
        self.final_norm = make_norm(cfg.final_norm, cfg.d_model, **kw)
        self.lm_head = Dense(cfg.d_model, (cfg.vocab,), generator=generator, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def hidden_states(self, tokens: torch.Tensor,
                      caches: Optional[Caches] = None,
                      positions: Optional[torch.Tensor] = None):
        """tokens (B, S) at ``positions`` (B, S; default 0..S-1) → (final-normed
        hidden (B, S, d), new caches or None)."""
        cd = self.cfg.compute_dtype
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        x = self.embed[tokens].to(cd)
        new_caches = []
        for i, layer in enumerate(self.layers):
            x, c = layer(x, positions=positions,
                         cache=None if caches is None else caches[i],
                         compute_dtype=cd)
            new_caches.append(c)
        return self.final_norm(x), (new_caches if caches is not None else None)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.lm_head.w.to(self.cfg.compute_dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full forward to logits (B, S, vocab)."""
        h, _ = self.hidden_states(tokens)
        return self.logits(h)

    # -- serving -------------------------------------------------------------
    def init_caches(self, batch: int, max_len: Optional[int] = None) -> Caches:
        """Each layer's decode state, every leaf leading with ``batch``;
        attention layers hold ``max_len`` positions of KV per row (required
        when the model has one)."""
        return [block_init_cache(blk, batch, device=self.device, max_len=max_len)
                for blk in self.cfg.layer_list]

    def prefill(self, tokens: torch.Tensor, caches: Caches,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Caches]:
        """Ingest a prompt chunk (B, S) from the caches' state at absolute
        ``positions`` (B, S; default 0..S-1: a fresh cache); returns the last
        position's logits (B, 1, vocab) and the advanced caches."""
        h, caches = self.hidden_states(tokens, caches, positions)
        return self.logits(h[:, -1:]), caches

    def decode_step(self, token: torch.Tensor, caches: Caches,
                    index: torch.Tensor) -> Tuple[torch.Tensor, Caches]:
        """One decode step: token (B, 1) at absolute position ``index`` (B,)
        → (logits (B, 1, vocab), caches)."""
        positions = torch.as_tensor(index, device=token.device).reshape(-1, 1)
        h, caches = self.hidden_states(token, caches, positions)
        return self.logits(h), caches
