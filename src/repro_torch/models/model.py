"""DecoderLM: embed → blocks → final norm → lm_head.

Counterpart of ``repro/models/model.py`` for the port's models (goom-rnn,
Jamba).  The residual stream runs in ``cfg.compute_dtype`` (bf16 by
default); the parameters are ``cfg.param_dtype`` (f32 by default).  The
lm_head product stays a plain ``torch.matmul``, as the JAX package leaves it
to XLA outside any kernel.

Training: ``loss(tokens, labels)``, the JAX package's next-token CE with
the MoE's aux losses added (``repro/models/model.py::DecoderLM.loss``).

Serving API (what ``serve.Engine`` drives): ``init_caches``, ``prefill`` and
``decode_step``.  Caches are a list with one dict per layer: the layer's
GOOM carry, Mamba state, or attention KV rows with a per-row index.
``positions`` are absolute, per row; attention layers rotate by them and
the recurrent layers ignore them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
        hidden (B, S, d), new caches or None, aux losses summed over layers)."""
        cd = self.cfg.compute_dtype
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        # F.embedding, not indexing: its backward gives the same bits every
        # run (indexing's accumulating backward does not on the CPU)
        x = F.embedding(tokens, self.embed).to(cd)
        new_caches = []
        aux_tot: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.layers):
            x, c, aux = layer(x, positions=positions,
                              cache=None if caches is None else caches[i],
                              compute_dtype=cd)
            new_caches.append(c)
            for k, v in aux.items():
                aux_tot[k] = aux_tot.get(k, 0.0) + v
        return (self.final_norm(x), (new_caches if caches is not None else None),
                aux_tot)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.lm_head.w.to(self.cfg.compute_dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Full forward to logits (B, S, vocab)."""
        h, _, _ = self.hidden_states(tokens)
        return self.logits(h)

    # -- training ------------------------------------------------------------
    def loss(self, tokens: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE of tokens (B, S) against labels (B, S; -1 masked),
        plus 0.01·load_balance_loss + router_z_loss when the model has an
        MoE.  Returns (loss, metrics: ce_loss, tokens, loss and the aux terms).

        The CE runs over pieces of ``min(logit_chunk, S)`` tokens, each
        recomputed in the backward (``jax.checkpoint`` in JAX), so no more
        than one piece's f32 logits are alive at a time; logits are the
        compute-dtype product cast to f32, as in JAX."""
        h, _, aux = self.hidden_states(tokens)
        w = self.lm_head.w.to(self.cfg.compute_dtype)
        s = h.shape[1]
        ck = min(self.cfg.logit_chunk, s)
        if s % ck:
            raise ValueError(f"sequence length {s} is not a multiple of "
                             f"logit_chunk {ck}")
        tot = cnt = 0.0
        for i in range(0, s, ck):
            nll, n = checkpoint(_piece_nll, h[:, i:i + ck], labels[:, i:i + ck], w,
                                use_reentrant=False)
            tot, cnt = tot + nll, cnt + n
        ce = tot / cnt.clamp_min(1.0)
        loss = ce
        metrics = {"ce_loss": ce, "tokens": cnt}
        if "load_balance_loss" in aux:
            loss = loss + 0.01 * aux["load_balance_loss"]
            metrics["load_balance_loss"] = aux["load_balance_loss"]
        if "router_z_loss" in aux:
            loss = loss + aux["router_z_loss"]
            metrics["router_z_loss"] = aux["router_z_loss"]
        metrics["loss"] = loss
        return loss, metrics

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
        h, caches, _ = self.hidden_states(tokens, caches, positions)
        return self.logits(h[:, -1:]), caches

    def decode_step(self, token: torch.Tensor, caches: Caches,
                    index: torch.Tensor) -> Tuple[torch.Tensor, Caches]:
        """One decode step: token (B, 1) at absolute position ``index`` (B,)
        → (logits (B, 1, vocab), caches)."""
        positions = torch.as_tensor(index, device=token.device).reshape(-1, 1)
        h, caches, _ = self.hidden_states(token, caches, positions)
        return self.logits(h), caches


def _piece_nll(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor):
    """(summed NLL, count) of one piece: hidden (B, k, d) in the compute
    dtype, labels (B, k) with -1 masked, head weight (d, V)."""
    logits = (h @ w).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()
