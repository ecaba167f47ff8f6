"""Feed-forward layers: the gated SiLU MLP and the top-k MoE.

Counterpart of ``repro/models/mlp.py``.  The MoE packs each row's tokens
into per-expert buffers of capacity C and runs every expert over its buffer
as one batched product (E, C, d) × (E, d, f), then adds each token's expert
outputs weighted by its renormalised router gates.  Two routings, chosen by
the caller as in the JAX package (``blocks.py``):

  * ``dropless=False`` (no cache: a full forward): C = ceil(k·S·1.25/E),
    slots assigned in token order by a per-row cumsum, overflow dropped;
  * ``dropless=True`` (serving): C = S, so every token keeps its top-k
    experts and its output does not depend on how the prompt was chunked.

The router runs in f32 (its weight is f32 whatever the model's dtype); ties
in the top-k break to the lower expert index, as ``jax.lax.top_k`` does.
The capacity routing also returns the training aux losses from the f32
router logits: the Switch load balance and the router z-loss.  The dropless
routing (serving) returns none: nothing reads them there, and in eager
PyTorch they would cost some twenty launches a layer a decode step (JAX
computes them in both and XLA drops the unused).  Plain tensor ops: the JAX
package leaves the MoE to XLA, no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MlpCfg, MoeCfg
from .common import Dense, dense_apply, normal_param


class Mlp(nn.Module):
    """down(silu(gate(x)) * up(x)); weights ``up.w``, ``gate.w``, ``down.w``."""

    def __init__(self, cfg: MlpCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.up = Dense(cfg.d_model, (cfg.d_ff,), **kw)
        self.gate = Dense(cfg.d_model, (cfg.d_ff,), **kw)
        self.down = Dense(cfg.d_ff, (cfg.d_model,), **kw)

    def forward(self, x: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        h = self.up(x, compute_dtype=compute_dtype)
        h = F.silu(self.gate(x, compute_dtype=compute_dtype)) * h
        return self.down(h, compute_dtype=compute_dtype)


def top_k_lowest_index(probs: torch.Tensor, k: int):
    """The k largest entries of the last dim and their indices, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Moe(nn.Module):
    """Top-k MoE; weights ``router.w`` (d, E) f32, ``gate``/``up`` (E, d, f)
    and ``down`` (E, f, d), the JAX param tree's names and layouts."""

    def __init__(self, cfg: MoeCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.router = Dense(d, (e,), device=device, dtype=torch.float32,
                            generator=generator)
        self.gate = normal_param((e, d, f), d ** -0.5, **kw)
        self.up = normal_param((e, d, f), d ** -0.5, **kw)
        self.down = normal_param((e, f, d), f ** -0.5, **kw)

    def forward(self, x: torch.Tensor, *, compute_dtype: torch.dtype = torch.bfloat16,
                dropless: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (output, aux).  With capacity routing aux =
        {load_balance_loss, router_z_loss}: E·Σ_e mean(probs_e)·mean(top-k
        hits_e) and router_z_loss · mean(logsumexp(logits)²), as
        ``repro/models/mlp.py`` computes them; dropless, aux is empty."""
        cfg, cd = self.cfg, compute_dtype
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        cap = s if dropless else max(1, int(math.ceil(k * s * cfg.capacity_factor / e)))

        logits = dense_apply(self.router.w, x.float())             # (B, S, E) f32
        probs = torch.softmax(logits, dim=-1)
        gate_vals, expert_idx = top_k_lowest_index(probs, k)
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

        aux: Dict[str, torch.Tensor] = {}
        if not dropless:
            hits = F.one_hot(expert_idx, e).float().sum(dim=2)     # (B, S, E)
            aux = {"load_balance_loss": e * (probs.mean(dim=(0, 1))
                                             * hits.mean(dim=(0, 1))).sum(),
                   "router_z_loss": cfg.router_z_loss
                   * torch.logsumexp(logits, dim=-1).square().mean()}

        # per-row dispatch: the j-th entry (token-major) routed to expert x
        # takes slot (entries of x before it); slot >= cap is dropped into
        # the trash row e*cap
        flat_expert = expert_idx.reshape(b, s * k)
        flat_gate = gate_vals.reshape(b, s * k)
        flat_token = torch.arange(s, device=x.device).repeat_interleave(k)
        onehot = F.one_hot(flat_expert, e)
        slot = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1
        keep = slot < cap
        dst = torch.where(keep, flat_expert * cap + slot, e * cap)
        buf = torch.zeros(b, e * cap + 1, d, dtype=cd, device=x.device)
        buf.scatter_(1, dst[..., None].expand(-1, -1, d), x.to(cd)[:, flat_token])
        buf = buf[:, :-1].reshape(b, e, cap, d)

        g = torch.einsum("becd,edf->becf", buf, self.gate.to(cd))
        u = torch.einsum("becd,edf->becf", buf, self.up.to(cd))
        out_buf = torch.einsum("becf,efd->becd", F.silu(g) * u, self.down.to(cd))
        out_buf = out_buf.reshape(b, e * cap, d)

        gathered = out_buf.gather(1, dst.clamp(max=e * cap - 1)[..., None].expand(-1, -1, d))
        gathered = torch.where(keep[..., None], gathered.float(), 0.0)
        out = (gathered * flat_gate[..., None]).reshape(b, s, k, d).sum(dim=2)
        return out.to(cd), aux
