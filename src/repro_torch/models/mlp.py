"""Feed-forward layers: gated and plain MLPs (SiLU, tanh-GELU, ReLU²) and
the top-k MoE.

Counterpart of ``repro/models/mlp.py``.  The MoE packs each row's tokens
into per-expert buffers of capacity C and runs every expert over its buffer
as one batched product (E, C, d) × (E, d, f), then adds each token's expert
outputs weighted by its renormalised router gates.  Two routings, chosen by
the caller as in the JAX package (``blocks.py``):

  * ``dropless=False`` (no cache: a full forward): C = ceil(k·S·1.25/E),
    slots assigned in token order by a per-row cumsum, overflow dropped;
  * ``dropless=True`` (serving): C = S, so every token keeps its top-k
    experts and its output does not depend on how the prompt was chunked.

Each expert is gated by its config's activation.  The router runs in f32
(its weight is f32 whatever the model's dtype); ties in the top-k break to the lower expert index, as ``jax.lax.top_k`` does.
The capacity routing also returns the training aux losses from the f32
router logits: the Switch load balance and the router z-loss.  The dropless
routing (serving) returns none: nothing reads them there, and in eager
PyTorch they would cost some twenty launches a layer a decode step (JAX
computes them in both and XLA drops the unused).  Plain tensor ops: the JAX
package leaves the MoE to XLA, no Pallas kernel.

Under rules that split ``act_mlp`` (``sharding/tensor_parallel.py``) a rank
runs its block of each expert's channels (``Moe.split_dims``, JAX's
``expert_mlp`` on "model"): ``gate``/``up`` column-split, ``down``
row-split.  The router, the top-k, the aux losses and the dispatch run
whole and alike on every rank; the dispatch's copy of x and the gate
values enter the split (the router's x does not, or its gradient would be
summed M times), and the combined (B, S, d) output, linear in the experts'
partial sums, is all-reduced (not the (B, E·C, d) expert buffers).  The
expert dim stays whole on every rank of "data".
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import MlpCfg, MoeCfg
from ..sharding.rules import constrain
from ..sharding.tensor_parallel import enter, leave, split_of
from .common import Dense, dense_apply, normal_param


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """``silu``, ``gelu`` (the tanh approximation, ``jax.nn.gelu``'s
    default) or ``relu2`` (squared ReLU)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.relu(x).square()
    raise ValueError(f"unknown activation {name!r}; one of 'silu', 'gelu', 'relu2'")


class Mlp(nn.Module):
    """down(act(gate(x)) * up(x)), or down(act(up(x))) when not gated;
    weights ``up.w``, ``gate.w`` (gated only), ``down.w``.  Under rules
    that split ``act_mlp`` a rank runs its block of the channels (up and
    gate column-split, down row-split and all-reduced;
    ``sharding/tensor_parallel.py``)."""

    def __init__(self, cfg: MlpCfg, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = activation(cfg.activation)
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.up = Dense(cfg.d_model, (cfg.d_ff,), **kw)
        self.gate = Dense(cfg.d_model, (cfg.d_ff,), **kw) if cfg.gated else None
        self.down = Dense(cfg.d_ff, (cfg.d_model,), in_axis="mlp", out_axes=("embed",), **kw)
        self.d_ff = cfg.d_ff

    def split_dims(self, rules) -> Tuple[Optional[str], Dict[str, Optional[int]]]:
        """The axis the channels split on (None: whole) and the dim of each
        weight a rank reads a block of (``Attention.split_dims``)."""
        axis = rules.split_axis("act_mlp", self.d_ff)
        if axis is None:
            return None, {}
        return axis, {"up.w": 1, "down.w": 0, **({"gate.w": 1} if self.gate else {})}

    def forward(self, x: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        sp = split_of("act_mlp", self.d_ff)
        x = enter(x, sp)
        col = (sp, 1, self.d_ff)
        h = self.up(x, compute_dtype=compute_dtype, split=col)
        if self.gate is not None:
            h = self.act(self.gate(x, compute_dtype=compute_dtype, split=col)) * h
        else:
            h = self.act(h)
        h = constrain(h, "batch", "act_seq", "act_mlp")
        return leave(self.down(h, compute_dtype=compute_dtype, split=(sp, 0, self.d_ff)), sp)


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
        self.act = activation(cfg.activation)
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.router = Dense(d, (e,), device=device, dtype=torch.float32,
                            generator=generator, out_axes=(None,))
        ax = ("expert", "embed", "expert_mlp")
        self.gate = normal_param((e, d, f), d ** -0.5, axes=ax, **kw)
        self.up = normal_param((e, d, f), d ** -0.5, axes=ax, **kw)
        self.down = normal_param((e, f, d), f ** -0.5, axes=("expert", "expert_mlp", "embed"),
                                 **kw)

    def split_dims(self, rules) -> Tuple[Optional[str], Dict[str, Optional[int]]]:
        """The axis the experts' channels split on (None: whole) and the dim
        of each weight a rank reads a block of (``Attention.split_dims``)."""
        axis = rules.split_axis("act_mlp", self.cfg.d_ff)
        return (None, {}) if axis is None else (axis, {"gate": 2, "up": 2, "down": 1})

    def forward(self, x: torch.Tensor, *, compute_dtype: torch.dtype = torch.bfloat16,
                dropless: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (output, aux).  With capacity routing aux =
        {load_balance_loss, router_z_loss}: E·Σ_e mean(probs_e)·mean(top-k
        hits_e) and router_z_loss · mean(logsumexp(logits)²), as
        ``repro/models/mlp.py`` computes them; dropless, aux is empty.
        Under rules that split ``act_mlp`` a rank runs its block of the
        experts' channels (module docstring)."""
        cfg, cd = self.cfg, compute_dtype
        b, s, d = x.shape
        e, k, f = cfg.n_experts, cfg.top_k, cfg.d_ff
        sp = split_of("act_mlp", f)
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
        flat_gate = enter(gate_vals.reshape(b, s * k), sp)
        flat_token = torch.arange(s, device=x.device).repeat_interleave(k)
        onehot = F.one_hot(flat_expert, e)
        slot = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1
        keep = slot < cap
        dst = torch.where(keep, flat_expert * cap + slot, e * cap)
        buf = torch.zeros(b, e * cap + 1, d, dtype=cd, device=x.device)
        buf.scatter_(1, dst[..., None].expand(-1, -1, d), enter(x.to(cd), sp)[:, flat_token])
        buf = constrain(buf[:, :-1].reshape(b, e, cap, d), "batch", "act_expert", None, None)

        w_gate, w_up, w_down = self.gate, self.up, self.down
        if sp is not None:
            w_gate, w_up, w_down = (sp.take(w_gate, 2, f), sp.take(w_up, 2, f),
                                    sp.take(w_down, 1, f))
        g = torch.einsum("becd,edf->becf", buf, w_gate.to(cd))
        u = torch.einsum("becd,edf->becf", buf, w_up.to(cd))
        h = constrain(self.act(g) * u, "batch", "act_expert", None, "act_mlp")
        out_buf = torch.einsum("becf,efd->becd", h, w_down.to(cd))
        out_buf = out_buf.reshape(b, e * cap, d)

        gathered = out_buf.gather(1, dst.clamp(max=e * cap - 1)[..., None].expand(-1, -1, d))
        gathered = torch.where(keep[..., None], gathered.float(), 0.0)
        out = (gathered * flat_gate[..., None]).reshape(b, s, k, d).sum(dim=2)
        return leave(out, sp).to(cd), aux
