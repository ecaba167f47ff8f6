"""Config dataclasses and the architecture registry.

The fields mirror the JAX package's ``GoomSSMCfg``, ``MambaCfg``,
``AttentionCfg``, ``MlpCfg``, ``MoeCfg``, ``BlockCfg``, ``GroupCfg`` and
``LMConfig`` (``repro/models/{goom_layer,ssm,attention,mlp,blocks,model}.py``),
cut to those the port's models use (goom-rnn and Jamba: gated-SiLU MLPs,
global attention without biases, q/k norms or M-RoPE); dtypes are torch
dtypes.  The defaults are the JAX package's, ``norm="rms"`` included.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class GoomSSMCfg:
    d_model: int
    head_dim: int = 16      # d of the per-head state-space model
    chunk: int = 128        # in-chunk scan length cap (see models.common.chunk_len)
    scan_variant: str = "shared_a"  # "shared_a" (time-invariant A doubling)
                                    # | "generic" (paper-literal eq. 26)

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    """Mamba's selective SSM (Jamba's recurrent block), GOOM scan."""

    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None
    chunk: int = 64         # scan chunk; sequences are identity-padded to it

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-self.d_model // 16)


@dataclasses.dataclass(frozen=True)
class AttentionCfg:
    """Global causal GQA with RoPE."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0


@dataclasses.dataclass(frozen=True)
class MlpCfg:
    """Gated SiLU MLP: down(silu(gate(x)) * up(x))."""

    d_model: int
    d_ff: int


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    """Top-k mixture of gated SiLU experts."""

    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3     # weight of the router z-loss (training aux)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One layer: a pre-normed sequence mixer and a pre-normed channel mixer."""

    mixer: str                      # goom_ssm | mamba | attention
    channel: str                    # none | mlp | moe
    goom: Optional[GoomSSMCfg] = None
    mamba: Optional[MambaCfg] = None
    attn: Optional[AttentionCfg] = None
    mlp: Optional[MlpCfg] = None
    moe: Optional[MoeCfg] = None
    norm: str = "rms"               # rms | ln


@dataclasses.dataclass(frozen=True)
class GroupCfg:
    period: Tuple[BlockCfg, ...]
    n_periods: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str
    vocab: int
    d_model: int
    n_layers: int
    groups: Tuple[GroupCfg, ...]
    final_norm: str = "rms"        # rms | ln
    sub_quadratic: bool = False
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    logit_chunk: int = 512         # the loss's CE is computed in pieces of this many tokens

    @property
    def layer_list(self):
        out = []
        for g in self.groups:
            out.extend(list(g.period) * g.n_periods)
        return out


def attn_block(d_model: int, n_heads: int, n_kv_heads: int, d_ff: int, *,
               rope_theta: float = 10000.0, moe: Optional[MoeCfg] = None) -> BlockCfg:
    """An attention block (head_dim d_model / n_heads) with a gated MLP, or
    with ``moe`` as its channel (``repro/configs/base.py::attn_block``, cut
    to the port's fields)."""
    attn = AttentionCfg(d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
                        head_dim=d_model // n_heads, rope_theta=rope_theta)
    if moe is not None:
        return BlockCfg(mixer="attention", channel="moe", attn=attn, moe=moe)
    return BlockCfg(mixer="attention", channel="mlp", attn=attn,
                    mlp=MlpCfg(d_model=d_model, d_ff=d_ff))


_REGISTRY: Dict[str, str] = {}  # name -> module


def register(name: str, module: str) -> None:
    _REGISTRY[name] = module


def get_config(name: str, smoke: bool = False) -> LMConfig:
    """The full published config of ``name``, or its reduced smoke config."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    mod = importlib.import_module(_REGISTRY[name])
    return mod.smoke_config() if smoke else mod.config()
