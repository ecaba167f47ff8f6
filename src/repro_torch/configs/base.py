"""Config dataclasses and the architecture registry.

The fields mirror the JAX package's ``GoomSSMCfg`` / ``BlockCfg`` /
``GroupCfg`` / ``LMConfig`` (``repro/models/{goom_layer,blocks,model}.py``),
cut to those the goom-rnn model uses; dtypes are torch dtypes.
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
class BlockCfg:
    """One layer: a pre-normed sequence mixer (and a channel mixer, none here)."""

    mixer: str                      # goom_ssm
    channel: str                    # none
    goom: Optional[GoomSSMCfg] = None
    norm: str = "ln"                # ln


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
    final_norm: str = "ln"
    sub_quadratic: bool = False
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def layer_list(self):
        out = []
        for g in self.groups:
            out.extend(list(g.period) * g.n_periods)
        return out


_REGISTRY: Dict[str, str] = {}  # name -> module


def register(name: str, module: str) -> None:
    _REGISTRY[name] = module


def get_config(name: str, smoke: bool = False) -> LMConfig:
    """The full published config of ``name``, or its reduced smoke config."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    mod = importlib.import_module(_REGISTRY[name])
    return mod.smoke_config() if smoke else mod.config()
