"""Config dataclasses and the architecture registry.

The fields mirror the JAX package's ``GoomSSMCfg``, ``MambaCfg``,
``Rwkv6Cfg``, ``AttentionCfg``, ``MlpCfg``, ``MoeCfg``, ``BlockCfg``,
``GroupCfg`` and ``LMConfig``
(``repro/models/{goom_layer,ssm,attention,mlp,blocks,model}.py``); dtypes
are torch dtypes and the defaults are the JAX package's, the
flash-attention tiles (``block_q``, ``block_kv``) included.  ``LMConfig.remat``
(``"none"``, ``"dots"``, ``"full"``) checkpoints each period of a group in
training, as JAX's ``group_apply``; ``MambaCfg.scan_impl`` picks the GOOM
scan (``"goom"``) or the conventional float baseline (``"float"``).
``transform_blocks`` rebuilds a config block by block (for example to flip
attention to banded sliding windows).

The shape registry is JAX's (``repro/configs/base.py``): ``ShapeCfg``, the
four ``SHAPES`` of the dry-run, ``shape_applicable`` and ``input_specs``,
whose stand-ins are tensors on the ``meta`` device of JAX's shapes and
dtypes.
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
    scan_impl: str = "goom"  # "goom" (paper) | "float" (baseline)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-self.d_model // 16)


@dataclasses.dataclass(frozen=True)
class Rwkv6Cfg:
    """RWKV6 (Finch) time and channel mix, the WKV scan in GOOM or float form."""

    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_mix: int = 32
    lora_decay: int = 64
    chunk: int = 128
    scan_impl: str = "goom"  # "goom" (paper) | "float" (baseline)

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


@dataclasses.dataclass(frozen=True)
class AttentionCfg:
    """Causal GQA with RoPE (full or partial), optionally windowed."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rotary_fraction: float = 1.0
    window: Optional[int] = None          # sliding-window size (None = global)
    qkv_bias: bool = False
    qk_norm: bool = False                 # gemma3-style q/k RMSNorm
    mrope_sections: Optional[Tuple[int, ...]] = None  # M-RoPE, half-dim units
    query_scale: Optional[float] = None   # override 1/sqrt(head_dim)
    block_q: int = 512                    # flash attention: queries padded to a multiple
    block_kv: int = 1024                  # flash attention: keys a block
    use_banded: bool = False              # banded SWA without a cache (2·window <= S)


@dataclasses.dataclass(frozen=True)
class MlpCfg:
    """MLP: down(act(gate(x)) * up(x)), or down(act(up(x))) when not gated."""

    d_model: int
    d_ff: int
    activation: str = "silu"      # silu | gelu | relu2
    gated: bool = True


@dataclasses.dataclass(frozen=True)
class MoeCfg:
    """Top-k mixture of gated experts."""

    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_z_loss: float = 1e-3     # weight of the router z-loss (training aux)


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One layer: a pre-normed sequence mixer and a pre-normed channel mixer."""

    mixer: str                      # attention | rwkv6 | mamba | goom_ssm | none
    channel: str                    # mlp | moe | rwkv6_cm | none
    attn: Optional[AttentionCfg] = None
    rwkv: Optional[Rwkv6Cfg] = None
    mamba: Optional[MambaCfg] = None
    goom: Optional[GoomSSMCfg] = None
    mlp: Optional[MlpCfg] = None
    moe: Optional[MoeCfg] = None
    norm: str = "rms"               # rms | rms_plus_one | ln | ln_nonparam
    post_norms: bool = False        # gemma3 sandwich norms


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
    tie_embeddings: bool = False
    scale_embedding: bool = False  # gemma: multiply embeddings by sqrt(d)
    final_norm: str = "rms"        # rms | rms_plus_one | ln | ln_nonparam
    pos_embedding: str = "none"    # none | sinusoidal
    frontend: Optional[str] = None  # vlm | audio (stubbed: prefix_embeds)
    n_prefix: int = 0              # frontend embedding positions
    mrope: bool = False
    sub_quadratic: bool = False
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: str = "full"            # none | dots | full (per period, training only)
    logit_chunk: int = 512         # the loss's CE is computed in pieces of this many tokens

    @property
    def layer_list(self):
        out = []
        for g in self.groups:
            out.extend(list(g.period) * g.n_periods)
        return out


# ---------------------------------------------------------------------------
# input shapes (the dry-run's cells)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long_decode"


SHAPES: Dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524_288, 1, "long_decode"),
}


def shape_applicable(cfg: "LMConfig", shape: ShapeCfg) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs; the reason if it is skipped."""
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is a pure full-attention arch (see DESIGN.md)"
        )
    return True, ""


def input_specs(cfg: "LMConfig", shape: ShapeCfg) -> Dict[str, torch.Tensor]:
    """``meta`` tensors standing in for every model input of a step.

    train/prefill: the full (B, S) token batch (+ frontend stubs).
    decode/long_decode: one new token per sequence (the caches are made by
    the serving code, not part of the input specs)."""
    b, s = shape.global_batch, shape.seq_len
    ids, f32 = torch.int32, torch.float32

    def spec(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((b, s), ids)}
        if shape.kind == "train":
            specs["labels"] = spec((b, s), ids)
        if cfg.frontend in ("vlm", "audio"):
            specs["prefix_embeds"] = spec((b, cfg.n_prefix, cfg.d_model), f32)
        if cfg.frontend == "vlm" and cfg.mrope:
            specs["mrope_positions"] = spec((3, b, s), ids)
        return specs
    return {"token": spec((b, 1), ids)}


def attn_block(
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    d_ff: int,
    *,
    head_dim: Optional[int] = None,
    rope_theta: float = 10000.0,
    rotary_fraction: float = 1.0,
    window: Optional[int] = None,
    qkv_bias: bool = False,
    qk_norm: bool = False,
    mrope_sections: Optional[Tuple[int, ...]] = None,
    query_scale: Optional[float] = None,
    activation: str = "silu",
    gated: bool = True,
    moe: Optional[MoeCfg] = None,
    norm: str = "rms",
    post_norms: bool = False,
) -> BlockCfg:
    """An attention block (head_dim d_model / n_heads unless given) with an
    MLP, or with ``moe`` as its channel (``repro/configs/base.py::attn_block``)."""
    hd = head_dim if head_dim is not None else d_model // n_heads
    attn = AttentionCfg(
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=hd,
        rope_theta=rope_theta, rotary_fraction=rotary_fraction, window=window,
        qkv_bias=qkv_bias, qk_norm=qk_norm, mrope_sections=mrope_sections,
        query_scale=query_scale)
    if moe is not None:
        return BlockCfg(mixer="attention", channel="moe", attn=attn, moe=moe,
                        norm=norm, post_norms=post_norms)
    return BlockCfg(
        mixer="attention", channel="mlp", attn=attn,
        mlp=MlpCfg(d_model=d_model, d_ff=d_ff, activation=activation, gated=gated),
        norm=norm, post_norms=post_norms)


def uniform_groups(block: BlockCfg, n_layers: int) -> Tuple[GroupCfg, ...]:
    return (GroupCfg(period=(block,), n_periods=n_layers),)


def transform_blocks(cfg: LMConfig, fn) -> LMConfig:
    """``cfg`` with ``fn(BlockCfg) -> BlockCfg`` applied to every block of
    every group (``repro/configs/base.py::transform_blocks``)."""
    groups = tuple(dataclasses.replace(g, period=tuple(fn(blk) for blk in g.period))
                   for g in cfg.groups)
    return dataclasses.replace(cfg, groups=groups)


_REGISTRY: Dict[str, str] = {}  # name -> module


def register(name: str, module: str) -> None:
    _REGISTRY[name] = module


def get_config(name: str, smoke: bool = False) -> LMConfig:
    """The full published config of ``name``, or its reduced smoke config."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    mod = importlib.import_module(_REGISTRY[name])
    return mod.smoke_config() if smoke else mod.config()


def list_archs():
    return sorted(_REGISTRY)
