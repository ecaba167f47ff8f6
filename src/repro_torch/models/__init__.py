"""The port's decoders: GOOM SSM, Mamba, RWKV6 and attention layers, MLP,
MoE and RWKV6 channel mixes, blocks, and the DecoderLM."""

from .attention import Attention, attention_init_cache
from .blocks import Block, block_init_cache
from .goom_layer import GoomSSM, goom_ssm_init_state
from .mlp import Mlp, Moe
from .model import DecoderLM
from .norms import LayerNorm, RMSNorm
from .ssm import (
    Mamba,
    Rwkv6ChannelMix,
    Rwkv6TimeMix,
    mamba_init_state,
    rwkv6_init_state,
    segment_states,
)

__all__ = ["Attention", "attention_init_cache", "Block", "block_init_cache",
           "GoomSSM", "goom_ssm_init_state", "Mlp", "Moe", "DecoderLM",
           "LayerNorm", "RMSNorm", "Mamba", "mamba_init_state", "segment_states",
           "Rwkv6TimeMix", "Rwkv6ChannelMix", "rwkv6_init_state"]
