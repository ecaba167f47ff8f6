"""The port's decoders: GOOM SSM, Mamba and attention layers, MLP and MoE
channels, blocks, and the DecoderLM."""

from .attention import Attention, attention_init_cache
from .blocks import Block, block_init_cache
from .goom_layer import GoomSSM, goom_ssm_init_state
from .mlp import Mlp, Moe
from .model import DecoderLM
from .norms import LayerNorm, RMSNorm
from .ssm import Mamba, mamba_init_state, segment_states

__all__ = ["Attention", "attention_init_cache", "Block", "block_init_cache",
           "GoomSSM", "goom_ssm_init_state", "Mlp", "Moe", "DecoderLM",
           "LayerNorm", "RMSNorm", "Mamba", "mamba_init_state", "segment_states"]
