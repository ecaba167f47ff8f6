"""Architecture registry: the models the port serves."""

from .base import (
    AttentionCfg,
    BlockCfg,
    GoomSSMCfg,
    GroupCfg,
    LMConfig,
    MambaCfg,
    MlpCfg,
    MoeCfg,
    attn_block,
    get_config,
    register,
)

register("goom-rnn-124m", "repro_torch.configs.goom_rnn_124m")
register("jamba-v0.1", "repro_torch.configs.jamba_v01")

__all__ = ["AttentionCfg", "BlockCfg", "GoomSSMCfg", "GroupCfg", "LMConfig",
           "MambaCfg", "MlpCfg", "MoeCfg", "attn_block", "get_config",
           "register"]
