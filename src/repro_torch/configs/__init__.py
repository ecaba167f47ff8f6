"""Architecture registry: the goom-rnn model this slice of the port serves."""

from .base import (
    BlockCfg,
    GoomSSMCfg,
    GroupCfg,
    LMConfig,
    get_config,
    register,
)

register("goom-rnn-124m", "repro_torch.configs.goom_rnn_124m")

__all__ = ["BlockCfg", "GoomSSMCfg", "GroupCfg", "LMConfig", "get_config",
           "register"]
