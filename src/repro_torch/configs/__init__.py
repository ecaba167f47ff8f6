"""Architecture registry: the models the port serves, under the JAX
package's names."""

from .base import (
    AttentionCfg,
    BlockCfg,
    GoomSSMCfg,
    GroupCfg,
    LMConfig,
    MambaCfg,
    MlpCfg,
    MoeCfg,
    Rwkv6Cfg,
    SHAPES,
    ShapeCfg,
    attn_block,
    get_config,
    input_specs,
    list_archs,
    register,
    shape_applicable,
    transform_blocks,
    uniform_groups,
)

register("goom-rnn-124m", "repro_torch.configs.goom_rnn_124m")
register("jamba-v0.1", "repro_torch.configs.jamba_v01")
register("rwkv6-7b", "repro_torch.configs.rwkv6_7b")
register("olmo-1b", "repro_torch.configs.olmo_1b")
register("codeqwen1.5-7b", "repro_torch.configs.codeqwen15_7b")
register("phi3.5-moe", "repro_torch.configs.phi35_moe")
register("mixtral-8x7b", "repro_torch.configs.mixtral_8x7b")
register("glm4-9b", "repro_torch.configs.glm4_9b")
register("gemma3-1b", "repro_torch.configs.gemma3_1b")
register("musicgen-large", "repro_torch.configs.musicgen_large")
register("qwen2-vl-7b", "repro_torch.configs.qwen2_vl_7b")

#: the ten assigned architectures, in JAX's order (goom-rnn-124m, the
#: paper's own, is registered but not among them)
ASSIGNED_ARCHS = [
    "qwen2-vl-7b", "rwkv6-7b", "mixtral-8x7b", "phi3.5-moe", "olmo-1b",
    "codeqwen1.5-7b", "glm4-9b", "gemma3-1b", "jamba-v0.1", "musicgen-large",
]

__all__ = ["ASSIGNED_ARCHS", "AttentionCfg", "BlockCfg", "GoomSSMCfg", "GroupCfg",
           "LMConfig", "MambaCfg", "MlpCfg", "MoeCfg", "Rwkv6Cfg", "SHAPES", "ShapeCfg",
           "attn_block", "get_config", "input_specs", "list_archs", "register",
           "shape_applicable", "transform_blocks", "uniform_groups"]
