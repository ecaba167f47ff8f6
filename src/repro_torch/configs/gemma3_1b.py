"""Gemma3-1B [hf:google/gemma-3-1b-pt]: 26L, d=1152, 4H GQA kv=1,
head_dim=256, d_ff=6912 (GeGLU), vocab=262144, 5:1 local(512):global,
dual rope bases (10k local / 1M global), qk-norm, sandwich norms,
scaled+tied embeddings.  Two groups: four periods of 5 local + 1 global
layers, then 2 local layers.  Same numbers as the JAX package's
``repro/configs/gemma3_1b.py``."""

from .base import GroupCfg, LMConfig, attn_block


def _make(d, layers, heads, kv, head_dim, ff, vocab, window, name):
    common = dict(
        head_dim=head_dim, qk_norm=True, activation="gelu",
        norm="rms_plus_one", post_norms=True,
        query_scale=head_dim ** -0.5,
    )
    local = attn_block(d, heads, kv, ff, rope_theta=10_000.0,
                       window=window, **common)
    glob = attn_block(d, heads, kv, ff, rope_theta=1_000_000.0, **common)

    n_full, rem = divmod(layers, 6)
    groups = [GroupCfg(period=(local,) * 5 + (glob,), n_periods=n_full)]
    if rem:
        groups.append(GroupCfg(period=(local,) * rem, n_periods=1))
    return LMConfig(
        name=name, family="dense", vocab=vocab, d_model=d, n_layers=layers,
        groups=tuple(groups),
        tie_embeddings=True, scale_embedding=True, final_norm="rms_plus_one",
        sub_quadratic=True,
    )


def config() -> LMConfig:
    return _make(1152, 26, 4, 1, 256, 6912, 262144, 512, "gemma3-1b")


def smoke_config() -> LMConfig:
    return _make(64, 8, 4, 1, 16, 128, 256, 16, "gemma3-1b-smoke")
