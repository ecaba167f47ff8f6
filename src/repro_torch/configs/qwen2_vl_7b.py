"""Qwen2-VL-7B backbone [arXiv:2409.12191]: 28L, d=3584, 28H GQA kv=4,
d_ff=18944, vocab=152064, M-RoPE (sections 16/24/24, theta 1e6), qkv bias.

The vision frontend is a stub, as in the JAX package: ``prefix_embeds``
carries precomputed patch embeddings (``n_prefix`` positions).  Same
numbers as ``repro/configs/qwen2_vl_7b.py``."""

from .base import LMConfig, attn_block, uniform_groups


def _make(d, layers, heads, kv, ff, vocab, n_prefix, name):
    hd = 128 if d >= 1024 else d // heads
    # M-RoPE sections in half-dim units: (16, 24, 24) at head_dim 128, the
    # reduced configs in proportion
    half = hd // 2
    sec_hw = int(half * 24 / 64)
    sections = (half - 2 * sec_hw, sec_hw, sec_hw)
    blk = attn_block(
        d, heads, kv, ff, head_dim=hd, rope_theta=1_000_000.0, qkv_bias=True,
        mrope_sections=sections,
    )
    return LMConfig(
        name=name, family="vlm", vocab=vocab, d_model=d, n_layers=layers,
        groups=uniform_groups(blk, layers),
        frontend="vlm", n_prefix=n_prefix, mrope=True,
        sub_quadratic=False,
    )


def config() -> LMConfig:
    return _make(3584, 28, 28, 4, 18944, 152064, 256, "qwen2-vl-7b")


def smoke_config() -> LMConfig:
    return _make(64, 2, 4, 2, 128, 256, 8, "qwen2-vl-7b-smoke")
