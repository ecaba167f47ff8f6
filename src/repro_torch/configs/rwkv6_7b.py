"""RWKV6 (Finch) 7B [arXiv:2404.05892]: 32L, d=4096, attention-free,
channel-mix d_ff=14336, vocab=65536.  The decay is computed in log space,
the GOOM-native quantity (``scan_impl="goom"``: the WKV scores are LMME
calls).  Same numbers as the JAX package's ``repro/configs/rwkv6_7b.py``."""

from .base import BlockCfg, GroupCfg, LMConfig, Rwkv6Cfg


def _make(d, layers, ff, vocab, name, scan_impl="goom", chunk=128):
    rw = Rwkv6Cfg(d_model=d, d_ff=ff, head_dim=min(64, d // 4),
                  chunk=chunk, scan_impl=scan_impl)
    blk = BlockCfg(mixer="rwkv6", channel="rwkv6_cm", rwkv=rw, norm="ln")
    return LMConfig(
        name=name, family="ssm", vocab=vocab, d_model=d, n_layers=layers,
        groups=(GroupCfg(period=(blk,), n_periods=layers),),
        final_norm="ln", sub_quadratic=True,
    )


def config() -> LMConfig:
    return _make(4096, 32, 14336, 65536, "rwkv6-7b")


def smoke_config() -> LMConfig:
    return _make(64, 2, 224, 256, "rwkv6-7b-smoke", chunk=16)
