"""The paper's deep RNN (§4.3, Fig. 4-left): 124M params, 24 layers, vocab
50257 (GPT-2 BPE), non-diagonal GOOM SSM layers computed in parallel via a
prefix scan, no stabilization of any kind.  Same numbers as the JAX
package's ``repro/configs/goom_rnn_124m.py``."""

from .base import BlockCfg, GoomSSMCfg, GroupCfg, LMConfig


def _make(d, layers, vocab, name, head_dim=16, chunk=128):
    goom = GoomSSMCfg(d_model=d, head_dim=head_dim, chunk=chunk)
    # the paper's layer holds its own norm/GLU/projection: no channel mixer
    blk = BlockCfg(mixer="goom_ssm", channel="none", goom=goom, norm="ln")
    return LMConfig(
        name=name, family="ssm", vocab=vocab, d_model=d, n_layers=layers,
        groups=(GroupCfg(period=(blk,), n_periods=layers),),
        final_norm="ln", sub_quadratic=True,
    )


def config() -> LMConfig:
    return _make(768, 24, 50257, "goom-rnn-124m")


def smoke_config() -> LMConfig:
    return _make(64, 2, 256, "goom-rnn-124m-smoke", head_dim=8, chunk=16)
