"""Carry weights over from the JAX package's param tree.

``params_from_jax(cfg, tree)`` takes the JAX tree as nested dicts of numpy
arrays (``unzip(model.init(key))[0]`` mapped through ``np.asarray``) and
returns a state dict for the port's ``DecoderLM``::

    model.load_state_dict(params_from_jax(cfg, tree))

The layouts agree leaf by leaf: goom-rnn's ``in_proj.w`` (d, H, hd) and
``out_proj.w`` (H·hd, d); attention's ``q.w`` (d, H, hd) and ``o.w``
(H, hd, d); the MoE's f32 ``router.w`` (d, E) and its stacked expert
weights ``gate``/``up`` (E, d, f) and ``down`` (E, f, d); Mamba's
``dt_proj.{w,b}``, ``a_log``, ``conv_w``/``conv_b`` and ``d_skip``.  What
differs is that a JAX group with ``n_periods > 1`` stacks each leaf over its
periods on the leading axis, while the port has one module per layer: the
leaves are unstacked period by period, block by block.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .configs.base import LMConfig

__all__ = ["params_from_jax"]


def _flat(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def params_from_jax(cfg: LMConfig, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``DecoderLM(cfg)`` from a JAX param tree."""
    sd: Dict[str, np.ndarray] = {
        "embed": np.asarray(tree["embed"]),
        "lm_head.w": np.asarray(tree["lm_head"]["w"]),
    }
    for k, v in _flat(tree["final_norm"]).items():
        sd[f"final_norm.{k}"] = v
    layer = 0
    for gi, grp in enumerate(cfg.groups):
        leaves = _flat(tree[f"group_{gi}"])
        for p in range(grp.n_periods):
            for bi in range(len(grp.period)):
                pre = f"b{bi}."
                for k, v in leaves.items():
                    if k.startswith(pre):
                        v = v[p] if grp.n_periods > 1 else v
                        sd[f"layers.{layer}.{k[len(pre):]}"] = v
                layer += 1
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
