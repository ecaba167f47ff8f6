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

``params_to_jax(cfg, state_dict)`` is the inverse: it restacks each group's
periods on the leading axis and returns the JAX tree as nested dicts of
numpy arrays.  ``jax_path(cfg, name)`` gives a port parameter's JAX tree
path and its period, e.g. ``layers.3.mixer.A`` → (``group_0.b0.mixer.A``,
3) for goom-rnn; the optimizer's decay mask and the checkpoint layout key on
that path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .configs.base import LMConfig

__all__ = ["params_from_jax", "params_to_jax", "jax_path"]


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
    for layer, (gi, p, bi) in enumerate(_layer_slots(cfg)):
        stacked = cfg.groups[gi].n_periods > 1
        pre = f"b{bi}."
        for k, v in _flat(tree[f"group_{gi}"]).items():
            if k.startswith(pre):
                sd[f"layers.{layer}.{k[len(pre):]}"] = v[p] if stacked else v
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def _layer_slots(cfg: LMConfig) -> List[Tuple[int, int, int]]:
    """(group, period, block in the period) of each of the port's layers."""
    return [(gi, p, bi) for gi, grp in enumerate(cfg.groups)
            for p in range(grp.n_periods) for bi in range(len(grp.period))]


def jax_path(cfg: LMConfig, name: str) -> Tuple[str, Optional[int]]:
    """(dotted JAX tree path, period index or None) of the port's parameter
    ``name``; the period is None where the JAX leaf is not stacked."""
    if not name.startswith("layers."):
        return name, None
    _, layer, rest = name.split(".", 2)
    gi, p, bi = _layer_slots(cfg)[int(layer)]
    stacked = cfg.groups[gi].n_periods > 1
    return f"group_{gi}.b{bi}.{rest}", (p if stacked else None)


def params_to_jax(cfg: LMConfig, state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """The JAX param tree (nested dicts of numpy arrays, each group's periods
    stacked on the leading axis) of a port state dict; the inverse of
    :func:`params_from_jax`.  Works on any dict keyed by the port's
    parameter names, such as the optimizer's moments."""
    stacks: Dict[str, Dict[int, np.ndarray]] = {}
    flat: Dict[str, np.ndarray] = {}
    for name, v in state_dict.items():
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        path, period = jax_path(cfg, name)
        if period is None:
            flat[path] = v
        else:
            stacks.setdefault(path, {})[period] = v
    for path, by_period in stacks.items():
        flat[path] = np.stack([by_period[p] for p in range(len(by_period))])
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree
