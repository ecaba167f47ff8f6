"""DecoderLM: embed → blocks → final norm → lm_head.

Counterpart of ``repro/models/model.py`` for every model of the JAX
package's registry (goom-rnn, Jamba, RWKV6, the attention families,
musicgen-large and qwen2-vl-7b).  The residual stream runs in
``cfg.compute_dtype`` (bf16 by default); the parameters are
``cfg.param_dtype`` (f32 by default).  ``tie_embeddings``: no ``lm_head``
parameter, the logits are ``h @ embed.T``; ``scale_embedding``: the
embedded tokens times sqrt(d), both in the compute dtype.  The lm_head
product stays a plain ``torch.matmul``, as the JAX package leaves it to XLA
outside any kernel.

Modality frontends are stubs, as in the JAX package: ``prefix_embeds``
(B, P, d) carries precomputed patch or frame embeddings, cast to the
compute dtype and added onto the first P positions of the call's tokens.
``pos_embedding="sinusoidal"`` (musicgen-large) adds ``[cos, sin]``
embeddings of the absolute positions after the prefix.  M-RoPE
(qwen2-vl-7b) takes ``mrope_positions`` (3, B, S); without them each of
the three streams is ``positions``.

Training: ``loss(tokens, labels, **kw)``, the JAX package's next-token CE
with the MoE's aux losses added (``repro/models/model.py::DecoderLM.loss``);
``kw`` are the frontend inputs above.  ``cfg.remat`` (JAX's
``group_apply``): ``"full"`` (the default) runs each period of each group
under non-reentrant ``torch.utils.checkpoint``, so the backward re-runs the
period's forward, its GOOM kernels included; ``"dots"`` keeps the outputs
of the products without batch dims (``aten.mm``, ``aten.addmm``: JAX's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest; ``"none"``
keeps everything.  Remat applies only with grad enabled and no caches.
``param_axes()`` gives each parameter's JAX logical axes, which the
sharding rules lay out (``sharding.distribute_model``).

Laid-out parameters (DTensors, FSDP) are gathered where they are read
(``sharding/gather.py``), as XLA places JAX's gathers inside its scan over
periods: each period's parameters as the period starts, inside its
checkpoint region under ``"full"`` and ``"dots"`` (the backward's
recomputation gathers again, and nothing gathered is saved); the
embedding, final norm and head around their use, the tied head gathered
again for the loss.  So a rank holds one period's gathered parameters at a
time, and their whole gradients one period at a time.  Under ``"none"``
autograd keeps the gathered weights the products save, every period's,
as JAX keeps them as scan residuals.  ``param_gather`` (the train step's
:class:`~repro_torch.sharding.gather.ParamGather`: the batch axes, the
bf16 cast) goes to ``hidden_states``, ``forward``, ``loss`` and
``prefill``; without it a laid-out model gathers with the default.

Serving API (what ``serve.Engine`` drives): ``init_caches``,
``init_slot_caches`` (the paged KV pool), ``prefill`` and ``decode_step``.
Caches are a list with one dict per layer: the layer's GOOM carry, Mamba
state, or attention KV rows (or page pool and tables) with a per-row index.
``positions`` are absolute, per row; attention layers rotate by them and
the recurrent layers ignore them.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from ..configs.base import LMConfig
from ..kernels.dispatch import resolve_device
from ..sharding import tensor_parallel as tp
from ..sharding.gather import ParamGather
from ..sharding.rules import constrain, current_rules, is_dtensor, use_rules
from .blocks import Block, block_init_cache
from .common import Dense, wide, with_axes
from .norms import make_norm
from .rope import sinusoidal_embedding

Caches = List[Dict[str, torch.Tensor]]


class DecoderLM(nn.Module):
    """The decoder, built on ``device`` (default ``cuda``) with weights drawn
    from ``generator`` (default: seed 0 on that device)."""

    def __init__(self, cfg: LMConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        kw = dict(device=dev, dtype=cfg.param_dtype)
        self.embed = with_axes(0.02 * torch.randn(
            (cfg.vocab, cfg.d_model), generator=generator, **kw), ("vocab", "embed"))
        self.layers = nn.ModuleList(
            [Block(blk, generator=generator, **kw) for blk in cfg.layer_list])
        self.final_norm = make_norm(cfg.final_norm, cfg.d_model, **kw)
        self.lm_head = (None if cfg.tie_embeddings
                        else Dense(cfg.d_model, (cfg.vocab,), generator=generator,
                                   out_axes=("vocab",), **kw))
        if cfg.remat not in _REMAT_CONTEXT:
            raise ValueError(f"unknown remat {cfg.remat!r}; one of {sorted(_REMAT_CONTEXT)}")
        self._axes = {name: p.axes for name, p in self.named_parameters()}
        # each group's periods as (first layer, end) spans of self.layers
        self._periods, lo = [], 0
        for g in cfg.groups:
            for _ in range(g.n_periods):
                self._periods.append((lo, lo + len(g.period)))
                lo += len(g.period)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Each parameter's JAX logical axes, keyed by state-dict name (the
        axes of JAX's ``init_shapes`` without the ``layers`` axis a stacked
        group adds; ``convert.param_axes_to_jax`` adds it)."""
        return dict(self._axes)

    def split_roles(self, rules) -> Dict[str, Tuple[str, Optional[int]]]:
        """Each parameter read by a module split across ranks under
        ``rules``: (the mesh axis, the dim whose block the module reads, or
        None for a weight read whole; ``sharding/gather.py``)."""
        roles = {}
        for i, layer in enumerate(self.layers):
            for part in ("mixer", "channel"):
                split_dims = getattr(getattr(layer, part, None), "split_dims", None)
                if split_dims is None:
                    continue
                axis, dims = split_dims(rules)
                roles.update({f"layers.{i}.{part}.{n}": (axis, d) for n, d in dims.items()})
        axis = rules.split_axis("act_vocab", self.cfg.vocab)
        if axis is not None:
            roles["embed"] = (axis, 0)
            if self.lm_head is not None:
                roles["lm_head.w"] = (axis, 1)
        return roles

    def _reads(self, param_gather: Optional[ParamGather]):
        """(the gather of this call, each split parameter's role under the
        active rules as (Split, dim)): ``param_gather``, else the default
        one for laid-out parameters or for a split model's plain ones, else
        None (plain parameters, read as they are)."""
        rules = current_rules()
        roles = {}
        if rules is not None and getattr(rules.mesh, "device_mesh", None) is not None:
            splits = {}
            for name, (axis, dim) in self.split_roles(rules).items():
                if axis not in splits:
                    splits[axis] = tp.split_on(rules, axis)
                roles[name] = (splits[axis], dim)
        if param_gather is not None:
            return param_gather, roles
        return (ParamGather() if roles or is_dtensor(self.embed) else None), roles

    def hidden_states(self, tokens: torch.Tensor,
                      caches: Optional[Caches] = None,
                      positions: Optional[torch.Tensor] = None, *,
                      prefix_embeds: Optional[torch.Tensor] = None,
                      mrope_positions: Optional[torch.Tensor] = None,
                      fresh_caches: bool = False,
                      param_gather: Optional[ParamGather] = None):
        """tokens (B, S) at ``positions`` (B, S; default 0..S-1) → (final-normed
        hidden (B, S, d), new caches or None, aux losses summed over layers).
        ``prefix_embeds`` (B, P <= S, d) are added onto the first P
        positions; ``mrope_positions`` (3, B, S) go to M-RoPE layers;
        ``fresh_caches`` (static) promises empty caches (see ``prefill``);
        ``param_gather`` gathers laid-out parameters (module docstring)."""
        gather, roles = self._reads(param_gather)
        cd = self.cfg.compute_dtype
        b, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(b, s)
        # F.embedding, not indexing: its backward gives the same bits every
        # run (indexing's accumulating backward does not on the CPU); the
        # rank's rows of a vocabulary split, all-reduced
        role = roles.get("embed")
        x = tp.embedding(tokens, self._whole("embed", self.embed, gather, role),
                         role and role[0], self.cfg.vocab).to(cd)
        if self.cfg.scale_embedding:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model)).to(cd)
        if prefix_embeds is not None:
            pad = s - prefix_embeds.shape[1]
            if pad < 0:
                raise ValueError("prefix longer than sequence")
            x = x + F.pad(prefix_embeds.to(cd), (0, 0, 0, pad))
        if self.cfg.pos_embedding == "sinusoidal":
            x = x + sinusoidal_embedding(positions, self.cfg.d_model).to(cd)
        x = constrain(x, "batch", "act_seq", "act_embed")
        new_caches = []
        aux_tot: Dict[str, torch.Tensor] = {}
        remat = self.cfg.remat if caches is None and torch.is_grad_enabled() else "none"
        for lo, hi in self._periods:
            if remat == "none":
                x, cs, aux = self._period(x, positions, mrope_positions, lo, hi, caches,
                                          fresh_caches, gather, roles)
                new_caches.extend(cs)
            else:
                x, aux = checkpoint(self._period_remat, x, positions, mrope_positions, lo, hi,
                                    gather, roles, current_rules(), use_reentrant=False,
                                    context_fn=_REMAT_CONTEXT[remat])
            for k, v in aux.items():
                aux_tot[k] = aux_tot.get(k, 0.0) + v
        with self._gathered(["final_norm"], gather):
            h = self.final_norm(x)
        return h, (new_caches if caches is not None else None), aux_tot

    @staticmethod
    def _whole(name: str, p: torch.Tensor, gather: Optional[ParamGather],
               role=None) -> torch.Tensor:
        return p if gather is None else gather(name, p, role)

    @contextlib.contextmanager
    def _gathered(self, prefixes: List[str], gather: Optional[ParamGather], roles=None):
        """The parameters under ``prefixes`` (state-dict names) whole (or a
        split module's blocks, by ``roles``) for the block's duration, freed
        after (nothing when ``gather`` is None)."""
        if gather is None:
            yield
            return
        roles = roles or {}
        whole = {}
        for pre in prefixes:
            for n, p in self.get_submodule(pre).named_parameters():
                name = f"{pre}.{n}"
                whole[name] = gather(name, p, roles.get(name))
        with _reparametrize_module(self, whole):
            yield

    def _period(self, x, positions, mrope_positions, lo: int, hi: int,
                caches: Optional[Caches], fresh_caches: bool = False,
                gather: Optional[ParamGather] = None, roles=None):
        """Layers ``lo:hi`` (one period of a group), their parameters
        gathered first → (x, their caches, aux)."""
        cs, aux_tot = [], {}
        with self._gathered([f"layers.{i}" for i in range(lo, hi)], gather, roles):
            for i in range(lo, hi):
                x, c, aux = self.layers[i](x, positions=positions,
                                           mrope_positions=mrope_positions,
                                           cache=None if caches is None else caches[i],
                                           compute_dtype=self.cfg.compute_dtype,
                                           fresh_caches=fresh_caches)
                cs.append(c)
                for k, v in aux.items():
                    aux_tot[k] = aux_tot.get(k, 0.0) + v
        return x, cs, aux_tot

    def _period_remat(self, x, positions, mrope_positions, lo: int, hi: int, gather, roles,
                      rules):
        # the backward recomputes this on autograd's device thread (a CUDA
        # tensor's), where the caller's thread-local rules are not active:
        # the forward's rules go with it, so the recomputation splits alike
        with use_rules(rules):
            x, _, aux = self._period(x, positions, mrope_positions, lo, hi, None,
                                     gather=gather, roles=roles)
        return x, aux

    def head_weight(self, param_gather: Optional[ParamGather] = None) -> torch.Tensor:
        """The (d, vocab) head in the compute dtype: ``embed.T`` when tied;
        laid-out parameters gathered whole (``param_gather``); under a
        vocabulary split the rank's (d, block)."""
        return self._head(param_gather)[0]

    def _head(self, param_gather: Optional[ParamGather]):
        """(the head weight of ``head_weight``, the vocabulary's Split or None)."""
        gather, roles = self._reads(param_gather)
        v = self.cfg.vocab
        if self.lm_head is None:
            role = roles.get("embed")
            w = self._whole("embed", self.embed, gather, role)
            w = (w if role is None else role[0].take(w, 0, v)).T
        else:
            role = roles.get("lm_head.w")
            w = self._whole("lm_head.w", self.lm_head.w, gather, role)
            w = w if role is None else role[0].take(w, 1, v)
        return w.to(self.cfg.compute_dtype), role and role[0]

    def logits(self, hidden: torch.Tensor,
               param_gather: Optional[ParamGather] = None) -> torch.Tensor:
        """(..., vocab) logits; under a vocabulary split each rank's block,
        all-gathered whole."""
        w, sp = self._head(param_gather)
        return constrain(tp.gather_last(tp.enter(hidden, sp) @ w, sp, self.cfg.vocab),
                         "batch", "act_seq", "act_vocab")

    def forward(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        """Full forward to logits (B, S, vocab); ``kw`` as ``hidden_states``."""
        h, _, _ = self.hidden_states(tokens, **kw)
        return self.logits(h, kw.get("param_gather"))

    # -- training ------------------------------------------------------------
    def loss(self, tokens: torch.Tensor, labels: torch.Tensor, **kw
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token CE of tokens (B, S) against labels (B, S; -1 masked),
        plus 0.01·load_balance_loss + router_z_loss when the model has an
        MoE; ``kw`` (frontend inputs) as ``hidden_states``.  Returns (loss,
        metrics: ce_loss, tokens, loss and the aux terms).

        The CE runs over pieces of ``min(logit_chunk, S)`` tokens, each
        recomputed in the backward (``jax.checkpoint`` in JAX), so no more
        than one piece's f32 logits are alive at a time; logits are the
        compute-dtype product cast to f32, as in JAX.  Under a vocabulary
        split each rank makes its block of the logits only, and the NLL
        combines the ranks' log-sum-exps and the gold logit
        (``tensor_parallel.split_nll``)."""
        h, _, aux = self.hidden_states(tokens, **kw)
        w, sp = self._head(kw.get("param_gather"))
        h = tp.enter(h, sp)
        s = h.shape[1]
        ck = min(self.cfg.logit_chunk, s)
        if s % ck:
            raise ValueError(f"sequence length {s} is not a multiple of "
                             f"logit_chunk {ck}")
        tot = cnt = 0.0
        for i in range(0, s, ck):
            nll, n = checkpoint(_piece_nll, h[:, i:i + ck], labels[:, i:i + ck], w, sp,
                                self.cfg.vocab, use_reentrant=False)
            tot, cnt = tot + nll, cnt + n
        ce = tot / cnt.clamp_min(1.0)
        loss = ce
        metrics = {"ce_loss": ce, "tokens": cnt}
        if "load_balance_loss" in aux:
            loss = loss + 0.01 * aux["load_balance_loss"]
            metrics["load_balance_loss"] = aux["load_balance_loss"]
        if "router_z_loss" in aux:
            loss = loss + aux["router_z_loss"]
            metrics["router_z_loss"] = aux["router_z_loss"]
        metrics["loss"] = loss
        return loss, metrics

    # -- serving -------------------------------------------------------------
    def init_caches(self, batch: int, max_len: Optional[int] = None, *,
                    kv_pages: Optional[Tuple[int, int, int]] = None,
                    device=None) -> Caches:
        """Each layer's decode state, every leaf leading with ``batch``;
        attention layers hold ``max_len`` positions of KV per row (required
        when the model has one), or, with ``kv_pages=(page_size, n_pages,
        max_blocks)``, a shared page pool with per-row page tables.
        ``device`` defaults to the model's (``"meta"`` sizes a cache
        without allocating it)."""
        dev = self.device if device is None else torch.device(device)
        return [block_init_cache(blk, batch, device=dev, max_len=max_len,
                                 kv_pages=kv_pages)
                for blk in self.cfg.layer_list]

    def init_slot_caches(self, max_slots: int, page_len: int, *,
                         page_size: Optional[int] = None, cache_pages: int = 0,
                         device=None) -> Caches:
        """Slot-managed decode state for continuous batching (``serve.Engine``).

        With ``page_size=None`` attention layers get dense ``(max_slots,
        page_len, ...)`` rows.  With ``page_size=ps`` they keep KV in a
        pool of ``max_slots * ceil(page_len / ps) + cache_pages`` pages (and
        the trash page) with per-slot page tables: pages can be shared
        across slots (prefix reuse), and ``cache_pages`` extra pages let
        finished prefixes outlive their slot.  As ``repro/models/model.py``."""
        if page_size is None:
            return self.init_caches(max_slots, page_len, device=device)
        ps = int(page_size)
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        max_blocks = -(-page_len // ps)
        n_pages = max_slots * max_blocks + int(cache_pages)
        return self.init_caches(max_slots, max_blocks * ps,
                                kv_pages=(ps, n_pages, max_blocks), device=device)

    def prefill(self, tokens: torch.Tensor, caches: Caches,
                positions: Optional[torch.Tensor] = None, *, fresh_caches: bool = False,
                **kw) -> Tuple[torch.Tensor, Caches]:
        """Ingest a prompt chunk (B, S) from the caches' state at absolute
        ``positions`` (B, S; default 0..S-1: a fresh cache), with ``kw``'s
        frontend inputs; returns the last position's logits (B, 1, vocab)
        and the advanced caches.  ``fresh_caches`` (static) promises that
        the caches are empty: the single-shot prefill then attends over the
        prompt itself, so its work scales with the prompt and not with the
        caches' length (chunked callers leave it False)."""
        h, caches, _ = self.hidden_states(tokens, caches, positions,
                                          fresh_caches=fresh_caches, **kw)
        return self.logits(h[:, -1:], kw.get("param_gather")), caches

    def decode_step(self, token: torch.Tensor, caches: Caches,
                    index: torch.Tensor, mrope_positions: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Caches]:
        """One decode step: token (B, 1) at absolute position ``index`` (B,)
        → (logits (B, 1, vocab), caches).  With M-RoPE and no
        ``mrope_positions`` (3, B, 1), the attention layers rotate every
        stream by ``index``, as JAX's ``decode_step`` does (after an image
        prefix too)."""
        positions = torch.as_tensor(index, device=token.device).reshape(-1, 1)
        h, caches, _ = self.hidden_states(token, caches, positions,
                                          mrope_positions=mrope_positions)
        return self.logits(h), caches


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``: keep
    the products without batch dims (``mm``, ``addmm``), recompute the rest
    (``bmm``, einsums over heads and the GOOM kernels included)."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_REMAT_CONTEXT = {
    "none": None,
    "full": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts, _save_dots),
}


def _piece_nll(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
               sp: Optional[tp.Split] = None, vocab: int = 0):
    """(summed NLL, count) of one piece: hidden (B, k, d) in the compute
    dtype, labels (B, k) with -1 masked, head weight (d, V), or with ``sp``
    the rank's (d, block) of a vocabulary of ``vocab``."""
    logits = wide(h @ w)
    mask = (labels >= 0).to(logits.dtype)
    if sp is not None:
        return tp.split_nll(logits, labels, sp, vocab), mask.sum()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()
