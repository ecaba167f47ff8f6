"""Roofline terms of a step on the H100, from the dry-run's cost pass.

    compute term    = FLOPs at each peak / (chips × that peak)
    memory term     = bytes / (chips × HBM bandwidth)
    collective term = a device's ring bytes / link bandwidth

The port of ``repro/launch/roofline.py`` with the NVIDIA H100 SXM5 80 GB's
constants in place of the TPU v5e's, each from NVIDIA's H100 Tensor Core GPU
datasheet (SXM5 column):

  * ``PEAK_FLOPS``: 989.4 TFLOP/s of dense BF16 on the tensor cores (the
    datasheet's 1,979 TFLOP/s is with 2:4 sparsity);
  * ``F32_FLOPS``: 67 TFLOP/s of FP32 outside the tensor cores, where the
    GOOM kernels' FMAs and transcendentals run, and every f32 product with
    TF32 off (the port's setting);
  * ``HBM_BW``: 3.35 TB/s of HBM3;
  * ``LINK_BW``: 450 GB/s, one direction of the 900 GB/s of NVLink a GPU
    has in both directions together; the ring model counts the bytes a
    device sends.

The FLOPs, bytes and collectives come from ``launch/cost.py`` (the port's
step on fake tensors) and ``launch/dryrun.py`` (collectives from the
layouts), not from HLO text: JAX's ``parse_collectives`` has no
counterpart.  ``hlo_flops`` and ``hlo_bytes`` keep JAX's names and meaning,
a device's work times ``chips``; the memory term reads the bytes the ops
write (``cost.Cost.written``), and ``hlo_bytes_upper`` adds every op's
reads.  In the port a device's work is the global
step's over the **batch shards**, not over the chips: the model axis splits
the parameters but not the activations (``train/train_loop.py``), so every
rank of it repeats its batch slice's compute.  ``mfu`` keeps JAX's
definition, ``model_flops / (chips · peak · step time)``, so that repetition
shows in it.

``count_params``, ``_block_params`` and ``model_flops`` are JAX's
arithmetic on the config.  ``lmme_work``, ``scan_work`` and ``diag_work``
are the GOOM kernels' bytes and operations (each input read once, each
output written once), which ``chip_smoke.py``'s bounds and the cost pass
share; ``kernel_bound`` turns them into the least time on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

# -- hardware constants (NVIDIA H100 SXM5 80 GB, datasheet) -----------------
PEAK_FLOPS = 989.4e12       # dense bf16 FLOP/s on the tensor cores
F32_FLOPS = 67e12           # f32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12            # HBM3 bytes/s
LINK_BW = 450e9             # NVLink bytes/s a device sends (900e9 both ways)
HBM_BYTES = 80e9            # the card's memory: 80 GB

__all__ = ["PEAK_FLOPS", "F32_FLOPS", "HBM_BW", "LINK_BW", "HBM_BYTES", "CollectiveOp",
           "collective_bytes_per_device", "Roofline", "count_params", "model_flops",
           "lmme_work", "scan_work", "diag_work", "kernel_bound"]


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int

    @property
    def ring_bytes(self) -> float:
        """Bytes over the wire per participating device (ring algorithms)."""
        n = max(self.group_size, 1)
        f = (n - 1) / n
        if self.kind == "all-reduce":
            return 2.0 * self.result_bytes * f
        if self.kind == "all-gather":
            return self.result_bytes * f          # result is the full gather
        if self.kind == "reduce-scatter":
            return self.result_bytes * (n - 1)    # result is the scattered part
        if self.kind == "all-to-all":
            return self.result_bytes * f
        if self.kind == "collective-permute":
            return float(self.result_bytes)
        return float(self.result_bytes)


def collective_bytes_per_device(ops: Iterable[CollectiveOp]) -> Tuple[float, Dict[str, float]]:
    """(total, by kind) of the ops' ring bytes a device sends."""
    by_kind: Dict[str, float] = {}
    for op in ops:
        by_kind[op.kind] = by_kind.get(op.kind, 0.0) + op.ring_bytes
    return sum(by_kind.values()), by_kind


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # a device's FLOPs × chips
    hlo_bytes: float                 # a device's bytes written × chips
    collective_bytes: float          # per-device ring bytes
    collective_by_kind: Dict[str, float]
    model_flops: float               # 6·N_active·D useful flops
    memory_per_device: Optional[Dict[str, float]] = None
    xla_flops_once: float = 0.0      # JAX's field; no counterpart (0)
    unknown_loops: int = 0           # JAX's field; the port counts every trip (0)
    hlo_bytes_upper: float = 0.0     # every op's inputs and outputs, × chips
    f32_flops: float = 0.0           # of hlo_flops, those at F32_FLOPS
    launches: Optional[Dict[str, int]] = None   # GOOM kernel calls a device a step
    host_s: float = 0.0              # seconds the cost pass took on the host

    @property
    def compute_s(self) -> float:
        tensor = self.hlo_flops - self.f32_flops
        return (tensor / PEAK_FLOPS + self.f32_flops / F32_FLOPS) / self.chips

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        # per-device bytes across that device's links
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs / (chips · peak · roofline step time)."""
        return self.model_flops / (
            self.chips * PEAK_FLOPS * max(self.step_time_s, 1e-12)
        )

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes_per_dev": self.collective_bytes,
            "collective_by_kind": self.collective_by_kind,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_fraction": self.useful_fraction,
            "mfu": self.mfu,
            "memory_per_device": self.memory_per_device,
            "xla_flops_once": self.xla_flops_once,
            "unknown_loops": self.unknown_loops,
            "hlo_bytes_upper": self.hlo_bytes_upper,
            "f32_flops": self.f32_flops, "launches": self.launches,
            "host_s": self.host_s,
        }


# ---------------------------------------------------------------------------
# model FLOPs (6·N·D for dense; 6·N_active·D for MoE; decode: 2·N per token)
# ---------------------------------------------------------------------------
def count_params(cfg, *, active_only: bool = False,
                 flops_weighted: bool = False) -> int:
    """Parameter count straight from the config (no allocation).

    ``flops_weighted``: count only params that participate in matmuls —
    the input embedding table is a gather (0 FLOPs/token), so 6·N·D with
    the raw N over-credits vocab-heavy models.  The LM head (or the tied
    table, which *is* the head matmul) stays counted.  JAX's count, which
    leaves some small tensors out (a model's ``numel`` is a little more)."""
    total = cfg.vocab * cfg.d_model  # head matmul (or tied table used as it)
    if not cfg.tie_embeddings and not flops_weighted:
        total += cfg.vocab * cfg.d_model  # separate input table (lookup only)
    for blk in cfg.layer_list:
        total += _block_params(blk, active_only)
    total += cfg.d_model  # final norm
    return total


def _block_params(blk, active_only: bool) -> int:
    n = 0
    d = None
    if blk.attn is not None:
        a = blk.attn
        d = a.d_model
        n += a.d_model * a.head_dim * (a.n_heads + 2 * a.n_kv_heads)
        n += a.n_heads * a.head_dim * a.d_model
    if blk.rwkv is not None and blk.mixer == "rwkv6":
        r = blk.rwkv
        d = r.d_model
        n += 5 * d * d  # r,k,v,g,out
        n += 5 * (d * r.lora_mix + r.lora_mix * d)
        n += d * r.lora_decay + r.lora_decay * d
        n += 8 * d  # mixes, decay base, bonus, norms
    if blk.mamba is not None:
        m = blk.mamba
        d = m.d_model
        di = m.d_inner
        n += d * 2 * di + di * (m.rank + 2 * m.d_state) + m.rank * di
        n += m.d_conv * di + di * m.d_state + 2 * di + di * d
    if blk.goom is not None:
        g = blk.goom
        d = g.d_model
        hd, h = g.head_dim, g.n_heads
        n += d * d  # in_proj
        n += h * hd * hd * 2 + h * hd * 2 * hd * 2  # A,B + C,D
        n += d * d  # out_proj
    if blk.mlp is not None and blk.channel == "mlp":
        f = blk.mlp.d_ff
        d = blk.mlp.d_model
        n += d * f * (3 if blk.mlp.gated else 2)
    if blk.moe is not None and blk.channel == "moe":
        mo = blk.moe
        d = mo.d_model
        e = mo.top_k if active_only else mo.n_experts
        n += mo.d_model * mo.n_experts  # router
        n += e * 3 * d * mo.d_ff
    if blk.rwkv is not None and blk.channel == "rwkv6_cm":
        r = blk.rwkv
        d = r.d_model
        n += d * r.d_ff * 2 + d * d + 2 * d
    if d is not None:
        n += 2 * d  # block norms
    return n


def model_flops(cfg, shape) -> float:
    """6·N_active·D (train); 2·N_active per generated token (decode).
    N counts matmul-participating params (input-embedding lookups are
    FLOP-free gathers)."""
    n_active = count_params(cfg, active_only=True, flops_weighted=True)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


# ---------------------------------------------------------------------------
# the GOOM kernels' work: (bytes moved, f32 operations) of one call
# ---------------------------------------------------------------------------
def lmme_work(a_shape: Sequence[int], b_shape: Sequence[int]) -> Tuple[int, int]:
    """LMME (..., n, d) x (..., d, m): each input plane read once, each
    output plane written once; one exp per input element, 2 flops per
    multiply-add and one log per output element."""
    batch = _broadcast(a_shape[:-2], b_shape[:-2])
    n, d = a_shape[-2:]
    m = b_shape[-1]
    n_out = math.prod(batch) * n * m
    n_in = math.prod(a_shape) + math.prod(b_shape)
    nbytes = 4 * (2 * n_in + 2 * n_out)
    ops = n_in + 2 * math.prod(batch) * n * d * m + n_out
    return nbytes, ops


def scan_work(t: int, g: int, d: int, m: int, *, has_b: bool,
              a_fixed: bool) -> Tuple[int, int]:
    """The matrix scan over (T, G, d, d) and (T, G, d, m): each input plane
    read once (a stride-0 A once per g), each output plane written once;
    exps of A and of the carry, 2 flops per multiply-add, a log per output,
    and 2 exps and a log more per output for the LSE with B."""
    a_reads = (1 if a_fixed else t) * g * d * d
    outs = t * g * d * m
    n_in = a_reads + (outs if has_b else 0) + g * d * m
    nbytes = 4 * 2 * (n_in + outs)
    ops = a_reads + outs + 2 * t * g * d * d * m + outs + (3 * outs if has_b else 0)
    return nbytes, ops


def diag_work(t: int, c: int) -> Tuple[int, int]:
    """The diagonal scan over (T, C): a and b read once (log and sign, 16 B),
    the states written once (8 B) per element, x0 read once (8 B) per
    channel; some ten f32 operations per element (two exps, a log, adds, a
    max)."""
    return 24 * t * c + 8 * c, 10 * t * c


def kernel_bound(nbytes: float, ops: float) -> Tuple[float, str]:
    """(bound ms, bound_by): the larger of the bytes over HBM_BW and the f32
    operations over F32_FLOPS."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _broadcast(a: Sequence[int], b: Sequence[int]) -> Tuple[int, ...]:
    n = max(len(a), len(b))
    a = (1,) * (n - len(a)) + tuple(a)
    b = (1,) * (n - len(b)) + tuple(b)
    return tuple(y if x == 1 else x for x, y in zip(a, b))
