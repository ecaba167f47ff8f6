"""The goomcheck rule catalog of the port.

The port's copy of ``repro/analysis/registry.py``: the same rule ids,
severities and titles, described in torch's names.  GC1xx rules run in the
**graph layer** (``graph_walker``): an abstract interpreter over the aten
ops that the port's code dispatches on fake tensors, propagating a
per-value lattice (``lattice.py``).  GC2xx rules run in the **AST layer**
(``rules_ast``) over ``src/repro_torch/**``.

Every rule here must have at least one triggering fixture under
``tests/fixtures/goomcheck_torch/bad`` (``tests/test_torch_analysis.py``
holds it to that).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["Rule", "RULES"]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    layer: str      # "graph" | "ast"
    severity: str   # "error" | "warning"
    title: str
    description: str


_CATALOG = [
    # -- graph layer (numerical safety) -------------------------------------
    Rule("GC101", "graph", "error", "exp-escape",
         "aten.exp applied to a log-space magnitude with no dominating "
         "max-subtraction: the value escapes GOOM space and can overflow "
         "(GOOMs remove overflow; a raw exp reintroduces it)."),
    Rule("GC102", "graph", "error", "log-demote",
         "a log-space value is cast to a narrower float (f32->bf16/f16, by "
         "aten._to_copy, a copy_ into a narrower tensor or autocast): "
         "log-space carries need the full f32 mantissa; demotion silently "
         "truncates magnitudes."),
    Rule("GC103", "graph", "error", "raw-log",
         "aten.log outside the safe_log autograd function: log(0) = -inf "
         "and d/dx log = 1/x blow up; core.goom.safe_log floors the value "
         "and redefines the derivative (paper eq. 6)."),
    Rule("GC104", "graph", "warning", "unrescaled-reduction",
         "a reduction (sum / mm / bmm / addmm / cumsum) over linear values "
         "produced by exp of an unrescaled log magnitude: this bypasses the "
         "max-rescaled LMME/LSE monoid and overflows first at the "
         "reduction (usually paired with a GC101 at the exp site)."),
    Rule("GC105", "graph", "error", "impure-hot-path",
         "a host read inside a traced hot path: aten._local_scalar_dense "
         "(.item(), int()/float()/bool() of a tensor), an op whose output "
         "shape depends on the data (nonzero, masked_select, unique), or a "
         "copy from the card to the CPU: host round-trips stall the "
         "dispatch-only serving loop."),
    # -- AST layer (architecture invariants) --------------------------------
    Rule("GC201", "ast", "error", "block-literal",
         "matmul= / block-size keyword or BlockConfig(...) literal outside "
         "kernels/ (+ the engine/scan plumbing): tile sizes reach call "
         "sites only via the engine's use_blocks overrides and the "
         "autotune cache."),
    Rule("GC202", "ast", "error", "raw-log-exp",
         "raw torch.log/torch.exp/torch.log1p/torch.expm1 (or the tensor "
         "method and in-place forms, x.exp(), x.log_()) outside "
         "core/goom.py, core/ops.py, core/scan.py and kernels/: "
         "application code must go through safe_log/signed_exp or a "
         "max-rescaled local pattern (suppress with a justification where "
         "the rescale is manifest)."),
    Rule("GC203", "ast", "error", "default-backend",
         "torch.cuda.is_available() outside kernels/dispatch.py: the "
         "platform is read once per process through the cached "
         "current_platform(); per-call reads make dispatch depend on "
         "where they are made."),
    Rule("GC204", "ast", "error", "monotonic-outside-guard",
         "time.monotonic() in serve/scheduler.py outside _deadline_clock: "
         "the scheduler's hot loop is dispatch-only; every clock read must "
         "route through the deadline guard's single helper."),
    Rule("GC205", "ast", "error", "registry-incomplete",
         "an engine op is missing its torch_reference registration or has "
         "no test referencing it: every op in kernels/blocks.py OPS needs "
         "a reference impl (the numerical oracle) and test coverage."),
    Rule("GC206", "ast", "error", "host-sync-outside-flight",
         "a blocking device->host pull (.item(), .tolist(), .cpu(), "
         ".numpy(), .synchronize(), or int()/float()/bool() of one) in "
         "serve/scheduler.py or serve/steps.py outside the _TokenFlight "
         "transfer buffer: the decode loop is dispatch-only, and every "
         "materialization routes through the async double-buffered lane "
         "so streaming never blocks a dispatch."),
]

RULES: Dict[str, Rule] = {r.id: r for r in _CATALOG}
