"""AST layer: architectural lint rules (GC201-GC206) in torch's names.

The port's copy of ``repro/analysis/rules_ast.py``.  Rules are scoped by
*relative path* (posix), so the same visitor serves both repo mode (paths
relative to ``src/repro_torch``) and fixture-corpus mode (paths relative to
the corpus root: a fixture at ``bad/serve/scheduler.py`` exercises the
scheduler-only GC204 rule).
"""

from __future__ import annotations

import ast
import pathlib
from typing import Iterable, List, Sequence, Set, Tuple

from .registry import RULES
from .report import Finding

__all__ = ["run_ast_rules", "run_source", "check_registry",
           "BLOCK_KWARGS", "RAW_LOGEXP", "HOST_PULLS"]

BLOCK_KWARGS = frozenset({
    "matmul", "block_t", "block_c", "block_n", "block_m", "block_d",
    "num_warps", "num_stages",
})
RAW_LOGEXP = frozenset({"log", "exp", "log1p", "expm1"})
# method-call roots that are host math, not tensors: np.exp(x), math.log(x)
_HOST_ROOTS = frozenset({"math", "np", "numpy"})
# GC206: the calls that pull a device value to the host (or wait for one)
HOST_PULLS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})

# GC201: block/tile plumbing may only be named here
_BLOCK_ALLOWED = ("core/engine.py", "core/scan.py")
# GC202: the log/exp substrate (safety is checked by the graph layer)
_LOGEXP_ALLOWED = ("core/goom.py", "core/ops.py", "core/scan.py")
# GC203: the single sanctioned torch.cuda.is_available() read
_BACKEND_ALLOWED = ("kernels/dispatch.py",)
# GC204: only applies to the scheduler; only this function may read the clock
_SCHEDULER_SUFFIX = "serve/scheduler.py"
_CLOCK_GUARD = "_deadline_clock"
# GC206: host pulls in the serve hot loop may only live in the transfer
# buffer (async double-buffered device->host lane)
_HOTLOOP_SUFFIXES = ("serve/scheduler.py", "serve/steps.py")
_SYNC_GUARD_CLASS = "_TokenFlight"


def _in_kernels(rel: str) -> bool:
    return rel.startswith("kernels/") or "/kernels/" in rel


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.findings: List[Finding] = []
        self._func_stack: List[str] = []
        self._class_stack: List[str] = []
        self._host_names: List[Set[str]] = [set()]
        self.check_blocks = not (_in_kernels(rel) or rel in _BLOCK_ALLOWED)
        self.check_logexp = not (_in_kernels(rel) or rel in _LOGEXP_ALLOWED)
        self.check_backend = rel not in _BACKEND_ALLOWED
        self.check_clock = rel.endswith(_SCHEDULER_SUFFIX)
        self.check_sync = rel.endswith(_HOTLOOP_SUFFIXES)
        self._sync_reported: set = set()  # inner pulls covered by a wrapper

    def _emit(self, rule: str, node: ast.AST, message: str):
        self.findings.append(Finding(
            rule=rule, file=self.rel, line=getattr(node, "lineno", 0),
            message=message, severity=RULES[rule].severity))

    # -- function/class context (for the GC204 / GC206 guards) ---------------
    def visit_FunctionDef(self, node):
        self._func_stack.append(node.name)
        self._host_names.append(_host_bound_names(node))
        self.generic_visit(node)
        self._host_names.pop()
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    # -- calls ---------------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        func = node.func
        if self.check_blocks:
            name = func.id if isinstance(func, ast.Name) else (
                func.attr if isinstance(func, ast.Attribute) else None)
            if name == "BlockConfig":
                self._emit("GC201", node,
                           "BlockConfig(...) literal outside kernels/")
            else:
                for kw in node.keywords:
                    if kw.arg in BLOCK_KWARGS:
                        self._emit("GC201", kw.value,
                                   f"`{kw.arg}=` keyword outside kernels/ "
                                   "(use engine.use_blocks / the autotune "
                                   "cache)")
        if self.check_logexp and isinstance(func, ast.Attribute):
            what = _raw_logexp(func)
            if what is not None:
                self._emit("GC202", node,
                           f"raw {what} outside core/goom.py and kernels/ "
                           "(use safe_log/signed_exp, or suppress with a "
                           "justification if max-rescaled)")
        if self.check_backend and _is_cuda_available(func):
            self._emit("GC203", node,
                       "torch.cuda.is_available() outside dispatch."
                       "current_platform (the cached single read)")
        if self.check_clock and isinstance(func, ast.Attribute):
            if (func.attr == "monotonic"
                    and isinstance(func.value, ast.Name)
                    and func.value.id == "time"
                    and _CLOCK_GUARD not in self._func_stack):
                self._emit("GC204", node,
                           "time.monotonic() outside the _deadline_clock "
                           "guard in serve/scheduler.py")
        if self.check_sync and _SYNC_GUARD_CLASS not in self._class_stack:
            host = self._host_names[-1]
            # int(x.item()) / float(x.cpu()): one finding at the wrapper,
            # and the inner pull is marked as already reported
            if (isinstance(func, ast.Name) and func.id in ("int", "float", "bool")
                    and len(node.args) == 1
                    and _is_device_pull(node.args[0], host)):
                self._sync_reported.add(id(node.args[0]))
                self._emit("GC206", node,
                           f"{func.id}(...) host-syncs a device value in "
                           "the serve hot loop: route materialization "
                           "through the _TokenFlight transfer buffer")
            elif _is_device_pull(node, host) and id(node) not in self._sync_reported:
                self._emit("GC206", node,
                           f".{func.attr}() host-syncs a device value in the "
                           "serve hot loop: route materialization through "
                           "the _TokenFlight transfer buffer (host-side data "
                           "is built with np.asarray(x, dtype))")
        self.generic_visit(node)


def _raw_logexp(func: ast.Attribute):
    """``torch.exp`` -> "torch.exp"; ``x.exp()`` / ``x.log_()`` -> ".exp()" /
    ".log_()"; host math (``math.log``, ``np.exp``) -> None."""
    attr = func.attr
    base = attr[:-1] if attr.endswith("_") else attr
    if base not in RAW_LOGEXP:
        return None
    root = func.value
    if isinstance(root, ast.Name):
        if root.id == "torch" and attr == base:
            return f"torch.{attr}"
        if root.id in _HOST_ROOTS:
            return None
    return f".{attr}()"


def _is_cuda_available(func: ast.AST) -> bool:
    return (isinstance(func, ast.Attribute) and func.attr == "is_available"
            and isinstance(func.value, ast.Attribute) and func.value.attr == "cuda"
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "torch")


def _is_np(node: ast.AST) -> bool:
    """np / numpy roots (host numpy)."""
    return isinstance(node, ast.Name) and node.id in ("np", "numpy")


def _is_host_array(node: ast.AST) -> bool:
    """``np.asarray(x, dtype)`` (or ``np.array``), possibly followed by a
    method chain (``.reshape(-1)``): host data, built with an explicit
    dtype, which no tensor method can be called on."""
    while isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        func = node.func
        if _is_np(func.value) and func.attr in ("asarray", "array"):
            return len(node.args) >= 2 or any(k.arg == "dtype" for k in node.keywords)
        node = func.value
    return False


def _host_bound_names(fn: ast.AST) -> Set[str]:
    """Names a function binds from :func:`_is_host_array` (and nothing
    else): their ``.tolist()`` is a numpy call, not a device pull."""
    bound: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            host = _is_host_array(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bound[t.id] = bound.get(t.id, True) and host
    return {n for n, host in bound.items() if host}


def _is_device_pull(node: ast.AST, host_names: Set[str]) -> bool:
    """A call that blocks on a device->host transfer: ``x.item()``,
    ``x.tolist()``, ``x.cpu()``, ``x.numpy()``, ``x.synchronize()``, unless
    ``x`` is a name bound from host data in the same function."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    func = node.func
    if func.attr not in HOST_PULLS:
        return False
    return not (isinstance(func.value, ast.Name) and func.value.id in host_names)


def run_source(source: str, rel: str) -> List[Finding]:
    """Run the AST rules over one file's source (``rel`` scopes the rules)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding(rule="GC200", file=rel, line=e.lineno or 0,
                        message=f"syntax error: {e.msg}")]
    v = _Visitor(rel)
    v.visit(tree)
    return v.findings


def run_ast_rules(files: Iterable[Tuple[pathlib.Path, str]]) -> List[Finding]:
    """Run AST rules over ``(absolute path, relative posix path)`` pairs."""
    out: List[Finding] = []
    for path, rel in files:
        out.extend(run_source(path.read_text(), rel))
    return out


# ---------------------------------------------------------------------------
# GC205: registry completeness (not a per-file syntactic rule)
# ---------------------------------------------------------------------------
def check_registry(
    ops: Sequence[str],
    impls: Iterable[Tuple[str, str]],
    tests_dir: pathlib.Path,
    *,
    file: str = "kernels/dispatch.py",
) -> List[Finding]:
    """Every op needs a ``torch_reference`` impl and a ``test_torch_*.py``
    that names it.

    Parameterized (ops / impls / tests_dir are injected) so a test can
    trigger the rule against a synthetic registry.
    """
    impls = set(impls)
    findings = []
    test_texts = None
    for op in ops:
        if (op, "torch_reference") not in impls:
            findings.append(Finding(
                rule="GC205", file=file, line=1, severity="error",
                message=f"op {op!r} has no torch_reference implementation "
                        "(the numerical oracle every backend is tested "
                        "against)"))
        if test_texts is None:
            test_texts = "\n".join(
                p.read_text() for p in sorted(tests_dir.glob("test_torch_*.py"))
            ) if tests_dir.is_dir() else ""
        if op not in test_texts:
            findings.append(Finding(
                rule="GC205", file=file, line=1, severity="error",
                message=f"op {op!r} is referenced by no test_torch_*.py under "
                        f"{tests_dir.name}/"))
    return findings
