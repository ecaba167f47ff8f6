"""goomcheck for the port (src/repro_torch/analysis), held to JAX's goomcheck.

The bad corpus under tests/fixtures/goomcheck_torch/bad mirrors JAX's
tests/fixtures/goomcheck/bad file for file; expected lines are located by
searching the fixture source for the triggering expression.  JAX's
``repro.analysis`` is imported here only, as the reference: the same rule
catalog, the same rule ids on each fixture (plus GC105, which JAX 0.9's
walker no longer sees), and the same files holding suppressed GC202s.
"""

import ast
import inspect
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import RULES as JAX_RULES
from repro.analysis import analyze_repo as jax_analyze_repo
from repro.analysis import rules_ast as jax_rules_ast
from repro.analysis.targets import run_module_traces as jax_module_traces
from repro_torch.analysis import (RULES, analyze_paths, analyze_repo,
                                  check_registry, format_text, repo_root,
                                  run_repo_targets, to_json)
from repro_torch.analysis.targets import ENGINE_SHAPES, port_locator
from repro_torch.models.model import DecoderLM

TESTS = pathlib.Path(__file__).parent
_HERE = pathlib.Path(__file__).name
FIXTURES = TESTS / "fixtures" / "goomcheck_torch"
BAD = FIXTURES / "bad"
GOOD = FIXTURES / "good"
JAX_BAD = TESTS / "fixtures" / "goomcheck" / "bad"


@pytest.fixture(scope="module")
def bad_result():
    return analyze_paths([BAD])


@pytest.fixture(scope="module")
def repo_result():
    """The live repo, traced once for the module."""
    return analyze_repo()


def _line(path: pathlib.Path, needle: str) -> int:
    """1-indexed line of the first line of ``path`` containing ``needle``."""
    for i, text in enumerate(path.read_text().splitlines(), start=1):
        if needle in text:
            return i
    raise AssertionError(f"{path}: no line contains {needle!r}")


def test_catalog_matches_jax():
    assert list(RULES) == list(JAX_RULES)
    layer = {"jaxpr": "graph", "ast": "ast"}
    for rid, rule in RULES.items():
        ref = JAX_RULES[rid]
        assert (rule.severity, rule.title, rule.layer) == \
            (ref.severity, ref.title, layer[ref.layer]), rid


# one (rule, fixture, triggering expression) triple per reproducer
CASES = [
    ("GC101", "gc101.py", "torch.exp(x)"),
    ("GC102", "gc102.py", ".to(torch.bfloat16)"),
    ("GC103", "gc103.py", "torch.log(x)"),
    ("GC104", "gc104.py", "torch.sum(p)"),
    ("GC105", "gc105.py", "x.sum().item()"),
    ("GC201", "gc201.py", "goom_ops.BlockConfig("),
    ("GC201", "gc201.py", "matmul=cfg"),
    ("GC202", "gc202.py", "torch.exp(x)"),
    ("GC202", "gc202.py", "x.log_()"),
    ("GC203", "gc203.py", "if torch.cuda.is_available()"),
    ("GC204", "serve/scheduler.py", "time.monotonic()"),
    ("GC206", "serve/scheduler.py", "pending.cpu()"),
    ("GC206", "serve/scheduler.py", "tokens.tolist()"),
    ("GC206", "serve/scheduler.py", "int(first.item())"),
    ("GC206", "serve/steps.py", "block.numpy()"),
]


@pytest.mark.parametrize("rule,rel,needle", CASES,
                         ids=[f"{r}-{n}" for r, _, n in CASES])
def test_bad_fixture_triggers_rule(bad_result, rule, rel, needle):
    active = {f.key() for f in bad_result.findings if not f.suppressed}
    assert (rule, rel, _line(BAD / rel, needle)) in active, \
        format_text(bad_result, verbose=True)


def test_bad_corpus_has_no_skips_and_fails_ci(bad_result):
    assert bad_result.skips == []
    assert not bad_result.ok
    # every graph finding has a real line of its fixture
    graph = [f for f in bad_result.findings if RULES[f.rule].layer == "graph"]
    assert graph and all(f.file != "<unknown>" and f.line > 0 for f in graph)
    assert all(f.target.startswith(f.file + ":") for f in graph)


# ---------------------------------------------------------------------------
# the same rules fire on each fixture as JAX's goomcheck gives today
# ---------------------------------------------------------------------------
_JAX_FIXTURES = sorted(p.relative_to(JAX_BAD).as_posix() for p in JAX_BAD.rglob("*.py"))


@pytest.fixture(scope="module")
def jax_by_fixture():
    """{fixture: findings} from JAX's goomcheck, each fixture traced alone
    (JAX's dedup would merge two fixtures' GC101s at ``<unknown>:0``)."""
    out = {rel: [] for rel in _JAX_FIXTURES}
    for rel in _JAX_FIXTURES:
        path = JAX_BAD / rel
        out[rel].extend(jax_rules_ast.run_source(path.read_text(), rel))
        traced, skips = jax_module_traces(path, rel)
        assert skips == [], skips
        out[rel].extend(traced)
    return out


def test_corpora_mirror_each_other():
    port = sorted(p.relative_to(BAD).as_posix() for p in BAD.rglob("*.py"))
    assert port == _JAX_FIXTURES
    good = sorted(p.relative_to(GOOD).as_posix() for p in GOOD.rglob("*.py"))
    jax_good = TESTS / "fixtures" / "goomcheck" / "good"
    assert good == sorted(p.relative_to(jax_good).as_posix() for p in jax_good.rglob("*.py"))
    assert not any(p.name.startswith("test_") for p in FIXTURES.rglob("*.py"))
    for rel in port:   # each docstring names the fixture it mirrors
        assert f"tests/fixtures/goomcheck/bad/{rel}" in (BAD / rel).read_text(), rel


@pytest.mark.parametrize("rel", _JAX_FIXTURES)
def test_fixture_rule_ids_match_jax(bad_result, jax_by_fixture, rel):
    ref = jax_by_fixture[rel]
    mine = [f for f in bad_result.findings if f.file == rel]
    extra = {"GC105"} if rel == "gc105.py" else set()
    assert {f.rule for f in mine} == {f.rule for f in ref} | extra, \
        format_text(bad_result, verbose=True)
    # graph findings: the same (rule, trace target) as JAX's, at the port's
    # own lines where JAX's say <unknown>:0
    assert {(f.rule, f.target) for f in mine if f.target} == \
        {(f.rule, f.target) for f in ref if f.target} | \
        {(r, "gc105.py:chatty") for r in extra}
    assert all(f.line > 0 for f in mine)


def test_gc105_is_silent_in_jax_and_fires_in_the_port(bad_result, jax_by_fixture):
    assert not any(f.rule == "GC105" for f in jax_by_fixture["gc105.py"])
    assert [(f.rule, f.line) for f in bad_result.findings if f.file == "gc105.py"] == \
        [("GC105", _line(BAD / "gc105.py", "x.sum().item()"))]


def test_gc205_registry_completeness():
    tests_dir = repo_root() / "tests"
    # built by concatenation so this file's own text can't satisfy the
    # "some test names the op" check
    phantom = "zz_" + "phantom_op"
    findings = check_registry(
        ["lmme", phantom], [("lmme", "torch_reference")], tests_dir)
    assert [f.rule for f in findings] == ["GC205", "GC205"]
    assert all(phantom in f.message for f in findings)
    # an op with a cuda impl only has no oracle
    findings = check_registry(["lmme"], [("lmme", "cuda")], tests_dir)
    assert [(f.rule, f.file) for f in findings] == [("GC205", "kernels/dispatch.py")]
    assert "torch_reference" in findings[0].message

    # the real registry is complete (the repo-mode half of the rule)
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.blocks import OPS

    assert len(dispatch.registered_impls()) == 8
    assert check_registry(OPS, dispatch.registered_impls(), tests_dir) == []


def test_every_rule_has_a_triggering_fixture(bad_result):
    triggered = {f.rule for f in bad_result.findings}
    triggered |= {f.rule for f in check_registry(
        ["zz_" + "phantom_op"], [], repo_root() / "tests")}
    assert triggered >= set(RULES), sorted(set(RULES) - triggered)


# ---------------------------------------------------------------------------
# suppression semantics
# ---------------------------------------------------------------------------
def test_suppression_is_line_and_rule_scoped(bad_result):
    # gc104.py suppresses exactly the GC101 at its exp site; the GC202 on
    # the same line and the GC104 on the next line stay active
    sup = [(f.rule, f.file) for f in bad_result.findings if f.suppressed]
    assert sup == [("GC101", "gc104.py")]
    active = {f.key() for f in bad_result.active}
    exp_line = _line(BAD / "gc104.py", "torch.exp(x)")
    assert ("GC202", "gc104.py", exp_line) in active
    assert ("GC104", "gc104.py", exp_line + 1) in active


def test_suppression_comment_must_name_the_rule(tmp_path):
    src = ("import torch\n"
           "\n"
           "# goomcheck: disable=GC203\n"
           "x = torch.exp(torch.ones(1))\n")
    f = tmp_path / "m.py"
    f.write_text(src)
    res = analyze_paths([f], trace=False)
    assert [(x.rule, x.suppressed) for x in res.findings] == [("GC202", False)]

    # naming the right rule on the line above suppresses it
    f.write_text(src.replace("GC203", "GC202"))
    res = analyze_paths([f], trace=False)
    assert [(x.rule, x.suppressed) for x in res.findings] == [("GC202", True)]

    # disable=all works too; a bare "disable" names nothing
    f.write_text(src.replace("disable=GC203", "disable=all"))
    res = analyze_paths([f], trace=False)
    assert res.ok and res.findings[0].suppressed
    f.write_text(src.replace("disable=GC203", "disable"))
    assert not analyze_paths([f], trace=False).ok


def test_good_corpus_is_clean():
    res = analyze_paths([GOOD])
    assert res.skips == []
    assert res.ok, format_text(res, verbose=True)
    # the corpus' one exp site is justified-and-suppressed, not absent
    assert [(f.rule, f.suppressed) for f in res.findings] == [("GC202", True)]
    assert [t["name"] for t in res.targets] == ["clean.py:rescaled_exp",
                                                "clean.py:guarded_log"]


def test_gc206_exempts_host_data_and_the_transfer_buffer():
    from repro_torch.analysis import run_source

    src = ("import numpy as np\n"
           "def admit(req, dev_ids):\n"
           "    prompt = np.asarray(req.prompt, np.int64).reshape(-1)\n"
           "    a = prompt.tolist()\n"
           "    b = dev_ids.tolist()\n"
           "    ids = np.asarray(req.prompt)\n"
           "    return a, b, ids.tolist(), bool(dev_ids.any().item())\n"
           "class _TokenFlight:\n"
           "    def take(self, x):\n"
           "        return int(x.item()), x.cpu().numpy()\n")
    found = [(f.rule, f.line) for f in run_source(src, "serve/scheduler.py")]
    assert found == [("GC206", 5), ("GC206", 7), ("GC206", 7)]
    assert run_source(src, "serve/engine.py") == []   # out of the rule's scope


# ---------------------------------------------------------------------------
# the graph walker's rules on small graphs
# ---------------------------------------------------------------------------
def _demote_copy(x):
    buf = torch.empty(x.shape, dtype=torch.bfloat16)
    buf.copy_(x)   # walker: GC102
    return buf


def _exp_then_mm(x):
    p = torch.exp(x)   # walker: GC101
    return p @ p.T   # walker: GC104


def _exp_then_cumsum(x):
    p = torch.exp(x)   # walker: GC101
    return torch.cumsum(p, 0)   # walker: GC104


def _rescaled_through_where(x):
    """lmme_reference's pattern: the max survives detach and where."""
    m = x.amax(dim=-1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.exp(x - m).sum(-1)


def _rescaled_by_another_max(x, y):
    return torch.exp(x - y.amax())   # walker: GC101


def _nonzero(x):
    return torch.nonzero(x > 0)   # walker: GC105


def _wrapped(x):
    from repro_torch.core.goom import safe_log, signed_exp

    return signed_exp(safe_log(x), torch.ones_like(x))


def _in_place_log(x):
    return x.clone().log_()   # walker: GC103


WALKS = [
    (_demote_copy, ("log",), {"GC102"}),
    (_exp_then_mm, ("log",), {"GC101", "GC104"}),
    (_exp_then_cumsum, ("log",), {"GC101", "GC104"}),
    (_rescaled_through_where, ("log",), set()),
    (_rescaled_by_another_max, ("log", "log"), {"GC101"}),
    (_nonzero, ("linear",), {"GC105"}),
    (_wrapped, ("linear",), set()),
    (_in_place_log, ("linear",), {"GC103"}),
]


@pytest.mark.parametrize("fn,domains,rules", WALKS, ids=[w[0].__name__ for w in WALKS])
def test_walker_rules(fn, domains, rules):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import TokenSource, trace_and_walk
    from repro_torch.analysis.lattice import seed_from_spec

    tokens = TokenSource()
    with FakeTensorMode():
        args = [torch.empty(4, 4) for _ in domains]
        seeds = [(a, seed_from_spec(d, tokens)) for a, d in zip(args, domains)]
        walk = trace_and_walk(fn, args, seeds, target=fn.__name__,
                              locate=port_locator(TESTS), tokens=tokens)
    assert walk.error is None, walk.error
    assert {f.rule for f in walk.findings} == rules
    src, first = inspect.getsourcelines(fn)
    marked = {first + i for i, text in enumerate(src) if "# walker:" in text}
    assert {f.line for f in walk.findings} == marked
    assert all(f.file == _HERE for f in walk.findings)


# ---------------------------------------------------------------------------
# CLI exit codes
# ---------------------------------------------------------------------------
def _run_cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo_root() / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        capture_output=True, text=True, env=env, cwd=repo_root())


def test_cli_bad_corpus_exits_nonzero(tmp_path):
    out = tmp_path / "findings.json"
    r = _run_cli(str(BAD), "--ci", "--json", str(out))
    assert r.returncode == 1, r.stdout + r.stderr
    data = json.loads(out.read_text())
    assert data["ok"] is False and data["findings"] and data["skips"] == []
    assert "device=cpu" in r.stdout


def test_cli_good_corpus_exits_zero():
    r = _run_cli(str(GOOD), "--ci", "--no-trace")
    assert r.returncode == 0, r.stdout + r.stderr


def test_device_cuda_without_a_card_raises():
    from repro_torch.kernels import dispatch

    if dispatch.current_platform() == "cuda":
        pytest.skip("this machine has a card: --device cuda runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_paths([GOOD], device="cuda")


# ---------------------------------------------------------------------------
# the live repo
# ---------------------------------------------------------------------------
def test_live_repo_is_goomcheck_clean(repo_result):
    res = repo_result
    assert res.skips == [], res.skips
    assert res.ok, format_text(res)
    data = json.loads(to_json(res))
    targets = {t["name"]: t for t in data["targets"]}
    engine = [f"{op}/{b}" for op in ENGINE_SHAPES for b in ("torch_reference", "cuda")]
    models = [f"{a}/{e}/{b}" for a in ("goom-rnn-124m", "olmo-1b")
              for e in ("decode_step", "prefill") for b in ("torch_reference", "cuda")]
    assert sorted(targets) == sorted(engine + models)
    # a walker that sees nothing cannot pass
    for name, t in targets.items():
        assert t["ops"] > 0, name
        if name.startswith("olmo-1b/"):     # attention only: no GOOM op
            assert t["kernel_steps"] == 0, name
            # the prefill's flash attention keeps each row's LSE (safe_log,
            # as JAX's); decode has no log value
            assert (t["log_values"] > 0) == ("/prefill/" in name), name
            continue
        assert t["log_values"] > 0, name
        if name.endswith("/cuda"):
            assert t["kernel_steps"] > 0, name
        else:
            assert t["kernel_steps"] == 0, name


def test_suppressed_gc202_files_match_jax(repo_result):
    mine = {f.file for f in repo_result.findings if f.suppressed and f.rule == "GC202"}
    ref = jax_analyze_repo(trace=False)
    theirs = {f.file for f in ref.findings if f.suppressed and f.rule == "GC202"}
    assert mine == theirs == {"core/chains.py", "models/attention.py",
                              "models/rope.py", "models/ssm.py"}
    assert {f.rule for f in repo_result.findings} == {"GC202"}


# ---------------------------------------------------------------------------
# mutations of the real goom-rnn-124m decode target
# ---------------------------------------------------------------------------
def _raw_scaled_exp(a, dim=None, shift=2.0):
    vals = torch.exp(a.log_abs) * a.sign   # mutation: an un-rescaled exp
    return vals, None


def _decode_with_item(self, token, caches, index, mrope_positions=None):
    _ = index.max().item()   # mutation: a host read
    return _ORIG_DECODE(self, token, caches, index, mrope_positions)


_ORIG_DECODE = DecoderLM.decode_step


def _decode_findings(rule):
    findings, skips, _ = run_repo_targets(archs=("goom-rnn-124m",),
                                          locate=port_locator(TESTS))
    assert skips == []
    return {(f.file, f.line, f.target) for f in findings if f.rule == rule}


def test_mutation_raw_exp_is_gc101(monkeypatch):
    from repro_torch.models import goom_layer

    monkeypatch.setattr(goom_layer, "scaled_exp", _raw_scaled_exp)
    line = inspect.getsourcelines(_raw_scaled_exp)[1] + 1
    hits = _decode_findings("GC101")
    for backend in ("torch_reference", "cuda"):
        assert (_HERE, line, f"goom-rnn-124m/decode_step/{backend}") in hits, hits


def test_mutation_item_is_gc105(monkeypatch):
    monkeypatch.setattr(DecoderLM, "decode_step", _decode_with_item)
    line = inspect.getsourcelines(_decode_with_item)[1] + 1
    hits = _decode_findings("GC105")
    assert hits == {(_HERE, line, f"goom-rnn-124m/decode_step/{b}")
                    for b in ("torch_reference", "cuda")}


# ---------------------------------------------------------------------------
# the package stands alone; the repairs hold the port to JAX
# ---------------------------------------------------------------------------
def test_analysis_imports_no_jax_and_no_repro():
    pkg = repo_root() / "src" / "repro_torch" / "analysis"
    files = sorted(pkg.glob("*.py"))
    assert len(files) == 9
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path.name, n)


def test_autotune_reads_the_platform_through_dispatch():
    src = (repo_root() / "src" / "repro_torch" / "kernels" / "autotune.py").read_text()
    assert "torch.cuda.is_available" not in src


def test_goom_log_norm_matches_jax_after_safe_log():
    from repro.core import chains as jchains
    from repro.core.goom import safe_log as jsafe_log
    from repro_torch.core import chains
    from repro_torch.core.goom import to_goom

    key = jax.random.PRNGKey(3)
    d = 16
    k0, _ = jax.random.split(key)   # goom_chain's S_0, which 0 steps return
    s0 = np.asarray(jax.random.normal(k0, (d, d), jnp.float32))
    ref = float(jchains.goom_chain(key, d, 0).final_log_norm)
    got = float(chains.goom_log_norm(to_goom(torch.tensor(s0))))
    np.testing.assert_allclose(got, ref, rtol=1e-6)

    gen = torch.Generator().manual_seed(5)
    res = chains.float_chain_survival(gen, d, 0, device="cpu")
    s = torch.randn((d, d), generator=torch.Generator().manual_seed(5))
    want = float(jsafe_log(jnp.sqrt(jnp.sum(jnp.square(jnp.asarray(s.numpy()))))))
    assert res.steps_survived == 0
    np.testing.assert_allclose(res.final_log_norm, want, rtol=1e-6)
