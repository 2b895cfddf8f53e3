"""PyTorch port: graftlint (``deeplearning4j_tpu_torch/analysis``) against
the JAX package's analyzer, on the CPU.

- Fixture parity: every lock-discipline, lock-order, blocking-under-lock,
  wait-discipline and thread-tracking fixture of
  ``tests/test_analysis_lint.py``, its GL013 sharding fixtures, its
  metric-naming fixtures, its GL007 fixtures outside jitted code, and its
  suppression and baseline fixtures, read from that file's source, go
  through both linters; the findings' (rule, line, function) sets are
  equal. In the suppression fixtures JAX's trace markers (``@jax.jit``,
  ``# graftlint: traced``) become the port's ``# graftlint: hot``, line
  for line.
- Tree parity: GL006 and GL009-GL012 over the port's own tree give the
  same findings in both linters.
- The torch rules (hot context, GL001-GL004, GL007, GL008, GL013-GL016)
  on positive and negative fixtures; the cache and the CLI.
- The port's gate: nothing beyond the port's baseline; the remote tier's
  two modules without a finding.
- LockAudit (the JAX package's five cases on the port's copy),
  TransferAudit (the same per-tag report as JAX's over the same
  requests) and CompileAudit (through ``kernels/cuda_lib.py``'s
  recording seam; nothing is built here).
- Queue A12's four names and the package re-exports.

Each linter's run over the port's tree is computed once a module."""

import ast
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import typing
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu.analysis import lint as jax_lint
from deeplearning4j_tpu_torch.analysis import (CompileAudit,
                                               CompileBudgetError,
                                               LockAudit, LockOrderError,
                                               TransferAudit,
                                               TransferBudgetError,
                                               collect_package_facts,
                                               lint_paths, load_baseline,
                                               new_findings, write_baseline)
from deeplearning4j_tpu_torch.analysis import lint as port_lint
from deeplearning4j_tpu_torch.analysis.concurrency import lock_order_edges

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "deeplearning4j_tpu_torch"
TREE = [str(PORT), str(ROOT / "chip_smoke.py")]
TREE_RULES = ["GL006", "GL009", "GL010", "GL011", "GL012"]


def _sites(findings):
    return {(f.rule, f.line, f.func) for f in findings}


# ===================================================================
# the JAX package's fixtures, read from its test file
# ===================================================================
JAX_TESTS = ROOT / "tests" / "test_analysis_lint.py"
DEFAULT_REL = "deeplearning4j_tpu/kernels/mod.py"
#: the one multi-file fixture writes its modules into this package dir
MULTI_DIR = "deeplearning4j_tpu/streaming"
#: classes whose fixtures must agree, and which of their fixtures: the
#: GL013 ones of the sharding class, the naming ones (no jax) of the
#: metric class, GL007's outside jitted code
PARITY = {
    "TestLockDisciplineRule": lambda src, rules: True,
    "TestLockOrderRule": lambda src, rules: True,
    "TestBlockingUnderLockRule": lambda src, rules: True,
    "TestWaitDisciplineRule": lambda src, rules: True,
    "TestThreadTrackingRule": lambda src, rules: True,
    "TestShardingRules": lambda src, rules: rules == ["GL013"],
    "TestMetricNamingAndSinkRule": lambda src, rules: "jax" not in src,
    "TestHostLoopSyncRule": lambda src, rules: "@jax" not in src,
    "TestSuppressionAndBaseline": lambda src, rules: True,
}


def _str_value(node, names):
    """A string expression of the fixture file: literal, name, ``+`` or
    ``textwrap.dedent(...)``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return names[node.id]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _str_value(node.left, names) + _str_value(node.right, names)
    if isinstance(node, ast.Call) and \
            getattr(node.func, "attr", None) == "dedent":
        return textwrap.dedent(_str_value(node.args[0], names))
    raise ValueError(ast.dump(node))


def _string_assigns(body, names):
    out = dict(names)
    for n in body:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 and \
                    isinstance(sub.targets[0], ast.Name):
                try:
                    out[sub.targets[0].id] = _str_value(sub.value, out)
                except (ValueError, KeyError):
                    pass
    return out


def _fixtures():
    tree = ast.parse(JAX_TESTS.read_text(encoding="utf-8"))
    names = _string_assigns([n for n in tree.body
                             if isinstance(n, ast.Assign)], {})
    out = []
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in PARITY):
            continue
        for meth in cls.body:
            if not (isinstance(meth, ast.FunctionDef) and
                    meth.name.startswith("test_")):
                continue
            local = _string_assigns(meth.body, names)
            calls = sorted((n for n in ast.walk(meth)
                            if isinstance(n, ast.Call) and
                            getattr(n.func, "id", None) == "_lint_src"),
                           key=lambda n: n.lineno)
            found = []
            for call in calls:
                kw = {k.arg: ast.literal_eval(k.value)
                      for k in call.keywords if k.arg in ("rel", "rules")}
                src = textwrap.dedent(_str_value(call.args[1], local))
                found.append(({kw.get("rel", DEFAULT_REL): src},
                              kw.get("rules")))
            writes = [n for n in ast.walk(meth)
                      if isinstance(n, ast.Call) and
                      getattr(n.func, "attr", None) == "write_text" and
                      isinstance(n.func.value, ast.BinOp) and
                      isinstance(n.func.value.right, ast.Constant) and
                      str(n.func.value.right.value).endswith(".py")]
            linted = [n for n in ast.walk(meth)
                      if isinstance(n, ast.Call) and
                      getattr(n.func, "id", None) == "lint_paths"]
            if writes and linted and not calls:
                files = {f"{MULTI_DIR}/{w.func.value.right.value}":
                         _str_value(w.args[0], local) for w in writes}
                rules = next((ast.literal_eval(k.value)
                              for k in linted[0].keywords
                              if k.arg == "rules"), None)
                found.append((files, rules))
            for i, (files, rules) in enumerate(found):
                if PARITY[cls.name]("".join(files.values()), rules):
                    out.append(pytest.param(
                        files, rules, cls.name == "TestSuppressionAndBaseline",
                        id=f"{cls.name}.{meth.name}[{i}]"))
    return out


FIXTURES = _fixtures()


def _as_hot(src: str) -> str:
    """JAX's trace markers → the port's hot marker, line for line."""
    lines = []
    for line in src.split("\n"):
        indent = line[:len(line) - len(line.lstrip())]
        if line.strip() == "@jax.jit":
            line = f"{indent}# graftlint: hot"
        lines.append(line.replace("graftlint: traced", "graftlint: hot"))
    return "\n".join(lines)


def _lint_files(linter, root: Path, files, rules):
    paths = set()
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        paths.add(str(p) if len(files) == 1 else str(p.parent))
    runner = linter.LintRunner(str(root), rules)
    found = runner.lint(sorted(paths))
    assert runner.errors == []
    return found


def test_fixture_set_covers_the_jax_classes():
    """The extraction found every class's fixtures (a renamed helper in
    the JAX test file must not empty the parity set silently)."""
    classes = {p.id.split(".")[0] for p in FIXTURES}
    assert classes == set(PARITY)
    assert len(FIXTURES) >= 55


@pytest.mark.parametrize("files,rules,translate", FIXTURES)
def test_fixture_parity_with_jax_linter(tmp_path, files, rules, translate):
    want = _lint_files(jax_lint, tmp_path / "jax", files, rules)
    port_files = {rel: _as_hot(src) if translate else src
                  for rel, src in files.items()}
    got = _lint_files(port_lint, tmp_path / "port", port_files, rules)
    assert _sites(got) == _sites(want), (got, want)


# ===================================================================
# the port's tree, linted once a module
# ===================================================================
@pytest.fixture(scope="module")
def port_run():
    """(findings, callgraph facts) of the port's linter over the port's
    tree and chip_smoke.py, every rule."""
    runner = port_lint.LintRunner(str(ROOT), force_facts=True)
    found = runner.lint(TREE)
    assert runner.errors == []
    return found, runner.facts


@pytest.fixture(scope="module")
def port_static_edges(port_run):
    return lock_order_edges(port_run[1])


def test_tree_parity_concurrency_and_lock_rules(port_run):
    """GL006 and GL009-GL012 do not depend on the framework: over the
    port's tree both linters report the same sites. The port's pass sees
    more — subprocess waits and device syncs, and module-level locks —,
    and the three loaders that build under such a lock carry reviewed
    notes, which both linters honour."""
    want = jax_lint.LintRunner(str(ROOT), TREE_RULES).lint(TREE)
    got = [f for f in port_run[0] if f.rule in TREE_RULES]
    assert {(f.rule, f.path, f.line, f.func) for f in got} == \
        {(f.rule, f.path, f.line, f.func) for f in want}


def test_port_baseline_is_clean(port_run):
    """The gate: the port's linter over the port's tree has ZERO
    findings beyond ``deeplearning4j_tpu_torch/analysis/baseline.json``."""
    baseline = load_baseline(str(PORT / "analysis" / "baseline.json"))
    fresh = new_findings(port_run[0], baseline)
    assert fresh == [], "\n".join(str(f) for f in fresh)


def test_remote_tier_has_no_finding_in_the_whole_tree(port_run):
    """``test_torch_remote.py::test_remote_module_lint_clean`` lints the
    remote tier's two modules alone; here they are held within the whole
    tree's run, where the package pass also follows calls into them from
    the rest of the port: still zero findings, not zero beyond the
    baseline."""
    tier = {f"deeplearning4j_tpu_torch/streaming/{f}"
            for f in ("remote.py", "tcp_broker.py")}
    found = [f for f in port_run[0] if f.path in tier]
    assert found == [], "\n".join(str(f) for f in found)


def test_analysis_and_cli_import_no_jax():
    files = sorted((PORT / "analysis").glob("*.py")) + \
        [ROOT / "scripts" / "torch_lint.py"]
    assert {p.name for p in files} >= {
        "lint.py", "callgraph.py", "concurrency.py", "sharding.py",
        "lock_audit.py", "compile_audit.py", "__init__.py",
        "torch_lint.py"}
    bad = []
    for p in files:
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            mods = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                and node.level == 0 else []
            bad += [(p.name, m) for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib",
                                           "deeplearning4j_tpu")]
    assert bad == []


def test_same_public_names_as_jax_analysis():
    import deeplearning4j_tpu.analysis as jax_analysis
    import deeplearning4j_tpu_torch.analysis as port_analysis
    assert sorted(port_analysis.__all__) == sorted(jax_analysis.__all__)
    assert set(port_lint.RULES) == set(jax_lint.RULES)


# ===================================================================
# the torch rules
# ===================================================================
def _lint_src(tmp_path, src, rel="deeplearning4j_tpu_torch/kernels/mod.py",
              rules=None):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return lint_paths([str(p)], repo_root=str(tmp_path), rules=rules)


def _rules(findings):
    return sorted({f.rule for f in findings})


_FN = """
    import torch

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, n: int, causal=False):
            {body}
            return x

        @staticmethod
        def backward(ctx, g):
            return g, None, None
"""


def _in_forward(tmp_path, body, rules=None, **kw):
    return _lint_src(tmp_path, _FN.format(body=body), rules=rules, **kw)


@pytest.mark.parametrize("body,rule", [
    ("v = x.item()", "GL001"),
    ("v = x.sum().tolist()", "GL001"),
    ("v = x.detach().cpu()", "GL001"),
    ("v = x.numpy()", "GL001"),
    ("v = float(x.sum())", "GL001"),
    ("v = np.asarray(x)", "GL001"),
    ("torch.cuda.synchronize()", "GL001"),
    ("if x.any(): x = x + 1", "GL003"),
    ("while x.sum() > 0: x = x - 1", "GL003"),
    ("y = x * 2\n        if y.max() > 1: x = y", "GL003"),
    ("x = torch.as_tensor(np.exp(x))", "GL004"),
    ("for i in range(x.shape[0]): x = x + 1", "GL002"),
    ("for i in range(x.size(0)): x = x + 1", "GL002"),
    ("registry.counter('a_total').inc()", "GL008"),
    ("hist.observe(1.0)", "GL008"),
    ("flightrec.record('blk', k=4)", "GL015"),
    ("slo_tracker.observe_request(1.0)", "GL015"),
    ("profiler.record_block(k=1)", "GL016"),
], ids=lambda v: v if isinstance(v, str) and v.startswith("GL") else None)
def test_hot_context_rule_flags(tmp_path, body, rule):
    out = _lint_forward(tmp_path, body)
    assert _rules(out) == [rule], out
    assert out[0].func == "Op.forward"


def _lint_forward(tmp_path, body):
    """Lint ``_FN`` with ``body`` in the Function's forward; the module
    must parse."""
    p = tmp_path / "deeplearning4j_tpu_torch" / "kernels" / "mod.py"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text("import numpy as np\n" +
                 textwrap.dedent(_FN).format(body=body))
    runner = port_lint.LintRunner(str(tmp_path))
    out = runner.lint([str(p)])
    assert runner.errors == []
    return out


@pytest.mark.parametrize("body", [
    "v = device_fetch(x, tag='blk')",          # the sanctioned crossing
    "h = start_fetch(x)",
    "if x is None: return x",
    "if x.shape[0] > 1: x = x[1:]",
    "if x.dtype == torch.bfloat16: x = x.float()",
    "if x.is_cuda and x.requires_grad: x = x * 1",
    "if x.dim() == 3 and len(x) > 2: x = x[0]",
    "if n > 2 and causal: x = x * 2",           # host scalars
    "v = float(n) ** -0.5",
    "d = x.shape[-1]\n        v = float(d) ** -0.5",
    "x = x * np.sqrt(4.0)",
    "for i in range(n): x = x + 1",
    "gauge_like = ev.set()",
    "session.record('frame')",
])
def test_hot_context_negatives(tmp_path, body):
    out = _lint_forward(tmp_path, body)
    assert out == [], out


def test_same_calls_outside_hot_context_are_fine(tmp_path):
    out = _lint_src(tmp_path, """
        import numpy as np
        import torch

        def host(x, registry):
            v = x.item()
            if x.any():
                v = float(x.sum())
            for i in range(x.shape[0]):
                torch.cuda.synchronize()
            registry.counter("a_total").inc()
            return np.exp(x), v
    """, rules=["GL001", "GL002", "GL003", "GL004", "GL008"])
    assert out == []


def test_hot_marker_and_nesting(tmp_path):
    """``# graftlint: hot`` opts a method in (above its decorators too),
    and a def nested in hot context is hot (reported under its root, as
    the JAX linter reports nested traced defs)."""
    out = _lint_src(tmp_path, """
        import functools

        class Dec:
            # graftlint: hot
            @functools.lru_cache(None)
            def _walk(self, params, ids):
                def inner(t):
                    return t.item()
                return inner(ids)

            def host(self, ids):
                return ids.item()
    """, rules=["GL001"])
    assert [(f.rule, f.func, f.snippet) for f in out] == [
        ("GL001", "Dec._walk", "return t.item()")]


def test_module_forward_is_hot_only_in_hot_dirs(tmp_path):
    src = """
        import torch.nn as nn

        class M(nn.Module):
            def forward(self, x):
                return x.item()
    """
    assert _rules(_lint_src(tmp_path, src)) == ["GL001"]
    assert _lint_src(tmp_path, src,
                     rel="deeplearning4j_tpu_torch/ui/mod.py") == []


def test_shape_loop_outside_hot_module_is_fine(tmp_path):
    out = _lint_src(tmp_path, _FN.format(
        body="for i in range(x.shape[0]): x = x + 1"),
        rel="deeplearning4j_tpu_torch/ui/mod.py", rules=["GL002"])
    assert out == []


def test_gl005_is_kept_and_never_fires(tmp_path):
    assert "not ported" in port_lint.RULES["GL005"]
    out = _lint_src(tmp_path, """
        import jax
        def a(x):
            return x
        def b(x):
            return x
        fa = jax.jit(a, donate_argnums=(0,))
        fb = jax.jit(b)
    """)
    assert out == []


@pytest.mark.parametrize("src,flags", [
    ("""
        def serve(dec, caches, ids):
            for _ in range(8):
                toks, caches = dec.decode_block(caches, ids)
                ids = toks.detach().cpu()
    """, True),
    ("""
        def serve(dec, caches, ids):
            out = []
            for _ in range(8):
                toks, caches = dec.decode_block(caches, ids)
                out.append(toks[0].item())
    """, True),
    ("""
        def serve(dec, caches, ids):
            for _ in range(8):
                toks, caches = dec.decode_block(caches, ids)
                host = device_fetch(start_fetch(toks), tag="blk")
                ids = host[:, -1].tolist()
    """, False),
    ("""
        def serve(fn, x, xs):
            y = fn(x)
            return [y.cpu() for _ in xs]
    """, False),
], ids=["chain", "per_lane", "device_fetch", "invariant"])
def test_gl007_torch_sync_tails(tmp_path, src, flags):
    out = _lint_src(tmp_path, src,
                    rel="deeplearning4j_tpu_torch/models/mod.py",
                    rules=["GL007"])
    assert _rules(out) == (["GL007"] if flags else [])


def test_gl013_on_the_port_mesh(tmp_path):
    out = _lint_src(tmp_path, """
        from deeplearning4j_tpu_torch.parallel.mesh import P, make_mesh

        def build(devs):
            mesh = make_mesh(4, axis_names=("data", "tp"), shape=(2, 2),
                             devices=devs)
            return mesh, {"W": P(None, "tp"), "b": P(None, "tp"),
                          "Wo": P("model", None)}
    """, rules=["GL013"])
    assert len(out) == 2
    assert any("rank-1" in f.message for f in out)
    assert any("'model'" in f.message for f in out)


def test_gl014_and_gl016_in_a_per_shard_body(tmp_path):
    out = _lint_src(tmp_path, """
        # graftlint: shard
        def step(x, hist, profiler):
            v = x.item()
            hist.observe(v)
            print(v)
            profiler.record_block(k=1)
            return x

        def controller(x, hist):
            print(x.item())
    """, rel="deeplearning4j_tpu_torch/parallel/mod.py",
        rules=["GL014", "GL016"])
    assert [f.rule for f in out] == ["GL014"] * 3 + ["GL016"]
    assert {f.func for f in out} == {"step"}


def test_gl010_sees_subprocess_and_device_waits_under_a_lock(tmp_path):
    out = _lint_src(tmp_path, """
        import subprocess, threading, torch

        class Loader:
            def __init__(self):
                self._lock = threading.Lock()

            def build(self, cmd):
                with self._lock:
                    subprocess.run(cmd)
                    torch.cuda.synchronize()

            def build_all(self, procs):
                with self._lock:
                    self._wait(procs)

            def _wait(self, procs):
                for p in procs:
                    p.communicate()
    """, rel="deeplearning4j_tpu_torch/kernels/mod.py", rules=["GL010"])
    kinds = [(f.func, next(k for k in ("device sync", "subprocess wait")
                           if k in f.message)) for f in out]
    assert sorted(kinds) == [("Loader.build", "device sync"),
                             ("Loader.build", "subprocess wait"),
                             ("Loader.build_all", "subprocess wait")]


def test_gl010_under_a_module_level_lock(tmp_path):
    """A module-level lock is a lock to the port's pass (the JAX pass
    models class and local locks only), with its kind: an RLock
    re-entered through a call is no self-deadlock, a Lock is."""
    src = """
        import subprocess, threading

        _LOCK = threading.Lock()
        _RLOCK = threading.RLock()

        def build(cmd):
            subprocess.run(cmd)

        def load(cmd):
            with _LOCK:
                build(cmd)
                again()

        def again():
            with _LOCK:
                pass

        def reload():
            with _RLOCK:
                relock()

        def relock():
            with _RLOCK:
                pass
    """
    out = _lint_src(tmp_path, src, rules=["GL009", "GL010"])
    assert sorted((f.rule, f.func) for f in out) == [("GL009", "load"),
                                                    ("GL010", "load")]
    assert "_LOCK" in out[0].message
    jax_out = jax_lint.LintRunner(str(tmp_path), ["GL009", "GL010"]).lint(
        [str(tmp_path / "deeplearning4j_tpu_torch")])
    assert jax_out == []


def test_cuda_lib_build_under_its_lock_is_seen(tmp_path):
    """``cuda_lib.load`` waits on nvcc under ``_LOCK``: without its
    reviewed note the port's GL010 flags exactly that call."""
    src = (PORT / "kernels" / "cuda_lib.py").read_text(encoding="utf-8")
    assert src.count("# graftlint: disable=GL010") == 1
    out = _lint_src(tmp_path, src.replace("   # graftlint: disable=GL010",
                                          ""), rules=["GL010"])
    assert [(f.func, f.snippet) for f in out] == [("load", "build([name])")]
    assert "subprocess wait" in out[0].message


def test_tagged_helper_and_scalar_annotations():
    tree = ast.parse(textwrap.dedent("""
        def f(ctx, x, n: int, m: "Optional[float]", k=3):
            pass
    """))
    fn = tree.body[0]
    assert port_lint.ModuleLint._tensor_params(fn) == {"x"}
    assert port_lint.tagged(fn, {2}) and not port_lint.tagged(fn, {3})


# ------------------------------------------------------ cache and CLI
_SRC = textwrap.dedent("""
    import torch

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.item()
""")


def _mod(tmp_path):
    mod = tmp_path / "deeplearning4j_tpu_torch" / "kernels" / "m.py"
    mod.parent.mkdir(parents=True, exist_ok=True)
    mod.write_text(_SRC)
    return mod


def test_cache_round_trip(tmp_path):
    from deeplearning4j_tpu_torch.analysis import LintCache, LintRunner
    mod = _mod(tmp_path)
    cpath = str(tmp_path / "cache.json")
    c1 = LintCache(cpath)
    f1 = LintRunner(str(tmp_path), cache=c1).lint([str(mod)])
    assert c1.misses == 1 and c1.hits == 0
    c2 = LintCache(cpath)
    f2 = LintRunner(str(tmp_path), cache=c2).lint([str(mod)])
    assert c2.hits == 1 and c2.misses == 0
    assert [f.key for f in f1] == [f.key for f in f2] and len(f1) == 1
    mod.write_text(_SRC.replace("x.item()", "x"))
    c3 = LintCache(cpath)
    f3 = LintRunner(str(tmp_path), cache=c3).lint([str(mod)])
    assert c3.misses == 1 and f3 == []


def test_cache_refreshes_stamps_after_touch(tmp_path):
    from deeplearning4j_tpu_torch.analysis import LintCache, LintRunner
    mod = _mod(tmp_path)
    cpath = str(tmp_path / "cache.json")
    LintRunner(str(tmp_path), cache=LintCache(cpath)).lint([str(mod)])
    st = os.stat(mod)
    os.utime(mod, (st.st_atime + 100, st.st_mtime + 100))
    c2 = LintCache(cpath)
    LintRunner(str(tmp_path), cache=c2).lint([str(mod)])
    assert c2.hits == 1
    c3 = LintCache(cpath)
    rel = "deeplearning4j_tpu_torch/kernels/m.py"
    assert c3._data[rel]["mtime"] == os.stat(mod).st_mtime


def test_cache_serves_every_rule_selection(tmp_path):
    from deeplearning4j_tpu_torch.analysis import LintCache, LintRunner
    mod = _mod(tmp_path)
    cpath = str(tmp_path / "cache.json")
    LintRunner(str(tmp_path), cache=LintCache(cpath)).lint([str(mod)])
    c = LintCache(cpath)
    got = LintRunner(str(tmp_path), rules=["GL004"],
                     cache=c).lint([str(mod)])
    assert c.hits == 1 and got == []
    c = LintCache(cpath)
    got = LintRunner(str(tmp_path), rules=["GL001"],
                     cache=c).lint([str(mod)])
    assert c.hits == 1 and len(got) == 1


def test_missing_and_unparseable_paths_are_surfaced(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def broken(:\n")
    runner = port_lint.LintRunner(str(tmp_path))
    found = runner.lint([str(tmp_path / "nope"), str(bad),
                         str(tmp_path / "not_python.txt")])
    assert found == [] and len(runner.errors) == 3


def test_baseline_round_trip(tmp_path):
    found = _lint_src(tmp_path, _SRC)
    assert len(found) == 1
    bpath = tmp_path / "baseline.json"
    data = write_baseline(str(bpath), found)
    assert json.loads(bpath.read_text()) == data
    assert data["total"] == 1 and data["rules"] == ["GL001"]
    baseline = load_baseline(str(bpath))
    assert new_findings(_lint_src(tmp_path, _SRC), baseline) == []
    worse = _lint_src(tmp_path, _SRC + textwrap.dedent("""
        class Op2(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.tolist()
    """))
    fresh = new_findings(worse, baseline)
    assert len(fresh) == 1 and fresh[0].func == "Op2.forward"


def test_cli_select_ignore_json_and_gate(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(_SRC.replace("return x.item()",
                                "return x.item() * np.exp(x)"
                                ).replace("import torch",
                                          "import numpy as np\nimport torch"))
    cli = str(ROOT / "scripts" / "torch_lint.py")

    def run(*extra):
        return subprocess.run(
            [sys.executable, cli, "--no-cache", "--json", *extra,
             str(mod)], capture_output=True, text=True, cwd=str(ROOT))

    r = run("--select", "GL001")
    assert r.returncode == 1, r.stderr
    assert {f["rule"] for f in json.loads(r.stdout)["findings"]} == \
        {"GL001"}
    r = run()
    assert {f["rule"] for f in json.loads(r.stdout)["findings"]} == \
        {"GL001", "GL004"}
    r = run("--ignore", "GL001,GL004")
    assert r.returncode == 0 and json.loads(r.stdout)["findings"] == []
    bl = str(tmp_path / "bl.json")
    assert subprocess.run([sys.executable, cli, "--no-cache",
                           "--write-baseline", "--baseline", bl, str(mod)],
                          capture_output=True, cwd=str(ROOT)
                          ).returncode == 0
    r = run("--fail-on-new", "--baseline", bl)
    assert r.returncode == 0 and json.loads(r.stdout)["new"] == 0


# ===================================================================
# LockAudit
# ===================================================================
#: the JAX test file's two-lock inversion, read from it
DEADLOCK_FIXTURE = textwrap.dedent(_string_assigns(
    [n for n in ast.parse(JAX_TESTS.read_text(encoding="utf-8")).body
     if isinstance(n, ast.Assign)], {})["_DEADLOCK_FIXTURE"])


def test_lock_audit_order_recording_and_no_false_cycle():
    audit = LockAudit()
    a = audit.wrap(threading.Lock(), "A")
    b = audit.wrap(threading.Lock(), "B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert audit.edges() == {("A", "B"): 3}
    assert audit.cycles() == []
    audit.check()


def test_lock_audit_aborted_wait_leaves_no_phantom_entry():
    audit = LockAudit()
    cond = audit.wrap(threading.Condition(), "C.cond")
    lock = audit.wrap(threading.Lock(), "C.lock")
    with pytest.raises(RuntimeError):
        cond.wait(timeout=0.01)
    with lock:
        pass
    assert audit.edges() == {}


def test_lock_audit_patch_mode_condition_wait_works():
    with LockAudit(patch=True) as audit:
        cond = threading.Condition()
        ev_like = threading.Event()
        with cond:
            assert cond.wait(timeout=0.05) is False
            cond.notify_all()
        ev_like.set()
        assert ev_like.wait(timeout=1)
        assert audit._stack() == []
    assert audit.cycles() == []


def test_lock_audit_deadlock_fixture_static_and_dynamic(tmp_path):
    static_out = _lint_src(tmp_path, DEADLOCK_FIXTURE,
                           rel="deeplearning4j_tpu_torch/streaming/mod.py",
                           rules=["GL009"])
    assert _rules(static_out) == ["GL009"] and len(static_out) >= 2
    audit = LockAudit()
    a = audit.wrap(threading.Lock(), "Pair.a")
    b = audit.wrap(threading.Lock(), "Pair.b")
    barrier = threading.Barrier(2)

    def t1():
        with a:
            barrier.wait(timeout=5)
            if b.acquire(timeout=1.0):
                b.release()

    def t2():
        with b:
            barrier.wait(timeout=5)
            if a.acquire(timeout=1.0):
                a.release()

    ts = [threading.Thread(target=t1, daemon=True),
          threading.Thread(target=t2, daemon=True)]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert time.monotonic() - t0 < 10
    assert audit.cycles() == [["Pair.a", "Pair.b"]]
    with pytest.raises(LockOrderError):
        audit.check()
    facts = collect_package_facts([str(tmp_path / "deeplearning4j_tpu_torch")],
                                  repo_root=str(tmp_path))
    cc = audit.cross_check(lock_order_edges(facts).keys())
    assert sorted(cc["inversions"]) == [("Pair.a", "Pair.b"),
                                        ("Pair.b", "Pair.a")]
    assert cc["novel"] == []


def _tiny_port_lm():
    import torch
    from deeplearning4j_tpu_torch.models import transformer_lm_conf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = transformer_lm_conf(vocab_size=37, d_model=16, num_heads=2,
                               num_layers=1, max_length=32)
    return ComputationGraph(conf, compute_dtype=torch.float32,
                            device="cpu").init()


def test_lock_audit_engine_supervisor_agreement(port_static_edges):
    """The port's engine and supervisor, instrumented and exercised
    through submit / stats / stop, give no cycle, no inversion and no
    novel edge against the port's static graph, and the supervisor →
    engine edge is explained."""
    from deeplearning4j_tpu_torch.models import SlotGenerationEngine
    from deeplearning4j_tpu_torch.parallel.failures import EngineSupervisor
    eng = SlotGenerationEngine(_tiny_port_lm(), num_slots=2)
    sup = EngineSupervisor(eng, timeout=60.0)
    audit = LockAudit()
    names = audit.instrument(sup, names={"_lock": "HeartbeatMonitor._lock"})
    names += audit.instrument(eng)
    assert "EngineSupervisor._sup_lock" in names
    assert "SlotGenerationEngine._lock" in names
    sup.start()
    reqs = [sup.submit([1, 2, 3], 3) for _ in range(4)]
    for r in reqs:
        r.result(timeout=120)
    sup.stats()
    sup.stop()
    assert audit.cycles() == []
    cc = audit.cross_check(port_static_edges.keys())
    assert cc["inversions"] == [] and cc["novel"] == [], cc
    assert ("EngineSupervisor._sup_lock",
            "SlotGenerationEngine._lock") in cc["explained"]


def test_lock_audit_broker_agreement(port_static_edges):
    from deeplearning4j_tpu_torch.streaming.tcp_broker import (
        TcpBrokerServer, TcpMessageBroker)
    server = TcpBrokerServer().start()
    client = TcpMessageBroker(server.host, server.port)
    audit = LockAudit()
    names = audit.instrument(client,
                             names={"_lock": "TcpMessageBroker._lock"})
    assert "TcpMessageBroker._send_lock" in names
    try:
        q = client.subscribe("t")
        client.publish("t", b"x")
        assert q.get(timeout=5) == b"x"
        client.unsubscribe("t", q)
    finally:
        client.close()
        server.close()
    assert audit.cycles() == []
    cc = audit.cross_check(port_static_edges.keys())
    assert cc["inversions"] == [] and cc["novel"] == [], cc
    assert ("TcpMessageBroker._sub_lock",
            "TcpMessageBroker._send_lock") in cc["explained"]


# ===================================================================
# TransferAudit
# ===================================================================
def _three_waves(make_engine, audit_cls):
    rng = np.random.default_rng(5)
    eng = make_engine()
    with audit_cls() as transfers:
        for _ in range(3):
            reqs = [eng.submit(rng.integers(0, 37, int(n)), 4)
                    for n in rng.integers(2, 9, 6)]
            eng.run_until_drained()
            assert all(r.done() for r in reqs)
    return transfers, eng.stats()


@pytest.mark.parametrize("k", [1, 2, 4])
def test_transfer_audit_reports_as_jax_over_the_same_requests(k):
    """The port's TransferAudit over a tiny engine's three waves gives
    the JAX TransferAudit's per-tag report over the JAX engine on the
    same weights and requests, and at most one ``engine.decode`` readback
    a decode block.

    At K = 1 the JAX engine keeps a legacy loop (dispatch one step, read
    it back at once) unless it is paged or runs the numerics sentinel;
    the port has only the pipelined block cycle (dispatch the next block,
    then read the previous), which dispatches one block a refill that the
    lanes finishing in the in-flight block do not use (here 24 blocks and
    23 readbacks against the legacy loop's 18 and 18). So at K = 1 the
    JAX engine runs with the sentinel on, which takes it down that same
    pipelined path: the reports are then equal."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.analysis import TransferAudit as JaxAudit
    from deeplearning4j_tpu.models import (
        SlotGenerationEngine as JaxEngine,
        transformer_lm_conf as jax_lm_conf)
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
    from deeplearning4j_tpu.observability import IntegrityConfig
    from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                                 transformer_lm_conf)
    from deeplearning4j_tpu_torch.utils import graph_from_numpy
    kw = dict(vocab_size=37, d_model=16, num_heads=2, num_layers=1,
              max_length=32)
    jnet = JaxGraph(jax_lm_conf(**kw), compute_dtype=jnp.float32).init()
    net = graph_from_numpy(transformer_lm_conf(**kw),
                           {v: {kk: np.asarray(a) for kk, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    pipelined = {"integrity": IntegrityConfig(kv_verify=False)} \
        if k == 1 else {}
    want, jstats = _three_waves(
        lambda: JaxEngine(jnet, num_slots=3, refill=True, seed=0,
                          block_size=k, **pipelined), JaxAudit)
    got, stats = _three_waves(
        lambda: SlotGenerationEngine(net, num_slots=3, refill=True, seed=0,
                                     block_size=k), TransferAudit)
    assert got.report() == want.report()
    assert set(got.report()) == {"engine.decode", "engine.prefill"}
    assert stats["decode_blocks"] == jstats["decode_blocks"]
    got.check_per_block("engine.decode", stats["decode_blocks"])
    got.check_per_block("engine.prefill", stats["prefill_batches"])
    assert got.fetches("engine.prefill") == stats["prefill_batches"]
    assert got.shards("engine.decode") == 1
    with pytest.raises(TransferBudgetError):
        got.check_per_block("engine.decode",
                            got.fetches("engine.decode") - 1)


# ===================================================================
# CompileAudit, through the cuda_lib seam
# ===================================================================
@pytest.fixture
def fresh_events(monkeypatch):
    """The seam's process log emptied for the test (nothing is built)."""
    from deeplearning4j_tpu_torch.kernels import cuda_lib
    monkeypatch.setattr(cuda_lib, "_EVENTS", [])
    return cuda_lib


def test_compile_audit_counts_builds_and_loads(fresh_events):
    record = fresh_events.record_compile
    with CompileAudit() as audit:
        record("build", "lstm", "abc")
        record("load", "lstm", "abc")
        snap = audit.snapshot()
        record("load", "batchnorm", "abc")
    record("load", "shortseq_attention", "abc")     # after exit: unseen
    assert audit.compiles("lstm") == 2 and audit.total_compiles == 3
    assert audit.builds() == {"lstm": 1}
    assert audit.loads("lstm") == 1 and audit.loads("batchnorm") == 1
    assert audit.delta(snap) == {"batchnorm": 1}
    assert audit.duplicate_signature_compiles == 0
    info = audit.retraces()["lstm"]
    assert info == {"compiles": 2, "distinct_signatures": 2,
                    "duplicate_signature_compiles": 0}
    audit.check(budget={"lstm": 2}, total=3)
    with pytest.raises(CompileBudgetError):
        audit.check(total=0)
    with pytest.raises(CompileBudgetError):
        audit.check(budget={"lstm": 1})
    rep = audit.report()
    assert rep["total_compiles"] == 3 and rep["loads"]["lstm"] == 1
    whole = CompileAudit.process()
    assert whole.total_compiles == 4
    assert whole.loads("shortseq_attention") == 1


def test_compile_audit_catches_a_blown_cache(fresh_events):
    record = fresh_events.record_compile
    with CompileAudit() as audit:
        record("load", "lstm", "abc")
        record("load", "lstm", "abc")        # the same hash again
        record("build", "lstm", "def")       # an edited source: new hash
    assert audit.duplicate_signature_compiles == 1
    with pytest.raises(CompileBudgetError):
        audit.check(forbid_duplicate_signatures=True)


def test_compile_audit_budget_on_exit(fresh_events):
    with pytest.raises(CompileBudgetError):
        with CompileAudit(total_budget=0):
            fresh_events.record_compile("build", "lstm", "abc")
    with CompileAudit(budget={"lstm": 1}) as audit:
        fresh_events.record_compile("build", "lstm", "abc")
    assert audit.total_compiles == 1


def test_cuda_lib_records_a_build_and_a_load(fresh_events, monkeypatch,
                                             tmp_path):
    """The seam in ``build`` / ``load`` themselves, with nvcc and the
    card stubbed: one build event per nvcc process started, one load
    event per ctypes load, keyed by ``_lib_path``'s source hash; a
    second load of a loaded library records nothing."""
    cl = fresh_events

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return "", ""

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(cl, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cl, "_require_cuda", lambda: None)
    monkeypatch.setattr(cl, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cl.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(cl.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(cl, "_LIBS", {})
    runs = cl.nvcc_runs()
    digest = cl._lib_path("lstm").stem.rsplit("-", 1)[1]
    with CompileAudit() as audit:
        cl.load("lstm")
    with CompileAudit() as again:
        cl.load("lstm")
    assert cl.nvcc_runs() == runs + 1
    assert audit.builds("lstm") == 1 and audit.loads("lstm") == 1
    assert set(audit.signatures["lstm"]) == {f"build@{digest}",
                                             f"load@{digest}"}
    assert again.total_compiles == 0
    assert cl.compile_events() == [("build", "lstm", digest),
                                   ("load", "lstm", digest)]


# ===================================================================
# queue A12 and the package re-exports
# ===================================================================
def _alias_shape(alias):
    args = typing.get_args(alias)
    return typing.get_origin(alias), [a if a is Ellipsis else len(a)
                                      if isinstance(a, list) else "T"
                                      for a in args]


def test_a12_names_equal_their_jax_values():
    from deeplearning4j_tpu.keras import layers as jax_keras
    from deeplearning4j_tpu.ops import activations as jax_act
    from deeplearning4j_tpu.ops import losses as jax_loss
    from deeplearning4j_tpu.parallel import faults as jax_faults
    from deeplearning4j_tpu_torch.keras import importer, layers
    from deeplearning4j_tpu_torch.ops import activations, losses
    from deeplearning4j_tpu_torch.parallel import faults
    assert faults.POINTS == jax_faults.POINTS
    assert layers.KERAS_LAYER_CONVERTERS is layers.convert_layer
    assert jax_keras.KERAS_LAYER_CONVERTERS is jax_keras.convert_layer
    assert importer.KERAS_LAYER_CONVERTERS is layers.convert_layer
    # the same Callable over the framework's array type
    import torch
    assert _alias_shape(activations.ActivationFn) == \
        _alias_shape(jax_act.ActivationFn)
    assert typing.get_args(activations.ActivationFn)[1] is torch.Tensor
    assert _alias_shape(losses.LossFn) == _alias_shape(jax_loss.LossFn)
    assert typing.get_args(losses.LossFn)[1] is torch.Tensor


#: the JAX package's kernel-registration glue the port leaves out by
#: design (ROADMAP "not to port"): its kernels are the card's default
GLUE = {"lstm_helper", "register_lstm_helper", "register_bn_helper"}


@pytest.mark.parametrize("pkg", ["ops", "nn", "nn.conf", "kernels"])
def test_package_reexports_match_jax(pkg):
    import importlib
    jax_mod = importlib.import_module(f"deeplearning4j_tpu.{pkg}")
    port_mod = importlib.import_module(f"deeplearning4j_tpu_torch.{pkg}")
    want = set(jax_mod.__all__) - GLUE
    missing = [n for n in sorted(want) if not hasattr(port_mod, n)]
    assert missing == []
    assert set(port_mod.__all__) == want
