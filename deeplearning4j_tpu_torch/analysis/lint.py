"""graftlint static passes for the port: AST lint for dispatch discipline
in eager torch code.

Nothing in the port is traced. The counterpart of the JAX package's "jit
context" is **hot context**: code that runs once per decode block or per
train step on the dispatch path. There a host sync stalls the CUDA queue
(the host waits for every kernel enqueued so far), and a host timestamp
or metric records when work was ENQUEUED, not when it ran. Hot context is
decided statically, without interprocedural analysis, from four sources:

1. ``forward`` / ``backward`` of ``torch.autograd.Function`` subclasses;
2. ``forward`` of ``nn.Module`` subclasses in the hot directories
   (``kernels``, ``models``, ``nn``, ``parallel``);
3. an explicit ``# graftlint: hot`` marker on (or directly above) a
   ``def`` line — the decode seams (``models/generation.py``'s
   ``_walk_*``, the attention layer's ``*_forward``), which no local
   analysis can tell from host code;
4. nesting — any function defined inside a hot function.

Inside hot context a name is a *tensor* when it is a positional
parameter without a default (minus ``self`` / ``cls`` / ``ctx``, and
minus parameters annotated with a Python scalar type, the counterpart of
JAX's ``static_argnames``), or a local assigned from an expression that
uses a tensor. Reading ``.shape`` / ``.dtype`` / ``.device`` / ``.dim()``
/ ... of a tensor is host metadata, not a sync.

GL005 (jit call sites) is not ported: the port compiles nothing, so the
id stays in :data:`RULES` with that reason and never fires. GL014 looks
at the per-shard bodies the one-controller loop runs (see
:mod:`.sharding`).

Suppression: ``# graftlint: disable=GL001[,GL002...]`` on the flagged
line (or the line above) silences those rules for that line;
``analysis/baseline.json`` suppresses reviewed findings repo-wide so
``scripts/torch_lint.py --fail-on-new`` gates only regressions. Baseline
keys are ``rule:path:function:snippet-hash`` — stable across unrelated
line drift.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "GL001": "host sync inside hot context (.item/.tolist/.cpu/.numpy, "
             "float/int/bool of a tensor, np.asarray of a tensor, "
             "synchronize)",
    "GL002": "Python loop over a tensor's dims in hot context (hot "
             "module)",
    "GL003": "branch on a tensor's value in hot context (a hidden sync)",
    "GL004": "numpy function applied to a tensor in hot context (a sync "
             "on the CPU, a TypeError on a CUDA tensor)",
    "GL005": "not ported: the port has no jit call site (it compiles "
             "nothing); kept for the rule table, never fires",
    "GL006": "shared attribute written from a thread target without a "
             "held lock",
    "GL007": "blocking host readback of a just-dispatched result inside "
             "a loop in a hot module",
    "GL008": "metric/trace recording inside hot context (in eager CUDA "
             "it stamps enqueue time; record on the readback thread)",
    "GL009": "lock-order inversion: cycle in the cross-module "
             "lock-acquisition graph (potential deadlock)",
    "GL010": "blocking call (socket/join/sleep/device/queue/HTTP/"
             "subprocess) executed while holding a lock",
    "GL011": "condition-wait discipline: wait outside a predicate "
             "re-check loop, or wait/notify without the lock",
    "GL012": "non-daemon thread started without a tracked join path",
    "GL013": "mesh-axis inconsistency in a P(...) spec (unknown axis or "
             "spec rank vs known parameter rank)",
    "GL014": "host sync or metric/trace recording inside a per-shard "
             "body of the one-controller loop",
    "GL015": "metric-family naming violation (counters must end _total, "
             "histograms _seconds/_bytes) or flight-recorder/devstats/"
             "SLO recording inside hot context",
    "GL016": "profiler/phase-stamp recording inside hot context or a "
             "per-shard body (phase stamps are host interval-clock "
             "anchors recorded from the readback thread)",
}

#: rules decided per module (cacheable per file); the rest (GL009-GL012)
#: need the whole-package call graph
PER_FILE_RULES = frozenset({"GL001", "GL002", "GL003", "GL004", "GL005",
                            "GL006", "GL007", "GL008", "GL013", "GL014",
                            "GL015", "GL016"})
PACKAGE_RULES = frozenset({"GL009", "GL010", "GL011", "GL012"})

#: bump to invalidate cached per-file results when any pass changes
LINT_VERSION = 2

#: modules where GL002 / GL007 apply — the hot paths
_HOT_DIRS = ("kernels", "models", "nn", "parallel")
#: reads of a tensor that are host metadata (attributes and methods)
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad", "dim", "size", "numel", "is_contiguous",
                 "data_ptr", "stride", "element_size", "is_floating_point",
                 "layout", "is_leaf", "grad_fn", "nbytes", "itemsize",
                 "storage_offset", "get_device", "names"}
#: calls whose tensor argument is read as host metadata only
_STATIC_CALLS = {"isinstance", "len", "type", "id", "callable", "hasattr",
                 "getattr", "is_tensor", "is_floating_point",
                 "is_complex"}
#: annotations that mark a parameter as a host scalar (not a tensor)
_SCALAR_TYPES = {"int", "float", "bool", "str", "bytes"}
#: method calls that read a tensor back to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: numpy calls that are NOT promotion hazards (dtype constructors, array
#: creation handled by GL001, index/meta helpers)
_NP_SAFE = {"asarray", "array", "float32", "float64", "float16", "int32",
            "int64", "int8", "uint8", "bool_", "dtype", "zeros", "ones",
            "empty", "arange", "shape", "ndim", "broadcast_to", "save"}
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}
#: GL008 — method names that ARE observability recording wherever they
#: appear, vs names generic enough (.set(), .event(), ...) that they only
#: count when the receiver expression names an observability object
_OBS_RECORD_METHODS = {"inc", "observe", "observe_many", "add_span",
                       "start_span", "end_span", "record_span"}
_OBS_HINTED_METHODS = {"set", "dec", "event", "finish", "labels",
                       "annotate"}
_OBS_NAME_HINTS = ("metric", "gauge", "counter", "hist", "trace", "span",
                   "registry", "telemetry")
#: GL015 — flight-recorder / devstats / SLO sinks (same receiver-hint
#: machinery as GL008, their own rule id)
_GL015_NAME_HINTS = ("flight", "recorder", "flightrec", "devstats",
                     "slo")
_GL015_RECORD_METHODS = {"record", "dump", "write_postmortem",
                         "observe_request", "snapshot", "sample",
                         "record_request"}
#: GL015 — metric-family naming: registry declaration method → the
#: suffixes a family name must carry (Prometheus conventions; gauges are
#: unconstrained)
_GL015_NAME_SUFFIXES = {"counter": ("_total",),
                        "histogram": ("_seconds", "_bytes")}
#: GL016 — the phase profiler's stamps (same receiver-hint machinery)
_GL016_NAME_HINTS = ("profiler", "prof", "phase", "timeline")
_GL016_RECORD_METHODS = {"record_block", "record_admission",
                         "record_chunk", "record_spec", "channel",
                         "attach_decoder"}
#: callees whose results are NOT "just-dispatched device work" for GL007:
#: python builtins and host-side helpers a loop legitimately materializes
_GL007_SAFE_CALLEES = {"range", "len", "list", "tuple", "dict", "set",
                       "zip", "enumerate", "sorted", "reversed", "min",
                       "max", "sum", "abs", "int", "float", "bool", "str",
                       "copy", "deepcopy", "append", "pop", "popleft",
                       "get", "items", "keys", "values", "split", "join",
                       "format", "device_fetch", "start_fetch"}
_HOT_MARKER = re.compile(r"graftlint:\s*hot\b")
_SHARD_MARKER = re.compile(r"graftlint:\s*shard\b")


@dataclasses.dataclass
class Finding:
    rule: str
    path: str           # repo-relative, forward slashes
    line: int
    func: str           # enclosing function qualname ("<module>" if none)
    message: str
    snippet: str        # stripped source line

    @property
    def key(self) -> str:
        h = hashlib.md5(self.snippet.encode("utf-8")).hexdigest()[:8]
        return f"{self.rule}:{self.path}:{self.func}:{h}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        return cls(**d)

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} [{self.func}] "
                f"{self.message}\n    {self.snippet}")


def scan_suppressions(source_lines: Sequence[str]) -> Dict[str, List[str]]:
    """{line: [rules]} from ``# graftlint: disable=...`` comments. A
    TRAILING comment suppresses its own line only; a standalone comment
    line suppresses the line below (a new violation written directly
    under an existing suppression has to trip the --fail-on-new gate).
    The one definition of this contract: the per-file passes and the
    package passes (via callgraph.ModuleFacts) both use it. Keys are
    strings so the shape is identical fresh and after a JSON cache
    round-trip."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source_lines, start=1):
        if "graftlint:" not in text:
            continue
        frag = text.split("graftlint:", 1)[1]
        if "disable=" not in frag:
            continue
        rules = {r.strip() for r in
                 frag.split("disable=", 1)[1].split("#")[0].split(",")
                 if r.strip()}
        out.setdefault(i, set()).update(rules)
        if text.strip().startswith("#"):      # standalone comment line
            out.setdefault(i + 1, set()).update(rules)
    return {str(k): sorted(v) for k, v in out.items()}


def scan_markers(source_lines: Sequence[str], pattern) -> Set[int]:
    """Lines a ``# graftlint: hot`` / ``shard`` marker tags: a trailing
    marker its own line, a standalone comment line also the line below
    (the same spillover rule as suppressions). A ``def`` is tagged when
    its own line or one of its decorators' is (:func:`tagged`)."""
    out: Set[int] = set()
    for i, text in enumerate(source_lines, start=1):
        if pattern.search(text):
            out.add(i)
            if text.strip().startswith("#"):
                out.add(i + 1)
    return out


def tagged(fn: ast.AST, lines: Set[int]) -> bool:
    """Is the def ``fn`` tagged by a marker on one of ``lines``?"""
    return fn.lineno in lines or any(d.lineno in lines
                                     for d in fn.decorator_list)


def _dotted_tail(node: ast.AST) -> str:
    """Last attribute/name segment of a call target ('torch.cuda.synchronize'
    -> 'synchronize')."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted_name(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_np_call(func: ast.AST) -> Optional[str]:
    """'np.sqrt(x)' / 'numpy.sqrt(x)' -> 'sqrt'; None otherwise."""
    if isinstance(func, ast.Attribute) and \
            isinstance(func.value, ast.Name) and \
            func.value.id in ("np", "numpy", "onp"):
        return func.attr
    return None


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    for b in cls.bases:
        dn = _dotted_name(b)
        if dn == "Function" or dn.endswith("autograd.Function"):
            return True
    return False


def _is_module(cls: ast.ClassDef) -> bool:
    for b in cls.bases:
        dn = _dotted_name(b)
        if dn == "Module" or dn.endswith("nn.Module"):
            return True
    return False


def _scalar_annotation(ann: Optional[ast.AST]) -> bool:
    """``int`` / ``float`` / ``bool`` / ``str`` / ``Optional[int]`` ...:
    a host scalar, never a tensor."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    if isinstance(ann, ast.Subscript) and \
            _dotted_tail(ann.value) == "Optional":
        return _scalar_annotation(ann.slice)
    return _dotted_tail(ann) in _SCALAR_TYPES


class _ParentMap(ast.NodeVisitor):
    def __init__(self):
        self.parents: Dict[ast.AST, ast.AST] = {}

    def generic_visit(self, node):
        for child in ast.iter_child_nodes(node):
            self.parents[child] = node
        super().generic_visit(node)


class ModuleLint:
    """All per-module passes over one parsed module."""

    def __init__(self, abspath: str, relpath: str, source: str,
                 tree: Optional[ast.Module] = None):
        self.relpath = relpath
        self.source_lines = source.splitlines()
        self.tree = tree if tree is not None \
            else ast.parse(source, filename=abspath)
        pm = _ParentMap()
        pm.visit(self.tree)
        self.parents = pm.parents
        self._disabled = {int(k): set(v) for k, v in
                          scan_suppressions(self.source_lines).items()}
        self._hot_markers = scan_markers(self.source_lines, _HOT_MARKER)
        self.shard_markers = scan_markers(self.source_lines, _SHARD_MARKER)
        self.hot_module = any(f"/{d}/" in f"/{self.relpath}"
                              for d in _HOT_DIRS)

    # ------------------------------------------------------------ comments
    def _suppressed(self, rule: str, line: int) -> bool:
        return rule in self._disabled.get(line, set())

    def _snippet(self, line: int) -> str:
        if 1 <= line <= len(self.source_lines):
            return self.source_lines[line - 1].strip()
        return ""

    def _emit(self, out: List[Finding], rule: str, node: ast.AST,
              func: str, message: str) -> None:
        self._emit_at(out, rule, getattr(node, "lineno", 0), func, message)

    def _emit_at(self, out: List[Finding], rule: str, line: int,
                 func: str, message: str) -> None:
        if self._suppressed(rule, line):
            return
        out.append(Finding(rule=rule, path=self.relpath, line=line,
                           func=func, message=message,
                           snippet=self._snippet(line)))

    # ------------------------------------------------------- hot contexts
    def _collect_hot_functions(self) -> List[Tuple[ast.AST, str]]:
        """(def node, qualname) for every root of hot context."""
        hot_methods: Set[int] = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if _is_autograd_function(node):
                names = ("forward", "backward")
            elif _is_module(node) and self.hot_module:
                names = ("forward",)
            else:
                continue
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and sub.name in names:
                    hot_methods.add(id(sub))
        roots: List[Tuple[ast.AST, str]] = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and (id(node) in hot_methods or
                         tagged(node, self._hot_markers)):
                roots.append((node, self._qualname(node)))
        return roots

    def _qualname(self, node: ast.AST) -> str:
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None and not isinstance(cur, ast.Module):
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                parts.append("<lambda>")
            cur = self.parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    @staticmethod
    def _tensor_params(fn: ast.AST) -> Set[str]:
        """Parameter names plausibly bound to tensors: positional params
        without defaults, minus self/cls/ctx (config flags like
        ``causal=False`` carry Python values) and minus params annotated
        with a host scalar type."""
        a = fn.args
        pos = a.posonlyargs + a.args
        n_default = len(a.defaults)
        cand = pos[:-n_default] if n_default else pos
        return {p.arg for p in cand
                if p.arg not in ("self", "cls", "ctx") and
                not _scalar_annotation(p.annotation)}

    def _static_use(self, name: ast.Name) -> bool:
        """A read of host metadata: ``x.shape`` / ``x.dtype`` /
        ``x.dim()`` / ``len(x)`` / ``isinstance(x, ...)`` / ``x is
        None``."""
        parent = self.parents.get(name)
        if isinstance(parent, ast.Attribute) and \
                parent.attr in _STATIC_ATTRS:
            return True
        if isinstance(parent, ast.Call) and name in parent.args and \
                _dotted_tail(parent.func) in _STATIC_CALLS:
            return True
        if isinstance(parent, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops):
            return True
        return False

    def _tensor_uses(self, expr: ast.AST, tensors: Set[str]) -> List[str]:
        return [n.id for n in ast.walk(expr)
                if isinstance(n, ast.Name) and n.id in tensors and
                isinstance(n.ctx, ast.Load) and not self._static_use(n)]

    @staticmethod
    def _bound(target: ast.AST) -> List[str]:
        """Names an assignment target binds (``a``, ``a, (b, *c)``; not
        ``self.x`` or ``d[k]``)."""
        if isinstance(target, ast.Name):
            return [target.id]
        if isinstance(target, ast.Starred):
            return ModuleLint._bound(target.value)
        if isinstance(target, (ast.Tuple, ast.List)):
            return [n for e in target.elts for n in ModuleLint._bound(e)]
        return []

    def _tensors(self, fn: ast.AST) -> Set[str]:
        """The tensor parameters and every local assigned from an
        expression that uses one (a fixpoint over the body)."""
        tensors = self._tensor_params(fn)
        assigns = [n for n in ast.walk(fn)
                   if isinstance(n, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign)) and
                   getattr(n, "value", None) is not None]
        changed = True
        while changed:
            changed = False
            for n in assigns:
                if not self._tensor_uses(n.value, tensors):
                    continue
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for e in [e for t in targets for e in self._bound(t)]:
                    if e not in tensors:
                        tensors.add(e)
                        changed = True
        return tensors

    # ------------------------------------------------------------ GL001-4
    def _check_hot_body(self, out: List[Finding], fn: ast.AST,
                        qual: str, enabled: Set[str]) -> None:
        tensors = self._tensors(fn)
        for node in [n for b in fn.body for n in ast.walk(b)]:
            if isinstance(node, ast.Call):
                self._check_hot_call(out, node, qual, enabled, tensors)
            if "GL002" in enabled and self.hot_module and \
                    isinstance(node, (ast.For, ast.While)):
                probe = node.iter if isinstance(node, ast.For) else node.test
                if any((isinstance(n, ast.Attribute) and n.attr == "shape")
                       or (isinstance(n, ast.Call) and
                           isinstance(n.func, ast.Attribute) and
                           n.func.attr == "size")
                       for n in ast.walk(probe)):
                    kind = "for" if isinstance(node, ast.For) else "while"
                    self._emit(out, "GL002", node, qual,
                               f"Python {kind} over a tensor dim launches "
                               "one batch of kernels per index on the "
                               "dispatch path — vectorize over the dim")
            if "GL003" in enabled and isinstance(node, (ast.If, ast.While)):
                hits = self._tensor_uses(node.test, tensors)
                if hits:
                    kind = "if" if isinstance(node, ast.If) else "while"
                    self._emit(out, "GL003", node, qual,
                               f"`{kind}` on tensor value(s) "
                               f"{sorted(set(hits))} reads the tensor "
                               "back (a hidden sync that stalls the CUDA "
                               "queue) — use torch.where or decide on "
                               "the host")

    def _check_hot_call(self, out: List[Finding], node: ast.Call,
                        qual: str, enabled: Set[str],
                        tensors: Set[str]) -> None:
        f = node.func
        np_fn = _is_np_call(f)
        if "GL001" in enabled:
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS:
                self._emit(out, "GL001", node, qual,
                           f".{f.attr}() reads the tensor back in hot "
                           "context — a host sync that stalls the CUDA "
                           "queue; return the tensor, or read it once a "
                           "block through ops.transfer.device_fetch")
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize":
                self._emit(out, "GL001", node, qual,
                           f"{_dotted_name(f)}() in hot context waits "
                           "for the device — the dispatch path must not "
                           "block")
            if np_fn in ("asarray", "array", "save") and node.args and \
                    self._tensor_uses(node.args[0], tensors):
                self._emit(out, "GL001", node, qual,
                           f"np.{np_fn}() of a tensor copies it to the "
                           "host — a sync in hot context")
            if isinstance(f, ast.Name) and f.id in ("float", "int",
                                                    "bool") and \
                    node.args and self._tensor_uses(node.args[0], tensors):
                self._emit(out, "GL001", node, qual,
                           f"{f.id}() of a tensor forces a host sync")
        if "GL004" in enabled and np_fn and np_fn not in _NP_SAFE and \
                not np_fn.startswith("random") and any(
                    self._tensor_uses(a, tensors) for a in node.args):
            self._emit(out, "GL004", node, qual,
                       f"np.{np_fn}() of a tensor converts it on the host "
                       "(a sync on the CPU, a TypeError on a CUDA tensor) "
                       "— use the torch function")
        if not isinstance(f, ast.Attribute):
            return
        recv = _dotted_name(f.value).lower()
        if "GL008" in enabled and (
                f.attr in _OBS_RECORD_METHODS or
                (f.attr in _OBS_HINTED_METHODS and
                 any(w in recv for w in _OBS_NAME_HINTS))):
            self._emit(out, "GL008", node, qual,
                       f".{f.attr}() records telemetry in hot context — "
                       "in eager CUDA it stamps enqueue time, not when "
                       "the work ran; record on the readback thread")
        if "GL015" in enabled and f.attr in _GL015_RECORD_METHODS and \
                any(w in recv for w in _GL015_NAME_HINTS):
            self._emit(out, "GL015", node, qual,
                       f".{f.attr}() on an SLO/flight-recorder/devstats "
                       "sink in hot context — it records enqueue time; "
                       "record on the readback thread")
        if "GL016" in enabled and f.attr in _GL016_RECORD_METHODS and \
                any(w in recv for w in _GL016_NAME_HINTS):
            self._emit(out, "GL016", node, qual,
                       f".{f.attr}() records profiler phase stamps in hot "
                       "context — the stamps would be enqueue times; "
                       "record on the readback thread")

    # -------------------------------------------------------------- GL006
    def _check_lock_discipline(self, out: List[Finding],
                               enabled: Set[str]) -> None:
        if "GL006" not in enabled:
            return
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self._check_class_locks(out, node)

    def _check_class_locks(self, out: List[Finding],
                           cls: ast.ClassDef) -> None:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        if not methods:
            return
        # thread entry points: threading.Thread(target=self.X) anywhere in
        # the class, expanded to self._y() calls made from them (fixpoint)
        entries: Set[str] = set()
        lock_attrs: Set[str] = set()
        writes: Dict[str, Dict[str, List[ast.AST]]] = {}   # meth -> attr
        reads: Dict[str, Set[str]] = {}
        calls: Dict[str, Set[str]] = {}
        for mname, m in methods.items():
            writes[mname] = {}
            reads[mname] = set()
            calls[mname] = set()
            for n in ast.walk(m):
                if isinstance(n, ast.Call):
                    if _dotted_tail(n.func) == "Thread":
                        for kw in n.keywords:
                            if kw.arg == "target" and \
                                    isinstance(kw.value, ast.Attribute) and \
                                    isinstance(kw.value.value, ast.Name) \
                                    and kw.value.value.id == "self":
                                entries.add(kw.value.attr)
                    if isinstance(n.func, ast.Attribute) and \
                            isinstance(n.func.value, ast.Name) and \
                            n.func.value.id == "self":
                        calls[mname].add(n.func.attr)
                if isinstance(n, ast.Assign):
                    for t in n.targets:
                        if self._self_attr(t):
                            writes[mname].setdefault(
                                self._self_attr(t), []).append(n)
                    if isinstance(n.value, ast.Call) and \
                            _dotted_tail(n.value.func) in _LOCK_FACTORIES:
                        for t in n.targets:
                            if self._self_attr(t):
                                lock_attrs.add(self._self_attr(t))
                elif isinstance(n, ast.AugAssign) and \
                        self._self_attr(n.target):
                    writes[mname].setdefault(
                        self._self_attr(n.target), []).append(n)
                elif isinstance(n, ast.Attribute) and \
                        isinstance(n.value, ast.Name) and \
                        n.value.id == "self" and \
                        isinstance(n.ctx, ast.Load):
                    reads[mname].add(n.attr)
        if not entries:
            return
        # fixpoint: self-methods called from thread context run in it too
        ctx = set(entries)
        changed = True
        while changed:
            changed = False
            for m in list(ctx):
                for callee in calls.get(m, ()):
                    if callee in methods and callee not in ctx:
                        ctx.add(callee)
                        changed = True
        for mname in sorted(ctx):
            m = methods.get(mname)
            if m is None:
                continue
            for attr, nodes in writes[mname].items():
                if attr in lock_attrs:
                    continue
                shared = any(attr in writes[o] for o in methods
                             if o not in ctx and o != "__init__") or \
                    any(attr in reads[o] for o in methods
                        if o not in ctx)
                for n in nodes:
                    racy_rmw = isinstance(n, ast.AugAssign)
                    if not (shared or racy_rmw):
                        continue
                    if self._under_lock(n, lock_attrs):
                        continue
                    what = "read-modify-write of" if racy_rmw else "write to"
                    self._emit(out, "GL006", n, f"{cls.name}.{mname}",
                               f"unlocked {what} self.{attr} in "
                               "thread-context method — guard with the "
                               "instance lock")

    # -------------------------------------------------------------- GL007
    def _check_host_loop_syncs(self, out: List[Finding],
                               enabled: Set[str],
                               hot_ids: Set[int]) -> None:
        """Flag a blocking readback (``.item()`` / ``.tolist()`` /
        ``.cpu()`` / ``.numpy()`` / ``np.asarray``) of a name assigned
        from a call INSIDE the same loop, in hot modules — the
        dispatch-then-immediately-sync pattern that serializes the CUDA
        queue with host round trips once per iteration. The receiver may
        hide behind a subscript or a method chain (``toks[s].item()``,
        ``out.detach().cpu()``). The sanctioned crossings are (a) one
        audited ``device_fetch`` per decode/verify BLOCK (its result is
        a host array — indexing it is free and exempt) and (b) fetching
        the PREVIOUS dispatch's result after launching the next
        (``start_fetch`` now, ``device_fetch`` a block later). Hot
        functions are GL001's domain and are skipped here."""
        if "GL007" not in enabled or not self.hot_module:
            return
        flagged: Set[int] = set()
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if id(fn) in hot_ids:
                continue
            qual = self._qualname(fn)
            for loop in ast.walk(fn):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                dispatched: Set[str] = set()
                for n in ast.walk(loop):
                    if isinstance(n, ast.Assign) and \
                            isinstance(n.value, ast.Call) and \
                            not self._gl007_safe_call(n.value):
                        for t in n.targets:
                            for el in ([t.elts] if isinstance(
                                    t, (ast.Tuple, ast.List)) else [[t]]):
                                for e in el:
                                    if isinstance(e, ast.Name):
                                        dispatched.add(e.id)
                if not dispatched:
                    continue
                for n in ast.walk(loop):
                    if not isinstance(n, ast.Call) or n.lineno in flagged:
                        continue
                    f = n.func
                    target = None
                    np_fn = _is_np_call(f)
                    if np_fn in ("asarray", "array") and n.args:
                        target = self._gl007_base_name(n.args[0])
                    elif isinstance(f, ast.Attribute) and \
                            f.attr in _SYNC_METHODS:
                        target = self._gl007_base_name(f.value)
                    if target in dispatched:
                        flagged.add(n.lineno)
                        self._emit(out, "GL007", n, qual,
                                   f"blocking readback of '{target}' "
                                   "dispatched in the same loop "
                                   "serializes the CUDA queue with a host "
                                   "sync — fuse steps into a device block "
                                   "and/or fetch the previous dispatch "
                                   "via ops.transfer.device_fetch")

    @staticmethod
    def _gl007_base_name(node: ast.AST) -> Optional[str]:
        """The base Name of a readback receiver: a bare name, a (nested)
        subscript of one, or a method chain on one — ``toks`` in
        ``toks[s].item()`` and in ``toks.detach().cpu()``."""
        while True:
            if isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                node = node.func.value
            else:
                break
        return node.id if isinstance(node, ast.Name) else None

    @staticmethod
    def _gl007_safe_call(call: ast.Call) -> bool:
        """Callees whose results are host values, not dispatched device
        work (builtins, np.*/math.* helpers, the audited fetch seam)."""
        if _is_np_call(call.func) is not None:
            return True
        tail = _dotted_tail(call.func)
        if tail in _GL007_SAFE_CALLEES:
            return True
        dn = _dotted_name(call.func)
        return dn.startswith("math.") or dn.startswith("time.")

    # -------------------------------------------------------------- GL015
    @staticmethod
    def _static_metric_name(node: ast.AST) -> Optional[str]:
        """The statically visible (suffix of the) metric name at a
        declaration site: a string literal whole, an f-string's trailing
        literal fragment, or None when the name is fully dynamic."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr) and node.values:
            last = node.values[-1]
            if isinstance(last, ast.Constant) and \
                    isinstance(last.value, str):
                return last.value
        return None

    def _check_metric_naming(self, out: List[Finding],
                             enabled: Set[str]) -> None:
        """Metric-family naming at registry declaration sites: counters
        must end ``_total``, histograms ``_seconds``/``_bytes``. Applies
        to ``<registry>.counter(...)`` / ``<registry>.histogram(...)``
        calls whose receiver names a registry."""
        if "GL015" not in enabled:
            return
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call) and
                    isinstance(node.func, ast.Attribute)):
                continue
            suffixes = _GL015_NAME_SUFFIXES.get(node.func.attr)
            if suffixes is None:
                continue
            recv = _dotted_name(node.func.value).lower()
            last = recv.rsplit(".", 1)[-1]
            if not ("registry" in last or last == "reg" or
                    last.endswith("_reg")):
                continue
            name_node = node.args[0] if node.args else None
            if name_node is None:
                for kw in node.keywords:
                    if kw.arg == "name":
                        name_node = kw.value
            name = None if name_node is None \
                else self._static_metric_name(name_node)
            if name is None or name.endswith(tuple(suffixes)):
                continue
            want = "/".join(suffixes)
            self._emit(out, "GL015", node, self._qualname(node),
                       f"{node.func.attr} family {name!r} must end "
                       f"{want} (Prometheus unit conventions; the "
                       "fleet-scrape aggregator sums by suffix)")

    @staticmethod
    def _self_attr(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return None

    def _under_lock(self, node: ast.AST, lock_attrs: Set[str]) -> bool:
        """Is ``node`` inside a ``with self.<lock>`` block (any lock-like
        attr, or any attr containing 'lock' when the class builds its
        locks elsewhere)?"""
        cur = self.parents.get(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            if isinstance(cur, ast.With):
                for item in cur.items:
                    expr = item.context_expr
                    for n in ast.walk(expr):
                        attr = self._self_attr(n)
                        if attr and (attr in lock_attrs or
                                     "lock" in attr.lower()):
                            return True
            cur = self.parents.get(cur)
        return False

    # ---------------------------------------------------------------- run
    def run(self, enabled: Set[str]) -> List[Finding]:
        out: List[Finding] = []
        hot_ids: Set[int] = set()
        for fn, qual in self._collect_hot_functions():
            self._check_hot_body(out, fn, qual, enabled)
            for n in ast.walk(fn):     # nested defs run with their root
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    hot_ids.add(id(n))
        self._check_lock_discipline(out, enabled)
        self._check_host_loop_syncs(out, enabled, hot_ids)
        self._check_metric_naming(out, enabled)
        if enabled & {"GL013", "GL014", "GL016"}:
            from .sharding import run_sharding_pass
            run_sharding_pass(
                self.tree, sorted(enabled & {"GL013", "GL014", "GL016"}),
                lambda rule, line, func, message:
                self._emit_at(out, rule, line, func, message),
                self.shard_markers)
        return out


class LintCache:
    """Per-file result cache: mtime+size fast path, content-hash slow
    path, keyed by repo-relative path and invalidated by LINT_VERSION.
    Stores the per-file findings for ALL per-file rules (rule filters
    apply at collection time, so one cache serves every ``--select``)
    plus the module's callgraph facts for the package pass."""

    def __init__(self, path: str):
        self.path = path
        self.hits = 0
        self.misses = 0
        self._dirty = False
        self._data: dict = {}
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
            if data.get("version") == LINT_VERSION:
                self._data = data.get("files", {})
        except (OSError, ValueError):
            self._data = {}

    @staticmethod
    def _digest(src: str) -> str:
        return hashlib.sha1(src.encode("utf-8")).hexdigest()

    def get(self, rel: str, mtime: float, size: int,
            src: str) -> Optional[dict]:
        entry = self._data.get(rel)
        if entry is None:
            self.misses += 1
            return None
        if not (entry["mtime"] == mtime and entry["size"] == size):
            if entry["sha1"] != self._digest(src):
                self.misses += 1
                return None
            # content unchanged, file merely touched: refresh the
            # stamps so the NEXT run takes the mtime fast path again
            entry["mtime"], entry["size"] = mtime, size
            self._dirty = True
        self.hits += 1
        return entry

    def put(self, rel: str, mtime: float, size: int, src: str,
            findings: Sequence["Finding"], facts) -> None:
        self._data[rel] = {
            "mtime": mtime, "size": size, "sha1": self._digest(src),
            "findings": [f.to_dict() for f in findings],
            "facts": facts.to_dict(),
        }
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": LINT_VERSION, "files": self._data},
                          f)
            os.replace(tmp, self.path)
        except OSError:
            pass                        # cache is best-effort


class LintRunner:
    """Walk .py files under roots, run the per-module passes on each,
    then the whole-package concurrency pass over the aggregated call
    graph, and return every finding."""

    def __init__(self, repo_root: str, rules: Optional[Iterable[str]] = None,
                 cache: Optional[LintCache] = None,
                 force_facts: bool = False):
        self.repo_root = os.path.abspath(repo_root)
        self.enabled = set(rules) if rules else set(RULES)
        self.errors: List[str] = []   # unparseable files (reported, not fatal)
        self.cache = cache
        # collect callgraph facts even when no package rule is enabled
        # (collect_package_facts' contract)
        self.force_facts = bool(force_facts)
        self._facts: Dict[str, object] = {}
        self._sources: Dict[str, List[str]] = {}

    @property
    def facts(self) -> Dict[str, object]:
        """{module path: callgraph facts} of the last :meth:`lint` — the
        static side of ``lock_audit.LockAudit.cross_check``; empty unless
        a package rule ran or ``force_facts`` was set."""
        return dict(self._facts)

    def lint_file(self, path: str) -> List[Finding]:
        from .callgraph import ModuleFacts, extract_module_facts
        rel = os.path.relpath(os.path.abspath(path),
                              self.repo_root).replace(os.sep, "/")
        try:
            st = os.stat(path)
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
        except (UnicodeDecodeError, OSError) as e:
            self.errors.append(f"{rel}: {e}")
            return []
        entry = None
        if self.cache is not None:
            entry = self.cache.get(rel, st.st_mtime, st.st_size, src)
        if entry is not None:
            found = [Finding.from_dict(d) for d in entry["findings"]]
            facts = ModuleFacts.from_dict(entry["facts"])
        else:
            try:
                tree = ast.parse(src, filename=path)
                module = ModuleLint(path, rel, src, tree=tree)
            except SyntaxError as e:
                self.errors.append(f"{rel}: {e}")
                return []
            # with a cache, run EVERY per-file pass so one entry serves
            # any later --select; without one, run only what was asked
            # (and skip facts extraction unless a package rule needs it)
            if self.cache is not None:
                found = module.run(set(PER_FILE_RULES))
                facts = extract_module_facts(rel, tree, src.splitlines())
                self.cache.put(rel, st.st_mtime, st.st_size, src,
                               found, facts)
            else:
                found = module.run(self.enabled & PER_FILE_RULES)
                facts = None
                if self.force_facts or self.enabled & PACKAGE_RULES:
                    facts = extract_module_facts(rel, tree,
                                                 src.splitlines())
        if facts is not None:
            self._facts[rel] = facts
        self._sources[rel] = src.splitlines()
        return [f for f in found if f.rule in self.enabled]

    def _package_pass(self, findings: List[Finding]) -> None:
        pkg_rules = self.enabled & PACKAGE_RULES
        if not pkg_rules or not self._facts:
            return
        from .concurrency import ConcurrencyAnalysis
        analysis = ConcurrencyAnalysis(self._facts)

        def emit(rule: str, module: str, line: int, func: str,
                 message: str) -> None:
            mf = self._facts[module]
            if mf.suppressed_at(rule, line):
                return
            lines = self._sources.get(module, [])
            snippet = lines[line - 1].strip() \
                if 1 <= line <= len(lines) else ""
            findings.append(Finding(rule=rule, path=module, line=line,
                                    func=func, message=message,
                                    snippet=snippet))

        analysis.findings(pkg_rules, emit)

    def lint(self, paths: Sequence[str]) -> List[Finding]:
        findings: List[Finding] = []
        self._facts.clear()
        self._sources.clear()
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = [d for d in dirnames
                                   if d not in ("__pycache__", ".git")]
                    for fn in sorted(filenames):
                        if fn.endswith(".py"):
                            findings.extend(
                                self.lint_file(os.path.join(dirpath, fn)))
            elif os.path.isfile(p) and p.endswith(".py"):
                findings.extend(self.lint_file(p))
            else:
                # a stale/misspelled path must not silently shrink the
                # gate's coverage — surface it like a parse error
                self.errors.append(f"{p}: not a directory or .py file")
        self._package_pass(findings)
        if self.cache is not None:
            self.cache.save()
        # de-duplicate identical (rule, site) findings: an edge can be
        # witnessed through several call paths; the gate needs one
        seen: Set[Tuple[str, str, int, str]] = set()
        unique: List[Finding] = []
        for f in findings:
            k = (f.rule, f.path, f.line, f.message)
            if k not in seen:
                seen.add(k)
                unique.append(f)
        unique.sort(key=lambda f: (f.path, f.line, f.rule))
        return unique


def lint_paths(paths: Sequence[str], repo_root: str,
               rules: Optional[Iterable[str]] = None) -> List[Finding]:
    return LintRunner(repo_root, rules).lint(paths)


def collect_package_facts(paths: Sequence[str], repo_root: str,
                          cache: Optional[LintCache] = None) -> Dict:
    """Extract callgraph facts for every module under ``paths`` without
    running the package rules — the static side of
    ``lock_audit.LockAudit.cross_check``."""
    runner = LintRunner(repo_root, rules=["GL001"], cache=cache,
                        force_facts=True)
    runner.lint(paths)
    return runner.facts


# ------------------------------------------------------------- baseline
def baseline_counts(findings: Sequence[Finding]) -> Dict[str, int]:
    return dict(Counter(f.key for f in findings))


def write_baseline(path: str, findings: Sequence[Finding]) -> dict:
    data = {
        "version": 1,
        "rules": sorted({f.rule for f in findings}),
        "total": len(findings),
        "suppressed": baseline_counts(findings),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return data


def load_baseline(path: str) -> Dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return dict(data.get("suppressed", {}))


def new_findings(findings: Sequence[Finding],
                 baseline: Dict[str, int]) -> List[Finding]:
    """Findings beyond the baselined count for their key (line-number
    drift does not churn keys; adding a second identical violation in the
    same function DOES trip the gate)."""
    seen: Counter = Counter()
    out: List[Finding] = []
    for f in findings:
        seen[f.key] += 1
        if seen[f.key] > baseline.get(f.key, 0):
            out.append(f)
    return out
