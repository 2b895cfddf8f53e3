"""Sharding-discipline pass: GL013/GL014 over the port's mesh code.

- **GL013 mesh-axis consistency** — a ``P(...)`` spec (the port's
  ``parallel/mesh.py::P``) naming an axis absent from every mesh
  declared in the module (``Mesh(devices, axis_names)`` /
  ``make_mesh(axis_names=...)``, ``parallel/mesh.py``) and from the
  module's ``*_axis`` vocabulary (parameter defaults, variables, and
  annotated fields such as ``SpecLayout``'s ``data_axis: str = "data"``)
  shards onto an axis that does not exist: ``shard_params`` raises at
  run time, long after review. Name-based assignment tables
  (``{"b": P(...)}``) are rank-checked for known-rank-1 parameter names:
  a bias spec with two axis entries cannot match a [F] leaf. The JAX
  package's per-``shard_map``-site check has no counterpart: the port
  has no SPMD call site, so every spec is held to the module's
  vocabulary.
- **GL014 host sync / telemetry inside a per-shard body** — the port
  has no ``shard_map`` region: one host loop drives every shard
  (``parallel/sharded.py::walk`` advances each shard's walk in step and
  answers the cross-shard requests; ``parallel/sequence.py``'s ring
  runs each (step, shard) pair). The bodies that loop runs once per
  shard per step are named statically with a ``# graftlint: shard``
  marker on their ``def`` (the counterpart of a ``shard_map``'d
  function). A host sync there waits for every shard queued so far, once
  per shard, and a metric or print records enqueue time; sanctioned
  crossings stay outside the body (the audited ``ops.transfer``
  ``device_fetch`` runs on the controller).
- **GL016** — the profiler's phase-stamp recording inside a per-shard
  body (the hot-context half is in :mod:`.lint`).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

#: known-rank-1 parameter names in name-based spec assignment tables
_RANK1_PARAM_NAMES = {"b", "bo", "bq", "bk", "bv", "bias", "beta",
                      "gamma", "scale", "offset"}

#: host-sync call tails inside a per-shard body
_HOST_SYNC_TAILS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_FETCH_NAMES = {"device_fetch"}

from .lint import (_GL016_NAME_HINTS, _GL016_RECORD_METHODS,
                   _OBS_HINTED_METHODS, _OBS_NAME_HINTS,
                   _OBS_RECORD_METHODS, _dotted_name, _dotted_tail,
                   tagged)


def _literal_strings(node: ast.AST) -> List[str]:
    """Every string literal inside an expression (axis names in specs)."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append(n.value)
    return out


def _spec_calls(node: ast.AST) -> List[ast.Call]:
    """P(...) / PartitionSpec(...) call sites inside an expression."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and \
                _dotted_tail(n.func) in ("P", "PartitionSpec"):
            out.append(n)
    return out


class ShardingLint:
    """Per-module GL013/GL014/GL016 pass. Pure-AST; emits via the
    callback ``emit(rule, line, func, message)`` (the runner owns Finding
    construction and suppression). ``shard_lines`` are the lines the
    module's ``# graftlint: shard`` markers tag."""

    def __init__(self, tree: ast.Module, shard_lines: Set[int] = ()):
        self.tree = tree
        self.shard_lines = set(shard_lines)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    # ------------------------------------------------------------ common
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

    # ------------------------------------------------------------- GL013
    def _axis_vocab(self) -> Set[str]:
        """The module-wide axis vocabulary: literal ``axis_names`` of
        ``Mesh`` / ``make_mesh`` calls, string defaults of ``*axis*``
        parameters, and string literals assigned (or annotated) to
        ``*axis*``-named variables and fields. An empty vocabulary
        disables the check (the mesh lives elsewhere)."""
        vocab: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                tail = _dotted_tail(node.func)
                axes: List[str] = []
                if tail == "Mesh" and len(node.args) >= 2:
                    axes = _literal_strings(node.args[1])
                for kw in node.keywords:
                    if kw.arg == "axis_names":
                        axes = _literal_strings(kw.value)
                if tail in ("Mesh", "make_mesh"):
                    vocab.update(axes)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = node.args
                pos = a.posonlyargs + a.args
                defaults = a.defaults
                pairs = list(zip(pos[len(pos) - len(defaults):], defaults))
                pairs += [(p, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                          if d is not None]
                for p, d in pairs:
                    if "axis" in p.arg.lower() and \
                            isinstance(d, ast.Constant) and \
                            isinstance(d.value, str):
                        vocab.add(d.value)
            elif isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name) and "axis" in t.id.lower():
                        vocab.add(node.value.value)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.value, ast.Constant) and \
                    isinstance(node.value.value, str) and \
                    isinstance(node.target, ast.Name) and \
                    "axis" in node.target.id.lower():
                vocab.add(node.value.value)
        return vocab

    def check_gl013(self, emit) -> None:
        vocab = self._axis_vocab()
        if vocab:
            for spec in _spec_calls(self.tree):
                for ax in _literal_strings(spec):
                    if ax not in vocab:
                        emit("GL013", spec.lineno, self._qualname(spec),
                             f"P(...) names axis '{ax}' absent from every "
                             "mesh/axis declaration in this module "
                             f"({sorted(vocab)}) — sharding onto a "
                             "nonexistent axis fails at run time")
        # rank check on name-based assignment tables
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Dict):
                continue
            for k, v in zip(node.keys, node.values):
                if not (isinstance(k, ast.Constant) and
                        isinstance(k.value, str) and
                        k.value in _RANK1_PARAM_NAMES):
                    continue
                if isinstance(v, ast.Call) and \
                        _dotted_tail(v.func) in ("P", "PartitionSpec") \
                        and len(v.args) > 1:
                    emit("GL013", v.lineno, self._qualname(v),
                         f"spec for rank-1 parameter '{k.value}' has "
                         f"{len(v.args)} entries — a spec's rank cannot "
                         "exceed the leaf's rank; a bias is sharded (or "
                         "replicated) on ONE axis")

    # ------------------------------------------------------------- GL014
    def _shard_bodies(self):
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and tagged(node, self.shard_lines):
                yield node, self._qualname(node)

    def check_gl014(self, emit) -> None:
        for fn, qual in self._shard_bodies():
            for node in [n for b in fn.body for n in ast.walk(b)]:
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                tail = _dotted_tail(f)
                dn = _dotted_name(f)
                if isinstance(f, ast.Attribute) and \
                        tail in _HOST_SYNC_TAILS:
                    emit("GL014", node.lineno, qual,
                         f".{tail}() inside a per-shard body — the "
                         "controller waits for every shard queued so "
                         "far, once per shard; return the tensor and "
                         "read it back once, outside the loop")
                elif tail in _HOST_FETCH_NAMES or \
                        dn in ("np.asarray", "numpy.asarray", "np.array",
                               "numpy.array", "np.save", "numpy.save"):
                    emit("GL014", node.lineno, qual,
                         f"{dn or tail}() inside a per-shard body copies "
                         "a shard's tensor to the host — cross the seam "
                         "once on the controller")
                elif isinstance(f, ast.Name) and f.id == "print":
                    emit("GL014", node.lineno, qual,
                         "print() inside a per-shard body runs once per "
                         "shard per step and formats tensors (a sync) — "
                         "log on the controller")
                elif isinstance(f, ast.Attribute):
                    recv = _dotted_name(f.value).lower()
                    hinted = any(w in recv for w in _OBS_NAME_HINTS)
                    if tail in _OBS_RECORD_METHODS or \
                            (hinted and tail in _OBS_HINTED_METHODS):
                        emit("GL014", node.lineno, qual,
                             f".{tail}() records telemetry inside a "
                             "per-shard body — it stamps enqueue time "
                             "once per shard; record on the controller's "
                             "readback side")

    def check_gl016(self, emit) -> None:
        """Profiler/phase-stamp recording inside a per-shard body (the
        hot-context half is in :mod:`.lint`)."""
        for fn, qual in self._shard_bodies():
            for node in [n for b in fn.body for n in ast.walk(b)]:
                if not (isinstance(node, ast.Call) and
                        isinstance(node.func, ast.Attribute)):
                    continue
                tail = node.func.attr
                recv = _dotted_name(node.func.value).lower()
                if tail in _GL016_RECORD_METHODS and any(
                        w in recv for w in _GL016_NAME_HINTS):
                    emit("GL016", node.lineno, qual,
                         f".{tail}() records profiler phase stamps inside "
                         "a per-shard body — stamps are host "
                         "interval-clock anchors recorded on the "
                         "readback thread")


def run_sharding_pass(tree: ast.Module, enabled, emit,
                      shard_lines: Set[int] = ()) -> None:
    lint = ShardingLint(tree, shard_lines)
    if "GL013" in enabled:
        lint.check_gl013(emit)
    if "GL014" in enabled:
        lint.check_gl014(emit)
    if "GL016" in enabled:
        lint.check_gl016(emit)
