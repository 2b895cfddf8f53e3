"""Whole-package facts extraction + call graph for the port's graftlint:
a copy of the JAX package's ``analysis/callgraph.py`` (pure ``ast``),
kept here because the port imports nothing of that package. Two
differences: the blocking set also holds the torch and subprocess waits —
``torch.cuda.synchronize()`` / ``Event.synchronize()`` (device sync) and
``Popen.communicate()`` / ``subprocess.run`` and friends (subprocess
wait) —, and module-level locks (``_LOCK = threading.Lock()``, token
``path:_LOCK``) are locks too, so GL010 sees an nvcc or g++ build under a
loader's lock.

The per-file passes (GL001-GL008) are flow- and module-local by design;
the concurrency rules (GL009-GL012) are not — a lock-order inversion
between ``tcp_broker.py`` and ``serving.py`` is invisible to any
single-module walk. This module extracts, per file, a JSON-serializable
summary of everything the interprocedural pass needs:

- classes (bases, lock-like attributes and their kinds, attribute types
  inferred from ``self.x = ClassName(...)`` constructor assignments);
- per function/method: lock acquisitions with the locally-held set at
  each, call sites with the held set and (when an argument is a known
  lock attribute) lock-argument bindings, direct blocking operations
  (``sendall``/``recv``/``join``/``sleep``/``device_fetch``/blocking
  queue ops/HTTP serving), ``.wait()``/``.notify()`` events, and
  ``threading.Thread`` creations with daemon/join tracking;
- the module's inline-suppression map, so package-level findings honor
  ``# graftlint: disable=GLxxx`` exactly like per-file ones.

Facts are plain dicts end to end (``ModuleFacts.to_dict`` /
``from_dict``) so the CLI's mtime+hash cache can persist them and skip
re-parsing unchanged files; :class:`PackageIndex` then stitches the
summaries into class-hierarchy-aware method resolution and the call
graph the concurrency pass (:mod:`.concurrency`) fixpoints over.

Lock identity is the DEFINING owner: ``self._lock`` assigned in
``HeartbeatMonitor.__init__`` is ``parallel/failures.py:
HeartbeatMonitor._lock`` even when used from a subclass, so edges taken
through an inherited method and through the base class unify. Locks
received as parameters (``_send_frame(sock, lock, ...)``) get a
per-function token that call sites re-bind to the caller's concrete
lock, which is how ``sendall`` under ``TcpMessageBroker._send_lock``
is attributed through the module-function seam.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: factory tails that create lock-like objects, by kind
_LOCK_KINDS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition",
               "Semaphore": "semaphore", "BoundedSemaphore": "semaphore"}

#: receiver-name fragments that mark an attribute as queue-like (for
#: blocking .get()/.put() detection without type inference)
_QUEUE_HINTS = ("queue", "requests", "inbox", "mailbox")
_QUEUE_NAMES = {"q", "_q"}

#: blocking call tails: tail -> kind. ``join`` and ``get``/``put`` are
#: qualified further at the call site (str.join / dict.get exclusion).
_BLOCKING_TAILS = {
    "sendall": "socket send", "recv": "socket recv",
    "recv_into": "socket recv", "accept": "socket accept",
    "connect": "socket connect", "create_connection": "socket connect",
    "sleep": "sleep", "device_fetch": "device readback",
    "block_until_ready": "device sync",
    "serve_forever": "HTTP serving", "handle_request": "HTTP serving",
    "urlopen": "HTTP request", "getresponse": "HTTP request",
    "synchronize": "device sync", "communicate": "subprocess wait",
    "check_call": "subprocess wait", "check_output": "subprocess wait",
}
#: ``subprocess.run(...)`` / ``.call(...)``: tails too generic alone
_SUBPROCESS_CALLS = {"subprocess.run", "subprocess.call"}


from .lint import _dotted_name, _dotted_tail, scan_suppressions


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def tarjan_sccs(succ: Dict[str, Set[str]]) -> List[List[str]]:
    """Strongly connected components of size >= 2 (iterative Tarjan,
    deterministic order) — shared by the static lock-order graph
    (concurrency.LockOrderGraph) and the runtime auditor (lock_audit.
    LockAudit), whose whole contract is agreeing with each other."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on: Set[str] = set()
    stack: List[str] = []
    out: List[List[str]] = []
    counter = [0]
    for root in sorted(succ):
        if root in index:
            continue
        work = [(root, iter(sorted(succ.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(succ.get(w, ())))))
                    advanced = True
                    break
                if w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    out.append(sorted(scc))
    return out


@dataclasses.dataclass
class FunctionFacts:
    """Concurrency-relevant events of one function/method. ``held`` on
    every event is the LOCAL set of lock tokens held at that point."""

    qual: str                 # "Class.method" or "func"
    lineno: int = 0
    acquires: List[dict] = dataclasses.field(default_factory=list)
    calls: List[dict] = dataclasses.field(default_factory=list)
    blocks: List[dict] = dataclasses.field(default_factory=list)
    waits: List[dict] = dataclasses.field(default_factory=list)
    notifies: List[dict] = dataclasses.field(default_factory=list)
    threads: List[dict] = dataclasses.field(default_factory=list)
    joins: List[str] = dataclasses.field(default_factory=list)
    param_locks: List[str] = dataclasses.field(default_factory=list)
    param_names: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FunctionFacts":
        return cls(**d)


@dataclasses.dataclass
class ModuleFacts:
    path: str                 # repo-relative, forward slashes
    classes: Dict[str, dict] = dataclasses.field(default_factory=dict)
    functions: Dict[str, dict] = dataclasses.field(default_factory=dict)
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)
    suppressed: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)   # str keys: JSON round-trip safe
    #: module-level lock name -> kind
    module_locks: Dict[str, str] = dataclasses.field(default_factory=dict)

    def suppressed_at(self, rule: str, line: int) -> bool:
        return rule in self.suppressed.get(str(line), ())

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ModuleFacts":
        return cls(**d)

    def function_facts(self, qual: str) -> FunctionFacts:
        return FunctionFacts.from_dict(self.functions[qual])


class _FactsExtractor:
    """One pass over a parsed module -> ModuleFacts."""

    def __init__(self, relpath: str, tree: ast.Module,
                 source_lines: Sequence[str]):
        self.relpath = relpath
        self.tree = tree
        self.facts = ModuleFacts(path=relpath,
                                 suppressed=scan_suppressions(source_lines))
        self._collect_imports()
        self._collect_classes()
        for node in tree.body:
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _dotted_tail(node.value.func) in _LOCK_KINDS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.facts.module_locks[t.id] = \
                            _LOCK_KINDS[_dotted_tail(node.value.func)]
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._extract_function(node, cls_name=None)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        self._extract_function(sub, cls_name=node.name)

    # -------------------------------------------------------- module scan
    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.facts.imports[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.facts.imports[alias.asname or
                                       alias.name.split(".")[0]] = alias.name

    def _collect_classes(self) -> None:
        for node in self.tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            lock_attrs: Dict[str, str] = {}
            attr_types: Dict[str, str] = {}
            methods: List[str] = []
            for sub in node.body:
                if not isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    continue
                methods.append(sub.name)
                local_ctor: Dict[str, str] = {}
                for n in ast.walk(sub):
                    if not isinstance(n, ast.Assign):
                        continue
                    # constructor-shaped values, incl. the ternary form
                    # `x if x is not None else ClassName(...)`
                    vals = [n.value]
                    if isinstance(n.value, ast.IfExp):
                        vals = [n.value.body, n.value.orelse]
                    tails = [_dotted_tail(v.func) for v in vals
                             if isinstance(v, ast.Call)]
                    ctor = next((t for t in tails
                                 if t and t[0].isupper()), "")
                    for t in n.targets:
                        attr = _self_attr(t)
                        if attr is None:
                            if isinstance(t, ast.Name) and ctor:
                                local_ctor.setdefault(t.id, ctor)
                            continue
                        if ctor in _LOCK_KINDS:
                            lock_attrs[attr] = _LOCK_KINDS[ctor]
                        elif ctor:
                            # self.engine = SlotGenerationEngine(...) —
                            # remember the type for method dispatch
                            attr_types.setdefault(attr, ctor)
                        elif isinstance(n.value, ast.Name) and \
                                n.value.id in local_ctor:
                            # new = ClassName(...); self.engine = new
                            attr_types.setdefault(
                                attr, local_ctor[n.value.id])
            self.facts.classes[node.name] = {
                "bases": [_dotted_tail(b) for b in node.bases],
                "methods": methods,
                "lock_attrs": lock_attrs,
                "attr_types": attr_types,
                "lineno": node.lineno,
            }

    # ------------------------------------------------------ lock identity
    def _lock_token(self, expr: ast.AST, cls_name: Optional[str],
                    fn: FunctionFacts,
                    local_locks: Dict[str, str]) -> Optional[str]:
        """Canonical token for a lock-valued expression, or None."""
        attr = _self_attr(expr)
        if attr is not None and cls_name is not None:
            kind = self._class_lock_kind(cls_name, attr)
            if kind is not None:
                owner = self._lock_owner(cls_name, attr)
                return f"{self.relpath}:{owner}.{attr}"
            if "lock" in attr.lower() or "cond" in attr.lower() or \
                    "mutex" in attr.lower():
                return f"{self.relpath}:{cls_name}.{attr}"
            return None
        if isinstance(expr, ast.Name):
            if expr.id in local_locks:
                return local_locks[expr.id]
            if expr.id in fn.param_locks_set:
                return f"{self.relpath}:{fn.qual}.{expr.id}"
            if expr.id in self.facts.module_locks:
                return f"{self.relpath}:{expr.id}"
        return None

    def _class_lock_kind(self, cls_name: str, attr: str) -> Optional[str]:
        seen: Set[str] = set()
        stack = [cls_name]
        while stack:
            c = stack.pop()
            if c in seen or c not in self.facts.classes:
                continue
            seen.add(c)
            info = self.facts.classes[c]
            if attr in info["lock_attrs"]:
                return info["lock_attrs"][attr]
            stack.extend(info["bases"])
        return None

    def _lock_owner(self, cls_name: str, attr: str) -> str:
        """Defining class of a lock attr (walk bases declared in this
        module; cross-module bases fall back to the using class)."""
        seen: Set[str] = set()
        stack = [cls_name]
        while stack:
            c = stack.pop()
            if c in seen or c not in self.facts.classes:
                continue
            seen.add(c)
            info = self.facts.classes[c]
            if attr in info["lock_attrs"]:
                return c
            stack.extend(info["bases"])
        return cls_name

    # ------------------------------------------------------ function walk
    def _extract_function(self, node: ast.AST,
                          cls_name: Optional[str]) -> None:
        qual = f"{cls_name}.{node.name}" if cls_name else node.name
        fn = FunctionFacts(qual=qual, lineno=node.lineno)
        # params whose NAME says lock/condition: callers may bind real
        # locks onto them (_send_frame's ``lock``); give them tokens
        a = node.args
        fn.param_locks = [p.arg for p in (a.posonlyargs + a.args)
                          if p.arg != "self" and (
                              "lock" in p.arg.lower() or
                              "cond" in p.arg.lower() or
                              "mutex" in p.arg.lower())]
        fn.param_names = [p.arg for p in (a.posonlyargs + a.args)]
        fn.param_locks_set = set(fn.param_locks)   # transient helper
        local_locks: Dict[str, str] = {}
        local_types: Dict[str, str] = {}
        # pre-scan: local lock constructions and local var types
        for n in ast.walk(node):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                tail = _dotted_tail(n.value.func)
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        if tail in _LOCK_KINDS:
                            local_locks[t.id] = \
                                f"{self.relpath}:{qual}.{t.id}"
                        elif tail and tail[0].isupper():
                            local_types.setdefault(t.id, tail)
        self._walk_body(node.body, [], fn, cls_name, local_locks,
                        local_types, loop_depth=0)
        # bind Thread() creations to their assignment target (the name
        # GL012's join tracking must see joined): `t = Thread(...)` /
        # `self._worker = Thread(...)`
        for n in ast.walk(node):
            if isinstance(n, ast.Assign) and \
                    isinstance(n.value, ast.Call) and \
                    _dotted_tail(n.value.func) == "Thread":
                tgt = None
                for t in n.targets:
                    tgt = _self_attr(t) or (
                        t.id if isinstance(t, ast.Name) else tgt)
                for ev in fn.threads:
                    if ev["line"] == n.value.lineno:
                        ev["assigned"] = tgt
        del fn.param_locks_set          # transient: not a dataclass field
        self.facts.functions[qual] = fn.to_dict()

    def _walk_body(self, body: List[ast.stmt], held: List[str],
                   fn: FunctionFacts, cls_name: Optional[str],
                   local_locks: Dict[str, str],
                   local_types: Dict[str, str], loop_depth: int) -> None:
        held = list(held)
        for stmt in body:
            if isinstance(stmt, ast.With):
                entered: List[str] = []
                for item in stmt.items:
                    for n in ast.walk(item.context_expr):
                        self._visit_expr(n, held, fn, cls_name,
                                         local_locks, local_types,
                                         loop_depth)
                    tok = self._lock_token(item.context_expr, cls_name,
                                           fn, local_locks)
                    if tok is not None:
                        fn.acquires.append({"lock": tok,
                                            "held": list(held + entered),
                                            "line": stmt.lineno})
                        entered.append(tok)
                self._walk_body(stmt.body, held + entered, fn, cls_name,
                                local_locks, local_types, loop_depth)
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                probe = stmt.iter if isinstance(stmt, ast.For) else stmt.test
                for n in ast.walk(probe):
                    self._visit_expr(n, held, fn, cls_name, local_locks,
                                     local_types, loop_depth)
                self._walk_body(stmt.body, held, fn, cls_name,
                                local_locks, local_types, loop_depth + 1)
                self._walk_body(stmt.orelse, held, fn, cls_name,
                                local_locks, local_types, loop_depth)
                continue
            if isinstance(stmt, ast.If):
                for n in ast.walk(stmt.test):
                    self._visit_expr(n, held, fn, cls_name, local_locks,
                                     local_types, loop_depth)
                self._walk_body(stmt.body, held, fn, cls_name,
                                local_locks, local_types, loop_depth)
                self._walk_body(stmt.orelse, held, fn, cls_name,
                                local_locks, local_types, loop_depth)
                continue
            if isinstance(stmt, ast.Try):
                for blk in (stmt.body, stmt.orelse, stmt.finalbody):
                    self._walk_body(blk, held, fn, cls_name, local_locks,
                                    local_types, loop_depth)
                for h in stmt.handlers:
                    self._walk_body(h.body, held, fn, cls_name,
                                    local_locks, local_types, loop_depth)
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # nested def: analyzed as part of this function's body
                # conservatively with the CURRENT held set only if it is
                # immediately used; skip (thread targets handled at the
                # Thread() call site by name)
                continue
            # bare acquire()/release() discipline at statement level
            if isinstance(stmt, ast.Expr) and \
                    isinstance(stmt.value, ast.Call):
                call = stmt.value
                tail = _dotted_tail(call.func)
                if tail in ("acquire", "release") and \
                        isinstance(call.func, ast.Attribute):
                    tok = self._lock_token(call.func.value, cls_name,
                                           fn, local_locks)
                    if tok is not None:
                        if tail == "acquire":
                            fn.acquires.append({"lock": tok,
                                                "held": list(held),
                                                "line": stmt.lineno})
                            held.append(tok)
                        elif tok in held:
                            held.remove(tok)
                        continue
            for n in ast.walk(stmt):
                self._visit_expr(n, held, fn, cls_name, local_locks,
                                 local_types, loop_depth)

    # ------------------------------------------------------- expressions
    def _visit_expr(self, n: ast.AST, held: List[str], fn: FunctionFacts,
                    cls_name: Optional[str], local_locks: Dict[str, str],
                    local_types: Dict[str, str],
                    loop_depth: int) -> None:
        if not isinstance(n, ast.Call):
            return
        f = n.func
        tail = _dotted_tail(f)
        dn = _dotted_name(f)
        line = n.lineno
        # --- thread creation ------------------------------------------
        if tail == "Thread":
            target = None
            daemon: Optional[bool] = None
            for kw in n.keywords:
                if kw.arg == "target":
                    target = _self_attr(kw.value) or (
                        kw.value.id if isinstance(kw.value, ast.Name)
                        else _dotted_name(kw.value))
                elif kw.arg == "daemon":
                    daemon = kw.value.value \
                        if isinstance(kw.value, ast.Constant) else None
            fn.threads.append({"target": target, "daemon": daemon,
                               "line": line, "assigned": None,
                               "held": list(held)})
            return
        # --- wait/notify ----------------------------------------------
        if tail in ("wait", "wait_for") and isinstance(f, ast.Attribute):
            tok = self._lock_token(f.value, cls_name, fn, local_locks)
            recv_kind = None
            attr = _self_attr(f.value)
            if attr is not None and cls_name is not None:
                recv_kind = self._class_lock_kind(cls_name, attr)
            fn.waits.append({"lock": tok, "kind": recv_kind,
                             "held": list(held), "line": line,
                             "in_loop": loop_depth > 0,
                             "recv": _dotted_name(f.value)})
            return
        if tail in ("notify", "notify_all") and \
                isinstance(f, ast.Attribute):
            tok = self._lock_token(f.value, cls_name, fn, local_locks)
            attr = _self_attr(f.value)
            recv_kind = None
            if attr is not None and cls_name is not None:
                recv_kind = self._class_lock_kind(cls_name, attr)
            fn.notifies.append({"lock": tok, "kind": recv_kind,
                                "held": list(held), "line": line,
                                "recv": _dotted_name(f.value)})
            return
        # --- joins (for GL012 tracking) -------------------------------
        if tail == "join" and not n.args and isinstance(f, ast.Attribute):
            name = _self_attr(f.value) or (
                f.value.id if isinstance(f.value, ast.Name) else None)
            if name:
                fn.joins.append(name)
            fn.blocks.append({"held": list(held), "line": line,
                              "kind": "thread join",
                              "what": _dotted_name(f) + "()"})
            return
        # --- direct blocking calls ------------------------------------
        bkind = _BLOCKING_TAILS.get(tail)
        if dn in _SUBPROCESS_CALLS:
            bkind = "subprocess wait"
        if bkind == "sleep" and not (dn.startswith("time.") or
                                     dn == "sleep"):
            bkind = None                 # stop.wait-style sleeps differ
        if bkind is not None:
            fn.blocks.append({"held": list(held), "line": line,
                              "kind": bkind, "what": dn + "()"})
            return
        if tail in ("get", "put") and isinstance(f, ast.Attribute):
            recv = _dotted_tail(f.value)
            if recv in _QUEUE_NAMES or \
                    any(h in recv.lower() for h in _QUEUE_HINTS):
                fn.blocks.append({"held": list(held), "line": line,
                                  "kind": f"blocking queue {tail}",
                                  "what": dn + "()"})
                return
        # --- resolvable call sites ------------------------------------
        callee = None
        if isinstance(f, ast.Name):
            callee = {"kind": "name", "name": f.id}
        elif isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id == "self":
                callee = {"kind": "self", "name": f.attr}
            elif isinstance(base, ast.Name):
                # HeartbeatMonitor.stop(self) or obj.meth() on a local
                # whose constructor we saw. The explicit-self form
                # passes self POSITIONALLY, so lock-argument indices
                # already line up with the callee's params (no shift).
                if base.id in self.facts.classes or \
                        base.id in self.facts.imports:
                    callee = {"kind": "cls", "cls": base.id,
                              "name": f.attr, "explicit_self": True}
                elif base.id in local_types:
                    callee = {"kind": "cls", "cls": local_types[base.id],
                              "name": f.attr}
            elif _self_attr(base) is not None and cls_name is not None:
                attr = _self_attr(base)
                atype = self._class_attr_type(cls_name, attr)
                if atype is not None:
                    callee = {"kind": "cls", "cls": atype, "name": f.attr}
        if callee is None:
            return
        # lock-argument bindings: positional args that ARE known locks
        bindings: Dict[str, str] = {}
        for i, arg in enumerate(n.args):
            tok = self._lock_token(arg, cls_name, fn, local_locks)
            if tok is not None:
                bindings[str(i)] = tok
        fn.calls.append({"callee": callee, "held": list(held),
                         "line": line, "bindings": bindings})

    def _class_attr_type(self, cls_name: str, attr: str) -> Optional[str]:
        seen: Set[str] = set()
        stack = [cls_name]
        while stack:
            c = stack.pop()
            if c in seen or c not in self.facts.classes:
                continue
            seen.add(c)
            t = self.facts.classes[c]["attr_types"].get(attr)
            if t is not None:
                return t
            stack.extend(self.facts.classes[c]["bases"])
        return None


def extract_module_facts(relpath: str, tree: ast.Module,
                         source_lines: Sequence[str]) -> ModuleFacts:
    return _FactsExtractor(relpath, tree, source_lines).facts


class PackageIndex:
    """Cross-module resolution over a set of ModuleFacts: class
    hierarchy (name-based, package-wide), method dispatch, and the
    function call graph the concurrency pass walks."""

    def __init__(self, modules: Dict[str, ModuleFacts]):
        self.modules = modules
        #: ClassName -> (module path, class info); first definition wins,
        #: same-module use resolves before the global index
        self.class_index: Dict[str, Tuple[str, dict]] = {}
        for path, mf in sorted(modules.items()):
            for cname, info in mf.classes.items():
                self.class_index.setdefault(cname, (path, info))
        #: module-level function name -> [(module, qual)]
        self.func_index: Dict[str, List[Tuple[str, str]]] = {}
        for path, mf in sorted(modules.items()):
            for qual in mf.functions:
                if "." not in qual:
                    self.func_index.setdefault(qual, []).append(
                        (path, qual))

    # ------------------------------------------------------- class walks
    def mro(self, cls_name: str, home_module: Optional[str] = None
            ) -> List[Tuple[str, str]]:
        """[(module, ClassName)] name-based linearization (BFS)."""
        out: List[Tuple[str, str]] = []
        seen: Set[str] = set()
        queue: List[Tuple[Optional[str], str]] = [(home_module, cls_name)]
        while queue:
            home, c = queue.pop(0)
            if c in seen:
                continue
            seen.add(c)
            loc = None
            if home is not None and c in self.modules.get(
                    home, ModuleFacts(path="")).classes:
                loc = (home, self.modules[home].classes[c])
            elif c in self.class_index:
                loc = self.class_index[c]
            if loc is None:
                continue
            out.append((loc[0], c))
            for b in loc[1]["bases"]:
                queue.append((loc[0], b))
        return out

    def resolve_method(self, cls_name: str, meth: str,
                       home_module: Optional[str] = None
                       ) -> Optional[Tuple[str, str]]:
        """(module, "Class.meth") the call dispatches to, or None."""
        for mod, c in self.mro(cls_name, home_module):
            if f"{c}.{meth}" in self.modules[mod].functions:
                return (mod, f"{c}.{meth}")
        return None

    def resolve_call(self, module: str, caller_qual: str,
                     call: dict) -> Optional[Tuple[str, str]]:
        """Resolve one recorded call site to (module, qual)."""
        callee = call["callee"]
        kind = callee["kind"]
        mf = self.modules[module]
        if kind == "self":
            cls = caller_qual.split(".")[0] if "." in caller_qual else None
            if cls is None:
                return None
            return self.resolve_method(cls, callee["name"], module)
        if kind == "cls":
            cls = callee["cls"]
            # imported name may alias the real class name
            imp = mf.imports.get(cls)
            if imp is not None:
                cls = imp.split(".")[-1]
            if callee["name"] == "__init__" or cls not in self.class_index:
                return None
            return self.resolve_method(cls, callee["name"])
        if kind == "name":
            name = callee["name"]
            # constructor call: ClassName(...) -> __init__
            if name in mf.classes or \
                    (name in mf.imports and
                     mf.imports[name].split(".")[-1] in self.class_index):
                cname = name if name in mf.classes \
                    else mf.imports[name].split(".")[-1]
                return self.resolve_method(cname, "__init__",
                                           module if name in mf.classes
                                           else None)
            # same-module function first, then imported package function
            if name in mf.functions and "." not in name:
                return (module, name)
            imp = mf.imports.get(name)
            if imp is not None:
                tail = imp.split(".")[-1]
                candidates = self.func_index.get(tail, ())
                # several modules define the same function name
                # (_recv_exact lives in two transports): prefer the one
                # whose module path matches the IMPORT's module, never
                # blind first-wins
                imp_mod = imp.rsplit(".", 1)[0].lstrip(".")
                for mod, qual in candidates:
                    dotted = mod[:-3].replace("/", ".") \
                        if mod.endswith(".py") else mod.replace("/", ".")
                    if imp_mod and dotted.endswith(imp_mod):
                        return (mod, qual)
                for mod, qual in candidates:
                    return (mod, qual)
            return None
        return None

    def all_functions(self):
        for path, mf in sorted(self.modules.items()):
            for qual in sorted(mf.functions):
                yield path, qual, mf.function_facts(qual)

    def lock_kinds(self) -> Dict[str, str]:
        """Token -> kind for every class-level and module-level lock
        found."""
        out: Dict[str, str] = {}
        for path, mf in self.modules.items():
            for name, kind in mf.module_locks.items():
                out[f"{path}:{name}"] = kind
            for cname, info in mf.classes.items():
                for attr, kind in info["lock_attrs"].items():
                    out[f"{path}:{cname}.{attr}"] = kind
        return out
