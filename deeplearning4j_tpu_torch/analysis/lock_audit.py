"""LockAudit: runtime lock-acquisition-order auditor — the dynamic
counterpart of the static GL009/GL010 pass, in the CompileAudit/
TransferAudit mold (context manager, snapshot/check discipline). The JAX
package's ``analysis/lock_audit.py``, copied: it audits Python locks and
knows nothing of the framework.

Each audited lock records, per thread, the stack of audited locks held;
every acquisition ATTEMPT (not just success — the attempt order is what
deadlocks) adds edges ``held -> acquiring`` to a global graph. After a
run:

- :meth:`LockAudit.edges` — observed (holder, acquired) pairs with
  counts;
- :meth:`LockAudit.cycles` — cycles in the observed order graph: two
  threads actually took these locks in opposing orders during the run;
- :meth:`LockAudit.check` — raise :class:`LockOrderError` on any cycle;
- :meth:`LockAudit.cross_check` — compare against the STATIC lock-order
  graph (``concurrency.lock_order_edges``): a dynamic edge whose
  reverse is statically (or dynamically) reachable is an **inversion**
  (deadlock candidate the static pass must already know about, else it
  is a static false negative); a dynamic edge the static graph lacks
  entirely is **novel** (informational — usually an unresolved dispatch
  edge). Each layer catches the other's false negatives: the static
  pass sees paths the test run never exercised, the audit sees dispatch
  the AST resolver could not follow (callbacks, per-call lock
  arguments, dynamically-built engines).

Two instrumentation modes:

- ``audit.instrument(obj)`` wraps every ``threading.Lock``/``RLock``/
  ``Condition`` attribute of an instance in place (names default to
  ``ClassName.attr``; pass ``names={attr: "Owner.attr"}`` to pin the
  identity to the DEFINING class the static tokens use);
- ``LockAudit(patch=True)`` patches the ``threading`` factories for the
  context's lifetime, so every lock constructed inside (engines built
  by a supervisor takeover included) is audited automatically, named by
  its creation site (``Class.attr`` recovered from the constructor's
  source line).

The wrappers add two dict operations per lock op under one internal
lock — fine for tests and chaos soaks, not for production serving.
"""

from __future__ import annotations

import linecache
import sys
import threading
from typing import Dict, Iterable, List, Optional, Set, Tuple

_RealLock = threading.Lock
_RealRLock = threading.RLock


class LockOrderError(AssertionError):
    """The observed acquisition orders contain a cycle (or contradict
    the static graph); carries the offending edges/cycles."""

    def __init__(self, message: str, cycles=None, inversions=None):
        super().__init__(message)
        self.cycles = cycles or []
        self.inversions = inversions or []


class _AuditedLock:
    """Wraps a real lock/rlock; reports attempts/acquisitions/releases
    to its audit. Supports the full context-manager + acquire/release
    surface (enough for ``threading.Condition(wrapped)`` too)."""

    def __init__(self, audit: "LockAudit", name: str, inner, kind: str):
        self._audit = audit
        self._name = name
        self._inner = inner
        self._kind = kind

    # threading.Lock surface ------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._audit._note_attempt(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._audit._note_acquired(self)
        return ok

    def release(self):
        self._audit._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    # Condition protocol ----------------------------------------------
    # threading.Condition lifts these from the lock it wraps when they
    # exist; without them it falls back to a release()/acquire(False)
    # dance that is WRONG for a wrapped RLock (the reentrant probe
    # acquire succeeds, so _is_owned reports False and wait() raises
    # "cannot wait on un-acquired lock"). Forwarding keeps
    # Condition(<audited lock>) — including the bare Condition() built
    # under patch mode, whose default lock is an audited RLock —
    # working, and keeps the held-stack accurate across the wait.
    def _release_save(self):
        st = self._audit._stack()
        n = st.count(self._name)
        for _ in range(n):
            self._audit._note_release(self)
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), n)
        self._inner.release()
        return (None, n)

    def _acquire_restore(self, state):
        inner_state, n = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        for _ in range(n):        # restore exactly what _release_save
            self._audit._note_acquired(self)   # popped — never invent


    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock: the stdlib's own probe fallback
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        return f"<audited {self._kind} {self._name!r} of {self._inner!r}>"


class _AuditedCondition:
    """Wraps a real Condition: acquire/release audited; ``wait`` pops
    the held tracking for its sleep (the condition RELEASES the lock)
    and re-pushes on wake, so edges taken while another thread holds
    the lock stay accurate."""

    def __init__(self, audit: "LockAudit", name: str,
                 inner: threading.Condition):
        self._audit = audit
        self._name = name
        self._inner = inner
        self._kind = "condition"

    def acquire(self, *a, **kw):
        self._audit._note_attempt(self)
        ok = self._inner.acquire(*a, **kw)
        if ok:
            self._audit._note_acquired(self)
        return ok

    def release(self):
        self._audit._note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout: Optional[float] = None):
        # re-push only what was actually popped: a wait() that raises
        # because the lock was never held must not plant a phantom
        # held-stack entry (it would fabricate lock-order edges for the
        # rest of the thread's life)
        popped = self._audit._note_release(self)
        try:
            return self._inner.wait(timeout)
        finally:
            if popped:
                self._audit._note_acquired(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        popped = self._audit._note_release(self)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            if popped:
                self._audit._note_acquired(self)

    def notify(self, n: int = 1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()


class LockAudit:
    """Records lock-acquisition orders; see module docstring."""

    def __init__(self, patch: bool = False):
        self._patch = bool(patch)
        self._tls = threading.local()
        self._elock = _RealLock()
        #: (holder, acquired) -> count
        self._edges: Dict[Tuple[str, str], int] = {}
        #: (holder, acquired) -> sample thread name
        self._sample: Dict[Tuple[str, str], str] = {}
        self.names: Set[str] = set()
        self._saved: dict = {}

    # ------------------------------------------------------ construction
    def __enter__(self) -> "LockAudit":
        if self._patch:
            self._saved = {"Lock": threading.Lock,
                           "RLock": threading.RLock}
            audit = self

            def make_lock():
                return _AuditedLock(audit, audit._creation_name("Lock"),
                                    _RealLock(), "lock")

            def make_rlock():
                return _AuditedLock(audit, audit._creation_name("RLock"),
                                    _RealRLock(), "rlock")

            threading.Lock = make_lock
            threading.RLock = make_rlock
        return self

    def __exit__(self, *exc) -> bool:
        if self._saved:
            threading.Lock = self._saved["Lock"]
            threading.RLock = self._saved["RLock"]
            self._saved = {}
        return False

    @staticmethod
    def _defining_class(frame) -> Optional[str]:
        """Class whose body defines the code object executing in
        ``frame`` (not the runtime type — an inherited ``__init__``
        must name the BASE class, matching the static tokens)."""
        slf = frame.f_locals.get("self")
        if slf is None:
            return None
        code = frame.f_code
        for cls in type(slf).__mro__:
            fn = cls.__dict__.get(code.co_name)
            fn = getattr(fn, "__func__", fn)
            if getattr(fn, "__code__", None) is code:
                return cls.__name__
        return type(slf).__name__

    def _creation_name(self, factory: str) -> str:
        """Name a factory-made lock from its creation site:
        ``Class.attr`` when the source line is ``self.attr = ...``,
        else ``file:line``."""
        f = sys._getframe(1)
        while f is not None:
            base = f.f_code.co_filename.replace("\\", "/").rsplit(
                "/", 1)[-1]
            # skip stdlib frames (threading.Event/queue.Queue build
            # their locks inside threading.py/queue.py) and our own
            if base not in ("threading.py", "queue.py",
                            "lock_audit.py", "socketserver.py"):
                break
            f = f.f_back
        if f is None:                     # pragma: no cover — defensive
            return f"<{factory}>"
        line = linecache.getline(f.f_code.co_filename, f.f_lineno).strip()
        attr = None
        if line.startswith("self.") and "=" in line:
            attr = line[len("self."):].split("=", 1)[0].strip()
            if not attr.isidentifier():
                attr = None
        cls = self._defining_class(f)
        if attr and cls:
            name = f"{cls}.{attr}"
        elif attr:
            name = f"{f.f_code.co_name}.{attr}"
        else:
            short = f.f_code.co_filename.rsplit("/", 1)[-1]
            name = f"{short}:{f.f_lineno}"
        with self._elock:
            self.names.add(name)
        return name

    def wrap(self, lock, name: str):
        """Explicitly wrap one lock/rlock/condition under ``name``."""
        with self._elock:
            self.names.add(name)
        if isinstance(lock, threading.Condition):
            return _AuditedCondition(self, name, lock)
        kind = "rlock" if type(lock) is type(_RealRLock()) else "lock"
        return _AuditedLock(self, name, lock, kind)

    def instrument(self, obj,
                   names: Optional[Dict[str, str]] = None) -> List[str]:
        """Wrap every lock-like attribute of ``obj`` in place; returns
        the audited names. ``names`` overrides per-attr identities
        (e.g. ``{"_lock": "HeartbeatMonitor._lock"}`` to pin a lock to
        its defining base class)."""
        lock_t = type(_RealLock())
        rlock_t = type(_RealRLock())
        out = []
        for attr, val in sorted(vars(obj).items()):
            if isinstance(val, (_AuditedLock, _AuditedCondition)):
                continue
            if isinstance(val, (lock_t, rlock_t, threading.Condition)):
                name = (names or {}).get(
                    attr, f"{type(obj).__name__}.{attr}")
                setattr(obj, attr, self.wrap(val, name))
                out.append(name)
        return out

    # --------------------------------------------------------- recording
    def _stack(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _note_attempt(self, lock) -> None:
        st = self._stack()
        name = lock._name
        if name in st:                    # re-entry (rlock): no edge
            return
        if st:
            thread = threading.current_thread().name
            with self._elock:
                for h in set(st):
                    if h != name:
                        k = (h, name)
                        self._edges[k] = self._edges.get(k, 0) + 1
                        self._sample.setdefault(k, thread)

    def _note_acquired(self, lock) -> None:
        self._stack().append(lock._name)

    def _note_release(self, lock) -> bool:
        """Pop the newest held-stack entry for ``lock``; returns whether
        one existed (callers that restore state re-push only then)."""
        st = self._stack()
        name = lock._name
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return True
        return False

    # ----------------------------------------------------------- queries
    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._elock:
            return dict(self._edges)

    def edge_list(self) -> List[Tuple[str, str]]:
        return sorted(self.edges())

    def cycles(self) -> List[List[str]]:
        """Cycles among the OBSERVED edges (Tarjan SCCs of size > 1) —
        the same SCC routine the static graph uses, so the two layers
        cannot drift apart on what counts as a cycle."""
        from .callgraph import tarjan_sccs
        succ: Dict[str, Set[str]] = {}
        for a, b in self.edges():
            succ.setdefault(a, set()).add(b)
            succ.setdefault(b, set())
        return tarjan_sccs(succ)

    def check(self) -> None:
        cyc = self.cycles()
        if cyc:
            raise LockOrderError(
                f"lock-order cycle(s) observed at runtime: {cyc} "
                f"(edges: {self.edge_list()})", cycles=cyc)

    # -------------------------------------------------------- cross-check
    @staticmethod
    def _static_tails(static_edges: Iterable[Tuple[str, str]]
                      ) -> Set[Tuple[str, str]]:
        """Static tokens ('pkg/mod.py:Owner.attr') -> 'Owner.attr'."""
        out = set()
        for a, b in static_edges:
            ta = a.split(":", 1)[-1]
            tb = b.split(":", 1)[-1]
            out.add((ta, tb))
        return out

    def cross_check(self, static_edges: Iterable[Tuple[str, str]],
                    known: Optional[Set[str]] = None) -> dict:
        """Compare dynamic edges with the static graph.

        ``known`` restricts the comparison to dynamic lock names the
        static analysis models (default: names appearing in the static
        edge set) — patch-mode audits also see stdlib-internal locks the
        AST pass never claims to cover.

        Returns ``{"explained": [...], "novel": [...],
        "inversions": [...]}``; **inversions** (a dynamic edge whose
        reverse is statically reachable, or a dynamic cycle) are the
        failures — a lock order the static graph calls wrong actually
        happened."""
        stat = self._static_tails(static_edges)
        nodes: Set[str] = set()
        succ: Dict[str, Set[str]] = {}
        for a, b in stat:
            nodes.update((a, b))
            succ.setdefault(a, set()).add(b)
        if known is None:
            known = nodes

        def reachable(src: str, dst: str) -> bool:
            seen = {src}
            frontier = [src]
            while frontier:
                v = frontier.pop()
                for w in succ.get(v, ()):
                    if w == dst:
                        return True
                    if w not in seen:
                        seen.add(w)
                        frontier.append(w)
            return False

        explained, novel, inversions = [], [], []
        dyn = self.edge_list()
        dyn_set = set(dyn)
        for a, b in dyn:
            if a not in known or b not in known:
                continue
            if (b, a) in dyn_set or reachable(b, a):
                inversions.append((a, b))
            elif (a, b) in stat or reachable(a, b):
                explained.append((a, b))
            else:
                novel.append((a, b))
        return {"explained": explained, "novel": novel,
                "inversions": inversions}
