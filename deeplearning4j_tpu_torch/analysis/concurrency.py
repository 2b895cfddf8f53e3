"""Interprocedural concurrency pass: GL009-GL012 over the package call
graph (:mod:`.callgraph`) — the JAX package's ``analysis/concurrency.py``,
copied: the rules do not depend on the framework.

- **GL009 lock-order inversion** — build the lock-acquisition graph
  (edge A->B when B is acquired while A is held, including through any
  chain of package-resolvable calls) and flag every edge that
  participates in a cycle: two threads taking the cycle's locks in
  opposing orders deadlock. Re-acquiring a non-reentrant lock through a
  call chain (a self-loop) is the same bug with one thread.
- **GL010 blocking call under a held lock** — ``sendall``/``recv``/
  ``accept``/``connect``, thread ``join``, ``time.sleep``,
  ``device_fetch``/``block_until_ready``, blocking ``queue.get/put``,
  and HTTP serving/requests executed (directly or transitively) while
  holding a lock: every other thread needing that lock now waits on the
  network/device/scheduler too. ``Condition.wait`` on a HELD condition
  is exempt (it releases the lock; GL011 owns its discipline).
- **GL011 condition-wait discipline** — ``Condition.wait`` outside a
  predicate re-check loop (wakeups are spurious and racy by contract),
  ``wait`` without the condition's lock held, ``notify`` without it.
- **GL012 untracked non-daemon thread** — a ``threading.Thread`` that
  is neither ``daemon=True`` nor joined anywhere in its class/module
  outlives shutdown silently and blocks interpreter exit.

The pass computes, per function, the transitive lock-acquisition and
blocking summaries by fixpoint over resolved call edges; call-site
lock-argument bindings substitute parameter-lock tokens (so a module
helper that takes a lock and blocks inside it is attributed to each
caller's concrete lock). Findings honor the same inline
``# graftlint: disable=`` suppression as the per-file passes.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from .callgraph import ModuleFacts, PackageIndex

#: cap on witness-path length in messages
_PATH_CAP = 5


def _tail(token: str) -> str:
    """Human-readable lock name: 'pkg/mod.py:Class._lock' -> 'Class._lock'."""
    return token.split(":", 1)[1] if ":" in token else token


class LockOrderGraph:
    """Directed lock-acquisition graph with per-edge witness sites."""

    def __init__(self):
        #: (a, b) -> list of site dicts {module, func, line, via}
        self.edges: Dict[Tuple[str, str], List[dict]] = {}

    def add(self, a: str, b: str, site: dict) -> None:
        if a == b:
            return                      # self-edges handled separately
        self.edges.setdefault((a, b), []).append(site)

    def succ(self) -> Dict[str, Set[str]]:
        out: Dict[str, Set[str]] = {}
        for a, b in self.edges:
            out.setdefault(a, set()).add(b)
            out.setdefault(b, set())
        return out

    def cycles(self) -> List[List[str]]:
        """Strongly connected components with >= 2 locks, each returned
        as a deterministic lock list."""
        from .callgraph import tarjan_sccs
        return tarjan_sccs(self.succ())

    def edge_list(self) -> List[Tuple[str, str]]:
        return sorted(self.edges)


class ConcurrencyAnalysis:
    """Runs the fixpoint + rule checks over extracted module facts."""

    def __init__(self, modules: Dict[str, ModuleFacts]):
        self.index = PackageIndex(modules)
        self.modules = modules
        self.lock_kinds = self.index.lock_kinds()
        #: fq = (module, qual) -> {lock: witness [fq names]}
        self.acq_trans: Dict[Tuple[str, str], Dict[str, List[str]]] = {}
        #: fq -> {kind: (line, witness [fq names])}
        self.blk_trans: Dict[Tuple[str, str],
                             Dict[str, Tuple[int, List[str]]]] = {}
        self.graph = LockOrderGraph()
        self._resolved_calls: Dict[Tuple[str, str],
                                   List[Tuple[dict, Tuple[str, str]]]] = {}
        self._run_fixpoint()
        self._build_graph()

    # --------------------------------------------------------- summaries
    def _bindings_map(self, callee_mod: str, callee_qual: str,
                      call: dict) -> Dict[str, str]:
        """Map the callee's parameter-lock tokens to the caller's
        concrete lock tokens for this call site."""
        mf = self.modules[callee_mod]
        fd = mf.functions.get(callee_qual)
        if fd is None or not call.get("bindings"):
            return {}
        params = fd.get("param_names", [])
        # methods called via self/attr dispatch: positional arg 0 maps
        # to params[1] (after self). Plain functions — and the
        # explicit-self form `Base.meth(self, lock)`, where self IS
        # positional arg 0 — map 0 -> params[0].
        shift = 1 if "." in callee_qual and params[:1] == ["self"] and \
            not call["callee"].get("explicit_self") else 0
        out: Dict[str, str] = {}
        for pos_s, tok in call["bindings"].items():
            i = int(pos_s) + shift
            if i < len(params):
                pname = params[i]
                out[f"{callee_mod}:{callee_qual}.{pname}"] = tok
        return out

    def _run_fixpoint(self) -> None:
        # seed with local facts and resolve every call site once
        for mod, qual, fn in self.index.all_functions():
            fq = (mod, qual)
            self.acq_trans[fq] = {a["lock"]: [] for a in fn.acquires}
            blocks: Dict[str, Tuple[int, List[str]]] = {}
            for b in fn.blocks:
                blocks.setdefault(b["kind"], (b["line"], []))
            self.blk_trans[fq] = blocks
            resolved = []
            for call in fn.calls:
                tgt = self.index.resolve_call(mod, qual, call)
                if tgt is not None and tgt != fq:
                    resolved.append((call, tgt))
            self._resolved_calls[fq] = resolved
        changed = True
        iters = 0
        while changed and iters < 50:
            changed = False
            iters += 1
            for fq, calls in self._resolved_calls.items():
                mod, qual = fq
                for call, tgt in calls:
                    sub = self._bindings_map(tgt[0], tgt[1], call)
                    for lock, wit in self.blk_and_acq(tgt)[0].items():
                        lock = sub.get(lock, lock)
                        if lock not in self.acq_trans[fq]:
                            self.acq_trans[fq][lock] = \
                                [f"{tgt[1]}"] + wit[:_PATH_CAP]
                            changed = True
                    for kind, (line, wit) in \
                            self.blk_and_acq(tgt)[1].items():
                        if kind not in self.blk_trans[fq]:
                            self.blk_trans[fq][kind] = (
                                call["line"],
                                [f"{tgt[1]}"] + wit[:_PATH_CAP])
                            changed = True

    def blk_and_acq(self, fq: Tuple[str, str]):
        return (self.acq_trans.get(fq, {}), self.blk_trans.get(fq, {}))

    # ------------------------------------------------------------- graph
    def _build_graph(self) -> None:
        for mod, qual, fn in self.index.all_functions():
            fq = (mod, qual)
            for a in fn.acquires:
                for h in a["held"]:
                    self.graph.add(h, a["lock"],
                                   {"module": mod, "func": qual,
                                    "line": a["line"], "via": []})
            for call, tgt in self._resolved_calls[fq]:
                if not call["held"]:
                    continue
                sub = self._bindings_map(tgt[0], tgt[1], call)
                for lock, wit in self.acq_trans.get(tgt, {}).items():
                    lock = sub.get(lock, lock)
                    via = [tgt[1]] + wit[:_PATH_CAP]
                    for h in call["held"]:
                        self.graph.add(h, lock,
                                       {"module": mod, "func": qual,
                                        "line": call["line"], "via": via})

    # ------------------------------------------------------------- rules
    def findings(self, enabled: Set[str], emit) -> None:
        """Invoke ``emit(rule, module, line, func, message)`` for every
        finding (the caller owns Finding construction + suppression)."""
        if "GL009" in enabled:
            self._check_lock_order(emit)
        if "GL010" in enabled:
            self._check_blocking(emit)
        if "GL011" in enabled:
            self._check_wait_discipline(emit)
        if "GL012" in enabled:
            self._check_threads(emit)

    def _check_lock_order(self, emit) -> None:
        cyclic: Set[str] = set()
        cycle_of: Dict[str, List[str]] = {}
        for cyc in self.graph.cycles():
            for lock in cyc:
                cyclic.add(lock)
                cycle_of[lock] = cyc
        for (a, b), sites in sorted(self.graph.edges.items()):
            if a in cyclic and b in cycle_of.get(a, ()):  # edge in an SCC
                cyc = cycle_of[a]
                site = sites[0]
                via = (" via " + " -> ".join(site["via"])) \
                    if site["via"] else ""
                emit("GL009", site["module"], site["line"], site["func"],
                     f"acquires {_tail(b)} while holding {_tail(a)}{via}, "
                     "closing a lock-order cycle "
                     f"[{' -> '.join(_tail(c) for c in cyc)}] — threads "
                     "taking these locks in opposing orders deadlock; "
                     "pick one global order (or merge the locks)")
        # self-deadlock: re-acquiring a held non-reentrant lock through a
        # call chain
        for mod, qual, fn in self.index.all_functions():
            fq = (mod, qual)
            for call, tgt in self._resolved_calls[fq]:
                if not call["held"]:
                    continue
                sub = self._bindings_map(tgt[0], tgt[1], call)
                for lock, wit in self.acq_trans.get(tgt, {}).items():
                    lock = sub.get(lock, lock)
                    if lock in call["held"] and \
                            self.lock_kinds.get(lock, "lock") == "lock":
                        emit("GL009", mod, call["line"], qual,
                             f"call re-acquires non-reentrant "
                             f"{_tail(lock)} already held here (via "
                             f"{' -> '.join([tgt[1]] + wit[:_PATH_CAP])})"
                             " — single-thread deadlock")

    def _check_blocking(self, emit) -> None:
        for mod, qual, fn in self.index.all_functions():
            fq = (mod, qual)
            for b in fn.blocks:
                if not b["held"]:
                    continue
                held = ", ".join(sorted(_tail(h) for h in b["held"]))
                emit("GL010", mod, b["line"], qual,
                     f"{b['kind']} ({b['what']}) while holding {held} — "
                     "every thread needing the lock now waits on this "
                     "too; move the blocking call outside the critical "
                     "section or bound it")
            for w in fn.waits:
                # Event/other .wait() under a DIFFERENT held lock blocks
                # with the lock held; waiting on a held condition is the
                # sanctioned sleep (it releases the lock) -> GL011's job
                if not w["held"]:
                    continue
                if w["lock"] is not None and w["lock"] in w["held"]:
                    continue
                held = ", ".join(sorted(_tail(h) for h in w["held"]))
                emit("GL010", mod, w["line"], qual,
                     f"{w['recv']}.wait() while holding {held} — the "
                     "waiter sleeps with the lock held (the setter may "
                     "need that very lock); wait outside the critical "
                     "section or use a Condition on the same lock")
            for call, tgt in self._resolved_calls[fq]:
                if not call["held"]:
                    continue
                for kind, (line, wit) in \
                        self.blk_trans.get(tgt, {}).items():
                    held = ", ".join(sorted(_tail(h)
                                            for h in call["held"]))
                    path = " -> ".join([tgt[1]] + wit[:_PATH_CAP])
                    emit("GL010", mod, call["line"], qual,
                         f"call chain {path} performs {kind} while "
                         f"holding {held} — blocking work reached from "
                         "a critical section; hoist the call or shrink "
                         "the locked region")

    def _check_wait_discipline(self, emit) -> None:
        for mod, qual, fn in self.index.all_functions():
            for w in fn.waits:
                if w.get("kind") != "condition":
                    continue             # Event.wait etc: not GL011
                if w["lock"] is not None and w["lock"] not in w["held"]:
                    emit("GL011", mod, w["line"], qual,
                         f"{w['recv']}.wait() without the condition's "
                         "lock held — Condition.wait requires the lock "
                         "(RuntimeError at runtime); wrap in "
                         f"`with {w['recv']}:`")
                if not w["in_loop"]:
                    emit("GL011", mod, w["line"], qual,
                         f"{w['recv']}.wait() outside a predicate "
                         "re-check loop — wakeups are spurious and "
                         "racy by contract; use "
                         "`while not <predicate>: wait()` (or wait_for)")
            for n in fn.notifies:
                if n.get("kind") != "condition":
                    continue
                if n["lock"] is not None and n["lock"] not in n["held"]:
                    emit("GL011", mod, n["line"], qual,
                         f"{n['recv']}.notify() without the condition's "
                         "lock held — the waiter can miss the wakeup "
                         "(check-then-wait race); notify under "
                         f"`with {n['recv']}:`")

    def _check_threads(self, emit) -> None:
        # join tracking: the thread's ASSIGNMENT NAME (`t = Thread(...)`
        # / `self._worker = Thread(...)`) must be joined somewhere in
        # its module (self-attrs: anywhere in the module — takeover/
        # shutdown paths often live on sibling classes). An unassigned
        # non-daemon `Thread(...).start()` has no join handle at all.
        joined_names: Dict[str, Set[str]] = {}
        for mod, qual, fn in self.index.all_functions():
            if fn.joins:
                joined_names.setdefault(mod, set()).update(fn.joins)
        for mod, qual, fn in self.index.all_functions():
            joined = joined_names.get(mod, set())
            for t in fn.threads:
                if t["daemon"] is True:
                    continue
                assigned = t.get("assigned")
                if assigned is not None and assigned in joined:
                    continue
                what = t["target"] or "<unnamed target>"
                emit("GL012", mod, t["line"], qual,
                     f"non-daemon Thread(target={what}) started with no "
                     f"tracked join path ("
                     f"{'assigned to ' + repr(assigned) if assigned else 'never assigned'}"
                     ", never joined in this module) — it outlives "
                     "shutdown and blocks interpreter exit; pass "
                     "daemon=True or join it")


def analyze(modules: Dict[str, ModuleFacts]) -> ConcurrencyAnalysis:
    return ConcurrencyAnalysis(modules)


def lock_order_edges(modules: Dict[str, ModuleFacts]
                     ) -> Dict[Tuple[str, str], List[dict]]:
    """The static lock-acquisition edge set (token pairs with witness
    sites) — the contract :class:`..lock_audit.LockAudit.cross_check`
    verifies dynamically observed orders against."""
    return analyze(modules).graph.edges
