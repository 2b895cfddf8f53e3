"""Runtime audits of the port's compile work and host readbacks.

The port runs no ``torch.compile`` and captures no CUDA graph: its only
compile work is ``kernels/cuda_lib.py``, which builds each kernel
library with one nvcc process (``build``) and loads it with ctypes
(``load``), both keyed by the hash of the kernel sources. A steady-state
region must do neither: an nvcc run or a load after warmup is a cold
start on the serving path (seconds to minutes), and a library built or
loaded twice in one process under the same hash means the loader's cache
was blown. ``cuda_lib.record_compile`` is the counting seam: it appends
each build and each load, as ``(kind, library, source hash)``, to the
process's ordered log ``cuda_lib.compile_events()`` and changes nothing
else. :class:`CompileAudit` reads the part of that log written during a
``with`` block, with the JAX package's API:

- ``counts[library]`` — builds + loads per library;
- ``signatures[library][f"{kind}@{hash}"]`` — events per (library,
  kind, source hash): a signature seen TWICE is the blown cache;
- ``retraces()`` / ``duplicate_signature_compiles`` — that detector;
- ``snapshot()`` / ``delta()``, ``report()``, ``builds()`` / ``loads()``;
- ``check(budget=..., total=...)`` — raises :class:`CompileBudgetError`.
  ``check(total=0)`` around a warm region is the port's counterpart of
  the JAX package's zero-steady-state-compile gate.

:meth:`CompileAudit.process` is the same view over every event of the
process so far.

:class:`TransferAudit` is its sibling for host syncs: per-tag
device→host readback counts through the ``ops.transfer.device_fetch``
seam, with a ≤ 1-readback-per-decode-block budget check.

Usage::

    with CompileAudit() as audit, TransferAudit() as transfers:
        engine.run_until_drained()
    audit.check(total=0)
    transfers.check_per_block("engine.decode",
                              engine.stats()["decode_blocks"])
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple


class CompileBudgetError(AssertionError):
    """An audited region built or loaded more than its budget allows."""


class TransferBudgetError(AssertionError):
    """An audited region read back from device more than its budget
    allows (e.g. more than one host sync per decode block)."""


class TransferAudit:
    """Counts device→host readbacks within a ``with`` block.

    A decode loop that blocks on a readback after every dispatched step
    serializes host time behind device time and caps tok/s at 1/RTT
    however fast the kernels are. The serving path routes every
    deliberate readback through :func:`..ops.transfer.device_fetch` with
    a tag (``engine.decode``, ``engine.prefill``, ...); this audit
    snapshots the per-tag counters on entry and reports the delta, so
    concurrent engines and audits never clobber each other.

    ``check_per_block(tag, blocks)`` asserts the pipelined-decode
    invariant: at most ``max_per_block`` readbacks per decode block (the
    engine's ``decode_blocks`` stat)."""

    def __init__(self):
        self._start: Dict[str, int] = {}
        self._end: Optional[Dict[str, int]] = None

    def __enter__(self) -> "TransferAudit":
        from ..ops import transfer
        self._transfer = transfer
        self._start = transfer.fetch_counts()
        self._end = None
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._end = self._transfer.fetch_counts()

    def fetches(self, tag: Optional[str] = None) -> int:
        """Readbacks since entry (one tag, or all tags summed). Live
        inside the block; frozen at exit."""
        now = self._end if self._end is not None \
            else self._transfer.fetch_counts()
        delta = {t: c - self._start.get(t, 0) for t, c in now.items()}
        if tag is not None:
            return delta.get(tag, 0)
        return sum(delta.values())

    def report(self) -> Dict[str, int]:
        """Per-tag readback deltas (zero-delta tags omitted)."""
        now = self._end if self._end is not None \
            else self._transfer.fetch_counts()
        return {t: c - self._start.get(t, 0) for t, c in sorted(now.items())
                if c - self._start.get(t, 0) > 0}

    def shards(self, tag: str) -> int:
        """Mesh shards the most recent fetch under ``tag`` gathered: one
        logical readback off a (data, tp) serving mesh reads data x tp
        shards."""
        return self._transfer.fetch_shards(tag).get(tag, 1)

    def check_per_block(self, tag: str, blocks: int,
                        max_per_block: float = 1.0) -> None:
        """Assert ≤ ``max_per_block`` readbacks under ``tag`` per decode
        block; raises :class:`TransferBudgetError` otherwise. ``blocks``
        of 0 demands zero readbacks."""
        got = self.fetches(tag)
        if got > max_per_block * blocks:
            raise TransferBudgetError(
                f"{tag}: {got} host readbacks over {blocks} decode "
                f"block(s) exceeds {max_per_block}/block")


class CompileAudit:
    """Context manager counting kernel-library builds and loads.

    ``budget``: optional {library: max events} checked on clean exit
    (plus ``total_budget`` for the sum); violations raise
    :class:`CompileBudgetError`. The counts are live inside the block
    and frozen at exit."""

    def __init__(self, budget: Optional[Dict[str, int]] = None,
                 total_budget: Optional[int] = None):
        self.budget = dict(budget or {})
        self.total_budget = total_budget
        self._events: Optional[List[Tuple[str, str, str]]] = []
        self._start: Optional[int] = None

    @classmethod
    def process(cls) -> "CompileAudit":
        """An audit of every build and load this process has made."""
        from ..kernels import cuda_lib
        audit = cls()
        audit._events = cuda_lib.compile_events()
        return audit

    def __enter__(self) -> "CompileAudit":
        from ..kernels import cuda_lib
        self._start = len(cuda_lib.compile_events())
        self._events = None
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._events = self._read()
        if exc_type is None and (self.budget or
                                 self.total_budget is not None):
            self.check(self.budget, self.total_budget)

    # ------------------------------------------------------------ results
    def _read(self) -> List[Tuple[str, str, str]]:
        if self._events is not None:
            return self._events
        from ..kernels import cuda_lib
        return cuda_lib.compile_events()[self._start:]

    @property
    def counts(self) -> Counter:
        """{library: builds + loads}."""
        return Counter(name for _, name, _ in self._read())

    @property
    def signatures(self) -> Dict[str, Counter]:
        """{library: {"kind@hash": events}}."""
        sigs: Dict[str, Counter] = defaultdict(Counter)
        for kind, name, digest in self._read():
            sigs[name][f"{kind}@{digest}"] += 1
        return sigs

    def _kind_counts(self, kind: str) -> Dict[str, int]:
        """{library: events of ``kind``}, libraries without one left
        out."""
        return dict(sorted(Counter(name for k, name, _ in self._read()
                                   if k == kind).items()))

    def builds(self, name: Optional[str] = None):
        """nvcc runs per library ({library: n}), or of one library."""
        counts = self._kind_counts("build")
        return counts.get(name, 0) if name is not None else counts

    def loads(self, name: Optional[str] = None):
        """ctypes loads per library ({library: n}), or of one library."""
        counts = self._kind_counts("load")
        return counts.get(name, 0) if name is not None else counts

    @property
    def total_compiles(self) -> int:
        return len(self._read())

    def compiles(self, name: str) -> int:
        return self.counts.get(name, 0)

    def retraces(self) -> Dict[str, dict]:
        """Libraries with more than one event: how many, how many
        DISTINCT (kind, hash) signatures, and how many repeated an
        already-seen signature (the loader's cache blown)."""
        out = {}
        signatures = self.signatures
        for name, c in self.counts.items():
            if c <= 1:
                continue
            sigs = signatures[name]
            out[name] = {
                "compiles": c,
                "distinct_signatures": len(sigs),
                "duplicate_signature_compiles": sum(
                    k - 1 for k in sigs.values() if k > 1),
            }
        return out

    @property
    def duplicate_signature_compiles(self) -> int:
        """Builds or loads that repeated an already-seen (library, kind,
        hash) — a process demands this be ZERO."""
        return sum(r["duplicate_signature_compiles"]
                   for r in self.retraces().values())

    def snapshot(self) -> Counter:
        return self.counts

    def delta(self, since: Counter) -> Dict[str, int]:
        """Per-library events since ``snapshot()`` — zero in any
        steady-state region."""
        now = self.snapshot()
        return {n: now[n] - since.get(n, 0) for n in now
                if now[n] > since.get(n, 0)}

    def report(self) -> dict:
        return {
            "total_compiles": self.total_compiles,
            "per_function": dict(sorted(self.counts.items())),
            "builds": self.builds(),
            "loads": self.loads(),
            "retraced": self.retraces(),
            "duplicate_signature_compiles":
                self.duplicate_signature_compiles,
        }

    def check(self, budget: Optional[Dict[str, int]] = None,
              total: Optional[int] = None,
              forbid_duplicate_signatures: bool = False) -> None:
        """Raise CompileBudgetError on any budget violation."""
        problems = []
        for name, cap in (budget or {}).items():
            got = self.counts.get(name, 0)
            if got > cap:
                problems.append(f"{name}: {got} builds/loads > budget "
                                f"{cap} ({dict(self.signatures[name])})")
        if total is not None and self.total_compiles > total:
            problems.append(f"total: {self.total_compiles} builds/loads > "
                            f"budget {total} ({dict(self.counts)})")
        if forbid_duplicate_signatures and \
                self.duplicate_signature_compiles:
            problems.append(
                "duplicate-signature builds/loads (cache blown): "
                f"{self.retraces()}")
        if problems:
            raise CompileBudgetError("; ".join(problems))
