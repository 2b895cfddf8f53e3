"""graftlint for the port — dispatch-discipline static analysis, the
interprocedural concurrency pass, and the runtime lock, transfer and
compile audits.

The serving path (``models/generation.py``'s decode loop) and every
train step live or die on dispatch discipline: one stray host sync in a
decode seam stalls the CUDA queue once per block, a metric stamped on
the dispatch path records enqueue time, and a kernel library rebuilt
after warmup is a cold start. This subsystem machine-checks those
invariants over the port's own tree:

- :mod:`.lint` — AST passes over the package flagging host syncs,
  Python loops over tensor dims, branches on tensor values and numpy on
  tensors in *hot context* (what runs once per decode block or train
  step), blocking readbacks of just-dispatched results in loops,
  telemetry on the dispatch path, and unlocked shared writes in thread
  targets, with a checked-in ``baseline.json`` so the gate fails only on
  NEW violations (``python scripts/torch_lint.py --fail-on-new``).
- :mod:`.callgraph` + :mod:`.concurrency` — the whole-package call graph
  and lock-acquisition graph driving GL009 lock-order inversions, GL010
  blocking-under-lock, GL011 condition-wait discipline, GL012 untracked
  threads.
- :mod:`.sharding` — GL013 mesh-axis consistency of ``P(...)`` specs and
  GL014 host syncs or telemetry inside the per-shard bodies of the
  one-controller loop.
- :mod:`.lock_audit` — :class:`LockAudit`, the runtime counterpart of
  GL009/GL010: instrumented locks record ACTUAL acquisition orders and
  are cross-checked against the static graph.
- :mod:`.compile_audit` — :class:`CompileAudit`, counting kernel-library
  builds and loads through ``kernels/cuda_lib.py``'s seam (zero after
  warmup), and :class:`TransferAudit`, per-tag device→host readback
  counts through ``ops.transfer.device_fetch`` with a ≤ 1-readback-per-
  decode-block budget check.

Neither this package nor ``scripts/torch_lint.py`` imports JAX or the
JAX package; importing it imports no torch until an audit is entered.
"""

from .compile_audit import (CompileAudit, CompileBudgetError, TransferAudit,
                            TransferBudgetError)
from .lint import (Finding, LintCache, LintRunner, RULES,
                   collect_package_facts, load_baseline, lint_paths,
                   new_findings, write_baseline)
from .lock_audit import LockAudit, LockOrderError

__all__ = [
    "CompileAudit", "CompileBudgetError", "TransferAudit",
    "TransferBudgetError", "Finding", "LintCache", "LintRunner", "RULES",
    "LockAudit", "LockOrderError", "collect_package_facts",
    "lint_paths", "load_baseline", "new_findings", "write_baseline",
]
