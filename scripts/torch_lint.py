#!/usr/bin/env python
"""graftlint CLI for the PyTorch port — dispatch- and
concurrency-discipline static analysis of ``deeplearning4j_tpu_torch``
with a baseline gate.

    python scripts/torch_lint.py                  # report all findings
    python scripts/torch_lint.py --fail-on-new    # gate: exit 1 only on
                                                  # findings NOT in the
                                                  # port's analysis/
                                                  # baseline.json
    python scripts/torch_lint.py --write-baseline # re-record the baseline
                                                  # (prints the key diff)
    python scripts/torch_lint.py --select GL009,GL010   # only these rules
    python scripts/torch_lint.py --ignore GL002   # all rules but these
    python scripts/torch_lint.py --json           # machine-readable output
    python scripts/torch_lint.py --no-cache       # force full re-analysis

Rules GL001-GL008 are per-module (host syncs, loops and branches on
tensors in hot context — what runs once per decode block or train step —,
locks, readbacks); GL009-GL012 are the interprocedural concurrency pass
over the package call graph (lock-order cycles, blocking under locks,
wait discipline, untracked threads); GL013-GL014 gate the mesh specs and
the per-shard bodies. Per-file results are cached (mtime+size fast path,
content hash on mismatch) in ``.graftlint_torch_cache.json`` so the gate
re-analyzes only changed files; the package pass recomputes from cached
facts every run.

The gate contract: the checked-in baseline suppresses reviewed
violations; any NEW violation (or a second instance of a baselined one)
fails fast. Fix it or — only with a reviewed justification — annotate
``# graftlint: disable=GLxxx`` / re-record the baseline.
No jax or torch import, no device: pure AST, safe anywhere.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from deeplearning4j_tpu_torch.analysis.lint import (  # noqa: E402
    RULES, LintCache, LintRunner, load_baseline, new_findings,
    write_baseline)

DEFAULT_BASELINE = os.path.join(REPO_ROOT, "deeplearning4j_tpu_torch",
                                "analysis", "baseline.json")
DEFAULT_CACHE = os.environ.get(
    "GRAFTLINT_TORCH_CACHE",
    os.path.join(REPO_ROOT, ".graftlint_torch_cache.json"))
DEFAULT_PATHS = [os.path.join(REPO_ROOT, "deeplearning4j_tpu_torch"),
                 os.path.join(REPO_ROOT, "chip_smoke.py")]


def _parse_rules(ap, spec):
    rules = [r.strip() for r in spec.split(",") if r.strip()]
    unknown = set(rules) - set(RULES)
    if unknown:
        ap.error(f"unknown rules: {sorted(unknown)}")
    return rules


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: the port's "
                         "package + chip_smoke.py)")
    ap.add_argument("--rules", default=None,
                    help="deprecated alias for --select")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run (default: all)")
    ap.add_argument("--ignore", default=None,
                    help="comma-separated rule ids to skip")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 only on findings not covered by the "
                         "baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current findings as the new baseline "
                         "and print the added/removed key diff")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--json", action="store_true",
                    help="shorthand for --format json")
    ap.add_argument("--cache", default=DEFAULT_CACHE,
                    help="per-file result cache path (mtime+hash keyed)")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the cache")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, desc in sorted(RULES.items()):
            print(f"{rid}  {desc}")
        return 0
    if args.json:
        args.format = "json"

    rules = None
    select = args.select or args.rules
    if select:
        rules = _parse_rules(ap, select)
    if args.ignore:
        ignored = set(_parse_rules(ap, args.ignore))
        rules = [r for r in (rules or sorted(RULES)) if r not in ignored]

    t0 = time.perf_counter()
    cache = None if args.no_cache else LintCache(args.cache)
    paths = args.paths or DEFAULT_PATHS
    runner = LintRunner(REPO_ROOT, rules, cache=cache)
    findings = runner.lint(paths)
    wall = time.perf_counter() - t0
    cache_note = "" if cache is None else \
        f", cache {cache.hits} hit(s)/{cache.misses} miss(es)"

    if args.write_baseline:
        old = load_baseline(args.baseline)
        data = write_baseline(args.baseline, findings)
        new = dict(data["suppressed"])
        added = sorted(k for k in new if new[k] > old.get(k, 0))
        removed = sorted(k for k in old if old[k] > new.get(k, 0))
        print(f"baseline: {data['total']} finding(s) across "
              f"{len(new)} key(s) -> {args.baseline}")
        for k in added:
            print(f"  + {k}")
        for k in removed:
            print(f"  - {k}")
        if not (added or removed):
            print("  (no baseline churn)")
        return 0

    baseline = load_baseline(args.baseline)
    fresh = new_findings(findings, baseline)
    shown = fresh if args.fail_on_new else findings

    if args.format == "json":
        print(json.dumps({
            "total": len(findings),
            "new": len(fresh),
            "baseline_keys": len(baseline),
            "wall_seconds": round(wall, 3),
            "cache": None if cache is None else
            {"hits": cache.hits, "misses": cache.misses},
            "parse_errors": runner.errors,
            "findings": [f.to_dict() for f in shown],
        }, indent=1))
    else:
        for f in shown:
            print(f)
        for e in runner.errors:
            print(f"PARSE ERROR: {e}", file=sys.stderr)
        tag = "new " if args.fail_on_new else ""
        print(f"graftlint: {len(shown)} {tag}finding(s) "
              f"({len(findings)} total, {len(baseline)} baselined "
              f"key(s)) in {wall:.2f}s{cache_note}")

    # fail CLOSED: unreadable/unparseable/missing inputs mean unknown
    # coverage — code the gate cannot see must not pass it green
    if runner.errors:
        return 2
    if args.fail_on_new:
        return 1 if fresh else 0
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
