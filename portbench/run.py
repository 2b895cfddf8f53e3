"""Run one cell of the benchmark of ``deeplearning4j_tpu_torch``:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Prints one JSON result line last on standard output and the
numbers compared, each beside its limit, last on standard error. Exits
non-zero without a result where there is no such card, where the program
cannot be loaded, or where JAX or the JAX package was loaded.

The program's kernel libraries are built into the checkout
(``build/kernels/``) by the first run and loaded from there by the next;
that build is reported on its own line before the result."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _power_limit():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    args = _args(argv)
    import torch
    from portbench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        _say(f"needs {cell['chips']} CUDA card(s); "
             f"cuda available: {torch.cuda.is_available()}, cards: "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from deeplearning4j_tpu_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    built = cuda_lib.build(cuda_lib.ENTRIES)
    if built:
        _say(f"build: {sorted(built)} in {time.perf_counter() - t0:.3f} s "
             f"(nvcc, first run in this checkout; part of setup_s)")
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"]}
    line, where, window = harness.run(cell, args.seed, args.seconds,
                                      bool(args.trace), device, T_PROCESS,
                                      info)
    found = harness.forbidden_modules(sys.modules)
    if found:
        _say(f"loaded in this process, which the benchmark forbids: {found}")
        return 3
    _say(f"card: {_power_limit()}")
    marks = window["readbacks_s"]
    _say(f"window: {window['steps']} steps in {window['seconds']:.4f} s; "
         f"every {window['readback_every']} steps took (s): " +
         " ".join(f"{b - a:.4f}" for a, b in zip([0.0] + marks, marks)))
    for name, m in line["metrics"].items():
        _say(f"{name}: {m['value']} {m['unit']}")
    for name, c in line["checks"].items():
        _say(f"{name} {c['value']} limit {c['limit']} (at {where[name]})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
