"""What a remote worker's boot costs the host (card unless ``--device
cpu``).

Starts ``N`` fresh interpreters at once for each N of ``--counts``, each
doing what a ``streaming/remote.py`` worker does before its weights: the
interpreter's start, ``import torch``, ``import
deeplearning4j_tpu_torch.streaming.remote``, and a first op on the
device (the CUDA context). Prints, for each N, the wall seconds until
the last one ended and, per process, its CPU seconds (``os.wait4``) and
its stage seconds; and whether torch's sources have bytecode caches
next to them and may write them (without either, every interpreter
compiles torch's modules again)::

    python -m deeplearning4j_tpu_torch.tools.boot_probe --counts 1 4 8 12
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

_BOOT = r"""
import sys, time
t0 = time.time()
import torch
t1 = time.time()
import deeplearning4j_tpu_torch.streaming.remote
t2 = time.time()
torch.zeros(1, device=sys.argv[1]).sum().item()
t3 = time.time()
print(f"torch {t1 - t0:.2f} package {t2 - t1:.2f} device {t3 - t2:.2f}")
"""

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def boot_wave(n: int, device: str) -> dict:
    """``n`` boots started together: the wall seconds to the last one's
    end and, per process, (seconds to its end, CPU seconds, stages)."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-c", _BOOT, device],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True)
             for _ in range(n)]
    rows = []
    for p in procs:
        _, status, ru = os.wait4(p.pid, 0)
        p.returncode = os.waitstatus_to_exitcode(status)
        if p.returncode:
            raise RuntimeError(f"a boot exited {p.returncode}")
        rows.append((round(time.monotonic() - t0, 2),
                     round(ru.ru_utime + ru.ru_stime, 2),
                     p.stdout.read().strip()))
    return {"n": n, "wall_s": round(time.monotonic() - t0, 2),
            "processes": sorted(rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", type=int, nargs="+", default=[1, 4, 8, 12])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("boot_probe needs a CUDA card (or --device cpu)")
    src = os.path.dirname(torch.__file__)
    print(f"cores {len(os.sched_getaffinity(0))}; torch {torch.__version__}"
          f" in {src}: bytecode cache beside the sources "
          f"{os.path.isdir(os.path.join(src, '__pycache__'))}, "
          f"writing bytecode {not sys.flags.dont_write_bytecode}",
          flush=True)
    for n in args.counts:
        w = boot_wave(n, args.device)
        print(f"N={n}: wall {w['wall_s']} s; per process (s to its end, "
              f"CPU s, stages): {w['processes']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
