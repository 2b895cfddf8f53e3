"""The readings a cell's limits are set from, on the card at the cell's
own sizes, many seeds in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 \
        [--control 3] [--faults 3] [--witness 0]

For each seed: the program's readings of the check steps (as a run
takes them, ``train.program_readings``) and the float32 reference's, and
their gaps (``compare.gaps``). For the first ``--control`` seeds also the
control, the reference computed in float8 e4m3 in the program's place;
for the first ``--faults`` seeds each fault of ``train.FAULTS`` planted
in the program; for the first ``--witness`` seeds the reference in
bfloat16. One JSON line a reading on standard output. The benchmark's
runs never run this."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--witness", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    from portbench import compare, feeds, harness, train
    from deeplearning4j_tpu_torch.kernels import cuda_lib
    cuda_lib.build(cuda_lib.ENTRIES)
    cell = harness.resolve(args.workload)
    cfg, traffic = cell["config"], cell["traffic"]
    device = torch.device("cuda", 0)

    def top(got, want, key):
        gaps = compare.leaf_gaps(got[key], want[key])
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:6]

    def emit(seed, what, got, want, t0):
        gaps = compare.gaps(got, want)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "what": what, "seconds": time.perf_counter() - t0,
                          "losses": got["losses"],
                          **{k: v[0] for k, v in gaps.items()},
                          "at": {k: v[1] for k, v in gaps.items()},
                          "top_grads": top(got, want, "grads"),
                          "top_change": top(got, want, "change")}),
              flush=True)

    def program(seed, ring):
        net = train.build_program(cfg, device)
        train.load_weights(net, cfg, seed, device)
        got = train.program_readings(net, cfg, traffic, ring, seed, device)
        del net
        torch.cuda.empty_cache()
        return got

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ring = feeds.make_ring(cfg, traffic, seed, device)
        got = program(seed, ring)
        want = train.reference_readings(cfg, traffic, ring, seed, device)
        emit(seed, "program", got, want, t0)
        if i < args.control:
            t0 = time.perf_counter()
            ctl = train.reference_readings(cfg, traffic, ring, seed, device,
                                           "fp8")
            emit(seed, "control_fp8", ctl, want, t0)
        if i < args.witness:
            t0 = time.perf_counter()
            wit = train.reference_readings(cfg, traffic, ring, seed, device,
                                           "bf16")
            emit(seed, "witness_reference_bf16", wit, want, t0)
        if i < args.faults:
            for fault in train.FAULTS:
                t0 = time.perf_counter()
                with train.program_fault(fault):
                    bad = program(seed, ring)
                emit(seed, f"fault_{fault}", bad, want, t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
