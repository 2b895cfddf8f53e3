"""Time the PyTorch port's synchronous data-parallel step at data 1 beside
its solo step, on one CUDA card: ResNet-50 (bf16, 224 x 224, 1000
classes, nesterovs) through ``GraphDataParallelTrainer`` over a one-device
mesh and through ``fit_batch``, the two stepped in turn.

    python scripts/torch_dp_step_time.py [--root CHECKOUT] [--batch 64]

``--root`` is the checkout whose ``deeplearning4j_tpu_torch`` is imported
(default: this one), so that two commits can be compared on one card in
one call: run the script once for each root, in the order A, B, B, A.
Prints one JSON line: the root, the card's name and power limit, and the
median ms of ``--steps`` timed steps (after ``--warm``) of each."""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from deeplearning4j_tpu_torch.models import resnet50_conf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (GraphDataParallelTrainer,
                                                   make_mesh)
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(args.batch, 224, 224, 3, generator=g, device=dev)
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (args.batch,), generator=g, device=dev),
        1000).float()
    ds = DataSet(x, y)
    base = ComputationGraph(resnet50_conf(1000, 224, 224, 3,
                                          updater="nesterovs",
                                          learning_rate=0.1),
                            compute_dtype=torch.bfloat16, device=dev).init()
    solo, dp = base.clone(), base.clone()
    steps = {"solo": solo.fit_batch,
             "data1": GraphDataParallelTrainer(
                 dp, mesh=make_mesh(devices=[dev])).fit_batch}
    times = {k: [] for k in steps}
    for i in range(args.warm + args.steps):
        for name, step in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(ds)
            torch.cuda.synchronize()
            if i >= args.warm:
                times[name].append((time.perf_counter() - t0) * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "root": root, "card": card, "batch": args.batch,
        "ms_median": {k: statistics.median(v) for k, v in times.items()},
        "ms": times,
        "loss": {"solo": float(solo.score_value),
                 "data1": float(dp.score_value)}}))


if __name__ == "__main__":
    main()
