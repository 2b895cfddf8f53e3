"""Where a fleet's throughput goes on one card (card only).

Serves the flagship LM (``transformer_lm_conf(32000, 768, 12 heads, 12
layers, max_length 577)``, bf16, seeded weights; ``--layers`` cuts the
depth) the fleet phase's 24 greedy requests (16-256 prompt tokens, 16-64
new, seed 13) through an ``EngineFleetRouter`` on one shared decoder, in
three shapes: 1 replica of ``--slots`` slots, ``--replicas`` replicas of
``--slots`` slots, and 1 replica of replicas x slots slots (the same
lanes as the fleet in one engine). Each shape runs with the decoder's
dispatch lock (``TransformerDecoder._dispatch_lock``: replicas enqueue
one decoder call at a time) and with it replaced by a no-op, in
alternating order over ``--pairs`` rounds after one warm run each, and
prints the aggregate generated tok/s of every run and the medians::

    python -m deeplearning4j_tpu_torch.tools.fleet_probe --pairs 2
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch


class _NoLock:
    """The dispatch lock's stand-in for the unlocked runs."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fleet_probe needs a CUDA card")
    from ..models import transformer_lm_conf
    from ..models.generation import TransformerDecoder
    from ..nn.graph import ComputationGraph
    from ..streaming.fleet import EngineFleetRouter

    torch.backends.cuda.matmul.allow_tf32 = False
    net = ComputationGraph(transformer_lm_conf(
        32000, d_model=768, num_heads=12, num_layers=args.layers,
        max_length=577), compute_dtype=torch.bfloat16).init()
    dec = TransformerDecoder(net, t_max=576)
    lock = dec._dispatch_lock
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(16, 257, 24)]
    gens = [int(g) for g in rng.integers(16, 65, 24)]

    def drain(replicas: int, slots: int, locked: bool) -> float:
        dec._dispatch_lock = lock if locked else _NoLock()
        router = EngineFleetRouter(net, num_replicas=replicas, decoder=dec,
                                   num_slots=slots, block_size=4,
                                   paged=True, page_size=16, tracing=False)
        try:
            frs = [router.submit(p, g) for p, g in zip(prompts, gens)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            router.start()
            toks = sum(len(fr.result(900)) - len(p)
                       for fr, p in zip(frs, prompts))
            torch.cuda.synchronize()
            return toks / (time.perf_counter() - t0)
        finally:
            router.shutdown()
            dec._dispatch_lock = lock

    n, s = args.replicas, args.slots
    arms = [(f"{r}x{k} {'locked' if lk else 'unlocked'}", r, k, lk)
            for r, k in ((1, s), (n, s), (1, n * s)) for lk in (True, False)]
    for _, r, k, lk in arms:
        drain(r, k, lk)
    runs = {name: [] for name, *_ in arms}
    for i in range(max(1, args.pairs)):
        for name, r, k, lk in (arms if i % 2 == 0 else arms[::-1]):
            runs[name].append(round(drain(r, k, lk), 1))
    card = torch.cuda.get_device_name(0)
    print(json.dumps({"device": card, "layers": args.layers,
                      "tok_s": runs,
                      "median_tok_s": {k: statistics.median(v)
                                       for k, v in runs.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
