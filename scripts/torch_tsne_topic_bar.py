"""Rehearse chip_smoke.py phase 18 (a) on the CPU at full size and read
the bar of its topic agreement: phase 17's HS corpus scan (layer 100,
window 5, min count 5, seed 42, one epoch over the 2,000,000-token
corpus) on the CPU's plain path, then ``BarnesHutTsne`` at its defaults
(perplexity 30, 1000 iterations, negative sampling with 64 negatives
above 8192 points, seed 42) over the unit-length vectors, and the share
of each topic word's 10 nearest neighbours from its own topic block in
2-D and in the 100-D vectors.

    python scripts/torch_tsne_topic_bar.py [--iters N]

Prints one JSON line: V, the iterations, each stage's seconds and both
shares."""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402
from deeplearning4j_tpu_torch.clustering import BarnesHutTsne  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    args = ap.parse_args()
    cpu = torch.device("cpu")
    out, t0 = {"threads": torch.get_num_threads()}, time.perf_counter()
    seqs, _ = c.nlp_corpus(c.NLP_SHAPES)
    w = c._w2v(cpu, c.NLP_SHAPES)
    w.fit(seqs)
    out["hs_scan_s"] = time.perf_counter() - t0
    syn0 = c.unit_rows(w.lookup.host_syn0())
    topics = c.word_topics(w.vocab)
    out["V"] = int(syn0.shape[0])
    t0 = time.perf_counter()
    out["agreement_100d"] = c.topic_agreement(syn0, topics, cpu)
    out["knn_100d_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Y = BarnesHutTsne(device=cpu).calculate(syn0, n_iter=args.iters)
    out["tsne_s"] = time.perf_counter() - t0
    out["iters"] = args.iters
    out["agreement_2d"] = c.topic_agreement(Y, topics, cpu)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
