"""Calibrate chip_smoke.py phase 17 (c)'s bars: the relative L2 of the
change to syn0 / syn1 between the PyTorch port's HS per-batch Word2Vec
fit on a CUDA card and the same fit on the CPU's plain path, for the
sound card path and for deliberately faulty segment updates on the card.

    python scripts/torch_w2v_parity_faults.py

Runs on the phase's 200,000-token prefix (the segment update's one-hot
route, values rounded to bf16) and, with every table forced onto the f32
route, on its first 50,000 tokens. The faults replace the segment update
on the card only: ``no bf16 rounding`` (the one-hot route summed in f32),
``bf16 rounding`` (the f32 route's values rounded to bf16) and ``divide
by W`` (the sums divided by the occurrence weight instead of its square
root). Prints one JSON line a route: the card's name and power limit,
each bar, and each case's two readings."""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as c  # noqa: E402
from deeplearning4j_tpu_torch.kernels import segment_update as sgk  # noqa
from deeplearning4j_tpu_torch.nlp import skipgram as psg  # noqa: E402


def _divide_by_w(table, idx, updates, weights, lr, bf16):
    V, D = table.shape
    u = torch.cat([updates, weights[:, None]], dim=1)
    if bf16:
        u = u.to(torch.bfloat16).float()
    r = torch.zeros((V, D + 1), device=table.device)
    r.index_add_(0, idx, u)
    return table.add_(lr * r[:, :D] / torch.clamp(r[:, D:], min=1.0))


FAULTS = {
    "sound": sgk.segment_update,
    "no bf16 rounding": lambda t, i, u, w, lr, bf16:
        sgk.segment_update(t, i, u, w, lr, False),
    "bf16 rounding": lambda t, i, u, w, lr, bf16:
        sgk.segment_update(t, i, u, w, lr, True),
    "divide by W": _divide_by_w,
}


def _readings(s, seqs, cases):
    """{case: [syn0, syn1] rel-L2 of the card's change against the CPU's}
    for each of ``cases``."""
    cpu_m, _, init = c._hs_batch_fit(torch.device("cpu"), s, seqs)
    out = {}
    for name in cases:
        psg.segment_update = FAULTS[name]
        try:
            card_m, _, _ = c._hs_batch_fit(torch.device("cuda:0"), s, seqs)
        finally:
            psg.segment_update = sgk.segment_update
        out[name] = c._table_errs(card_m, cpu_m, init)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    s = dict(c.NLP_SHAPES)
    _, prefix = c.nlp_corpus(s)
    print(json.dumps({"card": card, "route": "onehot",
                      "tokens": sum(len(x) for x in prefix),
                      "bar": c.NLP_CPU_BF16_TOL,
                      "rel_l2_change": _readings(
                          s, prefix, ("sound", "no bf16 rounding",
                                      "divide by W"))}), flush=True)
    n, short = 0, []
    for x in prefix:
        if n >= c.NLP_F32_ROUTE_TOKENS:
            break
        short.append(x)
        n += len(x)
    psg.ONEHOT_SEGMENT_MAX_V = 0
    print(json.dumps({"card": card, "route": "scatter", "tokens": n,
                      "bar": c.NLP_CPU_TOL,
                      "rel_l2_change": _readings(
                          s, short, ("sound", "bf16 rounding",
                                     "divide by W"))}), flush=True)


if __name__ == "__main__":
    main()
