"""Next-token batches: a ring of ``ring`` batches of token ids
[batch, seq_len + 1] drawn from a Zipf(``zipf_exponent``) law over the
configuration's vocabulary (rank r has weight 1 / (r + 1)^s), split into
inputs and next-token targets, both int32 [batch, seq_len]. A step's
work is its tokens."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def make(cfg: Dict, traffic: Dict, g, device):
    ring, b, t = traffic["ring"], traffic["batch"], traffic["seq_len"]
    if t > cfg["n_positions"]:
        raise ValueError(f"seq_len {t} > n_positions {cfg['n_positions']}")
    ranks = torch.arange(1, cfg["vocab_size"] + 1, device=device,
                         dtype=torch.float64)
    weights = ranks.pow(-float(traffic["zipf_exponent"]))
    ids = torch.multinomial(weights.float(), ring * b * (t + 1),
                            replacement=True, generator=g)
    ids = ids.view(ring, b, t + 1).to(torch.int32).cpu().numpy()
    return [(np.ascontiguousarray(r[:, :-1]), np.ascontiguousarray(r[:, 1:]))
            for r in ids]


def units_per_step(traffic: Dict) -> int:
    return traffic["batch"] * traffic["seq_len"]
