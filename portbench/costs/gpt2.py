"""GPT-2's counts.

- Training step: 6 operations per matmul weight per token (the forward
  product and its two backward products), plus attention's 4·D
  (forward) + 10·D (backward) per causal query-key pair (i ≤ j) per head
  and layer; embeddings, norms, biases and elementwise work are not
  counted.
- Attention kernels: the forward moves q, k, v, o ([B·H, T, D] in the
  compute dtype) and the f32 log-sum-exp row once each and does 4·D per
  visible pair; the backward's dq kernel moves 5 such tensors (q, k, v,
  dO, dq) and 2 f32 rows (lse, δ) and does 6·D a pair; its dk/dv kernel
  moves 6 tensors (q, k, v, dO, dk, dv) and 2 rows and does 8·D a pair.
  Each kernel's least time is the larger of its operations over the
  peak rate and its bytes over the memory bandwidth."""

from __future__ import annotations

from typing import Dict

from . import BF16_BYTES, F32_BYTES


def matmul_weights(cfg: Dict) -> int:
    """Weights that take part in a matrix product a token: the four
    attention projections and the two MLP matrices of every layer, and
    the output projection."""
    d, ff = cfg["n_embd"], cfg["n_inner"]
    return cfg["n_layer"] * (4 * d * d + 2 * d * ff) + d * cfg["vocab_size"]


def causal_pairs(batch: int, heads: int, t: int) -> int:
    return batch * heads * t * (t + 1) // 2


def step_flops(cfg: Dict, traffic: Dict) -> int:
    b, t = traffic["batch"], traffic["seq_len"]
    heads, layers = cfg["n_head"], cfg["n_layer"]
    dh = cfg["n_embd"] // heads
    return 6 * matmul_weights(cfg) * b * t + \
        layers * 14 * dh * causal_pairs(b, heads, t)


#: attention kernel: ([B·H, T, D] tensors moved, f32 rows moved,
#: operations per visible pair in units of D)
ATTENTION_KERNELS = {"fwd": (4, 1, 4), "dq": (5, 2, 6), "dkv": (6, 2, 8)}


def attention_bound_s(cfg: Dict, traffic: Dict, peak_flops: float,
                      peak_bytes: float) -> float:
    """The least device seconds of one step's attention kernels (every
    layer's forward, dq and dk/dv kernel on an unmasked causal batch)."""
    b, t = traffic["batch"], traffic["seq_len"]
    heads = cfg["n_head"]
    dh = cfg["n_embd"] // heads
    bh = b * heads
    pairs = causal_pairs(b, heads, t)
    total = 0.0
    for tensors, rows, per_pair in ATTENTION_KERNELS.values():
        nbytes = tensors * bh * t * dh * BF16_BYTES + rows * bh * t * \
            F32_BYTES
        total += max(nbytes / peak_bytes, per_pair * dh * pairs / peak_flops)
    return cfg["n_layer"] * total
