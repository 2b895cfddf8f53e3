"""SwinV2's counts.

- Training step: every matrix product's forward and its two backward
  products, by the 2·m·k·n rule, except that the patch embedding (the
  first product) has no input gradient: per image and block, the qkv
  projection (T_img·C·3C), the window attention's q·kᵀ and p·v (each
  T_img·M²·C: every token against the M² of its window, over the heads),
  the output projection (T_img·C²) and the MLP (2·T_img·C·rC); the patch
  embedding, the patch mergings (4C → 2C on the merged tokens) and the
  head. The position-bias MLP (once a step, not an image), LayerNorm and
  elementwise work are not counted. At SwinV2-B 256² this is 21.78 G
  multiply-adds an image forward (the paper's 21.8 G).
- Window attention kernels (the biased short-sequence forward and
  backward): [B·nW·heads, M², D] tensors in the compute dtype, f32 rows,
  and the f32 bias [P, heads, M², M²] (P = nW where the block shifts, else
  1) read once, its gradient written once by the backward. The forward
  moves q, k, v, o, lse and the bias and does 4·D a (query, key) pair;
  the backward moves q, k, v, dO, dq, dk, dv, lse, δ, the bias and dbias
  and does 10·D a pair (S recomputed, dP, dV, dQ, dK). Each kernel's least
  time is the larger of its operations over the peak rate and its bytes
  over the memory bandwidth."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from . import BF16_BYTES, F32_BYTES


def blocks(cfg: Dict) -> Iterator[Tuple[int, int, int, int, int]]:
    """(channels, heads, tokens an image, window tokens M², windows an
    image) of every block, clipping the window to the resolution."""
    res = cfg["image_size"] // cfg["patch_size"]
    for i, (depth, heads) in enumerate(zip(cfg["depths"],
                                           cfg["num_heads"])):
        c, r = cfg["embed_dim"] * 2 ** i, res // 2 ** i
        m = min(cfg["window_size"], r)
        for _ in range(depth):
            yield c, heads, r * r, m * m, (r // m) ** 2


def shifted(cfg: Dict):
    """Whether each block (in :func:`blocks`' order) shifts its windows."""
    res = cfg["image_size"] // cfg["patch_size"]
    for i, depth in enumerate(cfg["depths"]):
        r = res // 2 ** i
        for j in range(depth):
            yield bool(j % 2) and r > cfg["window_size"]


def forward_macs(cfg: Dict) -> int:
    """Multiply-adds of one image's forward pass (the counted products)."""
    p, c0 = cfg["patch_size"], cfg["embed_dim"]
    res = cfg["image_size"] // p
    macs = res * res * p * p * cfg["channels"] * c0
    for c, _, tok, t, _ in blocks(cfg):
        macs += tok * (3 * c * c + 2 * t * c + c * c +
                       2 * cfg["mlp_ratio"] * c * c)
    for i in range(len(cfg["depths"]) - 1):
        c, r = c0 * 2 ** i, res // 2 ** (i + 1)
        macs += r * r * 4 * c * 2 * c
    return macs + c0 * 2 ** (len(cfg["depths"]) - 1) * cfg["num_classes"]


def step_flops(cfg: Dict, traffic: Dict) -> int:
    p, res = cfg["patch_size"], cfg["image_size"] // cfg["patch_size"]
    embed = res * res * p * p * cfg["channels"] * cfg["embed_dim"]
    return traffic["batch"] * (6 * forward_macs(cfg) - 2 * embed)


#: the biased kernels: ([B·nW·heads, M², D] tensors moved, f32 rows moved,
#: f32 [P, heads, M², M²] blocks moved, operations a pair in units of D)
WINDOW_KERNELS = {"fwd": (4, 1, 1, 4), "bwd": (7, 2, 2, 10)}


def window_attention_bound_s(cfg: Dict, traffic: Dict, peak_flops: float,
                             peak_bytes: float) -> float:
    """The least device seconds of one step's biased attention kernels,
    the forward and the backward of every block."""
    total = 0.0
    for (c, heads, tok, t, nw), shift in zip(blocks(cfg), shifted(cfg)):
        d = c // heads
        rows = traffic["batch"] * nw * heads
        pairs = rows * t * t
        bias = (nw if shift else 1) * heads * t * t * F32_BYTES
        for tensors, row_terms, biases, per_pair in WINDOW_KERNELS.values():
            nbytes = tensors * rows * t * d * BF16_BYTES + \
                row_terms * rows * t * F32_BYTES + biases * bias
            total += max(nbytes / peak_bytes,
                         per_pair * d * pairs / peak_flops)
    return total
