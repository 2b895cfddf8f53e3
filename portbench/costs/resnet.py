"""ResNet's counts.

- Training step: every convolution's forward product and its two
  backward products (input and weight gradients), except that the first
  convolution has no input gradient; the head likewise. Batch norm,
  pooling and elementwise work are not counted.
- Batch norm: 5 passes of its [M, C] activation in bf16 per site
  (forward read and write, backward reads of x and dy and the write of
  dx; a ReLU inside the kernel adds none) and 8 for a fused
  batch-norm → add → ReLU tail (the residual read, its gradient written
  and the output read again by the backward)."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from . import BF16_BYTES


def _out(size: int, stride: int) -> int:
    return -(-size // stride)          # SAME padding


def sites(cfg: Dict) -> Iterator[Tuple[str, int, int, int, int, int]]:
    """(conv-bn name, kernel, c_in, c_out, stride, output positions per
    image) of every convolution in graph order, with SAME padding."""
    h, w = cfg["height"], cfg["width"]
    stem = cfg["widths"][0][0]
    s = cfg["stem_stride"]
    h, w = _out(h, s), _out(w, s)
    yield "stem", cfg["stem_kernel"], cfg["channels"], stem, s, h * w
    h, w = _out(h, 2), _out(w, 2)                     # the 3x3 / 2 pool
    c_in = stem
    for stage, (n, (mid, out)) in enumerate(zip(cfg["blocks"],
                                                cfg["widths"])):
        for blk in range(n):
            stride = 2 if blk == 0 and stage > 0 else 1
            ho, wo = _out(h, stride), _out(w, stride)
            name = f"s{stage}b{blk}"
            yield f"{name}_a", 1, c_in, mid, stride, ho * wo
            yield f"{name}_b", 3, mid, mid, 1, ho * wo
            yield f"{name}_c", 1, mid, out, 1, ho * wo
            if blk == 0:
                yield f"{name}_proj", 1, c_in, out, stride, ho * wo
            h, w, c_in = ho, wo, out


def batch_flops(cfg: Dict, batch: int) -> int:
    flops = 0
    for name, k, c_in, c_out, _, positions in sites(cfg):
        macs = batch * positions * c_out * k * k * c_in
        flops += 2 * macs * (2 if name == "stem" else 3)
    feat = cfg["widths"][-1][1]
    return flops + 2 * batch * feat * cfg["num_classes"] * 3


def step_flops(cfg: Dict, traffic: Dict) -> int:
    return batch_flops(cfg, traffic["batch"])


def bn_bytes(cfg: Dict, batch: int) -> int:
    """Least bytes one step's batch norms move: 5 bf16 passes of [M, C] a
    site, 8 at each block's last batch norm, which runs fused with the
    residual add and ReLU."""
    total = 0
    for name, _, _, c_out, _, positions in sites(cfg):
        passes = 8 if name.endswith("_c") else 5
        total += BF16_BYTES * batch * positions * c_out * passes
    return total
