"""Image batches: a ring of ``ring`` batches of float32 NHWC images of
unit normal noise at the configuration's height, width and channels, and
uniform int32 class ids. A step's work is its images."""

from __future__ import annotations

from typing import Dict

import torch


def make(cfg: Dict, traffic: Dict, g, device):
    ring, b = traffic["ring"], traffic["batch"]
    shape = (ring, b, cfg["height"], cfg["width"], cfg["channels"])
    x = torch.randn(shape, generator=g, device=device,
                    dtype=torch.float32).cpu().numpy()
    y = torch.randint(0, cfg["num_classes"], (ring, b), generator=g,
                      device=device).to(torch.int32).cpu().numpy()
    return [(x[i], y[i]) for i in range(ring)]


def units_per_step(traffic: Dict) -> int:
    return traffic["batch"]
