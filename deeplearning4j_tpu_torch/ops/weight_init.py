"""Weight initialization (the JAX package's ``ops/weight_init.py``) drawn
from an explicit ``torch.Generator``, for nets built without weights
carried across from JAX. The draws are seeded but are not JAX's bits. Only
the scheme the transformer LM uses is ported."""

from __future__ import annotations

import math
from typing import Sequence

import torch


def init_weights(gen: torch.Generator, shape: Sequence[int], fan_in: float,
                 fan_out: float, scheme: str = "xavier",
                 dtype=torch.float32) -> torch.Tensor:
    """A weight tensor per the named WeightInit scheme, on ``gen``'s
    device: "xavier" is N(0, 2 / (fan_in + fan_out))."""
    if str(scheme).lower() != "xavier":
        raise ValueError(f"weight init scheme '{scheme}' is not ported")
    std = math.sqrt(2.0 / (max(float(fan_in), 1.0) + max(float(fan_out),
                                                          1.0)))
    return torch.randn(tuple(int(d) for d in shape), generator=gen,
                       device=gen.device, dtype=dtype) * std
