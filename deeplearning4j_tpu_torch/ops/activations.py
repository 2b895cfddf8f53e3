"""Activation functions by canonical lower-case name (the names layer configs
serialize), as in the JAX package's ``ops/activations.py``.

Only the activations the transformer LM uses are ported. ``gelu`` is the
tanh approximation: that is ``jax.nn.gelu``'s default, while
``torch.nn.functional.gelu`` defaults to the exact erf form."""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def identity(x):
    return x


def softmax(x):
    return torch.softmax(x, dim=-1)


def gelu(x):
    return F.gelu(x, approximate="tanh")


_REGISTRY: Dict[str, Callable] = {
    "identity": identity, "softmax": softmax, "gelu": gelu,
}


def get_activation(name) -> Callable:
    """Resolve an activation by name."""
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown or unported activation '{name}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]
