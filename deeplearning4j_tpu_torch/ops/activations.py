"""Activation functions by canonical lower-case name (the names layer configs
serialize): the JAX package's ``ops/activations.py`` registry, as functions
on tensors.

``gelu`` is the tanh approximation: that is ``jax.nn.gelu``'s default,
while ``torch.nn.functional.gelu`` defaults to the exact erf form.
``rrelu`` draws its slopes from an explicit ``torch.Generator`` (the JAX
package takes a PRNG key) and without one uses the fixed test-mode slope."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

_REGISTRY: Dict[str, Callable] = {}


def register_activation(name: str, fn: Callable) -> Callable:
    _REGISTRY[name.lower()] = fn
    return fn


def get_activation(name) -> Callable:
    """Resolve an activation by name (or pass a callable through)."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown activation '{name}'. Known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key]


def activation_names():
    return sorted(_REGISTRY)


def identity(x):
    return x


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def relu(x):
    return torch.relu(x)


def leakyrelu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, alpha * x)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def softmax(x):
    return torch.softmax(x, dim=-1)


def logsoftmax(x):
    return torch.log_softmax(x, dim=-1)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def cube(x):
    return x * x * x


def rationaltanh(x):
    """1.7159 · a clipped rational approximation of tanh(2x/3) (nd4j
    ActivationRationalTanh)."""
    a = 0.6666667 * x
    approx = torch.sign(a) * (
        1.0 - 1.0 / (1.0 + a.abs() + a * a + 1.41645 * a ** 4))
    return 1.7159 * approx


def rectifiedtanh(x):
    return torch.clamp_min(torch.tanh(x), 0.0)


def swish(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def mish(x):
    return x * torch.tanh(F.softplus(x))


def thresholdedrelu(x, theta: float = 1.0):
    return torch.where(x > theta, x, torch.zeros_like(x))


def rrelu(x, gen: Optional[torch.Generator] = None,
          lower: float = 1.0 / 8.0, upper: float = 1.0 / 3.0):
    """Randomized leaky ReLU: slopes ~ U[lower, upper] drawn from ``gen``
    (train mode); without a generator the fixed slope (lower + upper) / 2
    (test mode)."""
    if gen is None:
        return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)
    alpha = torch.rand(x.shape, generator=gen, device=x.device,
                       dtype=x.dtype) * (upper - lower) + lower
    return torch.where(x >= 0, x, alpha * x)


for _name, _fn in [
    ("identity", identity), ("linear", identity),
    ("sigmoid", sigmoid), ("tanh", tanh), ("relu", relu),
    ("leakyrelu", leakyrelu), ("elu", elu), ("selu", selu),
    ("softmax", softmax), ("logsoftmax", logsoftmax),
    ("softplus", softplus), ("softsign", softsign),
    ("hardsigmoid", hardsigmoid), ("hardtanh", hardtanh),
    ("cube", cube), ("rationaltanh", rationaltanh),
    ("rectifiedtanh", rectifiedtanh), ("swish", swish), ("gelu", gelu),
    ("mish", mish), ("thresholdedrelu", thresholdedrelu), ("rrelu", rrelu),
]:
    register_activation(_name, _fn)
