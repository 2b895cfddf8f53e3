"""Per-parameter gradient updaters, learning-rate schedules and gradient
normalization (the JAX package's ``ops/updaters.py``), as plain functions
on tensors.

Each updater is a pair of functions

    init(param)                          -> state (dict of same-shape tensors)
    update(grad, state, lr, iteration)   -> (step, new_state)

and the train step applies ``param -= step``. ``lr`` and ``iteration`` are
host numbers, so no rule synchronises with the device.

The rules are the JAX package's, not ``torch.optim``'s: its adam puts ε
outside an un-corrected √v and folds both bias corrections into the step
size α, which gives other numbers than ``torch.optim.Adam``."""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

_EPS_DEFAULT = 1e-8


@dataclasses.dataclass(frozen=True)
class Updater:
    """A per-parameter update rule: init/update functions."""
    name: str
    init: Callable[[torch.Tensor], Any]
    update: Callable[..., Tuple[torch.Tensor, Any]]


def make_updater(name, *, momentum: float = 0.9, adam_mean_decay: float = 0.9,
                 adam_var_decay: float = 0.999, rho: float = 0.95,
                 rms_decay: float = 0.95,
                 epsilon: float = _EPS_DEFAULT) -> Updater:
    """An updater by the reference's enum name, with its default
    hyperparameters."""
    key = str(name).lower()
    zeros = torch.zeros_like

    if key in ("sgd", "none"):
        scaled = key == "sgd"

        def update(g, state, lr, iteration):
            return (lr * g if scaled else g), state
        return Updater(key, lambda p: (), update)

    if key == "adam":
        b1, b2 = adam_mean_decay, adam_var_decay

        def update(g, state, lr, iteration):
            t = iteration + 1.0
            m = b1 * state["m"] + (1.0 - b1) * g
            v = b2 * state["v"] + (1.0 - b2) * (g * g)
            alpha = lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            return alpha * m / (torch.sqrt(v) + epsilon), {"m": m, "v": v}
        return Updater("adam", lambda p: {"m": zeros(p), "v": zeros(p)},
                       update)

    if key == "adamax":
        b1, b2 = adam_mean_decay, adam_var_decay

        def update(g, state, lr, iteration):
            t = iteration + 1.0
            m = b1 * state["m"] + (1.0 - b1) * g
            u = torch.maximum(b2 * state["u"], g.abs())
            return lr / (1.0 - b1 ** t) * m / (u + epsilon), {"m": m, "u": u}
        return Updater("adamax", lambda p: {"m": zeros(p), "u": zeros(p)},
                       update)

    if key == "adadelta":
        def update(g, state, lr, iteration):
            msg = rho * state["msg"] + (1.0 - rho) * (g * g)
            step = g * torch.sqrt(state["msdx"] + epsilon) / \
                torch.sqrt(msg + epsilon)
            msdx = rho * state["msdx"] + (1.0 - rho) * (step * step)
            return step, {"msg": msg, "msdx": msdx}
        return Updater("adadelta",
                       lambda p: {"msg": zeros(p), "msdx": zeros(p)}, update)

    if key == "nesterovs":
        mu = momentum

        def update(g, state, lr, iteration):
            v_prev = state["v"]
            v = mu * v_prev - lr * g
            # ND4J NesterovsUpdater lookahead form: params -= mu*vPrev - (1+mu)*v
            return mu * v_prev - (1.0 + mu) * v, {"v": v}
        return Updater("nesterovs", lambda p: {"v": zeros(p)}, update)

    if key == "adagrad":
        def update(g, state, lr, iteration):
            h = state["h"] + g * g
            return lr * g / (torch.sqrt(h) + epsilon), {"h": h}
        return Updater("adagrad", lambda p: {"h": zeros(p)}, update)

    if key == "rmsprop":
        def update(g, state, lr, iteration):
            e = rms_decay * state["e"] + (1.0 - rms_decay) * (g * g)
            return lr * g / torch.sqrt(e + epsilon), {"e": e}
        return Updater("rmsprop", lambda p: {"e": zeros(p)}, update)

    raise ValueError(f"Unknown updater '{name}'")


UPDATER_NAMES = ("sgd", "adam", "adamax", "adadelta", "nesterovs", "adagrad",
                 "rmsprop", "none")


def schedule_lr(base_lr: float, policy: Optional[str], iteration,
                *, decay_rate: float = 0.0, steps: float = 1.0,
                power: float = 1.0, max_iterations: float = 1.0,
                schedule: Optional[Dict[int, float]] = None) -> float:
    """The reference's LearningRatePolicy math for a host ``iteration``.

    Policies: none | exponential | inverse | poly | sigmoid | step |
    torchstep | schedule (iteration → lr map, piecewise constant)."""
    it = float(iteration)
    if policy is None or str(policy).lower() in ("none", "fixed"):
        return float(base_lr)
    p = str(policy).lower()
    if p == "exponential":
        return base_lr * decay_rate ** it
    if p == "inverse":
        return base_lr / (1.0 + decay_rate * it) ** power
    if p == "poly":
        frac = min(max(it / max_iterations, 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power
    if p == "sigmoid":
        return base_lr / (1.0 + math.exp(-decay_rate * (it - steps)))
    if p in ("step", "torchstep"):
        return base_lr * decay_rate ** math.floor(it / steps)
    if p == "schedule":
        lr = float(base_lr)
        for k in sorted(schedule or {}):
            if it >= k:
                lr = float(schedule[k])
        return lr
    raise ValueError(f"Unknown learning-rate policy '{policy}'")


def normalize_gradient(grads: Dict[str, torch.Tensor],
                       strategy: Optional[str],
                       threshold: float = 1.0) -> Dict[str, torch.Tensor]:
    """The reference's GradientNormalization strategies, applied per layer
    over its named parameter gradients before the updater runs. Norms stay
    on the device."""
    if strategy is None or str(strategy).lower() == "none":
        return grads
    s = str(strategy).lower()

    def layer_norm():
        return torch.sqrt(sum((g * g).sum() for g in grads.values()))

    def clip_scale(norm):
        return torch.where(norm > threshold, threshold / (norm + 1e-12),
                           torch.ones_like(norm))

    if s == "renormalizel2perlayer":
        scale = 1.0 / layer_norm().clamp_min(1e-12)
        return {k: g * scale for k, g in grads.items()}
    if s == "renormalizel2perparamtype":
        return {k: g / torch.linalg.vector_norm(g).clamp_min(1e-12)
                for k, g in grads.items()}
    if s == "clipelementwiseabsolutevalue":
        return {k: g.clamp(-threshold, threshold) for k, g in grads.items()}
    if s == "clipl2perlayer":
        scale = clip_scale(layer_norm())
        return {k: g * scale for k, g in grads.items()}
    if s == "clipl2perparamtype":
        return {k: g * clip_scale(torch.linalg.vector_norm(g))
                for k, g in grads.items()}
    raise ValueError(f"Unknown gradient normalization '{strategy}'")
