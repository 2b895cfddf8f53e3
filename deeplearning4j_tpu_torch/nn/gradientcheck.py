"""Finite-difference gradient checking (the JAX package's
``nn/gradientcheck.py``): central differences of ``net.score`` against the
autograd gradients, per parameter element, with a maximum relative error.
Run it on a network with an f64 compute dtype (f64 masters)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def flat_gradients(net, grads) -> np.ndarray:
    """A network's gradients (a list per layer, or a dict per vertex) as
    one f64 vector in :meth:`params_flat` order: layers (vertices in
    topological order), then parameter names ascending."""
    groups = grads if isinstance(grads, list) else \
        [grads[k] for k in net.conf.topological_order]
    parts = [g[k].detach().double().cpu().numpy().reshape(-1)
             for g in groups for k in sorted(g)]
    return np.concatenate(parts) if parts else np.zeros(0)


def check_gradients(net, ds, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3,
                    min_abs_error: float = 1e-8,
                    subsample: Optional[int] = None,
                    seed: int = 0, print_failures: bool = True) -> bool:
    """Central-difference check of a MultiLayerNetwork or ComputationGraph
    (any model with ``compute_gradient_and_score``, ``params_flat``,
    ``set_params_flat`` and ``score``). ``subsample``: check only that
    many randomly chosen parameter elements."""
    grads, _ = net.compute_gradient_and_score(ds)
    analytic = flat_gradients(net, grads)
    flat0 = net.params_flat().astype(np.float64)
    n = flat0.size
    idxs = np.arange(n)
    if subsample is not None and subsample < n:
        idxs = np.random.default_rng(seed).choice(n, subsample, replace=False)
    failures = 0
    for j in idxs:
        pert = flat0.copy()
        pert[j] += epsilon
        net.set_params_flat(pert)
        s_plus = net.score(ds)
        pert[j] -= 2 * epsilon
        net.set_params_flat(pert)
        s_minus = net.score(ds)
        numeric = (s_plus - s_minus) / (2 * epsilon)
        a = analytic[j]
        abs_err = abs(a - numeric)
        denom = max(abs(a), abs(numeric))
        rel_err = abs_err / denom if denom > 0 else 0.0
        if rel_err > max_rel_error and abs_err > min_abs_error:
            failures += 1
            if print_failures:
                print(f"  param[{j}]: analytic={a:.8g} numeric={numeric:.8g} "
                      f"rel_err={rel_err:.3g}")
    net.set_params_flat(flat0)
    if failures and print_failures:
        print(f"Gradient check FAILED for {failures}/{len(idxs)} params")
    return failures == 0
