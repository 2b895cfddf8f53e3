"""Full-batch solvers over the flattened parameter vector (the JAX
package's ``optimize/solvers.py``): Armijo backtracking line search,
steepest descent with line search, nonlinear conjugate gradient
(Polak-Ribière with restarts), L-BFGS, and ``Solver``, which picks one by
the configuration's ``optimization_algo``. The vector lives on the host
in f64; each evaluation writes it into the network (its f32 masters) and
runs one loss-and-gradient pass on the network's device."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..nn.gradientcheck import flat_gradients


def _loss_grad_fn(net, ds):
    """θ ↦ (loss(θ), ∇loss(θ)) over the flattened parameter vector."""
    def f(theta: np.ndarray) -> Tuple[float, np.ndarray]:
        net.set_params_flat(theta)
        grads, score = net.compute_gradient_and_score(ds)
        return float(score), flat_gradients(net, grads)
    return f


def backtrack_line_search(f, theta, direction, loss0, grad0,
                          initial_step: float = 1.0, c1: float = 1e-4,
                          rho: float = 0.5, max_iter: int = 20) -> float:
    """Armijo backtracking: the first step (halving from
    ``initial_step``) with sufficient decrease."""
    slope = float(grad0 @ direction)
    step = initial_step
    for _ in range(max_iter):
        loss_new, _ = f(theta + step * direction)
        if loss_new <= loss0 + c1 * step * slope:
            return step
        step *= rho
    return step


class LineGradientDescent:
    """Steepest descent with line search."""

    def __init__(self, max_iterations: int = 100, tol: float = 1e-8):
        self.max_iterations = max_iterations
        self.tol = tol

    def optimize(self, net, ds) -> float:
        f = _loss_grad_fn(net, ds)
        theta = net.params_flat().astype(np.float64)
        loss, grad = f(theta)
        for _ in range(self.max_iterations):
            direction = -grad
            step = backtrack_line_search(f, theta, direction, loss, grad)
            theta = theta + step * direction
            new_loss, grad = f(theta)
            if abs(loss - new_loss) < self.tol * max(abs(loss), 1.0):
                loss = new_loss
                break
            loss = new_loss
        net.set_params_flat(theta)
        net.score_value = loss
        return loss


class ConjugateGradient:
    """Nonlinear conjugate gradient (Polak-Ribière) with restarts."""

    def __init__(self, max_iterations: int = 100, tol: float = 1e-8):
        self.max_iterations = max_iterations
        self.tol = tol

    def optimize(self, net, ds) -> float:
        f = _loss_grad_fn(net, ds)
        theta = net.params_flat().astype(np.float64)
        loss, grad = f(theta)
        direction = -grad
        for _ in range(self.max_iterations):
            step = backtrack_line_search(f, theta, direction, loss, grad)
            theta = theta + step * direction
            new_loss, new_grad = f(theta)
            beta = max(0.0, float(new_grad @ (new_grad - grad)) /
                       max(float(grad @ grad), 1e-12))
            direction = -new_grad + beta * direction
            if float(new_grad @ direction) > 0:   # not a descent direction
                direction = -new_grad
            if abs(loss - new_loss) < self.tol * max(abs(loss), 1.0):
                loss = new_loss
                break
            loss, grad = new_loss, new_grad
        net.set_params_flat(theta)
        net.score_value = loss
        return loss


class LBFGS:
    """Limited-memory BFGS: the two-loop recursion over the last ``m``
    (s, y) pairs."""

    def __init__(self, max_iterations: int = 100, m: int = 10,
                 tol: float = 1e-8):
        self.max_iterations = max_iterations
        self.m = m
        self.tol = tol

    def optimize(self, net, ds) -> float:
        f = _loss_grad_fn(net, ds)
        theta = net.params_flat().astype(np.float64)
        loss, grad = f(theta)
        s_list, y_list = [], []
        for _ in range(self.max_iterations):
            q = grad.copy()
            alphas = []
            for s, y in reversed(list(zip(s_list, y_list))):
                rho_i = 1.0 / max(float(y @ s), 1e-12)
                a = rho_i * float(s @ q)
                alphas.append((a, rho_i, s, y))
                q -= a * y
            if y_list:
                q *= float(s_list[-1] @ y_list[-1]) / \
                    max(float(y_list[-1] @ y_list[-1]), 1e-12)
            for a, rho_i, s, y in reversed(alphas):
                q += (a - rho_i * float(y @ q)) * s
            direction = -q
            if float(grad @ direction) > 0:
                direction = -grad
            step = backtrack_line_search(f, theta, direction, loss, grad)
            theta_new = theta + step * direction
            new_loss, new_grad = f(theta_new)
            s_vec, y_vec = theta_new - theta, new_grad - grad
            if float(s_vec @ y_vec) > 1e-10:
                s_list.append(s_vec)
                y_list.append(y_vec)
                if len(s_list) > self.m:
                    s_list.pop(0)
                    y_list.pop(0)
            converged = abs(loss - new_loss) < self.tol * max(abs(loss), 1.0)
            theta, loss, grad = theta_new, new_loss, new_grad
            if converged:
                break
        net.set_params_flat(theta)
        net.score_value = loss
        return loss


class Solver:
    """Picks the optimizer from the network's ``optimization_algo``
    (stochastic gradient descent: one ``fit`` pass)."""

    class Builder:
        def __init__(self):
            self._net = None

        def model(self, net):
            self._net = net
            return self

        def build(self) -> "Solver":
            return Solver(self._net)

    def __init__(self, net):
        self.net = net

    def optimize(self, ds, max_iterations: Optional[int] = None) -> float:
        algo = getattr(self.net.conf, "optimization_algo",
                       "stochastic_gradient_descent")
        kw = {} if max_iterations is None else \
            {"max_iterations": max_iterations}
        if algo == "conjugate_gradient":
            return ConjugateGradient(**kw).optimize(self.net, ds)
        if algo == "lbfgs":
            return LBFGS(**kw).optimize(self.net, ds)
        if algo == "line_gradient_descent":
            return LineGradientDescent(**kw).optimize(self.net, ds)
        self.net.fit(ds)
        return float(self.net.score_value)
