"""Last-axis LayerNorm with an analytic backward (the JAX package's
``kernels/layernorm.py``, a custom VJP there and a
``torch.autograd.Function`` here). Plain torch: the JAX module is not a
Pallas kernel.

The forward saves only (x, γ, mean, rstd), the statistics being one f32
scalar per row (kept as [..., 1]), and the backward rebuilds x̂ from them
(``_ln_bwd``). Statistics and the backward's arithmetic run at >= f32;
outputs come back in the inputs' dtypes. Where no gradient is wanted
(inference, under ``no_grad``), the forward runs without the Function,
whose per-call host overhead the 25 LayerNorms of every decode step
would otherwise pay."""

from __future__ import annotations

import torch


def _sd(dtype):
    return torch.promote_types(dtype, torch.float32)


def _ln_forward(x, gamma, beta, eps):
    sd = _sd(x.dtype)
    xf = x.to(sd)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (xf - mean) * rstd
    y = y * gamma.to(sd) + beta.to(sd)
    return y.to(x.dtype), mean, rstd


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = _ln_forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        sd = _sd(x.dtype)
        dyf = dy.to(sd)
        xhat = (x.to(sd) - mean) * rstd
        axes = tuple(range(x.dim() - 1))
        dgamma = (dyf * xhat).sum(dim=axes).to(gamma.dtype)
        dbeta = dyf.sum(dim=axes).to(gamma.dtype)
        # dx = rstd * (t - mean(t) - xhat * mean(t * xhat)),  t = dy * gamma
        t = dyf * gamma.to(sd)
        mt = t.mean(dim=-1, keepdim=True)
        mtx = (t * xhat).mean(dim=-1, keepdim=True)
        dx = rstd * (t - mt - xhat * mtx)
        return dx.to(x.dtype), dgamma, dbeta, None


def layernorm(x, gamma, beta, eps: float = 1e-5):
    """y = (x - mean) / sqrt(var + eps) * gamma + beta over the LAST axis.
    x: [..., C]; gamma/beta: [C]. Output in x's dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, gamma, beta)):
        return _LayerNorm.apply(x, gamma, beta, float(eps))
    return _ln_forward(x, gamma, beta, float(eps))[0]
