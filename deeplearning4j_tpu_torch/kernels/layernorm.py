"""Last-axis LayerNorm forward (the JAX package's ``kernels/layernorm.py``,
``_ln_forward``): statistics at >= f32, output in x's dtype. Plain torch;
the JAX module is a custom VJP, not a Pallas kernel, and its backward
belongs to the training slice."""

from __future__ import annotations

import torch


def layernorm(x, gamma, beta, eps: float = 1e-5):
    """y = (x - mean) / sqrt(var + eps) * gamma + beta over the LAST axis.
    x: [..., C]; gamma/beta: [C]."""
    sd = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(sd)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.to(sd) + beta.to(sd)
    return y.to(x.dtype)
