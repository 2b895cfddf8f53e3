"""Flash attention forward (any T): the counterpart of the JAX package's
``kernels/pallas_attention.py`` forward, and the ``attention`` helper that
routes every attention on a card, forward and backward.

- :func:`flash_forward` is the wrapper of the Hopper kernel
  ``csrc/flash_forward.cu`` (replacing the TPU kernel ``_fwd_kernel``,
  ``pallas_attention.py:67``): on a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it calls the plain version. Its ``launches``
  attribute counts kernel launches. A ragged T is masked in the kernel,
  with no host-side padding.
- :func:`flash_forward_plain` is the plain PyTorch version of the same
  function (o and lse): the streaming softmax computes the same values as
  one whole-row softmax.
- :class:`ShortAttention` and :class:`FlashAttention` are the
  ``torch.autograd.Function`` s of the two kernel families: the forward
  kernel saves (q, k, v, o, lse, key mask), and the backward takes
  δ = rowsum(dO·O) and runs the short-sequence backward kernel, or the
  flash dq and dkv kernels.
- :func:`cuda_attention` is the ``attention`` helper registered for Hopper
  (``nn/helpers.py``), the counterpart of ``make_pallas_flash_helper``:
  T <= 512 → the short-sequence pair, T > 512 → the flash pair. Its output
  carries a gradient through the kernels; where none is wanted (serving,
  under ``no_grad``) it calls the forward wrapper directly and spares the
  host the ``autograd.Function`` call. The TPU's materialized carve-outs
  (T < 256, 512 < T < 1024) were TPU tuning and do not carry over. A shape
  no kernel takes raises."""

from __future__ import annotations

import torch

from .cuda_lib import check_attention_args, launch_attention
from .flash_backward import flash_backward
from .shortseq_attention import (MAX_T, attention_fwd_plain, row_delta,
                                 short_attention_bwd, short_attention_fwd)

#: the plain version of the flash forward is the whole-row softmax
flash_forward_plain = attention_fwd_plain


def flash_forward(q3, k3, v3, key_mask=None, h: int = 1,
                  causal: bool = False):
    """Flash attention forward on [BH, T, D]: the Hopper kernel on a CUDA
    tensor, the plain version on a CPU tensor. Returns (o, lse [BH, T])."""
    if q3.device.type == "cpu":
        return flash_forward_plain(q3, k3, v3, key_mask, h, causal)
    check_attention_args(q3, k3, v3, key_mask, h)
    out = launch_attention("flash_forward", q3, k3, v3, key_mask, h, causal)
    flash_forward.launches += 1
    return out


flash_forward.launches = 0


def _save(ctx, q3, k3, v3, key_mask, h, causal, o, lse):
    ctx.save_for_backward(q3, k3, v3, key_mask, o, lse)
    ctx.h, ctx.causal = h, causal
    return o


def _grads(ctx, bwd, do):
    q3, k3, v3, key_mask, o, lse = ctx.saved_tensors
    # dO arrives as a strided view of the unfolded [B, T, H, D] gradient
    do = do.contiguous()
    dq, dk, dv = bwd(q3, k3, v3, key_mask, ctx.h, ctx.causal, o, lse, do,
                     row_delta(do, o))
    return dq, dk, dv, None, None, None


class ShortAttention(torch.autograd.Function):
    """[BH, T, D] attention for T <= 512: forward and backward through the
    short-sequence kernels (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, key_mask, h, causal):
        o, lse = short_attention_fwd(q3, k3, v3, key_mask, h, causal)
        return _save(ctx, q3, k3, v3, key_mask, h, causal, o, lse)

    @staticmethod
    def backward(ctx, do):
        return _grads(ctx, short_attention_bwd, do)


class FlashAttention(torch.autograd.Function):
    """[BH, T, D] attention for any T: forward and backward through the
    flash kernels (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, key_mask, h, causal):
        o, lse = flash_forward(q3, k3, v3, key_mask, h, causal)
        return _save(ctx, q3, k3, v3, key_mask, h, causal, o, lse)

    @staticmethod
    def backward(ctx, do):
        return _grads(ctx, flash_backward, do)


def cuda_attention(conf, q, k, v, mask):
    """The ``attention`` helper on Hopper: [B, T, H, D] q/k/v (+ [B, T]
    key mask) → [B, T, H, D], through a hand-written kernel pair for every
    T; differentiable through the backward kernels."""
    b, t, h, d = q.shape
    fold = lambda x: x.transpose(1, 2).reshape(b * h, t, d).contiguous()
    km = None if mask is None else mask.float().contiguous()
    args = (fold(q), fold(k), fold(v), km, h, conf.causal)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        o = (ShortAttention if t <= MAX_T else FlashAttention).apply(*args)
    else:
        o, _ = (short_attention_fwd if t <= MAX_T else flash_forward)(*args)
    return o.reshape(b, h, t, d).transpose(1, 2)
