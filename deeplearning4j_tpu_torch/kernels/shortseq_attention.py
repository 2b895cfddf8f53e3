"""Short-sequence attention (T <= 512), forward and backward: the
counterpart of the JAX package's ``kernels/pallas_shortseq.py``.

- :func:`short_attention_fwd` is the wrapper of the Hopper kernel
  ``csrc/shortseq_attention.cu`` (replacing the TPU kernel
  ``_short_fwd_kernel``, ``pallas_shortseq.py:127``), and
  :func:`short_attention_bwd` of ``csrc/shortseq_attention_bwd.cu``
  (replacing ``_short_bwd_kernel``, ``pallas_shortseq.py:160``). On a
  CUDA tensor each launches its kernel or raises; on a CPU tensor it calls
  the plain version. Their ``launches`` attributes count kernel launches.
- :func:`attention_fwd_plain` and :func:`attention_bwd_plain` are the
  plain PyTorch versions of the same functions, used by the CPU tests and
  by ``chip_smoke.py``'s comparison on the card — never by the main path
  on a card.

Masking is the reference's: the finite −1e30 REPLACES causal-future and
masked keys' logits, and l is clamped at 1e-20, so a fully masked row
yields a finite uniform average. lse and δ are [B·H, T] f32 (the TPU's
8-wide row carrier was a tiling artifact). The backward recomputes
p = exp(s − lse) from the saved lse and takes δ = rowsum(dO·O):
dv = pᵀ·dO, ds = p·(dO·vᵀ − δ)·scale, dq = ds·k, dk = dsᵀ·q.

Head dims: the kernels take any D that is a multiple of 8 (129–256, in
every dtype: the DMAX = 256 instance of the CUDA-core kernels on 32-row
tiles; above 256: ``csrc/attention_wide.cuh``, which splits the output's
columns over the grid). Every wrapper runs
through :func:`padded_fwd` / :func:`padded_bwd`, which zero-pad q, k, v
and dO along D to the next multiple of 8, pass the true D's 1/√D as the
scale and slice o and the gradients back: zero columns add nothing to the
scores, so the result is exact."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .cuda_lib import (check_attention_args, check_attention_bwd_args,
                       launch_attention, launch_attention_bwd)

MAX_T = 512
NEG = -1e30


def _scores(q3, k3, key_mask, h: int, causal: bool, scale=None):
    """[BH, T, T] f32 scaled logits (``scale`` 1/√D by default) with the
    −1e30 replacement masks."""
    t, d = q3.shape[1:]
    s = torch.einsum("btd,bsd->bts", q3.float(), k3.float())
    s = s / math.sqrt(d) if scale is None else s * scale
    if key_mask is not None:
        keep = key_mask.float().repeat_interleave(h, dim=0) > 0   # [BH, T]
        s = s.masked_fill(~keep[:, None, :], NEG)
    if causal:
        future = torch.ones(t, t, dtype=torch.bool,
                            device=q3.device).triu(1)
        s = s.masked_fill(future, NEG)
    return s


def attention_fwd_plain(q3, k3, v3, key_mask=None, h: int = 1,
                        causal: bool = False, scale=None):
    """[BH, T, D] attention with the kernels' semantics, all in f32:
    returns (o [BH, T, D] in q's dtype, lse [BH, T] f32). ``key_mask`` is
    [BH / h, T] (1 real / 0 masked); ``scale`` multiplies the logits
    (1/√D by default)."""
    s = _scores(q3, k3, key_mask, h, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = (p @ v3.float()) / l
    return o.to(q3.dtype), (m + torch.log(l))[..., 0]


def row_delta(do, o):
    """δ = rowsum(dO·O) in f32, [BH, T]."""
    return (do.float() * o.float()).sum(dim=-1)


def attention_bwd_plain(q3, k3, v3, key_mask, h: int, causal: bool, o, lse,
                        do, delta=None, scale=None):
    """The backward of :func:`attention_fwd_plain` from its saved lse, all
    in f32: returns (dq, dk, dv) in q's dtype. ``delta`` (δ, [BH, T] f32)
    may come from outside, as the ring backward passes it; ``o`` is read
    only when it does not."""
    if scale is None:
        scale = 1.0 / math.sqrt(q3.shape[-1])
    p = torch.exp(_scores(q3, k3, key_mask, h, causal, scale) -
                  lse[..., None])
    if delta is None:
        delta = row_delta(do, o)
    dof = do.float()
    dv = p.transpose(1, 2) @ dof
    ds = p * (dof @ v3.float().transpose(1, 2) - delta[..., None]) * scale
    dq = ds @ k3.float()
    dk = ds.transpose(1, 2) @ q3.float()
    return tuple(g.to(q3.dtype) for g in (dq, dk, dv))


def head_dim_padded(d: int) -> int:
    """D rounded up to the kernels' multiple of 8."""
    return -(-d // 8) * 8


def _pad(x, dp):
    return x if x.shape[-1] == dp else \
        F.pad(x, (0, dp - x.shape[-1])).contiguous()


def padded_fwd(fwd, q3, k3, v3, key_mask=None, h: int = 1,
               causal: bool = False):
    """``fwd(q, k, v, key_mask, h, causal, scale)`` on q, k, v zero-padded
    along D to :func:`head_dim_padded`, with the true D's 1/√D: (o sliced
    back to D, lse)."""
    if k3.shape != q3.shape or v3.shape != q3.shape:
        raise ValueError("q, k, v must share shape, dtype and device")
    d = q3.shape[-1]
    dp = head_dim_padded(d)
    o, lse = fwd(_pad(q3, dp), _pad(k3, dp), _pad(v3, dp), key_mask, h,
                 causal, d ** -0.5)
    return (o if dp == d else o[..., :d].contiguous()), lse


def padded_bwd(bwd, q3, k3, v3, key_mask, h: int, causal: bool, lse, do,
               delta):
    """``bwd(q, k, v, key_mask, h, causal, lse, do, delta, scale)`` on q, k,
    v and dO zero-padded along D (δ from the unpadded dO and O), with the
    true D's 1/√D; each gradient it returns sliced back to D."""
    if k3.shape != q3.shape or v3.shape != q3.shape:
        raise ValueError("q, k, v must share shape, dtype and device")
    if do.shape != q3.shape:
        raise ValueError("dO must be a contiguous, 16-byte aligned tensor "
                         "of q's shape, dtype and device")
    d = q3.shape[-1]
    dp = head_dim_padded(d)
    grads = bwd(_pad(q3, dp), _pad(k3, dp), _pad(v3, dp), key_mask, h,
                causal, lse, _pad(do, dp), delta, d ** -0.5)
    return tuple(g if dp == d else g[..., :d].contiguous() for g in grads)


def _short_fwd(q3, k3, v3, key_mask, h, causal, scale):
    check_attention_args(q3, k3, v3, key_mask, h, max_t=MAX_T)
    return launch_attention("shortseq_attention", q3, k3, v3, key_mask, h,
                            causal, scale)


def _short_bwd(q3, k3, v3, key_mask, h, causal, lse, do, delta, scale):
    check_attention_bwd_args(q3, k3, v3, key_mask, h, do, lse, delta,
                             max_t=MAX_T)
    return launch_attention_bwd("shortseq_attention_bwd",
                                "shortseq_attention_bwd", q3, k3, v3,
                                key_mask, h, causal, do, lse, delta,
                                scale=scale)


def short_attention_fwd(q3, k3, v3, key_mask=None, h: int = 1,
                        causal: bool = False):
    """Short-sequence attention forward on [BH, T, D] (T <= 512): the
    Hopper kernel on a CUDA tensor, the plain version on a CPU tensor.
    Returns (o, lse)."""
    if q3.device.type == "cpu":
        return attention_fwd_plain(q3, k3, v3, key_mask, h, causal)
    out = padded_fwd(_short_fwd, q3, k3, v3, key_mask, h, causal)
    short_attention_fwd.launches += 1
    return out


short_attention_fwd.launches = 0


def short_attention_bwd(q3, k3, v3, key_mask, h: int, causal: bool, o, lse,
                        do, delta=None):
    """Short-sequence attention backward on [BH, T, D] (T <= 512): dq, dk
    and dv from one launch of the Hopper kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if q3.device.type == "cpu":
        return attention_bwd_plain(q3, k3, v3, key_mask, h, causal, o, lse,
                                   do, delta)
    if delta is None:
        delta = row_delta(do, o)
    out = padded_bwd(_short_bwd, q3, k3, v3, key_mask, h, causal, lse, do,
                     delta)
    short_attention_bwd.launches += 1
    return out


short_attention_bwd.launches = 0
