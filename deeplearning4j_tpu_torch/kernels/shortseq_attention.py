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
scores, so the result is exact.

The biased pair (:func:`short_attention_bias_fwd` /
:func:`short_attention_bias_bwd`, the ``attention_bias_*_kernel``
instances of the same two libraries, bf16 / f16 and D <= 128) adds an f32
logit bias [P, H, T, T] to the caller-scaled logits: batch row ``bh`` reads
block ((bh / H) mod P, bh mod H), so P = 1 is one bias for every row and
P = nW one a window (SwinV2's position bias plus its shift mask). Its
backward also returns dbias [P, H, T, T] f32 = Σ p·(dO·vᵀ − δ) over the
rows of each block (on the card a third kernel sums it, tile by tile, in
image order). The biased pair takes no key mask and is not causal.
:class:`BiasedShortAttention` is its autograd Function, and
:func:`biased_attention` the ``attention_bias`` helper on Hopper
(``nn/helpers.py``). The plain functions take ``bias=`` for the same
semantics."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .cuda_lib import (check_attention_args, check_attention_bias_args,
                       check_attention_bwd_args, launch_attention,
                       launch_attention_bias, launch_attention_bias_bwd,
                       launch_attention_bwd)

MAX_T = 512
NEG = -1e30


def bias_index(bh: int, h: int, p: int, device=None):
    """The block of a [P, H, T, T] bias each of ``bh`` batch rows reads,
    as an index into its [P·H, T, T] view: ((row / H) mod P)·H + row mod
    H."""
    rows = torch.arange(bh, device=device)
    return (rows // h) % p * h + rows % h


def _scores(q3, k3, key_mask, h: int, causal: bool, scale=None, bias=None):
    """[BH, T, T] f32 scaled logits (``scale`` 1/√D by default), plus
    ``bias`` ([P, H, T, T], see :func:`bias_index`), with the −1e30
    replacement masks."""
    t, d = q3.shape[1:]
    s = torch.einsum("btd,bsd->bts", q3.float(), k3.float())
    s = s / math.sqrt(d) if scale is None else s * scale
    if bias is not None:
        flat = bias.float().reshape(-1, t, t)
        s = s + flat[bias_index(q3.shape[0], h, bias.shape[0], s.device)]
    if key_mask is not None:
        keep = key_mask.float().repeat_interleave(h, dim=0) > 0   # [BH, T]
        s = s.masked_fill(~keep[:, None, :], NEG)
    if causal:
        future = torch.ones(t, t, dtype=torch.bool,
                            device=q3.device).triu(1)
        s = s.masked_fill(future, NEG)
    return s


def attention_fwd_plain(q3, k3, v3, key_mask=None, h: int = 1,
                        causal: bool = False, scale=None, bias=None):
    """[BH, T, D] attention with the kernels' semantics, all in f32:
    returns (o [BH, T, D] in q's dtype, lse [BH, T] f32). ``key_mask`` is
    [BH / h, T] (1 real / 0 masked); ``scale`` multiplies the logits
    (1/√D by default); ``bias`` [P, h, T, T] is added to them."""
    s = _scores(q3, k3, key_mask, h, causal, scale, bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = (p @ v3.float()) / l
    return o.to(q3.dtype), (m + torch.log(l))[..., 0]


def row_delta(do, o):
    """δ = rowsum(dO·O) in f32, [BH, T]."""
    return (do.float() * o.float()).sum(dim=-1)


def attention_bwd_plain(q3, k3, v3, key_mask, h: int, causal: bool, o, lse,
                        do, delta=None, scale=None, bias=None):
    """The backward of :func:`attention_fwd_plain` from its saved lse, all
    in f32: returns (dq, dk, dv) in q's dtype, and with ``bias`` also
    dbias (f32, the bias's shape: the rows' p·(dO·vᵀ − δ) summed a block).
    ``delta`` (δ, [BH, T] f32) may come from outside, as the ring backward
    passes it; ``o`` is read only when it does not."""
    if scale is None:
        scale = 1.0 / math.sqrt(q3.shape[-1])
    p = torch.exp(_scores(q3, k3, key_mask, h, causal, scale, bias) -
                  lse[..., None])
    if delta is None:
        delta = row_delta(do, o)
    dof = do.float()
    dv = p.transpose(1, 2) @ dof
    dsr = p * (dof @ v3.float().transpose(1, 2) - delta[..., None])
    ds = dsr * scale
    dq = ds @ k3.float()
    dk = ds.transpose(1, 2) @ q3.float()
    grads = tuple(g.to(q3.dtype) for g in (dq, dk, dv))
    if bias is None:
        return grads
    t = q3.shape[1]
    dbias = torch.zeros(bias.shape[0] * h, t, t, device=dsr.device)
    dbias.index_add_(0, bias_index(q3.shape[0], h, bias.shape[0],
                                   dsr.device), dsr)
    return (*grads, dbias.view(bias.shape))


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


def short_attention_bias_fwd(q3, k3, v3, bias, h: int, scale: float):
    """Biased short-sequence attention forward on [BH, T, D] (T <= 512):
    softmax(scale·q·kᵀ + bias)·v with ``bias`` [P, h, T, T] f32 (see the
    module's docstring); the Hopper kernel on a CUDA tensor (q, k, v
    zero-padded along D to a multiple of 8), the plain version on a CPU
    tensor. Returns (o, lse)."""
    if q3.device.type == "cpu":
        return attention_fwd_plain(q3, k3, v3, None, h, False, scale, bias)
    if k3.shape != q3.shape or v3.shape != q3.shape:
        raise ValueError("q, k, v must share shape, dtype and device")
    d = q3.shape[-1]
    dp = head_dim_padded(d)
    qp, kp, vp = (_pad(x, dp) for x in (q3, k3, v3))
    check_attention_args(qp, kp, vp, None, h, max_t=MAX_T)
    check_attention_bias_args(qp, bias, h)
    o, lse = launch_attention_bias(qp, kp, vp, bias, h, scale)
    short_attention_bias_fwd.launches += 1
    return (o if dp == d else o[..., :d].contiguous()), lse


short_attention_bias_fwd.launches = 0


#: CTAs the dbias kernel should fill the card with (2 on each of an H100's
#: 132 SMs): fewer tiles than that split the images into groups, whose
#: partial sums are added after the kernel
DBIAS_CTAS = 264


def dbias_groups(bh: int, h: int, p: int, t: int) -> int:
    """The image groups of the dbias kernel for ``bh`` rows of ``h`` heads
    over ``p`` bias blocks of T ``t``: enough CTAs (one a 64 x 64 tile of a
    block and group) for :data:`DBIAS_CTAS`, at most one group an image."""
    tiles = (-(-t // 64)) ** 2 * h * p
    return max(1, min(bh // (h * p), -(-DBIAS_CTAS // tiles)))


def short_attention_bias_bwd(q3, k3, v3, bias, h: int, scale: float, o, lse,
                             do, delta=None):
    """Biased short-sequence attention backward on [BH, T, D]: (dq, dk, dv,
    dbias) from the Hopper kernels on a CUDA tensor (dbias from its own
    kernel over :func:`dbias_groups` image groups), the plain version on a
    CPU tensor."""
    if q3.device.type == "cpu":
        return attention_bwd_plain(q3, k3, v3, None, h, False, o, lse, do,
                                   delta, scale, bias)
    if delta is None:
        delta = row_delta(do, o)
    d = q3.shape[-1]
    dp = head_dim_padded(d)
    qp, kp, vp, dop = (_pad(x, dp) for x in (q3, k3, v3, do))
    check_attention_bwd_args(qp, kp, vp, None, h, dop, lse, delta,
                             max_t=MAX_T)
    check_attention_bias_args(qp, bias, h)
    groups = dbias_groups(q3.shape[0], h, bias.shape[0], q3.shape[1])
    *grads, dbias = launch_attention_bias_bwd(qp, kp, vp, bias, h, dop, lse,
                                              delta, scale, groups)
    short_attention_bias_bwd.launches += 1
    return (*(g if dp == d else g[..., :d].contiguous() for g in grads),
            dbias)


short_attention_bias_bwd.launches = 0


class BiasedShortAttention(torch.autograd.Function):
    """[BH, T, D] attention with an f32 logit bias [P, H, T, T] and a
    caller-given scale, forward and backward through the biased
    short-sequence kernels (their plain versions on CPU tensors); the bias
    gets its gradient."""

    @staticmethod
    def forward(ctx, q3, k3, v3, bias, h, scale):
        o, lse = short_attention_bias_fwd(q3, k3, v3, bias, h, scale)
        ctx.save_for_backward(q3, k3, v3, bias, o, lse)
        ctx.h, ctx.scale = h, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, bias, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, dk, dv, dbias = short_attention_bias_bwd(
            q3, k3, v3, bias, ctx.h, ctx.scale, o, lse, do, row_delta(do, o))
        return dq, dk, dv, dbias, None, None


def biased_attention(q, k, v, bias, scale: float = 1.0):
    """The ``attention_bias`` helper: [B, T, H, D] q / k / v and an f32
    logit bias [P, H, T, T] → softmax(scale·q·kᵀ + bias)·v [B, T, H, D],
    differentiable in q, k, v and the bias through
    :class:`BiasedShortAttention`; a T no kernel takes raises."""
    b, t, h, d = q.shape
    if t > MAX_T:
        raise ValueError(f"biased attention takes T <= {MAX_T}, got {t}")
    fold = lambda x: x.transpose(1, 2).reshape(b * h, t, d).contiguous()
    o = BiasedShortAttention.apply(fold(q), fold(k), fold(v),
                                   bias.contiguous(), h, float(scale))
    return o.reshape(b, h, t, d).transpose(1, 2)
