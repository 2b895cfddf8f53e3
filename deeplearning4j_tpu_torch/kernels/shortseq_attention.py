"""Short-sequence attention forward (T <= 512): the counterpart of the JAX
package's ``kernels/pallas_shortseq.py`` forward.

- :func:`short_attention_fwd` is the wrapper of the Hopper kernel
  ``csrc/shortseq_attention.cu`` (replacing the TPU kernel
  ``_short_fwd_kernel``, ``pallas_shortseq.py:127``): on a CUDA tensor it
  launches the kernel or raises; on a CPU tensor it calls the plain
  version. Its ``launches`` attribute counts kernel launches.
- :func:`attention_fwd_plain` is the plain PyTorch version of the same
  function (o and lse), used by the CPU tests and by ``chip_smoke.py``'s
  comparison on the card — never by the main path on a card.

Masking is the reference's: the finite −1e30 REPLACES causal-future and
masked keys' logits, and l is clamped at 1e-20, so a fully masked row
yields a finite uniform average. The lse is [B·H, T] f32 (the TPU's
8-wide row carrier was a tiling artifact)."""

from __future__ import annotations

import math

import torch

from .cuda_lib import check_attention_args, launch_attention

MAX_T = 512
NEG = -1e30


def attention_fwd_plain(q3, k3, v3, key_mask=None, h: int = 1,
                        causal: bool = False):
    """[BH, T, D] attention with the kernels' semantics, all in f32:
    returns (o [BH, T, D] in q's dtype, lse [BH, T] f32). ``key_mask`` is
    [BH / h, T] (1 real / 0 masked)."""
    bh, t, d = q3.shape
    s = torch.einsum("btd,bsd->bts", q3.float(), k3.float()) / math.sqrt(d)
    if key_mask is not None:
        keep = key_mask.float().repeat_interleave(h, dim=0) > 0   # [BH, T]
        s = s.masked_fill(~keep[:, None, :], NEG)
    if causal:
        future = torch.ones(t, t, dtype=torch.bool,
                            device=q3.device).triu(1)
        s = s.masked_fill(future, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    o = (p @ v3.float()) / l
    return o.to(q3.dtype), (m + torch.log(l))[..., 0]


def short_attention_fwd(q3, k3, v3, key_mask=None, h: int = 1,
                        causal: bool = False):
    """Short-sequence attention forward on [BH, T, D] (T <= 512): the
    Hopper kernel on a CUDA tensor, the plain version on a CPU tensor.
    Returns (o, lse)."""
    if q3.device.type == "cpu":
        return attention_fwd_plain(q3, k3, v3, key_mask, h, causal)
    check_attention_args(q3, k3, v3, key_mask, h, max_t=MAX_T)
    out = launch_attention("shortseq_attention", q3, k3, v3, key_mask, h,
                           causal)
    short_attention_fwd.launches += 1
    return out


short_attention_fwd.launches = 0

