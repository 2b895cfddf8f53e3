"""Flash attention forward (any T): the counterpart of the JAX package's
``kernels/pallas_attention.py`` forward, and the ``attention`` helper that
routes every forward attention on a card.

- :func:`flash_forward` is the wrapper of the Hopper kernel
  ``csrc/flash_forward.cu`` (replacing the TPU kernel ``_fwd_kernel``,
  ``pallas_attention.py:67``): on a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it calls the plain version. Its ``launches``
  attribute counts kernel launches. A ragged T is masked in the kernel,
  with no host-side padding.
- :func:`flash_forward_plain` is the plain PyTorch version of the same
  function (o and lse): the streaming softmax computes the same values as
  one whole-row softmax.
- :func:`cuda_attention` is the ``attention`` helper registered for Hopper
  (``nn/helpers.py``), the counterpart of ``make_pallas_flash_helper``:
  T <= 512 → the short-sequence kernel, T > 512 → the flash kernel. The
  TPU's materialized carve-outs (T < 256, 512 < T < 1024) were TPU tuning
  and do not carry over. A shape no kernel takes raises."""

from __future__ import annotations

from .cuda_lib import check_attention_args, launch_attention
from .shortseq_attention import MAX_T, attention_fwd_plain, \
    short_attention_fwd

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


def cuda_attention(conf, q, k, v, mask):
    """The ``attention`` helper on Hopper: [B, T, H, D] q/k/v (+ [B, T]
    key mask) → [B, T, H, D], through a hand-written kernel for every T."""
    b, t, h, d = q.shape
    fold = lambda x: x.transpose(1, 2).reshape(b * h, t, d).contiguous()
    km = None if mask is None else mask.float().contiguous()
    fwd = short_attention_fwd if t <= MAX_T else flash_forward
    o, _ = fwd(fold(q), fold(k), fold(v), km, h, conf.causal)
    return o.reshape(b, h, t, d).transpose(1, 2)
