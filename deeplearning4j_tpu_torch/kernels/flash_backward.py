"""Flash attention backward (any T): the counterpart of the JAX package's
``_flash_bwd_impl`` (``kernels/pallas_attention.py:260``), the dq / dkv
kernel pair.

- :func:`flash_backward_dq` is the wrapper of the Hopper kernel replacing
  ``_dq_kernel`` (``pallas_attention.py:114``), and
  :func:`flash_backward_dkv` of the one replacing ``_dkv_kernel``
  (``pallas_attention.py:153``); both live in ``csrc/flash_backward.cu``.
  On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
  calls the plain version. Their ``launches`` attributes count kernel
  launches.
- :func:`flash_backward` runs both and returns (dq, dk, dv). δ may come
  from outside (``delta``), as the sequence-parallel ring backward passes
  the global row term; otherwise it is rowsum(dO·O) from ``o``.
- :func:`flash_backward_plain` is the plain PyTorch version: the same
  function as the short-sequence backward's plain version."""

from __future__ import annotations

from .cuda_lib import check_attention_bwd_args, launch_attention_bwd
from .shortseq_attention import attention_bwd_plain, row_delta

flash_backward_plain = attention_bwd_plain


def flash_backward_dq(q3, k3, v3, key_mask, h: int, causal: bool, do, lse,
                      delta):
    """dq [BH, T, D], accumulated over key tiles from lse and δ."""
    if q3.device.type == "cpu":
        return attention_bwd_plain(q3, k3, v3, key_mask, h, causal, None,
                                   lse, do, delta)[0]
    check_attention_bwd_args(q3, k3, v3, key_mask, h, do, lse, delta)
    (dq,) = launch_attention_bwd("flash_backward", "flash_attention_bwd_dq",
                                 q3, k3, v3, key_mask, h, causal, do, lse,
                                 delta, outputs=("dq",))
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward_dkv(q3, k3, v3, key_mask, h: int, causal: bool, do, lse,
                       delta):
    """(dk, dv) [BH, T, D], accumulated over query tiles from lse and
    δ."""
    if q3.device.type == "cpu":
        return attention_bwd_plain(q3, k3, v3, key_mask, h, causal, None,
                                   lse, do, delta)[1:]
    check_attention_bwd_args(q3, k3, v3, key_mask, h, do, lse, delta)
    out = launch_attention_bwd("flash_backward", "flash_attention_bwd_dkv",
                               q3, k3, v3, key_mask, h, causal, do, lse,
                               delta, outputs=("dk", "dv"))
    flash_backward_dkv.launches += 1
    return out


flash_backward_dkv.launches = 0


def flash_backward(q3, k3, v3, key_mask, h: int, causal: bool, o, lse, do,
                   delta=None):
    """(dq, dk, dv) of flash attention on [BH, T, D]: the two Hopper
    kernels on a CUDA tensor, the plain version on a CPU tensor."""
    if q3.device.type == "cpu":
        return flash_backward_plain(q3, k3, v3, key_mask, h, causal, o, lse,
                                    do, delta)
    if delta is None:
        delta = row_delta(do, o)
    dq = flash_backward_dq(q3, k3, v3, key_mask, h, causal, do, lse, delta)
    dk, dv = flash_backward_dkv(q3, k3, v3, key_mask, h, causal, do, lse,
                                delta)
    return dq, dk, dv
