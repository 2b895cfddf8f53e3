"""Accelerated-implementation registry (the JAX package's ``nn/helpers.py``),
keyed by op kind, torch device type and CUDA capability instead of the jax
platform.

The JAX registry discovers providers lazily, swallows their ImportError and
falls back to the built-in path. The port does neither: the table below is
static, a CPU tensor gets no helper (the layer's plain path runs), and a
CUDA tensor gets the kernel listed for its capability — or an error, never
a silent fallback to plain PyTorch on the card."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels.flash_forward import cuda_attention
from ..kernels.lstm import cuda_lstm

#: (kind, device type, capability) → implementation
_HELPERS: Dict[Tuple[str, str, Tuple[int, int]], Callable] = {
    # every forward attention on Hopper: T <= 512 → the short-sequence
    # kernel, longer → the flash forward kernel (kernels/flash_forward.py)
    ("attention", "cuda", (9, 0)): cuda_attention,
    # every sigmoid-gate / tanh-cell LSTM recurrence on Hopper, f32 and
    # bf16, masked or not: kernel B6 (kernels/lstm.py)
    ("lstm", "cuda", (9, 0)): cuda_lstm,
}


def get_helper(kind: str, device) -> Optional[Callable]:
    """The implementation of ``kind`` for tensors on ``device``: None off
    CUDA (callers run their plain path); on CUDA the kernel listed for the
    card's capability, and RuntimeError when there is none."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    cap = tuple(torch.cuda.get_device_capability(device))
    fn = _HELPERS.get((kind, "cuda", cap))
    if fn is None:
        raise RuntimeError(
            f"no '{kind}' kernel for CUDA capability {cap}; the port's "
            "kernels are built for sm_90a (Hopper)")
    return fn
