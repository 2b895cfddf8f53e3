"""Accelerated-implementation registry (the JAX package's ``nn/helpers.py``),
keyed by op kind, torch device type and CUDA capability instead of the jax
platform.

The JAX registry discovers providers lazily, swallows their ImportError and
falls back to the built-in path. The port does neither: the table below is
static, a CPU tensor gets no helper (the layer's plain path runs), and a
CUDA tensor gets the kernel listed for its capability — or an error, never
a silent fallback to plain PyTorch on the card.

Over the static table sits one scoped claim per kind
(:func:`register_helper`): while a claim is held and not disabled it wins
on every device type it names, the CPU included, as the JAX package's
sequence-parallel trainer registers its ring for ``cpu`` too.
:func:`snapshot_helper` / :func:`restore_helper` put back exactly what a
scoped claim displaced. :func:`disable_helper` silences the claim only:
a CUDA tensor then gets its static kernel again, never the plain path."""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from ..kernels.batchnorm import bn_add_act_train_fused, bn_train_fused
from ..kernels.flash_forward import cuda_attention
from ..kernels.lstm import cuda_lstm
from ..kernels.shortseq_attention import biased_attention

#: (kind, device type, capability) → implementation
_HELPERS: Dict[Tuple[str, str, Tuple[int, int]], Callable] = {
    # every forward attention on Hopper: T <= 512 → the short-sequence
    # kernel, longer → the flash forward kernel (kernels/flash_forward.py)
    ("attention", "cuda", (9, 0)): cuda_attention,
    # every attention with an additive f32 logit bias (SwinV2's windows),
    # T <= 512, bf16 / f16: the biased short-sequence kernels
    ("attention_bias", "cuda", (9, 0)): biased_attention,
    # every sigmoid-gate / tanh-cell LSTM recurrence on Hopper, f32 and
    # bf16, masked or not: kernel B6 (kernels/lstm.py)
    ("lstm", "cuda", (9, 0)): cuda_lstm,
    # every batch norm in training on Hopper, f32 and bf16: the
    # batchnorm.cu kernels (kernels/batchnorm.py), alone and as the
    # BN -> add -> act residual tail of the graph's fusion plan
    ("batchnorm_train", "cuda", (9, 0)): bn_train_fused,
    ("batchnorm_add_act_train", "cuda", (9, 0)): bn_add_act_train_fused,
}

#: kind → (implementation, device types): the scoped claims
_CLAIMED: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}
#: kinds whose claim is silenced
_DISABLED: set = set()


def get_helper(kind: str, device) -> Optional[Callable]:
    """The implementation of ``kind`` for tensors on ``device``: a held
    claim naming the device type first; else None off CUDA (callers run
    their plain path) and on CUDA the kernel listed for the card's
    capability, or RuntimeError when there is none."""
    device = torch.device(device)
    claim = _CLAIMED.get(kind)
    if claim is not None and kind not in _DISABLED and \
            device.type in claim[1]:
        return claim[0]
    if device.type != "cuda":
        return None
    cap = tuple(torch.cuda.get_device_capability(device))
    fn = _HELPERS.get((kind, "cuda", cap))
    if fn is None:
        raise RuntimeError(
            f"no '{kind}' kernel for CUDA capability {cap}; the port's "
            "kernels are built for sm_90a (Hopper)")
    return fn


def register_helper(kind: str, fn: Callable,
                    platforms: Tuple[str, ...] = ("cuda", "cpu"),
                    _scoped: bool = False) -> None:
    """Claim ``kind`` for tensors on ``platforms`` (torch device types).
    ``_scoped``: the caller snapshotted the slot and will restore it, so
    replacing another claim is deliberate and does not warn."""
    prev = _CLAIMED.get(kind)
    if prev is not None and prev[0] is not fn and not _scoped:
        warnings.warn(
            f"helper kind '{kind}' already claimed "
            f"({getattr(prev[0], '__name__', prev[0])}); replacing with "
            f"{getattr(fn, '__name__', fn)}", stacklevel=2)
    _CLAIMED[kind] = (fn, tuple(str(p).lower() for p in platforms))


def disable_helper(kind: str) -> None:
    """Silence the claim on ``kind`` (the static table answers again)."""
    _DISABLED.add(kind)


def enable_helper(kind: str) -> None:
    _DISABLED.discard(kind)


def snapshot_helper(kind: str):
    """The claim state of ``kind``: (claim entry or None, disabled)."""
    return (_CLAIMED.get(kind), kind in _DISABLED)


def restore_helper(kind: str, snapshot) -> None:
    """Put back a state :func:`snapshot_helper` captured; an empty entry
    removes the claim."""
    entry, was_disabled = snapshot
    if entry is None:
        _CLAIMED.pop(kind, None)
    else:
        _CLAIMED[kind] = entry
    if was_disabled:
        _DISABLED.add(kind)
    else:
        _DISABLED.discard(kind)
