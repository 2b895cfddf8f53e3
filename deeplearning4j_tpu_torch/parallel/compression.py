"""Threshold-encoded delta sharing with error feedback (the JAX package's
``parallel/compression.py``; the EncodedGradientsAccumulator role).

Each element of a shared tensor is quantized to {−t, 0, +t} (sign ×
threshold where |value + residual| ≥ threshold, else 0), and the
remainder accumulates in a per-replica residual that is added back before
the next encoding: small components stay local until they add up to
something worth sharing. ``ParallelWrapper``'s local-steps mode encodes
each replica's round delta with ``gradient_compression=threshold``,
averages the encodings and applies the mean to the round's base. Pick the
threshold near the typical per-round delta magnitude: every sent element
moves the shared parameters by exactly ±threshold, and smaller ones wait
in the residual."""

from __future__ import annotations

import torch


def threshold_encode(value: torch.Tensor, residual: torch.Tensor,
                     threshold: float):
    """(encoded, new_residual): encoded[i] ∈ {−t, 0, +t} and
    value + residual == encoded + new_residual (everything unsent is
    carried)."""
    carried = value + residual
    t = torch.as_tensor(threshold, dtype=carried.dtype,
                        device=carried.device)
    sent = torch.where(carried.abs() >= t, torch.sign(carried) * t,
                       torch.zeros_like(carried))
    return sent, carried - sent


def sent_fraction(encoded: torch.Tensor) -> torch.Tensor:
    """Fraction of nonzero (sent) elements, as an f32 0-d tensor."""
    return (encoded != 0).to(torch.float32).mean()
