"""Integer-seed streams for ``torch.Generator``s.

The JAX package threads PRNG keys folded per layer, purpose and step. The
port keeps the same tree shape over plain 63-bit integer seeds: every
consumer derives its own seed with :func:`fold_in` and builds an explicit
generator from it. On a CUDA device that generator is Philox. The bits
differ from JAX's threefry by design; what carries over is determinism
(a seed gives the same stream on every run and for every block size)."""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit integers."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """Derive a child seed from ``seed`` and an integer (layer index, step,
    salt); the result fits ``torch.Generator.manual_seed``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & _MASK64
    return _mix64(z) & 0x7FFFFFFFFFFFFFFF


def for_purpose(seed: int, purpose: str) -> int:
    """Child seed for a named purpose ("init", "dropout"), via a stable FNV-1a
    string hash (Python's ``hash`` is salted per process)."""
    h = 2166136261
    for ch in purpose.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return fold_in(seed, h)


def for_layer(seed: int, layer_index: int) -> int:
    """Child seed of the vertex at ``layer_index`` (topological order)."""
    return fold_in(seed, layer_index)


def for_iteration(seed: int, iteration: int) -> int:
    """Child seed of a training iteration: a step's dropout streams are
    ``for_layer(for_iteration(for_purpose(seed, "dropout"), it), idx)``."""
    return fold_in(seed, iteration)


def generator(seed: int, device) -> torch.Generator:
    """An explicit generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
