"""Minimal stdlib PNG encoder (zlib + struct): the JAX package's
``ui/png.py``, the same host code. Renders the convolutional activation
grids the reference's ConvolutionalIterationListener drew with AWT. No
image library: 8-bit grayscale, one IDAT chunk."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Min-max normalize any numeric [H, W] array to uint8 0..255 (the one
    place this normalization lives; uint8 input passes through)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    img = img.astype(np.float64)
    lo, hi = float(img.min()), float(img.max())
    scaled = np.zeros_like(img) if hi <= lo else (img - lo) / (hi - lo)
    return (scaled * 255).astype(np.uint8)


def encode_gray_png(img: np.ndarray) -> bytes:
    """[H, W] array (any numeric dtype) → 8-bit grayscale PNG bytes.
    Non-uint8 input is min-max normalized to 0..255."""
    if np.asarray(img).ndim != 2:
        raise ValueError(f"need [H, W], got {np.asarray(img).shape}")
    u8 = to_uint8(img)
    h, w = u8.shape
    raw = b"".join(b"\x00" + u8[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)   # gray, 8-bit
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) +
            _chunk(b"IDAT", zlib.compress(raw, 6)) +
            _chunk(b"IEND", b""))


def activation_grid(act: np.ndarray, max_channels: int = 16,
                    max_px: int = 64) -> np.ndarray:
    """[H, W, C] activation → one [H', W'·C'] horizontal strip (channel
    tiles side by side), downsampled by striding to ≤ max_px per side."""
    act = np.asarray(act, np.float32)
    h, w, c = act.shape
    c = min(c, max_channels)
    sh = -(-h // max_px)               # ceil: honor the <= max_px bound
    sw = -(-w // max_px)
    tiles = [act[::sh, ::sw, i] for i in range(c)]
    return np.concatenate(tiles, axis=1)
