"""Deterministic segment update of an embedding table (the update behind
every write of ``nlp/skipgram.py``'s steps).

- :func:`segment_update` is the wrapper of the Hopper kernel
  ``csrc/segment_update.cu``. It replaces no TPU kernel: the JAX package's
  ``_segment_update`` (``nlp/skipgram.py:150``) is a bf16 one-hot matmul
  or an f32 scatter-add, both deterministic on the TPU, where the card's
  library sums are float atomics (``index_add_``, another order of
  summation each run) or a sorted accumulation that walks a Zipf-hot
  row's thousands of duplicates one after another
  (``index_put_(accumulate=True)``). On a CUDA tensor it sorts the indices
  stably and launches the kernel (two passes: per tile of sorted
  positions, then per row, each summing in a fixed order, the second
  applying the update) or raises; on a CPU tensor it calls the plain
  version. Its ``launches`` attribute counts wrapper calls that launched
  the kernel.
- :func:`segment_update_plain` is the plain PyTorch version: the sums by
  ``index_add_`` into a dense ``[V, D + 1]`` buffer (serial, in index
  order, on the CPU; the kernel sums a row whose entries fit one
  32-position tile in that order too), then the update."""

from __future__ import annotations

import torch

from . import cuda_lib


def segment_update_plain(table, idx, updates, weights, lr, bf16: bool):
    """table[v] += lr * Σ_{i: idx_i=v} updates_i / sqrt(max(Σ weights_i,
    1)), in place, each value rounded to bf16 first when ``bf16``.
    Returns ``table``."""
    V, D = table.shape
    u = torch.cat([updates, weights[:, None].to(updates.dtype)], dim=1)
    if bf16:
        u = u.to(torch.bfloat16).to(table.dtype)
    r = torch.zeros((V, D + 1), dtype=table.dtype, device=table.device)
    r.index_add_(0, idx, u)
    counts = torch.clamp(r[:, D], min=1.0)
    table.add_(lr * r[:, :D] / torch.sqrt(counts)[:, None])
    return table


def segment_update(table, idx, updates, weights, lr, bf16: bool):
    """:func:`segment_update_plain`'s function: the kernel on a CUDA
    table (f32 [V, D] contiguous, f32 updates [N, D] and weights [N],
    integer indices [N] in [0, V); an index outside that range updates no
    row), the plain version on a CPU one. Returns ``table``."""
    if table.device.type == "cpu":
        return segment_update_plain(table, idx, updates, weights, lr, bf16)
    n = idx.shape[0]
    V, D = table.shape
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"segment_update takes a contiguous f32 table, got "
                         f"{table.dtype}")
    if updates.shape != (n, D) or weights.shape != (n,) or \
            updates.dtype != torch.float32 or \
            weights.dtype != torch.float32:
        raise ValueError(f"segment_update needs f32 updates [{n}, {D}] and "
                         f"weights [{n}], got {tuple(updates.shape)} "
                         f"{updates.dtype}, {tuple(weights.shape)} "
                         f"{weights.dtype}")
    if idx.dim() != 1 or idx.is_floating_point() or \
            any(x.device != table.device for x in (idx, updates, weights)):
        raise ValueError("segment_update needs integer indices [N] and "
                         "every input on the table's device")
    updates, weights = updates.contiguous(), weights.contiguous()
    sidx, perm = torch.sort(idx.to(torch.int64), stable=True)
    partial = torch.empty((n, D + 1), dtype=torch.float32,
                          device=table.device)
    bounds = torch.empty(2 * V, dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        rc = cuda_lib.load("segment_update").segment_update_f32(
            sidx.data_ptr(), perm.data_ptr(), updates.data_ptr(),
            weights.data_ptr(), partial.data_ptr(), bounds.data_ptr(),
            table.data_ptr(), n, V, D, float(lr), int(bool(bf16)),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_update kernel launch failed: CUDA error "
                           f"{rc} (N={n}, V={V}, D={D})")
    segment_update.launches += 1
    return table


segment_update.launches = 0
