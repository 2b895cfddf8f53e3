"""Fused sparse-label softmax cross-entropy over the output projection (the
JAX package's ``kernels/fused_ce.py``, a custom VJP there and a
``torch.autograd.Function`` here; plain torch, not a Pallas kernel).

``sparse_softmax_ce_sum`` computes Σ_i w_i · (logsumexp(x_i W + b) −
(x_i W + b)[t_i]) from integer class ids, so the [R, V] one-hot labels
never exist:

- forward: per-row (lse, target logit) in f32 from the compute-dtype
  logits. At most ``MATERIALIZE_LIMIT`` logit elements are kept for the
  backward; above it the rows are processed ``CHUNK_ROWS`` at a time and
  the backward recomputes each chunk's logits instead of storing [R, V].
- backward: dlogits = (softmax − onehot) · w · g, the one-hot an iota
  comparison (not a scatter), consumed at once by the dx / dW products.

:func:`fused_sparse_ce_score` applies the JAX package's averaging rules
(``compute_loss``'s): per present cell for sequences with a [N, T] mask,
per example otherwise."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.losses import clamp_count

# Above this many logit elements ([rows x vocab]) the forward chunks the
# row axis and the backward recomputes logits chunk-wise instead of
# storing them: 2^29 elements = 1 GiB of bf16.
MATERIALIZE_LIMIT = 1 << 29
CHUNK_ROWS = 4096

_MCXENT_LOSSES = ("mcxent", "negativeloglikelihood",
                  "categorical_crossentropy")


def _acc(dtype):
    """Accumulation dtype: at least f32 (f64 stays f64)."""
    return torch.promote_types(dtype, torch.float32)


def _lse_tgt_from(logits, ids):
    """Per-row (logsumexp, target logit) in the accumulation dtype from
    logits kept in the compute dtype: only the exp runs wider."""
    acc = _acc(logits.dtype)
    m = logits.amax(dim=-1)
    z = (logits - m[:, None]).to(acc).exp().sum(dim=-1)
    lse = m.to(acc) + torch.log(z)
    tgt = logits.gather(1, ids[:, None])[:, 0]
    return lse, tgt.to(acc)


def _logits(x2, W, b):
    return x2 @ W + b[None, :]


def _dlogits(logits, lse, ids, scale):
    """(softmax − onehot) · scale, in the logits' dtype; the one-hot is a
    column-index comparison."""
    acc = _acc(logits.dtype)
    p = torch.exp(logits.to(acc) - lse[:, None])
    cols = torch.arange(logits.shape[1], device=logits.device)
    onehot = (cols[None, :] == ids[:, None]).to(acc)
    return ((p - onehot) * scale[:, None]).to(logits.dtype)


def _chunks(rows: int):
    return [slice(i, min(i + CHUNK_ROWS, rows))
            for i in range(0, rows, CHUNK_ROWS)]


class _SparseCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, W, b, ids, w, chunked: bool):
        if chunked:
            parts = [_lse_tgt_from(_logits(x2[sl], W, b), ids[sl])
                     for sl in _chunks(x2.shape[0])]
            lse = torch.cat([p[0] for p in parts])
            tgt = torch.cat([p[1] for p in parts])
            logits = None
        else:
            logits = _logits(x2, W, b)
            lse, tgt = _lse_tgt_from(logits, ids)
        ctx.chunked = chunked
        ctx.save_for_backward(x2, W, b, ids, w, lse, logits)
        return ((lse - tgt) * w).sum()

    @staticmethod
    def backward(ctx, g):
        x2, W, b, ids, w, lse, logits = ctx.saved_tensors
        acc = _acc(x2.dtype)
        scale = (w * g).to(acc)
        if not ctx.chunked:
            dl = _dlogits(logits, lse, ids, scale)
            dx = dl @ W.T
            dW = x2.T @ dl
            db = dl.to(acc).sum(dim=0).to(b.dtype)
            return dx, dW, db, None, None, None
        dx = torch.empty_like(x2)
        dW = torch.zeros(W.shape, dtype=acc, device=W.device)
        db = torch.zeros(b.shape, dtype=acc, device=b.device)
        for sl in _chunks(x2.shape[0]):
            dl = _dlogits(_logits(x2[sl], W, b), lse[sl], ids[sl], scale[sl])
            dx[sl] = dl @ W.T
            dW += (x2[sl].T @ dl).to(acc)
            db += dl.to(acc).sum(dim=0)
        return dx, dW.to(W.dtype), db.to(b.dtype), None, None, None


def sparse_softmax_ce_sum(x2, W, b, ids, w, chunked: bool = False):
    """Σ_i w_i · CE_i for rows x2 [R, D], projection W [D, V] + b [V],
    integer ids [R] and weights w [R] (0 masks a row out): a 0-d tensor in
    the accumulation dtype. The caller divides by its averaging
    denominator."""
    return _SparseCE.apply(x2, W, b, ids, w, bool(chunked))


def sparse_shaped(layer, y) -> bool:
    """Integer labels whose rank matches sparse ids for this head ([N, T]
    for rnn heads, [N] for ff heads, optional trailing singleton)."""
    if not torch.is_tensor(y) or y.dtype.is_floating_point or \
            y.dtype == torch.bool:
        return False
    kind = layer.input_kind() if hasattr(layer, "input_kind") else "ff"
    expected = 2 if kind == "rnn" else 1
    return y.dim() == expected or (y.dim() == expected + 1 and
                                   y.shape[-1] == 1)


def sparse_labels_eligible(layer, y, layer_params=None) -> bool:
    """Whether a sequential net's head takes the fused path: a softmax +
    mcxent projection (W and b present, not a center-loss head) whose
    labels are integer class ids of the head's rank. Integer one-hot
    labels keep the materialized ``compute_score``."""
    if hasattr(layer, "center_loss_and_update"):
        return False
    if str(getattr(layer, "loss", "")).lower() not in _MCXENT_LOSSES:
        return False
    if str(getattr(layer, "activation", "")).lower() != "softmax":
        return False
    if not hasattr(layer, "preoutput"):
        return False
    if layer_params is not None and not (
            isinstance(layer_params, dict) and "W" in layer_params and
            "b" in layer_params):
        return False
    return sparse_shaped(layer, y)


def fused_sparse_ce_terms(layer_params, x, ids,
                          mask: Optional[torch.Tensor]):
    """(the summed loss of a fused head, its denominator unclamped): x is
    the output layer's INPUT ([N, D] or [N, T, D]) and ids the integer
    labels ([N] or [N, T]). A [N, T] mask counts its present cells; a
    per-example [N] / [N, 1] mask over a sequence keeps the N·T
    denominator; 2-D inputs count their (present) examples."""
    W, b = layer_params["W"], layer_params["b"]
    seq = x.dim() == 3
    if seq:
        n, t, d = x.shape
        x2 = x.reshape(n * t, d)
        ids2 = ids.reshape(n * t).long()
    else:
        x2 = x
        ids2 = ids.reshape(x.shape[0]).long()
    acc = _acc(x2.dtype)
    per_example_seq_mask = False
    if mask is not None:
        m = mask.to(acc)
        if seq and not (m.dim() >= 2 and
                        tuple(m.shape[:2]) == (x.shape[0], x.shape[1])):
            m = m.reshape(x.shape[0], 1).expand(x.shape[0], x.shape[1])
            per_example_seq_mask = True
        w = m.reshape(-1)
        if w.shape[0] != x2.shape[0]:
            raise ValueError(f"mask {tuple(mask.shape)} does not cover rows "
                             f"{x2.shape[0]}")
    else:
        w = torch.ones(x2.shape[0], dtype=acc, device=x2.device)
    chunked = x2.shape[0] * W.shape[1] > MATERIALIZE_LIMIT
    total = sparse_softmax_ce_sum(x2, W, b, ids2, w, chunked)
    if mask is not None and not per_example_seq_mask:
        return total, w.sum()
    return total, float(x.shape[0] * x.shape[1] if seq else x.shape[0])


def fused_sparse_ce_score(layer_params, x, ids,
                          mask: Optional[torch.Tensor],
                          average: bool = True):
    """The loss of a fused head (:func:`fused_sparse_ce_terms`), averaged
    over its denominator unless ``average`` is False."""
    total, count = fused_sparse_ce_terms(layer_params, x, ids, mask)
    return total / clamp_count(count) if average else total
