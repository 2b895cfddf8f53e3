"""Loss functions (the JAX package's ``ops/losses.py``), as functions on
tensors.

Each loss maps ``(labels, preoutput, activation, mask)`` to the
per-example score [minibatch]; :func:`compute_loss` sums it and averages
it with the JAX package's rules: per present (example, timestep) cell for
sequences, per (present) example otherwise. Cross-entropies are computed
from log-probabilities (log-softmax, or the stable sigmoid form), as
there. Masks multiply the per-element score before the reduction."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .activations import get_activation

_EPS = 1e-7

LossFn = Callable[..., torch.Tensor]
_REGISTRY: Dict[str, LossFn] = {}


def register_loss(name: str, fn: LossFn) -> LossFn:
    _REGISTRY[name.lower()] = fn
    return fn


def get_loss(name) -> LossFn:
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def loss_names():
    return sorted(_REGISTRY)


def _apply_mask(per_elem, mask):
    if mask is None:
        return per_elem
    mask = mask.to(per_elem.dtype)
    while mask.dim() < per_elem.dim():
        mask = mask[..., None]
    return per_elem * mask


def _reduce_example(per_elem, mask):
    """Sum per-element scores over all non-batch axes → [minibatch]."""
    per_elem = _apply_mask(per_elem, mask)
    axes = tuple(range(1, per_elem.dim()))
    return per_elem.sum(dim=axes) if axes else per_elem


def _act_name(activation):
    return None if callable(activation) else str(activation).lower()


# Every loss: (labels, preoutput, activation, mask) -> [minibatch]

def mse(labels, preoutput, activation="identity", mask=None):
    d = get_activation(activation)(preoutput) - labels
    return _reduce_example(d * d, mask) / labels.shape[-1]


def l2(labels, preoutput, activation="identity", mask=None):
    d = get_activation(activation)(preoutput) - labels
    return _reduce_example(d * d, mask)


def l1(labels, preoutput, activation="identity", mask=None):
    out = get_activation(activation)(preoutput)
    return _reduce_example((out - labels).abs(), mask)


def mae(labels, preoutput, activation="identity", mask=None):
    return l1(labels, preoutput, activation, mask) / labels.shape[-1]


def xent(labels, preoutput, activation="sigmoid", mask=None):
    """Binary cross-entropy; the stable fused form under a sigmoid."""
    if _act_name(activation) == "sigmoid":
        x = preoutput
        per = torch.clamp_min(x, 0.0) - x * labels + \
            torch.log1p(torch.exp(-x.abs()))
    else:
        p = torch.clamp(get_activation(activation)(preoutput), _EPS,
                        1.0 - _EPS)
        per = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _reduce_example(per, mask)


def mcxent(labels, preoutput, activation="softmax", mask=None):
    """Multiclass cross-entropy; log-softmax under a softmax."""
    if _act_name(activation) == "softmax":
        logp = torch.log_softmax(preoutput, dim=-1)
    else:
        logp = torch.log(torch.clamp(get_activation(activation)(preoutput),
                                     _EPS, 1.0))
    return _reduce_example(-labels * logp, mask)


def negativeloglikelihood(labels, preoutput, activation="softmax",
                          mask=None):
    return mcxent(labels, preoutput, activation, mask)


def kl_divergence(labels, preoutput, activation="softmax", mask=None):
    p = torch.clamp(get_activation(activation)(preoutput), _EPS, 1.0)
    y = torch.clamp(labels, _EPS, 1.0)
    return _reduce_example(labels * (torch.log(y) - torch.log(p)), mask)


def cosine_proximity(labels, preoutput, activation="identity", mask=None):
    out = get_activation(activation)(preoutput)
    if mask is not None:
        out = _apply_mask(out, mask)
        labels = _apply_mask(labels, mask)
    dot = (labels * out).sum(dim=-1)
    norm = torch.linalg.vector_norm(labels, dim=-1) * \
        torch.linalg.vector_norm(out, dim=-1)
    per = -dot / torch.clamp_min(norm, _EPS)
    axes = tuple(range(1, per.dim()))
    return per.sum(dim=axes) if axes else per


def hinge(labels, preoutput, activation="identity", mask=None):
    out = get_activation(activation)(preoutput)
    return _reduce_example(torch.clamp_min(1.0 - labels * out, 0.0), mask)


def squared_hinge(labels, preoutput, activation="identity", mask=None):
    h = torch.clamp_min(1.0 - labels * get_activation(activation)(preoutput),
                        0.0)
    return _reduce_example(h * h, mask)


def poisson(labels, preoutput, activation="identity", mask=None):
    out = get_activation(activation)(preoutput)
    return _reduce_example(out - labels * torch.log(torch.clamp_min(out,
                                                                    _EPS)),
                           mask)


def mape(labels, preoutput, activation="identity", mask=None):
    out = get_activation(activation)(preoutput)
    per = 100.0 * ((labels - out) / torch.clamp_min(labels.abs(), _EPS)).abs()
    return _reduce_example(per, mask) / labels.shape[-1]


def msle(labels, preoutput, activation="identity", mask=None):
    out = get_activation(activation)(preoutput)
    d = torch.log1p(torch.clamp_min(out, -1.0 + _EPS)) - torch.log1p(labels)
    return _reduce_example(d * d, mask) / labels.shape[-1]


for _name, _fn in [
    ("mse", mse), ("squared_loss", l2), ("l2", l2), ("l1", l1), ("mae", mae),
    ("mean_absolute_error", mae), ("mean_squared_error", mse),
    ("xent", xent), ("binary_crossentropy", xent),
    ("mcxent", mcxent), ("categorical_crossentropy", mcxent),
    ("negativeloglikelihood", negativeloglikelihood),
    ("kl_divergence", kl_divergence), ("reconstruction_crossentropy", xent),
    ("cosine_proximity", cosine_proximity),
    ("hinge", hinge), ("squared_hinge", squared_hinge),
    ("poisson", poisson),
    ("mean_absolute_percentage_error", mape), ("mape", mape),
    ("mean_squared_logarithmic_error", msle), ("msle", msle),
]:
    register_loss(_name, _fn)


def loss_terms(name, labels, preoutput, activation="identity",
               mask: Optional[torch.Tensor] = None):
    """(the summed per-example score, the count :func:`compute_loss`
    divides it by, unclamped): for [N, T, ...] labels the count of
    present (example, timestep) cells (N·T without a [N, T] mask),
    otherwise the example count (the present examples' under an [N] /
    [N, 1] mask). Mask counts are f32 tensors, shape counts ints, so the
    counts of row blocks add up to the whole batch's (data-parallel
    training divides every block's sum by that)."""
    total = get_loss(name)(labels, preoutput, activation, mask).sum()
    if labels.dim() == 3:
        if mask is not None and mask.dim() >= 2 and \
                tuple(mask.shape[:2]) == tuple(labels.shape[:2]):
            return total, mask.to(torch.float32).sum()
        return total, labels.shape[0] * labels.shape[1]
    if mask is not None and (mask.dim() == 1 or
                             (mask.dim() == 2 and mask.shape[-1] == 1)):
        return total, mask.to(torch.float32).sum()
    return total, labels.shape[0]


def clamp_count(count):
    """A loss denominator as the score divides by it: a counted mask is
    at least 1 (an all-masked batch scores 0, not NaN)."""
    return torch.clamp_min(count, 1.0) if torch.is_tensor(count) else count


def compute_loss(name, labels, preoutput, activation="identity",
                 mask: Optional[torch.Tensor] = None, average: bool = True):
    """The scalar score: per-example scores summed and, with ``average``,
    divided by the JAX package's denominator (:func:`loss_terms`)."""
    total, count = loss_terms(name, labels, preoutput, activation, mask)
    return total / clamp_count(count) if average else total


def reduce_terms(terms, start=None, denominators=None):
    """The score of loss terms: ``start`` (e.g. the l1 / l2 penalty) plus,
    in order, each (total, count) term's total over its clamped count (a
    None count adds the total as is). ``denominators``, one per term,
    replace the terms' own counts: a data-parallel shard divides its
    block's sum by the whole batch's count."""
    score = start
    for i, (total, count) in enumerate(terms):
        if denominators is not None:
            count = denominators[i]
        value = total if count is None else total / clamp_count(count)
        score = value if score is None else score + value
    return score
