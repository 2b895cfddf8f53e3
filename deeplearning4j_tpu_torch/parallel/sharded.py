"""The vertex-synchronous sharded walk: one controller runs a net's forward
over a list of shards, each vertex (a ``ComputationGraph``'s) or layer (a
``MultiLayerNetwork``'s) over every shard before the next.

Each shard's forward is the net's own ``_loss_terms_walk``, a generator
that yields after every vertex. A vertex named a *cross-shard point*
yields a request instead of computing itself, and the walk answers it
with every shard's inputs at once:

- a ``BatchNormalization`` in training (and the graph's fused BN → add →
  act tail) takes the statistics of the whole batch: the shards' partial
  sums added in shard order, one finalize, the elementwise pass on every
  shard (``kernels/batchnorm.py::bn_train_shards``), the running mean and
  variance updated from the global statistics;
- a center-loss head (``CenterLossOutputLayer``) sums the shards'
  per-class sums and counts, so its centers move by the global batch's
  class means and its loss is the global mean;
- a Mixture-of-Experts layer (``expert.py``) routes every shard's tokens
  as one batch (the global capacity and buffer positions);
- under a sequence-parallel plan, a ``SelfAttentionLayer`` runs the ring
  (``sequence.py``) over each ring group's shards, and a
  ``TokenAndPositionEmbedding`` embeds each shard at its absolute
  positions.

Every other vertex runs on each shard alone. The backward is autograd
through the per-shard tensors (``wrapper.py::sync_step``)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..kernels.batchnorm import bn_train_shards
from ..nn.conf.layers.attention import (SelfAttentionLayer,
                                        TokenAndPositionEmbedding)
from ..nn.conf.layers.convolution import (BatchNormalization,
                                          detached_running_update)
from ..nn.conf.layers.feedforward import CenterLossOutputLayer
from ..nn.graph.computation_graph import ComputationGraph
from ..nn.graph.vertices import LayerVertex
from ..ops import activations


class ShardPlan:
    """The shards of one step: ``devices`` (one a shard, repeats allowed);
    for sequence parallelism ``offsets`` (each shard's first absolute
    position), ``rings`` (lists of shard indices, each one ring in
    sequence order) and ``ring`` (the ring-attention helper)."""

    def __init__(self, devices: Sequence, offsets: Optional[List[int]] = None,
                 rings: Optional[List[List[int]]] = None, ring=None):
        self.devices = [torch.device(d) for d in devices]
        self.offsets = offsets
        self.rings = rings
        self.ring = ring


def _layers(net):
    """(key, layer) of every layer: vertex names of a graph, indices of a
    multi-layer network."""
    if isinstance(net, ComputationGraph):
        return [(name, v.layer) for name, v in net.conf.vertices.items()
                if isinstance(v, LayerVertex)]
    return list(enumerate(net.layers))


def reads_batch(layer) -> bool:
    """A layer whose training forward reads the whole batch: a batch norm,
    a center-loss head, a Mixture-of-Experts router."""
    return isinstance(layer, (BatchNormalization, CenterLossOutputLayer)) \
        or getattr(layer, "routes_globally", False)


def cross_points(net, plan: ShardPlan) -> set:
    """The vertex names (graph) or layer indices (multi-layer network, and
    ``"center"`` for a center-loss head) the walk computes across shards:
    none for one shard outside sequence parallelism, whose own forward
    (the single-shard kernels) already sees the whole batch."""
    seq = plan.offsets is not None
    if len(plan.devices) == 1 and not seq:
        return set()
    out = set()
    for key, layer in _layers(net):
        if isinstance(layer, CenterLossOutputLayer):
            out.add("center")
        elif reads_batch(layer) or (seq and isinstance(
                layer, (SelfAttentionLayer, TokenAndPositionEmbedding))):
            out.add(key)
    if isinstance(net, ComputationGraph):
        plan_, _ = net._get_fusion_plan()
        out.update(plan_)                    # the BN tails' act vertices
    return out


# graftlint: shard
def walk(walks: list, plan: ShardPlan, answer_fn=None) -> list:
    """Advance every shard's walk in step, answering the cross-shard
    requests with ``answer_fn(requests, plan)`` (default :func:`answer`);
    returns each walk's return value."""
    answer_fn = answer_fn or answer
    n = len(walks)
    replies: list = [None] * n
    while True:
        reqs, results = [], []
        for w, reply in zip(walks, replies):
            try:
                reqs.append(w.send(reply))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if len(results) != n:
                raise RuntimeError("the shards' walks parted")
            return results
        if all(r is None for r in reqs):
            replies = [None] * n
            continue
        if any(r is None for r in reqs) or len({r[0] for r in reqs}) != 1:
            raise RuntimeError("the shards' walks parted at a cross-shard "
                               "vertex")
        replies = answer_fn(reqs, plan)


def answer(reqs, plan):
    """The replies to one cross-shard request of every shard."""
    kind = reqs[0][0]
    if kind == "center_loss":
        return _center_loss(reqs)
    if kind == "moe_route":
        _, layer, params, _, gen = reqs[0]
        return layer.route_global(params, [r[3] for r in reqs], True, gen)
    if kind == "bn_add_act":
        _, layer, params, state, _, _, act = reqs[0]
        return _batch_norm(layer, params, state, [r[4] for r in reqs],
                           plan, act=act, res=[r[5] for r in reqs])
    layer = reqs[0][1]
    if isinstance(layer, BatchNormalization):
        return _batch_norm(layer, reqs[0][2], reqs[0][3],
                           [r[4] for r in reqs], plan)
    if isinstance(layer, TokenAndPositionEmbedding):
        return [_embed(r, pos0) for r, pos0 in zip(reqs, plan.offsets)]
    if isinstance(layer, SelfAttentionLayer):
        return _ring_attention(reqs, plan)
    if getattr(layer, "routes_globally", False):
        return experts_across(reqs)
    raise RuntimeError(f"no cross-shard forward for {type(layer).__name__}")


def _on(tree, device):
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in tree.items()}


def _batch_norm(layer, params, state, xs, plan, act=None, res=None):
    """A batch norm (``act`` None: the layer's own activation; else the
    fused tail's) over every shard's x with the global statistics."""
    home = xs[0].device
    if not layer.lock_gamma_beta and params:
        gamma, beta = params["gamma"], params["beta"]
    else:
        gamma, beta = (torch.full((layer.n_out,), float(v), device=home,
                                  dtype=xs[0].dtype)
                       for v in (layer.gamma, layer.beta))
    own = act is None
    if own:
        relu = layer.activation_fn() is activations.relu
        act = "relu" if relu else "identity"
    ys, mean, var = bn_train_shards(xs, gamma, beta, state["mean"],
                                    layer.eps, act, res)
    if own and act != "relu":
        ys = [layer.activation_fn()(y) for y in ys]
    new = detached_running_update(layer.decay, state, mean, var)
    return [(y, _on(new, y.device)) for y in ys]


def _center_loss(reqs):
    """The center loss over every shard: each shard's squared distances
    over the global row count, the centers moved by the global batch's
    class means (sums and counts added in shard order)."""
    head, state = reqs[0][1], reqs[0][2]
    centers = state["centers"]
    home = centers.device
    n_total = sum(r[3].shape[0] for r in reqs)
    parts, sums, counts = [], None, None
    for _, _, _, feats, labels in reqs:
        dt = torch.promote_types(feats.dtype, centers.dtype)
        f, lab = feats.to(dt), labels.to(dt)
        diff = f - centers.to(f.device, dt)[lab.argmax(dim=-1)]
        parts.append(0.5 * head.lambda_ * (diff * diff).sum() / n_total)
        s = (lab.t() @ diff).detach().to(home)
        c = lab.sum(dim=0).detach().to(home)
        sums = s if sums is None else sums + s
        counts = c if counts is None else counts + c
    new_centers = centers + head.alpha * (
        sums / counts.clamp_min(1.0)[:, None]).to(centers.dtype)
    return [(loss, {"centers": new_centers.to(r[3].device)})
            for loss, r in zip(parts, reqs)]


def experts_across(reqs, experts=None):
    """A Mixture-of-Experts layer whose routing takes every shard's rows
    as one batch; shard s's experts are ``experts[s]`` (a list of
    parameter dicts, experts in order; default the request's own)."""
    layer = reqs[0][1]
    experts = experts or [[r[2]] for r in reqs]
    xs = [layer.maybe_dropout(r[4], train=True, gen=r[6]) for r in reqs]
    routes = layer.route_global(experts[0][0],
                                [x.reshape(-1, x.shape[-1]) for x in xs],
                                True, reqs[0][6])
    return [(layer.apply_experts(ex, x, rt), r[3])
            for r, ex, x, rt in zip(reqs, experts, xs, routes)]


# graftlint: shard
def _embed(req, pos0):
    """A token + position embedding at this shard's absolute positions."""
    _, layer, params, state, x, _, gen = req
    ids = x.long()
    if ids.dim() == 3:
        ids = ids.argmax(-1)
    if pos0 + ids.shape[1] > layer.max_length:
        raise ValueError(f"positions up to {pos0 + ids.shape[1]} > "
                         f"max_length {layer.max_length}")
    start = torch.full((ids.shape[0],), int(pos0), dtype=torch.long,
                       device=ids.device)
    out = layer.embed_chunk(params, ids, start)
    return layer.maybe_dropout(out, train=True, gen=gen), state


def _ring_attention(reqs, plan):
    """Self-attention with each ring group's shards' q/k/v through the
    ring helper."""
    if any(r[5] is not None for r in reqs):
        raise ValueError("ring attention does not support key masks; train "
                         "unmasked (LM) sequences or disable the ring "
                         "helper")
    layer = reqs[0][1]
    qkv = []
    for _, _, params, _, x, _, gen in reqs:
        x = layer.maybe_dropout(x, train=True, gen=gen)
        qkv.append(layer._project_qkv(params, x))
    outs: list = [None] * len(reqs)
    for ring in plan.rings:
        got = plan.ring.attend_shards(
            layer, [qkv[s][0] for s in ring], [qkv[s][1] for s in ring],
            [qkv[s][2] for s in ring])
        for s, o in zip(ring, got):
            outs[s] = o
    return [(layer._project_out(r[2], o), r[3]) for r, o in zip(reqs, outs)]
