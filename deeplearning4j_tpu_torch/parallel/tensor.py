"""Tensor (model) parallelism: parameters sharded over a ``model`` mesh axis
(the JAX package's ``parallel/tensor.py``).

JAX assigns a partition spec to every parameter and lets GSPMD partition
the unmodified step. Here one controller runs the sharded arithmetic
itself, Megatron's way, with the same specs:

- a column-parallel layer (``W`` [in, out] → ``P(None, model)``, ``b`` →
  ``P(model)``) computes its own slice of the output features on each
  shard, and the slices are put together along the last axis;
- the next, row-parallel, layer (``W`` → ``P(model, None)``, ``b``
  whole) multiplies each shard's slice of its input features by its rows
  of W and sums the partial products in shard order, then adds ``b`` once
  and applies the activation (a row-parallel head: its preoutput);
- convolutions alternate on their HWIO channel dims the same way (the
  port keeps JAX's HWIO kernel layout, so the specs carry over as they
  are); attention shards heads (``Wq`` / ``Wk`` / ``Wv`` column-parallel,
  each shard attending over its own heads, ``Wo`` row-parallel); an
  embedding is column-parallel; a Mixture-of-Experts layer shards its
  experts (``expert.py``);
- a layer's dropout is drawn once, on its whole input, before the cut.

:class:`ShardedTrainer` holds the masters and the updater state as
:class:`~.mesh.ShardedTensor` s (each coordinate its part, a copy for each
``data`` coordinate). A step cuts the batch over ``data`` and runs each
data group's forward as the net's own training walk (``_loss_terms_walk``,
``sharded.py``): the cut layers are its cross-shard points, answered over
the group's ``model`` shards, and every other layer, the preprocessors,
the loss (a center-loss head's too) and the penalty are the net's own
code. The groups' summed losses are divided by the global counts, one
backward runs, each shard's gradient is summed over the data groups in
order and the update rule applied to each shard's slice. A gradient
normalization over a layer takes the layer's whole gradient (the shards'
slices together), and the l1 / l2 penalty the whole parameter.
``net.params`` is refreshed with the gathered masters after each step."""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import torch

from ..nn.conf.layers.attention import SelfAttentionLayer
from ..nn.conf.layers.convolution import ConvolutionLayer
from ..nn.conf.layers.feedforward import (DenseLayer, EmbeddingLayer,
                                          OutputLayer)
from ..ops.updaters import normalize_gradient
from .mesh import DATA_AXIS, Mesh, P, ShardedTensor, make_mesh
from .sharded import ShardPlan, answer, cross_points, experts_across
from .wrapper import _view, pad_dataset, split_rows, walk_loss


def _spec_for_layer(layer, col_first: bool, model_axis: str):
    """(specs_dict, next_col_first). Alternates column/row parallelism."""
    if isinstance(layer, SelfAttentionLayer):
        # heads sharded: q/k/v column-parallel, output projection row
        specs = {"Wq": P(None, model_axis), "Wk": P(None, model_axis),
                 "Wv": P(None, model_axis)}
        if layer.project_out:
            specs["Wo"] = P(model_axis, None)
            specs["bo"] = P()
        return specs, col_first
    if isinstance(layer, EmbeddingLayer):
        # output features sharded → the next dense is row-parallel
        return {"W": P(None, model_axis), "b": P(model_axis)}, False
    if isinstance(layer, ConvolutionLayer):        # 1-D too (kIO / HWIO)
        ndim = 4 if type(layer).__name__ != "Convolution1DLayer" else 3
        lead = [None] * (ndim - 2)
        if col_first:
            return ({"W": P(*lead, None, model_axis), "b": P(model_axis)},
                    False)
        return {"W": P(*lead, model_axis, None), "b": P()}, True
    if isinstance(layer, DenseLayer) and not isinstance(layer, OutputLayer):
        if col_first:
            return {"W": P(None, model_axis), "b": P(model_axis)}, False
        return {"W": P(model_axis, None), "b": P()}, True
    if isinstance(layer, OutputLayer):
        # classifier head: row-parallel if the incoming features are cut
        if not col_first:
            return {"W": P(model_axis, None), "b": P()}, True
        return {}, col_first
    return {}, col_first


def tp_param_specs(net, model_axis: str = "model") -> List[dict]:
    """Per-layer {param_name: P}; unlisted params replicate."""
    net._ensure_init()
    specs, col = [], True
    for layer in net.layers:
        s, col = _spec_for_layer(layer, col, model_axis)
        specs.append(s)
    return specs


def _split_dim(spec) -> Optional[int]:
    """The dim a spec cuts (None when whole)."""
    for dim, entry in enumerate(tuple(spec)):
        if entry is not None:
            return dim
    return None


def _tmap(fn, tree):
    """``fn`` over the tensor (or ShardedTensor) leaves of a tree of
    dicts, lists and tuples."""
    if torch.is_tensor(tree) or isinstance(tree, ShardedTensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tmap(fn, v) for v in tree)
    return tree


def _leaves(tree) -> list:
    out = []
    _tmap(out.append, tree)
    return out


def _kind(layer, spec) -> str:
    """How the sharded forward runs a layer: its parameters' cut."""
    if not any(_split_dim(s) is not None for s in spec.values()):
        return "whole"
    if isinstance(layer, SelfAttentionLayer):
        return "heads"
    if "We1" in spec:
        return "experts"
    dim = _split_dim(spec["W"])
    return "col" if dim == len(tuple(spec["W"])) - 1 else "row"


def _row_sum(fn, ps, devs, x):
    """A row-parallel product: ``x`` cut along its last axis, shard t's
    slice through ``fn`` with its rows and a zero bias, the partial
    products summed in shard order on x's device, then the bias once."""
    home = x.device
    pre = None
    for p, dev, xs in zip(ps, devs, torch.chunk(x, len(ps), dim=-1)):
        part = fn({**p, "b": torch.zeros_like(p["b"])} if "b" in p else p,
                  xs.to(dev)).to(home)
        pre = part if pre is None else pre + part
    return pre + ps[0]["b"].to(home) if "b" in ps[0] else pre


class ShardedTrainer:
    """The net's train step with its parameters laid out by
    ``param_specs`` (per layer {name: P}; default: replicated) over
    ``mesh``, the batch cut over ``batch_axis`` (DP composes with the
    parameter layout: a ("data", "model") mesh is DP × TP)."""

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 param_specs: Optional[List[dict]] = None,
                 batch_axis: Optional[str] = DATA_AXIS):
        self.net = net
        self.mesh = mesh if mesh is not None else make_mesh()
        net._ensure_init()
        self.param_specs = param_specs if param_specs is not None \
            else [{} for _ in net.layers]
        self.batch_axis = batch_axis if batch_axis in self.mesh.shape \
            else None
        others = [a for a in self.mesh.axis_names if a != self.batch_axis]
        if len([a for a in others if self.mesh.shape[a] > 1]) > 1:
            raise ValueError(f"one parameter axis besides the batch axis; "
                             f"the mesh has {self.mesh.shape}")
        self.shard_axis = next((a for a in others
                                if self.mesh.shape[a] > 1),
                               others[0] if others else None)
        #: how the step runs each layer: "whole", or its cut ("col",
        #: "row", "heads", "experts")
        self._kinds = [_kind(layer, spec) if self.model_size > 1
                       else "whole"
                       for layer, spec in zip(net.layers, self.param_specs)]
        self._index = {id(layer): i for i, layer in enumerate(net.layers)}
        self.params = None
        self.updater_state = None

    @property
    def batch_divisor(self) -> int:
        return self.mesh.shape[self.batch_axis] if self.batch_axis else 1

    @property
    def model_size(self) -> int:
        return self.mesh.shape[self.shard_axis] if self.shard_axis else 1

    def _coord(self, d: int, t: int):
        return tuple(d if a == self.batch_axis else
                     t if a == self.shard_axis else 0
                     for a in self.mesh.axis_names)

    def _spec(self, i: int, name: str):
        return self.param_specs[i].get(name, P())

    def shard_params(self):
        """Lay the masters and the updater state out on the mesh by the
        specs (once; the steps keep the layout)."""
        net = self.net
        lay = lambda spec, v: ShardedTensor.from_global(self.mesh, spec, v)
        self.params = [{k: lay(self._spec(i, k), v) for k, v in p.items()}
                       for i, p in enumerate(net.params)]
        self.updater_state = [
            {k: _tmap(lambda sv, i=i, k=k: lay(
                self._spec(i, k) if sv.shape == net.params[i][k].shape
                else P(), sv), st)
             for k, st in us.items()}
            for i, us in enumerate(net.updater_state)]
        return self

    # ------------------------------------------------------------ forward
    def _full(self, i, ps, name, home):
        """Layer ``i``'s parameter ``name``: its shards concatenated along
        their cut dim (the autograd graph kept), or shard 0's copy."""
        dim = _split_dim(self._spec(i, name))
        if dim is None or len(ps) == 1:
            return ps[0][name]
        return torch.cat([p[name].to(home) for p in ps], dim=dim)

    def _walk_params(self, shards, home):
        """A data group's parameters as the net's own walk reads them
        (``shards``: each model shard's leaves). A whole layer's are model
        shard 0's; the walk reads a cut layer's only for the head's loss
        and for a penalty, and then gets them whole (the shards
        concatenated, so the penalty and the loss reach every shard);
        otherwise the cross-shard answer computes the layer from its
        shards and the walk gets none."""
        last = len(self.net.layers) - 1
        out = []
        for i, layer in enumerate(self.net.layers):
            ps = [s[i] for s in shards]
            if self._kinds[i] == "whole":
                out.append(ps[0])
            elif i == last or layer.l1 or layer.l2:
                out.append({k: self._full(i, ps, k, home) for k in ps[0]})
            else:
                out.append({})
        return out

    def _answer(self, shards, reqs, plan):
        """A cross-shard request of every data group's walk: a cut layer
        runs over the group's model shards (``shards[d][t]``: data group
        d's model shard t's cast parameters), a Mixture-of-Experts
        layer's routing takes every group's rows; the rest as any sharded
        walk answers them (a batch norm, a center loss)."""
        if reqs[0][0] in ("layer", "preoutput"):
            i = self._index[id(reqs[0][1])]
            kind = self._kinds[i]
            if kind == "experts":
                return experts_across(reqs, [[s[i] for s in group]
                                             for group in shards])
            if kind != "whole":
                return [self._cut(kind, [s[i] for s in group], req)
                        for group, req in zip(shards, reqs)]
        return answer(reqs, plan)

    @staticmethod
    def _cut(kind, ps, req):
        """A cut layer of one data group over its model shards' parameters
        ``ps``: (activation, state), or a row-parallel head's preoutput."""
        devs = [next(iter(p.values())).device for p in ps]
        if req[0] == "preoutput":         # its input dropped out already
            _, layer, _, x = req
            return _row_sum(lambda p, xs: layer.preoutput(p, xs), ps, devs,
                            x)
        _, layer, _, state, x, mask, gen = req
        if not isinstance(layer, EmbeddingLayer):
            # the layer's dropout, once, on the whole input (an embedding
            # draws nothing)
            x = layer.maybe_dropout(x, train=True, gen=gen)
        home = x.device
        if kind == "col":
            return torch.cat([layer.forward(p, state, x.to(dev), mask,
                                            train=True)[0].to(home)
                              for p, dev in zip(ps, devs)], dim=-1), state
        if kind == "row":
            lin = dataclasses.replace(layer, activation="identity")
            pre = _row_sum(lambda p, xs: lin.forward(
                p, state, xs, mask, train=True)[0], ps, devs, x)
            return layer.activation_fn()(pre), state
        # heads: each shard attends over its own heads
        sub = dataclasses.replace(layer, num_heads=layer.num_heads // len(ps),
                                  head_size=layer._head_size())
        out = None
        for p, dev in zip(ps, devs):
            q, k, v = sub._project_qkv(p, x.to(dev))
            o = sub._attend(q, k, v, None if mask is None else mask.to(dev))
            o = o.reshape(o.shape[0], o.shape[1], -1)
            part = (o @ p["Wo"]).to(home) if layer.project_out else \
                o.to(home)
            out = part if out is None else (
                out + part if layer.project_out else
                torch.cat([out, part], dim=-1))
        if layer.project_out:
            out = out + ps[0]["bo"].to(home)
        return layer.activation_fn()(out), state

    # --------------------------------------------------------------- step
    def fit_batch(self, ds):
        net = self.net
        if self.params is None:
            self.shard_params()
        n_dp, n_t = self.batch_divisor, self.model_size
        homes = [self.mesh.device(self._coord(d, 0)) for d in range(n_dp)]
        plan = ShardPlan(homes)
        cross = cross_points(net, plan) | {
            i for i, kind in enumerate(self._kinds) if kind != "whole"}
        leaves = {}
        with torch.enable_grad():
            for d in range(n_dp):
                for t in range(n_t):
                    c = self._coord(d, t)
                    leaves[(d, t)] = [
                        {k: st.local(c).detach().requires_grad_(True)
                         for k, st in p.items()} for p in self.params]
            groups = [[leaves[(d, t)] for t in range(n_t)]
                      for d in range(n_dp)]
            shards = [[net._cast_params(lv) for lv in group]
                      for group in groups]
            total, outs = walk_loss(
                net, [_view(net, h) for h in homes],
                [self._walk_params(g, h) for g, h in zip(groups, homes)],
                split_rows(pad_dataset(ds, n_dp), n_dp), plan, cross,
                functools.partial(self._answer, shards))
            flat = [(key, i, k) for key in sorted(leaves)
                    for i, p in enumerate(leaves[key]) for k in p]
            grads = torch.autograd.grad(
                total, [leaves[key][i][k] for key, i, k in flat],
                materialize_grads=True)
        self._update(dict(zip(flat, grads)), n_dp, n_t)
        net.state = net._strip_rnn_carry(
            [{k: v.detach().to(net.device) if torch.is_tensor(v) else v
              for k, v in s.items()} for s in outs[0][2]])
        net._after_step(total.detach(), net.state)

    @torch.no_grad()
    def _update(self, by, n_dp, n_t):
        """Each shard's gradient summed over the data groups, the whole
        layer's normalization, then the update rule on each shard's slice
        at data coordinate 0, copied to the other data coordinates."""
        net = self.net
        layers = net.layers
        grads = [[{} for _ in layers] for _ in range(n_t)]
        for i, p in enumerate(self.params):
            for k in p:
                sharded = _split_dim(self._spec(i, k)) is not None
                for t in (range(n_t) if sharded else (0,)):
                    acc = None
                    dev = self.mesh.device(self._coord(0, t))
                    for d in range(n_dp):
                        g = by[((d, t), i, k)].to(dev)
                        acc = g if acc is None else acc + g
                    grads[t][i][k] = acc
        for i, layer in enumerate(layers):
            strategy = layer.gradient_normalization
            if strategy is None or str(strategy).lower() == "none" or \
                    not grads[0][i]:
                continue
            home = self.mesh.device(self._coord(0, 0))
            full = {}
            for k in grads[0][i]:
                dim = _split_dim(self._spec(i, k))
                full[k] = grads[0][i][k] if dim is None else torch.cat(
                    [grads[t][i][k].to(home) for t in range(n_t)], dim=dim)
            full = normalize_gradient(
                full, strategy,
                1.0 if layer.gradient_normalization_threshold is None
                else layer.gradient_normalization_threshold)
            for k, g in full.items():
                dim = _split_dim(self._spec(i, k))
                if dim is None:
                    grads[0][i][k] = g
                else:
                    for t, part in enumerate(torch.chunk(g, n_t, dim=dim)):
                        grads[t][i][k] = part.to(grads[t][i][k].device)
        for t in range(n_t):
            c = self._coord(0, t)
            params = [{k: st.local(c) for k, st in p.items()}
                      for p in self.params]
            ustate = [{k: _tmap(lambda sv: sv.local(c), st)
                       for k, st in us.items()}
                      for us in self.updater_state]
            net._apply_gradients(grads[t], params=params,
                                 updater_state=ustate, normalize=False)
            for i, us in enumerate(ustate):
                for k, st in us.items():
                    if k not in grads[t][i]:
                        continue
                    for held, sv in zip(_leaves(self.updater_state[i][k]),
                                        _leaves(st)):
                        held.shards[c] = sv
        # every coordinate takes its slice from data coordinate 0 (a
        # replicated leaf from model shard 0, the one updated)
        for i, p in enumerate(self.params):
            for k, st in p.items():
                for tree in [st, *_leaves(self.updater_state[i][k])]:
                    split = _split_dim(tree.spec) is not None
                    for d in range(n_dp):
                        for t in range(n_t):
                            src = self._coord(0, t if split else 0)
                            dst = self._coord(d, t)
                            if dst != src:
                                tree.shards[dst] = tree.shards[src].to(
                                    self.mesh.device(dst), copy=True)
        home = net.device
        net.params = [{k: st.gather(home) for k, st in p.items()}
                      for p in self.params]
        net.updater_state = [{k: _tmap(lambda sv: sv.gather(home), st)
                              for k, st in us.items()}
                             for us in self.updater_state]

    def fit(self, data, num_epochs: int = 1):
        from ..datasets.iterators import as_iterator
        for _ in range(num_epochs):
            for ds in as_iterator(data):
                self.fit_batch(ds)
            self.net.epoch += 1
        return self


class TensorParallelTrainer(ShardedTrainer):
    """Megatron-style TP (optionally × DP on a 2-axis mesh)."""

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 model_axis: str = "model", batch_axis: str = DATA_AXIS):
        if mesh is None:
            mesh = make_mesh(axis_names=(DATA_AXIS, model_axis),
                             shape=(1, torch.cuda.device_count()))
        net._ensure_init()
        super().__init__(net, mesh, tp_param_specs(net, model_axis),
                         batch_axis)
