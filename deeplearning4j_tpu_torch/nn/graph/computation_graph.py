"""ComputationGraph: the DAG model (the JAX package's
``nn/graph/computation_graph.py``), inference and training.

Parameters are f32 masters in ``params[vertex][name]`` on ``device``; a
bf16 ``compute_dtype`` runs the forward on a cast copy
(:meth:`_cast_params`), and gradients flow back through the cast to the
masters. ``device=None`` means the CUDA card and raises when there is
none — tests and CPU references pass ``device="cpu"``.

A train step (:meth:`fit_batch`) is: the loss of the batch (dropout drawn
from generators seeded per iteration and vertex, integer labels on a
terminal softmax head through the fused sparse cross-entropy, other
labels through the head's ``compute_score``),
``torch.autograd.grad`` over the masters, then per vertex the gradient
normalization, the scheduled learning rate and the JAX package's update
rule, applied to the masters in place. Nothing in the step reads a value
back to the host; ``score_value`` stays a device tensor. The BN fusion
plan and truncated BPTT of the JAX graph are not on the LM path and are
not ported."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...ops import rng as rngmod
from ...ops.dataset import DataSet
from ...ops.platform import resolve_device
from ...ops.updaters import make_updater, normalize_gradient, schedule_lr
from ...kernels.fused_ce import (_MCXENT_LOSSES, fused_sparse_ce_score,
                                 sparse_shaped)
from ..conf.layers import OutputLayer
from .graph_config import ComputationGraphConfiguration
from .vertices import LayerVertex


def _nz(value, default):
    """None-aware default (0.0 is a real value — e.g. a frozen lr)."""
    return default if value is None else value


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration,
                 compute_dtype=None, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or torch.float32
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Dict] = {}
        self.updaters: Dict[str, object] = {}
        self.updater_state: Dict[str, Dict] = {}
        self.iteration = 0
        self.epoch = 0
        self.score_value = float("nan")
        self._initialized = False

    # ------------------------------------------------------------------ init
    def init(self) -> "ComputationGraph":
        """Seeded f32 initialization on the net's device: one generator
        per vertex, folded from the configuration seed and the vertex's
        topological index; then the updaters and their zero state."""
        base = rngmod.for_purpose(self.conf.seed, "init")
        self.params, self.state = {}, {}
        for idx, name in enumerate(self.conf.topological_order):
            v = self.conf.vertices[name]
            gen = rngmod.generator(rngmod.fold_in(base, idx), self.device)
            self.params[name] = v.init_params(gen, torch.float32)
            self.state[name] = v.init_state()
        self.init_updaters()
        self._initialized = True
        return self

    def init_updaters(self) -> None:
        """Per-vertex update rules from each layer's configuration, and
        their zero state for the current parameters."""
        self.updaters, self.updater_state = {}, {}
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            layer = v.layer if isinstance(v, LayerVertex) else None
            get = lambda field, default: _nz(
                getattr(layer, field) if layer else None, default)
            upd = make_updater(
                get("updater", None) or "sgd",
                momentum=get("momentum", 0.9),
                adam_mean_decay=get("adam_mean_decay", 0.9),
                adam_var_decay=get("adam_var_decay", 0.999),
                rho=get("rho", 0.95), rms_decay=get("rms_decay", 0.95),
                epsilon=get("epsilon", 1e-8))
            self.updaters[name] = upd
            self.updater_state[name] = {k: upd.init(p) for k, p in
                                        self.params.get(name, {}).items()}

    def _ensure_init(self):
        if not self._initialized:
            self.init()

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, inputs: Dict[str, torch.Tensor], *,
                 train: bool = False, rng: Optional[int] = None,
                 input_masks: Optional[Dict] = None,
                 output_preout: bool = False, skip_preoutput=()):
        """Walk the topological order. Returns (activations, new_state,
        reg, masks, last_inputs, preouts). ``rng`` is the step's dropout
        seed: a vertex that draws dropout gets a generator seeded with
        ``for_layer(rng, index)``. Each vertex's mask is its first input's.
        With ``output_preout``, output vertices record their input
        (``last_inputs``) and pre-activation (``preouts``, which their loss
        scores); those in ``skip_preoutput`` are projected inside the loss
        (fused CE), so their [.., n_out] pre-activation is never built."""
        acts: Dict[str, torch.Tensor] = dict(inputs)
        masks: Dict[str, Optional[torch.Tensor]] = dict(input_masks or {})
        new_state: Dict[str, Dict] = {}
        last_inputs: Dict[str, torch.Tensor] = {}
        preouts: Dict[str, torch.Tensor] = {}
        reg = 0.0
        out_set = set(self.conf.network_outputs) if output_preout else set()
        for idx, name in enumerate(self.conf.topological_order):
            v = self.conf.vertices[name]
            in_names = self.conf.vertex_inputs[name]
            xs = [acts[i] for i in in_names]
            ms = [masks.get(i) for i in in_names]
            layer = v.layer if isinstance(v, LayerVertex) else None
            gen = None
            if train and rng is not None and layer is not None and \
                    layer.uses_dropout():
                gen = rngmod.generator(rngmod.for_layer(rng, idx),
                                       self.device)
            if layer is not None:
                reg = reg + layer.reg_penalty(params[name])
            if name in out_set and layer is not None and \
                    hasattr(layer, "preoutput"):
                if v.preprocessor is not None:
                    raise NotImplementedError("input preprocessors are not "
                                              "ported")
                x = layer.maybe_dropout(xs[0], train=train, gen=gen)
                last_inputs[name] = x
                masks[name] = ms[0]
                new_state[name] = state[name]
                if name in skip_preoutput:
                    continue            # projection fused into the loss
                preouts[name] = layer.preoutput(params[name], x)
                acts[name] = layer.activation_fn()(preouts[name])
            else:
                acts[name], new_state[name] = v.forward(
                    params[name], state[name], xs, train=train, gen=gen,
                    masks=ms)
                masks[name] = ms[0] if ms else None
        return acts, new_state, reg, masks, last_inputs, preouts

    def _to_device_dtype(self, a) -> torch.Tensor:
        """compute_dtype for floats; integer inputs (token ids, class ids)
        keep an integer dtype — casting ids through bf16 would corrupt
        every id >= 257."""
        t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
        t = t.to(self.device)
        if t.dtype.is_floating_point:
            return t.to(self.compute_dtype)
        return t.long()

    def _named(self, names, values, convert) -> Dict[str, torch.Tensor]:
        if isinstance(values, dict):
            return {k: convert(v) for k, v in values.items()}
        if isinstance(values, (list, tuple)):
            return {n: convert(v) for n, v in zip(names, values)}
        return {names[0]: convert(values)}

    def _inputs_dict(self, features) -> Dict[str, torch.Tensor]:
        return self._named(self.conf.network_inputs, features,
                           self._to_device_dtype)

    def _labels_dict(self, labels) -> Dict[str, torch.Tensor]:
        return self._named(self.conf.network_outputs, labels,
                           self._to_device_dtype)

    def _inference_state(self):
        """Per-vertex state for inference (empty for the transformer
        LM)."""
        return self.state

    def _cast_params(self, params):
        """Mixed precision: a compute-dtype copy of the f32 master
        params (differentiable: gradients reach the masters in f32)."""
        cd = self.compute_dtype
        if cd == torch.float32:
            return params
        return {v: {k: a.to(cd) if a.dtype == torch.float32 else a
                    for k, a in p.items()}
                for v, p in params.items()}

    @torch.no_grad()
    def output(self, *features) -> List[np.ndarray]:
        """Forward pass → list of output activations as float32 numpy
        arrays (one per network output)."""
        self._ensure_init()
        inputs = self._inputs_dict(features[0] if len(features) == 1
                                   else list(features))
        acts, *_ = self._forward(self._cast_params(self.params),
                                 self._inference_state(), inputs)
        return [acts[o].float().cpu().numpy()
                for o in self.conf.network_outputs]

    def num_params(self) -> int:
        self._ensure_init()
        return sum(int(a.numel()) for p in self.params.values()
                   for a in p.values())

    # -------------------------------------------------------------- training
    def _fused_ce_outputs(self, labels: Dict) -> set:
        """Terminal softmax + mcxent OutputLayers whose labels are integer
        class ids of the head's rank: their projection and loss run as one
        fused sparse cross-entropy (kernels/fused_ce.py)."""
        eligible = set()
        for out_name in self.conf.network_outputs:
            v = self.conf.vertices[out_name]
            if not isinstance(v, LayerVertex):
                continue
            layer = v.layer
            if str(getattr(layer, "loss", "")).lower() not in _MCXENT_LOSSES:
                continue
            if str(getattr(layer, "activation", "")).lower() != "softmax":
                continue
            if not isinstance(layer, OutputLayer):
                continue                 # needs a W/b projection to fuse
            y = labels.get(out_name)
            if y is None or not sparse_shaped(layer, y):
                continue
            if any(out_name in ins for ins in self.conf.vertex_inputs.values()):
                continue                 # another vertex consumes this act
            eligible.add(out_name)
        return eligible

    def _loss(self, params, state, inputs, labels: Dict, rng,
              label_masks: Optional[Dict] = None, input_masks=None):
        """(score, new_state): the summed output losses plus the l1/l2
        penalty, on the compute-dtype cast of ``params``."""
        params = self._cast_params(params)
        fused_outs = self._fused_ce_outputs(labels)
        _, new_state, reg, masks, last_in, preouts = self._forward(
            params, state, inputs, train=True, rng=rng,
            input_masks=input_masks, output_preout=True,
            skip_preoutput=fused_outs)
        score = reg
        for out_name in self.conf.network_outputs:
            v = self.conf.vertices[out_name]
            if not isinstance(v, LayerVertex) or \
                    not hasattr(v.layer, "compute_score"):
                continue
            y = labels[out_name]
            lmask = (label_masks or {}).get(out_name)
            if out_name in fused_outs:
                x = last_in[out_name]
                if lmask is None and x.dim() == 3:
                    lmask = masks.get(out_name)
                score = score + fused_sparse_ce_score(params[out_name], x, y,
                                                      lmask)
                continue
            if sparse_shaped(v.layer, y) and \
                    str(getattr(v.layer, "loss", "")).lower() in \
                    _MCXENT_LOSSES:
                raise ValueError(
                    f"output '{out_name}' got integer class-id labels but "
                    "is not fused-CE eligible (sparse labels need a "
                    "TERMINAL OutputLayer with softmax activation whose "
                    "activation no other vertex consumes). Pass one-hot "
                    "labels here, or restructure the graph so the softmax "
                    "head is terminal.")
            pre = preouts[out_name]
            if lmask is None and pre.dim() == 3:
                lmask = masks.get(out_name)
            score = score + v.layer.compute_score(params[out_name], y, pre,
                                                  lmask)
        return score, new_state

    def _masks_of(self, ds):
        """(input_masks, label_masks) dicts from a DataSet, in the compute
        dtype on the device."""
        conv = lambda m: \
            torch.as_tensor(np.asarray(m)).to(self.device, self.compute_dtype)
        imasks = None if ds.features_mask is None else \
            {self.conf.network_inputs[0]: conv(ds.features_mask)}
        lmasks = None if ds.labels_mask is None else \
            {self.conf.network_outputs[0]: conv(ds.labels_mask)}
        return imasks, lmasks

    def _batch(self, ds):
        imasks, lmasks = self._masks_of(ds)
        return (self._inputs_dict(ds.features), self._labels_dict(ds.labels),
                imasks, lmasks)

    def _value_and_grad(self, state, inputs, labels, rng, lmasks, imasks):
        """(score, new_state, {vertex: {param: gradient}}) of the loss over
        the f32 masters. The autograd leaves share the masters' storage,
        so an update may write the masters in place once this returns."""
        leaves = {name: {k: p.detach().requires_grad_(True)
                         for k, p in ps.items()}
                  for name, ps in self.params.items()}
        flat = [(name, k) for name, ps in leaves.items() for k in ps]
        with torch.enable_grad():
            score, new_state = self._loss(leaves, state, inputs, labels,
                                          rng, lmasks, imasks)
            grads = torch.autograd.grad(
                score, [leaves[n][k] for n, k in flat],
                materialize_grads=True) if flat else ()
        by_vertex: Dict[str, Dict[str, torch.Tensor]] = {
            name: {} for name in self.params}
        for (name, k), g in zip(flat, grads):
            by_vertex[name][k] = g
        return score.detach(), new_state, by_vertex

    def _train_step(self, inputs, labels, imasks, lmasks):
        """One update of every parameter in place; returns the score (a
        0-d device tensor)."""
        conf = self.conf
        rng = rngmod.for_iteration(rngmod.for_purpose(conf.seed, "dropout"),
                                   self.iteration)
        score, new_state, by_vertex = self._value_and_grad(
            self.state, inputs, labels, rng, lmasks, imasks)
        with torch.no_grad():
            for name, g in by_vertex.items():
                if not g:
                    continue
                v = conf.vertices[name]
                layer = v.layer if isinstance(v, LayerVertex) else None
                if layer is not None:
                    g = normalize_gradient(
                        g, layer.gradient_normalization,
                        _nz(layer.gradient_normalization_threshold, 1.0))
                lr = schedule_lr(
                    _nz(layer.learning_rate if layer else None, 0.1),
                    conf.lr_policy, self.iteration,
                    decay_rate=conf.lr_policy_decay_rate,
                    steps=conf.lr_policy_steps, power=conf.lr_policy_power,
                    max_iterations=float(conf.max_iterations or 1),
                    schedule=conf.learning_rate_schedule)
                upd = self.updaters[name]
                for pname, grad in g.items():
                    step, ustate = upd.update(
                        grad, self.updater_state[name][pname], lr,
                        float(self.iteration))
                    self.params[name][pname].sub_(step)
                    self.updater_state[name][pname] = ustate
        self.state = new_state
        return score

    def fit_batch(self, ds):
        """One train step on a DataSet. ``score_value`` becomes the step's
        loss as a device tensor (no host sync)."""
        self._ensure_init()
        if self.conf.backprop_type == "truncated_bptt":
            raise NotImplementedError("truncated BPTT is not ported")
        self.score_value = self._train_step(*self._batch(ds))
        self.iteration += 1

    def fit(self, data, num_epochs: int = 1):
        """Train on a DataSet, or a list or iterator of them (an iterator
        with ``reset`` is reset after each epoch)."""
        self._ensure_init()
        if isinstance(data, DataSet):
            data = [data]
        elif not isinstance(data, (list, tuple)) and \
                not hasattr(data, "reset"):
            data = list(data)   # a plain generator would train one epoch
        for _ in range(num_epochs):
            for ds in data:
                self.fit_batch(ds)
            if hasattr(data, "reset"):
                data.reset()
            self.epoch += 1
        return self

    # --------------------------------------------------------------- scoring
    def score(self, ds) -> float:
        """The loss of ``ds`` with the current parameters (no dropout)."""
        self._ensure_init()
        inputs, labels, imasks, lmasks = self._batch(ds)
        with torch.no_grad():
            loss, _ = self._loss(self.params, self._inference_state(),
                                 inputs, labels, None, lmasks, imasks)
        return float(loss)

    def compute_gradient_and_score(self, ds):
        """({vertex: {param: f32 gradient}}, score) without updating."""
        self._ensure_init()
        inputs, labels, imasks, lmasks = self._batch(ds)
        score, _, grads = self._value_and_grad(
            self._inference_state(), inputs, labels, None, lmasks, imasks)
        return grads, float(score)
