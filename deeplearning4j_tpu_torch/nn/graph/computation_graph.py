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
back to the host; ``score_value`` stays a device tensor.

Layer state (batch norm's running mean and variance) lives on the
device in ``state[vertex]``; a train step replaces it with the detached
new statistics, and inference reads it. In training the cached fusion
plan (``fusion.py``) runs each BN → add → act residual tail as one
``batchnorm_add_act_train`` helper call, on the card the fused Hopper
kernel; the other batch norms take the ``batchnorm_train`` kernel.

Truncated BPTT (:meth:`_fit_tbptt`) runs where the JAX graph runs it: a
``truncated_bptt`` configuration with ``tbptt_fwd_length`` > 0 and a 3-D
input; it makes one update per time window and carries only the recurrent
vertices' (h, c), detached, into the next window. Every update calls the
listeners' ``iteration_done``. Each update is a ``dl4j.fit`` span holding
its ``input``, ``forward``, ``backward``, ``update`` and ``listeners``
phases (``observability/tracing.py::phase``; under truncated BPTT the
batch's one ``dl4j.fit.input`` comes before its windows' updates).
:meth:`rnn_time_step` keeps the recurrent
carry between calls. :meth:`pretrain` / :meth:`pretrain_layer` train the
pretrainable layer vertices (autoencoder, RBM, VAE) on the
inference-mode features of the vertices their input depends on.
Evaluation (:meth:`do_evaluation` and the ``evaluate*`` methods) brings
each output head to the host once a batch through
``ops/transfer.py::device_fetch`` (tag ``graph.eval``)."""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from ...datasets.iterators import as_iterator
from ...eval.evaluation import Evaluation
from ...eval.regression import RegressionEvaluation
from ...eval.roc import ROC, ROCMultiClass
from ...observability.tracing import phase
from ...ops import rng as rngmod
from ...ops.dataset import DataSet, MultiDataSet
from ...ops.losses import reduce_terms
from ...ops.platform import resolve_device, state_on
from ...ops.transfer import device_fetch, host_tensor, stage_to_device
from ...ops.updaters import make_updater, normalize_gradient, schedule_lr
from ...kernels.fused_ce import (_MCXENT_LOSSES, fused_sparse_ce_terms,
                                 sparse_shaped)
from ..conf.layers import OutputLayer
from ..conf.layers.convolution import detached_running_update
from ..helpers import get_helper
from ..multilayer import (_clone_tree, _host, _pretrain_step, _to_numpy,
                          drive, format_summary_table)
from .fusion import build_fusion_plan
from .graph_config import ComputationGraphConfiguration, with_ancestors
from .vertices import LayerVertex


_CARRY = ("h", "c")


def _nz(value, default):
    """None-aware default (0.0 is a real value — e.g. a frozen lr)."""
    return default if value is None else value


def _strip_rnn_carry(states):
    """States without the transient recurrent (h, c): each minibatch, and
    every inference call but ``rnn_time_step``, starts from zeros."""
    return {name: {k: v for k, v in s.items() if k not in _CARRY}
            for name, s in states.items()}


def _detached(states):
    return {name: {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in st.items()}
            for name, st in states.items()}


def _carries(states):
    """The recurrent vertices' (h, c), detached."""
    return {name: {k: v.detach() for k, v in s.items() if k in _CARRY}
            for name, s in states.items() if any(k in s for k in _CARRY)}


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
        self.listeners: List = []
        self._rnn_state: Optional[Dict[str, Dict]] = None
        self._initialized = False
        self._fusion = None

    # ------------------------------------------------------------------ init
    def init(self) -> "ComputationGraph":
        """Seeded initialization on the net's device: one generator per
        vertex, folded from the configuration seed and the vertex's
        topological index; then the updaters and their zero state.
        Masters are f32 (f64 under an f64 compute dtype)."""
        storage = torch.float64 if self.compute_dtype == torch.float64 \
            else torch.float32
        base = rngmod.for_purpose(self.conf.seed, "init")
        self.params, self.state = {}, {}
        for idx, name in enumerate(self.conf.topological_order):
            v = self.conf.vertices[name]
            gen = rngmod.generator(rngmod.fold_in(base, idx), self.device)
            self.params[name] = v.init_params(gen, storage)
            self.state[name] = state_on(v.init_state(), self.device)
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

    # ---------------------------------------------------------------- fusion
    def _get_fusion_plan(self):
        """The cached cross-vertex fusion plan (``fusion.py``); training
        path only."""
        if self._fusion is None:
            self._fusion = build_fusion_plan(self.conf, self.device)
        return self._fusion

    def _forward_fused(self, fu, params, state, acts, masks, new_state):
        """One BN → add → act tail. The plain vertex walk runs instead where
        a mask reaches the tail or no helper is registered."""
        x = acts[fu.bn_input]
        res = acts[fu.res_input]
        bn = self.conf.vertices[fu.bn_name].layer
        helper = get_helper("batchnorm_add_act_train", x.device)
        if helper is not None and masks.get(fu.bn_input) is None and \
                masks.get(fu.res_input) is None:
            y, mean, var = helper(x, params[fu.bn_name]["gamma"],
                                  params[fu.bn_name]["beta"],
                                  state[fu.bn_name]["mean"], res, bn.eps,
                                  fu.activation)
            new_state[fu.bn_name] = detached_running_update(
                bn.decay, state[fu.bn_name], mean, var)
            masks[fu.act_name] = None
        else:
            y, nstate = bn.forward(params[fu.bn_name], state[fu.bn_name], x,
                                   masks.get(fu.bn_input), train=True)
            y = y + res
            if fu.activation == "relu":
                y = torch.clamp_min(y, 0)
            new_state[fu.bn_name] = nstate
            # the plain walk's masks: the add propagates its first input's
            # mask and the activation inherits it; the skipped BN vertex
            # would have passed on its own input's
            first_in = self.conf.vertex_inputs[fu.add_name][0]
            masks[fu.act_name] = masks.get(fu.bn_input) \
                if first_in == fu.bn_name else masks.get(first_in)
        acts[fu.act_name] = y
        new_state[fu.act_name] = state[fu.act_name]

    # --------------------------------------------------------------- forward
    def _forward(self, *args, **kwargs):
        """:meth:`_forward_walk` run to its end (no cross-shard vertex)."""
        return drive(self._forward_walk(*args, **kwargs))

    def _forward_walk(self, params, state, inputs: Dict[str, torch.Tensor],
                      *, train: bool = False, rng: Optional[int] = None,
                      input_masks: Optional[Dict] = None,
                      output_preout: bool = False, skip_preoutput=(),
                      initial_rnn: Optional[Dict] = None, only=None,
                      cross=()):
        """Walk the topological order. Returns (activations, new_state,
        reg, masks, last_inputs, preouts). ``rng`` is the step's dropout
        seed: a vertex that draws dropout gets a generator seeded with
        ``for_layer(rng, index)``. Each vertex's mask is its first input's.
        With ``output_preout``, output vertices record their input
        (``last_inputs``) and pre-activation (``preouts``, which their loss
        scores); those in ``skip_preoutput`` are projected inside the loss
        (fused CE), so their [.., n_out] pre-activation is never built. In
        training the fusion plan's tails run fused at their activation
        vertex and their BN and add vertices are skipped. ``initial_rnn``:
        per-vertex (h, c) carries (truncated BPTT, ``rnn_time_step``); a
        non-empty entry replaces that vertex's state. ``only``: the set of
        vertices to run (the rest are skipped).

        A generator (``parallel/sharded.py`` walks one a shard, vertex by
        vertex): it yields None after each vertex, and at a vertex named
        in ``cross`` it yields a request instead of computing it —
        ``("layer", layer, params, state, x, mask, gen)``, or
        ``("bn_add_act", bn layer, params, state, x, res, activation)``
        for a fused tail — and takes (activation, new state) back."""
        acts: Dict[str, torch.Tensor] = dict(inputs)
        masks: Dict[str, Optional[torch.Tensor]] = dict(input_masks or {})
        new_state: Dict[str, Dict] = {}
        last_inputs: Dict[str, torch.Tensor] = {}
        preouts: Dict[str, torch.Tensor] = {}
        reg = 0.0
        out_set = set(self.conf.network_outputs) if output_preout else set()
        fusion_plan, fusion_skip = self._get_fusion_plan() if train \
            else ({}, set())
        for idx, name in enumerate(self.conf.topological_order):
            if only is not None and name not in only:
                continue
            if name in fusion_skip:
                new_state.setdefault(name, state[name])
                continue
            if name in fusion_plan:
                fu = fusion_plan[name]
                if name in cross:
                    acts[name], new_state[fu.bn_name] = yield (
                        "bn_add_act", self.conf.vertices[fu.bn_name].layer,
                        params[fu.bn_name], state[fu.bn_name],
                        acts[fu.bn_input], acts[fu.res_input],
                        fu.activation)
                    masks[name] = None
                    new_state[name] = state[name]
                else:
                    self._forward_fused(fu, params, state, acts, masks,
                                        new_state)
                yield None
                continue
            v = self.conf.vertices[name]
            vstate = state[name]
            if initial_rnn and initial_rnn.get(name):
                vstate = initial_rnn[name]
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
                x, m = xs[0], ms[0]
                if v.preprocessor is not None:
                    x = v.preprocessor.pre_process(x, m)
                    m = v.preprocessor.feed_forward_mask(m)
                x = layer.maybe_dropout(x, train=train, gen=gen)
                last_inputs[name] = x
                masks[name] = m
                new_state[name] = vstate
                if name not in skip_preoutput:   # else fused into the loss
                    preouts[name] = layer.preoutput(params[name], x)
                    acts[name] = layer.activation_fn()(preouts[name])
            elif name in cross:
                x, m = xs[0], ms[0]
                if v.preprocessor is not None:
                    x = v.preprocessor.pre_process(x, m)
                    m = v.preprocessor.feed_forward_mask(m)
                acts[name], new_state[name] = yield (
                    "layer", layer, params[name], vstate, x, m, gen)
                masks[name] = ms[0] if ms else None
            else:
                acts[name], new_state[name] = v.forward(
                    params[name], vstate, xs, train=train, gen=gen,
                    masks=ms)
                masks[name] = ms[0] if ms else None
            yield None
        return acts, new_state, reg, masks, last_inputs, preouts

    def _to_device_dtype(self, a) -> torch.Tensor:
        """compute_dtype for floats; integer inputs (token ids, class ids)
        keep an integer dtype — casting ids through bf16 would corrupt
        every id >= 257. A host batch bound for the card is staged
        (``ops.transfer.stage_to_device``)."""
        t = host_tensor(a)
        return stage_to_device(t, self.device, self.compute_dtype
                               if t.dtype.is_floating_point else torch.long)

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
        """Per-vertex state for inference: batch norm's running statistics
        stay, a recurrent carry (h, c) is dropped."""
        return _strip_rnn_carry(self.state)

    def _cast_params(self, params):
        """Mixed precision: a compute-dtype copy of the f32 master
        params (differentiable: gradients reach the masters in f32)."""
        cd = self.compute_dtype
        if cd in (torch.float32, torch.float64):
            return params
        return {v: {k: a.to(cd) if a.dtype == torch.float32 else a
                    for k, a in p.items()}
                for v, p in params.items()}

    @torch.no_grad()
    def _output_tensors(self, features) -> List[torch.Tensor]:
        """The inference forward: every network output as a device
        tensor (float32 where the compute dtype is bf16)."""
        self._ensure_init()
        acts, *_ = self._forward(self._cast_params(self.params),
                                 self._inference_state(),
                                 self._inputs_dict(features))
        out = [acts[o] for o in self.conf.network_outputs]
        return [o.float() if o.dtype == torch.bfloat16 else o for o in out]

    def output(self, *features) -> List[np.ndarray]:
        """Forward pass → list of output activations as float32 numpy
        arrays (one per network output)."""
        outs = self._output_tensors(features[0] if len(features) == 1
                                    else list(features))
        return [o.float().cpu().numpy() for o in outs]

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

    def _loss_terms(self, *args, **kwargs):
        """:meth:`_loss_terms_walk` run to its end."""
        return drive(self._loss_terms_walk(*args, **kwargs))

    def _loss_terms_walk(self, params, state, inputs, labels: Dict, rng,
                         label_masks: Optional[Dict] = None,
                         input_masks=None, initial_rnn=None, cross=()):
        """(terms, reg, new_state) on the compute-dtype cast of ``params``:
        one (summed loss, denominator unclamped) term per scoring output,
        in ``network_outputs`` order, and the l1/l2 penalty. A generator
        over the forward's vertices, as :meth:`_forward_walk`."""
        params = self._cast_params(params)
        fused_outs = self._fused_ce_outputs(labels)
        _, new_state, reg, masks, last_in, preouts = \
            yield from self._forward_walk(
                params, state, inputs, train=True, rng=rng,
                input_masks=input_masks, output_preout=True,
                skip_preoutput=fused_outs, initial_rnn=initial_rnn,
                cross=cross)
        terms = []
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
                terms.append(fused_sparse_ce_terms(params[out_name], x, y,
                                                   lmask))
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
            terms.append(v.layer.compute_score_terms(params[out_name], y,
                                                     pre, lmask))
        return terms, reg, new_state

    def _loss(self, params, state, inputs, labels: Dict, rng,
              label_masks: Optional[Dict] = None, input_masks=None,
              initial_rnn=None):
        """(score, new_state): the l1/l2 penalty plus each output's loss
        (:meth:`_loss_terms`, each over its denominator)."""
        terms, reg, new_state = self._loss_terms(
            params, state, inputs, labels, rng, label_masks, input_masks,
            initial_rnn)
        return reduce_terms(terms, start=reg), new_state

    def _masks_of(self, ds):
        """(input_masks, label_masks) dicts from a DataSet or MultiDataSet
        (host arrays or tensors), in the compute dtype on the device."""
        conv = lambda m: None if m is None else \
            stage_to_device(m, self.device, self.compute_dtype)
        if isinstance(ds, MultiDataSet):
            imasks = None if not ds.features_masks else \
                {n: conv(m) for n, m in zip(self.conf.network_inputs,
                                            ds.features_masks)}
            lmasks = None if not ds.labels_masks else \
                {n: conv(m) for n, m in zip(self.conf.network_outputs,
                                            ds.labels_masks)}
            return imasks, lmasks
        imasks = None if ds.features_mask is None else \
            {self.conf.network_inputs[0]: conv(ds.features_mask)}
        lmasks = None if ds.labels_mask is None else \
            {self.conf.network_outputs[0]: conv(ds.labels_mask)}
        return imasks, lmasks

    def _batch(self, ds):
        """(inputs, labels, input masks, label masks) of a DataSet or a
        MultiDataSet (whose lists follow the network's inputs and
        outputs)."""
        imasks, lmasks = self._masks_of(ds)
        features, labels = ds.features, ds.labels
        if isinstance(ds, MultiDataSet):
            features, labels = list(features), list(labels)
        return (self._inputs_dict(features), self._labels_dict(labels),
                imasks, lmasks)

    def _param_leaves(self):
        """Autograd leaves sharing the masters' storage."""
        return {name: {k: p.detach().requires_grad_(True)
                       for k, p in ps.items()}
                for name, ps in self.params.items()}

    @staticmethod
    def _grads_of(score, leaves):
        """{vertex: {param: gradient of ``score``}} over ``leaves``."""
        flat = [(name, k) for name, ps in leaves.items() for k in ps]
        with torch.enable_grad():
            grads = torch.autograd.grad(
                score, [leaves[n][k] for n, k in flat],
                materialize_grads=True) if flat else ()
        by_vertex: Dict[str, Dict[str, torch.Tensor]] = {
            name: {} for name in leaves}
        for (name, k), g in zip(flat, grads):
            by_vertex[name][k] = g
        return by_vertex

    def _value_and_grad(self, state, inputs, labels, rng, lmasks, imasks,
                        initial_rnn=None):
        """(score, new_state, {vertex: {param: gradient}}) of the loss over
        the f32 masters, the new state detached. The autograd leaves share
        the masters' storage, so an update may write the masters in place
        once this returns."""
        with phase("fit.forward"), torch.enable_grad():
            leaves = self._param_leaves()
            score, new_state = self._loss(leaves, state, inputs, labels,
                                          rng, lmasks, imasks, initial_rnn)
        with phase("fit.backward"):
            by_vertex = self._grads_of(score, leaves)
        return score.detach(), _detached(new_state), by_vertex

    def _dropout_rng(self) -> int:
        """The step's dropout seed (per iteration)."""
        return rngmod.for_iteration(
            rngmod.for_purpose(self.conf.seed, "dropout"), self.iteration)

    def _train_step(self, inputs, labels, imasks, lmasks, initial_rnn=None):
        """One update of every parameter in place; returns (the score as a
        0-d device tensor, the new state with its recurrent carry)."""
        score, new_state, by_vertex = self._value_and_grad(
            self.state, inputs, labels, self._dropout_rng(), lmasks, imasks,
            initial_rnn)
        self._apply_gradients(by_vertex)
        return score, new_state

    @torch.no_grad()
    def _apply_gradients(self, by_vertex):
        """Per vertex: the gradient normalization, the scheduled learning
        rate and the update rule, applied to the masters in place (solo
        and data-parallel training alike)."""
        with phase("fit.update"):
            conf = self.conf
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

    @staticmethod
    def _strip_rnn_carry(states):
        return _strip_rnn_carry(states)

    def _after_step(self, score, new_state):
        self.state = _strip_rnn_carry(new_state)
        self.score_value = score        # a device tensor until read
        self.iteration += 1
        with phase("fit.listeners"):
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration)

    def fit_batch(self, ds):
        """One train step on a DataSet or MultiDataSet (truncated BPTT
        where the configuration asks for it and an input is 3-D).
        ``score_value`` becomes the step's loss as a device tensor (no
        host sync)."""
        self._ensure_init()
        self.last_input_batch = ds
        if not (self.conf.backprop_type == "truncated_bptt" and
                (self.conf.tbptt_fwd_length or 0) > 0):
            with phase("fit", self.iteration):
                with phase("fit.input"):
                    batch = self._batch(ds)
                self._after_step(*self._train_step(*batch))
            return
        with phase("fit.input"):
            batch = self._batch(ds)
        if any(v.dim() == 3 for v in batch[0].values()):
            self._fit_tbptt(*batch)
            return
        with phase("fit", self.iteration):
            self._after_step(*self._train_step(*batch))

    @staticmethod
    def _slice_time(d: Optional[Dict], start: int, end: int,
                    min_ndim: int = 3) -> Optional[Dict]:
        """Every time-distributed tensor of a name → tensor dict cut to
        [start, end) along axis 1: masks are [N, T] (``min_ndim`` 2),
        features and labels [N, T, C]."""
        if d is None:
            return None
        return {k: (v if v is None or v.dim() < min_ndim else
                    v[:, start:end])
                for k, v in d.items()}

    def _fit_tbptt(self, inputs, labels, imasks, lmasks):
        """Truncated BPTT: one update per window of ``tbptt_fwd_length``
        steps, only the recurrent vertices' (h, c) carried (detached) from
        each window into the next."""
        t_total = max(v.shape[1] for v in inputs.values() if v.dim() == 3)
        window = self.conf.tbptt_fwd_length
        carry: Dict[str, Dict] = {}
        for start in range(0, t_total, window):
            end = min(start + window, t_total)
            # [N, T] integer class ids are time-distributed too; an [N, 1]
            # column on a feedforward head passes whole
            sliced = {k: (v if v is None else v[:, start:end]
                          if v.dim() >= 3 or (
                              v.dim() == 2 and
                              not v.dtype.is_floating_point and
                              v.shape[1] == t_total) else v)
                      for k, v in labels.items()}
            with phase("fit", self.iteration):
                score, new_state = self._train_step(
                    self._slice_time(inputs, start, end), sliced,
                    self._slice_time(imasks, start, end, min_ndim=2),
                    self._slice_time(lmasks, start, end, min_ndim=2), carry)
                carry = _carries(new_state)
                self._after_step(score, new_state)

    def fit(self, data, num_epochs: int = 1):
        """Train on a DataSet or MultiDataSet, or a list or iterator of
        them (an iterator with ``reset`` is reset after each epoch)."""
        self._ensure_init()
        if isinstance(data, (DataSet, MultiDataSet)):
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

    # -------------------------------------------------------------- pretrain
    def pretrain(self, data, num_epochs: int = 1):
        """Greedy layerwise unsupervised pretraining of every pretrainable
        layer vertex (AutoEncoder, RBM, VAE), in topological order."""
        self._ensure_init()
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            if isinstance(v, LayerVertex) and \
                    hasattr(v.layer, "pretrain_loss"):
                self.pretrain_layer(name, data, num_epochs)
        return self

    def pretrain_layer(self, layer_name: str, data, num_epochs: int = 1):
        """Unsupervised pretraining of one layer vertex: each batch's
        features run in inference mode through the vertices its input
        depends on (on the compute-dtype cast of the masters), then the
        layer's preprocessor, and the layer takes one update of its
        ``pretrain_loss`` on its f32 masters at its learning rate; noise is
        drawn from a generator seeded per vertex and iteration.
        ``score_value`` is the last batch's loss, a device tensor."""
        self._ensure_init()
        v = self.conf.vertices.get(layer_name)
        if v is None:
            raise ValueError(f"Unknown vertex '{layer_name}'")
        if not (isinstance(v, LayerVertex) and
                hasattr(v.layer, "pretrain_loss")):
            raise ValueError(
                f"Vertex '{layer_name}' is not pretrainable (needs an "
                "AutoEncoder/RBM/VariationalAutoencoder layer)")
        in_name = self.conf.vertex_inputs[layer_name][0]
        needed = with_ancestors(self.conf.vertex_inputs[layer_name],
                                self.conf.vertex_inputs,
                                self.conf.network_inputs)
        lr = _nz(v.layer.learning_rate, 0.1)
        base = rngmod.for_purpose(self.conf.seed, f"pretrain-{layer_name}")
        for _ in range(num_epochs):
            for ds in as_iterator(data):
                features = list(ds.features) \
                    if isinstance(ds, MultiDataSet) else ds.features
                with torch.no_grad():
                    acts, *_ = self._forward(
                        self._cast_params(self.params),
                        self._inference_state(),
                        self._inputs_dict(features), only=needed)
                    act = acts[in_name]
                    if v.preprocessor is not None:
                        act = v.preprocessor.pre_process(act, None)
                gen = rngmod.generator(
                    rngmod.for_iteration(base, self.iteration), self.device)
                self.score_value = _pretrain_step(
                    v.layer, self.params[layer_name],
                    self.updaters[layer_name],
                    self.updater_state[layer_name], act, gen, lr,
                    self.iteration)
                self.iteration += 1
        return self

    # ------------------------------------------------------ rnn / stateful
    @torch.no_grad()
    def rnn_time_step(self, *features) -> List[np.ndarray]:
        """Stateful streaming inference: each input is [N, nIn] (one step)
        or [N, T, nIn]; every recurrent vertex continues from the (h, c)
        the previous call left, until :meth:`rnn_clear_previous_state`.
        Runs on the f32 masters, as the JAX graph does. Returns one numpy
        array per network output, time-squeezed when a recurrent input was
        a single step; one readback an output (tag
        ``graph.rnn_time_step``)."""
        self._ensure_init()
        inputs = self._inputs_dict(features[0] if len(features) == 1
                                   else list(features))
        # only recurrent inputs get the [N, nIn] -> [N, 1, nIn] expansion;
        # a genuinely 2-D static input stays 2-D
        rec_names = set(self.conf.network_inputs)
        if self.conf.input_types is not None:
            rec_names = {n for n, t in zip(self.conf.network_inputs,
                                           self.conf.input_types)
                         if getattr(t, "kind", None) == "rnn"}
        squeeze = any(v.dim() == 2 for k, v in inputs.items()
                      if k in rec_names)
        inputs = {k: (v[:, None, :] if v.dim() == 2 and k in rec_names
                      else v) for k, v in inputs.items()}
        if self._rnn_state is None:
            self._rnn_state = {}
        acts, new_state, *_ = self._forward(
            self.params, self._inference_state(), inputs,
            initial_rnn=self._rnn_state)
        self._rnn_state.update(_carries(new_state))
        outs = []
        for o in self.conf.network_outputs:
            a = acts[o]
            out = device_fetch(a.float() if a.dtype == torch.bfloat16
                               else a, "graph.rnn_time_step")
            outs.append(out[:, 0] if squeeze and out.ndim == 3 else out)
        return outs

    def rnn_clear_previous_state(self):
        """Forget the streaming (h, c): the next :meth:`rnn_time_step`
        starts from zeros."""
        self._rnn_state = None

    # ------------------------------------------------------------ evaluation
    def _eval_batch_parts(self, ds):
        """(labels list, label-mask list) aligned with network_outputs, as
        host numpy arrays, from a DataSet or MultiDataSet."""
        n_out = len(self.conf.network_outputs)
        if isinstance(ds, MultiDataSet):
            labels = list(ds.labels)
            lmasks = list(ds.labels_masks) if ds.labels_masks \
                else [None] * n_out
        else:
            labels = [ds.labels]
            lmasks = [ds.labels_mask]
        labels += [None] * (n_out - len(labels))
        lmasks += [None] * (n_out - len(lmasks))
        return [_host(l) for l in labels], [_host(m) for m in lmasks]

    def do_evaluation(self, data, evaluations: Dict):
        """Accumulate per-output evaluations (Evaluation /
        RegressionEvaluation / ROC family), ``{output name: evaluation}``,
        over a DataSet, MultiDataSet, list or iterator: one inference
        forward a batch feeds every output's evaluation, and each output
        head comes to the host once a batch (tag ``graph.eval``)."""
        self._ensure_init()
        out_names = self.conf.network_outputs
        for ds in as_iterator(data):
            features = list(ds.features) if isinstance(ds, MultiDataSet) \
                else ds.features
            outs = [device_fetch(o, tag="graph.eval")
                    for o in self._output_tensors(features)]
            labels, lmasks = self._eval_batch_parts(ds)
            for i, name in enumerate(out_names):
                ev = evaluations.get(name)
                if ev is None or labels[i] is None:
                    continue
                ev.eval(labels[i], outs[i], mask=lmasks[i])
        return evaluations

    def evaluate_outputs(self, data) -> Dict[str, Evaluation]:
        """Classification evaluation of every output head → {output name:
        Evaluation}."""
        evs = {name: Evaluation() for name in self.conf.network_outputs}
        return self.do_evaluation(data, evs)

    def evaluate(self, data, labels_list=None, top_n: int = 1):
        """Classification evaluation of the first output head against the
        first labels array (every head: :meth:`evaluate_outputs`)."""
        first = self.conf.network_outputs[0]
        return self.do_evaluation(
            data, {first: Evaluation(labels=labels_list,
                                     top_n=top_n)})[first]

    def evaluate_regression(self, data):
        """Regression evaluation of the first output head."""
        first = self.conf.network_outputs[0]
        return self.do_evaluation(
            data, {first: RegressionEvaluation()})[first]

    def evaluate_roc(self, data, threshold_steps: int = 0):
        """Binary ROC of the first output head."""
        first = self.conf.network_outputs[0]
        return self.do_evaluation(data, {first: ROC(threshold_steps)})[first]

    def evaluate_roc_multi_class(self, data, threshold_steps: int = 0):
        """One-vs-all ROC per class of the first output head."""
        first = self.conf.network_outputs[0]
        return self.do_evaluation(
            data, {first: ROCMultiClass(threshold_steps)})[first]

    # ----------------------------------------------------------- param utils
    def summary(self) -> str:
        """A printable table of the vertices and their parameter counts."""
        self._ensure_init()
        rows = [("vertex", "type", "inputs", "params")]
        total = 0
        for name in self.conf.topological_order:
            v = self.conf.vertices[name]
            n = sum(int(a.numel()) for a in self.params[name].values())
            total += n
            vtype = type(v.layer).__name__ if isinstance(v, LayerVertex) \
                else type(v).__name__
            rows.append((name, vtype,
                         ",".join(self.conf.vertex_inputs[name]), f"{n:,}"))
        return format_summary_table(rows, total)

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def params_flat(self) -> np.ndarray:
        """Every parameter in one vector, vertices in topological order,
        then names ascending (the JAX graph's order)."""
        self._ensure_init()
        parts = [_to_numpy(a).reshape(-1)
                 for name in self.conf.topological_order
                 for _, a in sorted(self.params[name].items())]
        return np.concatenate(parts) if parts else np.zeros(0, np.float32)

    def set_params_flat(self, flat: np.ndarray):
        """Write :meth:`params_flat`'s vector back into the parameters."""
        self._ensure_init()
        offset = 0
        with torch.no_grad():
            for name in self.conf.topological_order:
                p = self.params[name]
                for k in sorted(p):
                    size = p[k].numel()
                    part = np.asarray(flat[offset:offset + size])
                    p[k].copy_(torch.from_numpy(part).reshape(p[k].shape))
                    offset += size

    def clone(self) -> "ComputationGraph":
        """An independent copy: the configuration, parameters, layer and
        updater state and iteration, in new tensors on the same device."""
        self._ensure_init()
        net = ComputationGraph(copy.deepcopy(self.conf), self.compute_dtype,
                               self.device).init()
        net.params = _clone_tree(self.params)
        net.state = _clone_tree(self.state)
        net.updater_state = _clone_tree(self.updater_state)
        net.iteration = self.iteration
        return net

