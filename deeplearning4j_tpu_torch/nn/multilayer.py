"""MultiLayerNetwork: the sequential-stack model (the JAX package's
``nn/multilayer.py``), inference and training.

Parameters are f32 masters in ``params[layer][name]`` on ``device``; a
bf16 ``compute_dtype`` runs the training forward on a cast copy
(:meth:`_cast_params`), and gradients flow back through the cast to the
masters. ``device=None`` means the CUDA card and raises when there is
none — tests and CPU references pass ``device="cpu"``.

A train step (:meth:`_fit_batch`) is the loss of the batch (dropout drawn
from generators seeded per iteration and layer; integer class ids on a
softmax + mcxent head through the fused sparse cross-entropy, any other
labels through the head's ``compute_score``), ``torch.autograd.grad``
over the masters, then per layer the gradient normalization, the
scheduled learning rate and the JAX package's update rule, applied to the
masters in place. ``score_value`` stays a device tensor. Truncated BPTT
(:meth:`_fit_tbptt`) makes one such update per time window and carries the
recurrent layers' (h, c), detached, into the next window. Updates trace as
``ComputationGraph``'s do: a ``dl4j.fit`` span each, holding its
``input``, ``forward``, ``backward``, ``update`` and ``listeners`` phases
(``observability/tracing.py::phase``; under truncated BPTT the batch's
one ``dl4j.fit.input`` comes before its windows' updates).

Inference (``output``, ``feed_forward``, ``rnn_time_step``) runs on the
f32 masters, as the JAX package does (a bf16 input promotes to f32
there). ``rnn_time_step`` keeps each recurrent layer's (h, c) between
calls until :meth:`rnn_clear_previous_state`, and reads its result back
once per call. Evaluation (:meth:`do_evaluation` and the ``evaluate*``
methods) brings the output to the host once a batch through
``ops/transfer.py::device_fetch`` (tag ``multilayer.eval``).

``fit`` pulls its batches through :class:`AsyncDataSetIterator`, which
copies the next batch to the device on a producer thread. A
``CenterLossOutputLayer`` head adds its center loss to the score, and its
class centers move in the layer state, not by gradient. :meth:`pretrain`
trains each layer that has a ``pretrain_loss`` (autoencoder, RBM, VAE)
greedily, bottom up, on the features of the layers below it."""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch

from ..datasets.iterators import AsyncDataSetIterator, as_iterator
from ..eval.evaluation import Evaluation
from ..eval.regression import RegressionEvaluation
from ..eval.roc import ROC, ROCMultiClass
from ..observability.tracing import phase
from ..kernels.fused_ce import (_MCXENT_LOSSES, fused_sparse_ce_terms,
                                sparse_labels_eligible, sparse_shaped)
from ..ops import rng as rngmod
from ..ops.dataset import DataSet
from ..ops.losses import get_loss, reduce_terms
from ..ops.platform import resolve_device, state_on
from ..ops.transfer import device_fetch, host_tensor, stage_to_device
from ..ops.updaters import make_updater, normalize_gradient, schedule_lr
from .conf.config import MultiLayerConfiguration
from .conf.layers.base import BaseRecurrentLayerConf
from .conf.layers.feedforward import CenterLossOutputLayer

_BIAS_PARAMS = ("b", "vb", "mub", "ob")
_CARRY = ("h", "c")


def drive(walk):
    """Run a forward walk (a generator that yields None after each layer or
    vertex, see ``parallel/sharded.py``) to its end; its return value."""
    try:
        while True:
            if next(walk) is not None:
                raise RuntimeError("a cross-shard request outside a "
                                   "sharded walk")
    except StopIteration as stop:
        return stop.value


def _nz(value, default):
    """None-aware default (0.0 is a real value — e.g. a frozen lr)."""
    return default if value is None else value


def format_summary_table(rows, total: int) -> str:
    """Header + rows → aligned table and a total line."""
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    lines = ["  ".join(v.ljust(w) for v, w in zip(r, widths)) for r in rows]
    lines.append(f"Total params: {total:,}")
    return "\n".join(lines)


def _strip_carry(states):
    """States without the transient recurrent (h, c): each minibatch, and
    every inference call but ``rnn_time_step``, starts from zeros."""
    return [{k: v for k, v in s.items() if k not in _CARRY} for s in states]


def _detached(states):
    return [{k: v.detach() if torch.is_tensor(v) else v
             for k, v in s.items()} for s in states]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, compute_dtype=None,
                 device=None):
        self.conf = conf
        self.layers = conf.layers
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or torch.float32
        self.params: List[Dict[str, torch.Tensor]] = []
        self.state: List[Dict] = []
        self.updaters: List = []
        self.updater_state: List[Dict] = []
        self.iteration = 0
        self.epoch = 0
        self.listeners: List = []
        self.score_value = float("nan")
        self._rnn_state: Optional[List[Dict]] = None
        self._initialized = False

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[List[Dict]] = None) -> "MultiLayerNetwork":
        """Seeded initialization (one generator per layer, folded from the
        configuration seed and the layer index) or the given per-layer
        parameters; then the updaters and their zero state. Masters are
        f32 (f64 under an f64 compute dtype)."""
        storage = torch.float64 if self.compute_dtype == torch.float64 \
            else torch.float32
        base = rngmod.for_purpose(self.conf.seed, "init")
        self.params, self.state = [], []
        for i, layer in enumerate(self.layers):
            if params is None:
                gen = rngmod.generator(rngmod.for_layer(base, i), self.device)
                p = layer.init_params(gen, storage)
            else:
                p = {k: torch.as_tensor(a).to(self.device, storage)
                     for k, a in params[i].items()}
            self.params.append(p)
            self.state.append(state_on(layer.init_state(), self.device))
        self.init_updaters()
        self._initialized = True
        return self

    def init_updaters(self) -> None:
        """Per-layer update rules from each layer's configuration, and their
        zero state for the current parameters."""
        self.updaters, self.updater_state = [], []
        for layer, p in zip(self.layers, self.params):
            upd = make_updater(
                layer.updater or "sgd",
                momentum=_nz(layer.momentum, 0.9),
                adam_mean_decay=_nz(layer.adam_mean_decay, 0.9),
                adam_var_decay=_nz(layer.adam_var_decay, 0.999),
                rho=_nz(layer.rho, 0.95), rms_decay=_nz(layer.rms_decay, 0.95),
                epsilon=_nz(layer.epsilon, 1e-8))
            self.updaters.append(upd)
            self.updater_state.append({k: upd.init(v) for k, v in p.items()})

    def _ensure_init(self):
        if not self._initialized:
            self.init()

    # --------------------------------------------------------------- forward
    def _forward(self, *args, **kwargs):
        """:meth:`_forward_walk` run to its end."""
        return drive(self._forward_walk(*args, **kwargs))

    def _forward_walk(self, params, state, x, *, train, rng, fmask=None,
                      initial_rnn=None, last_preoutput=False,
                      skip_last_preoutput=False, cross=()):
        """Run the stack: (activation, new_states, reg). ``initial_rnn``:
        per-layer (h, c) carries (truncated BPTT). With ``last_preoutput``
        stop before the output layer's activation and return (preoutput,
        new_states, reg, its input, its mask); ``skip_last_preoutput``
        skips the projection too (it runs inside the fused sparse CE).

        A generator: it yields None after each layer, and for a layer
        index in ``cross`` it yields ``("layer", layer, params, state, x,
        mask, gen)`` and takes (activation, new state) back (the sharded
        walk of ``parallel/sharded.py``); for the output layer's index
        under ``last_preoutput``, ``("preoutput", layer, params, x)`` (x
        dropped out already), taking the preoutput back."""
        new_states = []
        reg = 0.0
        act, mask = x, fmask
        n_layers = len(self.layers)
        for i in range(n_layers):
            layer = self.layers[i]
            pp = self.conf.preprocessor_for(i)
            if pp is not None:
                act = pp.pre_process(act, mask)
                mask = pp.feed_forward_mask(mask)
            gen = None
            if train and rng is not None and layer.uses_dropout():
                gen = rngmod.generator(rngmod.for_layer(rng, i), self.device)
            lstate = state[i]
            if initial_rnn is not None and initial_rnn[i]:
                lstate = initial_rnn[i]
            reg = reg + layer.reg_penalty(params[i])
            if last_preoutput and i == n_layers - 1 and \
                    hasattr(layer, "preoutput"):
                act = layer.maybe_dropout(act, train=train, gen=gen)
                new_states.append(lstate)
                if skip_last_preoutput:
                    return None, new_states, reg, act, mask
                if i in cross:
                    pre = yield ("preoutput", layer, params[i], act)
                else:
                    pre = layer.preoutput(params[i], act)
                return pre, new_states, reg, act, mask
            if i in cross:
                act, nstate = yield ("layer", layer, params[i], lstate, act,
                                     mask, gen)
            else:
                act, nstate = layer.forward(params[i], lstate, act, mask,
                                            train=train, gen=gen)
            new_states.append(nstate)
            yield None
        if last_preoutput:
            return act, new_states, reg, act, mask
        return act, new_states, reg

    def _inference_state(self):
        return _strip_carry(self.state)

    def _as_tensor(self, a, dtype=None) -> torch.Tensor:
        """A host array or tensor on the net's device: floats in ``dtype``
        (the compute dtype by default); integer ids stay integers (a bf16
        round trip corrupts ids >= 257). A host batch bound for the card is
        staged (``ops.transfer.stage_to_device``)."""
        t = host_tensor(a)
        if t.dtype.is_floating_point:
            dtype = dtype or self.compute_dtype
        elif t.dtype != torch.bool:
            dtype = torch.long
        return stage_to_device(t, self.device, dtype)

    def _batch(self, ds: DataSet):
        mask = lambda m: None if m is None else self._as_tensor(m)
        labels = None if ds.labels is None else self._as_tensor(ds.labels)
        return (self._as_tensor(ds.features), labels,
                mask(ds.features_mask), mask(ds.labels_mask))

    def _cast_params(self, params):
        """Mixed precision: a compute-dtype copy of the f32 masters
        (differentiable: gradients reach the masters in f32)."""
        cd = self.compute_dtype
        if cd in (torch.float32, torch.float64):
            return params
        return [{k: a.to(cd) if a.dtype == torch.float32 else a
                 for k, a in p.items()} for p in params]

    @torch.no_grad()
    def _output_tensor(self, x) -> torch.Tensor:
        """The inference forward on the device (float32 for a bf16
        result, which numpy cannot hold)."""
        self._ensure_init()
        y, _, _ = self._forward(self.params, self._inference_state(),
                                self._as_tensor(x), train=False, rng=None)
        return y.float() if y.dtype == torch.bfloat16 else y

    def output(self, x, train: bool = False) -> np.ndarray:
        """The full forward pass as a numpy array (float32 for a bf16
        result, which numpy cannot hold)."""
        return _to_numpy(self._output_tensor(x))

    @torch.no_grad()
    def feed_forward(self, x, train: bool = False) -> List[np.ndarray]:
        """The input and every layer's activation, as numpy arrays."""
        self._ensure_init()
        act = self._as_tensor(x)
        outs = [_to_numpy(act)]
        states = self._inference_state()
        for i, layer in enumerate(self.layers):
            pp = self.conf.preprocessor_for(i)
            if pp is not None:
                act = pp.pre_process(act, None)
            act, _ = layer.forward(self.params[i], states[i], act)
            outs.append(_to_numpy(act))
        return outs

    def predict(self, x) -> np.ndarray:
        """The argmax class per example (per timestep for sequences)."""
        return np.argmax(self.output(x), axis=-1)

    # -------------------------------------------------------------- training
    def _output_layer(self):
        last = self.layers[-1]
        if not hasattr(last, "compute_score"):
            raise ValueError("Last layer has no loss (need an Output layer)")
        return last

    def _loss_terms(self, *args, **kwargs):
        """:meth:`_loss_terms_walk` run to its end."""
        return drive(self._loss_terms_walk(*args, **kwargs))

    def _loss_terms_walk(self, params, state, feats, labels, fmask, lmask,
                         rng, initial_rnn=None, cross=()):
        """(terms, reg, new_states) on the compute-dtype cast of
        ``params``: ``terms`` holds the head's (summed loss, denominator
        unclamped) and, for a center-loss head, (its center loss, None);
        the moved centers are the head's new state. ``reg`` is the l1 /
        l2 penalty. A generator over the layers, as :meth:`_forward_walk`;
        with ``"center"`` in ``cross`` the center loss is a request too,
        ``("center_loss", head, state, features, labels)``."""
        params = self._cast_params(params)
        out_layer = self._output_layer()
        fused = sparse_labels_eligible(out_layer, labels, params[-1])
        pre, new_states, reg, last_in, out_mask = \
            yield from self._forward_walk(
                params, state, feats, train=True, rng=rng, fmask=fmask,
                initial_rnn=initial_rnn, last_preoutput=True,
                skip_last_preoutput=fused, cross=cross)
        if fused:
            mask = lmask if lmask is not None else \
                (out_mask if last_in.dim() == 3 else None)
            terms = [fused_sparse_ce_terms(params[-1], last_in, labels,
                                           mask)]
        else:
            if sparse_shaped(out_layer, labels) and \
                    str(getattr(out_layer, "loss", "")).lower() in \
                    _MCXENT_LOSSES:
                raise ValueError(
                    "the output layer got integer class-id labels but is "
                    "not fused-CE eligible (sparse labels need a plain "
                    "softmax Output/RnnOutput head). Pass one-hot labels "
                    "here.")
            mask = lmask if lmask is not None else \
                (out_mask if pre.dim() == 3 else None)
            terms = [out_layer.compute_score_terms(params[-1], labels, pre,
                                                   mask)]
        if isinstance(out_layer, CenterLossOutputLayer):
            if "center" in cross:
                closs, centers = yield ("center_loss", out_layer, state[-1],
                                        last_in, labels)
            else:
                closs, centers = out_layer.center_loss_and_update(
                    state[-1], last_in, labels)
            terms.append((closs, None))
            new_states = new_states[:-1] + [centers]
        return terms, reg, new_states

    def _loss_fn(self, params, state, feats, labels, fmask, lmask, rng,
                 initial_rnn=None):
        """(score, new_states): :meth:`_loss_terms` each divided by its
        denominator, summed, plus the penalty."""
        terms, reg, new_states = self._loss_terms(
            params, state, feats, labels, fmask, lmask, rng, initial_rnn)
        return reduce_terms(terms) + reg, new_states

    def _param_leaves(self):
        """Autograd leaves sharing the masters' storage."""
        return [{k: p.detach().requires_grad_(True) for k, p in ps.items()}
                for ps in self.params]

    @staticmethod
    def _grads_of(score, leaves):
        """[{param: gradient of ``score``}] over ``leaves``."""
        flat = [(i, k) for i, ps in enumerate(leaves) for k in ps]
        with torch.enable_grad():
            grads = torch.autograd.grad(
                score, [leaves[i][k] for i, k in flat],
                materialize_grads=True) if flat else ()
        by_layer: List[Dict[str, torch.Tensor]] = [{} for _ in leaves]
        for (i, k), g in zip(flat, grads):
            by_layer[i][k] = g
        return by_layer

    def _value_and_grad(self, state, feats, labels, fmask, lmask, rng,
                        initial_rnn=None):
        """(score, new_states, [{param: gradient}]) of the loss over the
        f32 masters. The autograd leaves share the masters' storage, so an
        update may write the masters in place once this returns."""
        with phase("fit.forward"), torch.enable_grad():
            leaves = self._param_leaves()
            score, new_states = self._loss_fn(leaves, state, feats, labels,
                                              fmask, lmask, rng, initial_rnn)
        with phase("fit.backward"):
            grads = self._grads_of(score, leaves)
        return score.detach(), _detached(new_states), grads

    def _lr(self, base):
        c = self.conf
        return schedule_lr(base, c.lr_policy, self.iteration,
                           decay_rate=c.lr_policy_decay_rate,
                           steps=c.lr_policy_steps, power=c.lr_policy_power,
                           max_iterations=float(c.max_iterations or 1),
                           schedule=c.learning_rate_schedule)

    def _dropout_rng(self) -> int:
        """The step's dropout seed (per iteration)."""
        return rngmod.for_iteration(
            rngmod.for_purpose(self.conf.seed, "dropout"), self.iteration)

    def _train_step(self, feats, labels, fmask, lmask, initial_rnn=None):
        """One update of every parameter in place; returns (score as a 0-d
        device tensor, new states)."""
        score, new_states, grads = self._value_and_grad(
            self.state, feats, labels, fmask, lmask, self._dropout_rng(),
            initial_rnn)
        self._apply_gradients(grads)
        return score, new_states

    @torch.no_grad()
    def _apply_gradients(self, grads, params=None, updater_state=None,
                         normalize: bool = True):
        """Per layer: the gradient normalization, the scheduled learning
        rate and the update rule, applied to the masters in place (solo
        and data-parallel training alike). ``params`` / ``updater_state``
        (default the net's) are updated instead where given, as a tensor-
        parallel shard's slices are; ``normalize=False`` when the caller
        normalized the whole layer's gradient already."""
        with phase("fit.update"):
            params = self.params if params is None else params
            updater_state = self.updater_state if updater_state is None \
                else updater_state
            for i, (layer, g) in enumerate(zip(self.layers, grads)):
                if not g:
                    continue
                if normalize:
                    g = normalize_gradient(
                        g, layer.gradient_normalization,
                        _nz(layer.gradient_normalization_threshold, 1.0))
                lr = self._lr(_nz(layer.learning_rate, 0.1))
                upd = self.updaters[i]
                for name, grad in g.items():
                    use_lr = lr
                    if name in _BIAS_PARAMS and \
                            layer.bias_learning_rate is not None:
                        use_lr = self._lr(layer.bias_learning_rate)
                    step, ustate = upd.update(grad, updater_state[i][name],
                                              use_lr, float(self.iteration))
                    params[i][name].sub_(step)
                    updater_state[i][name] = ustate

    @staticmethod
    def _strip_rnn_carry(states):
        return _strip_carry(states)

    def _after_step(self, score, new_states):
        self.state = _strip_carry(new_states)
        self.score_value = score        # a device tensor until read
        self.iteration += 1
        with phase("fit.listeners"):
            for lst in self.listeners:
                lst.iteration_done(self, self.iteration)

    def fit(self, data, labels=None, num_epochs: int = 1):
        """Train on a DataSet, a list or iterator of them, or a features
        array with ``labels``; truncated BPTT for sequence batches when the
        configuration asks for it. Batches come through an
        :class:`AsyncDataSetIterator` onto the net's device."""
        self._ensure_init()
        if isinstance(labels, (int, np.integer)):
            num_epochs, labels = int(labels), None    # fit(data, epochs)
        if labels is not None:
            data = DataSet(np.asarray(data), np.asarray(labels))
        tbptt = self.conf.backprop_type == "truncated_bptt" and \
            (self.conf.tbptt_fwd_length or 0) > 0
        for _ in range(num_epochs):
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_start"):
                    lst.on_epoch_start(self)
            it = as_iterator(data)
            if getattr(it, "async_supported", True):
                it = AsyncDataSetIterator(it, device=self.device)
            for ds in it:
                if self.conf.pretrain:
                    raise ValueError("conf.pretrain=True: call "
                                     "pretrain(data)")
                if tbptt and ds.features.ndim == 3:
                    self._fit_tbptt(ds)
                else:
                    self._fit_batch(ds)
            self.epoch += 1
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self)
        return self

    def _fit_batch(self, ds: DataSet):
        """One train step on a whole minibatch, from zero recurrent
        state."""
        self._ensure_init()
        self.last_input_batch = ds
        with phase("fit", self.iteration):
            with phase("fit.input"):
                batch = self._batch(ds)
            self._after_step(*self._train_step(*batch))

    def _fit_tbptt(self, ds: DataSet):
        """Truncated BPTT: one update per window of ``tbptt_fwd_length``
        steps, the recurrent (h, c) carried (detached) across windows."""
        self._ensure_init()
        with phase("fit.input"):
            feats, labels, fmask, lmask = self._batch(ds)
        window = self.conf.tbptt_fwd_length
        cut = lambda a, s, e: None if a is None else a[:, s:e]
        carry = [{} for _ in self.layers]
        for start in range(0, feats.shape[1], window):
            end = start + window
            with phase("fit", self.iteration):
                score, new_states = self._train_step(
                    cut(feats, start, end), cut(labels, start, end),
                    cut(fmask, start, end), cut(lmask, start, end), carry)
                carry = [{k: v for k, v in st.items() if k in _CARRY}
                         if isinstance(layer, BaseRecurrentLayerConf) else {}
                         for layer, st in zip(self.layers, new_states)]
                self._after_step(score, new_states)

    # -------------------------------------------------------------- pretrain
    @torch.no_grad()
    def _featurize(self, upto: int, x) -> torch.Tensor:
        """``x`` through layers [0, upto) in inference mode on the f32
        masters, each after its preprocessor."""
        act = self._as_tensor(x)
        states = self._inference_state()
        for j in range(upto):
            pp = self.conf.preprocessor_for(j)
            if pp is not None:
                act = pp.pre_process(act)
            act, _ = self.layers[j].forward(self.params[j], states[j], act)
        return act

    def pretrain(self, data, num_epochs: int = 1):
        """Greedy layerwise unsupervised pretraining: bottom up, each layer
        with a ``pretrain_loss`` (AutoEncoder, RBM, VAE) takes one update a
        batch of its loss, on the f32 masters, over the inference-mode
        features of the layers below, with its own updater at its learning
        rate; noise is drawn from a generator seeded per layer and
        iteration. ``score_value`` is the last batch's loss, a device
        tensor."""
        self._ensure_init()
        for li, layer in enumerate(self.layers):
            if not hasattr(layer, "pretrain_loss"):
                continue
            lr = _nz(layer.learning_rate, 0.1)
            base = rngmod.for_purpose(self.conf.seed, f"pretrain{li}")
            for _ in range(num_epochs):
                for ds in as_iterator(data):
                    act = self._featurize(li, ds.features)
                    gen = rngmod.generator(
                        rngmod.for_iteration(base, self.iteration),
                        self.device)
                    self.score_value = _pretrain_step(
                        layer, self.params[li], self.updaters[li],
                        self.updater_state[li], act, gen, lr,
                        self.iteration)
                    self.iteration += 1
        return self

    # --------------------------------------------------------------- scoring
    def score(self, ds: DataSet, training: bool = False) -> float:
        """The loss of ``ds`` with the current parameters (no dropout)."""
        self._ensure_init()
        with torch.no_grad():
            loss, _ = self._loss_fn(self.params, self._inference_state(),
                                    *self._batch(ds), None)
        return float(loss)

    def compute_gradient_and_score(self, ds: DataSet):
        """([{param: f32 gradient}] per layer, score) without updating."""
        self._ensure_init()
        score, _, grads = self._value_and_grad(self._inference_state(),
                                               *self._batch(ds), None)
        return grads, float(score)

    # ------------------------------------------------------------ evaluation
    def evaluate(self, data, batch_size: int = 0):
        """Classification evaluation over a DataSet, list or iterator."""
        return self.do_evaluation(data, Evaluation())

    def do_evaluation(self, data, evaluation):
        """Accumulate any evaluation (Evaluation / RegressionEvaluation /
        ROC family) over the data: one inference forward a batch, its
        output brought to the host once (tag ``multilayer.eval``)."""
        for ds in as_iterator(data):
            out = device_fetch(self._output_tensor(ds.features),
                               "multilayer.eval")
            evaluation.eval(_host(ds.labels), out,
                            mask=_host(ds.labels_mask))
        return evaluation

    def evaluate_regression(self, data):
        return self.do_evaluation(data, RegressionEvaluation())

    def evaluate_roc(self, data, threshold_steps: int = 0):
        """Binary ROC on a 2-class or 1-unit output."""
        return self.do_evaluation(data, ROC(threshold_steps))

    def evaluate_roc_multi_class(self, data, threshold_steps: int = 0):
        """One-vs-all ROC per class."""
        return self.do_evaluation(data, ROCMultiClass(threshold_steps))

    @torch.no_grad()
    def score_examples(self, ds: DataSet,
                       add_regularization: bool = False) -> np.ndarray:
        """Per-example loss [N] (f64), the score each example contributes,
        with the l1 / l2 penalty added when ``add_regularization``; the
        inference forward on the compute-dtype cast of the masters."""
        self._ensure_init()
        feats, labels, fmask, lmask = self._batch(ds)
        out_layer = self._output_layer()
        pre, _, reg, _, out_mask = self._forward(
            self._cast_params(self.params), self._inference_state(), feats,
            train=False, rng=None, fmask=fmask, last_preoutput=True)
        mask = lmask if lmask is not None else \
            (out_mask if pre.dim() == 3 else None)
        per = get_loss(out_layer.loss)(labels, pre,
                                       out_layer.activation or "identity",
                                       mask)
        per = _to_numpy(per).astype(np.float64)
        if add_regularization:
            per = per + float(reg)
        return per

    # ------------------------------------------------------ rnn / stateful
    @torch.no_grad()
    def rnn_time_step(self, x) -> np.ndarray:
        """Stateful streaming inference: ``x`` is [N, nIn] (one step) or
        [N, T, nIn]; each recurrent layer continues from the (h, c) the
        previous call left, until :meth:`rnn_clear_previous_state`. One
        device→host readback per call (tag ``rnn_time_step``)."""
        self._ensure_init()
        act = self._as_tensor(x)
        squeeze = act.dim() == 2
        if squeeze:
            act = act[:, None, :]
        if self._rnn_state is None:
            self._rnn_state = [{} for _ in self.layers]
        states = self._inference_state()
        new_rnn = []
        for i, layer in enumerate(self.layers):
            pp = self.conf.preprocessor_for(i)
            if pp is not None:
                act = pp.pre_process(act)
            lstate = self._rnn_state[i] or states[i]
            act, nstate = layer.forward(self.params[i], lstate, act)
            new_rnn.append({k: v for k, v in nstate.items() if k in _CARRY}
                           if isinstance(layer, BaseRecurrentLayerConf)
                           else {})
        self._rnn_state = new_rnn
        if act.dtype == torch.bfloat16:
            act = act.float()
        out = device_fetch(act, "rnn_time_step")
        return out[:, 0] if squeeze and out.ndim == 3 else out

    def rnn_clear_previous_state(self):
        self._rnn_state = None

    # ----------------------------------------------------------- param access
    def set_listeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def num_params(self) -> int:
        self._ensure_init()
        return sum(int(v.numel()) for p in self.params for v in p.values())

    def param_table(self) -> Dict[str, np.ndarray]:
        """Flat name → array, names like ``0_W``."""
        self._ensure_init()
        return {f"{i}_{k}": _to_numpy(v) for i, p in enumerate(self.params)
                for k, v in sorted(p.items())}

    def params_flat(self) -> np.ndarray:
        """Every parameter in one vector, layer ascending then name
        ascending (the JAX package's order)."""
        self._ensure_init()
        parts = [_to_numpy(v).reshape(-1) for p in self.params
                 for _, v in sorted(p.items())]
        return np.concatenate(parts) if parts else np.zeros((0,), np.float32)

    def set_params_flat(self, flat: np.ndarray):
        self._ensure_init()
        offset = 0
        with torch.no_grad():
            for p in self.params:
                for k in sorted(p):
                    size = p[k].numel()
                    part = np.asarray(flat[offset:offset + size])
                    p[k].copy_(torch.from_numpy(part).reshape(p[k].shape))
                    offset += size

    def clone(self) -> "MultiLayerNetwork":
        """An independent copy: the configuration, parameters, layer and
        updater state and iteration, in new tensors on the same device."""
        self._ensure_init()
        net = MultiLayerNetwork(copy.deepcopy(self.conf), self.compute_dtype,
                                self.device).init()
        net.params = [_clone_tree(p) for p in self.params]
        net.state = [_clone_tree(s) for s in self.state]
        net.updater_state = [_clone_tree(u) for u in self.updater_state]
        net.iteration = self.iteration
        return net

    def summary(self) -> str:
        """A printable table of the layers and their parameter counts."""
        self._ensure_init()
        rows = [("idx", "layer", "nIn", "nOut", "params")]
        total = 0
        for i, layer in enumerate(self.layers):
            n = sum(int(v.numel()) for v in self.params[i].values())
            total += n
            rows.append((str(i), type(layer).__name__,
                         str(getattr(layer, "n_in", "") or ""),
                         str(getattr(layer, "n_out", "") or ""), f"{n:,}"))
        return format_summary_table(rows, total)


def _clone_tree(x):
    """A copy of parameters or state (tensors, dicts, lists, tuples,
    scalars) in new tensors."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(v) for v in x)
    return copy.deepcopy(x)


def _host(a) -> Optional[np.ndarray]:
    """Labels or a mask as a host array (a tensor given as input data is
    copied over; None stays None)."""
    if a is None:
        return None
    return _to_numpy(a) if torch.is_tensor(a) else np.asarray(a)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.detach().cpu().numpy()


def _pretrain_step(layer, params, upd, upd_state, x, gen, lr,
                   iteration) -> torch.Tensor:
    """One update of ``params`` (in place) and ``upd_state`` by the
    gradient of ``layer.pretrain_loss`` on ``x``; returns the loss,
    detached."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = layer.pretrain_loss(leaves, x, gen)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    materialize_grads=True)
    with torch.no_grad():
        for name, g in zip(leaves, grads):
            step, upd_state[name] = upd.update(g, upd_state[name], lr,
                                               float(iteration))
            params[name].sub_(step)
    return loss.detach()
