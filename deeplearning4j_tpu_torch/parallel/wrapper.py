"""ParallelWrapper: data-parallel training over a device mesh (the JAX
package's ``parallel/wrapper.py``; reference ParallelWrapper.java).

One controller drives every shard, as the mesh-sharded decoder does:
a :class:`~.mesh.Mesh` is a grid of ``torch.device`` entries (repeats
allowed, so several shards can share one card), each ``data`` coordinate
computes on its own device, and the shards are combined by explicit
reductions in shard order. No NCCL or gloo rank is involved.

- ``averaging_frequency == 1`` (synchronous DP, :func:`sync_step`): the
  batch, padded to divide evenly (:func:`pad_rows`), splits into one
  contiguous row block per ``data`` shard. Every shard runs the forward
  on its block; the loss denominators of the whole batch (one per
  output: present cells or examples over all shards) are summed in shard
  order; each shard divides its block's summed loss by them, the penalty
  counted on shard 0 only, and one backward runs through every shard. The
  gradients are summed in shard order and the net's ``_apply_gradients``
  (gradient normalization included) updates the masters once: the step of
  the whole batch, as JAX's one GSPMD program over the global batch
  computes it. Dropout draws per shard from the step's seed folded with
  the shard index.
- ``averaging_frequency == k > 1`` (local steps): each shard keeps a
  replica (parameters, updater state, layer state) that takes k plain
  train steps on its row block of each of k batches; then the replicas'
  parameters, updater state (``average_updaters``), layer state and score
  are averaged in shard order and every replica takes the mean. With
  ``gradient_compression=t`` each replica threshold-encodes its round
  delta (``compression.py``), carries its residual, and the mean of the
  encodings is added to the round's base.

The shards' forwards advance together, vertex by vertex (the walk of
``sharded.py``), so a batch norm, a center-loss head or an MoE router
reads the whole batch across the shards, as JAX's GSPMD step does. When
``multihost`` reports
several processes, each process trains over its own mesh and the step's
(or round's) parameters and updater state are averaged across processes
with ``host_allreduce_mean``, under tags namespaced by construction
order."""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch

from ..nn.graph.computation_graph import ComputationGraph
from ..ops import rng as rngmod
from ..ops.dataset import DataSet, MultiDataSet
from ..ops.losses import reduce_terms
from . import multihost
from .mesh import DATA_AXIS, Mesh, make_mesh
from .sharded import ShardPlan, cross_points, walk


# ------------------------------------------------------------------ trees
def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of same-shaped trees (dicts, lists);
    a non-tensor leaf is the first tree's."""
    t0 = trees[0]
    if torch.is_tensor(t0):
        return fn(*trees)
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *(t[i] for t in trees))
                        for i in range(len(t0)))
    return t0


def tree_leaves(tree) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def tree_to(tree, device):
    """A copy of ``tree`` with every tensor on ``device`` (new storage even
    where it already is there)."""
    return tree_map(lambda a: a.detach().to(device, copy=True), tree)


def tree_sum(trees, device):
    """The leafwise sum of ``trees`` on ``device``, in list order."""
    def add(*leaves):
        acc = leaves[0].detach().to(device)
        for a in leaves[1:]:
            acc = acc + a.detach().to(device)
        return acc
    return tree_map(add, *trees)


def tree_mean(trees, device):
    """The leafwise mean of ``trees`` on ``device``: the sum in list order
    over the count (as ``pmean`` is ``psum / n``); non-float leaves are
    the first tree's."""
    n = len(trees)

    def mean(*leaves):
        if not leaves[0].is_floating_point():
            return leaves[0].detach().to(device, copy=True)
        acc = leaves[0].detach().to(device)
        for a in leaves[1:]:
            acc = acc + a.detach().to(device)
        return acc / n
    return tree_map(mean, *trees)


# ---------------------------------------------------------------- padding
def _take(a, idx: np.ndarray):
    if a is None:
        return None
    if torch.is_tensor(a):
        return a[torch.as_tensor(idx, device=a.device)]
    return np.asarray(a)[idx]


def _sequence_labels(labels) -> bool:
    """[N, T, C] labels, or [N, T] integer class ids (T > 1)."""
    if labels.ndim == 3:
        return True
    integer = not (labels.is_floating_point() if torch.is_tensor(labels)
                   else np.issubdtype(np.asarray(labels).dtype,
                                      np.floating))
    return labels.ndim == 2 and integer and labels.shape[1] > 1


def pad_rows(n: int, n_dev: int, features: list, labels: list,
             fmasks: list, lmasks: list):
    """Pad a batch of ``n`` rows to a multiple of ``n_dev`` (JAX's
    ``_pad_to_devices``): repeated rows for finite arithmetic, with ZERO
    labels-mask weight, so score and gradient are the unpadded batch's.
    Absent label masks are synthesized: [N, T] ones for sequence labels
    (one-hot [N, T, C] or integer [N, T]: present cells count), [N]
    otherwise. Returns the four lists, unchanged when ``n`` divides."""
    rem = n % n_dev
    if rem == 0:
        return features, labels, fmasks, lmasks
    idx = np.concatenate([np.arange(n), np.arange(n_dev - rem) % n])
    out_m = []
    for lab, m in zip(labels, lmasks):
        if m is None and lab is not None:
            m = np.ones(tuple(lab.shape[:2]) if _sequence_labels(lab)
                        else (n,), np.float32)
        m = _take(m, idx)
        if m is not None:
            m = m.clone().float() if torch.is_tensor(m) else \
                m.astype(np.float32)
            m[n:] = 0.0
        out_m.append(m)
    return ([_take(f, idx) for f in features],
            [_take(lab, idx) for lab in labels],
            [_take(m, idx) for m in fmasks], out_m)


def split_rows(ds, n_shards: int) -> list:
    """``ds`` (rows divisible by ``n_shards``) as contiguous row blocks,
    one DataSet or MultiDataSet per shard."""
    b = ds.num_examples() // n_shards
    cut = lambda a, s: None if a is None else a[s * b:(s + 1) * b]
    if isinstance(ds, MultiDataSet):
        cuts = lambda xs, s: None if xs is None else \
            [cut(a, s) for a in xs]
        return [MultiDataSet(cuts(ds.features, s), cuts(ds.labels, s),
                             cuts(ds.features_masks, s),
                             cuts(ds.labels_masks, s))
                for s in range(n_shards)]
    return [DataSet(cut(ds.features, s), cut(ds.labels, s),
                    cut(ds.features_mask, s), cut(ds.labels_mask, s))
            for s in range(n_shards)]


def pad_dataset(ds, n_dev: int):
    """``ds`` padded by :func:`pad_rows`, as the same kind of dataset."""
    n = ds.num_examples()
    if isinstance(ds, MultiDataSet):
        nf, nl = len(ds.features), len(ds.labels)
        f, lab, fm, lm = pad_rows(
            n, n_dev, list(ds.features), list(ds.labels),
            list(ds.features_masks or [None] * nf),
            list(ds.labels_masks or [None] * nl))
        return MultiDataSet(f, lab, None if all(m is None for m in fm)
                            else fm,
                            None if all(m is None for m in lm) else lm)
    f, lab, fm, lm = pad_rows(n, n_dev, [ds.features], [ds.labels],
                              [ds.features_mask], [ds.labels_mask])
    return DataSet(f[0], lab[0], fm[0], lm[0])


# ------------------------------------------------------------- the shards
def data_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each ``data`` coordinate, in order (the other axes at
    coordinate 0)."""
    if DATA_AXIS not in mesh.shape:
        raise ValueError(f"data-parallel training shards the batch over "
                         f"a '{DATA_AXIS}' axis; the mesh has axes "
                         f"{mesh.axis_names}")
    ax = mesh.axis_index(DATA_AXIS)
    return [mesh.device(tuple(d if i == ax else 0
                              for i in range(len(mesh.axis_names))))
            for d in range(mesh.shape[DATA_AXIS])]


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def replica(net, device):
    """A shallow copy of ``net`` on ``device`` with copies of its
    parameters, layer state and updater state (the configuration and
    update rules shared) and no listeners."""
    r = copy.copy(net)
    r.device = torch.device(device)
    r.params = tree_to(net.params, device)
    r.state = tree_to(net.state, device)
    r.updater_state = tree_to(net.updater_state, device)
    r.listeners = []
    if hasattr(r, "_fusion"):
        r._fusion = None          # the fusion plan is built per device
    return r


def _view(net, device):
    """``net`` itself on its own device, else a :func:`replica` there."""
    if _canonical(device) == _canonical(net.device):
        return net
    return replica(net, device)


def _loss_terms_walk(net, leaves, batch, rng, cross):
    """The walk (a generator, for :func:`~.sharded.walk`) of the net's
    loss terms on one shard's batch."""
    feats, labels, fmask, lmask = batch
    if isinstance(net, ComputationGraph):
        args = (leaves, net.state, feats, labels, rng, lmask, fmask)
    else:
        args = (leaves, net.state, feats, labels, fmask, lmask, rng)
    return net._loss_terms_walk(*args, cross=cross)


def _global_counts(outs, device):
    """Per loss term, its count over every shard (summed in shard order;
    a tensor on ``device`` for mask counts, a number for shape counts)."""
    out = []
    for i in range(len(outs[0][0])):
        total = None
        for terms, _, _ in outs:
            c = terms[i][1]
            if torch.is_tensor(c):
                c = c.detach().to(device)
            total = c if total is None else total + c
        out.append(total)
    return out


def walk_loss(net, views, params, blocks, plan: ShardPlan, cross,
              answer_fn=None):
    """(the step's loss on the net's device, each shard's (terms, reg,
    new state)): shard s's loss walk (``views[s]``, the net on its
    device, with parameters ``params[s]`` on ``blocks[s]``) run in step
    with the others through the vertex-synchronous walk (``sharded.py``),
    the cross-shard vertices ``cross`` over all the shards at once (by
    ``answer_fn``, default :func:`~.sharded.answer`). The loss counts are
    summed over the shards, each shard's sums divided by them and added
    up, the penalty taken once, from shard 0."""
    rng = net._dropout_rng()
    walks = [_loss_terms_walk(view, p, view._batch(block),
                              rngmod.fold_in(rng, s), cross)
             for s, (view, p, block) in enumerate(zip(views, params,
                                                      blocks))]
    outs = walk(walks, plan, answer_fn)
    counts = _global_counts(outs, net.device)
    total = None
    for s, (view, (terms, reg, _)) in enumerate(zip(views, outs)):
        denominators = [c.to(view.device) if torch.is_tensor(c) else c
                        for c in counts]
        loss = reduce_terms(terms, start=reg if s == 0 else None,
                            denominators=denominators).to(net.device)
        total = loss if total is None else total + loss
    return total, outs


def sync_step(net, devices: List[torch.device], blocks: list,
              plan: Optional[ShardPlan] = None):
    """One synchronous step of ``net`` over ``blocks`` (one row block a
    device, as :func:`split_rows` cuts them, or the (data, sp) blocks of
    a sequence-parallel ``plan``): :func:`walk_loss` over the shards,
    then one backward through every shard. The shards' gradients are
    summed in shard order and the net's ``_apply_gradients`` updates the
    masters once: the step of the whole batch. Returns (the score as a
    0-d tensor on the net's device, shard 0's new layer state — the
    global statistics)."""
    plan = plan or ShardPlan(devices)
    views = [_view(net, dev) for dev in devices]
    with torch.enable_grad():
        leaves = [view._param_leaves() for view in views]
        total, outs = walk_loss(net, views, leaves, blocks, plan,
                                cross_points(net, plan))
        flat = [x for lv in leaves for x in tree_leaves(lv)]
        grads = iter(torch.autograd.grad(total, flat,
                                         materialize_grads=True))
    per_shard = [tree_map(lambda _: next(grads), lv) for lv in leaves]
    net._apply_gradients(tree_sum(per_shard, net.device))
    return total.detach(), tree_map(lambda a: a.detach().to(net.device),
                                    outs[0][2])


class ParallelWrapper:
    """Builder-style API mirroring the reference:

        ParallelWrapper.Builder(net).workers(8).averaging_frequency(5)
            .average_updaters(True).build().fit(iterator)
    """

    _ns_counter = 0      # cross-process-consistent store namespace source

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 averaging_frequency: int = 1, average_updaters: bool = True,
                 prefetch_buffer: int = 2, report_score: bool = True,
                 gradient_compression: Optional[float] = None):
        self.net = net
        self.mesh = mesh if mesh is not None else make_mesh()
        self.devices = data_devices(self.mesh)
        # store keys are write-once and must MATCH across processes:
        # namespace them by construction order (the same program runs on
        # every process), never by id()
        self._sync_no = 0
        self._sync_ns = ParallelWrapper._ns_counter
        ParallelWrapper._ns_counter += 1
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.average_updaters = average_updaters
        self.prefetch_buffer = prefetch_buffer
        self.report_score = report_score
        self.gradient_compression = gradient_compression
        if gradient_compression is not None and \
                self.averaging_frequency == 1:
            raise ValueError(
                "gradient_compression requires local-steps mode "
                "(averaging_frequency > 1); synchronous DP sums the "
                "shards' gradients, where threshold encoding does not "
                "apply")
        self._replicas = None
        self._residuals = None
        self.last_sent_fraction: Optional[torch.Tensor] = None

    class Builder:
        def __init__(self, net):
            self._net = net
            self._mesh = None
            self._freq = 1
            self._avg_upd = True
            self._prefetch = 2
            self._compression = None

        def workers(self, n: int, devices=None):
            """A ``data`` mesh of ``n`` shards over ``devices`` (default:
            the first ``n`` CUDA devices; a list may repeat one)."""
            self._mesh = make_mesh(n, devices=devices)
            return self

        def mesh(self, mesh: Mesh):
            self._mesh = mesh
            return self

        def averaging_frequency(self, k: int):
            self._freq = int(k)
            return self

        def gradient_compression(self, threshold: float):
            """Threshold-encoded delta sharing with error feedback (the
            EncodedGradientsAccumulator role); local-steps mode only."""
            self._compression = float(threshold)
            return self

        def average_updaters(self, flag: bool):
            self._avg_upd = bool(flag)
            return self

        def prefetch_buffer(self, n: int):
            self._prefetch = int(n)
            return self

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._net, self._mesh, self._freq,
                                   self._avg_upd, self._prefetch,
                                   gradient_compression=self._compression)

    @property
    def num_workers(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))

    # ------------------------------------------------------------ fit
    def fit(self, data, num_epochs: int = 1):
        net = self.net
        net._ensure_init()
        from ..datasets.iterators import AsyncDataSetIterator, as_iterator
        for _ in range(num_epochs):
            it = as_iterator(data)
            if getattr(it, "async_supported", True):
                it = AsyncDataSetIterator(it, self.prefetch_buffer,
                                          device_put=False)
            if self.averaging_frequency == 1:
                self._fit_sync(it)
            else:
                self._fit_local_steps(it)
            net.epoch += 1
        return self

    def _host_sync(self):
        """Several processes: average the masters (and updater state,
        matching ``average_updaters``) across processes after every step,
        the cadence of JAX's emulated collective."""
        net = self.net
        self._sync_no += 1
        tag = f"n{self._sync_ns}-s{self._sync_no}"
        net.params = multihost.host_allreduce_mean(net.params, tag + "/p")
        if self.average_updaters:
            net.updater_state = multihost.host_allreduce_mean(
                net.updater_state, tag + "/u")

    # --- mode 1: synchronous DP, gradients summed over the shards ---
    def _fit_sync(self, iterator):
        net = self.net
        for ds in iterator:
            padded = pad_dataset(ds, self.num_workers)
            score, new_state = sync_step(
                net, self.devices, split_rows(padded, len(self.devices)))
            if multihost.process_count() > 1:
                self._host_sync()
            net._after_step(score, new_state)

    # --- mode k: local steps + periodic parameter averaging ---
    def _fit_local_steps(self, iterator):
        net = self.net
        if self._replicas is None:
            # one replica per shard, kept across fit() calls; the residual
            # (error-feedback carry of compressed sharing) starts at zero
            self._replicas = [replica(net, d) for d in self.devices]
            if self.gradient_compression is not None:
                self._residuals = [tree_map(torch.zeros_like, r.params)
                                   for r in self._replicas]
        buf = []
        for ds in iterator:
            buf.append(ds)
            if len(buf) == self.averaging_frequency:
                self._run_round(buf)
                buf = []
        if buf:
            self._run_round(buf)
        r0 = self._replicas[0]
        net.params = tree_to(r0.params, net.device)
        net.updater_state = tree_to(r0.updater_state, net.device)
        net.state = tree_to(r0.state, net.device)

    def _run_round(self, batches: List):
        net = self.net
        k, n = len(batches), len(self.devices)
        blocks = [split_rows(pad_dataset(b, self.num_workers), n)
                  for b in batches]
        bases, scores = [], []
        for s, r in enumerate(self._replicas):
            bases.append(tree_to(r.params, r.device)
                         if self._residuals is not None else None)
            r.iteration = net.iteration
            for j in range(k):
                score, new_state = r._train_step(*r._batch(blocks[j][s]))
                r.state = r._strip_rnn_carry(new_state)
                r.iteration += 1
                scores.append(score.to(net.device))
        dev0 = self.devices[0]
        if self._residuals is None:
            params = tree_mean([r.params for r in self._replicas], dev0)
            sent = torch.ones((), dtype=torch.float32, device=net.device)
        else:
            params, sent = self._compressed_mean(bases)
        upd = tree_mean([r.updater_state for r in self._replicas], dev0) \
            if self.average_updaters else None
        state = tree_mean([r.state for r in self._replicas], dev0)
        if multihost.process_count() > 1:
            params, upd, state = self._host_sync_round(params, upd, state)
        for r in self._replicas:
            r.params = tree_to(params, r.device)
            if upd is not None:
                r.updater_state = tree_to(upd, r.device)
            r.state = tree_to(state, r.device)
        # the mean over shards of each shard's mean step score
        per_shard = [torch.stack(scores[s * k:(s + 1) * k]).float().mean()
                     for s in range(n)]
        score = per_shard[0]
        for sc in per_shard[1:]:
            score = score + sc
        self.last_sent_fraction = sent
        net.score_value = score / n
        net.iteration += k
        for lst in net.listeners:
            lst.iteration_done(net, net.iteration)

    def _compressed_mean(self, bases):
        """Each replica's round delta threshold-encoded against its
        residual; the mean of the encodings added to the round's base
        (the same on every replica). Returns (new parameters, the mean
        over replicas of the sent fraction)."""
        from .compression import sent_fraction, threshold_encode
        dev0 = self.devices[0]
        encoded, fracs = [], []
        for s, r in enumerate(self._replicas):
            pairs = tree_map(
                lambda p, b, res: threshold_encode(
                    p - b, res, self.gradient_compression),
                r.params, bases[s], self._residuals[s])
            enc, self._residuals[s] = _unzip(pairs)
            leaves = tree_leaves(enc)
            size = max(sum(l.numel() for l in leaves), 1)
            frac = sum(sent_fraction(l).to(self.net.device) * l.numel()
                       for l in leaves) / size
            encoded.append(enc)
            fracs.append(frac)
        mean_enc = tree_mean(encoded, dev0)
        params = tree_map(lambda b, e: b.to(dev0) + e, bases[0], mean_enc)
        sent = fracs[0]
        for f in fracs[1:]:
            sent = sent + f
        return params, sent / len(fracs)

    def _host_sync_round(self, params, upd, state):
        """Several processes: complete the round's mean across processes
        (every local replica holds the local mean, so the mean of the
        processes' means is the global one for equal-sized meshes); the
        residuals stay per replica."""
        self._sync_no += 1
        tag = f"n{self._sync_ns}-r{self._sync_no}"
        params = multihost.host_allreduce_mean(params, tag + "/p")
        if upd is not None:
            upd = multihost.host_allreduce_mean(upd, tag + "/u")
        state = multihost.host_allreduce_mean(state, tag + "/s")
        return params, upd, state


def _unzip(pairs):
    """A tree whose leaves are (a, b) pairs → two trees (a's, b's)."""
    def pick(tree, i):
        if isinstance(tree, tuple) and len(tree) == 2 and \
                all(torch.is_tensor(x) for x in tree):
            return tree[i]
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(pick(v, i) for v in tree)
        return tree
    return pick(pairs, 0), pick(pairs, 1)
