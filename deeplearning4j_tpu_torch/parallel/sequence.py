"""Sequence parallelism: ring attention over the shards of the time axis
(the JAX package's ``parallel/sequence.py``).

One controller holds every shard: the sequence is cut into ``sp``
contiguous chunks, each on its mesh coordinate's device ([B, T/sp, H, D]
q/k/v). Each shard attends its query chunk against every key/value chunk
in ring order (step t: the chunk of shard (my − t) mod sp, as JAX's
``ppermute`` brings it), keeping a running (o, lse) merged with
:func:`_merge_partials`. Causal masking follows the chunks' absolute
positions: the diagonal pair is causal, a pair below it is fully visible,
and a strictly-future pair is skipped (nothing launched).

- :class:`_RingFlash` is the ring as a ``torch.autograd.Function`` over
  the shards' [BH, T/sp, D] chunks: each pair's forward is the flash
  forward kernel B3 (``kernels/flash_forward.py::flash_forward``), each
  pair's backward the dq and dk/dv kernels B4 and B5
  (``kernels/flash_backward.py``) with the ring's global lse and one
  δ = rowsum(dO·O) a shard, computed once; dq accumulates on its shard,
  each dk/dv on its chunk's shard in the order the JAX ring rotates it
  home. On a CPU tensor every pair call takes the wrappers' plain
  versions.
- The plain version is the streaming ring (``impl="jnp"``, JAX's
  ``ring``): :func:`_block_attend` updates of a running max, denominator
  and numerator, differentiated by autograd.
- :func:`ring_self_attention` takes whole [B, T, H, D] tensors and a
  mesh; :class:`RingAttention` is the ``attention`` helper that
  :func:`enable_ring_attention` claims, on every device type, and whose
  :meth:`RingAttention.attend_shards` the sharded walk calls with each
  shard's chunk (``sharded.py``).
- :class:`GraphSequenceParallelTrainer` trains a whole graph (the
  transformer LM) sequence-parallel through that walk: every vertex is
  token-local but attention (the ring) and the embedding (each shard at
  its absolute positions); the loss divides by the global count of
  present cells. :class:`SequenceParallelTrainer` trains one attention
  block with a per-token regression loss.

JAX initializes parameters with threefry, which the port cannot draw
(ROADMAP rule 3): the trainers also take parameters carried across from
numpy."""

from __future__ import annotations

import math
import warnings
import weakref
from typing import List, Optional

import numpy as np
import torch

from ..kernels.flash_backward import flash_backward_dkv, flash_backward_dq
from ..kernels.flash_forward import flash_forward
from ..kernels.shortseq_attention import row_delta
from ..nn import helpers
from ..ops import rng as rngmod
from ..ops.dataset import DataSet
from .mesh import Mesh, P, ShardedTensor, make_mesh
from .sharded import ShardPlan


def attention_reference(q, k, v, causal: bool = False):
    """Plain single-device attention: q/k/v [B, T, H, D] → [B, T, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones(tq, tk, dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# graftlint: shard
def _block_attend(q, k, v, m, l, o, q_offset, k_offset, causal,
                  k_keep=None):
    """One streaming-softmax block update. q [B,Tq,H,D], k/v [B,Tk,H,D];
    m/l [B,H,Tq], o [B,Tq,H,D] are the running max/denominator/numerator.
    ``k_keep`` [B,Tk]: masked keys (0) have their logits replaced by
    −1e30, so a fully-masked row degrades to the uniform average the
    materialized softmax gives."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if k_keep is not None:
        logits = torch.where(k_keep[:, None, None, :] > 0, logits,
                             torch.full_like(logits, -1e30))
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = k_offset + torch.arange(tk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = logits.masked_fill(~mask, float("-inf"))
    block_max = logits.amax(dim=-1)
    new_m = torch.maximum(m, block_max)
    # guard fully-masked blocks (all -inf)
    new_m_safe = torch.where(torch.isfinite(new_m), new_m,
                             torch.zeros_like(new_m))
    p = torch.exp(logits - new_m_safe[..., None])
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    correction = torch.where(torch.isfinite(m), torch.exp(m - new_m_safe),
                             torch.zeros_like(m))
    new_l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v)
    new_o = o * correction.transpose(1, 2)[..., None] + pv
    return new_m, new_l, new_o


# graftlint: shard
def _merge_partials(o, lse, o_p, lse_p):
    """Merge two normalized attention partials (o_i, lse_i): weights
    exp(lse_i − logaddexp) ≤ 1, guarded where an lse is −∞."""
    new = torch.logaddexp(lse, lse_p)
    new_safe = torch.where(torch.isfinite(new), new, torch.zeros_like(new))
    w = torch.where(torch.isfinite(lse), torch.exp(lse - new_safe),
                    torch.zeros_like(lse))
    wp = torch.where(torch.isfinite(lse_p), torch.exp(lse_p - new_safe),
                     torch.zeros_like(lse_p))
    return o * w[..., None] + o_p * wp[..., None], new


def _pairs(n, causal):
    """The ring's (step, my, src) pairs in JAX's order, strictly-future
    pairs left out under causal masking."""
    return [(t, my, (my - t) % n) for t in range(n) for my in range(n)
            if not (causal and (my - t) % n > my)]


class _RingFlash(torch.autograd.Function):
    """The ring over the shards' [BH, T/sp, D] chunks (``spec`` = (shards,
    causal); then the n q chunks, the n k chunks, the n v chunks): each
    pair through the flash kernels, partials merged in f32; returns every
    shard's o in q's dtype."""

    @staticmethod
    def forward(ctx, spec, *qkv):
        n, causal = spec
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        acc = []
        for q in qs:
            bh, t, d = q.shape
            acc.append([torch.zeros((bh, t, d), dtype=torch.float32,
                                    device=q.device),
                        torch.full((bh, t), float("-inf"),
                                   dtype=torch.float32, device=q.device)])
        for _, my, src in _pairs(n, causal):
            q = qs[my]
            op, lsep = flash_forward(q, ks[src].to(q.device),
                                     vs[src].to(q.device), None, 1,
                                     causal and src == my)
            acc[my] = list(_merge_partials(acc[my][0], acc[my][1],
                                           op.float(), lsep.float()))
        outs = [o.to(q.dtype) for (o, _), q in zip(acc, qs)]
        lses = [lse for _, lse in acc]
        ctx.spec = spec
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        n, causal = ctx.spec
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        dos = [do.contiguous() for do in dos]
        # δ depends only on dO and O: once a shard, not once a pair
        deltas = [row_delta(do, o) for do, o in zip(dos, outs)]
        zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device)
        dq = [zeros(q) for q in qs]
        dk = [zeros(k) for k in ks]
        dv = [zeros(v) for v in vs]
        for _, my, src in _pairs(n, causal):
            q, dev = qs[my], qs[my].device
            kc, vc = ks[src].to(dev), vs[src].to(dev)
            diag = causal and src == my
            args = (q, kc, vc, None, 1, diag, dos[my], lses[my], deltas[my])
            dq[my] = dq[my] + flash_backward_dq(*args).float()
            dkp, dvp = flash_backward_dkv(*args)
            dk[src] = dk[src] + dkp.float().to(dk[src].device)
            dv[src] = dv[src] + dvp.float().to(dv[src].device)
        return (None, *[g.to(x.dtype) for g, x in zip(dq, qs)],
                *[g.to(x.dtype) for g, x in zip(dk, ks)],
                *[g.to(x.dtype) for g, x in zip(dv, vs)])


def _ring_flash(qs, ks, vs, causal: bool):
    """The kernel ring over one ring's [BH, T/sp, D] chunks (lists, one a
    shard, in sequence order): every shard's o (:class:`_RingFlash`)."""
    return list(_RingFlash.apply((len(qs), bool(causal)), *qs, *ks, *vs))


def _fold(x):
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d).contiguous()


def _unfold(o, b, h):
    bh, t, d = o.shape
    return o.reshape(b, h, t, d).transpose(1, 2)


def _ring_kernel(qs, ks, vs, causal):
    """[B, T/sp, H, D] chunks → their outputs through :class:`_RingFlash`."""
    b, _, h, _ = qs[0].shape
    n = len(qs)
    folded = [_fold(x) for x in (*qs, *ks, *vs)]
    outs = _ring_flash(folded[:n], folded[n:2 * n], folded[2 * n:], causal)
    return [_unfold(o, b, h) for o in outs]


def _ring_streaming(qs, ks, vs, causal):
    """The plain ring (JAX's ``ring``): :func:`_block_attend` over the
    chunks in ring order, in q's dtype."""
    n = len(qs)
    out = []
    for my, q in enumerate(qs):
        b, t, h, _ = q.shape
        m = torch.full((b, h, t), float("-inf"), dtype=q.dtype,
                       device=q.device)
        l = torch.zeros((b, h, t), dtype=q.dtype, device=q.device)
        o = torch.zeros_like(q)
        for step in range(n):
            src = (my - step) % n
            m, l, o = _block_attend(q, ks[src].to(q.device),
                                    vs[src].to(q.device), m, l, o,
                                    my * t, src * t, causal)
        out.append(o / l.clamp_min(1e-20).transpose(1, 2)[..., None])
    return out


def _ring_block(t_local: int):
    """The JAX ring's kernel block for a shard length (None where no TPU
    block tiles it). The port's kernels mask any length, so the port's
    ring takes its kernels at every shard length; kept for the API."""
    if t_local <= 512:
        return t_local
    for blk in (512, 256, 128):
        if t_local % blk == 0:
            return blk
    return None


_IMPLS = (None, "pallas", "jnp")


def ring_attend(qs, ks, vs, causal: bool, impl: Optional[str] = None):
    """Ring attention over the chunks of one ring (lists of [B, T/sp, H,
    D], one a shard, in sequence order): ``impl`` None or "pallas" (the
    JAX package's name) the flash-kernel ring, "jnp" the plain streaming
    ring."""
    if impl not in _IMPLS:
        raise ValueError(f"ring impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "jnp":
        return _ring_streaming(qs, ks, vs, causal)
    return _ring_kernel(qs, ks, vs, causal)


def _grid(mesh: Mesh, axis: str, batch_axis: Optional[str]):
    """[(data group, sp index, device)] in data-major order: the shard
    coordinates of a (batch_axis, axis) layout, other axes at 0."""
    n_sp = mesh.shape[axis]
    n_dp = mesh.shape[batch_axis] if batch_axis else 1
    out = []
    for d in range(n_dp):
        for s in range(n_sp):
            coord = tuple(s if a == axis else d if a == batch_axis else 0
                          for a in mesh.axis_names)
            out.append((d, s, mesh.device(coord)))
    return out


def ring_self_attention(q, k, v, mesh: Mesh, axis: str = "sp",
                        causal: bool = False, impl: Optional[str] = None,
                        batch_axis: Optional[str] = None):
    """Ring attention on whole q/k/v [B, T, H, D]: T cut over ``axis``
    (and B over ``batch_axis``, each batch shard its own ring), each chunk
    on its coordinate's device. Returns [B, T, H, D] on q's device."""
    n_sp = mesh.shape[axis]
    n_dp = mesh.shape[batch_axis] if batch_axis else 1
    b, t = q.shape[:2]
    if t % n_sp or b % n_dp:
        raise ValueError(f"[B, T] = [{b}, {t}] does not divide over the "
                         f"mesh ({n_dp} batch shards, {n_sp} sequence "
                         "shards)")
    tl, bl = t // n_sp, b // n_dp
    grid = _grid(mesh, axis, batch_axis)
    rows = []
    for d in range(n_dp):
        cut = lambda x, s, dev: x[d * bl:(d + 1) * bl,
                                  s * tl:(s + 1) * tl].to(dev)
        shards = [(s, dev) for dd, s, dev in grid if dd == d]
        outs = ring_attend([cut(q, s, dev) for s, dev in shards],
                           [cut(k, s, dev) for s, dev in shards],
                           [cut(v, s, dev) for s, dev in shards],
                           causal, impl)
        rows.append(torch.cat([o.to(q.device) for o in outs], dim=1))
    return torch.cat(rows, dim=0)


def sequence_sharded(mesh: Mesh, x, axis: str = "sp") -> ShardedTensor:
    """[B, T, ...] as a ShardedTensor with T cut over ``axis``."""
    x = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    return ShardedTensor.from_global(
        mesh, P(None, axis, *([None] * (x.dim() - 2))), x)


class RingAttention:
    """The ``attention`` helper of ring attention over ``mesh``: called
    with whole [B, T, H, D] q/k/v (``conf``, q, k, v, key mask) it runs
    :func:`ring_self_attention`; the sharded walk hands it each shard's
    chunk through :meth:`attend_shards`. Key masks are refused."""

    def __init__(self, mesh: Mesh, axis: str = "sp",
                 batch_axis: Optional[str] = None,
                 impl: Optional[str] = None):
        self.mesh, self.axis = mesh, axis
        self.batch_axis, self.impl = batch_axis, impl

    def __call__(self, conf, q, k, v, mask):
        if mask is not None:
            raise ValueError("ring attention does not support key masks; "
                             "train unmasked (LM) sequences or disable the "
                             "ring helper")
        return ring_self_attention(q, k, v, self.mesh, self.axis,
                                   causal=conf.causal,
                                   batch_axis=self.batch_axis,
                                   impl=self.impl)

    def attend_shards(self, conf, qs, ks, vs) -> List[torch.Tensor]:
        return ring_attend(qs, ks, vs, conf.causal, self.impl)


def enable_ring_attention(mesh: Mesh, axis: str = "sp",
                          platforms=("cuda", "cpu"),
                          batch_axis: Optional[str] = None,
                          impl: Optional[str] = None,
                          _scoped: bool = False) -> RingAttention:
    """Claim the ``attention`` helper slot for ring attention over
    ``mesh`` on ``platforms`` (torch device types); re-enables the slot if
    :func:`disable_ring_attention` silenced it."""
    ring = RingAttention(mesh, axis, batch_axis, impl)
    helpers.register_helper("attention", ring, platforms, _scoped=_scoped)
    helpers.enable_helper("attention")
    return ring


def disable_ring_attention():
    helpers.disable_helper("attention")


def _init_params(conf, seed: int, device):
    gen = rngmod.generator(rngmod.for_purpose(seed, "init"), device)
    return conf.init_params(gen, torch.float32)


def _params_from(params, device):
    return {k: torch.tensor(np.asarray(a, np.float32), device=device)
            for k, a in params.items()}


class SequenceParallelTrainer:
    """Sequence-parallel training of one self-attention block with a
    per-token MSE loss (JAX's trainer of the same name): x / y [B, T, d]
    cut over ``axis``; projections and loss shard-local, the attention
    through the kernel ring; plain SGD. ``params``: a {name: array} dict
    carried across (e.g. from the JAX trainer), else a seeded init."""

    def __init__(self, attn_conf, mesh: Optional[Mesh] = None,
                 axis: str = "sp", learning_rate: float = 0.1,
                 seed: int = 12345, params=None):
        self.conf = attn_conf
        self.mesh = mesh if mesh is not None else \
            make_mesh(axis_names=("sp",))
        self.axis = axis
        self.learning_rate = float(learning_rate)
        home = self.mesh.device((0,) * len(self.mesh.axis_names))
        self.params = _params_from(params, home) if params is not None \
            else _init_params(attn_conf, seed, home)
        self.iteration = 0
        self.score_value = float("nan")

    def fit_batch(self, x, y) -> float:
        mesh, axis, conf = self.mesh, self.axis, self.conf
        n_sp = mesh.shape[axis]
        x = torch.as_tensor(np.asarray(x, np.float32))
        y = torch.as_tensor(np.asarray(y, np.float32))
        if x.shape[1] % n_sp:
            raise ValueError(
                f"sequence length {x.shape[1]} not divisible by sp axis size "
                f"{n_sp}; pad the sequence to a multiple of {n_sp}")
        tl = x.shape[1] // n_sp
        devs = [dev for _, _, dev in _grid(mesh, axis, None)]
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in self.params.items()}
        home = next(iter(leaves.values())).device
        with torch.enable_grad():
            qs, ks, vs, ps = [], [], [], []
            for s, dev in enumerate(devs):
                p = {k: a.to(dev) for k, a in leaves.items()}
                q, k, v = conf._project_qkv(p, x[:, s * tl:(s + 1) * tl]
                                            .to(dev))
                qs.append(q)
                ks.append(k)
                vs.append(v)
                ps.append(p)
            outs = ring_attend(qs, ks, vs, conf.causal)
            total = None
            for s, (dev, o) in enumerate(zip(devs, outs)):
                out = conf._project_out(ps[s], o)
                err = ((out - y[:, s * tl:(s + 1) * tl].to(dev)) ** 2).sum()
                total = err.to(home) if total is None else \
                    total + err.to(home)
            score = total / y.numel()
            grads = torch.autograd.grad(score, list(leaves.values()))
        with torch.no_grad():
            for (k, p), g in zip(self.params.items(), grads):
                p.sub_(self.learning_rate * g)
        self.score_value = score.detach()
        self.iteration += 1
        return float(self.score_value)


# ring helpers of trainers that have been close()d, mapped to the snapshot
# each displaced: restoring a closed ring would resurrect a ring bound to
# a dead mesh, so restores walk this chain to the most recent still-live
# registration instead
_CLOSED_RING_SNAPSHOTS: "weakref.WeakKeyDictionary" = \
    weakref.WeakKeyDictionary()


class GraphSequenceParallelTrainer:
    """Sequence-parallel training of a whole ComputationGraph (the
    transformer LM): token ids, labels and label masks cut over ``axis``
    on the time dimension (and rows over ``data_axis`` on a 2-D mesh, each
    data group its own ring), one step through the vertex-synchronous walk
    (``wrapper.py::sync_step``) with the ring claimed in the
    ``attention`` slot. One SP step equals one single-device step (ring
    attention is exact)."""

    def __init__(self, net, mesh: Optional[Mesh] = None, axis: str = "sp",
                 data_axis: Optional[str] = None,
                 ring_impl: Optional[str] = None):
        self.net = net
        self.mesh = mesh if mesh is not None else \
            make_mesh(axis_names=("sp",))
        self.axis = axis
        if data_axis is not None and data_axis == axis:
            raise ValueError(
                f"data_axis {data_axis!r} must differ from the sequence "
                f"axis {axis!r} (use a 2-D mesh like axis_names="
                f"('data', 'sp'))")
        self.data_axis = data_axis if data_axis in self.mesh.shape else None
        # the ring claims the process-wide "attention" slot: snapshot what
        # was there and put it back in close() / on context exit
        self._prev_attention = helpers.snapshot_helper("attention")
        self._ring_helper = enable_ring_attention(
            self.mesh, axis, batch_axis=self.data_axis, impl=ring_impl,
            _scoped=True)
        self._closed = False

    def close(self):
        """Restore what held the ``attention`` slot before this trainer
        claimed it, while this trainer's ring still holds it (else warn
        and leave the slot alone); a displaced ring of a closed trainer is
        skipped for what that trainer displaced. Safe to call twice."""
        if self._closed:
            return
        self._closed = True
        _CLOSED_RING_SNAPSHOTS[self._ring_helper] = self._prev_attention
        current = helpers._CLAIMED.get("attention")
        if current is not None and current[0] is not self._ring_helper:
            warnings.warn(
                "GraphSequenceParallelTrainer.close(): the 'attention' "
                "helper slot was re-registered after this trainer claimed "
                "it; leaving the current registration in place (close "
                "trainers LIFO to restore cleanly)", stacklevel=2)
            return
        snap = self._prev_attention
        while snap[0] is not None and snap[0][0] in _CLOSED_RING_SNAPSHOTS:
            snap = _CLOSED_RING_SNAPSHOTS[snap[0][0]]
        helpers.restore_helper("attention", snap)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _blocks(self, ds, n_dp, n_sp):
        """The (data group, sp index) blocks of ``ds``, data-major."""
        n = ds.num_examples()
        t = np.asarray(ds.features).shape[1] if not \
            torch.is_tensor(ds.features) else ds.features.shape[1]
        bl, tl = n // n_dp, t // n_sp

        def cut(a, d, s, seq=True):
            if a is None:
                return None
            a = a[d * bl:(d + 1) * bl]
            return a[:, s * tl:(s + 1) * tl] if seq and a.ndim >= 2 else a
        return [DataSet(cut(ds.features, d, s), cut(ds.labels, d, s),
                        cut(ds.features_mask, d, s),
                        cut(ds.labels_mask, d, s))
                for d in range(n_dp) for s in range(n_sp)]

    def fit_batch(self, ds):
        from .wrapper import sync_step
        if self._closed:
            raise RuntimeError(
                "GraphSequenceParallelTrainer is closed: its ring-attention "
                "registration has been restored away, so training would "
                "silently lose sequence parallelism; create a new trainer")
        current = helpers._CLAIMED.get("attention")
        if current is None or current[0] is not self._ring_helper or \
                "attention" in helpers._DISABLED:
            raise RuntimeError(
                "this trainer's ring-attention helper no longer holds the "
                "'attention' slot (another trainer or helper registration "
                "displaced it); training would route attention through the "
                "wrong mesh — close the other registration first or use "
                "one trainer at a time")
        net = self.net
        net._ensure_init()
        n_sp = self.mesh.shape[self.axis]
        feats = ds.features
        t = feats.shape[1]
        if t % n_sp:
            raise ValueError(f"sequence length {t} not divisible by sp "
                             f"axis size {n_sp}")
        n_dp = self.mesh.shape[self.data_axis] if self.data_axis else 1
        n = ds.num_examples()
        if n % n_dp:
            raise ValueError(f"batch size {n} not divisible by data "
                             f"axis size {n_dp}")
        if ds.features_mask is not None:
            raise ValueError("ring attention does not support key masks; "
                             "train unmasked (LM) sequences or disable the "
                             "ring helper")
        net.last_input_batch = ds
        grid = _grid(self.mesh, self.axis, self.data_axis)
        tl = t // n_sp
        plan = ShardPlan([dev for _, _, dev in grid],
                         offsets=[s * tl for _, s, _ in grid],
                         rings=[[d * n_sp + s for s in range(n_sp)]
                                for d in range(n_dp)],
                         ring=self._ring_helper)
        score, new_state = sync_step(net, plan.devices,
                                        self._blocks(ds, n_dp, n_sp), plan)
        net._after_step(score, new_state)

    def fit(self, data, num_epochs: int = 1):
        from ..datasets.iterators import as_iterator
        for _ in range(num_epochs):
            for ds in as_iterator(data):
                self.fit_batch(ds)
            self.net.epoch += 1
        return self
