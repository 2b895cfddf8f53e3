"""Pipeline parallelism: a GPipe microbatch schedule over the stages of a
``pipe`` mesh axis (the JAX package's ``parallel/pipeline.py``).

A stack of L identical blocks keeps its parameters stacked on a leading
axis, cut over ``pipe``: stage s holds blocks [s·L/S, (s+1)·L/S) on the
mesh's s-th ``pipe`` device. Microbatches stream through the stages: at
tick t stage s applies its blocks to microbatch t − s (stage 0 takes it
from the input, the others from the stage before, the activation copied
to the stage's device), and M microbatches drain in M + S − 1 ticks. JAX
computes a stage's idle ticks and masks them out; here the controller
skips them, with the same outputs. The backward is autograd through the
schedule (the reverse pipeline, the activations copied back)."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import rng as rngmod
from ..ops.dataset import DataSet
from ..ops.updaters import make_updater
from .mesh import Mesh, P, ShardedTensor, make_mesh


def _stage_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    return [mesh.device(tuple(s if a == axis else 0
                              for a in mesh.axis_names))
            for s in range(mesh.shape[axis])]


def _schedule(block_fn: Callable, stages: List[Dict], x_micro,
              devices: List[torch.device]):
    """The GPipe ticks over per-stage parameters (``stages[s]``: name →
    [L/S, ...] on ``devices[s]``): [M, mb, ...] outputs on the last
    stage's device."""
    n_stages, m_micro = len(stages), x_micro.shape[0]
    carry, outs = {}, [None] * m_micro
    for tick in range(m_micro + n_stages - 1):
        for s, (local, dev) in enumerate(zip(stages, devices)):
            m = tick - s
            if not 0 <= m < m_micro:
                continue                      # an idle tick: skipped
            a = (x_micro[m] if s == 0 else carry.pop(m)).to(dev)
            for j in range(next(iter(local.values())).shape[0]):
                a = block_fn({k: v[j] for k, v in local.items()}, a)
            if s == n_stages - 1:
                outs[m] = a
            else:
                carry[m] = a
    return torch.stack(outs)


def pipeline_apply(block_fn: Callable, stacked_params, x_micro, mesh: Mesh,
                   axis: str = "pipe"):
    """Microbatches through a pipelined stack of identical blocks.

    block_fn(params_one_block, x) -> y with y.shape == x.shape.
    stacked_params: name → [L, ...] tensor (or a ShardedTensor cut over
    ``axis``); L % stages == 0. x_micro: [M, mb, ...] microbatches.
    Returns [M, mb, ...] on x_micro's device; differentiable with respect
    to the parameters and the inputs."""
    devices = _stage_devices(mesh, axis)
    n = len(devices)
    stages = []
    for s, dev in enumerate(devices):
        local = {}
        for k, v in stacked_params.items():
            if isinstance(v, ShardedTensor):
                local[k] = v.local(tuple(s if a == axis else 0
                                         for a in mesh.axis_names))
            else:
                if v.shape[0] % n:
                    raise ValueError(f"{v.shape[0]} blocks do not divide "
                                     f"over {n} stages")
                per = v.shape[0] // n
                local[k] = v[s * per:(s + 1) * per].to(dev)
        stages.append(local)
    return _schedule(block_fn, stages, x_micro, devices).to(x_micro.device)


class PipelineParallelTrainer:
    """Train an L-deep stack of identical blocks plus a head with the
    pipeline schedule. ``block_conf`` maps n_in → n_in. The blocks live
    as ShardedTensors cut over ``axis``, the head on the last stage.
    ``block_params`` (name → [L, ...] arrays) and ``head_params`` carry
    parameters across (e.g. from the JAX trainer); else a seeded init."""

    def __init__(self, block_conf, depth: int, head_conf,
                 mesh: Optional[Mesh] = None, axis: str = "pipe",
                 num_microbatches: int = 4, learning_rate: float = 0.1,
                 updater: str = "sgd", seed: int = 12345,
                 block_params=None, head_params=None):
        self.mesh = mesh if mesh is not None else \
            make_mesh(axis_names=("pipe",))
        self.axis = axis
        self.devices = _stage_devices(self.mesh, axis)
        n_stages = len(self.devices)
        if depth % n_stages:
            raise ValueError(f"depth {depth} not divisible by {n_stages} "
                             "stages")
        self.block_conf, self.head_conf = block_conf, head_conf
        self.depth = depth
        self.num_microbatches = int(num_microbatches)
        self.learning_rate = float(learning_rate)
        self.iteration = 0
        self.score_value = float("nan")
        home = self.devices[-1]
        if block_params is None:
            key = rngmod.for_purpose(seed, "init")
            blocks = [block_conf.init_params(rngmod.generator(
                rngmod.for_layer(key, i), home)) for i in range(depth)]
            stacked = {k: torch.stack([b[k] for b in blocks])
                       for k in blocks[0]}
        else:
            stacked = {k: torch.tensor(np.asarray(v, np.float32))
                       for k, v in block_params.items()}
        if head_params is None:
            head = head_conf.init_params(rngmod.generator(
                rngmod.for_layer(rngmod.for_purpose(seed, "init"), depth),
                home))
        else:
            head = {k: torch.tensor(np.asarray(v, np.float32))
                    for k, v in head_params.items()}
        self.block_params = {k: ShardedTensor.from_global(
            self.mesh, P(axis, *([None] * (v.dim() - 1))), v)
            for k, v in stacked.items()}
        self.head_params = {k: v.to(home, copy=True)
                            for k, v in head.items()}
        self.updater = make_updater(updater)
        self.upd_state = {
            "block": {k: [self.updater.init(t) for t in self._locals(st)]
                      for k, st in self.block_params.items()},
            "head": {k: self.updater.init(v)
                     for k, v in self.head_params.items()}}

    def _coord(self, s):
        return tuple(s if a == self.axis else 0
                     for a in self.mesh.axis_names)

    def _locals(self, st: ShardedTensor):
        return [st.local(self._coord(s)) for s in range(len(self.devices))]

    def _block_fn(self, p, a):
        out, _ = self.block_conf.forward(p, {}, a, train=False)
        return out

    def _micro(self, a):
        m = self.num_microbatches
        a = torch.as_tensor(np.asarray(a, np.float32))
        return a.reshape((m, a.shape[0] // m) + tuple(a.shape[1:]))

    def fit_batch(self, ds: DataSet):
        m = self.num_microbatches
        n = ds.num_examples()
        if n % m:
            raise ValueError(f"batch {n} not divisible by {m} "
                             "microbatches")
        x, y = self._micro(ds.features), self._micro(ds.labels)
        stages = [{k: self._locals(st)[s].detach().requires_grad_(True)
                   for k, st in self.block_params.items()}
                  for s in range(len(self.devices))]
        head = {k: v.detach().requires_grad_(True)
                for k, v in self.head_params.items()}
        home = self.devices[-1]
        with torch.enable_grad():
            feats = _schedule(self._block_fn, stages, x, self.devices)
            flat = feats.reshape((-1,) + tuple(feats.shape[2:]))
            labels = y.reshape((-1,) + tuple(y.shape[2:])).to(home)
            pre = self.head_conf.preoutput(head, flat)
            score = self.head_conf.compute_score(head, labels, pre, None)
            leaves = [t for st in stages for t in st.values()] + \
                list(head.values())
            grads = torch.autograd.grad(score, leaves)
        upd, lr, it = self.updater, self.learning_rate, float(self.iteration)
        g = iter(grads)
        with torch.no_grad():
            for s in range(len(self.devices)):
                for k, st in self.block_params.items():
                    step, self.upd_state["block"][k][s] = upd.update(
                        next(g), self.upd_state["block"][k][s], lr, it)
                    st.local(self._coord(s)).sub_(step)
            for k, p in self.head_params.items():
                step, self.upd_state["head"][k] = upd.update(
                    next(g), self.upd_state["head"][k], lr, it)
                p.sub_(step)
        self.score_value = score.detach()
        self.iteration += 1

    @torch.no_grad()
    def output(self, x) -> np.ndarray:
        m = self.num_microbatches
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        pad = (-n) % m
        if pad:
            x = np.concatenate([x, x[:pad]], 0)
        stages = [{k: self._locals(st)[s]
                   for k, st in self.block_params.items()}
                  for s in range(len(self.devices))]
        feats = _schedule(self._block_fn, stages, self._micro(x),
                          self.devices)
        flat = feats.reshape((-1,) + tuple(feats.shape[2:]))
        out, _ = self.head_conf.forward(self.head_params, {}, flat)
        return out.float().cpu().numpy()[:n]
