"""Expert parallelism: a Mixture-of-Experts layer whose experts shard over
an ``ep`` mesh axis (the JAX package's ``parallel/expert.py``).

Routing is Switch top-1 over a capacity-bounded buffer, as dense one-hot
dispatch / combine products with static shapes: each token goes to the
expert of its largest gate (the first such expert on a tie), at most
``ceil(N / E · capacity_factor)`` tokens an expert, overflow tokens get a
zero expert output. ``MixtureOfExpertsLayer`` is an ordinary layer
configuration (JSON under the JAX package's ``@type``, so JAX's
configurations and ``coefficients.npz`` load). ``ep_param_specs`` and
:class:`ExpertParallelTrainer` shard the expert-stacked leaves ``We1`` /
``be1`` / ``We2`` / ``be2`` over ``ep``: shard e computes its experts'
FFNs on the tokens dispatched to them, and the combine sums the shards'
outputs in expert order (``tensor.py``'s sharded forward)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from ..nn.conf.layers.base import FeedForwardLayerConf
from ..nn.conf.serde import register_config
from .mesh import Mesh, P, make_mesh
from .tensor import ShardedTrainer


@register_config
@dataclasses.dataclass
class MixtureOfExpertsLayer(FeedForwardLayerConf):
    """Top-1 (Switch) routed FFN: x [N, n_in] (or [N, T, n_in]) → [N,
    n_out]: ``num_experts`` two-layer FFNs of width ``expert_hidden``
    (default 4 · n_in); ``router_jitter`` adds Gaussian noise to the
    router logits in training, drawn from the layer's generator."""
    num_experts: int = 4
    expert_hidden: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0

    def _hidden(self) -> int:
        return self.expert_hidden or 4 * self.n_in

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        e, d, h = self.num_experts, self.n_in, self._hidden()
        zeros = lambda *s: torch.zeros(s, device=gen.device, dtype=dtype)
        return {"Wg": self._winit(gen, (d, e), d, e, dtype),
                "We1": self._winit(gen, (e, d, h), d, h, dtype),
                "be1": zeros(e, h),
                "We2": self._winit(gen, (e, h, self.n_out), h, self.n_out,
                                   dtype),
                "be2": zeros(e, self.n_out)}

    def regularizable(self):
        return ("We1", "We2")

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(math.ceil(
            n_tokens / self.num_experts * self.capacity_factor)))

    def uses_dropout(self) -> bool:
        return super().uses_dropout() or bool(self.router_jitter)

    def route(self, params, x, train=False, gen=None):
        """(dispatch, combine), each [N, E, C]: token n's slot c in expert
        e's buffer (combine weighted by the token's gate)."""
        e = self.num_experts
        cap = self.capacity(x.shape[0])
        logits = x @ params["Wg"]
        if train and self.router_jitter and gen is not None:
            logits = logits + self.router_jitter * torch.randn(
                logits.shape, generator=gen, device=logits.device,
                dtype=logits.dtype)
        gates = torch.softmax(logits, dim=-1)
        expert_idx = torch.argmax(gates, dim=-1)         # first on a tie
        gate_val = gates.amax(dim=-1)
        onehot = torch.nn.functional.one_hot(expert_idx, e).to(x.dtype)
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
        keep = (pos >= 0) & (pos < cap)
        pos_oh = torch.nn.functional.one_hot(
            pos.clamp(0, cap - 1).long(), cap).to(x.dtype)
        dispatch = pos_oh * keep.to(x.dtype)[..., None]
        return dispatch, dispatch * gate_val[:, None, None]

    def experts(self, p, dispatch, combine, x):
        """The experts of ``p`` (We1 / be1 / We2 / be2 stacked on their
        leading axis) on the tokens ``dispatch`` sends them, combined:
        [N, n_out]."""
        expert_in = torch.einsum("nec,nd->ecd", dispatch, x)
        h = self.activation_fn()(
            torch.einsum("ecd,edh->ech", expert_in, p["We1"]) +
            p["be1"][:, None, :])
        out = torch.einsum("ech,eho->eco", h, p["We2"]) + \
            p["be2"][:, None, :]
        return torch.einsum("nec,eco->no", combine, out)

    #: its routing reads the whole batch (capacity and buffer positions
    #: of the global batch, as JAX routes it): a sharded walk routes the
    #: shards' rows together (``route_global``)
    routes_globally = True

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        routing = self.route(params, x.reshape(-1, x.shape[-1]), train, gen)
        return self.apply_experts([params], x, routing), state

    def route_global(self, params, xs, train=False, gen=None):
        """The routing of several shards' rows ([N_s, n_in] each) as one
        batch, split back into each shard's (dispatch, combine) on its
        device."""
        home = xs[0].device
        dispatch, combine = self.route(
            params, torch.cat([x.to(home) for x in xs]), train, gen)
        out, start = [], 0
        for x in xs:
            rows = slice(start, start + x.shape[0])
            out.append((dispatch[rows].to(x.device),
                        combine[rows].to(x.device)))
            start += x.shape[0]
        return out

    def apply_experts(self, shards: List[Dict], x, routing):
        """The experts split over ``shards`` (each a dict of its experts'
        We1 / be1 / We2 / be2 on its device, experts in order) on x ([N,
        n_in] or [N, T, n_in]) routed by ``routing``; the shards' outputs
        summed in shard order on x's device."""
        seq = x.dim() == 3
        x2 = x.reshape(-1, x.shape[-1])
        dispatch, combine = routing
        per = self.num_experts // len(shards)
        y = None
        for s, p in enumerate(shards):
            dev = p["We1"].device
            cut = slice(s * per, (s + 1) * per)
            part = self.experts(p, dispatch[:, cut].to(dev),
                                combine[:, cut].to(dev), x2.to(dev))
            y = part.to(x.device) if y is None else y + part.to(x.device)
        return y.reshape(x.shape[0], x.shape[1], -1) if seq else y

    def load_balance_loss(self, params, x) -> torch.Tensor:
        """Switch aux loss: E · Σ_e(fraction of tokens_e · mean gate_e)."""
        if x.dim() == 3:
            x = x.reshape(-1, x.shape[-1])
        gates = torch.softmax(x @ params["Wg"], dim=-1)
        frac = torch.nn.functional.one_hot(
            torch.argmax(gates, -1), self.num_experts).to(x.dtype).mean(0)
        return self.num_experts * (frac * gates.mean(0)).sum()


def ep_param_specs(net, expert_axis: str = "ep") -> List[dict]:
    """Shard every MoE layer's expert-stacked leaves over ``expert_axis``."""
    net._ensure_init()
    return [{"We1": P(expert_axis, None, None), "be1": P(expert_axis, None),
             "We2": P(expert_axis, None, None), "be2": P(expert_axis, None)}
            if isinstance(layer, MixtureOfExpertsLayer) else {}
            for layer in net.layers]


class ExpertParallelTrainer(ShardedTrainer):
    """EP (optionally × DP): experts sharded over ``ep``, batch over
    ``data``."""

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 expert_axis: str = "ep", batch_axis: str = "data"):
        if mesh is None:
            mesh = make_mesh(axis_names=("data", "ep"),
                             shape=(1, torch.cuda.device_count()))
        net._ensure_init()
        super().__init__(net, mesh, ep_param_specs(net, expert_axis),
                         batch_axis)
