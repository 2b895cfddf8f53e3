"""What the plain references share: the precision a forward is computed
in, the update rules a configuration names, and seeded parameters made
from a list of leaf specs.

Nothing here, or anywhere under ``portbench/reference/``, imports the
program under test or JAX. A reference is given the benchmark's inputs
(the weights from the seed, the batches) and works out everything else
itself.

``precision`` is the type every parameter copy, activation and
activation gradient is stored in between operations: "f32" (the
reference: float32 with TF32 off), "bf16" (rounded to bfloat16, as the
program stores them) or "fp8" (rounded to float8 e4m3 with a per-tensor
scale: the control, one step below the program's bfloat16). Products
accumulate, and normalizations, softmax, losses and updates compute, in
float32 whatever the precision; the master weights and the optimizer's
state are float32."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

#: the largest finite float8 e4m3 magnitude
_E4M3_MAX = 448.0


def set_strict_f32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if precision == "fp8":
        scale = _E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    if precision == "f32":
        return x
    raise ValueError(f"unknown precision {precision!r}")


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return _round(x, precision)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.precision), None


def q(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` stored in ``precision``: rounded in the forward pass, and the
    gradient that flows back through it rounded the same way."""
    if precision == "f32":
        return x
    return _Rounded.apply(x, precision)


# ------------------------------------------------------------ parameters
def leaf_count(specs: Iterable[Tuple]) -> int:
    return sum(math.prod(shape) for _, _, shape, _ in specs)


def make_params(specs: List[Tuple], seed: int, device) -> Dict[str, Dict]:
    """{vertex: {key: float32 tensor}} from ``specs`` (vertex, key, shape,
    init) with init "normal:<std>", "ones" or "zeros": one draw of every
    normal number from a generator on ``device`` seeded with ``seed``,
    then each leaf a view of it scaled or filled in place."""
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(leaf_count(specs), generator=g, device=device,
                       dtype=torch.float32)
    out: Dict[str, Dict] = {}
    at = 0
    for vertex, key, shape, init in specs:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        at += n
        if init == "ones":
            leaf.fill_(1.0)
        elif init == "zeros":
            leaf.zero_()
        elif init.startswith("normal:"):
            leaf.mul_(float(init.split(":", 1)[1]))
        else:
            raise ValueError(f"unknown init {init!r} for {vertex}.{key}")
        out.setdefault(vertex, {})[key] = leaf
    return out


# --------------------------------------------------------------- updaters
class Adam:
    """Deeplearning4j's Adam: both bias corrections folded into the step
    size, ε added outside the un-corrected √v."""

    def __init__(self, lr, beta1=0.9, beta2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps

    def init(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def step(self, p, g, s, iteration):
        t = iteration + 1.0
        s["m"] = self.b1 * s["m"] + (1.0 - self.b1) * g
        s["v"] = self.b2 * s["v"] + (1.0 - self.b2) * g * g
        alpha = self.lr * math.sqrt(1.0 - self.b2 ** t) / \
            (1.0 - self.b1 ** t)
        p.sub_(alpha * s["m"] / (torch.sqrt(s["v"]) + self.eps))

    def first_gradient(self, s, lr=None):
        """The gradient of step 1 worked out from the state after it."""
        return s["m"] / (1.0 - self.b1)


class Nesterovs:
    """Deeplearning4j's Nesterov momentum in its look-ahead form:
    v ← μ·v − lr·g, p ← p − (μ·v_prev − (1 + μ)·v)."""

    def __init__(self, lr, momentum=0.9):
        self.lr, self.mu = lr, momentum

    def init(self, p):
        return {"v": torch.zeros_like(p)}

    def step(self, p, g, s, iteration):
        v_prev = s["v"]
        s["v"] = self.mu * v_prev - self.lr * g
        p.sub_(self.mu * v_prev - (1.0 + self.mu) * s["v"])

    def first_gradient(self, s, lr=None):
        return -s["v"] / self.lr


def updater_of(cfg: Dict):
    """The update rule a configuration file states under ``training``."""
    t = cfg["training"]
    name = t["updater"]
    if name == "adam":
        return Adam(t["learning_rate"], t["adam_beta1"], t["adam_beta2"],
                    t["adam_epsilon"])
    if name == "nesterovs":
        return Nesterovs(t["learning_rate"], t["momentum"])
    raise ValueError(f"no reference update rule for {name!r}")


# ---------------------------------------------------------------- driving
def train_readings(model, cfg: Dict, params: Dict[str, Dict],
                   state: Dict[str, Dict], batches, precision: str):
    """Drive ``model`` (a reference module: ``loss(cfg, params, state,
    batch, precision) -> (loss, new_state)``) through one training step a
    batch, in float32 on ``params`` (updated in place) and ``state``.
    Returns the readings the comparison takes: each step's loss, each
    leaf's first gradient and each leaf's change from its start (batch
    norm's running statistics as leaves of their own)."""
    upd = updater_of(cfg)
    start = {v: {k: p.detach().clone() for k, p in ps.items()}
             for v, ps in params.items()}
    start_state = {v: {k: s.clone() for k, s in st.items()}
                   for v, st in state.items()}
    opt = {v: {k: upd.init(p) for k, p in ps.items()}
           for v, ps in params.items()}
    losses, grads = [], {}
    for i, batch in enumerate(batches):
        leaves = {v: {k: p.detach().requires_grad_(True)
                      for k, p in ps.items()} for v, ps in params.items()}
        loss, state = model.loss(cfg, leaves, state, batch, precision)
        flat = [(v, k) for v, ps in leaves.items() for k in ps]
        gs = torch.autograd.grad(loss, [leaves[v][k] for v, k in flat])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for (v, k), g in zip(flat, gs):
                if i == 0:
                    grads[f"{v}.{k}"] = float(g.norm())
                upd.step(params[v][k], g, opt[v][k], float(i))
        del leaves, gs, loss
    change = {f"{v}.{k}": float((params[v][k] - start[v][k]).norm())
              for v in params for k in params[v]}
    change.update({f"{v}.{k}": float((state[v][k] -
                                      start_state[v][k]).norm())
                   for v in state for k in state[v]})
    return {"losses": losses, "grads": grads, "change": change}


def make_state(specs: Dict[str, Dict], device) -> Dict[str, Dict]:
    """{vertex: {key: float32 tensor}} from a reference's ``state_specs``
    ({vertex: {key: ("zeros" | "ones", size)}})."""
    fill = {"zeros": torch.zeros, "ones": torch.ones}
    return {v: {k: fill[init](n, device=device, dtype=torch.float32)
                for k, (init, n) in st.items()}
            for v, st in specs.items()}
