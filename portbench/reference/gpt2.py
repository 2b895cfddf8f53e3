"""Plain PyTorch reference of GPT-2 training as the benchmark runs it
(``configs/gpt2-small.json``): learned token and position embeddings,
pre-LN blocks of causal multi-head attention and a 4x gelu(tanh) MLP,
a final LayerNorm and an output projection with a bias, scored by
softmax cross-entropy averaged over every token.

Leaves are named ``vertex.key`` as the configuration's layer graph names
them (``embed``, ``ln{i}a``, ``attn{i}``, ``ln{i}b``, ``ffn{i}``, ``lnf``,
``out``), so the benchmark can hand the same seeded weights to the
program and to this file. Each block and each slice of the head's rows
is recomputed in the backward pass (checkpointed) so that the float32
reference of a full-size batch fits beside nothing else on one card."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import q

#: rows of the head's [rows, vocab] logits formed at a time
HEAD_ROWS = 2048


def param_specs(cfg: Dict) -> List[Tuple]:
    """(vertex, key, shape, init) of every leaf, in draw order: GPT-2's
    initialization (normal 0.02, the residual projections scaled by
    1/√(2·layers), LayerNorm 1 / 0, biases 0)."""
    d, v, layers = cfg["n_embd"], cfg["vocab_size"], cfg["n_layer"]
    ff, std = cfg["n_inner"], cfg["initializer_range"]
    proj = f"normal:{std / math.sqrt(2 * layers)}"
    w = f"normal:{std}"
    specs = [("embed", "W", (v, d), w),
             ("embed", "P", (cfg["n_positions"], d), w)]
    for i in range(layers):
        specs += [(f"ln{i}a", "gamma", (d,), "ones"),
                  (f"ln{i}a", "beta", (d,), "zeros"),
                  (f"attn{i}", "Wq", (d, d), w),
                  (f"attn{i}", "Wk", (d, d), w),
                  (f"attn{i}", "Wv", (d, d), w),
                  (f"attn{i}", "Wo", (d, d), proj),
                  (f"attn{i}", "bo", (d,), "zeros"),
                  (f"ln{i}b", "gamma", (d,), "ones"),
                  (f"ln{i}b", "beta", (d,), "zeros"),
                  (f"ffn{i}", "W1", (d, ff), w),
                  (f"ffn{i}", "b1", (ff,), "zeros"),
                  (f"ffn{i}", "W2", (ff, d), proj),
                  (f"ffn{i}", "b2", (d,), "zeros")]
    specs += [("lnf", "gamma", (d,), "ones"), ("lnf", "beta", (d,), "zeros"),
              ("out", "W", (d, v), w), ("out", "b", (v,), "zeros")]
    return specs


def state_specs(cfg: Dict) -> Dict[str, Dict]:
    return {}


def _ln(x, gamma, beta, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _block(x, ga, ba, wq, wk, wv, wo, bo, gb, bb, w1, b1, w2, b2, *, heads,
           eps, precision):
    n, t, d = x.shape
    dh = d // heads
    r = lambda a: q(a, precision)
    h = r(_ln(x, ga, ba, eps))
    qh, kh, vh = (r(h @ w).view(n, t, heads, dh).transpose(1, 2)
                  for w in (wq, wk, wv))
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = r(torch.softmax(scores, dim=-1))
    att = r((probs @ vh).transpose(1, 2).reshape(n, t, d))
    x = r(x + r(att @ wo + bo))
    h = r(_ln(x, gb, bb, eps))
    u = r(F.gelu(r(h @ w1 + b1), approximate="tanh"))
    return r(x + r(u @ w2 + b2))


def _head_sum(h, w, b, ids, *, precision):
    logits = q(h @ w + b, precision)
    return (torch.logsumexp(logits, dim=-1) -
            logits.gather(1, ids[:, None])[:, 0]).sum()


def loss(cfg: Dict, params: Dict[str, Dict], state: Dict, batch,
         precision: str = "f32"):
    """(mean next-token cross-entropy, state) of ``batch`` = (input ids
    [N, T], target ids [N, T]) on ``params``, parameters, activations and
    their gradients stored in ``precision`` (``common.q``)."""
    ids, targets = batch
    n, t = ids.shape
    p = {v: {k: q(a, precision) for k, a in ps.items()}
         for v, ps in params.items()}
    eps = cfg["layer_norm_epsilon"]
    x = q(p["embed"]["W"][ids] + p["embed"]["P"][:t], precision)
    for i in range(cfg["n_layer"]):
        a, f = p[f"attn{i}"], p[f"ffn{i}"]
        x = checkpoint(_block, x, p[f"ln{i}a"]["gamma"], p[f"ln{i}a"]["beta"],
                       a["Wq"], a["Wk"], a["Wv"], a["Wo"], a["bo"],
                       p[f"ln{i}b"]["gamma"], p[f"ln{i}b"]["beta"], f["W1"],
                       f["b1"], f["W2"], f["b2"], heads=cfg["n_head"],
                       eps=eps, precision=precision, use_reentrant=False)
    h = q(_ln(x, p["lnf"]["gamma"], p["lnf"]["beta"], eps),
          precision).reshape(n * t, -1)
    rows = targets.reshape(-1)
    total = sum(checkpoint(_head_sum, h[i:i + HEAD_ROWS], p["out"]["W"],
                           p["out"]["b"], rows[i:i + HEAD_ROWS],
                           precision=precision, use_reentrant=False)
                for i in range(0, n * t, HEAD_ROWS))
    return total / (n * t), state
