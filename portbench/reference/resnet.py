"""Plain PyTorch reference of ResNet-50 training as the benchmark runs it
(``configs/resnet50.json``): He et al.'s bottleneck network (a 7x7 / 2
stem conv, a 3x3 / 2 max-pool, stages of 1x1 / 3x3 / 1x1 blocks with the
stride on the first 1x1 and a projection shortcut opening each stage,
global average pooling, a softmax head), every convolution without a
bias and followed by batch normalization over the batch, "SAME" padding
in TensorFlow's convention (the extra row and column after), softmax
cross-entropy averaged over the batch plus ½·l2·Σw² over the
convolution and head weights.

Leaves are named ``vertex.key`` as the configuration's layer graph names
them (``stem_conv``, ``s{stage}b{block}_{a,b,c,proj}_{conv,bn}``,
``fc``); kernels are HWIO and images NHWC, as the benchmark feeds them.
Batch norm's running mean and (biased) variance are state, updated as
decay · old + (1 − decay) · batch. Each block is recomputed in the
backward pass (checkpointed) so that a float32 batch of 256 fits on one
card."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import q


def _blocks(cfg: Dict):
    """(name, mid, out, stride, project) of every bottleneck."""
    for stage, (n, (mid, out)) in enumerate(zip(cfg["blocks"],
                                                cfg["widths"])):
        for blk in range(n):
            yield (f"s{stage}b{blk}", mid, out,
                   2 if blk == 0 and stage > 0 else 1, blk == 0)


def _convs(cfg: Dict):
    """(conv-bn name, kernel, c_in, c_out, stride) of every convolution,
    in the graph's order."""
    stem = cfg["widths"][0][0]
    yield "stem", cfg["stem_kernel"], cfg["channels"], stem, \
        cfg["stem_stride"]
    c_in = stem
    for name, mid, out, stride, project in _blocks(cfg):
        yield f"{name}_a", 1, c_in, mid, stride
        yield f"{name}_b", 3, mid, mid, 1
        yield f"{name}_c", 1, mid, out, 1
        if project:
            yield f"{name}_proj", 1, c_in, out, stride
        c_in = out


def param_specs(cfg: Dict) -> List[Tuple]:
    """(vertex, key, shape, init) of every leaf, in draw order: He normal
    convolutions (std √(2 / fan-in)), batch-norm scale 1 and shift 0, a
    Glorot normal head with a zero bias."""
    specs = []
    for name, k, c_in, c_out, _ in _convs(cfg):
        specs += [(f"{name}_conv", "W", (k, k, c_in, c_out),
                   f"normal:{math.sqrt(2.0 / (k * k * c_in))}"),
                  (f"{name}_bn", "gamma", (c_out,), "ones"),
                  (f"{name}_bn", "beta", (c_out,), "zeros")]
    feat, classes = cfg["widths"][-1][1], cfg["num_classes"]
    specs += [("fc", "W", (feat, classes),
               f"normal:{math.sqrt(2.0 / (feat + classes))}"),
              ("fc", "b", (classes,), "zeros")]
    return specs


def state_specs(cfg: Dict) -> Dict[str, Dict]:
    """Each batch norm's running (mean, variance) at their start: 0 and
    1."""
    return {f"{name}_bn": {"mean": ("zeros", c_out), "var": ("ones", c_out)}
            for name, _, _, c_out, _ in _convs(cfg)}


def _same(size, k, s):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, precision):
    """NCHW x, HWIO w, SAME padding; the input's gradient, like the
    output, stored in ``precision``."""
    k = w.shape[0]
    ph, pw = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
    x = F.pad(q(x, precision), (pw[0], pw[1], ph[0], ph[1]))
    return q(F.conv2d(x, w.permute(3, 2, 0, 1), None, stride), precision)


def _bn(x, gamma, beta, eps):
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    y = (x - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
    return y * gamma[:, None, None] + beta[:, None, None], mean, var


def _bottleneck(x, *leaves, stride, project, eps, precision):
    wa, ga, ba, wb, gb, bb, wc, gc, bc = leaves[:9]
    r = lambda a: q(a, precision)
    stats = []
    h, m, v = _bn(_conv(x, wa, stride, precision), ga, ba, eps)
    stats += [m, v]
    h, m, v = _bn(_conv(r(F.relu(h)), wb, 1, precision), gb, bb, eps)
    stats += [m, v]
    h, m, v = _bn(_conv(r(F.relu(h)), wc, 1, precision), gc, bc, eps)
    stats += [m, v]
    short = x
    if project:
        wp, gp, bp = leaves[9:]
        short, m, v = _bn(_conv(x, wp, stride, precision), gp, bp, eps)
        stats += [m, v]
        short = r(short)
    return (r(F.relu(r(h) + short)), *stats)


def _stem(x, w, gamma, beta, *, stride, eps, precision):
    h, m, v = _bn(_conv(x, w, stride, precision), gamma, beta, eps)
    h = q(F.relu(h), precision)
    ph, pw = _same(h.shape[2], 3, 2), _same(h.shape[3], 3, 2)
    h = F.pad(h, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return q(F.max_pool2d(h, 3, 2), precision), m, v


def loss(cfg: Dict, params: Dict[str, Dict], state: Dict[str, Dict], batch,
         precision: str = "f32"):
    """(loss, new running statistics) of ``batch`` = (images [N, H, W, C]
    float32, class ids [N]) on ``params``, parameters, activations and
    their gradients stored in ``precision`` (``common.q``)."""
    images, labels = batch
    eps, decay = cfg["bn_eps"], cfg["bn_decay"]
    p = {v: {k: q(a, precision) for k, a in ps.items()}
         for v, ps in params.items()}
    seen = {}
    x, m, v = checkpoint(_stem, q(images.permute(0, 3, 1, 2), precision),
                         p["stem_conv"]["W"], p["stem_bn"]["gamma"],
                         p["stem_bn"]["beta"], stride=cfg["stem_stride"],
                         eps=eps, precision=precision, use_reentrant=False)
    seen["stem_bn"] = (m, v)
    for name, _, _, stride, project in _blocks(cfg):
        parts = ["a", "b", "c"] + (["proj"] if project else [])
        leaves = [t for part in parts for t in (
            p[f"{name}_{part}_conv"]["W"], p[f"{name}_{part}_bn"]["gamma"],
            p[f"{name}_{part}_bn"]["beta"])]
        x, *stats = checkpoint(_bottleneck, x, *leaves, stride=stride,
                               project=project, eps=eps, precision=precision,
                               use_reentrant=False)
        for j, part in enumerate(parts):
            seen[f"{name}_{part}_bn"] = (stats[2 * j], stats[2 * j + 1])
    pooled = q(x.mean(dim=(2, 3)), precision)
    logits = q(pooled @ p["fc"]["W"] + p["fc"]["b"], precision)
    ce = F.cross_entropy(logits, labels.long())
    l2 = cfg["training"]["l2"]
    reg = sum((params[v_]["W"] * params[v_]["W"]).sum() for v_ in params
              if "W" in params[v_])
    new_state = {bn: {"mean": decay * state[bn]["mean"] +
                      (1 - decay) * mv[0].detach(),
                      "var": decay * state[bn]["var"] +
                      (1 - decay) * mv[1].detach()}
                 for bn, mv in seen.items()}
    return ce + 0.5 * l2 * reg, new_state
