"""Plain PyTorch reference of SwinV2 training as the benchmark runs it
(``configs/swinv2-base-w16-256.json``): Liu et al.'s SwinV2 (arXiv:2111.09883)
as its published code computes it, without stochastic depth.

- Patch embedding: a p x p / p convolution with a bias, then LayerNorm.
- Each stage: blocks of windowed scaled cosine attention with res-post-norm
  (x1 = x + LN(attn(x)), x2 = x1 + LN(mlp(x1))), every second block's
  windows shifted by half a window (no shift, and the window clipped to
  the resolution, where that is at most the window); between stages the
  V2 patch merging (2 x 2 concat, a linear 4C → 2C without bias, then
  LayerNorm).
- Attention in a window of M² tokens: logits (q/‖q‖)·(k/‖k‖)ᵀ ·
  exp(min(logit_scale, ln 100)) + 16·σ(cpb), cpb an MLP (Linear 2 → 512,
  ReLU, Linear 512 → heads without bias) over the log-spaced relative
  coordinates sign(Δ)·log2(1 + 8|Δ|/(M − 1))/log2 8, gathered by the
  relative position index, plus −100 between regions of the shifted
  layout; q and v carry biases, k none. The MLP is 4x wide with the exact
  (erf) GELU.
- Head: LayerNorm, the mean over the tokens, a linear classifier, softmax
  cross-entropy averaged over the batch.

Leaves are named ``vertex.key`` as the program's graph names them
(``patch_embed``, ``patch_norm``, ``s{i}b{j}``, ``s{i}_merge``,
``head_norm``, ``fc``). The per-head ``logit_scale`` is held as ``tau``,
its offset from ln 10, so that it is drawn as zeros. Attention is a
materialised softmax over chunks of windows, each chunk and each block
recomputed in the backward pass (checkpointed), so the float32 reference
of a batch of 256 fits on one card."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import q

#: most logits ([windows, heads, M², M²] f32) one chunk of windows forms
CHUNK_LOGITS = 1 << 27
#: the leaves of a block, in draw order
BLOCK_LEAVES = ("Wqkv", "q_bias", "v_bias", "tau", "cpb_W1", "cpb_b1",
                "cpb_W2", "Wo", "bo", "ln1_gamma", "ln1_beta", "W1", "b1",
                "W2", "b2", "ln2_gamma", "ln2_beta")


def stages(cfg: Dict):
    """(stage, depth, heads, channels, resolution) of every stage."""
    res = cfg["image_size"] // cfg["patch_size"]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        yield i, depth, heads, cfg["embed_dim"] * 2 ** i, res // 2 ** i


def window(cfg: Dict, res: int, block: int) -> Tuple[int, int]:
    """(M, shift) of block ``block`` of a stage at resolution ``res``."""
    m = cfg["window_size"]
    if res <= m:
        return res, 0
    return m, m // 2 if block % 2 else 0


def param_specs(cfg: Dict) -> List[Tuple]:
    """(vertex, key, shape, init) of every leaf, in draw order (see the
    configuration's ``assumed``)."""
    c0, p = cfg["embed_dim"], cfg["patch_size"]
    ch, hid, r = cfg["channels"], cfg["cpb_hidden"], cfg["mlp_ratio"]
    w = "normal:0.02"
    specs = [("patch_embed", "W", (p, p, ch, c0),
              f"normal:{math.sqrt(1.0 / (3 * p * p * ch))}"),
             ("patch_embed", "b", (c0,), "zeros"),
             ("patch_norm", "gamma", (c0,), "ones"),
             ("patch_norm", "beta", (c0,), "zeros")]
    last = len(cfg["depths"]) - 1
    for i, depth, heads, c, _ in stages(cfg):
        shapes = {"Wqkv": ((c, 3 * c), w), "q_bias": ((c,), "zeros"),
                  "v_bias": ((c,), "zeros"), "tau": ((heads,), "zeros"),
                  "cpb_W1": ((2, hid), w), "cpb_b1": ((hid,), "zeros"),
                  "cpb_W2": ((hid, heads), w), "Wo": ((c, c), w),
                  "bo": ((c,), "zeros"), "ln1_gamma": ((c,), "ones"),
                  "ln1_beta": ((c,), "zeros"), "W1": ((c, r * c), w),
                  "b1": ((r * c,), "zeros"), "W2": ((r * c, c), w),
                  "b2": ((c,), "zeros"), "ln2_gamma": ((c,), "ones"),
                  "ln2_beta": ((c,), "zeros")}
        for j in range(depth):
            specs += [(f"s{i}b{j}", k, *shapes[k]) for k in BLOCK_LEAVES]
        if i < last:
            specs += [(f"s{i}_merge", "W", (4 * c, 2 * c), w),
                      (f"s{i}_merge", "gamma", (2 * c,), "ones"),
                      (f"s{i}_merge", "beta", (2 * c,), "zeros")]
    c = cfg["embed_dim"] * 2 ** last
    specs += [("head_norm", "gamma", (c,), "ones"),
              ("head_norm", "beta", (c,), "zeros"),
              ("fc", "W", (c, cfg["num_classes"]), w),
              ("fc", "b", (cfg["num_classes"],), "zeros")]
    return specs


def state_specs(cfg: Dict) -> Dict[str, Dict]:
    return {}


def _ln(x, gamma, beta, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _windows(x, m):
    """[N, H, W, C] → [N, nW, M², C]."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // m, m, w // m, m, c).transpose(2, 3)
    return x.reshape(n, (h // m) * (w // m), m * m, c)


def _unwindows(xw, m, h, w):
    n, _, _, c = xw.shape
    x = xw.reshape(n, h // m, w // m, m, m, c).transpose(2, 3)
    return x.reshape(n, h, w, c)


def relative_coords(m: int, device) -> torch.Tensor:
    """[(2M − 1)², 2]: the log-spaced (Δrow, Δcol) of every offset, rows
    in row-major order of (Δrow, Δcol)."""
    d = torch.arange(-(m - 1), m, device=device, dtype=torch.float32)
    grid = torch.stack([d[:, None].expand(-1, 2 * m - 1),
                        d[None, :].expand(2 * m - 1, -1)], dim=-1)
    grid = grid / (m - 1) * 8.0
    grid = torch.sign(grid) * torch.log2(grid.abs() + 1.0) / math.log2(8.0)
    return grid.reshape(-1, 2)


def relative_index(m: int, device) -> torch.Tensor:
    """[M², M²] long: the row of :func:`relative_coords` of the offset
    from key j to query i (tokens in row-major order in the window)."""
    r = torch.arange(m * m, device=device)
    row, col = r // m, r % m
    dr = row[:, None] - row[None, :] + (m - 1)
    dc = col[:, None] - col[None, :] + (m - 1)
    return dr * (2 * m - 1) + dc


def shift_mask(m: int, s: int, h: int, w: int, value: float,
               device) -> torch.Tensor:
    """[nW, M², M²]: ``value`` where query and key of a window lie in
    different regions of the shifted layout (the cuts at −M and −s on
    each axis), else 0."""
    def region(size):
        idx = torch.arange(size, device=device)
        return (idx >= size - m).long() + (idx >= size - s).long()
    lab = region(h)[:, None] * 3 + region(w)[None, :]
    lab = _windows(lab[None, :, :, None].float(), m)[0, ..., 0]  # [nW, T]
    differ = lab[:, :, None] != lab[:, None, :]
    return torch.where(differ, torch.tensor(value, device=device),
                       torch.tensor(0.0, device=device))


def _attend(qn, kn, v, bias, temp, precision):
    """Softmax attention of one chunk of windows: q̂, k̂, v [n, nW, H, T, D],
    bias [nW or 1, H, T, T], temp [H]."""
    logits = (qn @ kn.transpose(-1, -2)) * temp[:, None, None] + bias
    probs = q(torch.softmax(logits, dim=-1), precision)
    return q(probs @ v, precision)


def _block(x, *leaves, heads, m, s, eps, mask_value, max_scale,
           precision):
    (wqkv, qb, vb, tau, c1, cb1, c2, wo, bo, g1, be1, w1, b1, w2, b2, g2,
     be2) = leaves
    r = lambda a: q(a, precision)
    n, h, w, c = x.shape
    t, d = m * m, c // heads
    cpb = torch.relu(relative_coords(m, x.device) @ c1 + cb1) @ c2
    bias = 16.0 * torch.sigmoid(cpb[relative_index(m, x.device)]
                                .permute(2, 0, 1))           # [H, T, T]
    bias = bias[None]
    if s:
        bias = bias + shift_mask(m, s, h, w, mask_value,
                                 x.device)[:, None]          # [nW, H, T, T]
    xs = torch.roll(x, shifts=(-s, -s), dims=(1, 2)) if s else x
    xw = _windows(xs, m)                                     # [N, nW, T, C]
    nw = xw.shape[1]
    qkv = r(xw @ wqkv + torch.cat([qb, torch.zeros_like(vb), vb]))
    qkv = qkv.reshape(n, nw, t, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    qh, kh, vh = qkv[0], qkv[1], qkv[2]                      # [N, nW, H, T, D]
    qn, kn = F.normalize(qh, dim=-1), F.normalize(kh, dim=-1)
    temp = torch.exp(torch.clamp(tau + math.log(10.0), max=max_scale))
    per = max(1, CHUNK_LOGITS // (nw * heads * t * t))
    outs = [checkpoint(_attend, qn[i:i + per], kn[i:i + per],
                       vh[i:i + per], bias, temp, precision,
                       use_reentrant=False) for i in range(0, n, per)]
    o = torch.cat(outs).permute(0, 1, 3, 2, 4).reshape(n, nw, t, c)
    y = _unwindows(r(o @ wo + bo), m, h, w)
    if s:
        y = torch.roll(y, shifts=(s, s), dims=(1, 2))
    x1 = r(x + r(_ln(y, g1, be1, eps)))
    u = r(F.gelu(r(x1 @ w1 + b1)))
    return r(x1 + r(_ln(r(u @ w2 + b2), g2, be2, eps)))


def _merge(x, wm, gamma, beta, *, eps, precision):
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    return q(_ln(q(x @ wm, precision), gamma, beta, eps), precision)


def loss(cfg: Dict, params: Dict[str, Dict], state: Dict, batch,
         precision: str = "f32"):
    """(loss, state) of ``batch`` = (images [N, H, W, C] float32, class ids
    [N]) on ``params``, parameters, activations and their gradients stored
    in ``precision`` (``common.q``)."""
    images, labels = batch
    eps = cfg["ln_eps"]
    pk = cfg["patch_size"]
    p = {v: {k: q(a, precision) for k, a in ps.items()}
         for v, ps in params.items()}
    x = F.conv2d(q(images.permute(0, 3, 1, 2), precision),
                 p["patch_embed"]["W"].permute(3, 2, 0, 1),
                 p["patch_embed"]["b"], stride=pk)
    x = q(x.permute(0, 2, 3, 1), precision)
    x = q(_ln(x, p["patch_norm"]["gamma"], p["patch_norm"]["beta"], eps),
          precision)
    last = len(cfg["depths"]) - 1
    for i, depth, heads, _, res in stages(cfg):
        for j in range(depth):
            m, s = window(cfg, res, j)
            blk = p[f"s{i}b{j}"]
            x = checkpoint(_block, x, *(blk[k] for k in BLOCK_LEAVES),
                           heads=heads, m=m, s=s, eps=eps,
                           mask_value=float(cfg["mask_value"]),
                           max_scale=float(cfg["logit_scale_max"]),
                           precision=precision, use_reentrant=False)
        if i < last:
            mg = p[f"s{i}_merge"]
            x = checkpoint(_merge, x, mg["W"], mg["gamma"], mg["beta"],
                           eps=eps, precision=precision, use_reentrant=False)
    x = q(_ln(x, p["head_norm"]["gamma"], p["head_norm"]["beta"], eps),
          precision)
    pooled = q(x.mean(dim=(1, 2)), precision)
    logits = q(pooled @ p["fc"]["W"] + p["fc"]["b"], precision)
    return F.cross_entropy(logits, labels.long()), state
