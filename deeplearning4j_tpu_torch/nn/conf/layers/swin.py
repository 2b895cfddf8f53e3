"""SwinV2's layers (Liu et al., "Swin Transformer V2", arXiv:2111.09883)
on NHWC activations [N, H, W, C]: the block with its windowed scaled
cosine attention, the patch merging between stages and the channel
LayerNorm of the patch embedding and the head. The JAX package has no
counterpart; the published equations are in ``models/swin.py``.

A :class:`SwinV2Block` (window M, shift s, heads of D = C / heads):

1. ``x' = roll(x, (−s, −s))`` cut into windows [N·nW, M², C];
2. ``q, k, v = x'·Wqkv + [q_bias, 0, v_bias]``;
3. logits ``(q/‖q‖)·(k/‖k‖)ᵀ·exp(min(ln 10 + tau, ln 100)) + 16·σ(cpb)
   + mask``: ``cpb`` an MLP (2 → ``cpb_hidden`` → heads, ReLU) over the
   log-spaced relative coordinates, gathered by the relative index, and
   the mask ``mask_value`` between the regions of the shifted layout;
4. softmax, times v, heads merged, ``·Wo + bo``, windows put back,
   ``roll(+s, +s)``;
5. ``x1 = x + LN1(attn)``, ``x2 = x1 + LN2(W2·gelu_erf(W1·x1 + b1) + b2)``.

Where the resolution is at most M, the window is the resolution and
s = 0. The per-head temperature is held as ``tau``, its offset from
ln 10 (SwinV2's ``logit_scale`` starts at ln 10), so it starts at zero.
The coordinate table, the relative index and the shift mask are
constants of the window and the resolution, built once
(:func:`window_constants`), never leaves.

The attention runs through the ``attention_bias`` helper seam: on the card
the biased short-sequence kernels, given q̂ with the temperature folded in,
k̂ and an f32 bias [P, heads, M², M²] (P = nW with the shift mask, 1
without), at scale 1; on the CPU a materialised softmax. The bias is
built in f32 from the (compute-dtype) CPB weights and takes its gradient
through the kernel's dbias. Spans (``observability/tracing.py::phase``):
``dl4j.swin.shuffle`` (roll, partition, reverse, merge), ``dl4j.swin.bias``
(the CPB MLP, gather, sigmoid and mask) and ``dl4j.swin.attention`` (the
q / k normalisation and the kernel)."""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import torch

from ....kernels.layernorm import layernorm
from ....observability.tracing import phase
from ....ops.activations import gelu_exact
from ...helpers import get_helper
from ..input_type import InputType
from ..serde import register_config
from .base import LayerConf

#: SwinV2's logit_scale starts at ln 10; ``tau`` is its offset from that
TAU_ORIGIN = math.log(10.0)


def partition(x, m: int):
    """[N, H, W, C] → [N·nW, M², C], windows in row-major order of their
    (row, column) block within each image."""
    n, h, w, c = x.shape
    x = x.view(n, h // m, m, w // m, m, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n * (h // m) * (w // m), m * m, c)


def reverse(xw, m: int, n: int, h: int, w: int):
    """The inverse of :func:`partition`: [N·nW, M², C] → [N, H, W, C]."""
    c = xw.shape[-1]
    x = xw.view(n, h // m, w // m, m, m, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, c)


def window_of(height: int, width: int, window: int,
              shift: int) -> Tuple[int, int]:
    """(M, s) at a resolution: the window clipped to the resolution, with
    no shift, where the resolution is at most the window."""
    if min(height, width) <= window:
        return min(height, width), 0
    return window, shift


@functools.lru_cache(maxsize=None)
def window_constants(m: int, shift: int, height: int, width: int,
                     mask_value: float, device: str):
    """The block's constants at window ``m``, shift and resolution:
    (coords [(2m−1)², 2] f32: sign(Δ)·log2(1 + 8|Δ|/(m−1))/log2 8 for
    Δ = (Δrow, Δcol) ∈ [−(m−1), m−1]² in row-major order; index [m², m²]
    long: the row of coords of query i and key j within a window; mask
    [nW, m², m²] f32: ``mask_value`` between keys and queries of different
    regions of the shifted layout, else 0; None where shift is 0)."""
    if m < 2:
        raise ValueError(f"SwinV2's coordinate table needs a window of at "
                         f"least 2, got {m}")
    r = torch.arange(-(m - 1), m, dtype=torch.float32)
    table = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    table = table * (8.0 / (m - 1))
    table = torch.sign(table) * torch.log2(table.abs() + 1.0) / math.log2(8)
    c = torch.arange(m)
    pos = torch.stack(torch.meshgrid(c, c, indexing="ij")).flatten(1)
    rel = (pos[:, :, None] - pos[:, None, :]).permute(1, 2, 0) + (m - 1)
    index = rel[..., 0] * (2 * m - 1) + rel[..., 1]
    mask = None
    if shift:
        regions = torch.zeros(1, height, width, 1)
        cuts = (slice(0, -m), slice(-m, -shift), slice(-shift, None))
        for i, (hs, ws) in enumerate((a, b) for a in cuts for b in cuts):
            regions[:, hs, ws, :] = i
        win = partition(regions, m)[..., 0]                  # [nW, T]
        diff = win[:, None, :] - win[:, :, None]
        mask = torch.where(diff != 0, torch.tensor(float(mask_value)),
                           torch.tensor(0.0))
        mask = mask.to(device)
    return table.reshape(-1, 2).to(device), index.to(device), mask


class UnitRows(torch.autograd.Function):
    """y = x·s_h / max(‖x‖, 1e-12) over the last axis of [..., H, D] rows,
    with one factor a head (``s`` [H], f32): the norms and the row terms in
    f32, y and dx in x's dtype, so a bf16 x takes bf16 passes only, a
    quarter of the bytes of normalising an f32 copy."""

    @staticmethod
    def forward(ctx, x, s):
        acc = torch.promote_types(x.dtype, torch.float32)
        r = 1.0 / torch.linalg.vector_norm(x, dim=-1, keepdim=True,
                                           dtype=acc).clamp_min(1e-12)
        ctx.save_for_backward(x, s, r)
        return x * (s[:, None] * r).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        # dx = s r dy − s r³ ⟨x, dy⟩ x;  ds_h = Σ r ⟨x, dy⟩ over h's rows
        x, s, r = ctx.saved_tensors
        xdy = (x * dy).sum(-1, keepdim=True, dtype=r.dtype)
        f = s[:, None] * r
        dx = dy * f.to(x.dtype) - x * (f * r * r * xdy).to(x.dtype)
        ds = (r * xdy).reshape(-1, s.shape[0]).sum(0)
        return dx, ds


@register_config
@dataclasses.dataclass
class SwinV2Block(LayerConf):
    """One SwinV2 block on [N, H, W, C] (``n_in`` = C, out = in); see the
    module's docstring. ``shift_size`` is s before clipping (M / 2 on every
    second block of a stage, else 0)."""
    n_in: int = 0
    num_heads: int = 4
    window_size: int = 8
    shift_size: int = 0
    mlp_ratio: int = 4
    cpb_hidden: int = 512
    logit_scale_max: float = math.log(100.0)
    mask_value: float = -100.0
    eps: float = 1e-5

    def input_kind(self) -> str:
        return "cnn"

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.channels

    def get_output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        c, h, hid = self.n_in, self.num_heads, self.cpb_hidden
        ff = self.mlp_ratio * c
        zeros = lambda *s: torch.zeros(s, device=gen.device, dtype=dtype)
        ones = lambda *s: torch.ones(s, device=gen.device, dtype=dtype)
        w = lambda fi, fo: self._winit(gen, (fi, fo), fi, fo, dtype)
        return {"Wqkv": w(c, 3 * c), "q_bias": zeros(c), "v_bias": zeros(c),
                "tau": zeros(h), "cpb_W1": w(2, hid), "cpb_b1": zeros(hid),
                "cpb_W2": w(hid, h), "Wo": w(c, c), "bo": zeros(c),
                "ln1_gamma": ones(c), "ln1_beta": zeros(c), "W1": w(c, ff),
                "b1": zeros(ff), "W2": w(ff, c), "b2": zeros(c),
                "ln2_gamma": ones(c), "ln2_beta": zeros(c)}

    def regularizable(self):
        return ("Wqkv", "cpb_W1", "cpb_W2", "Wo", "W1", "W2")

    def _bias(self, params, m: int, s: int, height: int, width: int,
              device):
        """The f32 logit bias [P, heads, M², M²]: 16·σ(cpb) gathered by the
        relative index, plus the shift mask (P = nW) where there is one
        (else P = 1)."""
        table, index, mask = window_constants(m, s, height, width,
                                              float(self.mask_value),
                                              str(device))
        hid = torch.relu(table @ params["cpb_W1"].float() +
                         params["cpb_b1"].float())
        cpb = (hid @ params["cpb_W2"].float())[index.reshape(-1)]
        rel = 16.0 * torch.sigmoid(cpb.view(m * m, m * m, -1)
                                   .permute(2, 0, 1))
        if mask is None:
            return rel[None].contiguous()
        return (rel[None] + mask[:, None]).contiguous()

    def _attend(self, params, xw, bias):
        """[B_, T, C] windows → [B_, T, C] attention output (heads merged)
        under ``bias``."""
        b_, t, c = xw.shape
        h = self.num_heads
        zero = torch.zeros_like(params["v_bias"])
        qkv = xw @ params["Wqkv"] + torch.cat(
            (params["q_bias"], zero, params["v_bias"]))
        q, k, v = qkv.view(b_, t, 3, h, c // h).unbind(2)
        with phase("swin.attention"):
            temp = torch.exp(torch.clamp(params["tau"].float() + TAU_ORIGIN,
                                         max=float(self.logit_scale_max)))
            qn = UnitRows.apply(q, temp)
            kn = UnitRows.apply(k, torch.ones_like(temp))
            helper = get_helper("attention_bias", xw.device)
            if helper is not None:
                o = helper(qn, kn, v, bias, 1.0)
            else:
                logits = torch.einsum("bqhd,bkhd->bhqk", qn.float(),
                                      kn.float())
                p = bias.shape[0]
                logits = (logits.view(-1, p, h, t, t) + bias[None]).view(
                    b_, h, t, t)
                probs = torch.softmax(logits, dim=-1).to(v.dtype)
                o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return o.reshape(b_, t, c) @ params["Wo"] + params["bo"]

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        n, height, width, c = x.shape
        m, s = window_of(height, width, self.window_size, self.shift_size)
        if height % m or width % m or c % self.num_heads:
            raise ValueError(f"SwinV2 block: resolution {height}x{width} "
                             f"must be a multiple of the window {m}, and "
                             f"{c} channels of the {self.num_heads} heads")
        with phase("swin.shuffle"):
            xs = torch.roll(x, (-s, -s), (1, 2)) if s else x
            xw = partition(xs, m)
        with phase("swin.bias"):
            bias = self._bias(params, m, s, height, width, x.device)
        attn = self._attend(params, xw, bias)
        with phase("swin.shuffle"):
            y = reverse(attn, m, n, height, width)
            if s:
                y = torch.roll(y, (s, s), (1, 2))
        eps = float(self.eps)
        x1 = x + layernorm(y, params["ln1_gamma"], params["ln1_beta"], eps)
        hdn = gelu_exact(x1 @ params["W1"] + params["b1"])
        out = hdn @ params["W2"] + params["b2"]
        return x1 + layernorm(out, params["ln2_gamma"], params["ln2_beta"],
                              eps), state


@register_config
@dataclasses.dataclass
class PatchMerging(LayerConf):
    """SwinV2's patch merging (its V2 order: reduce, then norm): [N, H, W,
    C] → concat(x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2])
    [N, H/2, W/2, 4C] → ``·W`` (no bias) → LayerNorm → [N, H/2, W/2,
    n_out] (n_out 2C by default)."""
    n_in: int = 0
    n_out: int = 0
    eps: float = 1e-5

    def input_kind(self) -> str:
        return "cnn"

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.channels
        if not self.n_out:
            self.n_out = 2 * self.n_in

    def get_output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(it.height // 2, it.width // 2,
                                       self.n_out)

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        fi = 4 * self.n_in
        return {"W": self._winit(gen, (fi, self.n_out), fi, self.n_out,
                                 dtype),
                "gamma": torch.ones(self.n_out, device=gen.device,
                                    dtype=dtype),
                "beta": torch.zeros(self.n_out, device=gen.device,
                                    dtype=dtype)}

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        if x.shape[1] % 2 or x.shape[2] % 2:
            raise ValueError(f"patch merging needs an even resolution, got "
                             f"{x.shape[1]}x{x.shape[2]}")
        with phase("swin.shuffle"):
            x = torch.cat((x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                           x[:, 0::2, 1::2], x[:, 1::2, 1::2]), dim=-1)
        return layernorm(x @ params["W"], params["gamma"], params["beta"],
                         float(self.eps)), state


@register_config
@dataclasses.dataclass
class ChannelLayerNorm(LayerConf):
    """LayerNorm over the channels of NHWC activations [N, H, W, C] (the
    patch embedding's norm and the head's); statistics in f32."""
    n_in: int = 0
    eps: float = 1e-5

    def input_kind(self) -> str:
        return "cnn"

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.channels

    def get_output_type(self, it: InputType) -> InputType:
        return it

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {"gamma": torch.ones(self.n_in, device=gen.device,
                                    dtype=dtype),
                "beta": torch.zeros(self.n_in, device=gen.device,
                                    dtype=dtype)}

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        return layernorm(x, params["gamma"], params["beta"],
                         float(self.eps)), state
