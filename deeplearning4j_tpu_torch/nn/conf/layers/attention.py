"""Transformer layers (the JAX package's ``nn/conf/layers/attention.py``):
causal multi-head self-attention with its KV-cache seams, LayerNorm, the
FFN block and the token + position embedding.

Activations are [N, T, C]; the decode cache is {"k", "v"} each
[B, H, T_max, Dh] in the compute dtype. Unlike the JAX seams, which return
a new cache, the port writes the cache IN PLACE (no copy of the dominant
serving allocation per step) and returns the same dict.

Attention goes through the ``attention`` helper seam: on a CUDA tensor
that is a hand-written kernel pair, forward and backward
(``kernels/flash_forward.py`` routes by T), and it launches or raises. The
materialized softmax below runs only for CPU tensors.

``forward(..., train=True, gen=g)`` applies dropout where the JAX layers
do: on the attention input, on the FFN hidden activation and on the
embedding output, each drawn from the explicit generator ``g``."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ....kernels.layernorm import layernorm
from ....ops.activations import gelu
from ...helpers import get_helper
from ..serde import register_config
from .base import FeedForwardLayerConf

NEG = -1e30


@register_config
@dataclasses.dataclass
class SelfAttentionLayer(FeedForwardLayerConf):
    """Input [N, T, n_in] → [N, T, n_out]; n_out = num_heads * head_size.
    ``fused_qkv`` (one concatenated projection in the JAX package) computes
    the same products as three separate ones, so the port always runs
    three."""
    num_heads: int = 4
    head_size: int = 0            # inferred as n_out // num_heads
    causal: bool = False
    project_out: bool = True
    fused_qkv: bool = False

    def _head_size(self) -> int:
        return self.head_size or max(self.n_out // self.num_heads, 1)

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        inner = self.num_heads * self._head_size()
        p = {w: self._winit(gen, (self.n_in, inner), self.n_in, inner, dtype)
             for w in ("Wq", "Wk", "Wv")}
        if self.project_out:
            p["Wo"] = self._winit(gen, (inner, self.n_out), inner,
                                  self.n_out, dtype)
            p["bo"] = torch.zeros(self.n_out, device=gen.device, dtype=dtype)
        return p

    def regularizable(self):
        return ("Wq", "Wk", "Wv", "Wo")

    def _project_qkv(self, params, x):
        """x [N, T, n_in] → (q, k, v) each [N, T, H, Dh]."""
        n, t, _ = x.shape
        shape = (n, t, self.num_heads, self._head_size())
        return tuple((x @ params[w]).reshape(shape)
                     for w in ("Wq", "Wk", "Wv"))

    def _attend(self, q, k, v, mask):
        """[N, T, H, Dh] attention: the helper seam's kernel on a card, the
        materialized softmax (the JAX path, ``attention.py:88-100``) on the
        CPU. ``mask`` is the [N, T] key mask (1 real / 0 masked)."""
        helper = get_helper("attention", q.device)
        if helper is not None:
            return helper(self, q, k, v, mask)
        t = q.shape[1]
        scale = 1.0 / torch.sqrt(torch.tensor(float(self._head_size()),
                                              dtype=q.dtype))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        neg = torch.tensor(NEG, dtype=logits.dtype)
        if self.causal:
            cmask = torch.ones(t, t, dtype=torch.bool).tril()
            logits = torch.where(cmask[None, None], logits, neg)
        if mask is not None:
            keep = mask.bool()[:, None, None, :]
            logits = torch.where(keep, logits, neg)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    def _project_out(self, params, out):
        """[N, T, H, Dh] heads → activation([N, T, n_out])."""
        n, t = out.shape[:2]
        out = out.reshape(n, t, self.num_heads * self._head_size())
        if self.project_out:
            out = out @ params["Wo"] + params["bo"]
        return self.activation_fn()(out)

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        x = self.maybe_dropout(x, train=train, gen=gen)
        q, k, v = self._project_qkv(params, x)
        return self._project_out(params, self._attend(q, k, v, mask)), state

    # ---- KV-cache autoregressive decoding (models/generation.py) ----
    def init_cache(self, batch: int, t_max: int, dtype=torch.float32,
                   device="cpu") -> Dict:
        """Preallocated decode cache: {"k", "v"} each [B, H, T_max, Dh]."""
        if not self.causal:
            raise ValueError("KV-cache decoding needs causal=True "
                             "(autoregressive attention)")
        shape = (batch, self.num_heads, t_max, self._head_size())
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill_forward(self, params, x, cache: Dict, mask=None,
                        slots: Optional[torch.Tensor] = None):
        """Teacher-forced pass over the prompt [B, T, n_in] that also writes
        this layer's k/v into cache rows ``slots`` (default: rows 0..B-1)
        at positions [0, T). Attention rides the same helper seam as
        forward(). Positions beyond a row's true length carry garbage k/v
        that decode_forward's length mask never attends. Returns
        (out [B, T, n_out], cache)."""
        q, k, v = self._project_qkv(params, x)
        out = self._attend(q, k, v, mask)
        t = x.shape[1]
        kk = k.transpose(1, 2).to(cache["k"].dtype)
        vv = v.transpose(1, 2).to(cache["v"].dtype)
        if slots is None:
            cache["k"][:, :, :t] = kk
            cache["v"][:, :, :t] = vv
        else:
            cache["k"][slots, :, :t] = kk
            cache["v"][slots, :, :t] = vv
        return self._project_out(params, out), cache

    def decode_forward(self, params, x, cache: Dict, positions):
        """One decode step: x [B, 1, n_in] is the token at ``positions``
        ([B] integer tensor). Writes k/v into each row's cell and attends
        q over cache[:, :, :pos+1] through a length mask, softmax in f32
        (plain torch: the JAX package has no decode kernel either).

        Positions clamp to the cache depth: a fused decode block lets
        finished lanes overshoot their stop, and an overshooting lane
        keeps writing inside its own last cell. Returns
        (out [B, 1, n_out], cache)."""
        q, k, v = self._project_qkv(params, x)          # [B, 1, H, Dh]
        ck, cv = cache["k"], cache["v"]
        t_max = ck.shape[2]
        pos = positions.reshape(-1).clamp(max=t_max - 1)
        rows = torch.arange(x.shape[0], device=x.device)
        ck[rows, :, pos] = k[:, 0].to(ck.dtype)
        cv[rows, :, pos] = v[:, 0].to(cv.dtype)
        scale = 1.0 / math.sqrt(self._head_size())
        logits = torch.einsum("bhd,bhtd->bht", q[:, 0].float(),
                              ck.float()) * scale
        kpos = torch.arange(t_max, device=x.device)
        keep = kpos[None, :] <= pos[:, None]             # [B, T_max]
        logits = logits.masked_fill(~keep[:, None, :], NEG)
        probs = torch.softmax(logits, dim=-1)             # f32
        out = torch.einsum("bht,bhtd->bhd", probs.to(cv.dtype), cv)
        return self._project_out(params, out[:, None].to(x.dtype)), cache


@register_config
@dataclasses.dataclass
class LayerNormalization(FeedForwardLayerConf):
    """Last-axis layer norm; statistics in at least f32 whatever the
    compute dtype."""
    eps: float = 1e-5

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        d = self.n_out or self.n_in
        return {"gamma": torch.ones(d, device=gen.device, dtype=dtype),
                "beta": torch.zeros(d, device=gen.device, dtype=dtype)}

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        return layernorm(x, params["gamma"], params["beta"],
                         float(self.eps)), state


@register_config
@dataclasses.dataclass
class TransformerFeedForward(FeedForwardLayerConf):
    """Per-token MLP: gelu(x W1 + b1) W2 + b2 over [N, T, C]."""
    hidden_mult: int = 4

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        h = self.hidden_mult * self.n_in
        return {"W1": self._winit(gen, (self.n_in, h), self.n_in, h, dtype),
                "b1": torch.zeros(h, device=gen.device, dtype=dtype),
                "W2": self._winit(gen, (h, self.n_out), h, self.n_out, dtype),
                "b2": torch.zeros(self.n_out, device=gen.device,
                                  dtype=dtype)}

    def regularizable(self):
        return ("W1", "W2")

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        h = gelu(x @ params["W1"] + params["b1"])
        h = self.maybe_dropout(h, train=train, gen=gen)
        return h @ params["W2"] + params["b2"], state


@register_config
@dataclasses.dataclass
class TokenAndPositionEmbedding(FeedForwardLayerConf):
    """Token ids [N, T] → embeddings + learned positions [N, T, n_out].
    ``n_in`` is the vocabulary size."""
    max_length: int = 512

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        kw = dict(generator=gen, device=gen.device, dtype=dtype)
        return {"W": torch.randn(self.n_in, self.n_out, **kw) * 0.02,
                "P": torch.randn(self.max_length, self.n_out, **kw) * 0.02}

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        t = x.shape[1]
        if t > self.max_length:
            raise ValueError(f"sequence length {t} > max_length "
                             f"{self.max_length}")
        out = params["W"][x] + params["P"][None, :t]
        return self.maybe_dropout(out, train=train, gen=gen), state

    def embed_at(self, params, ids, positions):
        """Single-position decode embedding: ids [B] + per-row positions
        [B] → [B, 1, n_out]. Positions clamp to max_length - 1 (a fused
        decode block's overshooting lanes sit at the context edge)."""
        pos = positions.reshape(-1).clamp(max=self.max_length - 1)
        return (params["W"][ids.reshape(-1)] + params["P"][pos])[:, None, :]
