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
materialized softmax below runs only for CPU tensors. The cache seams
(decode, chunk windows, and the paged pool [P, H, page_size, Dh] read
through per-slot page tables) are length-masked plain attention on every
device, as in the JAX package, which has no kernel for them either.

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
from ..input_type import InputType
from .base import BaseRecurrentLayerConf

NEG = -1e30


@register_config
@dataclasses.dataclass
class SelfAttentionLayer(BaseRecurrentLayerConf):
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

    # graftlint: hot
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

    # graftlint: hot
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

    # graftlint: hot
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
        pos = positions.reshape(-1).clamp(max=ck.shape[2] - 1)
        rows = torch.arange(x.shape[0], device=x.device)
        ck[rows, :, pos] = k[:, 0].to(ck.dtype)
        cv[rows, :, pos] = v[:, 0].to(cv.dtype)
        out = self._decode_attend(q, ck, cv, pos)
        return self._project_out(params, out.to(x.dtype)), cache

    def _decode_attend(self, q, ck, cv, pos):
        """q [B, 1, H, Dh] over keys [B, H, T, Dh] at positions <= pos
        [B]; scores and softmax in f32. Returns [B, 1, H, Dh] in cv's
        dtype."""
        scale = 1.0 / math.sqrt(self._head_size())
        logits = torch.einsum("bhd,bhtd->bht", q[:, 0].float(),
                              ck.float()) * scale
        kpos = torch.arange(ck.shape[2], device=q.device)
        keep = kpos[None, :] <= pos[:, None]             # [B, T]
        logits = logits.masked_fill(~keep[:, None, :], NEG)
        probs = torch.softmax(logits, dim=-1)             # f32
        return torch.einsum("bht,bhtd->bhd", probs.to(cv.dtype),
                            cv)[:, None]

    def _window_attend(self, q, ck, cv, qpos):
        """Window queries q [B, C, H, Dh] over keys [B, H, T, Dh], query i
        seeing positions <= qpos[:, i]; scores and softmax in f32. Returns
        [B, C, H, Dh] in cv's dtype."""
        scale = 1.0 / math.sqrt(self._head_size())
        logits = torch.einsum("bqhd,bhtd->bhqt", q.float(),
                              ck.float()) * scale
        kpos = torch.arange(ck.shape[2], device=q.device)
        keep = kpos[None, None, :] <= qpos[:, :, None]   # [B, C, T]
        logits = logits.masked_fill(~keep[:, None], NEG)
        probs = torch.softmax(logits, dim=-1)             # f32
        return torch.einsum("bhqt,bhtd->bqhd", probs.to(cv.dtype), cv)

    # graftlint: hot
    def chunk_forward(self, params, x, cache: Dict, pos0, valid=None):
        """A window of C tokens x [B, C, n_in] whose first token sits at
        absolute position ``pos0`` ([B] integer tensor): writes the
        window's k/v into the cache and attends query i over
        cache[:, :, :pos0+i+1], so earlier context is read back through
        the cache decode_forward uses. Returns (out [B, C, n_out], cache).

        ``valid=None``: ``pos0`` is clamped so the window fits the cache
        (the window slides left over filled cells) and every cell is
        written. ``valid`` ([B]) given: ``pos0`` is not clamped and only
        cells [pos0, pos0 + valid) below the cache depth are written; a
        row with valid 0 (a frozen lane) writes nothing. The JAX package
        drops the other cells with an out-of-range scatter; the slab has
        no trash cell, so here each of them rewrites its row's spare cell
        (pos0 - 1, or pos0 + valid when pos0 is 0) with the value that
        cell already holds. No kept cell of the row is the spare cell, so
        no two writes of different values meet in one cell."""
        q, k, v = self._project_qkv(params, x)           # [B, C, H, Dh]
        ck, cv = cache["k"], cache["v"]
        b, c = x.shape[:2]
        t_max = ck.shape[2]
        if c > t_max:
            raise ValueError(f"window of {c} > cache depth {t_max}")
        rows = torch.arange(b, device=x.device)
        cols = torch.arange(c, device=x.device)[None, :]
        kk, vv = k.to(ck.dtype), v.to(cv.dtype)
        if valid is None:
            w = pos0.reshape(-1).clamp(0, t_max - c)[:, None] + cols
            idx = w
        else:
            p0 = pos0.reshape(-1)
            n = valid.reshape(-1)
            w = p0[:, None] + cols
            keep = (cols < n[:, None]) & (w < t_max)
            spare = torch.where(p0 > 0, p0 - 1, p0 + n).clamp(max=t_max - 1)
            keep4 = keep[:, :, None, None]
            kk = torch.where(keep4, kk, ck[rows, :, spare][:, None])
            vv = torch.where(keep4, vv, cv[rows, :, spare][:, None])
            idx = torch.where(keep, w, spare[:, None])
        ck[rows[:, None], :, idx] = kk
        cv[rows[:, None], :, idx] = vv
        out = self._window_attend(q, ck, cv, w)
        return self._project_out(params, out.to(x.dtype)), cache

    # ---- paged KV cache (models/paging.py + models/generation.py) ----
    def init_page_pool(self, num_pages: int, page_size: int,
                       dtype=torch.float32, device="cpu") -> Dict:
        """Paged decode cache: {"k", "v"} each [P, H, page_size, Dh], a
        pool of pages shared by every slot and addressed through per-slot
        page tables. Page 0 is the reserved null page: unmapped table
        entries and redirected writes land there, and length masks keep
        it from being attended."""
        if not self.causal:
            raise ValueError("KV-cache decoding needs causal=True "
                             "(autoregressive attention)")
        shape = (num_pages, self.num_heads, page_size, self._head_size())
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    # graftlint: hot
    def _paged_gather(self, pool, ptable):
        """Page table [B, NP] → the rows' contiguous logical view
        [B, H, NP*page_size, Dh] (entry j covers positions [j*ps,
        (j+1)*ps)), so the attention after it is the slab's."""
        b, n_pages = ptable.shape
        g = pool[ptable]                          # [B, NP, H, ps, Dh]
        return g.permute(0, 2, 1, 3, 4).reshape(
            b, self.num_heads, n_pages * pool.shape[2], -1)

    # graftlint: hot
    def paged_decode_forward(self, params, x, pool: Dict, ptable,
                             positions):
        """One decode step over a paged cache: x [B, 1, n_in] at
        ``positions`` [B], page tables ``ptable`` [B, NP]. Writes each
        row's k/v into the page its table maps for that position (a row
        whose table is redirected to the null page writes there), then
        attends over the gathered view with decode_forward's math, so the
        logits equal the slab path's. Returns (out [B, 1, n_out],
        pool)."""
        q, k, v = self._project_qkv(params, x)          # [B, 1, H, Dh]
        pk, pv = pool["k"], pool["v"]
        ps = pk.shape[2]
        pos = positions.reshape(-1).clamp(max=ptable.shape[1] * ps - 1)
        rows = torch.arange(x.shape[0], device=x.device)
        pids = ptable[rows, pos // ps]
        offs = pos % ps
        pk[pids, :, offs] = k[:, 0].to(pk.dtype)
        pv[pids, :, offs] = v[:, 0].to(pv.dtype)
        out = self._decode_attend(q, self._paged_gather(pk, ptable),
                                  self._paged_gather(pv, ptable), pos)
        return self._project_out(params, out.to(x.dtype)), pool

    # graftlint: hot
    def paged_chunk_forward(self, params, x, pool: Dict, ptable, pos0,
                            valid=None):
        """A window x [B, C, n_in] starting at absolute position ``pos0``
        [B] over a paged cache. Writes the window's k/v through the page
        tables (positions below ``pos0`` are never written, which keeps
        mapped shared pages read-only) and attends query i over the
        gathered view at positions <= pos0 + i. Cells at or past
        ``valid`` [B] (default the whole window) or past the table's
        reach go to the null page. Returns (out [B, C, n_out], pool)."""
        q, k, v = self._project_qkv(params, x)          # [B, C, H, Dh]
        w = self._paged_write(pool, ptable, k, v, pos0, valid)
        out = self._window_attend(q, self._paged_gather(pool["k"], ptable),
                                  self._paged_gather(pool["v"], ptable), w)
        return self._project_out(params, out.to(x.dtype)), pool

    def _paged_write(self, pool: Dict, ptable, k, v, pos0, valid):
        """Write a window's k / v [B, C, H, Dh] through the page tables at
        absolute positions pos0 + i (cells at or past ``valid`` or past
        the table's reach go to the null page). Returns the positions
        [B, C]."""
        pk, pv = pool["k"], pool["v"]
        c = k.shape[1]
        ps = pk.shape[2]
        n_pages = ptable.shape[1]
        cols = torch.arange(c, device=k.device)[None, :]
        w = pos0.reshape(-1)[:, None] + cols             # [B, C]
        keep = w < n_pages * ps
        if valid is not None:
            keep = keep & (cols < valid.reshape(-1)[:, None])
        pids = torch.gather(ptable, 1, (w // ps).clamp(max=n_pages - 1))
        pids = torch.where(keep, pids, 0)                # null-page redirect
        offs = torch.where(keep, w % ps, 0)
        pk[pids, :, offs] = k.to(pk.dtype)
        pv[pids, :, offs] = v.to(pv.dtype)
        return w

    # graftlint: hot
    def paged_prefill_forward(self, params, x, pool: Dict, ptable,
                              pos0=None, valid=None, fresh: bool = False):
        """Prompt prefill into pages: one window starting at each row's
        ``pos0`` (0 for a fresh prompt, the shared-prefix length after a
        prefix-cache hit), i.e. :meth:`paged_chunk_forward`. ``fresh``
        (every row starts at 0, known on the host): the window's queries
        attend only the window's own keys, so the attention is causal
        self-attention under the key mask ``valid`` and, where the device
        has an attention helper (a card), goes through it as the slab's
        prefill does; the k / v are written through the tables all the
        same."""
        if pos0 is None:
            pos0 = torch.zeros(x.shape[0], dtype=torch.long,
                               device=x.device)
        helper = get_helper("attention", x.device) if fresh else None
        if helper is None:
            return self.paged_chunk_forward(params, x, pool, ptable, pos0,
                                            valid)
        q, k, v = self._project_qkv(params, x)
        self._paged_write(pool, ptable, k, v, pos0, valid)
        mask = None
        if valid is not None:
            mask = (torch.arange(x.shape[1], device=x.device)[None, :] <
                    valid.reshape(-1)[:, None]).float()
        return self._project_out(params, helper(self, q, k, v, mask)), pool


@register_config
@dataclasses.dataclass
class LayerNormalization(BaseRecurrentLayerConf):
    """Last-axis layer norm; statistics in at least f32 whatever the
    compute dtype."""
    eps: float = 1e-5

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.size
        if not self.n_out:
            self.n_out = self.n_in

    def get_output_type(self, it: InputType) -> InputType:
        return it

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
class TransformerFeedForward(BaseRecurrentLayerConf):
    """Per-token MLP: gelu(x W1 + b1) W2 + b2 over [N, T, C]."""
    hidden_mult: int = 4

    def set_n_in(self, it: InputType) -> None:
        if not self.n_in:
            self.n_in = it.size
        if not self.n_out:
            self.n_out = self.n_in

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
class TokenAndPositionEmbedding(BaseRecurrentLayerConf):
    """Token ids [N, T], or one-hot [N, T, V], → embeddings + learned
    positions [N, T, n_out]. ``n_in`` is the vocabulary size."""
    max_length: int = 512

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        kw = dict(generator=gen, device=gen.device, dtype=dtype)
        return {"W": torch.randn(self.n_in, self.n_out, **kw) * 0.02,
                "P": torch.randn(self.max_length, self.n_out, **kw) * 0.02}

    def forward(self, params, state, x, mask=None, *, train=False,
                gen=None):
        ids = x.long()
        if ids.dim() == 3:                 # one-hot [N, T, V]
            ids = ids.argmax(-1)
        t = ids.shape[1]
        if t > self.max_length:
            raise ValueError(f"sequence length {t} > max_length "
                             f"{self.max_length}")
        out = params["W"][ids] + params["P"][None, :t]
        return self.maybe_dropout(out, train=train, gen=gen), state

    # graftlint: hot
    def embed_at(self, params, ids, positions):
        """Single-position decode embedding: ids [B] + per-row positions
        [B] → [B, 1, n_out]. Positions clamp to max_length - 1 (a fused
        decode block's overshooting lanes sit at the context edge)."""
        pos = positions.reshape(-1).clamp(max=self.max_length - 1)
        return (params["W"][ids.reshape(-1)] + params["P"][pos])[:, None, :]

    # graftlint: hot
    def embed_chunk(self, params, ids, pos0):
        """Window embedding: ids [B, C] at absolute positions pos0 + [0, C)
        per row (``pos0`` [B]), positions clamped to max_length - 1 →
        [B, C, n_out]."""
        c = ids.shape[1]
        pos = (pos0.reshape(-1)[:, None] +
               torch.arange(c, device=ids.device)[None, :]).clamp(
                   max=self.max_length - 1)
        return params["W"][ids.long()] + params["P"][pos]
