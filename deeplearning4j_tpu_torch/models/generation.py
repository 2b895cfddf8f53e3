"""KV-cache autoregressive decoding and slot-based continuous batching (the
JAX package's ``models/generation.py``: the slab cache, the paged cache
with its prefix cache, and speculative decoding).

- :class:`TransformerDecoder` runs a causal decoder-only ComputationGraph
  with a preallocated [B, H, T_max, Dh] cache per attention layer (the
  slab) or a pool of [P, H, page_size, Dh] pages read through per-slot
  page tables (paged): ``prefill`` / ``prefill_slots`` (one ordinary
  forward over the padded prompts; attention goes through the helper
  seam, i.e. a hand-written kernel on the card), ``paged_prefill`` (tail
  windows straight into pages), ``decode_step``, ``decode_block`` /
  ``paged_decode_block`` (K decode steps dispatched back to back with the
  stop flags and positions kept on the device), ``verify_block`` /
  ``paged_verify_block`` (one forward over a drafted window with the
  acceptance on the device), ``kv_export`` / ``kv_import`` (page frames).
  ``generate`` pipelines blocks with one host readback per block.
- :class:`SlotGenerationEngine` serves a request queue over ``num_slots``
  lanes: batched pow2-bucketed admission with one readback per admission,
  the double-buffered block pipeline (block t+1 is dispatched from the
  on-device carry before block t's tokens are read back), refill of freed
  slots, ``max_pending`` shedding. ``paged=True`` maps pages lazily,
  shares resident prompt prefixes and preempts under pool pressure;
  ``speculative=True`` drafts with :class:`~.speculative.NGramDrafter`
  and verifies K drafts a block.

A JAX ``scan`` becomes a Python loop of device launches that never waits
for the device; ``jit`` has no counterpart here. Caches and pools are
updated in place. Selection: greedy (argmax of f32 logits) where a row's
temperature is <= 0, else Gumbel-max sampling from bf16-ROUNDED logits
with a generator seeded per ABSOLUTE step (a Philox generator on the
card), so a fixed seed gives the same tokens for every block size K.

Not in this slice: chunked prefill scheduling, EDF/headroom, adaptive K,
deadlines/cancel, sentinel and page verification, disaggregated handoff,
journal, tracing/metrics, supervisor and mesh."""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.conf.layers import SelfAttentionLayer, TokenAndPositionEmbedding
from ..nn.graph.vertices import LayerVertex
from ..ops import rng as rngmod
from ..ops.transfer import device_fetch, start_fetch, to_device
from ..parallel.faults import RejectedError
from .paging import PageAllocator
from .speculative import NGramDrafter

#: seed salts: the engine's decode and admission selections never share a
#: seed with each other or with TransformerDecoder.generate's
ENGINE_KEY_SALT = 1 << 20
PREFILL_BATCH_SALT = 1 << 21

_ENGINE_COUNTERS = ("emitted_tokens", "completed", "decode_steps",
                    "decode_blocks", "host_readbacks", "prefills",
                    "prefill_batches", "rejected", "failed",
                    "page_preempted", "prefix_cache_hits",
                    "prefix_cache_misses", "prefix_cache_hit_tokens",
                    "spec_blocks", "spec_drafted", "spec_accepted_tokens",
                    "spec_emitted_tokens", "spec_fallbacks")


def _round_up_pow2(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class TransformerDecoder:
    """Cache-aware executor for a causal decoder-only ComputationGraph.

    ``t_max`` bounds the context (prompt + generated) a cache row holds;
    it defaults to the embedding's max_length and may not exceed it. The
    decoder runs on the net's device, in the net's compute dtype."""

    def __init__(self, net, t_max: Optional[int] = None):
        net._ensure_init()
        self.net = net
        self.device = net.device
        conf = net.conf
        if len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1:
            raise ValueError("TransformerDecoder needs a single-input, "
                             "single-output graph")
        self.input_name = conf.network_inputs[0]
        self.output_name = conf.network_outputs[0]
        self.attn_names: List[str] = []
        embed = None
        for name in conf.topological_order:
            v = conf.vertices[name]
            if not isinstance(v, LayerVertex):
                continue
            if v.preprocessor is not None:
                raise ValueError(f"vertex '{name}' has a preprocessor; the "
                                 "decode walk supports plain transformer "
                                 "topologies only")
            if isinstance(v.layer, SelfAttentionLayer):
                if not v.layer.causal:
                    raise ValueError(f"attention vertex '{name}' is not "
                                     "causal — cannot decode "
                                     "autoregressively")
                self.attn_names.append(name)
            elif isinstance(v.layer, TokenAndPositionEmbedding):
                embed = v.layer
        if embed is None or not self.attn_names:
            raise ValueError("graph has no TokenAndPositionEmbedding / "
                             "causal SelfAttentionLayer — not a decoder LM")
        out_v = conf.vertices[self.output_name]
        if not (isinstance(out_v, LayerVertex) and
                hasattr(out_v.layer, "preoutput")):
            raise ValueError("output vertex must be a projection head "
                             "(RnnOutputLayer)")
        self.embed = embed
        if t_max is None:
            t_max = embed.max_length
        if t_max > embed.max_length:
            raise ValueError(f"t_max {t_max} > embedding max_length "
                             f"{embed.max_length}")
        self.t_max = int(t_max)
        self.vocab_size = out_v.layer.n_out
        self._cast_src = None
        self._cast_params = None

    # ------------------------------------------------------------- params
    def _device_params(self):
        """Params cast once to the net's compute dtype (recast only when
        ``net.params`` is replaced)."""
        if self._cast_params is None or self._cast_src is not self.net.params:
            self._cast_params = self.net._cast_params(self.net.params)
            self._cast_src = self.net.params
        return self._cast_params

    def init_cache(self, batch: int) -> Dict[str, Dict]:
        """{attn_name: {"k", "v" [B, H, t_max, Dh]}} in the compute
        dtype."""
        return {name: self.net.conf.vertices[name].layer.init_cache(
                    batch, self.t_max, self.net.compute_dtype, self.device)
                for name in self.attn_names}

    def init_paged_pool(self, num_pages: int,
                        page_size: int) -> Dict[str, Dict]:
        """{attn_name: {"k", "v" [P, H, page_size, Dh]}}: one page pool
        per attention layer in the compute dtype, page 0 the null page."""
        return {name: self.net.conf.vertices[name].layer.init_page_pool(
                    int(num_pages), int(page_size), self.net.compute_dtype,
                    self.device)
                for name in self.attn_names}

    def _to_dev(self, x, dtype) -> torch.Tensor:
        """Host array (or a tensor already on the device, e.g. a block
        carry) → device tensor of ``dtype``."""
        if torch.is_tensor(x):
            return x.to(self.device, dtype)
        return to_device(x, self.device, dtype)

    def _temps(self, temps, b: int) -> Tuple[np.ndarray, torch.Tensor]:
        host = np.zeros(b, np.float32) if temps is None else \
            np.broadcast_to(np.asarray(temps, np.float32), (b,))
        return host, self._to_dev(host, torch.float32)

    # -------------------------------------------------------------- walks
    def _walk_prefill(self, params, state, caches, tokens, lengths,
                      slots=None):
        """One teacher-forced pass over padded prompts [B, Tp]: fills
        cache rows ``slots`` (default 0..B-1) at [0, Tp) in every attention
        vertex and returns the logits at each row's LAST real position
        [B, V] f32."""
        conf = self.net.conf
        tp = tokens.shape[1]
        kmask = (torch.arange(tp, device=self.device)[None, :] <
                 lengths[:, None]).float()
        acts = {self.input_name: tokens}
        logits = None
        for name in conf.topological_order:
            v = conf.vertices[name]
            xs = [acts[i] for i in conf.vertex_inputs[name]]
            if isinstance(v, LayerVertex) and \
                    isinstance(v.layer, SelfAttentionLayer):
                acts[name], _ = v.layer.prefill_forward(
                    params[name], xs[0], caches[name], mask=kmask,
                    slots=slots)
            elif name == self.output_name:
                # gather each row's last real hidden state BEFORE the vocab
                # projection: [B, Tp, V] logits would be GBs at a 32k vocab
                rows = torch.arange(tokens.shape[0], device=self.device)
                h_last = xs[0][rows, (lengths - 1).clamp(min=0)][:, None]
                logits = v.layer.preoutput(params[name], h_last)[:, 0]
            else:
                acts[name], _ = v.forward(params[name], state[name], xs)
        return logits.float()

    def _walk_decode(self, params, state, caches, ids, positions,
                     ptables=None):
        """One single-token step: ids [B] at per-row ``positions`` [B] →
        logits [B, V] f32 (caches written in place). With ``ptables``
        [B, NP] the caches are page pools read through those tables."""
        conf = self.net.conf
        acts = {self.input_name: ids}
        logits = None
        for name in conf.topological_order:
            v = conf.vertices[name]
            xs = [acts[i] for i in conf.vertex_inputs[name]]
            if isinstance(v, LayerVertex) and \
                    isinstance(v.layer, TokenAndPositionEmbedding):
                acts[name] = v.layer.embed_at(params[name], xs[0], positions)
            elif isinstance(v, LayerVertex) and \
                    isinstance(v.layer, SelfAttentionLayer):
                if ptables is None:
                    acts[name], _ = v.layer.decode_forward(
                        params[name], xs[0], caches[name], positions)
                else:
                    acts[name], _ = v.layer.paged_decode_forward(
                        params[name], xs[0], caches[name], ptables,
                        positions)
            elif name == self.output_name:
                logits = v.layer.preoutput(params[name], xs[0])[:, 0]
            else:
                acts[name], _ = v.forward(params[name], state[name], xs)
        return logits.float()

    def _walk_window(self, params, state, caches, tokens, pos0, valid,
                     ptables=None, last=False):
        """One window pass: tokens [B, C] at absolute start positions
        ``pos0`` [B], ``valid`` [B] real tokens a row, written through
        the slab (``chunk_forward``'s per-cell path) or, with ``ptables``,
        through the page tables (``paged_prefill_forward``). Returns the
        logits [B, C, V] f32 at every window position (a verify window),
        or with ``last`` only at each row's last valid position [B, V] (a
        prefill tail)."""
        conf = self.net.conf
        acts = {self.input_name: tokens}
        logits = None
        for name in conf.topological_order:
            v = conf.vertices[name]
            xs = [acts[i] for i in conf.vertex_inputs[name]]
            if isinstance(v, LayerVertex) and \
                    isinstance(v.layer, TokenAndPositionEmbedding):
                acts[name] = v.layer.embed_chunk(params[name], xs[0], pos0)
            elif isinstance(v, LayerVertex) and \
                    isinstance(v.layer, SelfAttentionLayer):
                if ptables is None:
                    acts[name], _ = v.layer.chunk_forward(
                        params[name], xs[0], caches[name], pos0, valid)
                else:
                    acts[name], _ = v.layer.paged_prefill_forward(
                        params[name], xs[0], caches[name], ptables, pos0,
                        valid)
            elif name == self.output_name:
                h = xs[0]
                if last:
                    rows = torch.arange(h.shape[0], device=self.device)
                    h = h[rows, (valid - 1).clamp(min=0)][:, None]
                logits = v.layer.preoutput(params[name], h)
                if last:
                    logits = logits[:, 0]
            else:
                acts[name], _ = v.forward(params[name], state[name], xs)
        return logits.float()

    @staticmethod
    def _select(logits, temps, seed: int, sample: bool):
        """Per-row next token [B] (int64): greedy (argmax of the raw f32
        logits) where temps <= 0, elsewhere Gumbel-max sampling from the
        bf16-ROUNDED logits / temperature with a generator seeded by
        ``seed``. ``sample`` (known on the host: any temperature > 0) skips
        the draw for all-greedy batches."""
        greedy = logits.argmax(dim=-1)
        if not sample:
            return greedy
        t = temps.clamp(min=1e-6)[:, None]
        ql = logits.to(torch.bfloat16).float()
        gen = rngmod.generator(seed, logits.device)
        u = torch.rand(ql.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(
            u.clamp(min=torch.finfo(torch.float32).tiny)))
        sampled = (ql / t + gumbel).argmax(dim=-1)
        return torch.where(temps <= 0, greedy, sampled)

    # ----------------------------------------------------------- programs
    @torch.no_grad()
    def prefill(self, caches, tokens, lengths, temps=None, seed: int = 0):
        """Fill ``caches`` from padded prompts [B, Tp] (+ true lengths [B])
        and return (first selected ids [B], last-position logits [B, V]
        f32, caches). ``seed`` seeds this selection's draw."""
        return self.prefill_slots(caches, tokens, lengths, None, temps, seed)

    @torch.no_grad()
    def prefill_slots(self, caches, tokens, lengths, slots, temps=None,
                      seed: int = 0):
        """Batched admission: one forward over [M, Tp] writes row i's k/v
        into cache row ``slots[i]`` (None: rows 0..M-1). Padded rows may
        repeat a slot with identical data."""
        host_t, temps_d = self._temps(temps, np.shape(tokens)[0])
        slots_d = None if slots is None else self._to_dev(slots, torch.long)
        logits = self._walk_prefill(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(tokens, torch.long), self._to_dev(lengths,
                                                           torch.long),
            slots_d)
        return (self._select(logits, temps_d, seed, bool((host_t > 0).any())),
                logits, caches)

    @torch.no_grad()
    def decode_step(self, caches, ids, positions, temps=None, seed: int = 0):
        """One decode step; returns (next ids [B], logits [B, V] f32,
        caches)."""
        host_t, temps_d = self._temps(temps, np.shape(ids)[0])
        logits = self._walk_decode(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(ids, torch.long), self._to_dev(positions,
                                                        torch.long))
        return (self._select(logits, temps_d, seed, bool((host_t > 0).any())),
                logits, caches)

    @torch.no_grad()
    def decode_block(self, caches, ids, positions, temps=None, seed: int = 0,
                     *, block_size: int, eos_ids=None, stopped=None,
                     step0: int = 0, key_salt: int = 0, ptables=None):
        """``block_size`` decode steps launched back to back, nothing read
        back. Returns ``(toks [B, K], ids [B], positions [B], stopped [B],
        caches)``, all on the device, so the caller can dispatch the NEXT
        block from this carry before reading these tokens. ``eos_ids``
        ([B], -1 = none) freezes a lane the step after it emits its eos; a
        frozen lane re-emits its last token and keeps its position (the
        overshoot stays in its own cache cell and is dropped on the host).
        Step j draws with seed ``fold_in(seed, key_salt | (step0 + j +
        1))``: the absolute step, so outputs are identical for every K.
        ``ptables`` [B, NP] makes ``caches`` page pools (see
        :meth:`paged_decode_block`)."""
        b = np.shape(ids)[0]
        k = int(block_size)
        host_t, temps_d = self._temps(temps, b)
        sample = bool((host_t > 0).any())
        eos, stop, ids, pos, ptab = self._carry_in(b, ids, positions,
                                                   eos_ids, stopped,
                                                   ptables)
        params = self._device_params()
        state = self.net._inference_state()
        toks = torch.empty((b, k), dtype=torch.long, device=self.device)
        for j in range(k):
            logits = self._walk_decode(params, state, caches, ids,
                                       pos.clamp(max=self.t_max - 1), ptab)
            nxt = self._select(logits, temps_d, rngmod.fold_in(
                seed, key_salt | (step0 + j + 1)), sample)
            nxt = torch.where(stop, ids, nxt)
            hit_eos = (eos >= 0) & (nxt == eos)
            pos = torch.where(stop, pos, pos + 1)
            stop = stop | hit_eos | (pos >= self.t_max)
            ids = nxt
            toks[:, j] = nxt
        return toks, ids, pos, stop, caches

    def _carry_in(self, b, ids, positions, eos_ids, stopped, ptables):
        """A block's per-lane inputs on the device: (eos ids, stop flags,
        ids, positions, page tables or None)."""
        eos = self._to_dev(np.full(b, -1, np.int64) if eos_ids is None
                           else np.broadcast_to(np.asarray(eos_ids), (b,)),
                           torch.long)
        stop = self._to_dev(np.zeros(b, bool) if stopped is None
                            else stopped, torch.bool)
        ptab = None if ptables is None else self._to_dev(ptables,
                                                         torch.long)
        return (eos, stop, self._to_dev(ids, torch.long),
                self._to_dev(positions, torch.long), ptab)

    # ------------------------------------------------------------- paged
    @torch.no_grad()
    def paged_prefill(self, caches, tokens, pos0, valid, ptables,
                      temps=None, seed: int = 0):
        """Batched tail prefill into page pools: tokens [M, C] are each
        row's prompt tail starting at absolute position ``pos0`` [M] (0 on
        a prefix-cache miss), ``valid`` [M] real tokens a row, ``ptables``
        [M, NP] the rows' page tables. Returns (selected next ids [M],
        last-position logits [M, V] f32, caches), like
        :meth:`prefill_slots` (the JAX package's returns (ids, pools))."""
        host_t, temps_d = self._temps(temps, np.shape(tokens)[0])
        valid_d = self._to_dev(valid, torch.long)
        logits = self._walk_window(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(tokens, torch.long), self._to_dev(pos0, torch.long),
            valid_d, self._to_dev(ptables, torch.long), last=True)
        return (self._select(logits, temps_d, seed, bool((host_t > 0).any())),
                logits, caches)

    def paged_decode_block(self, caches, ptables, ids, positions,
                           temps=None, seed: int = 0, *, block_size: int,
                           eos_ids=None, stopped=None, step0: int = 0,
                           key_salt: int = 0):
        """:meth:`decode_block` over page pools: the same carry and seed
        schedule, so outputs equal the slab path's. ``ptables`` [B, NP]
        is a per-dispatch input: the caller grows the tables between
        blocks."""
        return self.decode_block(caches, ids, positions, temps, seed,
                                 block_size=block_size, eos_ids=eos_ids,
                                 stopped=stopped, step0=step0,
                                 key_salt=key_salt, ptables=ptables)

    @torch.no_grad()
    def kv_export(self, caches, pids) -> Dict[str, Dict[str, torch.Tensor]]:
        """Gather pages ``pids`` out of every layer's pool: {layer:
        {"k", "v" [n, H, page_size, Dh]}} on the device (see
        ``paging.PageFrameSet.from_tensors``)."""
        idx = self._to_dev(pids, torch.long)
        return {n: {kk: caches[n][kk][idx] for kk in ("k", "v")}
                for n in self.attn_names}

    @torch.no_grad()
    def kv_import(self, caches, pids, frames):
        """Scatter page frames ({layer: {"k", "v" [n, H, page_size, Dh]}})
        into the pools at ``pids`` in place; returns the pools."""
        idx = self._to_dev(pids, torch.long)
        for n in self.attn_names:
            for kk in ("k", "v"):
                pool = caches[n][kk]
                pool[idx] = frames[n][kk].to(pool.device, pool.dtype)
        return caches

    # ------------------------------------------------------- speculation
    @torch.no_grad()
    def verify_block(self, caches, ids, positions, draft, temps=None,
                     seed: int = 0, *, eos_ids=None, stopped=None,
                     step0: int = 0, key_salt: int = 0, ptables=None):
        """Verify ``draft`` [B, K] candidate tokens in ONE forward over the
        window [last id | draft] at positions [pos, pos + K]. Returns
        ``(out [B, K + 2], ids [B], positions [B], stopped [B], caches)``
        on the device: row b emits ``out[b, :out[b, K + 1]]``, the
        accepted draft prefix plus the model's own token at the first
        mismatch, and the carry is already rewound to the accepted length.
        A frozen lane writes nothing; a lane at the context edge writes
        only what fits. ``step0`` / ``key_salt`` follow
        :meth:`decode_block`'s seed schedule, so the emitted tokens are
        what decode_block would emit."""
        b = np.shape(ids)[0]
        draft_d = self._to_dev(np.asarray(draft), torch.long)
        kd = draft_d.shape[1]
        host_t, temps_d = self._temps(temps, b)
        eos, stop, ids, pos, ptab = self._carry_in(b, ids, positions,
                                                   eos_ids, stopped,
                                                   ptables)
        window = torch.cat([ids[:, None], draft_d], dim=1)
        wvalid = torch.where(stop, 0, (self.t_max - pos).clamp(0, kd + 1))
        logits = self._walk_window(
            self._device_params(), self.net._inference_state(), caches,
            window, pos, wvalid, ptab)
        out, ids, pos, stop = self._verify_accept(
            logits, ids, pos, draft_d, stop, temps_d, eos, seed, step0,
            key_salt, bool((host_t > 0).any()))
        return out, ids, pos, stop, caches

    def paged_verify_block(self, caches, ptables, ids, positions, draft,
                           temps=None, seed: int = 0, *, eos_ids=None,
                           stopped=None, step0: int = 0, key_salt: int = 0):
        """:meth:`verify_block` over page pools: the window's writes go
        through the page tables, invalid cells to the null page; the
        caller truncates the tables after the readback."""
        return self.verify_block(caches, ids, positions, draft, temps, seed,
                                 eos_ids=eos_ids, stopped=stopped,
                                 step0=step0, key_salt=key_salt,
                                 ptables=ptables)

    def _verify_accept(self, logits, ids, positions, draft, stopped, temps,
                       eos_ids, seed, step0, key_salt, sample):
        """Acceptance on the device: ``logits`` [B, K+1, V] are the
        window's next-token scores, ``draft`` [B, K] the candidates.
        Position j selects with :meth:`_select` under seed
        ``fold_in(seed, key_salt | (step0 + j + 1))``, as decode_block's
        step j would. Emission is the longest exact-match prefix plus the
        bonus token, cut after the first eos and at the context edge;
        frozen lanes emit nothing. Returns (out [B, K+1 tokens | emit],
        ids, positions, stopped)."""
        kq = logits.shape[1]
        kd = kq - 1
        sel = torch.stack(
            [self._select(logits[:, j], temps, rngmod.fold_in(
                seed, key_salt | (step0 + j + 1)), sample)
             for j in range(kq)], dim=1)                  # [B, K+1]
        idxs = torch.arange(kq, device=sel.device)[None, :]
        match = torch.cumprod((sel[:, :kd] == draft).long(), dim=1)
        emit = match.sum(dim=1) + 1                        # + the bonus
        hit = (eos_ids[:, None] >= 0) & (sel == eos_ids[:, None])
        first_eos = torch.where(hit, idxs, kq).min(dim=1).values
        emit = torch.minimum(emit, first_eos + 1)          # eos ends it
        emit = torch.minimum(emit, (self.t_max - positions).clamp(0, kq))
        emit = torch.where(stopped, 0, emit)
        new_pos = positions + emit
        last = torch.gather(sel, 1, (emit - 1).clamp(0, kq - 1)[:, None])[:,
                                                                         0]
        new_ids = torch.where(emit > 0, last, ids)
        # emit == first_eos + 1 means the last emitted token is the eos
        new_stop = stopped | (emit == first_eos + 1) | (new_pos >= self.t_max)
        return (torch.cat([sel, emit[:, None]], dim=1), new_ids, new_pos,
                new_stop)

    # ----------------------------------------------------------- generate
    def generate(self, prompts: Sequence, max_new_tokens: int,
                 temperature=0.0, eos_id: Optional[int] = None,
                 seed: int = 0, block_size: int = 1) -> List[np.ndarray]:
        """Batched autoregressive generation: ragged int prompts → [prompt
        + generated] per row. Greedy where the (scalar or per-row)
        temperature is <= 0; per-row stop on ``eos_id``,
        ``max_new_tokens`` or a full context. Decoding runs in blocks of
        ``block_size`` steps, pipelined: block t+1 is dispatched before
        block t's [B, K] tokens are read back, one readback per block."""
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        b = len(prompts)
        if b == 0:
            return []
        lengths = np.asarray([len(p) for p in prompts], np.int64)
        if (lengths < 1).any():
            raise ValueError("empty prompt")
        if int(lengths.max()) > self.t_max:
            raise ValueError(f"prompt length {int(lengths.max())} > t_max "
                             f"{self.t_max}")
        tp = min(_round_up_pow2(int(lengths.max())), self.t_max)
        tokens = np.zeros((b, tp), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        temps = np.broadcast_to(np.asarray(temperature, np.float32),
                                (b,)).copy()
        nxt, _, caches = self.prefill(self.init_cache(b), tokens, lengths,
                                      temps, seed=rngmod.fold_in(seed, 0))
        gen: List[List[int]] = [[] for _ in range(b)]
        finished = np.zeros(b, bool)

        def consume(tok_cols: np.ndarray) -> None:
            """Append a [B, k] column block until each row's stop; later
            columns of a finished row are device overshoot."""
            for c in range(tok_cols.shape[1]):
                for i in range(b):
                    if finished[i]:
                        continue
                    tok = int(tok_cols[i, c])
                    gen[i].append(tok)
                    if (eos_id is not None and tok == eos_id) or \
                            len(gen[i]) >= max_new_tokens or \
                            int(lengths[i]) + len(gen[i]) >= self.t_max:
                        finished[i] = True

        def results():
            return [np.concatenate([p, np.asarray(g, np.int64)]).astype(
                np.int32) for p, g in zip(prompts, gen)]

        if int(max_new_tokens) >= 1:
            consume(device_fetch(nxt, tag="generate.prefill")[:, None])
        n_steps = int(max_new_tokens) - 1
        if finished.all() or n_steps <= 0:
            return results()
        k = max(1, int(block_size))
        eos_arr = np.full(b, -1 if eos_id is None else int(eos_id), np.int64)
        ids_d, pos_d, stop_d = nxt, lengths, None
        pending = None
        for blk in range(-(-n_steps // k)):
            toks, ids_d, pos_d, stop_d, caches = self.decode_block(
                caches, ids_d, pos_d, temps, seed=seed, block_size=k,
                eos_ids=eos_arr, stopped=stop_d, step0=blk * k)
            copy = start_fetch(toks)
            if pending is not None:
                # read block t while block t+1 computes (double buffer)
                consume(device_fetch(pending, tag="generate.decode"))
                if finished.all():
                    pending = None     # the in-flight block is overshoot
                    break
            pending = copy
        if pending is not None:
            consume(device_fetch(pending, tag="generate.decode"))
        return results()


class GenerationRequest:
    """Handle for one queued prompt; ``result()`` blocks until the engine
    completes it (the full [prompt + generated] id array). States:
    PENDING (queued), RUNNING (holds a cache slot), DONE, FAILED."""

    PENDING = "PENDING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"

    def __init__(self, prompt, max_new_tokens: int, temperature: float,
                 eos_id: Optional[int]):
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.generated: List[int] = []
        self._done = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._running = False

    def _complete(self):
        self._result = np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int64)]).astype(
                np.int32)
        self._running = False
        self._done.set()

    def _fail(self, exc: BaseException):
        self._error = exc
        self._running = False
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def state(self) -> str:
        if self._done.is_set():
            return self.DONE if self._error is None else self.FAILED
        return self.RUNNING if self._running else self.PENDING

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("generation not finished")
        if self._error is not None:
            raise self._error
        return self._result


class SlotGenerationEngine:
    """Slot-based continuous batching over a TransformerDecoder.

    ``num_slots`` lanes share one [S, H, t_max, Dh] cache per attention
    layer (the slab). Every admittable queued request coalesces into one
    bucketed prefill call (count and prompt length rounded up to powers of
    two, padded rows repeating row 0) with ONE readback. Decoding runs in
    blocks of ``block_size`` steps: each cycle dispatches the next block
    from the device-side carry of the previous one, THEN reads back and
    books the previous block's [S, K] tokens, so host work overlaps the
    device. A slot that finishes frees at a block boundary and, with
    ``refill=True``, is re-admitted from the queue; ``refill=False`` drains
    each admitted wave first. Submissions beyond ``max_pending`` queued
    requests are shed with :class:`RejectedError`.

    ``paged=True`` replaces the slab with a pool of ``num_pages`` pages of
    ``page_size`` tokens (``page_size`` must divide t_max; by default the
    slab's capacity plus the null page) and per-slot page tables. A lane
    maps only the pages its context needs, growing them before each block;
    with ``prefix_cache`` a prompt maps the resident pages of its longest
    cached prefix read-only and prefills only its tail. A request the pool
    cannot serve waits at the queue head while work is in flight, and is
    shed when nothing is; a decoding lane the pool cannot grow is
    preempted and requeued at the head (its tokens so far ride along and
    are re-prefilled). Paged engines always decode through blocks.

    ``speculative=True`` drafts ``spec_k`` tokens a lane from the lane's
    own context (:class:`~.speculative.NGramDrafter` over ``spec_ngram``-
    grams) and verifies them in one forward a block, with one readback; a
    rejected tail is rewound. While the acceptance rate's moving average
    is below ``spec_threshold`` the engine decodes plain blocks, trying a
    speculative block again every ``spec_probe_every`` of them. Greedy
    output is the same with speculation on or off.

    Synchronous use: ``submit(...)`` then ``run_until_drained()``. Serving
    use: ``start()`` runs the loop on a worker thread; ``shutdown()``."""

    def __init__(self, net, num_slots: int = 8,
                 t_max: Optional[int] = None, refill: bool = True,
                 seed: int = 0, decoder: Optional[TransformerDecoder] = None,
                 max_pending: int = 256, block_size: int = 1, device=None,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_cache: bool = True,
                 speculative: bool = False, spec_k: Optional[int] = None,
                 spec_ngram: int = 3, spec_threshold: float = 0.35,
                 spec_probe_every: int = 16):
        if decoder is not None and t_max is not None and \
                decoder.t_max != t_max:
            raise ValueError(f"shared decoder has t_max {decoder.t_max}, "
                             f"engine asked for {t_max}")
        self.decoder = decoder if decoder is not None \
            else TransformerDecoder(net, t_max=t_max)
        self.device = self.decoder.device
        if device is not None:
            want = torch.device(device)
            if want.type != self.device.type or \
                    want.index not in (None, self.device.index):
                raise ValueError(f"engine device {want} differs from the "
                                 f"net's device {self.device}")
        self.num_slots = int(num_slots)
        self.refill = bool(refill)
        self.seed = int(seed)
        self.max_pending = int(max_pending)
        self.block_size = max(1, int(block_size))
        self.t_max = self.decoder.t_max
        self.speculative = bool(speculative)
        self.spec_k = max(1, int(spec_k)) if spec_k is not None \
            else max(self.block_size, 4)
        self.spec_ngram = max(1, int(spec_ngram))
        self.spec_threshold = float(spec_threshold)
        self.spec_probe_every = max(1, int(spec_probe_every))
        self._spec_ewma: Optional[float] = None     # acceptance average
        self._spec_cool = 0          # plain blocks until the next probe
        self._drafters: Dict[int, NGramDrafter] = {}
        self.page_size = int(page_size)
        self.prefix_cache = bool(prefix_cache)
        self._pager: Optional[PageAllocator] = None
        self._pages_per_slot = 0
        if paged:
            if self.t_max % self.page_size:
                raise ValueError(
                    f"page_size {self.page_size} must divide t_max "
                    f"{self.t_max}: page-aligned logical views keep the "
                    "paged attention shapes identical to the slab path")
            self._pages_per_slot = self.t_max // self.page_size
            if num_pages is None:
                num_pages = self.num_slots * self._pages_per_slot + 1
            self._pager = PageAllocator(int(num_pages), self.page_size,
                                        prefix_cache=self.prefix_cache)
            self._caches = self.decoder.init_paged_pool(
                self._pager.num_pages, self.page_size)
        else:
            self._caches = self.decoder.init_cache(self.num_slots)
        self.num_pages = None if self._pager is None \
            else self._pager.num_pages
        # per-slot mapping (the slot's refs) and the host page tables
        # shipped, copied, with every paged dispatch
        self._slot_pages: List[List[int]] = \
            [[] for _ in range(self.num_slots)]
        self._ptables = np.zeros(
            (self.num_slots, max(1, self._pages_per_slot)), np.int64)
        self._slots: List[Optional[GenerationRequest]] = \
            [None] * self.num_slots
        self._last_ids = np.zeros(self.num_slots, np.int64)
        self._positions = np.zeros(self.num_slots, np.int64)
        self._temps = np.zeros(self.num_slots, np.float32)
        self._eos_ids = np.full(self.num_slots, -1, np.int64)
        # block pipeline: the device carry (ids, positions, stop flags) of
        # the last dispatched block, and that block while it is unread
        self._carry = None
        self._inflight = None
        self._pending: collections.deque = collections.deque()
        # popped from the queue but not yet in a slot: shutdown fails them
        self._admitting: List[GenerationRequest] = []
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._step_no = 0
        self._worker: Optional[threading.Thread] = None
        self._shutdown = False
        self._dead: Optional[BaseException] = None
        self._stats = dict.fromkeys(_ENGINE_COUNTERS, 0)

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               eos_id: Optional[int] = None) -> GenerationRequest:
        req = GenerationRequest(prompt, max_new_tokens, temperature, eos_id)
        if len(req.prompt) < 1:
            req._fail(ValueError("empty prompt"))
            return req
        if req.max_new_tokens <= 0:
            req._complete()
            return req
        if len(req.prompt) >= self.t_max:
            req._fail(ValueError(
                f"prompt length {len(req.prompt)} leaves no room to "
                f"generate within t_max {self.t_max}"))
            return req
        with self._lock:
            dead = self._dead
            stopped = self._shutdown or dead is not None
            depth = len(self._pending)
            shed = not stopped and depth >= self.max_pending
            if shed:
                self._stats["rejected"] += 1
            elif not stopped:
                self._pending.append(req)
        if stopped:
            req._fail(dead or RuntimeError("SlotGenerationEngine shut down"))
        elif shed:
            req._fail(RejectedError(
                f"pending queue full ({depth} queued, max_pending="
                f"{self.max_pending}) — request shed", queue_depth=depth))
        else:
            self._work.set()
        return req

    # -------------------------------------------------------------- slots
    def _req_finished(self, req: GenerationRequest, tok: int) -> bool:
        return (req.eos_id is not None and tok == req.eos_id) or \
            len(req.generated) >= req.max_new_tokens or \
            len(req.prompt) + len(req.generated) >= self.t_max

    def _count_bucket(self, m: int) -> int:
        """Admission-count bucket: pow2 capped at num_slots."""
        b = 1
        while b < m:
            b *= 2
        return min(b, self.num_slots)

    def _any_active(self) -> bool:
        return any(r is not None for r in self._slots)

    def _occupy_locked(self, s: int, req: GenerationRequest, tok: int,
                       pos: int) -> None:
        self._slots[s] = req
        self._last_ids[s] = tok
        self._positions[s] = pos
        self._temps[s] = req.temperature
        self._eos_ids[s] = -1 if req.eos_id is None else int(req.eos_id)

    def _admit(self):
        """Batched admission: every queued request that finds a free slot
        joins ONE bucketed prefill_slots call with a single readback."""
        if self._pager is not None:
            return self._admit_paged()
        while True:
            with self._lock:
                free = [s for s in range(self.num_slots)
                        if self._slots[s] is None]
                batch: List[Tuple[GenerationRequest, int]] = []
                while len(batch) < len(free) and self._pending:
                    batch.append((self._pending.popleft(), free[len(batch)]))
                drained = not self._pending
                if not batch:
                    return
                self._admitting = [r for r, _ in batch]
                self._stats["prefills"] += len(batch)
                self._stats["prefill_batches"] += 1
                batch_no = self._stats["prefill_batches"]
            m = len(batch)
            mb = self._count_bucket(m)
            tp = min(_round_up_pow2(max(len(r.prompt) for r, _ in batch)),
                     self.t_max)
            tokens = np.zeros((mb, tp), np.int64)
            lengths = np.zeros(mb, np.int64)
            slot_idx = np.zeros(mb, np.int64)
            temps = np.zeros(mb, np.float32)
            for i in range(mb):
                req, s = batch[i if i < m else 0]      # pad rows = row 0
                tokens[i, :len(req.prompt)] = req.prompt
                lengths[i] = len(req.prompt)
                slot_idx[i] = s
                temps[i] = req.temperature
            nxt, _, self._caches = self.decoder.prefill_slots(
                self._caches, tokens, lengths, slot_idx, temps,
                seed=rngmod.fold_in(self.seed, PREFILL_BATCH_SALT | batch_no))
            toks = device_fetch(nxt, tag="engine.prefill")    # ONE readback
            finishers: List[GenerationRequest] = []
            with self._lock:
                if self._shutdown:
                    return              # shutdown fails the parked batch
                self._admitting = []
                self._stats["host_readbacks"] += 1
                for i, (req, s) in enumerate(batch):
                    tok = int(toks[i])
                    req._running = True
                    req.generated.append(tok)
                    self._stats["emitted_tokens"] += 1
                    if self._req_finished(req, tok):
                        self._stats["completed"] += 1
                        finishers.append(req)
                    else:
                        self._occupy_locked(s, req, tok, len(req.prompt))
                # slot contents changed: the next block resyncs from host
                self._carry = None
            for req in finishers:
                req._complete()
            if drained:
                return

    # -------------------------------------------------------------- pages
    def _map_slot_pages(self, s: int, pages: List[int]) -> None:
        """Install ``pages`` (already carrying this mapping's refs) as
        slot ``s``'s mapping; caller holds the engine lock."""
        self._slot_pages[s] = list(pages)
        self._ptables[s, :] = 0
        self._ptables[s, :len(pages)] = pages

    def _release_slot_pages(self, s: int) -> None:
        """Unmap slot ``s`` (caller holds the engine lock): one unref a
        page, and the table row pointed at the null page so a frozen
        lane's rewrite lands in trash. Pages the prefix index retains stay
        resident."""
        if self._pager is None:
            return
        pages, self._slot_pages[s] = self._slot_pages[s], []
        self._ptables[s, :] = 0
        for pid in pages:
            self._pager.unref(pid)

    def _release_all_pages(self) -> None:
        if self._pager is None:
            return
        for s in range(self.num_slots):
            self._release_slot_pages(s)

    def _pool_blocked(self, req: GenerationRequest, n_need: int,
                      batch_live: bool = False) -> None:
        """The pool cannot hold ``req`` now: with work in flight (or rows
        of this admission already mapped, ``batch_live``) it waits at the
        queue head; with nothing in flight to free a page it is shed."""
        with self._lock:
            active = batch_live or self._any_active()
            if req in self._admitting:
                self._admitting.remove(req)
            if active:
                req._running = False
                self._pending.appendleft(req)
                return
            self._stats["rejected"] += 1
        req._fail(RejectedError(
            f"KV page pool exhausted: {n_need} pages needed, none free "
            "after eviction and nothing in flight to free one — request "
            "shed"))

    def _admit_paged(self):
        """Paged batched admission: each request maps the longest resident
        chain prefix of its context read-only and allocates private pages
        for the rest; then ONE bucketed ``paged_prefill`` prefills only
        the tails, with one readback. Every full prompt page is then
        published into the prefix index."""
        ps = self.page_size
        while True:
            with self._lock:
                free = [s for s in range(self.num_slots)
                        if self._slots[s] is None]
            if not free:
                return
            batch: List[Tuple[GenerationRequest, int, np.ndarray, int]] = []
            drained = blocked = False
            for s in free:
                with self._lock:
                    if not self._pending:
                        drained = True
                        break
                    req = self._pending.popleft()
                    self._admitting.append(req)
                # a requeued request re-prefills what it generated so far
                ctx = np.concatenate(
                    [req.prompt, np.asarray(req.generated, np.int64)])
                # the tail must produce the next-token logits, so the match
                # stops one token short of the context
                shared, start = self._pager.match_and_ref(
                    ctx, max_tokens=len(ctx) - 1)
                # private pages cover [start, len(ctx)]: the tail and the
                # cell the first decode token writes
                n_need = len(ctx) // ps + 1 - len(shared)
                fresh = self._pager.alloc(n_need)
                if fresh is None:
                    for pid in shared:
                        self._pager.unref(pid)
                    self._pool_blocked(req, n_need, batch_live=bool(batch))
                    blocked = True
                    break
                with self._lock:
                    if self._shutdown:
                        for pid in shared + fresh:
                            self._pager.unref(pid)
                        return
                    self._map_slot_pages(s, shared + fresh)
                    if start:
                        self._stats["prefix_cache_hits"] += 1
                        self._stats["prefix_cache_hit_tokens"] += start
                    else:
                        self._stats["prefix_cache_misses"] += 1
                batch.append((req, s, ctx, start))
            if not batch:
                return
            m = len(batch)
            mb = self._count_bucket(m)
            c = min(_round_up_pow2(max(len(ctx) - start
                                       for _, _, ctx, start in batch)),
                    self.t_max)
            tokens = np.zeros((mb, c), np.int64)
            pos0 = np.zeros(mb, np.int64)
            valid = np.zeros(mb, np.int64)
            ptab = np.zeros((mb, self._pages_per_slot), np.int64)
            temps = np.zeros(mb, np.float32)
            with self._lock:
                if self._shutdown:
                    return
                for i in range(mb):
                    req, s, ctx, start = batch[i if i < m else 0]
                    tail = ctx[start:]                  # pad rows = row 0
                    tokens[i, :len(tail)] = tail
                    pos0[i] = start
                    valid[i] = len(tail)
                    ptab[i] = self._ptables[s]
                    temps[i] = req.temperature
                self._stats["prefills"] += m
                self._stats["prefill_batches"] += 1
                batch_no = self._stats["prefill_batches"]
            nxt, _, self._caches = self.decoder.paged_prefill(
                self._caches, tokens, pos0, valid, ptab, temps,
                seed=rngmod.fold_in(self.seed, PREFILL_BATCH_SALT | batch_no))
            toks = device_fetch(nxt, tag="engine.prefill")    # ONE readback
            finishers: List[GenerationRequest] = []
            with self._lock:
                if self._shutdown:
                    return
                self._stats["host_readbacks"] += 1
                for i, (req, s, ctx, start) in enumerate(batch):
                    self._admitting.remove(req)
                    tok = int(toks[i])
                    req._running = True
                    req.generated.append(tok)
                    self._stats["emitted_tokens"] += 1
                    # full context pages are never written again (decode
                    # writes land past the context end): publish them
                    self._pager.register_chain(
                        ctx, self._slot_pages[s][:len(ctx) // ps])
                    if self._req_finished(req, tok):
                        self._stats["completed"] += 1
                        finishers.append(req)
                        self._release_slot_pages(s)
                    else:
                        self._occupy_locked(s, req, tok, len(ctx))
                self._carry = None
            for req in finishers:
                req._complete()
            if drained or blocked:
                return

    def _ensure_decode_pages_locked(self, k: int) -> None:
        """Grow each active lane's table to cover this dispatch's furthest
        write (position + in-flight lead + k - 1, clamped to the context
        edge); caller holds the engine lock. With a block in flight the
        device carry runs one block ahead of the host positions, hence
        the lead. A lane the pool cannot serve, even after evicting
        cache-only prefix pages, is preempted: unmapped and requeued at
        the head. Highest slots go first, so their pages serve the lower
        lanes."""
        ps = self.page_size
        lead = self._inflight[2] if self._inflight is not None else 0
        for s in reversed(range(self.num_slots)):
            req = self._slots[s]
            if req is None:
                continue
            upto = min(int(self._positions[s]) + lead + k - 1,
                       self.t_max - 1)
            delta = upto // ps + 1 - len(self._slot_pages[s])
            if delta <= 0:
                continue
            fresh = self._pager.alloc(delta)
            if fresh is not None:
                base = len(self._slot_pages[s])
                self._slot_pages[s].extend(fresh)
                self._ptables[s, base:base + len(fresh)] = fresh
                continue
            self._slots[s] = None
            self._release_slot_pages(s)
            req._running = False
            self._pending.appendleft(req)
            self._stats["page_preempted"] += 1
            self._carry = None

    def _pool_bytes(self) -> int:
        if self._pager is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for layer in self._caches.values()
                   for t in layer.values())

    def kv_page_stats(self) -> Optional[Dict]:
        """Page accounting: the allocator's pool state, mapped pages, pool
        bytes and internal fragmentation (the share of mapped page cells
        no live context has written). None on a slab engine."""
        if self._pager is None:
            return None
        st = self._pager.stats()
        with self._lock:
            mapped = sum(len(p) for p in self._slot_pages)
            written = sum(int(self._positions[s])
                          for s in range(self.num_slots)
                          if self._slot_pages[s] and
                          self._slots[s] is not None)
        st["mapped"] = mapped
        st["pool_bytes"] = self._pool_bytes()
        span = mapped * self.page_size
        st["fragmentation"] = 0.0 if not span else round(
            max(0.0, 1.0 - written / span), 4)
        return st

    # ------------------------------------------------------------ decoding
    def _step(self):
        """One decode cycle: a speculative block, or a plain pipelined
        block (always, without speculation; during the low-acceptance
        cooldown, with it)."""
        if self.speculative:
            with self._lock:
                cooling = self._spec_cool > 0
                if cooling:
                    self._spec_cool -= 1
                    self._stats["spec_fallbacks"] += 1
            if not cooling:
                return self._step_spec()
        return self._step_block()

    def _step_block(self):
        """One pipelined block cycle: dispatch the next K-step block from
        the on-device carry, THEN read back and book the previous block —
        the fetch and host work overlap the new block's device time. When
        slots changed since the in-flight block was dispatched (the carry
        was dropped), that block is retired first: host state lags it by K
        steps, so dispatching from host state would replay them. Paged
        lanes grow their tables first; a preemption drops the carry, so
        the pickup below sees it."""
        k = self.block_size
        with self._lock:
            if self._pager is not None and not self._shutdown:
                self._ensure_decode_pages_locked(k)
            stale = self._inflight if self._carry is None else None
            if stale is not None:
                self._inflight = None
        if stale is not None:
            self._retire_block(stale)
        dispatch = None
        with self._lock:
            snapshot = [(s, self._slots[s]) for s in range(self.num_slots)
                        if self._slots[s] is not None]
            prev, self._inflight = self._inflight, None
            if snapshot:
                self._step_no += k
                self._stats["decode_steps"] += k
                self._stats["decode_blocks"] += 1
                carry = self._carry
                if carry is None:
                    # free lanes launch frozen: they touch only their own
                    # cell (paged: the null page) until a refill
                    carry = (self._last_ids.copy(), self._positions.copy(),
                             np.asarray([r is None for r in self._slots]))
                ptab = None if self._pager is None else self._ptables.copy()
                dispatch = (carry, self._step_no - k, self._temps.copy(),
                            self._eos_ids.copy(), ptab)
        if dispatch is not None:
            (ids, pos, stop), step0, temps, eos, ptab = dispatch
            toks, ids_d, pos_d, stop_d, self._caches = \
                self.decoder.decode_block(
                    self._caches, ids, pos, temps, seed=self.seed,
                    block_size=k, eos_ids=eos, stopped=stop, step0=step0,
                    key_salt=ENGINE_KEY_SALT, ptables=ptab)
            with self._lock:
                if not self._shutdown:
                    self._carry = (ids_d, pos_d, stop_d)
                    self._inflight = (start_fetch(toks), snapshot, k)
        if prev is not None and dispatch is not None:
            self._retire_block(prev)

    def _retire_block(self, block):
        """Read one block's [S, K] tokens (ONE readback) and book them:
        per-lane appends until a stop, slot frees, completions."""
        copy, snapshot, k = block
        host = device_fetch(copy, tag="engine.decode")
        finished: List[GenerationRequest] = []
        with self._lock:
            if self._shutdown:
                return
            self._stats["host_readbacks"] += 1
            for s, req in snapshot:
                if req.done() or self._slots[s] is not req:
                    continue          # finished since dispatch: overshoot
                closed = False
                for c in range(k):
                    tok = int(host[s, c])
                    req.generated.append(tok)
                    self._stats["emitted_tokens"] += 1
                    if self._req_finished(req, tok):
                        self._slots[s] = None
                        self._release_slot_pages(s)
                        self._stats["completed"] += 1
                        finished.append(req)
                        closed = True
                        break
                if not closed:
                    self._positions[s] += k
                    self._last_ids[s] = int(host[s, k - 1])
            if finished:
                # freed lanes must not keep decoding from the device carry
                self._carry = None
        for req in finished:
            req._complete()

    # ------------------------------------------------ speculative decoding
    def _draft_locked(self, snapshot) -> np.ndarray:
        """[S, spec_k] drafts: each occupied lane's drafter syncs to its
        request's context (rebuilt when the occupant changed) and
        proposes; free lanes keep zeros (they dispatch frozen)."""
        draft = np.zeros((self.num_slots, self.spec_k), np.int64)
        for s, req in snapshot:
            d = self._drafters.get(s)
            if d is None:
                d = self._drafters[s] = NGramDrafter(self.spec_ngram)
            d.sync(req, req.prompt, req.generated)
            draft[s] = d.draft(self.spec_k)
        return draft

    def _rewind_slot_pages_locked(self, s: int) -> None:
        """Truncate slot ``s``'s mapping to cover its retired position:
        pages past the accepted length go back (entries to the null page,
        one unref each). Rejected cells inside kept pages need nothing:
        the next dispatch rewrites them before anything attends them."""
        keep = max(1, -(-int(self._positions[s]) // self.page_size))
        pages = self._slot_pages[s]
        if len(pages) <= keep:
            return
        drop, self._slot_pages[s] = pages[keep:], pages[:keep]
        self._ptables[s, keep:] = 0
        for pid in drop:
            self._pager.unref(pid)

    def _step_spec(self):
        """One draft / verify block. Drafting extends each lane's last
        retired suffix, so the block runs from host state: an in-flight
        plain block retires first, and the verify block's single [S, K+2]
        readback is taken at once."""
        kd = self.spec_k
        with self._lock:
            stale, self._inflight = self._inflight, None
            self._carry = None
        if stale is not None:
            self._retire_block(stale)
        with self._lock:
            if self._shutdown:
                return
            if self._pager is not None:
                # the window's furthest write is position + kd; nothing
                # is in flight, so there is no lead
                self._ensure_decode_pages_locked(kd + 1)
            snapshot = [(s, self._slots[s]) for s in range(self.num_slots)
                        if self._slots[s] is not None]
            if not snapshot:
                return
            draft = self._draft_locked(snapshot)
            self._step_no += kd + 1
            self._stats["decode_steps"] += kd + 1
            self._stats["decode_blocks"] += 1
            self._stats["spec_blocks"] += 1
            self._stats["spec_drafted"] += kd * len(snapshot)
            stop = np.asarray([r is None for r in self._slots])
            ids, pos = self._last_ids.copy(), self._positions.copy()
            temps, eos = self._temps.copy(), self._eos_ids.copy()
            ptab = None if self._pager is None else self._ptables.copy()
            step0 = self._step_no - (kd + 1)
        toks, _, _, _, self._caches = self.decoder.verify_block(
            self._caches, ids, pos, draft, temps, seed=self.seed,
            eos_ids=eos, stopped=stop, step0=step0,
            key_salt=ENGINE_KEY_SALT, ptables=ptab)
        self._retire_spec(toks, snapshot, kd)

    def _retire_spec(self, toks, snapshot, kd: int) -> None:
        """Read one verify block's [S, K+1 tokens | emit] (ONE readback)
        and append each lane's accepted prefix; open lanes advance by what
        they emitted (the slab's rewind) and paged lanes truncate their
        tables. The acceptance average decides the cooldown."""
        host = device_fetch(toks, tag="engine.decode")
        finished: List[GenerationRequest] = []
        drafted = accepted = emitted = 0
        with self._lock:
            if self._shutdown:
                return
            self._stats["host_readbacks"] += 1
            for s, req in snapshot:
                if req.done() or self._slots[s] is not req:
                    continue
                take = int(host[s, kd + 1])
                drafted += kd
                accepted += max(0, take - 1)
                took = 0
                for c in range(take):
                    tok = int(host[s, c])
                    req.generated.append(tok)
                    took += 1
                    if self._req_finished(req, tok):
                        self._slots[s] = None
                        self._release_slot_pages(s)
                        self._stats["completed"] += 1
                        finished.append(req)
                        break
                emitted += took
                if self._slots[s] is req and took:
                    self._positions[s] += took
                    self._last_ids[s] = int(host[s, took - 1])
                    if self._pager is not None:
                        self._rewind_slot_pages_locked(s)
            self._stats["spec_accepted_tokens"] += accepted
            self._stats["spec_emitted_tokens"] += emitted
            self._stats["emitted_tokens"] += emitted
            if drafted:
                rate = accepted / drafted
                self._spec_ewma = rate if self._spec_ewma is None else \
                    0.7 * self._spec_ewma + 0.3 * rate
                if self._spec_ewma < self.spec_threshold:
                    self._spec_cool = self.spec_probe_every
        for req in finished:
            req._complete()

    def stats(self) -> Dict[str, int]:
        """Serving counters plus the live queue depth and active slots."""
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = len(self._pending)
            out["active_slots"] = sum(r is not None for r in self._slots)
        return out

    # ---------------------------------------------------------- execution
    def run_until_drained(self):
        """Synchronous mode: process the queue to empty. With refill on,
        freed slots re-admit between blocks; with refill off, each
        admitted wave drains fully before the next."""
        while True:
            self._admit()
            if not self._any_active():
                if not self._pending:
                    return
                continue                      # wave finished at token 1
            while self._any_active():
                self._step()
                if self.refill:
                    self._admit()

    def _serve_loop(self):
        try:
            while not self._shutdown:
                if not self._any_active():
                    self._admit()
                if not self._any_active():
                    self._work.wait(timeout=0.05)
                    self._work.clear()
                    continue
                self._step()
                if self.refill:
                    self._admit()
        except BaseException as exc:  # noqa: BLE001 — don't strand callers
            # a dying worker fails every outstanding request and marks the
            # engine dead, so later submit()s fail fast with the cause
            with self._lock:
                self._dead = exc
            self._fail_outstanding(exc)
            raise

    def _fail_outstanding(self, exc: BaseException) -> None:
        with self._lock:
            doomed = list(self._admitting)
            self._admitting = []
            for s in range(self.num_slots):
                if self._slots[s] is not None:
                    doomed.append(self._slots[s])
                    self._slots[s] = None
            self._release_all_pages()
            doomed.extend(self._pending)
            self._pending.clear()
            self._inflight = None
            self._carry = None
            self._stats["failed"] += len(doomed)
        for req in doomed:
            req._fail(exc)

    def start(self) -> "SlotGenerationEngine":
        if self._worker is None or not self._worker.is_alive():
            self._shutdown = False
            self._worker = threading.Thread(target=self._serve_loop,
                                            daemon=True)
            self._worker.start()
        return self

    def shutdown(self):
        """Stop the worker and fail whatever is still queued or decoding —
        a caller blocked in result() must not hang forever."""
        with self._lock:
            self._shutdown = True
        self._work.set()
        if self._worker is not None and \
                self._worker is not threading.current_thread():
            self._worker.join(timeout=5)
        self._fail_outstanding(self._dead or RuntimeError(
            "SlotGenerationEngine shut down"))
