"""KV-cache autoregressive decoding and slot-based continuous batching (the
JAX package's ``models/generation.py``: the slab cache, the paged cache
with its prefix cache, speculative decoding, and the serving engine's
scheduling and resilience tier).

- :class:`TransformerDecoder` runs a causal decoder-only ComputationGraph
  with a preallocated [B, H, T_max, Dh] cache per attention layer (the
  slab) or a pool of [P, H, page_size, Dh] pages read through per-slot
  page tables (paged): ``prefill`` / ``prefill_slots`` (one ordinary
  forward over the padded prompts; attention goes through the helper
  seam, i.e. a hand-written kernel on the card), ``prefill_chunk`` (one
  slot's prompt window into the slab), ``paged_prefill`` (tail windows
  straight into pages), ``decode_step``, ``decode_block`` /
  ``paged_decode_block`` (K decode steps dispatched back to back with the
  stop flags and positions kept on the device), ``verify_block`` /
  ``paged_verify_block`` (one forward over a drafted window with the
  acceptance on the device), ``recompute_logits`` (the no-cache forward),
  ``kv_export`` / ``kv_import`` (page frames), and the scrub and corrupt
  scatters of the integrity defence. ``sentinel=True`` folds a per-row
  finite / bound verdict over the logits into the serving programs'
  outputs as one more column. ``generate`` pipelines blocks with one host
  readback per block.
- :class:`SlotGenerationEngine` serves a request queue over ``num_slots``
  lanes: batched pow2-bucketed admission with one readback per admission,
  the double-buffered block pipeline (block t+1 is dispatched from the
  on-device carry before block t's tokens are read back), refill of freed
  slots, ``max_pending`` shedding. ``paged=True`` maps pages lazily,
  shares resident prompt prefixes and preempts under pool pressure;
  ``speculative=True`` drafts with :class:`~.speculative.NGramDrafter`
  and verifies K drafts a block. The scheduling tier: deadlines and
  ``cancel()``, EDF order, headroom shedding, chunked prefill and adaptive
  K. The resilience tier: the numerics sentinel and the prefix-page
  verifier (``integrity=``), fault injection, and the hooks
  ``parallel.failures.EngineSupervisor`` restarts through.

A JAX ``scan`` becomes a Python loop of device launches that never waits
for the device; ``jit`` has no counterpart here. Caches and pools are
updated in place. Selection: greedy (argmax of f32 logits) where a row's
temperature is <= 0, else Gumbel-max sampling from bf16-ROUNDED logits
with a generator seeded per ABSOLUTE step (a Philox generator on the
card), so a fixed seed gives the same tokens for every block size K.

Not in this slice: disaggregated handoff, the journal, tracing, metrics
and the flight recorder, and mesh sharding."""

from __future__ import annotations

import collections
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.conf.layers import SelfAttentionLayer, TokenAndPositionEmbedding
from ..nn.graph.vertices import LayerVertex
from ..observability.clock import interval_now
from ..observability.integrity import (NumericalFault, PageVerifier,
                                       as_integrity, logits_fault,
                                       page_content_checksum)
from ..ops import rng as rngmod
from ..ops.transfer import device_fetch, start_fetch, to_device
from ..parallel.faults import (NULL_INJECTOR, Cancelled, DeadlineExceeded,
                               RejectedError)
from .paging import PageAllocator, chain_digests
from .speculative import NGramDrafter

#: seed salts: the engine's decode and admission selections never share a
#: seed with each other or with TransformerDecoder.generate's
ENGINE_KEY_SALT = 1 << 20
PREFILL_BATCH_SALT = 1 << 21
CHUNK_SALT = 1 << 22

#: creation order: the EDF tie-break (equal deadlines pop FIFO), carried
#: by the request across requeues
_REQ_SEQ = itertools.count()

#: the engine's counters, the keys of stats() besides the two gauges
#: (queue_depth, active_slots), under the JAX package's names
_ENGINE_COUNTERS = ("emitted_tokens", "completed", "decode_steps",
                    "decode_blocks", "host_readbacks", "prefills",
                    "prefill_batches", "prefill_chunks", "rejected",
                    "headroom_shed", "deadline_exceeded", "cancelled",
                    "requeued", "failed", "page_preempted",
                    "prefix_cache_hits", "prefix_cache_misses",
                    "prefix_cache_hit_tokens", "spec_blocks",
                    "spec_drafted", "spec_accepted_tokens",
                    "spec_emitted_tokens", "spec_fallbacks",
                    "numerical_faults", "kv_page_corruptions")


def _round_up_pow2(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class TransformerDecoder:
    """Cache-aware executor for a causal decoder-only ComputationGraph.

    ``t_max`` bounds the context (prompt + generated) a cache row holds;
    it defaults to the embedding's max_length and may not exceed it. The
    decoder runs on the net's device, in the net's compute dtype.

    ``sentinel=True`` makes the serving programs (``prefill_slots``,
    ``prefill_chunk``, ``paged_prefill``, the decode and verify blocks)
    return their per-row numerics verdict (:func:`~..observability.
    integrity.logits_fault` with ``logit_bound``) as one more int column
    of the token tensor they already return, so it crosses to the host in
    the same readback. An engine must agree with its decoder's setting."""

    def __init__(self, net, t_max: Optional[int] = None,
                 sentinel: bool = False,
                 logit_bound: Optional[float] = 1e4):
        self.sentinel = bool(sentinel)
        self.logit_bound = None if logit_bound is None \
            else float(logit_bound)
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
        #: weight casts made so far: engines rebuilt around this decoder
        #: (a supervisor restart) reuse the cast weights and add none
        self.param_casts = 0

    # ------------------------------------------------------------- params
    def _device_params(self):
        """Params cast once to the net's compute dtype (recast only when
        ``net.params`` is replaced)."""
        if self._cast_params is None or self._cast_src is not self.net.params:
            self._cast_params = self.net._cast_params(self.net.params)
            self._cast_src = self.net.params
            self.param_casts += 1
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

    def _walk_recompute(self, params, state, tokens, lengths):
        """The no-cache forward: one teacher-forced pass over padded
        contexts [B, Tp] through ``SelfAttentionLayer.forward`` with a key
        mask (so attention takes the helper seam: B1 on the card at
        Tp <= 512), writing no cache. Returns the logits at each row's
        last real position [B, V] f32."""
        conf = self.net.conf
        tp = tokens.shape[1]
        kmask = (torch.arange(tp, device=self.device)[None, :] <
                 lengths[:, None]).float()
        acts = {self.input_name: tokens}
        logits = None
        for name in conf.topological_order:
            v = conf.vertices[name]
            xs = [acts[i] for i in conf.vertex_inputs[name]]
            if name == self.output_name:
                rows = torch.arange(tokens.shape[0], device=self.device)
                h_last = xs[0][rows, (lengths - 1).clamp(min=0)][:, None]
                logits = v.layer.preoutput(params[name], h_last)[:, 0]
            elif isinstance(v, LayerVertex) and \
                    isinstance(v.layer, SelfAttentionLayer):
                acts[name], _ = v.layer.forward(params[name], state[name],
                                                xs[0], mask=kmask)
            else:
                acts[name], _ = v.forward(params[name], state[name], xs)
        return logits.float()

    def _fault_of(self, logits, stop=None):
        """The sentinel's per-row verdict [B] bool; frozen lanes
        (``stop``) are exempt: their overshoot logits are never used."""
        bad = logits_fault(logits, self.logit_bound)
        return bad if stop is None else bad & ~stop

    def _with_verdict(self, sel, logits, fault_in=None):
        """Sentinel decoders: [B] ids → [B, 2] (id, verdict), the verdict
        ORed into ``fault_in`` (a windowed prefill's accumulated one)."""
        if not self.sentinel:
            return sel
        fault = self._fault_of(logits).long()
        if fault_in is not None:
            fault = fault | self._to_dev(fault_in, torch.long)
        return torch.stack([sel, fault], dim=1)

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
        f32, caches). ``seed`` seeds this selection's draw. No verdict
        column: the caller holds the logits."""
        return self._prefill(caches, tokens, lengths, None, temps, seed)

    @torch.no_grad()
    def prefill_slots(self, caches, tokens, lengths, slots, temps=None,
                      seed: int = 0):
        """Batched admission: one forward over [M, Tp] writes row i's k/v
        into cache row ``slots[i]`` (None: rows 0..M-1). Padded rows may
        repeat a slot with identical data. A sentinel decoder returns
        [M, 2] (id, verdict) in place of the ids."""
        sel, logits, caches = self._prefill(caches, tokens, lengths, slots,
                                            temps, seed)
        return self._with_verdict(sel, logits), logits, caches

    def _prefill(self, caches, tokens, lengths, slots, temps, seed):
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
    def prefill_chunk(self, caches, tokens, pos0: int, valid: int,
                      slot: int, temps=None, seed: int = 0, fault_in=None):
        """One slot's prompt window into the slab: tokens [1, C] at
        absolute positions [pos0, pos0 + valid) of cache row ``slot``,
        attending the cells earlier windows filled. Only that row's cells
        are written (the window runs on a view of the row), so decode
        blocks of other lanes may be in flight. Returns (selected next id
        [1], or [1, 2] (id, verdict) on a sentinel decoder with the
        verdict ORed into ``fault_in``; the logits at the window's last
        valid position [1, V] f32; caches), like :meth:`paged_prefill`
        (the JAX package's returns (ids, caches))."""
        host_t, temps_d = self._temps(temps, 1)
        s = int(slot)
        row = {n: {kk: caches[n][kk][s:s + 1] for kk in ("k", "v")}
               for n in self.attn_names}
        logits = self._walk_window(
            self._device_params(), self.net._inference_state(), row,
            self._to_dev(tokens, torch.long),
            self._to_dev(np.asarray([pos0]), torch.long),
            self._to_dev(np.asarray([valid]), torch.long), last=True)
        sel = self._select(logits, temps_d, seed, bool((host_t > 0).any()))
        return self._with_verdict(sel, logits, fault_in), logits, caches

    @torch.no_grad()
    def recompute_logits(self, tokens, lengths, temps=None, seed: int = 0):
        """The no-cache baseline step: one full forward over padded
        contexts [B, Tp] (true lengths [B]) and decode_step's selection.
        Returns (ids [B], logits [B, V] f32)."""
        host_t, temps_d = self._temps(temps, np.shape(tokens)[0])
        logits = self._walk_recompute(
            self._device_params(), self.net._inference_state(),
            self._to_dev(tokens, torch.long), self._to_dev(lengths,
                                                           torch.long))
        return (self._select(logits, temps_d, seed, bool((host_t > 0).any())),
                logits)

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
        :meth:`paged_decode_block`). A sentinel decoder returns toks
        [B, K + 1]: column K is each lane's verdict ORed over the block's
        steps (a lane frozen at a step is exempt at that step)."""
        b = np.shape(ids)[0]
        k = int(block_size)
        host_t, temps_d = self._temps(temps, b)
        sample = bool((host_t > 0).any())
        eos, stop, ids, pos, ptab = self._carry_in(b, ids, positions,
                                                   eos_ids, stopped,
                                                   ptables)
        params = self._device_params()
        state = self.net._inference_state()
        toks = torch.empty((b, k + int(self.sentinel)), dtype=torch.long,
                           device=self.device)
        fault = torch.zeros(b, dtype=torch.bool, device=self.device) \
            if self.sentinel else None
        for j in range(k):
            logits = self._walk_decode(params, state, caches, ids,
                                       pos.clamp(max=self.t_max - 1), ptab)
            if self.sentinel:
                fault = fault | self._fault_of(logits, stop)
            nxt = self._select(logits, temps_d, rngmod.fold_in(
                seed, key_salt | (step0 + j + 1)), sample)
            nxt = torch.where(stop, ids, nxt)
            hit_eos = (eos >= 0) & (nxt == eos)
            pos = torch.where(stop, pos, pos + 1)
            stop = stop | hit_eos | (pos >= self.t_max)
            ids = nxt
            toks[:, j] = nxt
        if self.sentinel:
            toks[:, k] = fault.long()
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
                      temps=None, seed: int = 0, fault_in=None):
        """Batched tail prefill into page pools: tokens [M, C] are each
        row's prompt tail starting at absolute position ``pos0`` [M] (0 on
        a prefix-cache miss), ``valid`` [M] real tokens a row, ``ptables``
        [M, NP] the rows' page tables. Returns (selected next ids [M],
        last-position logits [M, V] f32, caches), like
        :meth:`prefill_slots` (the JAX package's returns (ids, pools)). A
        sentinel decoder returns [M, 2] (id, verdict) ids, the verdict
        ORed into ``fault_in`` [M] (a chunked tail's earlier windows)."""
        host_t, temps_d = self._temps(temps, np.shape(tokens)[0])
        valid_d = self._to_dev(valid, torch.long)
        logits = self._walk_window(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(tokens, torch.long), self._to_dev(pos0, torch.long),
            valid_d, self._to_dev(ptables, torch.long), last=True)
        sel = self._select(logits, temps_d, seed, bool((host_t > 0).any()))
        return self._with_verdict(sel, logits, fault_in), logits, caches

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

    @torch.no_grad()
    def scrub_slot(self, caches, slots):
        """Zero whole slab rows ``slots`` in place (after a sentinel
        fault: a chunk-admitted successor writes only its windows, and
        residual NaN past its fill point would reach it through the masked
        probs·V product, since 0 × NaN is NaN). Returns the caches."""
        idx = self._to_dev(np.asarray(slots), torch.long)
        for n in self.attn_names:
            for kk in ("k", "v"):
                caches[n][kk][idx] = 0
        return caches

    @torch.no_grad()
    def scrub_pages(self, caches, pids):
        """Zero pool pages ``pids`` in place before they are reused (the
        same 0 × NaN hazard as :meth:`scrub_slot`). Returns the pools."""
        return self.scrub_slot(caches, pids)

    @torch.no_grad()
    def corrupt_page(self, caches, pid: int, mode: str = "nan"):
        """Chaos only: poison pool page ``pid`` in place: NaN fill
        (``"nan"``, trips the sentinel) or sign flip (``"flip"``,
        plausible values only content checksums catch)."""
        for n in self.attn_names:
            for kk in ("k", "v"):
                page = caches[n][kk][int(pid)]
                page.copy_(torch.full_like(page, float("nan"))
                           if mode == "nan" else -page)
        return caches

    @torch.no_grad()
    def corrupt_cache(self, caches, slot: int, pos: int,
                      mode: str = "nan"):
        """Chaos only: poison slab cell (``slot``, ``pos``) in place, as
        :meth:`corrupt_page` does a page."""
        for n in self.attn_names:
            for kk in ("k", "v"):
                cell = caches[n][kk][int(slot), :, int(pos)]
                cell.copy_(torch.full_like(cell, float("nan"))
                           if mode == "nan" else -cell)
        return caches

    # ------------------------------------------------------- speculation
    @torch.no_grad()
    def verify_block(self, caches, ids, positions, draft, temps=None,
                     seed: int = 0, *, eos_ids=None, stopped=None,
                     step0: int = 0, key_salt: int = 0, ptables=None):
        """Verify ``draft`` [B, K] candidate tokens in ONE forward over the
        window [last id | draft] at positions [pos, pos + K]. Returns
        ``(out [B, K + 2], ids [B], positions [B], stopped [B], caches)``
        (a sentinel decoder's out has a verdict column K + 2) on the
        device: row b emits ``out[b, :out[b, K + 1]]``, the
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
        ids, positions, stopped); a sentinel decoder appends a verdict
        column over the positions whose selections are emitted (a
        rejected tail's logits conditioned on a rejected draft)."""
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
        out = torch.cat([sel, emit[:, None]], dim=1)
        if self.sentinel:
            faults = torch.stack([self._fault_of(logits[:, j], stopped)
                                  for j in range(kq)], dim=1)
            fault = (faults & (idxs < emit[:, None])).any(dim=1)
            out = torch.cat([out, fault.long()[:, None]], dim=1)
        return out, new_ids, new_pos, new_stop

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

        def fetch_block(copy) -> np.ndarray:
            """A block's tokens; a sentinel decoder's verdict column fails
            the whole call (this entry point has no per-request
            recovery)."""
            arr = device_fetch(copy, tag="generate.decode")
            if not self.sentinel:
                return arr
            bad = np.nonzero(arr[:, -1])[0]
            if len(bad):
                raise NumericalFault(
                    f"numerics sentinel tripped on row(s) {bad.tolist()}: "
                    "non-finite or out-of-bound logits in a decode block — "
                    "tokens dropped")
            return arr[:, :-1]

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
                consume(fetch_block(pending))
                if finished.all():
                    pending = None     # the in-flight block is overshoot
                    break
            pending = copy
        if pending is not None:
            consume(fetch_block(pending))
        return results()


class GenerationRequest:
    """Handle for one queued prompt; ``result()`` blocks until the engine
    completes it (the full [prompt + generated] id array).

    States: PENDING (queued), RUNNING (holds a cache slot), DONE, FAILED,
    CANCELLED. ``deadline`` (seconds from submission) is enforced by the
    engine while queued, while chunk-prefilling and mid-decode: the slot is
    freed and ``result()`` raises :class:`DeadlineExceeded`. ``cancel()``
    takes the same path with :class:`Cancelled` at the engine's next
    sweep. ``add_done_callback`` hooks fire once, outside the engine
    lock."""

    PENDING = "PENDING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    def __init__(self, prompt, max_new_tokens: int, temperature: float,
                 eos_id: Optional[int], deadline: Optional[float] = None):
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.deadline = None if deadline is None else float(deadline)
        self._deadline_t = None if deadline is None \
            else interval_now() + float(deadline)
        self.generated: List[int] = []
        self._seq = next(_REQ_SEQ)
        self._done = threading.Event()
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._running = False
        self._cancel_requested = False
        self._engine = None            # set at submit; woken on cancel
        self._cb_lock = threading.Lock()
        self._callbacks: List = []

    def _complete(self):
        self._result = np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int64)]).astype(
                np.int32)
        self._running = False
        self._done.set()
        self._fire_callbacks()

    def _fail(self, exc: BaseException):
        self._error = exc
        self._running = False
        self._done.set()
        self._fire_callbacks()

    def _fire_callbacks(self):
        # drained under the lock, fired outside it: each registered
        # callback runs exactly once, even racing add_done_callback
        with self._cb_lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:   # noqa: BLE001 — a bad hook must not
                pass            # strand the engine thread completing us

    def add_done_callback(self, fn) -> None:
        """Call ``fn(request)`` once the request is DONE, FAILED or
        CANCELLED: from the thread that ends it, or at once in this thread
        if it already ended. An exception in ``fn`` is swallowed."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:   # noqa: BLE001 — same contract as above
            pass

    def _expired(self, now: Optional[float] = None) -> bool:
        return self._deadline_t is not None and \
            (now if now is not None else interval_now()) > self._deadline_t

    def done(self) -> bool:
        return self._done.is_set()

    @property
    def state(self) -> str:
        if self._done.is_set():
            if self._error is None:
                return self.DONE
            if isinstance(self._error, Cancelled):
                return self.CANCELLED
            return self.FAILED
        return self.RUNNING if self._running else self.PENDING

    def cancel(self) -> bool:
        """Ask for cancellation; False if the request already ended. A
        queued request fails before taking a slot, a running one frees
        its slot."""
        if self._done.is_set():
            return False
        self._cancel_requested = True
        eng = self._engine
        if eng is not None:
            eng._work.set()            # wake an idle serve loop
        return True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("generation not finished")
        if self._error is not None:
            raise self._error
        return self._result

    def __repr__(self) -> str:
        dl = "" if self.deadline is None else f" deadline={self.deadline}s"
        err = "" if self._error is None \
            else f" error={type(self._error).__name__}"
        return (f"<GenerationRequest {self.state} prompt_len="
                f"{len(self.prompt)} generated={len(self.generated)}/"
                f"{self.max_new_tokens}{dl}{err}>")


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

    Scheduling (all off by default, leaving every path above as it was):
    ``submit(..., deadline=)`` and ``GenerationRequest.cancel()`` free a
    slot mid-decode; ``scheduling="edf"`` pops the earliest absolute
    deadline first (FIFO among equal deadlines, no deadline last);
    ``shed_headroom=True`` rejects at admission a request the measured
    prefill and per-step latencies (moving averages) project to miss its
    deadline by ``headroom_margin``, with ``RejectedError.
    projected_miss_s``; ``prefill_chunk=C`` prefills a context longer
    than C in C-token windows, one window a serve-loop cycle with decode
    blocks in between, so a long prompt cannot stall the other lanes;
    ``adaptive_block=True`` picks K per block from ``block_ladder`` by
    queue depth, capped so a block stays under ``block_latency_target``
    seconds.

    Resilience: ``integrity=`` (an ``IntegrityConfig`` or True) turns on
    the numerics sentinel, whose verdict rides the readbacks the engine
    already makes (a tripped request fails with ``NumericalFault`` and
    streams none of the poisoned block's tokens), and on a paged engine
    checksums prefix-cache pages at registration and verifies them on
    hits. ``fault_injector`` arms the ``engine.step`` / ``engine.prefill``
    points and the corruption payloads. A supervisor
    (``parallel.failures.EngineSupervisor``) attaches through the
    heartbeat and crash hooks and takes over with ``quarantine()`` /
    ``requeue()``: a recovered request re-prefills prompt + tokens so far,
    exactly once.

    Synchronous use: ``submit(...)`` then ``run_until_drained()``. Serving
    use: ``start()`` runs the loop on a worker thread; ``shutdown()``."""

    def __init__(self, net, num_slots: int = 8,
                 t_max: Optional[int] = None, refill: bool = True,
                 seed: int = 0, decoder: Optional[TransformerDecoder] = None,
                 max_pending: int = 256, fault_injector=None,
                 block_size: int = 1, device=None, scheduling: str = "fifo",
                 shed_headroom: bool = False, headroom_margin: float = 1.0,
                 prefill_chunk: Optional[int] = None,
                 adaptive_block: bool = False,
                 block_ladder: Optional[Sequence[int]] = None,
                 block_latency_target: float = 0.25,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_cache: bool = True,
                 integrity=None, speculative: bool = False,
                 spec_k: Optional[int] = None, spec_ngram: int = 3,
                 spec_threshold: float = 0.35, spec_probe_every: int = 16):
        if decoder is not None and t_max is not None and \
                decoder.t_max != t_max:
            raise ValueError(f"shared decoder has t_max {decoder.t_max}, "
                             f"engine asked for {t_max}")
        self._integrity = as_integrity(integrity)
        want_sentinel = self._integrity is not None and \
            self._integrity.sentinel
        if decoder is not None and decoder.sentinel != want_sentinel:
            raise ValueError(
                f"shared decoder sentinel={decoder.sentinel} but the "
                f"engine's integrity config wants {want_sentinel}: the "
                "sentinel changes the programs' outputs, so decoder and "
                "engine must agree (build the shared decoder with "
                "sentinel=, or drop integrity=)")
        self.decoder = decoder if decoder is not None \
            else TransformerDecoder(
                net, t_max=t_max, sentinel=want_sentinel,
                logit_bound=None if self._integrity is None
                else self._integrity.logit_bound)
        self._sentinel_on = want_sentinel
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
        self.t_max = self.decoder.t_max
        # ---- scheduling tier
        if scheduling not in ("fifo", "edf"):
            raise ValueError(f"scheduling must be 'fifo' or 'edf', "
                             f"got {scheduling!r}")
        self.scheduling = scheduling
        self.shed_headroom = bool(shed_headroom)
        self.headroom_margin = float(headroom_margin)
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if not 1 <= prefill_chunk <= self.t_max:
                raise ValueError(f"prefill_chunk {prefill_chunk} must be "
                                 f"in [1, t_max={self.t_max}]")
        self.prefill_chunk = prefill_chunk
        self.adaptive_block = bool(adaptive_block)
        ladder = tuple(sorted({int(k) for k in
                               (block_ladder or (1, 2, 4, 8))}))
        if any(k < 1 for k in ladder):
            raise ValueError(f"block_ladder rungs must be >= 1: {ladder}")
        self.block_ladder = ladder if self.adaptive_block \
            else (max(1, int(block_size)),)
        self.block_size = max(self.block_ladder) if self.adaptive_block \
            else max(1, int(block_size))
        self.block_latency_target = float(block_latency_target)
        # seconds a decode step and a prefill dispatch take (moving
        # averages under the engine lock): what the headroom shed and
        # adaptive K read
        self._est_step: Optional[float] = None
        self._est_prefill: Optional[float] = None
        self._faults = fault_injector if fault_injector is not None \
            else NULL_INJECTOR
        # ---- speculation
        self.speculative = bool(speculative)
        self.spec_k = max(1, int(spec_k)) if spec_k is not None \
            else max(self.block_size, 4)
        self.spec_ngram = max(1, int(spec_ngram))
        self.spec_threshold = float(spec_threshold)
        self.spec_probe_every = max(1, int(spec_probe_every))
        self._spec_ewma: Optional[float] = None     # acceptance average
        self._spec_cool = 0          # plain blocks until the next probe
        self._drafters: Dict[int, NGramDrafter] = {}
        # ---- the cache: slab or page pool
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
        # prefix-page checksums (paged engines with verification on)
        self._kv_verifier: Optional[PageVerifier] = None
        if self._integrity is not None and self._integrity.kv_verify \
                and self._integrity.verify_every and paged:
            self._kv_verifier = PageVerifier()
        self._kv_hit_ctr = 0
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
        # chunked prefill: slot -> [request, context, tokens filled,
        # verdict accumulated on the device or None]. A chunking slot is
        # occupied (the free list skips it) but its lane decodes frozen
        # until the final window lands the first token.
        self._chunking: Dict[int, List] = {}
        self._chunk_rr = 0
        self._pending: collections.deque = collections.deque()
        # popped from the queue but not yet in a slot, so a quarantine or
        # shutdown drain can always harvest them
        self._admitting: List[GenerationRequest] = []
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._step_no = 0
        self._worker: Optional[threading.Thread] = None
        self._shutdown = False
        self._dead: Optional[BaseException] = None
        # preemption drain: admission closed / the loop parked
        self._draining = False
        self._drain_stop = False
        # supervision hooks (EngineSupervisor._attach)
        self._supervised = False
        self._quarantined = False
        self._first_step_done = False
        self._on_crash = None       # callable(engine, exc)
        self._beat = None           # callable(), once a loop iteration
        self._stats = dict.fromkeys(_ENGINE_COUNTERS, 0)

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               eos_id: Optional[int] = None,
               deadline: Optional[float] = None) -> GenerationRequest:
        """Queue a request. ``deadline`` is seconds from now; a stopped,
        dead or draining engine, an invalid request, a full queue and
        (with ``shed_headroom``) a projected deadline miss fail the
        returned handle at once."""
        req = GenerationRequest(prompt, max_new_tokens, temperature, eos_id,
                                deadline=deadline)
        req._engine = self
        with self._lock:
            dead = self._dead
            stopped = self._shutdown or dead is not None
        if stopped:
            # the caller learns the engine is gone even for no-op requests
            req._fail(dead or RuntimeError("SlotGenerationEngine shut down"))
            return req
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
        headroom_exc = None
        if self.shed_headroom and req._deadline_t is not None:
            headroom_exc = self._headroom_check(req)
        shed = None
        with self._lock:
            # re-checked in the append's critical section: a dying loop
            # marks itself dead under this lock before it drains the
            # queue, so nothing is queued after the last drain
            dead = self._dead
            queued = not (self._shutdown or dead is not None)
            if queued and self._draining:
                self._stats["rejected"] += 1
                shed = RejectedError("engine draining for preemption — "
                                     "request shed")
            elif queued and headroom_exc is not None:
                self._stats["rejected"] += 1
                self._stats["headroom_shed"] += 1
                shed = headroom_exc
            elif queued:
                depth = len(self._pending)
                if depth >= self.max_pending:
                    self._stats["rejected"] += 1
                    shed = RejectedError(
                        f"pending queue full ({depth} queued, max_pending="
                        f"{self.max_pending}) — request shed",
                        queue_depth=depth)
                else:
                    self._pending.append(req)
        if shed is not None:
            req._fail(shed)
        elif not queued:
            req._fail(dead or RuntimeError("SlotGenerationEngine shut down"))
        else:
            self._work.set()
        return req

    def requeue(self, req: GenerationRequest) -> None:
        """Queue a recovered request (the supervisor's takeover): it
        re-prefills prompt + tokens so far and decodes on, token for token
        with an uninterrupted greedy run. Recovery bypasses admission
        control."""
        with self._lock:
            dead = self._dead
            alive = not (self._shutdown or dead is not None)
            if alive:
                req._running = False
                req._engine = self
                self._pending.append(req)
                self._stats["requeued"] += 1
        if not alive:
            req._fail(dead or RuntimeError("SlotGenerationEngine shut down"))
            return
        self._work.set()

    # --------------------------------------------------------- scheduling
    def _headroom_check(self, req: GenerationRequest,
                        remaining: Optional[int] = None
                        ) -> Optional[RejectedError]:
        """RejectedError iff the measured latencies project that ``req``
        cannot finish inside its deadline: one prefill dispatch per chunk
        window of its context plus ``remaining`` (default all its) tokens
        at the per-step average, times ``headroom_margin``. None while the
        averages are cold or the headroom suffices."""
        with self._lock:
            est, pre = self._est_step, self._est_prefill
        if est is None or req._deadline_t is None:
            return None
        tokens = req.max_new_tokens if remaining is None else remaining
        ctx = len(req.prompt) + len(req.generated)
        dispatches = 1
        if self.prefill_chunk is not None and ctx > self.prefill_chunk:
            dispatches = -(-ctx // self.prefill_chunk)
        need = ((pre or 0.0) * dispatches +
                max(0, tokens) * est) * self.headroom_margin
        headroom = req._deadline_t - interval_now()
        if need <= headroom:
            return None
        return RejectedError(
            f"projected deadline miss: needs ~{need:.3f}s (margin "
            f"{self.headroom_margin:g}) against {headroom:.3f}s headroom "
            f"— shed at admission", projected_miss_s=need - headroom)

    def _ewma_locked(self, attr: str, value: float) -> None:
        """Fold one observation into a latency average (caller holds the
        engine lock)."""
        old = getattr(self, attr)
        setattr(self, attr, value if old is None
                else 0.8 * old + 0.2 * value)

    def _choose_block_size(self) -> int:
        """Adaptive K: the largest rung no deeper than the queue (an idle
        queue gets the smallest, for latency), then stepped down while K
        steps at the measured per-step average exceed
        ``block_latency_target``."""
        with self._lock:
            depth = len(self._pending)
            est = self._est_step
        ladder = self.block_ladder
        k = ladder[0]
        for rung in ladder:
            if rung <= max(1, depth):
                k = rung
        if est is not None and est > 0:
            while k > ladder[0] and k * est > self.block_latency_target:
                k = max(r for r in ladder if r < k)
        return k

    def _edf_key(self, req: GenerationRequest):
        # earliest absolute deadline first; none sorts last; creation
        # order breaks ties, so equal deadlines never starve each other
        return (req._deadline_t if req._deadline_t is not None
                else float("inf"), req._seq)

    def _pop_for_admit(self) -> Optional[GenerationRequest]:
        """Pop the next queued request (the queue head, or with EDF the
        earliest deadline) and park it in ``_admitting`` in one critical
        section, so a drain never misses it."""
        with self._lock:
            req = None
            if self._pending:
                if self.scheduling == "edf":
                    best = min(range(len(self._pending)),
                               key=lambda i: self._edf_key(
                                   self._pending[i]))
                    req = self._pending[best]
                    del self._pending[best]
                else:
                    req = self._pending.popleft()
            if req is not None:
                self._admitting.append(req)
            return req

    def _unpark(self, req: GenerationRequest) -> bool:
        """Take ``req`` out of the admission park (caller holds the
        lock); False means a drain harvested it and owns it now."""
        if self._shutdown or req not in self._admitting:
            return False
        self._admitting.remove(req)
        return True

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
        return any(r is not None for r in self._slots) or \
            bool(self._chunking)

    def _occupy_locked(self, s: int, req: GenerationRequest, tok: int,
                       pos: int) -> None:
        self._slots[s] = req
        self._last_ids[s] = tok
        self._positions[s] = pos
        self._temps[s] = req.temperature
        self._eos_ids[s] = -1 if req.eos_id is None else int(req.eos_id)

    def _fail_faulted(self, faulted: List[GenerationRequest],
                      where: str) -> None:
        """Fail sentinel-tripped requests with NumericalFault, outside the
        engine lock. Their poisoned tokens were dropped; ``generated``
        holds only clean ones."""
        for req in faulted:
            req._fail(NumericalFault(
                f"numerics sentinel tripped ({where}): non-finite or "
                f"out-of-bound logits after {len(req.generated)} clean "
                "tokens — the poisoned tokens were dropped, nothing was "
                "served"))

    def _sweep_pending(self):
        """Fail queued requests that were cancelled or ran out of
        deadline before taking a slot."""
        now = interval_now()
        doomed: List[Tuple[GenerationRequest, BaseException]] = []
        with self._lock:
            if self._pending:
                keep: collections.deque = collections.deque()
                for req in self._pending:
                    if req._cancel_requested:
                        self._stats["cancelled"] += 1
                        doomed.append((req, Cancelled(
                            "cancelled while queued")))
                    elif req._expired(now):
                        self._stats["deadline_exceeded"] += 1
                        doomed.append((req, DeadlineExceeded(
                            f"deadline of {req.deadline}s passed while "
                            "queued")))
                    else:
                        keep.append(req)
                self._pending = keep
        for req, exc in doomed:
            req._fail(exc)

    def _enforce_slots(self):
        """Free the slots of requests cancelled or past their deadline
        mid-decode; refill reuses them."""
        now = interval_now()
        doomed: List[Tuple[GenerationRequest, BaseException]] = []
        with self._lock:
            for s in range(self.num_slots):
                req = self._slots[s]
                if req is None:
                    continue
                if req._cancel_requested:
                    exc = Cancelled(f"cancelled mid-decode after "
                                    f"{len(req.generated)} tokens")
                    self._stats["cancelled"] += 1
                elif req._expired(now):
                    exc = DeadlineExceeded(
                        f"deadline of {req.deadline}s exceeded after "
                        f"{len(req.generated)} tokens")
                    self._stats["deadline_exceeded"] += 1
                else:
                    continue
                self._slots[s] = None
                self._release_slot_pages(s)
                doomed.append((req, exc))
        for req, exc in doomed:
            req._fail(exc)

    def _next_admittable(self) -> Tuple[Optional[GenerationRequest],
                                        Optional[np.ndarray], bool]:
        """Pop the next request through the lifecycle gates (cancel,
        deadline, the headroom re-projection, a recovered request already
        at its stop), parked in ``_admitting`` throughout. Returns (req,
        context, aborted): req None and not aborted means the queue
        drained; aborted means a drain owns the popped request and
        admission must stop."""
        while True:
            req = self._pop_for_admit()
            if req is None:
                return None, None, False
            exc = None
            if req._cancel_requested:
                exc = Cancelled("cancelled while queued")
            elif req._expired():
                exc = DeadlineExceeded(f"deadline of {req.deadline}s "
                                       "passed while queued")
            elif self.shed_headroom:
                exc = self._headroom_check(
                    req, remaining=req.max_new_tokens - len(req.generated))
            if exc is not None:
                with self._lock:
                    if not self._unpark(req):
                        return None, None, True
                    if isinstance(exc, Cancelled):
                        self._stats["cancelled"] += 1
                    elif isinstance(exc, RejectedError):
                        self._stats["rejected"] += 1
                        self._stats["headroom_shed"] += 1
                    else:
                        self._stats["deadline_exceeded"] += 1
                req._fail(exc)
                continue
            # a requeued request re-prefills what it generated so far
            ctx = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int64)])
            if len(ctx) >= self.t_max or \
                    len(req.generated) >= req.max_new_tokens:
                with self._lock:      # recovered already at its stop
                    if not self._unpark(req):
                        return None, None, True
                    self._stats["completed"] += 1
                req._complete()
                continue
            return req, ctx, False

    def _enter_chunking(self, s: int, req: GenerationRequest,
                        ctx: np.ndarray, filled: int) -> bool:
        """Occupy slot ``s`` for windowed prefill from absolute position
        ``filled`` (0, or a paged prefix hit's length). The lane's decode
        write-head parks at the last cell: a frozen lane rewrites its own
        cell every block, and that cell is attended only at position
        t_max - 1, which decode overwrites first. The carry is dropped, so
        no in-flight lane state reaches the windows' cells. False: a drain
        owns the request."""
        with self._lock:
            if not self._unpark(req):
                return False
            self._chunking[s] = [req, ctx, filled, None]
            self._positions[s] = self.t_max - 1
            self._last_ids[s] = 0
            self._carry = None
            req._running = True
            self._stats["prefills"] += 1
        return True

    def _admit(self):
        """Batched admission: every admittable queued request that finds a
        free slot joins ONE bucketed prefill_slots call with a single
        readback; a context longer than ``prefill_chunk`` enters chunked
        prefill instead. A recovered request re-prefills prompt + tokens
        so far."""
        if self._pager is not None:
            return self._admit_paged()
        while True:
            with self._lock:
                free = [s for s in range(self.num_slots)
                        if self._slots[s] is None and
                        s not in self._chunking]
            if not free:
                return
            batch: List[Tuple[GenerationRequest, int, np.ndarray]] = []
            drained = False
            for s in free:
                req, ctx, aborted = self._next_admittable()
                if aborted:
                    return
                if req is None:
                    drained = True
                    break
                if self.prefill_chunk is not None and \
                        len(ctx) > self.prefill_chunk:
                    if not self._enter_chunking(s, req, ctx, 0):
                        return
                    continue
                batch.append((req, s, ctx))
            if not batch:
                return
            m = len(batch)
            mb = self._count_bucket(m)
            tp = min(_round_up_pow2(max(len(c) for _, _, c in batch)),
                     self.t_max)
            tokens = np.zeros((mb, tp), np.int64)
            lengths = np.zeros(mb, np.int64)
            slot_idx = np.zeros(mb, np.int64)
            temps = np.zeros(mb, np.float32)
            for i in range(mb):
                req, s, ctx = batch[i if i < m else 0]   # pad rows = row 0
                tokens[i, :len(ctx)] = ctx
                lengths[i] = len(ctx)
                slot_idx[i] = s
                temps[i] = req.temperature
            with self._lock:
                if self._shutdown:
                    return      # the batch stays parked for the drain
                self._stats["prefills"] += m
                self._stats["prefill_batches"] += 1
                batch_no = self._stats["prefill_batches"]
            t0 = interval_now()
            self._faults.fire("engine.prefill")
            nxt, _, self._caches = self.decoder.prefill_slots(
                self._caches, tokens, lengths, slot_idx, temps,
                seed=rngmod.fold_in(self.seed, PREFILL_BATCH_SALT | batch_no))
            toks = device_fetch(nxt, tag="engine.prefill")    # ONE readback
            t1 = interval_now()
            fault_col = None
            if self._sentinel_on:
                fault_col, toks = toks[:, 1], toks[:, 0]
            finishers: List[GenerationRequest] = []
            faulted: List[GenerationRequest] = []
            scrub_slots: List[int] = []
            with self._lock:
                if self._shutdown:
                    return      # a drain harvested the batch meanwhile
                self._stats["host_readbacks"] += 1
                self._ewma_locked("_est_prefill", t1 - t0)
                for i, (req, s, ctx) in enumerate(batch):
                    if req not in self._admitting:
                        continue
                    self._admitting.remove(req)
                    if fault_col is not None and fault_col[i]:
                        # the first token is suspect: never appended, the
                        # slot stays free and is scrubbed
                        scrub_slots.append(s)
                        self._stats["numerical_faults"] += 1
                        faulted.append(req)
                        continue
                    tok = int(toks[i])
                    req._running = True
                    req.generated.append(tok)
                    self._stats["emitted_tokens"] += 1
                    if self._req_finished(req, tok):
                        self._stats["completed"] += 1
                        finishers.append(req)
                    else:
                        self._occupy_locked(s, req, tok, len(ctx))
                # slot contents changed: the next block resyncs from host
                self._carry = None
            self._scrub_slots(scrub_slots)
            self._fail_faulted(faulted, "prefill")
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
            if not self._unpark(req):
                return
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
        chain prefix of its context read-only (verified against its
        checksums at the sampled rate) and allocates private pages for
        the rest; then ONE bucketed ``paged_prefill`` prefills only the
        tails, with one readback. A tail longer than ``prefill_chunk``
        enters chunked prefill, which allocates its pages window by
        window. Every full context page is then published into the prefix
        index."""
        ps = self.page_size
        while True:
            with self._lock:
                free = [s for s in range(self.num_slots)
                        if self._slots[s] is None and
                        s not in self._chunking]
            if not free:
                return
            batch: List[Tuple[GenerationRequest, int, np.ndarray, int]] = []
            drained = blocked = False
            for s in free:
                req, ctx, aborted = self._next_admittable()
                if aborted:
                    return
                if req is None:
                    drained = True
                    break
                # the tail must produce the next-token logits, so the match
                # stops one token short of the context
                shared, start = self._pager.match_and_ref(
                    ctx, max_tokens=len(ctx) - 1)
                if shared and self._kv_verifier is not None:
                    with self._lock:
                        self._kv_hit_ctr += 1
                        due = self._kv_hit_ctr % \
                            self._integrity.verify_every == 0
                    if due and self._verify_matched(ctx, shared) is not None:
                        shared, start = [], 0       # degrade to a miss
                chunked = self.prefill_chunk is not None and \
                    len(ctx) - start > self.prefill_chunk
                if chunked:
                    fresh: List[int] = []
                else:
                    # private pages cover [start, len(ctx)]: the tail and
                    # the cell the first decode token writes
                    n_need = len(ctx) // ps + 1 - len(shared)
                    fresh = self._pager.alloc(n_need)
                    if fresh is None:
                        for pid in shared:
                            self._pager.unref(pid)
                        self._pool_blocked(req, n_need,
                                           batch_live=bool(batch))
                        blocked = True
                        break
                pages = shared + fresh
                with self._lock:
                    if self._shutdown:
                        # the request stays parked for the drain
                        for pid in pages:
                            self._pager.unref(pid)
                        return
                    # mapped before dispatch: a drain's release owns it
                    self._map_slot_pages(s, pages)
                    if start:
                        self._stats["prefix_cache_hits"] += 1
                        self._stats["prefix_cache_hit_tokens"] += start
                    else:
                        self._stats["prefix_cache_misses"] += 1
                if chunked:
                    if not self._enter_chunking(s, req, ctx, start):
                        return
                    continue
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
            t0 = interval_now()
            self._faults.fire("engine.prefill")
            nxt, _, self._caches = self.decoder.paged_prefill(
                self._caches, tokens, pos0, valid, ptab, temps,
                seed=rngmod.fold_in(self.seed, PREFILL_BATCH_SALT | batch_no))
            toks = device_fetch(nxt, tag="engine.prefill")    # ONE readback
            t1 = interval_now()
            fault_col = None
            if self._sentinel_on:
                fault_col, toks = toks[:, 1], toks[:, 0]
            finishers: List[GenerationRequest] = []
            faulted: List[GenerationRequest] = []
            scrub: List[int] = []
            to_sum: List[Tuple[np.ndarray, int]] = []
            registered_ctx: Optional[np.ndarray] = None
            with self._lock:
                if self._shutdown:
                    return
                self._stats["host_readbacks"] += 1
                self._ewma_locked("_est_prefill", t1 - t0)
                for i, (req, s, ctx, start) in enumerate(batch):
                    if req not in self._admitting:
                        continue
                    self._admitting.remove(req)
                    if fault_col is not None and fault_col[i]:
                        # never registered, pages scrubbed and released,
                        # shared pages it attended evicted as suspect
                        scrub.extend(self._faulted_pages_locked(s))
                        self._stats["numerical_faults"] += 1
                        faulted.append(req)
                        continue
                    tok = int(toks[i])
                    req._running = True
                    req.generated.append(tok)
                    self._stats["emitted_tokens"] += 1
                    # full context pages are never written again (decode
                    # writes land past the context end): publish them
                    self._pager.register_chain(
                        ctx, self._slot_pages[s][:len(ctx) // ps])
                    if len(ctx) // ps:
                        registered_ctx = ctx
                    if self._kv_verifier is not None:
                        to_sum.append((ctx, len(ctx) // ps))
                    if self._req_finished(req, tok):
                        self._stats["completed"] += 1
                        finishers.append(req)
                        self._release_slot_pages(s)
                    else:
                        self._occupy_locked(s, req, tok, len(ctx))
                self._carry = None
            self._scrub_pages(scrub)
            self._fail_faulted(faulted, "paged_prefill")
            self._after_register(to_sum, registered_ctx)
            for req in finishers:
                req._complete()
            if drained or blocked:
                return

    def _advance_chunks(self):
        """One chunked-prefill window (round-robin over chunking slots),
        run by the serve loop between decode blocks. Cancelled or expired
        chunking requests free their slot first. A non-final window reads
        nothing back (a sentinel verdict accumulates on the device); the
        final one's single readback lands the first token and activates
        the lane. The final window slides left to fit the cache depth."""
        doomed: List[Tuple[GenerationRequest, BaseException]] = []
        entry = None
        with self._lock:
            if self._shutdown:
                return
            for s in sorted(self._chunking):
                req = self._chunking[s][0]
                if req._cancel_requested:
                    self._stats["cancelled"] += 1
                    exc = Cancelled("cancelled during chunked prefill")
                elif req._expired():
                    self._stats["deadline_exceeded"] += 1
                    exc = DeadlineExceeded(
                        f"deadline of {req.deadline}s passed during "
                        "chunked prefill")
                else:
                    continue
                doomed.append((req, exc))
                del self._chunking[s]
                self._release_slot_pages(s)
            if self._chunking:
                slots = sorted(self._chunking)
                s = slots[self._chunk_rr % len(slots)]
                self._chunk_rr += 1
                entry = (s, *self._chunking[s])
        for req, exc in doomed:
            req._fail(exc)
        if entry is None:
            return
        s, req, ctx, filled, fdev = entry
        c = self.prefill_chunk
        # windows sit at multiples of c; the final one may slide left over
        # filled cells (rewriting them from the same tokens) to fit t_max
        pos0 = filled if filled + c <= self.t_max else self.t_max - c
        window = ctx[pos0:pos0 + c]
        valid = len(window)
        final = pos0 + valid >= len(ctx)
        tokens = np.zeros((1, c), np.int64)
        tokens[0, :valid] = window
        ptab = None
        if self._pager is not None:
            # each window maps exactly the pages it writes (the final one
            # also the first decode token's cell)
            ps = self.page_size
            upto = len(ctx) if final else pos0 + valid - 1
            need = min(upto, self.t_max - 1) // ps + 1
            shed = False
            with self._lock:
                if self._shutdown:
                    return
                cur = self._chunking.get(s)
                if cur is None or cur[0] is not req:
                    return
                delta = need - len(self._slot_pages[s])
                fresh = self._pager.alloc(delta) if delta > 0 else []
                if fresh is not None:
                    base = len(self._slot_pages[s])
                    self._slot_pages[s].extend(fresh)
                    self._ptables[s, base:base + len(fresh)] = fresh
                    ptab = self._ptables[s:s + 1].copy()
                elif any(r is not None for r in self._slots):
                    return      # decoding lanes will free pages: retry
                else:
                    # only chunkers hold the pool, and they only grow:
                    # shedding this one frees pages for the rest
                    del self._chunking[s]
                    self._release_slot_pages(s)
                    self._stats["rejected"] += 1
                    shed = True
            if shed:
                req._fail(RejectedError(
                    "KV page pool exhausted mid-chunked-prefill and "
                    "nothing in flight to free a page — request shed"))
                return
        with self._lock:
            self._stats["prefill_chunks"] += 1
            chunk_no = self._stats["prefill_chunks"]
        t0 = interval_now()
        self._faults.fire("engine.prefill")
        seed = rngmod.fold_in(self.seed, CHUNK_SALT | chunk_no)
        temp = np.asarray([req.temperature], np.float32)
        fault_in = fdev if fdev is not None else np.zeros(1, np.int64)
        if self._pager is not None:
            nxt, _, self._caches = self.decoder.paged_prefill(
                self._caches, tokens, [pos0], [valid], ptab, temp,
                seed=seed, fault_in=fault_in)
        else:
            nxt, _, self._caches = self.decoder.prefill_chunk(
                self._caches, tokens, pos0, valid, s, temp, seed=seed,
                fault_in=fault_in)
        tok, fault = None, False
        if final:
            arr = device_fetch(nxt, tag="engine.prefill")
            if self._sentinel_on:
                tok, fault = int(arr[0, 0]), bool(arr[0, 1])
            else:
                tok = int(arr[0])
        t1 = interval_now()
        finish = None
        faulted: List[GenerationRequest] = []
        scrub: List[int] = []
        scrub_slots: List[int] = []
        registered = False
        with self._lock:
            if self._shutdown:
                return      # the takeover harvest owns the request
            cur = self._chunking.get(s)
            if cur is None or cur[0] is not req:
                return      # freed (cancel / deadline) meanwhile
            self._ewma_locked("_est_prefill", t1 - t0)
            if not final:
                cur[2] = pos0 + valid
                if self._sentinel_on:
                    cur[3] = nxt[:, 1]     # stays on the device
            elif fault:
                # tripped in some window: nothing emitted or registered
                del self._chunking[s]
                self._stats["host_readbacks"] += 1
                if self._pager is not None:
                    scrub = self._faulted_pages_locked(s)
                else:
                    scrub_slots.append(s)
                self._stats["numerical_faults"] += 1
                faulted.append(req)
            else:
                del self._chunking[s]
                self._stats["host_readbacks"] += 1
                req.generated.append(tok)
                self._stats["emitted_tokens"] += 1
                if self._pager is not None:
                    self._pager.register_chain(
                        ctx, self._slot_pages[s][:len(ctx) //
                                                 self.page_size])
                    registered = True
                if self._req_finished(req, tok):
                    self._stats["completed"] += 1
                    finish = req
                    self._release_slot_pages(s)
                else:
                    self._occupy_locked(s, req, tok, len(ctx))
                    self._carry = None
        self._scrub_pages(scrub)
        self._scrub_slots(scrub_slots)
        self._fail_faulted(faulted, "prefill_chunk")
        if registered:
            self._after_register(
                [(ctx, len(ctx) // self.page_size)]
                if self._kv_verifier is not None else [], ctx)
        if finish is not None:
            finish._complete()

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
            written = 0
            for s in range(self.num_slots):
                if not self._slot_pages[s]:
                    continue
                if s in self._chunking:
                    written += int(self._chunking[s][2])
                elif self._slots[s] is not None:
                    written += int(self._positions[s])
        st["mapped"] = mapped
        st["pool_bytes"] = self._pool_bytes()
        span = mapped * self.page_size
        st["fragmentation"] = 0.0 if not span else round(
            max(0.0, 1.0 - written / span), 4)
        return st

    # ------------------------------------------- KV content integrity
    def _page_sums(self, pids: List[int]) -> List[bytes]:
        """Content checksums of pool pages ``pids``: each layer's k then v
        bytes in sorted-layer order (PageFrameSet's recipe). One readback
        a layer and kind, tagged ``integrity.verify``: none is a decode
        block's."""
        frames = self.decoder.kv_export(self._caches, pids)
        host = {}
        for n, kv in frames.items():
            host[n] = {}
            for kk, t in kv.items():
                if t.dtype == torch.bfloat16:   # numpy has no bfloat16:
                    t = t.view(torch.int16)     # hash the same bytes
                host[n][kk] = device_fetch(t, tag="integrity.verify")
        names = sorted(host)
        return [page_content_checksum(
                    [host[n][kk][j] for n in names for kk in ("k", "v")])
                for j in range(len(pids))]

    def _after_register(self, entries: List[Tuple[np.ndarray, int]],
                        registered_ctx: Optional[np.ndarray]) -> None:
        """After a prefix registration: record checksums of the newly
        indexed pages (``entries``: (context, full pages) rows), then poll
        the at-rest corruption payload (``device.corrupt_page`` at
        ``"registered"``) on the first page of ``registered_ctx``."""
        if entries:
            self._record_page_sums(entries)
        if registered_ctx is not None:
            plan = self._faults.corruption("device.corrupt_page",
                                           where="registered")
            if plan is not None:
                self._corrupt_registered_page(registered_ctx, plan["mode"])

    def _record_page_sums(self, entries: List[Tuple[np.ndarray,
                                                    int]]) -> None:
        """Record references for freshly registered chains, each unique
        (digest, page) once. Cached pages are never rewritten, so reading
        them without the engine lock is race-free."""
        need: List[Tuple[bytes, int]] = []
        seen = set()
        for ctx, n_full in entries:
            for dg in chain_digests(ctx[:n_full * self.page_size],
                                    self.page_size):
                if dg in seen:
                    continue
                seen.add(dg)
                pid = self._pager.cached_page(dg)
                if pid is None or \
                        self._kv_verifier.expected(dg, pid) is not None:
                    continue
                need.append((dg, int(pid)))
        if not need:
            return
        sums = self._page_sums([pid for _, pid in need])
        for (dg, pid), cs in zip(need, sums):
            self._kv_verifier.record(dg, pid, cs)

    def _verify_matched(self, ctx: np.ndarray,
                        shared: List[int]) -> Optional[int]:
        """Verify a prefix hit's matched pages against their references.
        Returns the first corrupt page's index in ``shared``, or None. On
        a mismatch this match's refs go back, the chain from the corrupt
        page on is evicted and scrubbed where free, the streams still
        mapping a corrupt page are requeued to re-prefill, and the caller
        degrades the match to a miss."""
        digests = chain_digests(ctx[:len(shared) * self.page_size],
                                self.page_size)
        sums = self._page_sums(shared)
        bad = None
        for j, (dg, pid) in enumerate(zip(digests, shared)):
            if self._kv_verifier.check(dg, int(pid), sums[j]) is False:
                bad = j
                break
        if bad is None:
            return None
        for pid in shared:
            self._pager.unref(pid)
        self._pager.evict_digests(digests[bad:])
        self._kv_verifier.forget(digests[bad:])
        self._scrub_pages(shared[bad:])
        with self._lock:
            self._stats["kv_page_corruptions"] += 1
        self._preempt_corrupt_holders(set(shared[bad:]))
        return bad

    def _preempt_corrupt_holders(self, pids: set) -> None:
        """Requeue at the head every stream mapping a corrupt page (its
        private pages, computed over the corrupt ones, are scrubbed too):
        the evicted chain cannot be re-mapped, so it re-prefills clean."""
        scrub: List[int] = []
        with self._lock:
            for s in range(self.num_slots):
                if not pids.intersection(self._slot_pages[s]):
                    continue
                req = None
                if self._slots[s] is not None:
                    req = self._slots[s]
                    self._slots[s] = None
                elif s in self._chunking:
                    req = self._chunking.pop(s)[0]
                scrub.extend(self._slot_pages[s])
                self._release_slot_pages(s)
                if req is not None and not req.done():
                    req._running = False
                    self._pending.appendleft(req)
                    self._stats["page_preempted"] += 1
                self._carry = None
        self._scrub_pages(scrub)

    def _faulted_pages_locked(self, s: int) -> List[int]:
        """A sentinel-faulted paged lane (caller holds the lock): every
        page it mapped is suspect, its registered prompt pages included.
        Evict them from the prefix index and drop their references,
        release the slot's mapping, and return the pages to scrub."""
        pages = list(self._slot_pages[s])
        dgs = self._pager.evict_pages(pages)
        if self._kv_verifier is not None:
            self._kv_verifier.forget(dgs)
        self._release_slot_pages(s)
        return pages

    def _scrub_pages(self, pids: List[int]) -> None:
        """Zero the free ones among ``pids`` on the device (a page a
        healthy stream still maps keeps its bytes until released; its
        index entry is gone, so nothing new maps it). Serve-loop thread:
        nothing can map a freed page mid-scrub."""
        if self._pager is None or not pids:
            return
        pids = self._pager.free_subset(pids)
        if pids:
            self._caches = self.decoder.scrub_pages(self._caches, pids)

    def _scrub_slots(self, slots: List[int]) -> None:
        """Zero sentinel-faulted slab rows before refill hands them on."""
        if self._pager is None and slots:
            self._caches = self.decoder.scrub_slot(self._caches, slots)

    def _corrupt_registered_page(self, ctx: np.ndarray, mode: str) -> None:
        """Chaos only (``device.corrupt_page`` at ``"registered"``):
        poison the first cached page of ``ctx``'s chain on the device."""
        digests = chain_digests(ctx[:self.page_size], self.page_size)
        pid = self._pager.cached_page(digests[0]) if digests else None
        if pid is not None:
            self._caches = self.decoder.corrupt_page(self._caches,
                                                     int(pid), mode)

    def _inject_corrupt_logits(self, mode: str, s: int) -> None:
        """Chaos only (``device.corrupt_logits``): poison lane ``s``'s
        always-attended KV (its first page, or slab cell 0) before a
        block dispatch, so the block's logits go bad."""
        if self._pager is not None:
            with self._lock:
                pages = list(self._slot_pages[s])
            if pages:
                self._caches = self.decoder.corrupt_page(
                    self._caches, int(pages[0]), mode)
        else:
            self._caches = self.decoder.corrupt_cache(self._caches, int(s),
                                                      0, mode)

    # ------------------------------------------------------------ decoding
    def _step(self):
        """One serve-loop cycle: a chunked-prefill window first (when a
        slot is chunking), then a speculative block or a plain pipelined
        block (always, without speculation; during the low-acceptance
        cooldown, with it)."""
        if self._chunking:
            self._advance_chunks()
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
        the pickup below sees it. Chunking lanes launch frozen."""
        k = self._choose_block_size() if self.adaptive_block \
            else self.block_size
        self._enforce_slots()
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
                    # free and chunking lanes launch frozen: they touch
                    # only their own parked cell (paged: the null page)
                    carry = (self._last_ids.copy(), self._positions.copy(),
                             np.asarray([r is None for r in self._slots]))
                ptab = None if self._pager is None else self._ptables.copy()
                dispatch = (carry, self._step_no - k, self._temps.copy(),
                            self._eos_ids.copy(), ptab)
        if dispatch is not None:
            (ids, pos, stop), step0, temps, eos, ptab = dispatch
            plan = self._faults.corruption("device.corrupt_logits")
            if plan is not None:
                self._inject_corrupt_logits(plan["mode"], snapshot[0][0])
            t_disp = interval_now()
            self._faults.fire("engine.step")
            toks, ids_d, pos_d, stop_d, self._caches = \
                self.decoder.decode_block(
                    self._caches, ids, pos, temps, seed=self.seed,
                    block_size=k, eos_ids=eos, stopped=stop, step0=step0,
                    key_salt=ENGINE_KEY_SALT, ptables=ptab)
            with self._lock:
                if not self._shutdown:
                    self._carry = (ids_d, pos_d, stop_d)
                    self._inflight = (start_fetch(toks), snapshot, k, t_disp)
        if prev is not None and dispatch is not None:
            self._retire_block(prev)

    def _retire_block(self, block):
        """Read one block's [S, K] tokens (ONE readback; a sentinel's
        verdict is column K of the same copy) and book them: per-lane
        appends until a stop, slot frees, completions. A tripped lane
        drops the whole block's tokens, frees (and scrubs) its slot and
        fails typed."""
        copy, snapshot, k, t_disp = block
        host = device_fetch(copy, tag="engine.decode")
        t_ret = interval_now()
        fault_col = None
        if self._sentinel_on:
            fault_col, host = host[:, k], host[:, :k]
        finished: List[GenerationRequest] = []
        faulted: List[GenerationRequest] = []
        scrub: List[int] = []
        scrub_slots: List[int] = []
        with self._lock:
            self._ewma_locked("_est_step", (t_ret - t_disp) / max(1, k))
            if self._shutdown:
                return      # the drain owns the requests: recovery
            #                 re-prefills and regenerates these tokens
            self._stats["host_readbacks"] += 1
            for s, req in snapshot:
                if req.done() or self._slots[s] is not req:
                    continue          # finished since dispatch: overshoot
                if fault_col is not None and fault_col[s]:
                    self._slots[s] = None
                    if self._pager is not None:
                        scrub.extend(self._faulted_pages_locked(s))
                    else:
                        scrub_slots.append(s)
                    self._stats["numerical_faults"] += 1
                    faulted.append(req)
                    continue
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
            self._first_step_done = True
            if finished or faulted:
                # freed lanes must not keep decoding from the device carry
                self._carry = None
        self._scrub_pages(scrub)
        self._scrub_slots(scrub_slots)
        self._fail_faulted(faulted, f"decode_block{k}")
        for req in finished:
            req._complete()

    # ------------------------------------------------ speculative decoding
    def _draft_locked(self, snapshot) -> np.ndarray:
        """[S, spec_k] drafts: each occupied lane's drafter syncs to its
        request's context (rebuilt when the occupant changed) and
        proposes; free and chunking lanes keep zeros (they dispatch
        frozen)."""
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
        self._enforce_slots()
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
        plan = self._faults.corruption("device.corrupt_logits")
        if plan is not None:
            self._inject_corrupt_logits(plan["mode"], snapshot[0][0])
        t_disp = interval_now()
        self._faults.fire("engine.step")
        toks, _, _, _, self._caches = self.decoder.verify_block(
            self._caches, ids, pos, draft, temps, seed=self.seed,
            eos_ids=eos, stopped=stop, step0=step0,
            key_salt=ENGINE_KEY_SALT, ptables=ptab)
        self._retire_spec(toks, snapshot, kd, t_disp)

    def _retire_spec(self, toks, snapshot, kd: int, t_disp: float) -> None:
        """Read one verify block's [S, K+1 tokens | emit (| verdict)] (ONE
        readback) and append each lane's accepted prefix; open lanes
        advance by what they emitted (the slab's rewind) and paged lanes
        truncate their tables. A tripped lane fails as in
        :meth:`_retire_block`. The acceptance average decides the
        cooldown."""
        host = device_fetch(toks, tag="engine.decode")
        t_ret = interval_now()
        fault_col = host[:, kd + 2] if self._sentinel_on else None
        finished: List[GenerationRequest] = []
        faulted: List[GenerationRequest] = []
        scrub: List[int] = []
        scrub_slots: List[int] = []
        drafted = accepted = emitted = 0
        with self._lock:
            if self._shutdown:
                return
            self._stats["host_readbacks"] += 1
            for s, req in snapshot:
                if req.done() or self._slots[s] is not req:
                    continue
                if fault_col is not None and fault_col[s]:
                    self._slots[s] = None
                    if self._pager is not None:
                        scrub.extend(self._faulted_pages_locked(s))
                    else:
                        scrub_slots.append(s)
                    self._stats["numerical_faults"] += 1
                    faulted.append(req)
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
            self._first_step_done = True
            if drafted:
                rate = accepted / drafted
                self._spec_ewma = rate if self._spec_ewma is None else \
                    0.7 * self._spec_ewma + 0.3 * rate
                if self._spec_ewma < self.spec_threshold:
                    self._spec_cool = self.spec_probe_every
            # seconds per emitted token: the divisor grows with acceptance
            self._ewma_locked("_est_step", (t_ret - t_disp) / max(1, emitted))
        self._scrub_pages(scrub)
        self._scrub_slots(scrub_slots)
        self._fail_faulted(faulted, f"verify_block{kd}")
        for req in finished:
            req._complete()

    # ---------------------------------------------------- drain, takeover
    def begin_drain(self) -> None:
        """Close admission (new submissions are shed with RejectedError)
        while queued and decoding work goes on."""
        with self._lock:
            self._draining = True

    def preempt_drain(self, budget: float = 10.0
                      ) -> Tuple[List[GenerationRequest],
                                 Optional[BaseException]]:
        """Stop for preemption: close admission, park the serve loop at
        the next block boundary (waiting at most ``budget`` seconds; a
        loop wedged in a device call is abandoned), retire the in-flight
        block if the loop stopped and budget is left, then
        :meth:`quarantine`. Harvested requests are not failed: a restart
        resumes them."""
        t_end = interval_now() + max(0.0, float(budget))
        with self._lock:
            self._draining = True
            self._drain_stop = True
        self._work.set()
        w = self._worker
        if w is not None and w is not threading.current_thread():
            w.join(timeout=max(0.0, t_end - interval_now()))
        stale = None
        with self._lock:
            loop_stopped = w is None or not w.is_alive()
            if loop_stopped and not self._shutdown:
                stale, self._inflight = self._inflight, None
        if stale is not None and interval_now() < t_end:
            self._retire_block(stale)
        return self.quarantine()

    def quarantine(self) -> Tuple[List[GenerationRequest],
                                  Optional[BaseException]]:
        """Detach this engine for a takeover: stop the loop and harvest
        every recoverable request exactly once, in this order: mid-admit,
        mid-chunk, in a slot, queued. A wedged loop that wakes later sees
        the quarantine and touches nothing. Returns (recoverable requests,
        death cause)."""
        with self._lock:
            self._quarantined = True
            self._shutdown = True
            self._beat = None    # a stale loop must not beat for the new
            harvested = self._harvest_locked()
            cause = self._dead
        self._work.set()
        return [r for r in harvested if not r.done()], cause

    def _harvest_locked(self) -> List[GenerationRequest]:
        """Take every request the engine holds (mid-admit, mid-chunk, in
        a slot, queued, in that order) and reset the slots, the pipeline
        (in-flight tokens are never read: a resumed request regenerates
        them) and the page mappings; caller holds the engine lock."""
        taken = list(self._admitting)
        self._admitting = []
        for s in sorted(self._chunking):
            taken.append(self._chunking[s][0])
        self._chunking = {}
        for s in range(self.num_slots):
            if self._slots[s] is not None:
                taken.append(self._slots[s])
                self._slots[s] = None
        taken.extend(self._pending)
        self._pending.clear()
        self._inflight = None
        self._carry = None
        self._release_all_pages()
        return taken

    def stats(self) -> Dict[str, int]:
        """Serving counters plus the live queue depth and active slots
        (decoding or chunk-prefilling)."""
        with self._lock:
            out = dict(self._stats)
            out["queue_depth"] = len(self._pending)
            out["active_slots"] = sum(r is not None for r in self._slots) + \
                len(self._chunking)
        return out

    # ---------------------------------------------------------- execution
    def run_until_drained(self):
        """Synchronous mode: process the queue to empty. With refill on,
        freed slots re-admit between blocks; with refill off, each
        admitted wave drains fully before the next. Injected faults
        propagate to the caller here."""
        while True:
            self._sweep_pending()
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
                if self._drain_stop:
                    return            # parked for preempt_drain
                beat = self._beat
                if beat is not None:
                    beat()            # the supervisor's liveness signal
                self._sweep_pending()
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
            with self._lock:
                self._dead = exc
                quarantined = self._quarantined
                on_crash = self._on_crash if self._supervised else None
            if quarantined:
                return        # superseded: a supervisor already harvested
            if on_crash is not None:
                # supervised: the supervisor harvests and restarts; the
                # requests are not failed here (failed and re-run are
                # mutually exclusive)
                on_crash(self, exc)
                return
            # unsupervised: fail every outstanding request and mark the
            # engine dead, so later submit()s fail fast with the cause
            self._fail_outstanding(exc)
            raise

    def _fail_outstanding(self, exc: BaseException) -> None:
        with self._lock:
            doomed = self._harvest_locked()
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
        """Stop the worker and fail whatever is still queued, chunking or
        decoding — a caller blocked in result() must not hang forever."""
        with self._lock:
            self._shutdown = True
        self._work.set()
        if self._worker is not None and \
                self._worker is not threading.current_thread():
            self._worker.join(timeout=5)
        self._fail_outstanding(self._dead or RuntimeError(
            "SlotGenerationEngine shut down"))
