"""KV-cache autoregressive decoding and slot-based continuous batching (the
JAX package's ``models/generation.py``, core of the slab-cache path).

- :class:`TransformerDecoder` runs a causal decoder-only ComputationGraph
  with a preallocated [B, H, T_max, Dh] cache per attention layer:
  ``prefill`` (one ordinary forward over the padded prompts — attention
  goes through the helper seam, i.e. a hand-written kernel on the card),
  ``decode_step``, ``prefill_slots`` (batched admission into chosen cache
  rows) and ``decode_block`` (K decode steps dispatched back to back with
  the stop flags and positions kept on the device). ``generate`` pipelines
  blocks with one host readback per block.
- :class:`SlotGenerationEngine` serves a request queue over ``num_slots``
  cache rows: batched pow2-bucketed admission with one readback per
  admission, the double-buffered block pipeline (block t+1 is dispatched
  from the on-device carry before block t's tokens are read back), refill
  of freed slots, ``max_pending`` shedding.

A JAX ``scan`` becomes a Python loop of device launches that never waits
for the device; ``jit`` has no counterpart here. The cache is updated in
place. Selection: greedy (argmax of f32 logits) where a row's temperature
is <= 0, else Gumbel-max sampling from bf16-ROUNDED logits with a
generator seeded per ABSOLUTE step (a Philox generator on the card), so a
fixed seed gives the same tokens for every block size K.

Not in this slice: paged KV, speculation, chunked prefill, EDF/headroom,
adaptive K, deadlines/cancel, sentinel, journal, tracing/metrics,
supervisor and mesh."""

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

#: seed salts: the engine's decode and admission selections never share a
#: seed with each other or with TransformerDecoder.generate's
ENGINE_KEY_SALT = 1 << 20
PREFILL_BATCH_SALT = 1 << 21

_ENGINE_COUNTERS = ("emitted_tokens", "completed", "decode_steps",
                    "decode_blocks", "host_readbacks", "prefills",
                    "prefill_batches", "rejected", "failed")


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

    def _walk_decode(self, params, state, caches, ids, positions):
        """One single-token step: ids [B] at per-row ``positions`` [B] →
        logits [B, V] f32 (caches written in place)."""
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
                acts[name], _ = v.layer.decode_forward(
                    params[name], xs[0], caches[name], positions)
            elif name == self.output_name:
                logits = v.layer.preoutput(params[name], xs[0])[:, 0]
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
                     step0: int = 0, key_salt: int = 0):
        """``block_size`` decode steps launched back to back, nothing read
        back. Returns ``(toks [B, K], ids [B], positions [B], stopped [B],
        caches)``, all on the device, so the caller can dispatch the NEXT
        block from this carry before reading these tokens. ``eos_ids``
        ([B], -1 = none) freezes a lane the step after it emits its eos; a
        frozen lane re-emits its last token and keeps its position (the
        overshoot stays in its own cache cell and is dropped on the host).
        Step j draws with seed ``fold_in(seed, key_salt | (step0 + j +
        1))``: the absolute step, so outputs are identical for every K."""
        b = np.shape(ids)[0]
        k = int(block_size)
        host_t, temps_d = self._temps(temps, b)
        sample = bool((host_t > 0).any())
        eos = self._to_dev(np.full(b, -1, np.int64) if eos_ids is None
                           else np.broadcast_to(np.asarray(eos_ids), (b,)),
                           torch.long)
        stop = self._to_dev(np.zeros(b, bool) if stopped is None
                            else stopped, torch.bool)
        ids = self._to_dev(ids, torch.long)
        pos = self._to_dev(positions, torch.long)
        params = self._device_params()
        state = self.net._inference_state()
        toks = torch.empty((b, k), dtype=torch.long, device=self.device)
        for j in range(k):
            logits = self._walk_decode(params, state, caches, ids,
                                       pos.clamp(max=self.t_max - 1))
            nxt = self._select(logits, temps_d, rngmod.fold_in(
                seed, key_salt | (step0 + j + 1)), sample)
            nxt = torch.where(stop, ids, nxt)
            hit_eos = (eos >= 0) & (nxt == eos)
            pos = torch.where(stop, pos, pos + 1)
            stop = stop | hit_eos | (pos >= self.t_max)
            ids = nxt
            toks[:, j] = nxt
        return toks, ids, pos, stop, caches

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

    ``num_slots`` cache rows share one [S, H, t_max, Dh] cache per
    attention layer. Every admittable queued request coalesces into one
    bucketed ``prefill_slots`` call (count and prompt length rounded up to
    powers of two, padded rows repeating row 0) with ONE readback. Decoding
    runs in blocks of ``block_size`` steps: each cycle dispatches the next
    block from the device-side carry of the previous one, THEN reads back
    and books the previous block's [S, K] tokens, so host work overlaps the
    device. A slot that finishes frees at a block boundary and, with
    ``refill=True``, is re-admitted from the queue; ``refill=False``
    drains each admitted wave first. Submissions beyond ``max_pending``
    queued requests are shed with :class:`RejectedError`.

    Synchronous use: ``submit(...)`` then ``run_until_drained()``. Serving
    use: ``start()`` runs the loop on a worker thread; ``shutdown()``."""

    def __init__(self, net, num_slots: int = 8,
                 t_max: Optional[int] = None, refill: bool = True,
                 seed: int = 0, decoder: Optional[TransformerDecoder] = None,
                 max_pending: int = 256, block_size: int = 1, device=None):
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
        self._caches = self.decoder.init_cache(self.num_slots)
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

    def _admit(self):
        """Batched admission: every queued request that finds a free slot
        joins ONE bucketed prefill_slots call with a single readback."""
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
                        self._slots[s] = req
                        self._last_ids[s] = tok
                        self._positions[s] = len(req.prompt)
                        self._temps[s] = req.temperature
                        self._eos_ids[s] = -1 if req.eos_id is None \
                            else int(req.eos_id)
                # slot contents changed: the next block resyncs from host
                self._carry = None
            for req in finishers:
                req._complete()
            if drained:
                return

    def _step(self):
        """One pipelined block cycle: dispatch the next K-step block from
        the on-device carry, THEN read back and book the previous block —
        the fetch and host work overlap the new block's device time. When
        slots changed since the in-flight block was dispatched (the carry
        was dropped), that block is retired first: host state lags it by K
        steps, so dispatching from host state would replay them."""
        k = self.block_size
        with self._lock:
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
                    # cell until a refill re-prefills them
                    carry = (self._last_ids.copy(), self._positions.copy(),
                             np.asarray([r is None for r in self._slots]))
                dispatch = (carry, self._step_no - k, self._temps.copy(),
                            self._eos_ids.copy())
        if dispatch is not None:
            (ids, pos, stop), step0, temps, eos = dispatch
            toks, ids_d, pos_d, stop_d, self._caches = \
                self.decoder.decode_block(
                    self._caches, ids, pos, temps, seed=self.seed,
                    block_size=k, eos_ids=eos, stopped=stop, step0=step0,
                    key_salt=ENGINE_KEY_SALT)
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
