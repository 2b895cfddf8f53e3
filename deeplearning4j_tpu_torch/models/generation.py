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
  ``parallel.failures.EngineSupervisor`` restarts through. The host
  tier around it: registry-backed ``stats()`` (``observability/
  metrics.py``), a :class:`~..observability.tracing.Trace` per request
  (submit → queued → prefill → decode blocks, a ``takeover`` span per
  restart), the SLO tracker's per-request record, flight-recorder events
  (admissions, block retires, sheds, preemptions, numerics faults), the
  phase profiler's per-block account, and the durable request journal
  (``journal=``; ``streaming/journal.py``). None of them adds a readback:
  each block still costs one ``engine.decode`` readback.
- Phase specialization for the disaggregated tier
  (``streaming/disagg.py``): ``phase="prefill"`` engines prefill into
  pages and hand each request, with its exported pages (a
  :class:`~.paging.PageFrameSet`, 2 x layers ``kv_handoff`` readbacks),
  to the ``handoff`` sink instead of decoding it; ``phase="decode"``
  engines refuse fresh prompts and take requests through :meth:`adopt`,
  which imports the frames (one host→device copy) and resumes decode at
  the next position with no prefill.

A JAX ``scan`` becomes a Python loop of device launches that never waits
for the device; ``jit`` has no counterpart here. Caches and pools are
updated in place. Selection: greedy (argmax of f32 logits) where a row's
temperature is <= 0, else Gumbel-max sampling from bf16-ROUNDED logits
with a generator seeded per ABSOLUTE step (a Philox generator on the
card), so a fixed seed gives the same tokens for every block size K.

``mesh=`` (a ``parallel.mesh.generation_mesh``) shards the decoder over
a (data, tp) grid of devices driven by this one process: cache slots and
batch rows over ``data``, heads and projection columns over ``tp``, by
the roles of ``parallel.spec_layout.SpecLayout``. Every vertex of every
walk goes through :meth:`TransformerDecoder._vertex` once per data
group; the tp shards' partial products are summed in coordinate order
and the logits concatenated on the controller device (coordinate (0,
0)), where the selection runs as it does unsharded. One readback a block
still gathers every shard (``ops.transfer.fetch_shards``)."""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import threading
import uuid
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.conf.layers import (SelfAttentionLayer, TokenAndPositionEmbedding,
                              TransformerFeedForward)
from ..nn.graph.vertices import LayerVertex
from ..observability.clock import interval_now
from ..observability.flightrec import default_flight_recorder
from ..observability.integrity import (KV_CORRUPTION_COUNTER,
                                       NUMERICAL_FAULT_COUNTER,
                                       NumericalFault, PageVerifier,
                                       as_integrity, logits_fault,
                                       page_content_checksum)
from ..observability.metrics import default_registry
from ..observability.profiler import default_profiler
from ..observability.slo import default_slo_tracker
from ..observability.tracing import Trace, default_trace_ring
from ..ops import rng as rngmod
from ..ops.activations import gelu
from ..ops.transfer import device_fetch, mark_shards, start_fetch, to_device
from ..parallel.faults import (NULL_INJECTOR, Cancelled, DeadlineExceeded,
                               RejectedError)
from ..parallel.mesh import (Mesh, ShardedTensor, local_slice, mesh_tag,
                             serving_grid, validate_decode_mesh)
from ..parallel.spec_layout import (SpecLayout, decoder_param_specs,
                                    shard_params, validate_param_specs)
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

#: the engine's counters: stats() key → (metric family, help), the JAX
#: package's families. Each engine instance owns one labeled child of
#: each in its registry; stats() and the counter attributes are views.
_ENGINE_COUNTERS = {
    key: (f"generation_{key}_total", desc) for key, desc in (
        ("emitted_tokens", "tokens emitted to requests"),
        ("completed", "requests completed"),
        ("decode_steps", "decode steps executed (K per fused block)"),
        ("decode_blocks", "decode device programs dispatched"),
        ("host_readbacks", "deliberate device→host syncs in the serve "
                           "loop"),
        ("prefills", "requests admitted (prefilled into a cache slot)"),
        ("prefill_batches", "coalesced batched-admission prefill calls"),
        ("prefill_chunks", "chunked-prefill device dispatches (long "
                           "prompts)"),
        ("rejected", "admission-control sheds (queue bound or projected "
                     "deadline miss)"),
        ("headroom_shed", "admission sheds on projected deadline miss "
                          "(headroom policy; subset of rejected)"),
        ("deadline_exceeded", "requests failed by per-request deadline"),
        ("cancelled", "requests cancelled by their caller"),
        ("requeued", "requests recovered into this engine after a "
                     "takeover"),
        ("failed", "requests failed by engine crash/shutdown"),
        ("page_preempted", "requests preempted mid-decode on KV page-pool "
                           "pressure (re-queued at the head; exactly-once "
                           "preserved — re-admission re-prefills)"),
        ("handoffs", "prefilled requests handed off to the disagg tier "
                     "(prefill-only engines: KV pages exported, request "
                     "leaves through the handoff sink)"),
        ("adopted", "requests adopted with imported KV state (decode-only "
                    "engines: the disaggregated handoff receive path)"),
        ("spec_blocks", "speculative verify blocks dispatched"),
        ("spec_drafted", "candidate tokens drafted for speculative "
                         "verification"),
        ("spec_accepted_tokens", "drafted tokens accepted by the verify "
                                 "forward (the per-length account is "
                                 "generation_spec_accepted_total{len=})"),
        ("spec_emitted_tokens", "tokens emitted by speculative verify "
                                "blocks"),
        ("spec_fallbacks", "decode blocks dispatched by the "
                           "low-acceptance adaptive fallback while "
                           "speculation is enabled"))}
_ENGINE_COUNTERS.update({
    "prefix_cache_hits": ("prefix_cache_hit_total",
                          "requests admitted with >= 1 shared prefix page "
                          "mapped"),
    "prefix_cache_misses": ("prefix_cache_miss_total",
                            "requests admitted with no resident prefix "
                            "page"),
    "prefix_cache_hit_tokens": ("prefix_cache_hit_tokens_total",
                                "prompt tokens served from shared prefix "
                                "pages (prefill compute skipped)"),
    "numerical_faults": NUMERICAL_FAULT_COUNTER[:2],
    "kv_page_corruptions": KV_CORRUPTION_COUNTER[:2]})
_COUNTER_LABELS = {"numerical_faults": NUMERICAL_FAULT_COUNTER[2],
                   "kv_page_corruptions": KV_CORRUPTION_COUNTER[2]}
#: unique per-engine metric label values (e0, e1, ...)
_ENGINE_SEQ = itertools.count()


class _CounterView:
    """The engine's counters as a mapping over its registry children:
    ``view[key]`` reads a child's value and ``view[key] += n`` increments
    it, so the registry is the one place the numbers live."""

    def __init__(self, registry, engine_id: str):
        self._children = {
            key: registry.counter(name, desc,
                                  _COUNTER_LABELS.get(key, ("engine",)))
            .labels(engine_id)
            for key, (name, desc) in _ENGINE_COUNTERS.items()}

    def __getitem__(self, key: str) -> int:
        return int(self._children[key].value)

    def __setitem__(self, key: str, value: int) -> None:
        child = self._children[key]
        delta = int(value) - int(child.value)
        if delta < 0:
            raise ValueError(f"counter {key} cannot decrease")
        if delta:
            child.inc(delta)

    def snapshot(self) -> Dict[str, int]:
        return {key: int(c.value) for key, c in self._children.items()}


def _dispatching(fn):
    """A decoder method that enqueues device work, run under the decoder's
    dispatch lock: engines sharing one decoder (a fleet's replicas on one
    card) enqueue one call at a time. Each waiting serve thread sleeps on
    the lock instead of taking the interpreter lock back from the
    dispatching one at every operator (each torch operator releases it and
    takes it back)."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._dispatch_lock:
            return fn(self, *args, **kwargs)
    return wrapper


def _round_up_pow2(n: int, floor: int = 16) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class _Group:
    """One data group's share of a dispatch: its rows ``lo:hi`` of the
    batch, their inputs on each tp shard's device (``inp[t]``; one dict
    when they share a device), the activations on the group's home device
    (its tp shard 0), each tp shard's caches (``kv[t]``: {layer: {"k",
    "v"}}) and, for a slab prefill on a mesh, where its rows' k / v go."""

    __slots__ = ("g", "lo", "hi", "home", "inp", "acts", "kv", "writes")

    def __init__(self, g: int, lo: int, hi: int, home, inp, kv):
        self.g, self.lo, self.hi, self.home = g, lo, hi, home
        self.inp = inp
        self.kv = kv
        self.acts: Dict[str, torch.Tensor] = {}
        self.writes = None


class _PoolCopies:
    """A data group's handle on one of a page pool's copies (the pool is
    replicated over the data axis): reads see the group's own copy, every
    write lands in all copies in data-group order, so the copies stay
    equal whichever group writes."""

    __slots__ = ("own", "copies")

    def __init__(self, own: torch.Tensor, copies: List[torch.Tensor]):
        self.own = own
        self.copies = copies

    @property
    def shape(self):
        return self.own.shape

    @property
    def dtype(self):
        return self.own.dtype

    def __getitem__(self, idx):
        return self.own[idx]

    def __setitem__(self, idx, value):
        for c in self.copies:
            at = tuple(i.to(c.device) if torch.is_tensor(i) else i
                       for i in idx) if isinstance(idx, tuple) else \
                (idx.to(c.device) if torch.is_tensor(idx) else idx)
            c[at] = value.to(c.device)


class TransformerDecoder:
    """Cache-aware executor for a causal decoder-only ComputationGraph.

    ``t_max`` bounds the context (prompt + generated) a cache row holds;
    it defaults to the embedding's max_length and may not exceed it. The
    decoder runs on the net's device, in the net's compute dtype.

    ``mesh`` (``parallel.mesh.generation_mesh(data, tp, devices=...)``)
    shards the decoder over a grid of devices driven by this process:
    parameters by role through ``spec_layout`` (a ``parallel.spec_layout.
    SpecLayout``; the default shards embeddings and projections on
    ``tp``), the slab cache with slots over ``data`` and heads over
    ``tp``, the page pool with heads over ``tp`` and a copy per data
    group. Rows of a dispatch split over the data groups in contiguous
    runs; a slab prefill's k / v go to the group that owns each row's
    slot (slot ``s`` of ``S`` lives in group ``s // (S / data)``). Heads
    divisible by tp and a valid layout are checked here, before anything
    runs; program names gain a ``__m<data>x<tp>`` suffix. The controller
    device (``self.device``) is coordinate (0, 0)'s: logits, the
    selection and every block carry live there.

    ``sentinel=True`` makes the serving programs (``prefill_slots``,
    ``prefill_chunk``, ``paged_prefill``, the decode and verify blocks)
    return their per-row numerics verdict (:func:`~..observability.
    integrity.logits_fault` with ``logit_bound``) as one more int column
    of the token tensor they already return, so it crosses to the host in
    the same readback. An engine must agree with its decoder's setting."""

    def __init__(self, net, t_max: Optional[int] = None, mesh=None,
                 spec_layout: Optional[SpecLayout] = None,
                 sentinel: bool = False,
                 logit_bound: Optional[float] = 1e4):
        self._dispatch_lock = threading.RLock()
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
        #: serving program name → [its first dispatch's shape (rows b,
        #: query tokens a row q, cells read a row ctx), memoized cost]:
        #: what ``observability.devstats.impl_cost_analysis`` reads
        self._cost_seam: Dict[str, List] = {}
        # ---- mesh sharding
        self.mesh = mesh
        self._layout: Optional[SpecLayout] = None
        self._specs = None
        self._grid = None            # [data, tp] mesh coordinates
        self._data = self._tp = 1
        self._impl_suffix = ""
        self._views: Dict[str, SelfAttentionLayer] = {}
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError("mesh must be a parallel.mesh.Mesh "
                                "(generation_mesh / make_mesh), got "
                                f"{type(mesh).__name__}")
            self._layout = spec_layout if spec_layout is not None \
                else SpecLayout()
            for name in self.attn_names:
                validate_decode_mesh(
                    mesh, num_heads=conf.vertices[name].layer.num_heads,
                    data_axis=self._layout.data_axis,
                    tp_axis=self._layout.tp_axis)
            self._specs = decoder_param_specs(self, self._layout)
            validate_param_specs(mesh, self._specs, net.params)
            self._grid = serving_grid(mesh, self._layout.data_axis,
                                      self._layout.tp_axis)
            self._data, self._tp = self._grid.shape
            self._impl_suffix = "__m" + mesh_tag(mesh)
            self.device = self._dev(0, 0)
        #: mesh shards one readback of a program's result gathers
        self.fetch_shards = self._data * self._tp

    @property
    def data_axis_size(self) -> int:
        """Rows-per-dispatch divisor: slot counts must divide by the data
        axis (1 for an unsharded decoder)."""
        return self._data

    def _dev(self, g: int, t: int) -> torch.device:
        return self.mesh.device(self._grid[g, t])

    def _note_program(self, name: str, b: int, q: int, ctx: int) -> None:
        """Record a serving program's first dispatch (one dict lookup a
        call after that); a sharded decoder's names carry the mesh
        suffix."""
        name += self._impl_suffix
        if name not in self._cost_seam:
            self._cost_seam[name] = [{"b": int(b), "q": int(q),
                                      "ctx": int(ctx)}, None]

    # ------------------------------------------------------------- params
    def _device_params(self):
        """Params cast once to the net's compute dtype (recast only when
        ``net.params`` is replaced). On a mesh the cast is also placed
        once: {coordinate: params tree} with each coordinate's part of
        every leaf on its device, rebuilt from the same cast."""
        if self._cast_params is None or self._cast_src is not self.net.params:
            cast = self.net._cast_params(self.net.params)
            if self.mesh is not None:
                cast = shard_params(self.mesh, self._specs, cast)
            self._cast_params = cast
            self._cast_src = self.net.params
            self.param_casts += 1
        return self._cast_params

    def _leaves(self, params, g: int, t: int, name: str) -> Dict:
        """Vertex ``name``'s params as tp shard ``t`` of data group ``g``
        uses them: its coordinate's parts, with the dims an FSDP layout
        splits over the data axis gathered from every group (in group
        order) onto its device."""
        if self.mesh is None:
            return params[name]
        coord = self._grid[g, t]
        tree = params[coord][name]
        fs = self._layout.fsdp_axis
        if fs is None or self.mesh.shape.get(fs, 1) == 1:
            return tree
        ax = self.mesh.axis_index(fs)
        specs = self._specs.get(name, {})
        out = {}
        for pname, leaf in tree.items():
            dims = [i for i, e in enumerate(specs.get(pname, ())) if e == fs]
            if not dims:
                out[pname] = leaf
                continue
            parts = []
            for i in range(self.mesh.shape[fs]):
                c = list(coord)
                c[ax] = i
                parts.append(params[tuple(c)][name][pname].to(leaf.device))
            out[pname] = torch.cat(parts, dim=dims[0])
        return out

    def _attn_view(self, name: str) -> SelfAttentionLayer:
        """Attention vertex ``name`` as one tp shard runs it: H/tp heads
        of the same size, no output projection and no activation (the
        shards' heads meet in :meth:`_row_parallel` first)."""
        view = self._views.get(name)
        if view is None:
            layer = self.net.conf.vertices[name].layer
            view = dataclasses.replace(
                layer, num_heads=layer.num_heads // self._tp,
                head_size=layer._head_size(), project_out=False,
                activation="identity")
            self._views[name] = view
        return view

    @staticmethod
    def _row_parallel(partials: List[torch.Tensor], home) -> torch.Tensor:
        """The sum of a row-parallel product's tp partials on ``home``, in
        shard order (half-precision partials accumulate in f32 and round
        once)."""
        acc = partials[0].to(home)
        if len(partials) == 1:
            return acc
        dtype = acc.dtype
        if dtype in (torch.bfloat16, torch.float16):
            acc = acc.float()
        for p in partials[1:]:
            acc = acc + p.to(home, acc.dtype)
        return acc.to(dtype)

    # -------------------------------------------------------------- cache
    def init_cache(self, batch: int) -> Dict[str, Dict]:
        """{attn_name: {"k", "v" [B, H, t_max, Dh]}} in the compute dtype;
        on a mesh each a :class:`~..parallel.mesh.ShardedTensor` born
        sharded (rows over data, heads over tp)."""
        if self.mesh is None:
            return {name: self.net.conf.vertices[name].layer.init_cache(
                        batch, self.t_max, self.net.compute_dtype,
                        self.device)
                    for name in self.attn_names}
        if batch % self._data:
            raise ValueError(
                f"cache rows {batch} are not divisible by the "
                f"'{self._layout.data_axis}' axis size {self._data} — "
                "slab rows shard over it")
        return self._sharded_kv(self._layout.kv_cache(), batch, self.t_max)

    def init_paged_pool(self, num_pages: int,
                        page_size: int) -> Dict[str, Dict]:
        """{attn_name: {"k", "v" [P, H, page_size, Dh]}}: one page pool
        per attention layer in the compute dtype, page 0 the null page;
        on a mesh heads split over tp and each data group holds a copy."""
        if self.mesh is None:
            return {name: self.net.conf.vertices[name].layer.init_page_pool(
                        int(num_pages), int(page_size),
                        self.net.compute_dtype, self.device)
                    for name in self.attn_names}
        return self._sharded_kv(self._layout.kv_pages(), int(num_pages),
                                int(page_size))

    def _sharded_kv(self, spec, rows: int, depth: int) -> Dict[str, Dict]:
        out = {}
        for name in self.attn_names:
            layer = self.net.conf.vertices[name].layer
            if not layer.causal:
                raise ValueError("KV-cache decoding needs causal=True "
                                 "(autoregressive attention)")
            shape = (rows, layer.num_heads, depth, layer._head_size())
            out[name] = {kk: ShardedTensor.zeros(self.mesh, spec, shape,
                                                 self.net.compute_dtype)
                         for kk in ("k", "v")}
        return out

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
    # graftlint: hot
    def _walk(self, kind: str, params, state, caches, inp: Dict, *,
              slots=None, row_slot: Optional[int] = None,
              last: bool = False, fresh: bool = False) -> torch.Tensor:
        """One pass of the graph; ``inp`` holds the batch's device inputs
        (rows first) and the result is f32 logits on the controller:

        - ``"prefill"``: teacher-forced over padded prompts ``tokens``
          [B, Tp] (true ``lengths`` [B]), writing each row's k / v into
          cache row ``slots[i]`` (a host array; default row i) at
          [0, Tp); logits at each row's last real position [B, V].
        - ``"recompute"``: the same forward through
          ``SelfAttentionLayer.forward``, writing no cache (attention
          takes the helper seam: B1 on the card at Tp <= 512).
        - ``"decode"``: one step of ``ids`` [B] at ``positions`` [B] →
          [B, V]; with ``ptables`` [B, NP] the caches are page pools.
        - ``"window"``: tokens [B, C] at start positions ``pos0`` [B],
          ``valid`` [B] real tokens a row, through the slab
          (``chunk_forward``) or with ``ptables`` through the pages
          (``paged_prefill_forward``; ``fresh``: every row starts at 0).
          Logits at every window position [B, C, V], or with ``last`` at
          each row's last valid one [B, V]. ``row_slot``: the batch is one
          row that runs on that slab row alone.

        Every vertex goes through :meth:`_vertex` once per data group."""
        conf = self.net.conf
        groups = self._split(kind, caches, inp, slots, row_slot)
        src = "tokens" if "tokens" in inp else "ids"
        for grp in groups:
            grp.acts[self.input_name] = grp.inp[0][src]
        for name in conf.topological_order:
            v = conf.vertices[name]
            ins = conf.vertex_inputs[name]
            for grp in groups:
                grp.acts[name] = self._vertex(
                    kind, name, v, [grp.acts[i] for i in ins], grp, params,
                    state, last, fresh)
        parts = [grp.acts[self.output_name] for grp in groups]
        if len(parts) == 1:
            return parts[0].to(self.device).float()
        return torch.cat([p.to(self.device) for p in parts]).float()

    # graftlint: hot
    def _walk_prefill(self, params, state, caches, tokens, lengths,
                      slots=None):
        """Padded prompts [B, Tp] → cache rows ``slots`` (default
        0..B-1) filled at [0, Tp), logits at each row's last real
        position [B, V] f32."""
        return self._walk("prefill", params, state, caches,
                          {"tokens": tokens, "lengths": lengths},
                          slots=slots)

    # graftlint: hot
    def _walk_decode(self, params, state, caches, ids, positions,
                     ptables=None):
        """One step of ids [B] at ``positions`` [B] → logits [B, V] f32;
        with ``ptables`` [B, NP] the caches are page pools."""
        inp = {"ids": ids, "positions": positions}
        if ptables is not None:
            inp["ptables"] = ptables
        return self._walk("decode", params, state, caches, inp)

    # graftlint: hot
    def _walk_window(self, params, state, caches, tokens, pos0, valid,
                     ptables=None, last=False, fresh=False,
                     row_slot=None):
        """A window of tokens [B, C] at ``pos0`` [B], ``valid`` [B] real
        tokens a row, through the slab or, with ``ptables``, the pages:
        logits [B, C, V] f32, or with ``last`` [B, V]."""
        inp = {"tokens": tokens, "pos0": pos0, "valid": valid}
        if ptables is not None:
            inp["ptables"] = ptables
        return self._walk("window", params, state, caches, inp,
                          row_slot=row_slot, last=last, fresh=fresh)

    # graftlint: hot
    def _walk_recompute(self, params, state, tokens, lengths):
        """The no-cache forward over padded contexts [B, Tp]: logits at
        each row's last real position [B, V] f32."""
        return self._walk("recompute", params, state, None,
                          {"tokens": tokens, "lengths": lengths})

    def _split(self, kind: str, caches, inp: Dict, slots,
               row_slot: Optional[int]) -> List[_Group]:
        """The dispatch's data groups, with their inputs and caches."""
        b = int(inp["tokens" if "tokens" in inp else "ids"].shape[0])
        paged = "ptables" in inp
        if self.mesh is None:
            kv = caches
            if row_slot is not None:
                kv = {n: {kk: caches[n][kk][row_slot:row_slot + 1]
                          for kk in ("k", "v")} for n in self.attn_names}
            grp = _Group(0, 0, b, self.device, [inp], [kv])
            if kind == "prefill" and slots is not None:
                grp.writes = self._to_dev(slots, torch.long)
            return self._finish_inputs(kind, [grp])
        data, tp = self._data, self._tp
        slab_rows = None
        if caches is not None and not paged:
            slab_rows = int(next(iter(caches.values()))["k"].shape[0])
        per = None if slab_rows is None else slab_rows // data
        if row_slot is not None:
            bounds = [(int(row_slot) // per, 0, b)]
        else:
            size, extra = divmod(b, data)
            bounds, lo = [], 0
            for g in range(data):
                hi = lo + size + (1 if g < extra else 0)
                if hi > lo:
                    bounds.append((g, lo, hi))
                lo = hi
            if kind in ("decode", "window") and not paged and b != slab_rows:
                raise ValueError(
                    f"a sharded slab dispatch runs every cache row: {b} "
                    f"rows for a cache of {slab_rows}")
        groups = []
        for g, lo, hi in bounds:
            home = self._dev(g, 0)
            ginp = {k: x[lo:hi].to(home) for k, x in inp.items()}
            per_t = []
            for t in range(tp):
                dev = self._dev(g, t)
                per_t.append(ginp if dev == home else
                             {k: x.to(dev) for k, x in ginp.items()})
            row = None if row_slot is None else int(row_slot) % per
            kv = [None if caches is None or kind == "prefill" else
                  self._local_kv(caches, g, t, paged, row)
                  for t in range(tp)]
            groups.append(_Group(g, lo, hi, home, per_t, kv))
        if kind == "prefill":
            self._route_writes(groups, caches, slots, b, per)
        return self._finish_inputs(kind, groups)

    def _local_kv(self, caches, g: int, t: int, paged: bool,
                  row: Optional[int]) -> Dict[str, Dict]:
        """Tp shard ``t`` of data group ``g``'s caches: its slab rows (the
        one local ``row`` if given), or its copy of the page pool, whose
        writes go to every data group's copy."""
        c = self._grid[g, t]

        def leaf(x: ShardedTensor):
            own = x.local(c)
            if paged:
                return own if self._data == 1 else _PoolCopies(
                    own, [x.local(self._grid[d, t])
                          for d in range(self._data)])
            return own if row is None else own[row:row + 1]

        return {n: {kk: leaf(caches[n][kk]) for kk in ("k", "v")}
                for n in self.attn_names}

    def _route_writes(self, groups: List[_Group], caches, slots, b: int,
                      per: int) -> None:
        """A sharded slab prefill's write plan: each group's rows go to
        the group owning their slot, as (owner, the rows' indices in the
        group, their local cache rows) beside the caches; a slot repeated
        by padded rows is written once, from its first row."""
        slots = np.arange(b) if slots is None else \
            np.asarray(slots.cpu() if torch.is_tensor(slots) else slots,
                       np.int64).reshape(-1)
        keep = np.zeros(b, bool)
        keep[np.unique(slots, return_index=True)[1]] = True
        for grp in groups:
            plan = []
            rows = np.arange(grp.lo, grp.hi)
            rows = rows[keep[rows]]
            for o in np.unique(slots[rows] // per):
                sel = rows[slots[rows] // per == o]
                plan.append((int(o),
                             to_device(sel - grp.lo, grp.home, torch.long),
                             to_device(slots[sel] % per, grp.home,
                                       torch.long)))
            grp.writes = (caches, plan)

    def _finish_inputs(self, kind: str, groups: List[_Group]):
        """Derived per-group inputs: the prefill / recompute key mask."""
        if kind in ("prefill", "recompute"):
            for grp in groups:
                for inp in {id(d): d for d in grp.inp}.values():
                    tp = inp["tokens"].shape[1]
                    inp["kmask"] = (
                        torch.arange(tp, device=inp["tokens"].device)[None, :]
                        < inp["lengths"][:, None]).float()
        return groups

    # graftlint: hot
    def _vertex(self, kind: str, name: str, v, xs, grp: _Group, params,
                state, last: bool, fresh: bool) -> torch.Tensor:
        """Vertex ``name`` on data group ``grp``: the one place that
        knows how each vertex shards. Embedding and vocab head run per tp
        shard on their column slices and concatenate; attention and the
        FFN run per tp shard and meet in a row-parallel sum with their
        bias added once; everything else (layer norms, the residual adds)
        runs whole on the group's home device."""
        layer = v.layer if isinstance(v, LayerVertex) else None
        inp = grp.inp[0]
        if name == self.output_name:
            h = xs[0]
            idx = inp["lengths"] if kind in ("prefill", "recompute") else \
                inp["valid"] if kind == "window" and last else None
            if idx is not None:
                rows = torch.arange(h.shape[0], device=h.device)
                h = h[rows, (idx - 1).clamp(min=0)][:, None]
            logits = self._columns(grp, params, name, lambda p, i, x:
                                   layer.preoutput(p, x), h)
            return logits if kind == "window" and not last else logits[:, 0]
        if isinstance(layer, TokenAndPositionEmbedding):
            if kind == "decode":
                fn = lambda p, i, x: layer.embed_at(p, x, i["positions"])
            elif kind == "window":
                fn = lambda p, i, x: layer.embed_chunk(p, x, i["pos0"])
            else:
                fn = lambda p, i, x: layer.forward(p, state[name], x)[0]
            return self._columns(grp, params, name, fn, xs[0])
        if isinstance(layer, SelfAttentionLayer):
            return self._attention(kind, name, layer, xs[0], grp, params,
                                   state, fresh)
        if isinstance(layer, TransformerFeedForward) and \
                self.mesh is not None:
            parts = []
            for t in range(self._tp):
                p = self._leaves(params, grp.g, t, name)
                x = xs[0].to(self._dev(grp.g, t))
                parts.append(gelu(x @ p["W1"] + p["b1"]) @ p["W2"])
            return self._row_parallel(parts, grp.home) + \
                self._leaves(params, grp.g, 0, name)["b2"]
        return v.forward(self._leaves(params, grp.g, 0, name), state[name],
                         xs)[0]

    def _columns(self, grp: _Group, params, name: str, fn, x):
        """A column-parallel vertex: ``fn(params, inputs, x)`` on every tp
        shard, the outputs concatenated on their last dim."""
        if self.mesh is None:
            return fn(params[name], grp.inp[0], x)
        parts = [fn(self._leaves(params, grp.g, t, name), grp.inp[t],
                    x.to(self._dev(grp.g, t))) for t in range(self._tp)]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(grp.home) for p in parts], dim=-1)

    def _attention(self, kind: str, name: str, layer, x, grp: _Group,
                   params, state, fresh: bool) -> torch.Tensor:
        """An attention vertex on data group ``grp``. Unsharded it is the
        layer's own cache seam. On a mesh each tp shard runs its heads
        through :meth:`_attn_view` on its part of the cache, and the
        shards' ``heads @ Wo`` partials are summed before ``bo`` and the
        activation."""
        if self.mesh is None:
            return self._cache_seam(kind, layer, params[name], x, grp.inp[0],
                                grp.kv[0][name] if grp.kv[0] is not None
                                else None, state[name], fresh, grp.writes)
        view = self._attn_view(name)
        parts = []
        for t in range(self._tp):
            p = self._leaves(params, grp.g, t, name)
            xt = x.to(self._dev(grp.g, t))
            inp = grp.inp[t]
            if kind == "prefill":
                q, k, v = view._project_qkv(p, xt)
                heads = view._attend(q, k, v, inp["kmask"])
                heads = heads.reshape(*heads.shape[:2], -1)
                self._write_prefill(name, t, grp, k, v)
            else:
                kv = grp.kv[t]
                heads = self._cache_seam(kind, view, p, xt, inp,
                                     None if kv is None else kv[name],
                                     state[name], fresh, None)
            parts.append(heads @ p["Wo"] if layer.project_out else heads)
        if layer.project_out:
            out = self._row_parallel(parts, grp.home) + \
                self._leaves(params, grp.g, 0, name)["bo"]
        else:
            out = parts[0] if len(parts) == 1 else \
                torch.cat([q.to(grp.home) for q in parts], dim=-1)
        return layer.activation_fn()(out)

    @staticmethod
    def _cache_seam(kind: str, lay, p, x, inp, cache, state, fresh, slots):
        """``lay``'s cache seam for ``kind`` (the layer itself, or a tp
        shard's view of it)."""
        if kind == "recompute":
            return lay.forward(p, state, x, mask=inp["kmask"])[0]
        if kind == "prefill":
            return lay.prefill_forward(p, x, cache, mask=inp["kmask"],
                                       slots=slots)[0]
        if kind == "decode":
            if "ptables" in inp:
                return lay.paged_decode_forward(p, x, cache, inp["ptables"],
                                                inp["positions"])[0]
            return lay.decode_forward(p, x, cache, inp["positions"])[0]
        if "ptables" in inp:
            return lay.paged_prefill_forward(p, x, cache, inp["ptables"],
                                             inp["pos0"], inp["valid"],
                                             fresh=fresh)[0]
        return lay.chunk_forward(p, x, cache, inp["pos0"], inp["valid"])[0]

    def _write_prefill(self, name: str, t: int, grp: _Group, k, v) -> None:
        """A sharded slab prefill's k / v [B, T, H/tp, Dh] of tp shard
        ``t`` into the cache rows of the slots' owner groups."""
        caches, plan = grp.writes
        tlen = k.shape[1]
        for o, sel, local in plan:
            c = self._grid[o, t]
            for kk, val in (("k", k), ("v", v)):
                dst = caches[name][kk].local(c)
                dst[local.to(dst.device), :, :tlen] = \
                    val[sel.to(val.device)].transpose(1, 2).to(
                        dst.device, dst.dtype)

    # graftlint: hot
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

    # graftlint: hot
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
    @_dispatching
    def prefill(self, caches, tokens, lengths, temps=None, seed: int = 0):
        """Fill ``caches`` from padded prompts [B, Tp] (+ true lengths [B])
        and return (first selected ids [B], last-position logits [B, V]
        f32, caches). ``seed`` seeds this selection's draw. No verdict
        column: the caller holds the logits."""
        return self._prefill(caches, tokens, lengths, None, temps, seed)

    @torch.no_grad()
    @_dispatching
    def prefill_slots(self, caches, tokens, lengths, slots, temps=None,
                      seed: int = 0):
        """Batched admission: one forward over [M, Tp] writes row i's k/v
        into cache row ``slots[i]`` (None: rows 0..M-1). Padded rows may
        repeat a slot with identical data. A sentinel decoder returns
        [M, 2] (id, verdict) in place of the ids."""
        sel, logits, caches = self._prefill(caches, tokens, lengths, slots,
                                            temps, seed)
        return self._out(self._with_verdict(sel, logits)), logits, caches

    def _prefill(self, caches, tokens, lengths, slots, temps, seed):
        m, tp = np.shape(tokens)
        # causal: a query reads (tp + 1) / 2 cells on average
        self._note_program("prefill" if slots is None else "prefill_slots",
                           m, tp, (tp + 1) // 2)
        host_t, temps_d = self._temps(temps, np.shape(tokens)[0])
        logits = self._walk_prefill(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(tokens, torch.long),
            self._to_dev(lengths, torch.long), slots)
        return (self._out(self._select(logits, temps_d, seed,
                                       bool((host_t > 0).any()))),
                logits, caches)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """A result the caller reads back, marked with the mesh shards it
        was gathered from."""
        return mark_shards(t, self.fetch_shards)

    @torch.no_grad()
    @_dispatching
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
        logits = self._walk_window(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(tokens, torch.long),
            self._to_dev(np.asarray([pos0]), torch.long),
            self._to_dev(np.asarray([valid]), torch.long), last=True,
            row_slot=int(slot))
        sel = self._select(logits, temps_d, seed, bool((host_t > 0).any()))
        return self._out(self._with_verdict(sel, logits, fault_in)), \
            logits, caches

    @torch.no_grad()
    @_dispatching
    def recompute_logits(self, tokens, lengths, temps=None, seed: int = 0):
        """The no-cache baseline step: one full forward over padded
        contexts [B, Tp] (true lengths [B]) and decode_step's selection.
        Returns (ids [B], logits [B, V] f32)."""
        host_t, temps_d = self._temps(temps, np.shape(tokens)[0])
        logits = self._walk_recompute(
            self._device_params(), self.net._inference_state(),
            self._to_dev(tokens, torch.long),
            self._to_dev(lengths, torch.long))
        return (self._out(self._select(logits, temps_d, seed,
                                       bool((host_t > 0).any()))), logits)

    @torch.no_grad()
    @_dispatching
    def decode_step(self, caches, ids, positions, temps=None, seed: int = 0):
        """One decode step; returns (next ids [B], logits [B, V] f32,
        caches)."""
        host_t, temps_d = self._temps(temps, np.shape(ids)[0])
        logits = self._walk_decode(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(ids, torch.long),
            self._to_dev(positions, torch.long))
        return (self._out(self._select(logits, temps_d, seed,
                                       bool((host_t > 0).any()))),
                logits, caches)

    @torch.no_grad()
    @_dispatching
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
        # the cost table's row is one step, attending the whole cache row
        self._note_program(("paged_" if ptables is not None else "") +
                           f"decode_block{k}", b, 1, self.t_max)
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
        return self._out(toks), ids, pos, stop, caches

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
    @_dispatching
    def paged_prefill(self, caches, tokens, pos0, valid, ptables,
                      temps=None, seed: int = 0, fault_in=None):
        """Batched tail prefill into page pools: tokens [M, C] are each
        row's prompt tail starting at absolute position ``pos0`` [M] (0 on
        a prefix-cache miss), ``valid`` [M] real tokens a row, ``ptables``
        [M, NP] the rows' page tables. Returns (selected next ids [M],
        last-position logits [M, V] f32, caches), like
        :meth:`prefill_slots` (the JAX package's returns (ids, pools)). A
        sentinel decoder returns [M, 2] (id, verdict) ids, the verdict
        ORed into ``fault_in`` [M] (a chunked tail's earlier windows).
        When every row starts at 0 the tails are whole prompts, and their
        attention takes the helper seam (B1, or B3 past 512 tokens, on the
        card), as the slab's prefill does."""
        # a tail attends the mapped pages of its whole row
        self._note_program("paged_prefill", np.shape(tokens)[0],
                           np.shape(tokens)[1], self.t_max)
        host_t, temps_d = self._temps(temps, np.shape(tokens)[0])
        logits = self._walk_window(
            self._device_params(), self.net._inference_state(), caches,
            self._to_dev(tokens, torch.long), self._to_dev(pos0, torch.long),
            self._to_dev(valid, torch.long),
            self._to_dev(ptables, torch.long), last=True,
            fresh=not np.asarray(pos0).any())
        sel = self._select(logits, temps_d, seed, bool((host_t > 0).any()))
        return self._out(self._with_verdict(sel, logits, fault_in)), \
            logits, caches

    @_dispatching
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

    def _row_parts(self, leaf, rows) -> List[Tuple[torch.Tensor,
                                                    torch.Tensor]]:
        """(tensor, its row indices) pairs that hold the global rows
        ``rows`` (dim 0) of a cache leaf: the leaf itself unsharded; on a
        mesh every tp shard of the owning data group for slab rows, and
        every copy for pool pages."""
        rows = np.asarray(rows, np.int64).reshape(-1)
        if not isinstance(leaf, ShardedTensor):
            return [(leaf, self._to_dev(rows, torch.long))]
        split = leaf.spec[0] if len(leaf.spec) else None
        out = []
        for c in self.mesh.coords():
            local = leaf.local(c)
            sel = rows
            if split is not None:
                per = local.shape[0]
                g = c[self.mesh.axis_index(split)]
                sel = rows[rows // per == g] % per
            if len(sel):
                out.append((local, to_device(sel, local.device,
                                             torch.long)))
        return out

    @torch.no_grad()
    @_dispatching
    def kv_export(self, caches, pids) -> Dict[str, Dict[str, torch.Tensor]]:
        """Gather pages ``pids`` out of every layer's pool: {layer:
        {"k", "v" [n, H, page_size, Dh]}} on the device (see
        ``paging.PageFrameSet.from_tensors``). On a mesh the frames are
        read from data group 0's copy, the tp shards' heads concatenated
        on the controller: the frame format does not change."""
        if self.mesh is None:
            idx = self._to_dev(pids, torch.long)
            return {n: {kk: caches[n][kk][idx] for kk in ("k", "v")}
                    for n in self.attn_names}
        out = {}
        for n in self.attn_names:
            out[n] = {}
            for kk in ("k", "v"):
                parts = []
                for t in range(self._tp):
                    local = caches[n][kk].local(self._grid[0, t])
                    idx = to_device(np.asarray(pids), local.device,
                                    torch.long)
                    parts.append(local[idx].to(self.device))
                out[n][kk] = torch.cat(parts, dim=1)
        return out

    @torch.no_grad()
    @_dispatching
    def kv_import(self, caches, pids, frames):
        """Scatter page frames ({layer: {"k", "v" [n, H, page_size, Dh]}})
        into the pools at ``pids`` in place (on a mesh every copy, each tp
        shard its heads); returns the pools."""
        for n in self.attn_names:
            for kk in ("k", "v"):
                pool = caches[n][kk]
                frame = frames[n][kk]
                if not isinstance(pool, ShardedTensor):
                    idx = self._to_dev(pids, torch.long)
                    pool[idx] = frame.to(pool.device, pool.dtype)
                    continue
                for c in self.mesh.coords():
                    local = pool.local(c)
                    idx = to_device(np.asarray(pids), local.device,
                                    torch.long)
                    local[idx] = local_slice(self.mesh, pool.spec, c,
                                             frame).to(local.device,
                                                       local.dtype)
        return caches

    @torch.no_grad()
    @_dispatching
    def scrub_slot(self, caches, slots):
        """Zero whole slab rows ``slots`` in place (after a sentinel
        fault: a chunk-admitted successor writes only its windows, and
        residual NaN past its fill point would reach it through the masked
        probs·V product, since 0 × NaN is NaN). Returns the caches."""
        for n in self.attn_names:
            for kk in ("k", "v"):
                for local, idx in self._row_parts(caches[n][kk], slots):
                    local[idx] = 0
        return caches

    @torch.no_grad()
    @_dispatching
    def scrub_pages(self, caches, pids):
        """Zero pool pages ``pids`` in place before they are reused (the
        same 0 × NaN hazard as :meth:`scrub_slot`; on a mesh in every
        copy). Returns the pools."""
        return self.scrub_slot(caches, pids)

    @torch.no_grad()
    @_dispatching
    def corrupt_page(self, caches, pid: int, mode: str = "nan"):
        """Chaos only: poison pool page ``pid`` in place (every copy):
        NaN fill (``"nan"``, trips the sentinel) or sign flip
        (``"flip"``, plausible values only content checksums catch)."""
        for n in self.attn_names:
            for kk in ("k", "v"):
                for local, idx in self._row_parts(caches[n][kk], [pid]):
                    page = local[idx]
                    local[idx] = torch.full_like(page, float("nan")) \
                        if mode == "nan" else -page
        return caches

    @torch.no_grad()
    @_dispatching
    def corrupt_cache(self, caches, slot: int, pos: int,
                      mode: str = "nan"):
        """Chaos only: poison slab cell (``slot``, ``pos``) in place, as
        :meth:`corrupt_page` does a page."""
        for n in self.attn_names:
            for kk in ("k", "v"):
                for local, idx in self._row_parts(caches[n][kk], [slot]):
                    cell = local[idx, :, int(pos)]
                    local[idx, :, int(pos)] = \
                        torch.full_like(cell, float("nan")) \
                        if mode == "nan" else -cell
        return caches

    # ------------------------------------------------------- speculation
    @torch.no_grad()
    @_dispatching
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
        self._note_program(("paged_" if ptables is not None else "") +
                           f"verify_block{kd}", b, kd + 1, self.t_max)
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
        return self._out(out), ids, pos, stop, caches

    @_dispatching
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

    # graftlint: hot
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
        block t's [B, K] tokens are read back, one readback per block. On
        a mesh the rows are padded to a multiple of the data axis with
        copies of row 0 (its temperature too), whose outputs are
        dropped."""
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        n_real = len(prompts)
        if n_real == 0:
            return []
        pad = (-n_real) % self._data
        prompts = prompts + [prompts[0].copy() for _ in range(pad)]
        b = len(prompts)
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
                                (n_real,)).copy()
        temps = np.concatenate([temps, np.repeat(temps[:1], pad)])
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
                np.int32) for p, g in zip(prompts[:n_real], gen[:n_real])]

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
        # one Trace for the request's whole life: it rides the request
        # through quarantine / requeue, so a recovered request keeps its
        # timeline (plus a takeover span per restart)
        self.trace: Optional[Trace] = None
        self._submit_t = interval_now()
        # SLO clocks, anchored at the ORIGINAL submission and written
        # once: requeue resets _submit_t (the queued span's clock) but
        # never these, so queue wait, TTFT and headroom span takeovers
        self._created_t = self._submit_t
        self._admitted_t: Optional[float] = None
        self._first_token_t: Optional[float] = None
        self._slo = None                   # SLOTracker, armed at submit
        self._slo_done = False             # an observe_request happened
        self._slo_labels: Dict = {}
        # the id the request journals under (None: not journaled),
        # stable across requeues; the latch keeps the terminal-state
        # journal callback to one
        self.journal_id: Optional[str] = None
        self._journal_hooked = False

    def _complete(self):
        self._result = np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int64)]).astype(
                np.int32)
        self._running = False
        if self.trace is not None:
            self.trace.finish("ok", tokens=len(self.generated))
        self._done.set()
        self._notify_slo("ok")
        self._fire_callbacks()

    def _fail(self, exc: BaseException):
        self._error = exc
        self._running = False
        if self.trace is not None:
            self.trace.finish(f"failed:{type(exc).__name__}",
                              tokens=len(self.generated))
        self._done.set()
        self._notify_slo(self._slo_status(exc))
        self._fire_callbacks()

    @staticmethod
    def _slo_status(exc: BaseException) -> str:
        """A terminal exception's SLO outcome class."""
        if isinstance(exc, DeadlineExceeded):
            return "deadline"
        if isinstance(exc, Cancelled):
            return "cancelled"
        if isinstance(exc, RejectedError):
            return "shed"
        return "failed"

    def _notify_slo(self, status: str) -> None:
        # exactly once per request, racing completion paths included: the
        # first notifier takes the tracker handle under _cb_lock
        with self._cb_lock:
            slo, self._slo = self._slo, None
        if slo is None:
            return
        self._slo_done = True
        try:
            slo.observe_request(self, status)
        except Exception:   # noqa: BLE001 — accounting must not strand
            pass            # the engine thread that completed us

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
                 spec_threshold: float = 0.35, spec_probe_every: int = 16,
                 registry=None, trace_store=None, tracing: bool = True,
                 slo=None, slo_label=None, flight_recorder=None,
                 journal=None, profiler=None,
                 profiling: Optional[bool] = None, phase: str = "both",
                 handoff=None, mesh=None, spec_layout=None):
        if decoder is not None and t_max is not None and \
                decoder.t_max != t_max:
            raise ValueError(f"shared decoder has t_max {decoder.t_max}, "
                             f"engine asked for {t_max}")
        if decoder is not None and mesh is not None and \
                decoder.mesh is not mesh:
            raise ValueError("shared decoder was built for a different "
                             "mesh; pass mesh= only when the engine owns "
                             "its decoder")
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
        # a shared decoder carries its mesh and layout, so an engine
        # rebuilt around it (a supervisor restart) serves sharded as well
        self.decoder = decoder if decoder is not None \
            else TransformerDecoder(
                net, t_max=t_max, mesh=mesh, spec_layout=spec_layout,
                sentinel=want_sentinel,
                logit_bound=None if self._integrity is None
                else self._integrity.logit_bound)
        self._sentinel_on = want_sentinel
        self.mesh = self.decoder.mesh
        if self.mesh is not None:
            layout = self.decoder._layout
            validate_decode_mesh(self.mesh, num_slots=int(num_slots),
                                 data_axis=layout.data_axis,
                                 tp_axis=layout.tp_axis)
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
        # phase specialization (the disaggregated tier): "prefill" fills
        # pages and hands every unfinished request to ``handoff`` instead
        # of decoding it; "decode" refuses fresh prompts and takes
        # requests through adopt(). Pages are the transfer unit, so both
        # need the paged cache. Recovery (requeue) stays open on decode
        # engines: role purity is a routing contract.
        if phase not in ("both", "prefill", "decode"):
            raise ValueError(f"phase must be 'both', 'prefill' or "
                             f"'decode', got {phase!r}")
        if phase != "both" and self._pager is None:
            raise ValueError("phase-specialized engines need paged=True: "
                             "KV pages are the handoff transfer unit")
        self.phase = phase
        self._handoff = handoff
        # (request, PageFrameSet) pairs received by adopt(), admitted by
        # the serve loop ahead of the prefill queue
        self._adopted: collections.deque = collections.deque()
        self._adopt_ctr = 0
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
        self._init_observability(registry, trace_store, tracing, slo,
                                 slo_label, flight_recorder, journal,
                                 profiler, profiling)

    def _init_observability(self, registry, trace_store, tracing, slo,
                            slo_label, flight_recorder, journal, profiler,
                            profiling) -> None:
        """The host tier's sinks, each the process default unless
        injected: the metrics registry (one labeled child of every
        counter family per engine; ``stats()`` is a view), the trace ring
        (``tracing`` opens a Trace per request), the SLO tracker (one
        record per request at its completion; ``slo_label`` is the stable
        replica label a supervisor passes to the engine it rebuilds), the
        flight recorder, the phase profiler (``profiling`` defaults to
        ``tracing``; its channel is keyed by ``slo_label``, so a rebuilt
        engine continues it) and the request journal (appends happen
        outside the engine lock, batched per block)."""
        self._journal = journal
        self._registry = registry if registry is not None \
            else default_registry()
        self._trace_store = trace_store if trace_store is not None \
            else default_trace_ring()
        self._tracing = bool(tracing)
        self.engine_id = f"e{next(_ENGINE_SEQ)}"
        self._slo = slo if slo is not None else default_slo_tracker()
        self.slo_label = str(slo_label) if slo_label is not None \
            else self.engine_id
        self._flightrec = flight_recorder if flight_recorder is not None \
            else default_flight_recorder()
        self._profiling = self._tracing if profiling is None \
            else bool(profiling)
        self._profiler = profiler if profiler is not None \
            else default_profiler()
        self._prof = self._profiler.channel(
            self.slo_label, num_slots=self.num_slots,
            decoder=self.decoder) if self._profiling else None
        reg = self._registry
        self._stats = _CounterView(reg, self.engine_id)
        self._h_block = reg.histogram(
            "generation_decode_block_seconds",
            "host wall time per decode block, dispatch to retire",
            ("engine",)).labels(self.engine_id)
        self._m_k = reg.counter(
            "generation_adaptive_k_total",
            "decode blocks dispatched, by adaptively chosen K",
            ("engine", "k"))
        self._m_spec_len = reg.counter(
            "generation_spec_accepted_total",
            "speculative verify lanes retired, by accepted draft "
            "length (0..K)", ("engine", "len"))
        self._h_spec_draft = reg.histogram(
            "generation_spec_draft_seconds",
            "host wall time drafting candidates per speculative block",
            ("engine",)).labels(self.engine_id)
        # gauges read at collection time through a WEAK reference: the
        # process-default registry must never keep a dead engine (and its
        # device caches) alive
        wself = weakref.ref(self)
        reg.gauge("generation_queue_depth", "pending requests queued "
                  "(incl. adopted handoffs awaiting a slot)",
                  ("engine",)).labels(self.engine_id).set_function(
            lambda: (lambda e: 0 if e is None else
                     len(e._pending) + len(e._adopted))(wself()))
        if self.mesh is not None:
            # one child per mesh axis: the topology never changes for an
            # engine's lifetime
            ax_g = reg.gauge("generation_mesh_axis_size",
                             "serving-mesh axis size (data/tp)",
                             ("engine", "axis"))
            for ax in self.mesh.axis_names:
                ax_g.labels(self.engine_id, ax).set(
                    int(self.mesh.shape[ax]))
        if self.phase != "both":
            # the role marker the fleet scrape reads each replica's
            # prefill / decode column from
            reg.gauge("generation_engine_role",
                      "phase-specialized engine role (1 = this engine "
                      "serves the labeled role)",
                      ("engine", "role")).labels(
                self.engine_id, self.phase).set(1)
        reg.gauge("generation_active_slots",
                  "cache slots decoding or chunk-prefilling",
                  ("engine",)).labels(self.engine_id).set_function(
            lambda: (lambda e: 0 if e is None else
                     sum(r is not None for r in e._slots) +
                     len(e._chunking))(wself()))
        if self._pager is not None:
            pg = reg.gauge("generation_kv_pages",
                           "KV page pool, pages by state",
                           ("engine", "state"))
            for st in ("free", "used", "cached", "shared"):
                pg.labels(self.engine_id, st).set_function(
                    lambda _st=st: (lambda e: 0 if e is None else
                                    e._pager.stats()[_st])(wself()))
            reg.gauge("generation_kv_pool_bytes",
                      "paged KV pool bytes allocated (global, all "
                      "layers)", ("engine",)).labels(
                self.engine_id).set_function(
                lambda: (lambda e: 0 if e is None else
                         e._pool_bytes())(wself()))
            reg.gauge("generation_kv_page_fragmentation",
                      "allocated-but-unwritten fraction of mapped "
                      "pages (internal fragmentation)",
                      ("engine",)).labels(self.engine_id).set_function(
                lambda: (lambda e: 0.0 if e is None else
                         (e.kv_page_stats() or {}).get(
                             "fragmentation", 0.0))(wself()))

    def _prof_impl(self, kind: str, k: Optional[int] = None) -> str:
        """The serving program's name under which the profiler records
        its measured time, the key of ``devstats.impl_cost_analysis``'s
        analytic cost (both with the decoder's mesh suffix)."""
        paged = "paged_" if self._pager is not None else ""
        if kind == "block":
            name = f"{paged}decode_block{int(k)}"
        elif kind == "verify":
            name = f"{paged}verify_block{int(k)}"
        else:
            name = "paged_prefill" if paged else "prefill_slots"
        return name + self.decoder._impl_suffix

    # ------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               eos_id: Optional[int] = None,
               deadline: Optional[float] = None,
               route: Optional[str] = None,
               journal_id: Optional[str] = None,
               _slo_sync_fail: bool = True,
               _canary: bool = False) -> GenerationRequest:
        """Queue a request. ``deadline`` is seconds from now; a stopped,
        dead or draining engine, an invalid request, a full queue and
        (with ``shed_headroom``) a projected deadline miss fail the
        returned handle at once. ``route`` labels its SLO record;
        ``journal_id`` pins the id it journals under (a journaled engine
        mints one otherwise), and the ``sub`` record lands before this
        returns. ``_slo_sync_fail=False`` (the fleet router) arms the SLO
        record only once the request is queued, since the router spills
        past a synchronous fast-fail to another replica; ``_canary=True``
        (the golden-canary probe) is never journaled or SLO-accounted. A
        decode-only engine refuses every fresh prompt."""
        req = GenerationRequest(prompt, max_new_tokens, temperature, eos_id,
                                deadline=deadline)
        req._engine = self
        if journal_id is not None:
            req.journal_id = str(journal_id)
        elif self._journal is not None and not _canary:
            req.journal_id = uuid.uuid4().hex[:16]
        if self._tracing:
            req.trace = Trace(store=self._trace_store)
            req.trace.event("submit", engine=self.engine_id,
                            prompt_len=len(req.prompt))
        req._slo_labels = {"replica": self.slo_label, "route": route}
        if _canary:
            req._slo_done = True      # never armed anywhere
        elif _slo_sync_fail:
            req._slo = self._slo
        with self._lock:
            dead = self._dead
            stopped = self._shutdown or dead is not None
        if stopped:
            # the caller learns the engine is gone even for no-op requests
            req._fail(dead or RuntimeError("SlotGenerationEngine shut down"))
            return req
        if self.phase == "decode":
            # the disagg router sends fresh prompts to prefill workers
            # only; requeue() and adopt() are this role's intakes
            req._fail(RuntimeError(
                "decode-only engine: fresh prompts belong on a prefill "
                "worker (handoff receives arrive via adopt())"))
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
        shed_event = None
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
                shed_event = {"reason": "draining"}
            elif queued and headroom_exc is not None:
                self._stats["rejected"] += 1
                self._stats["headroom_shed"] += 1
                shed = headroom_exc
                shed_event = {"reason": "headroom",
                              "projected_miss_s": round(
                                  headroom_exc.projected_miss_s, 4)}
            elif queued:
                depth = len(self._pending)
                if depth >= self.max_pending:
                    self._stats["rejected"] += 1
                    shed = RejectedError(
                        f"pending queue full ({depth} queued, max_pending="
                        f"{self.max_pending}) — request shed",
                        queue_depth=depth)
                    shed_event = {"queue_depth": depth}
                else:
                    # armed before the append: the loop may complete the
                    # request the instant it is queued
                    if not _canary:
                        req._slo = self._slo
                    self._pending.append(req)
        if shed is not None:
            self._flightrec.record("shed", engine=self.engine_id,
                                   **shed_event)
            req._fail(shed)
            return req
        if not queued:
            req._fail(dead or RuntimeError("SlotGenerationEngine shut down"))
            return req
        jr = self._journal
        if jr is not None and req.journal_id is not None:
            # write-ahead: the sub record lands before the caller can
            # observe acceptance; a SIGKILL from here on recovers it
            jr.submitted(req, route=route)
            self._hook_journal(req)
        self._work.set()
        return req

    def requeue(self, req: GenerationRequest) -> None:
        """Queue a recovered request (the supervisor's takeover): it
        re-prefills prompt + tokens so far and decodes on, token for token
        with an uninterrupted greedy run. Recovery bypasses admission
        control. Its trace gains a ``takeover`` event and its SLO record
        is re-armed on this engine's tracker, with its clocks untouched."""
        if req.trace is not None:
            req.trace.event("takeover", engine=self.engine_id,
                            generated=len(req.generated))
        if not req._slo_done:
            req._slo = self._slo
        req._slo_labels = dict(req._slo_labels or {},
                               replica=self.slo_label)
        req._submit_t = interval_now()
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
        jr = self._journal
        if jr is not None and req.journal_id is not None:
            # replay-inert resume marker: the forensic timeline shows
            # where each resumption happened
            jr.requeued(req)
            self._hook_journal(req)
        self._work.set()

    def _hook_journal(self, req: GenerationRequest) -> None:
        """Attach the terminal-state journal callback once per request
        (the latch rides the request, so takeovers never double-attach);
        it fires outside every engine lock."""
        with req._cb_lock:
            hooked, req._journal_hooked = req._journal_hooked, True
        if hooked:
            return
        jr = self._journal

        def _fin(r, _jr=jr):
            rid = r.journal_id
            if rid is None:
                return
            err = r._error
            if err is None:
                _jr.finished(rid, "done")
            elif isinstance(err, Cancelled):
                _jr.finished(rid, "cancelled")
            else:
                _jr.finished(rid, "failed",
                             error=f"{type(err).__name__}: {err}")

        req.add_done_callback(_fin)

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
            if req.trace is not None:
                req.trace.event("numerical_fault", engine=self.engine_id,
                                where=where, generated=len(req.generated))
            self._flightrec.record(
                "numerical_fault", engine=self.engine_id, where=where,
                generated=len(req.generated))
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
            if self._adopted:
                keep_a: collections.deque = collections.deque()
                for req, kv in self._adopted:
                    if req._cancel_requested:
                        self._stats["cancelled"] += 1
                        doomed.append((req, Cancelled(
                            "cancelled while awaiting adoption")))
                    elif req._expired(now):
                        self._stats["deadline_exceeded"] += 1
                        doomed.append((req, DeadlineExceeded(
                            f"deadline of {req.deadline}s passed while "
                            "awaiting adoption")))
                    else:
                        keep_a.append((req, kv))
                self._adopted = keep_a
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
        if req.trace is not None:
            req.trace.add_span("queued", req._submit_t, interval_now())
        return True

    def _admit(self):
        """Batched admission: every admittable queued request that finds a
        free slot joins ONE bucketed prefill_slots call with a single
        readback; a context longer than ``prefill_chunk`` enters chunked
        prefill instead. A recovered request re-prefills prompt + tokens
        so far. Adopted handoffs (decode role) admit first: their callers
        are already consuming tokens."""
        if self._pager is not None:
            self._admit_adopted()
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
            jlog: List[Tuple] = []       # journal appends, written
            #                              outside the engine lock below
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
                    self._book_first_token(req, tok, t0, t1, jlog,
                                           batch=m, bucket=mb, tp=tp,
                                           ctx=len(ctx))
                    if self._req_finished(req, tok):
                        self._stats["completed"] += 1
                        finishers.append(req)
                    else:
                        self._occupy_locked(s, req, tok, len(ctx))
                # slot contents changed: the next block resyncs from host
                self._carry = None
            t_host, t_journal = self._after_admission(m, mb, tp, t0, t1,
                                                      jlog)
            self._scrub_slots(scrub_slots)
            self._fail_faulted(faulted, "prefill")
            for req in finishers:
                req._complete()
            self._record_admission(m, t0, t1, t_host, t_journal)
            if drained:
                return

    def _book_first_token(self, req: GenerationRequest, tok: int,
                          t0: float, t1: float, jlog: List[Tuple],
                          **span) -> None:
        """An admitted request's first token (caller holds the engine
        lock): appended, queued for the journal, the SLO clocks stamped
        once (a request re-admitted after a takeover keeps its first
        queue wait and TTFT), the queued and prefill spans."""
        if self._journal is not None and req.journal_id is not None:
            jlog.append((req.journal_id, len(req.generated), (tok,)))
        req.generated.append(tok)
        if req._admitted_t is None:
            req._admitted_t = t0
        if req._first_token_t is None:
            req._first_token_t = t1
        self._stats["emitted_tokens"] += 1
        if req.trace is not None:
            req.trace.add_span("queued", req._submit_t, t0)
            req.trace.add_span("prefill", t0, t1, **span)

    def _after_admission(self, m: int, mb: int, tp: int, t0: float,
                         t1: float, jlog: List[Tuple]) -> Tuple[float,
                                                                float]:
        """Out-of-lock tail of an admission wave: its flight-recorder
        event, then the first tokens journaled (before any finisher
        completes, so a ``fin`` never precedes its tokens). Returns the
        profiler's host and journal stamps."""
        if self._tracing:
            self._flightrec.record(
                "admission", engine=self.engine_id, batch=m, bucket=mb,
                tp=tp, wait_ms=round((t1 - t0) * 1e3, 3))
        t_host = interval_now() if self._prof is not None else t1
        if jlog:
            self._journal.retired(jlog)
        t_journal = interval_now() if self._prof is not None else t_host
        return t_host, t_journal

    def _record_admission(self, m: int, t0: float, t1: float,
                          t_host: float, t_journal: float) -> None:
        if self._prof is not None:
            self._prof.record_admission(
                impl=self._prof_impl("prefill"), count=m, t_dispatch=t0,
                t_fetched=t1, t_host=t_host, t_journal=t_journal,
                t_publish=interval_now())

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
                        if req.trace is not None:
                            req.trace.event("prefix_hit", tokens=start,
                                            pages=len(shared))
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
            handoffs: List[Tuple[GenerationRequest, int, np.ndarray]] = []
            to_sum: List[Tuple[np.ndarray, int]] = []
            registered_ctx: Optional[np.ndarray] = None
            jlog: List[Tuple] = []
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
                    self._book_first_token(req, tok, t0, t1, jlog,
                                           batch=m, bucket=mb, tp=c,
                                           ctx=len(ctx), prefix=start)
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
                    elif self.phase == "prefill":
                        # never decodes here: the pages stay mapped until
                        # the export below ships them
                        handoffs.append((req, s, ctx))
                    else:
                        self._occupy_locked(s, req, tok, len(ctx))
                self._carry = None
            t_host, t_journal = self._after_admission(m, mb, c, t0, t1,
                                                      jlog)
            self._scrub_pages(scrub)
            self._fail_faulted(faulted, "paged_prefill")
            self._after_register(to_sum, registered_ctx)
            for req in finishers:
                req._complete()
            self._record_admission(m, t0, t1, t_host, t_journal)
            # after the wave's bookkeeping, on this thread: each export
            # releases its slot's pages before the next wave can map it
            for req, s, ctx in handoffs:
                self._handoff_one(req, s, ctx)
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
        if req._admitted_t is None:
            req._admitted_t = t0    # the queue wait ends at the first window
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
        if self._tracing:
            self._flightrec.record(
                "prefill_chunk", engine=self.engine_id, slot=s,
                pos0=pos0, valid=valid, final=final,
                ms=round((t1 - t0) * 1e3, 3))
        if self._prof is not None:
            # non-final windows never sync (t1 is dispatch return): only
            # the device phase is attributable, but the window still
            # anchors the bubble account
            self._prof.record_chunk(t_dispatch=t0, t_done=t1, final=final)
        finish = None
        faulted: List[GenerationRequest] = []
        scrub: List[int] = []
        scrub_slots: List[int] = []
        registered = False
        handoff_entry = None
        jlog: List[Tuple] = []
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
                if self._journal is not None and req.journal_id is not None:
                    jlog.append((req.journal_id, len(req.generated),
                                 (tok,)))
                req.generated.append(tok)
                if req._first_token_t is None:
                    req._first_token_t = t1
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
                elif self.phase == "prefill":
                    # the final window's token is the handoff point: the
                    # pages stay mapped for the export below
                    handoff_entry = (req, s, ctx)
                else:
                    self._occupy_locked(s, req, tok, len(ctx))
                    self._carry = None
        if req.trace is not None:
            req.trace.add_span("prefill_chunk", t0, t1, pos0=pos0,
                               valid=valid, final=final)
        if jlog:
            # the first token journaled before the finisher completes
            self._journal.retired(jlog)
        self._scrub_pages(scrub)
        self._scrub_slots(scrub_slots)
        self._fail_faulted(faulted, "prefill_chunk")
        if registered:
            self._after_register(
                [(ctx, len(ctx) // self.page_size)]
                if self._kv_verifier is not None else [], ctx)
        if finish is not None:
            finish._complete()
        if handoff_entry is not None:
            self._handoff_one(*handoff_entry)

    def _ensure_decode_pages_locked(self, k: int
                                    ) -> List[GenerationRequest]:
        """Grow each active lane's table to cover this dispatch's furthest
        write (position + in-flight lead + k - 1, clamped to the context
        edge); caller holds the engine lock. With a block in flight the
        device carry runs one block ahead of the host positions, hence
        the lead. A lane the pool cannot serve, even after evicting
        cache-only prefix pages, is preempted: unmapped and requeued at
        the head. Highest slots go first, so their pages serve the lower
        lanes. Returns the preempted requests."""
        ps = self.page_size
        preempted: List[GenerationRequest] = []
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
            preempted.append(req)
        return preempted

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

    # ------------------------------------------------ disagg handoff
    def _pool_dtype_name(self) -> str:
        """The page pool's dtype as a PageFrameSet names it."""
        pool = next(iter(self._caches.values()))["k"]
        return str(pool.dtype).replace("torch.", "")

    def _export_pages(self, pids: List[int],
                      tag: str = "kv_handoff") -> Dict:
        """Pool pages ``pids`` as host frames {layer: {"k", "v" [n, H,
        page_size, Dh]}} (bfloat16 as raw uint16 words): one gather a
        layer, every copy started behind it before any is waited for,
        then 2 x layers readbacks under ``tag`` (``kv_handoff`` for a
        disagg export, ``integrity.verify`` for checksums), none of them
        a decode block's. Each waits on its own copy's event only."""
        frames = self.decoder.kv_export(self._caches, pids)
        started = {}
        for n, kv in frames.items():
            started[n] = {}
            for kk, t in kv.items():
                if t.dtype == torch.bfloat16:   # numpy has no bfloat16
                    t = t.view(torch.int16)
                started[n][kk] = start_fetch(t)
        host = {}
        for n, kv in started.items():
            host[n] = {}
            for kk, hc in kv.items():
                a = device_fetch(hc, tag=tag)
                host[n][kk] = a.view(np.uint16) if a.dtype == np.int16 \
                    else a
        return host

    def _import_pages(self, pids: List[int], frames: Dict) -> None:
        """Scatter host frames ({layer: {"k", "v"}}, raw words for
        bfloat16) into this pool at ``pids``: every frame packed into one
        host buffer and moved in ONE host→device copy from pinned memory
        (``ops/transfer.to_device``), then split on the device. Serve-loop
        thread only."""
        names = sorted(frames)
        host = np.stack([np.asarray(frames[n][kk]) for n in names
                         for kk in ("k", "v")])
        if host.dtype == np.uint16:
            host = host.view(np.int16)
        dev = to_device(host, self.device)
        if self._pool_dtype_name() == "bfloat16":
            dev = dev.view(torch.bfloat16)
        parts = {n: {kk: dev[2 * i + j] for j, kk in enumerate(("k", "v"))}
                 for i, n in enumerate(names)}
        # _caches is serve-loop-thread-owned (every dispatch site
        # threads the pools the same way); the analyzer can't see the
        # single-thread ownership contract
        self._caches = self.decoder.kv_import(  # graftlint: disable=GL006
            self._caches, pids, parts)

    def _handoff_one(self, req: GenerationRequest, s: int,
                     ctx: np.ndarray) -> None:
        """Export slot ``s``'s pages and pass the request, which holds its
        first token, to the handoff sink (prefill-only engines,
        serve-loop thread). The frames cover context cells [0, len(ctx))
        the receiver's decode attends. A quarantine or shutdown racing the
        export owns the request (and released the pages): nothing
        ships."""
        from .paging import PageFrameSet
        ps = self.page_size
        n_xfer = (len(ctx) - 1) // ps + 1
        with self._lock:
            if self._shutdown:
                return
            pages = list(self._slot_pages[s][:n_xfer])
        t0 = interval_now()
        layers = self._export_pages(pages)
        t1 = interval_now()
        # content checksums only when verification is armed: the
        # integrity-off handoff stays CRC-only
        state = PageFrameSet(
            ps, ctx, layers, dtype=self._pool_dtype_name(),
            checksums=None if self._kv_verifier is not None else False)
        # chaos (device.corrupt_page at "handoff"): flip the host frames
        # after their checksums were stamped, so every CRC downstream
        # passes and only content verification can catch it
        plan = self._faults.corruption("device.corrupt_page",
                                       where="handoff")
        if plan is not None:
            from ..observability.integrity import corrupt_host_frames
            corrupt_host_frames(state, plan["mode"])
            self._flightrec.record(
                "corruption_injected", engine=self.engine_id,
                point="device.corrupt_page", where="handoff",
                mode=plan["mode"])
        cancelled = req._cancel_requested
        with self._lock:
            if self._shutdown:
                return          # the drain released the mapping already
            self._release_slot_pages(s)
            self._stats["cancelled" if cancelled else "handoffs"] += 1
        if cancelled:
            req._fail(Cancelled("cancelled at prefill handoff"))
            return
        if req.trace is not None:
            req.trace.add_span("kv_export", t0, t1, pages=len(pages),
                               bytes=state.nbytes)
        if self._tracing:
            self._flightrec.record(
                "kv_handoff", engine=self.engine_id, stage="export",
                pages=len(pages), bytes=state.nbytes,
                ms=round((t1 - t0) * 1e3, 3))
        sink = self._handoff
        if sink is None:
            req._fail(RuntimeError(
                "prefill-only engine has no handoff sink"))
            return
        try:
            sink(req, state)
        except Exception as exc:   # noqa: BLE001 — a broken sink must
            req._fail(exc)         # not kill the serve loop

    def adopt(self, req: GenerationRequest, kv) -> None:
        """Take a prefilled request WITH its exported KV state (a
        :class:`~.paging.PageFrameSet`: ``page_size``, ``tokens``,
        ``layers``, ``dtype``) — the decode side of the disaggregated
        handoff. The geometry is checked here (ValueError: the router
        re-prefills instead); the import runs on the serve loop, which
        maps pages from this pool (resident same-content chains reused
        read-only), scatters the frames and resumes decode at position
        ``len(kv.tokens)``. Like ``requeue``, it bypasses admission
        control; pool pressure still applies."""
        if self._pager is None:
            raise ValueError("adopt() needs a paged engine (pages are "
                             "the handoff transfer unit)")
        if int(kv.page_size) != self.page_size:
            raise ValueError(
                f"page_size mismatch: frames carry {kv.page_size}, this "
                f"pool uses {self.page_size} — disaggregated roles must "
                "share one page geometry")
        want_dtype = self._pool_dtype_name()
        if str(getattr(kv, "dtype", "")) != want_dtype:
            raise ValueError(f"frame dtype {getattr(kv, 'dtype', None)} "
                             f"!= pool dtype {want_dtype}")
        for n, pool in self._caches.items():
            lf = kv.layers.get(n)
            if lf is None:
                raise ValueError(f"page frames missing attention vertex "
                                 f"{n!r}")
            for kk in ("k", "v"):
                want = tuple(int(x) for x in pool[kk].shape[1:])
                got = tuple(int(x) for x in np.shape(lf[kk])[1:])
                if got != want:
                    raise ValueError(
                        f"frame shape {tuple(np.shape(lf[kk]))} does not "
                        f"match pool page geometry {want} at {n!r}")
        expect = len(req.prompt) + len(req.generated) - 1
        if len(kv.tokens) != expect:
            raise ValueError(
                f"frame set covers {len(kv.tokens)} context tokens; the "
                f"request resumes at {expect}")
        # sampled content verification at intake: a flip anywhere between
        # export and here fails before a corrupt byte reaches this pool
        # (a serialized transport's wire decode already verified them)
        if self._kv_verifier is not None and hasattr(kv, "verify") and \
                not getattr(kv, "_verified", False):
            with self._lock:
                self._adopt_ctr += 1
                due = self._adopt_ctr % self._integrity.verify_every == 0
            if due:
                bad = kv.verify()
                if bad:
                    from .paging import PageCorruptionError
                    with self._lock:
                        self._stats["kv_page_corruptions"] += 1
                    self._flightrec.record(
                        "kv_corruption", engine=self.engine_id,
                        detector="adopt", pages=len(bad))
                    raise PageCorruptionError(
                        f"adopt intake: page content checksum mismatch "
                        f"on page(s) {bad} — corrupt frames refused")
        if req.trace is not None:
            req.trace.event("adopt", engine=self.engine_id,
                            ctx=len(kv.tokens))
        # SLO continuity as in requeue: the sink and replica label move,
        # the created / admitted / first-token clocks do not
        if not req._slo_done:
            req._slo = self._slo
        req._slo_labels = dict(req._slo_labels or {},
                               replica=self.slo_label)
        req._submit_t = interval_now()
        with self._lock:
            dead = self._dead
            alive = not (self._shutdown or dead is not None)
            if alive:
                req._running = False
                req._engine = self
                self._adopted.append((req, kv))
                self._stats["adopted"] += 1
        if not alive:
            req._fail(dead or RuntimeError("SlotGenerationEngine shut down"))
            return
        jr = self._journal
        if jr is not None and req.journal_id is not None:
            # a replay-inert hop marker, like a takeover's
            jr.requeued(req)
            self._hook_journal(req)
        self._work.set()

    def _admit_adopted(self):
        """Admit adopted handoffs (serve-loop thread): map and import each
        request's pages into this pool and install its decode state — no
        prefill; the shipped pages are the prefill. Resident same-content
        chains are mapped read-only and only the other frames scatter
        in."""
        ps = self.page_size
        while True:
            entry = None
            with self._lock:
                if self._adopted and not self._shutdown:
                    free = [s for s in range(self.num_slots)
                            if self._slots[s] is None and
                            s not in self._chunking and
                            not self._slot_pages[s]]
                    if free:
                        req, kv = self._adopted.popleft()
                        self._admitting.append(req)
                        entry = (free[0], req, kv)
            if entry is None:
                return
            s, req, kv = entry
            exc = None
            if req._cancel_requested:
                exc = Cancelled("cancelled before adoption")
            elif req._expired():
                exc = DeadlineExceeded(
                    f"deadline of {req.deadline}s passed in handoff")
            if exc is not None:
                with self._lock:
                    if not self._unpark(req):
                        return
                    self._stats["cancelled" if isinstance(exc, Cancelled)
                                else "deadline_exceeded"] += 1
                req._fail(exc)
                continue
            tokens = np.asarray(kv.tokens, np.int64).reshape(-1)
            n_ctx = len(tokens)
            total = n_ctx // ps + 1     # with the next write's cell
            shared, start = self._pager.match_and_ref(tokens,
                                                      max_tokens=n_ctx)
            fresh = self._pager.alloc(total - len(shared))
            if fresh is None:
                for pid in shared:
                    self._pager.unref(pid)
                # with work in flight wait at the head (completions free
                # pages); with none this pool can never hold it: shed
                requeued = False
                with self._lock:
                    if not self._unpark(req):
                        return
                    if self._any_active():
                        self._adopted.appendleft((req, kv))
                        requeued = True
                    else:
                        self._stats["rejected"] += 1
                if requeued:
                    return
                self._flightrec.record(
                    "shed", engine=self.engine_id, reason="kv_pool_adopt",
                    pages_needed=total - len(shared))
                req._fail(RejectedError(
                    f"KV page pool exhausted on handoff receive: "
                    f"{total - len(shared)} pages needed, none free "
                    "after eviction and nothing in flight to free one"))
                continue
            pages = shared + fresh
            n_xfer = min((n_ctx - 1) // ps + 1, int(kv.n_pages))
            import_idx = list(range(len(shared), n_xfer))
            t0 = interval_now()
            if import_idx:
                self._import_pages(
                    [pages[j] for j in import_idx],
                    {n: {kk: np.asarray(lf[kk])[import_idx]
                         for kk in ("k", "v")}
                     for n, lf in kv.layers.items()})
            t1 = interval_now()
            finish = None
            with self._lock:
                if self._shutdown or not self._unpark(req):
                    # the drain owns the request; these refs go back so
                    # its harvest audits balanced
                    for pid in pages:
                        self._pager.unref(pid)
                    return
                self._map_slot_pages(s, pages)
                # the imported context's full pages become shareable here
                self._pager.register_chain(tokens, pages[:n_ctx // ps])
                if req._admitted_t is None:
                    req._admitted_t = t0
                tok = int(req.generated[-1])
                if len(req.prompt) + len(req.generated) >= self.t_max \
                        or len(req.generated) >= req.max_new_tokens:
                    # a sender completes its finishers itself
                    self._stats["completed"] += 1
                    finish = req
                    self._release_slot_pages(s)
                else:
                    req._running = True
                    self._occupy_locked(s, req, tok, n_ctx)
                    self._carry = None    # the pipeline resyncs
            if req.trace is not None:
                req.trace.add_span("queued", req._submit_t, t0)
                req.trace.add_span("kv_import", t0, t1,
                                   pages=len(import_idx),
                                   shared_pages=len(shared),
                                   shared_tokens=start)
            if self._tracing:
                self._flightrec.record(
                    "kv_handoff", engine=self.engine_id, stage="import",
                    pages=len(import_idx), shared=len(shared),
                    ms=round((t1 - t0) * 1e3, 3))
            if self._kv_verifier is not None:
                self._record_page_sums([(tokens, n_ctx // ps)])
            if finish is not None:
                finish._complete()

    # ------------------------------------------- KV content integrity
    def _page_sums(self, pids: List[int]) -> List[bytes]:
        """Content checksums of pool pages ``pids``: each layer's k then v
        bytes in sorted-layer order (PageFrameSet's recipe), from one
        export under the ``integrity.verify`` tag."""
        host = self._export_pages(pids, tag="integrity.verify")
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
        self._flightrec.record(
            "kv_corruption", engine=self.engine_id, page=int(shared[bad]),
            detector="prefix_hit")
        self._preempt_corrupt_holders(set(shared[bad:]))
        return bad

    def _preempt_corrupt_holders(self, pids: set) -> None:
        """Requeue at the head every stream mapping a corrupt page (its
        private pages, computed over the corrupt ones, are scrubbed too):
        the evicted chain cannot be re-mapped, so it re-prefills clean."""
        scrub: List[int] = []
        victims: List[GenerationRequest] = []
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
                    victims.append(req)
                self._carry = None
        self._scrub_pages(scrub)
        for req in victims:
            if req.trace is not None:
                req.trace.event("kv_corruption_preempt",
                                engine=self.engine_id,
                                generated=len(req.generated))
        self._note_preempted(victims, reason="kv_corruption")

    def _note_preempted(self, victims: List[GenerationRequest],
                        **attrs) -> None:
        """Out-of-lock bookkeeping of preempted lanes: a flight-recorder
        event each and a journal resume marker."""
        for req in victims:
            self._flightrec.record("page_preempt", engine=self.engine_id,
                                   generated=len(req.generated), **attrs)
            if self._journal is not None and req.journal_id is not None:
                self._journal.requeued(req)

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
            self._caches = self.decoder.scrub_pages(  # graftlint: disable=GL006
                self._caches, pids)

    def _scrub_slots(self, slots: List[int]) -> None:
        """Zero sentinel-faulted slab rows before refill hands them on."""
        if self._pager is None and slots:
            self._caches = self.decoder.scrub_slot(  # graftlint: disable=GL006
                self._caches, slots)

    def _corrupt_registered_page(self, ctx: np.ndarray, mode: str) -> None:
        """Chaos only (``device.corrupt_page`` at ``"registered"``):
        poison the first cached page of ``ctx``'s chain on the device."""
        digests = chain_digests(ctx[:self.page_size], self.page_size)
        pid = self._pager.cached_page(digests[0]) if digests else None
        if pid is not None:
            # serve-loop-owned pools, same single-thread contract as
            # every dispatch site
            self._caches = self.decoder.corrupt_page(  # graftlint: disable=GL006
                self._caches, int(pid), mode)

    def _inject_corrupt_logits(self, mode: str, s: int) -> None:
        """Chaos only (``device.corrupt_logits``): poison lane ``s``'s
        always-attended KV (its first page, or slab cell 0) before a
        block dispatch, so the block's logits go bad."""
        if self._pager is not None:
            with self._lock:
                pages = list(self._slot_pages[s])
            if pages:
                self._caches = self.decoder.corrupt_page(  # graftlint: disable=GL006
                    self._caches, int(pages[0]), mode)
        else:
            self._caches = self.decoder.corrupt_cache(  # graftlint: disable=GL006
                self._caches, int(s), 0, mode)

    # ------------------------------------------------------------ decoding
    def _step(self):
        """One serve-loop cycle: a chunked-prefill window first (when a
        slot is chunking), then a speculative block or a plain pipelined
        block (always, without speculation; during the low-acceptance
        cooldown, with it)."""
        if self._chunking:
            self._advance_chunks()
        if self.speculative and self.phase != "prefill":
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
        preempted: List[GenerationRequest] = []
        with self._lock:
            if self._pager is not None and not self._shutdown:
                preempted = self._ensure_decode_pages_locked(k)
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
                            self._eos_ids.copy(), ptab, len(self._pending))
        for req in preempted:
            if req.trace is not None:
                req.trace.event("page_preempt", engine=self.engine_id,
                                generated=len(req.generated))
        self._note_preempted(preempted)
        if dispatch is not None:
            (ids, pos, stop), step0, temps, eos, ptab, qdepth = dispatch
            if self.adaptive_block:
                self._m_k.labels(self.engine_id, str(k)).inc()
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
                    self._inflight = (start_fetch(toks), snapshot, k, t_disp,
                                      qdepth)
        if prev is not None and dispatch is not None:
            self._retire_block(prev)

    def _retire_block(self, block):
        """Read one block's [S, K] tokens (ONE readback; a sentinel's
        verdict is column K of the same copy) and book them: per-lane
        appends until a stop, slot frees, completions. A tripped lane
        drops the whole block's tokens, frees (and scrubs) its slot and
        fails typed."""
        copy, snapshot, k, t_disp, qdepth = block
        host = device_fetch(copy, tag="engine.decode")
        t_ret = interval_now()
        fault_col = None
        if self._sentinel_on:
            fault_col, host = host[:, k], host[:, :k]
        if self._tracing:
            self._h_block.observe(t_ret - t_disp)
            self._flightrec.record("block_retire", engine=self.engine_id,
                                   k=k, lanes=len(snapshot),
                                   ms=round((t_ret - t_disp) * 1e3, 3))
        finished: List[GenerationRequest] = []
        faulted: List[GenerationRequest] = []
        scrub: List[int] = []
        scrub_slots: List[int] = []
        jlog: List[Tuple] = []
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
                base = len(req.generated)
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
                took = len(req.generated) - base
                if self._journal is not None and \
                        req.journal_id is not None and took:
                    jlog.append((req.journal_id, base,
                                 req.generated[base:]))
                if req.trace is not None:
                    req.trace.add_span("decode_block", t_disp, t_ret,
                                       k=k, tokens=took)
                if not closed:
                    self._positions[s] += k
                    self._last_ids[s] = int(host[s, k - 1])
            self._first_step_done = True
            if finished or faulted:
                # freed lanes must not keep decoding from the device carry
                self._carry = None
        # phase stamps, outside the engine lock: dispatch → fetched →
        # host → journal → publish telescope to the block's wall time
        prof = self._prof
        t_host = interval_now() if prof is not None else t_ret
        if jlog:
            # one journal write (and at most one fsync, per the journal's
            # policy) a block, outside the engine lock
            self._journal.retired(jlog)
        t_journal = interval_now() if prof is not None else t_host
        self._scrub_pages(scrub)
        self._scrub_slots(scrub_slots)
        self._fail_faulted(faulted, f"decode_block{k}")
        for req in finished:
            req._complete()
        if prof is not None:
            prof.record_block(
                impl=self._prof_impl("block", k), k=k, lanes=len(snapshot),
                queued=qdepth, t_dispatch=t_disp, t_fetched=t_ret,
                t_host=t_host, t_journal=t_journal, t_publish=interval_now())

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
        preempted: List[GenerationRequest] = []
        with self._lock:
            if not self._shutdown and self._pager is not None:
                # the window's furthest write is position + kd; nothing
                # is in flight, so there is no lead
                preempted = self._ensure_decode_pages_locked(kd + 1)
        for req in preempted:
            if req.trace is not None:
                req.trace.event("page_preempt", engine=self.engine_id,
                                generated=len(req.generated))
        self._note_preempted(preempted)
        t_draft = interval_now()
        with self._lock:
            if self._shutdown:
                return
            snapshot = [(s, self._slots[s]) for s in range(self.num_slots)
                        if self._slots[s] is not None]
            if not snapshot:
                return
            qdepth = len(self._pending)
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
        self._retire_spec(toks, snapshot, kd, t_disp, t_draft, qdepth)

    def _retire_spec(self, toks, snapshot, kd: int, t_disp: float,
                     t_draft: float, qdepth: int) -> None:
        """Read one verify block's [S, K+1 tokens | emit (| verdict)] (ONE
        readback) and append each lane's accepted prefix; open lanes
        advance by what they emitted (the slab's rewind) and paged lanes
        truncate their tables. A tripped lane fails as in
        :meth:`_retire_block`. The acceptance average decides the
        cooldown."""
        host = device_fetch(toks, tag="engine.decode")
        t_ret = interval_now()
        fault_col = host[:, kd + 2] if self._sentinel_on else None
        if self._tracing:
            self._h_block.observe(t_ret - t_disp)
            self._flightrec.record("block_retire", engine=self.engine_id,
                                   k=kd, lanes=len(snapshot), spec=True,
                                   ms=round((t_ret - t_disp) * 1e3, 3))
        finished: List[GenerationRequest] = []
        faulted: List[GenerationRequest] = []
        scrub: List[int] = []
        scrub_slots: List[int] = []
        jlog: List[Tuple] = []
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
                acc = max(0, take - 1)
                accepted += acc
                self._m_spec_len.labels(self.engine_id, str(acc)).inc()
                took = 0
                base = len(req.generated)
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
                if self._journal is not None and \
                        req.journal_id is not None and took:
                    jlog.append((req.journal_id, base,
                                 req.generated[base:]))
                if req.trace is not None:
                    req.trace.add_span("verify_block", t_disp, t_ret,
                                       k=kd, tokens=took)
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
        t_rewind = interval_now()
        prof = self._prof
        t_host = interval_now() if prof is not None else t_rewind
        if jlog:
            self._journal.retired(jlog)
        t_journal = interval_now() if prof is not None else t_host
        self._scrub_pages(scrub)
        self._scrub_slots(scrub_slots)
        self._fail_faulted(faulted, f"verify_block{kd}")
        for req in finished:
            req._complete()
        if self._tracing:
            self._h_spec_draft.observe(max(0.0, t_disp - t_draft))
        if prof is not None:
            prof.record_spec(
                impl=self._prof_impl("verify", kd), k=kd,
                lanes=len(snapshot), queued=qdepth, accepted=accepted,
                drafted=drafted, t_draft=t_draft, t_dispatch=t_disp,
                t_fetched=t_ret, t_rewind=t_rewind, t_host=t_host,
                t_journal=t_journal, t_publish=interval_now())

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
        """Take every request the engine holds (mid-admit, adopted,
        mid-chunk, in a slot, queued, in that order) and reset the slots, the pipeline
        (in-flight tokens are never read: a resumed request regenerates
        them) and the page mappings; caller holds the engine lock."""
        taken = list(self._admitting)
        self._admitting = []
        # adoptions not yet in a slot: recovery re-prefills them (their
        # frames are dropped; a re-prefill regenerates the KV)
        taken.extend(r for r, _ in self._adopted)
        self._adopted.clear()
        for s in sorted(self._chunking):
            taken.append(self._chunking[s][0])
        # caller holds the engine lock (the _locked contract); the
        # analyzer just can't see across the call boundary
        self._chunking = {}   # graftlint: disable=GL006
        for s in range(self.num_slots):
            if self._slots[s] is not None:
                taken.append(self._slots[s])
                self._slots[s] = None
        taken.extend(self._pending)
        self._pending.clear()
        # under self._lock (the _locked contract)
        self._inflight = None   # graftlint: disable=GL006
        self._carry = None
        self._release_all_pages()
        return taken

    def stats(self) -> Dict[str, int]:
        """Serving counters — a view over this engine's registry
        children — plus the live queue depth and active slots (decoding
        or chunk-prefilling)."""
        out = self._stats.snapshot()
        with self._lock:
            # adoptions awaiting a slot are queued work: the disagg
            # router's least-loaded decode dispatch reads this
            out["queue_depth"] = len(self._pending) + len(self._adopted)
            out["active_slots"] = sum(r is not None for r in self._slots) + \
                len(self._chunking)
        # the serving topology: "<data>x<tp>", None unsharded
        out["mesh_shape"] = mesh_tag(self.mesh) or None
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
                if not self._pending and not self._adopted:
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


# the counters as read-only attributes (``eng.emitted_tokens``, ...), views
# over the engine's registry children
for _counter_name in _ENGINE_COUNTERS:
    setattr(SlotGenerationEngine, _counter_name,
            property(lambda self, _k=_counter_name: self._stats[_k],
                     doc=f"registry view: {_ENGINE_COUNTERS[_counter_name][0]}"
                         "{engine=<id>}"))
del _counter_name
