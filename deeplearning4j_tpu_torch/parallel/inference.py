"""ParallelInference (reference parallelism/ParallelInference.java +
observers/BatchedInferenceObservable.java) — the JAX package's
``parallel/inference.py``: an inference server with SEQUENTIAL and
BATCHED modes and a shared generation engine.

BATCHED mode keeps the reference's request coalescing: concurrent
callers' inputs are concatenated up to ``max_batch_size``, run as one
forward, and the slices handed back. Without a mesh the forward runs on
the net's device. With ``mesh=`` (``parallel.mesh.make_mesh(n)``; the
``Builder``'s ``workers(n)``) it is data-parallel: the batch rows, padded
to a multiple of the mesh's coordinates, split over them in contiguous
runs, each run through a replica of the params on its coordinate's
device, the outputs concatenated in order. ``generate`` coalesces
concurrent callers into ONE slot engine (``models/generation.py``),
sharded over ``generation_mesh`` when one is given."""

from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np
import torch

from .mesh import Mesh, make_mesh


class InferenceMode:
    SEQUENTIAL = "sequential"
    BATCHED = "batched"


class ParallelInference:
    def __init__(self, net, mesh=None,
                 inference_mode: str = InferenceMode.BATCHED,
                 max_batch_size: int = 64, queue_timeout: float = 0.005,
                 generation_slots: int = 8,
                 generation_t_max: Optional[int] = None,
                 generation_max_pending: int = 256,
                 generation_supervised: bool = False,
                 generation_supervisor_timeout: float = 10.0,
                 generation_max_restarts: int = 3,
                 generation_fault_injector=None,
                 generation_block_size: int = 1,
                 generation_registry=None,
                 generation_trace_store=None,
                 generation_tracing: bool = True,
                 generation_mesh=None,
                 generation_journal_dir: Optional[str] = None,
                 generation_journal_fsync: str = "every_n",
                 generation_recover: bool = True,
                 generation_scheduling: str = "fifo",
                 generation_shed_headroom: bool = False,
                 generation_headroom_margin: float = 1.0,
                 generation_prefill_chunk: Optional[int] = None,
                 generation_adaptive_block: bool = False,
                 generation_block_ladder=None,
                 generation_block_latency_target: float = 0.25,
                 generation_paged: bool = False,
                 generation_page_size: int = 16,
                 generation_num_pages: Optional[int] = None,
                 generation_prefix_cache: bool = True):
        for name, m in (("mesh", mesh), ("generation_mesh",
                                         generation_mesh)):
            if m is not None and not isinstance(m, Mesh):
                raise TypeError(f"{name} must be a parallel.mesh.Mesh "
                                f"(make_mesh / generation_mesh), got "
                                f"{type(m).__name__}")
        self.net = net
        self.mesh = mesh
        # per mesh coordinate: (params, state) replicas on its device,
        # made at the first forward (rebuilt when net.params is replaced)
        self._replicas = None
        self._replica_src = None
        # mesh-sharded generation: the engine decodes over this (data,
        # tp) mesh (models/generation.py)
        self.generation_mesh = generation_mesh
        self.mode = inference_mode
        self.max_batch_size = int(max_batch_size)
        self.queue_timeout = queue_timeout
        self.generation_slots = int(generation_slots)
        self.generation_t_max = generation_t_max
        # resilience knobs: bounded pending queue + optional
        # EngineSupervisor wrapping (crash/wedge restart with exactly-once
        # request recovery); the injector threads through to the engine's
        # engine.step/engine.prefill points for chaos tests
        self.generation_max_pending = int(generation_max_pending)
        # decode-pipeline knob: K>1 fuses K decode steps per device
        # program and double-buffers the readback (models/generation.py)
        self.generation_block_size = int(generation_block_size)
        self.generation_supervised = bool(generation_supervised)
        self.generation_supervisor_timeout = float(
            generation_supervisor_timeout)
        self.generation_max_restarts = int(generation_max_restarts)
        self.generation_fault_injector = generation_fault_injector
        # observability sinks threaded to the engine: registry
        # for counters/histograms, trace store for completed request
        # timelines; tracing=False is the telemetry-off A/B baseline
        self.generation_registry = generation_registry
        self.generation_trace_store = generation_trace_store
        self.generation_tracing = bool(generation_tracing)
        self._telemetry = None
        # durable request journal: a directory turns on the
        # write-ahead log; on the first generate() after a restart the
        # facade recovers every unfinished journaled request (prompt +
        # retired tokens, original SLO clocks) before serving new work
        self.generation_journal_dir = generation_journal_dir
        self.generation_journal_fsync = str(generation_journal_fsync)
        self.generation_recover = bool(generation_recover)
        # scheduling policy tier: EDF queue order, headroom
        # shed, chunked prefill for long prompts, adaptive block size
        self.generation_scheduling = str(generation_scheduling)
        self.generation_shed_headroom = bool(generation_shed_headroom)
        self.generation_headroom_margin = float(generation_headroom_margin)
        self.generation_prefill_chunk = generation_prefill_chunk
        self.generation_adaptive_block = bool(generation_adaptive_block)
        self.generation_block_ladder = generation_block_ladder
        self.generation_block_latency_target = float(
            generation_block_latency_target)
        # paged KV cache + prefix caching
        self.generation_paged = bool(generation_paged)
        self.generation_page_size = int(generation_page_size)
        self.generation_num_pages = generation_num_pages
        self.generation_prefix_cache = bool(generation_prefix_cache)
        self._gen_journal = None
        self.last_recovery = None          # RecoveryReport of this boot
        self._lock = threading.Lock()
        self._requests: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._gen_engine = None
        self._gen_supervisor = None
        self._gen_lock = threading.Lock()
        self._shutdown = False

    class Builder:
        def __init__(self, net):
            self._net = net
            self._mesh = None
            self._mode = InferenceMode.BATCHED
            self._max_batch = 64

        def inference_mode(self, mode: str):
            self._mode = mode
            return self

        def batch_limit(self, n: int):
            self._max_batch = int(n)
            return self

        def workers(self, n: int):
            """Data-parallel over the first ``n`` CUDA devices (a clear
            error where fewer exist)."""
            self._mesh = make_mesh(int(n))
            return self

        def build(self) -> "ParallelInference":
            return ParallelInference(self._net, self._mesh, self._mode,
                                     self._max_batch)

    def _forward(self, feats: np.ndarray) -> np.ndarray:
        """One forward of the net in inference mode: the first output of a
        ComputationGraph, a MultiLayerNetwork's output; on the net's
        device, or data-parallel over the mesh."""
        if self.mesh is not None:
            return self._forward_mesh(feats)
        out = self.net.output(feats)
        if isinstance(out, (list, tuple)):
            out = out[0]
        return np.asarray(out)

    @torch.no_grad()
    def _forward_mesh(self, feats: np.ndarray) -> np.ndarray:
        """The rows padded to a multiple of the mesh's coordinates (with
        copies of the first rows, dropped after), split in contiguous
        runs, each run's forward on its coordinate's replica."""
        net = self.net
        net._ensure_init()
        devices = list(self.mesh.devices.flat)
        if self._replicas is None or self._replica_src is not net.params:
            graph = hasattr(net.conf, "network_inputs")
            # a graph's forward takes the compute-dtype copy, a
            # MultiLayerNetwork's casts its masters itself
            params = net._cast_params(net.params) if graph else net.params
            state = net._inference_state()

            def place(tree, d):
                move = lambda p: {k: a.to(d) if torch.is_tensor(a) else a
                                  for k, a in p.items()}
                return {v: move(p) for v, p in tree.items()} if graph \
                    else [move(p) for p in tree]

            self._replicas = [(place(params, d), place(state, d))
                              for d in devices]
            self._replica_src = net.params
        n = feats.shape[0]
        pad = (-n) % len(devices)
        if pad:
            feats = np.concatenate([feats, feats[:pad]], axis=0)
        per = feats.shape[0] // len(devices)
        outs = []
        for i, (d, (params, state)) in enumerate(zip(devices,
                                                     self._replicas)):
            part = feats[i * per:(i + 1) * per]
            if hasattr(net.conf, "network_inputs"):
                x = {k: t.to(d) for k, t in net._inputs_dict(part).items()}
                acts, *_ = net._forward(params, state, x)
                y = acts[net.conf.network_outputs[0]]
            else:
                y, _, _ = net._forward(params, state,
                                       net._as_tensor(part).to(d),
                                       train=False, rng=None)
            outs.append(y.float())
        # every replica's forward is queued before the first readback
        return torch.cat([y.cpu() for y in outs]).numpy()[:n]

    # --- public API (reference ParallelInference.output) ---
    def output(self, features: np.ndarray) -> np.ndarray:
        if self.mode == InferenceMode.SEQUENTIAL:
            with self._lock:
                return self._forward(np.asarray(features))
        return self._output_batched(np.asarray(features))

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._batch_loop,
                                            daemon=True)
            self._worker.start()

    def _output_batched(self, features: np.ndarray) -> np.ndarray:
        self._ensure_worker()
        done = threading.Event()
        slot = {}
        self._requests.put((features, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _batch_loop(self):
        while not self._shutdown:
            try:
                first = self._requests.get(timeout=0.25)
            except queue.Empty:
                continue
            batch = [first]
            total = first[0].shape[0]
            # coalesce whatever arrives within the window, up to the cap
            while total < self.max_batch_size:
                try:
                    nxt = self._requests.get(timeout=self.queue_timeout)
                    batch.append(nxt)
                    total += nxt[0].shape[0]
                except queue.Empty:
                    break
            feats = np.concatenate([b[0] for b in batch], axis=0)
            try:
                with self._lock:
                    out = self._forward(feats)
                offset = 0
                for f, done, slot in batch:
                    slot["result"] = out[offset:offset + f.shape[0]]
                    offset += f.shape[0]
                    done.set()
            except Exception as e:  # propagate to all waiting callers
                for _, done, slot in batch:
                    slot["error"] = e
                    done.set()

    # --- batched autoregressive generation (models/generation.py) ---
    def _ensure_gen_engine(self):
        """Lazily start the shared slot-based continuous-batching engine:
        concurrent generate() callers coalesce into ONE fixed-shape decode
        loop (the BATCHED-mode coalescing idea applied to the
        autoregressive workload); a caller finishing frees its cache slot
        mid-loop for the next queued prompt."""
        with self._gen_lock:
            if self._shutdown:
                raise RuntimeError("ParallelInference is shut down")
            if self._gen_engine is None:
                from ..models.generation import SlotGenerationEngine
                if self.generation_journal_dir and \
                        self._gen_journal is None:
                    from ..streaming.journal import RequestJournal
                    self._gen_journal = RequestJournal(
                        self.generation_journal_dir,
                        fsync=self.generation_journal_fsync,
                        registry=self.generation_registry)
                engine = SlotGenerationEngine(
                    self.net, num_slots=self.generation_slots,
                    t_max=self.generation_t_max,
                    max_pending=self.generation_max_pending,
                    fault_injector=self.generation_fault_injector,
                    block_size=self.generation_block_size,
                    registry=self.generation_registry,
                    trace_store=self.generation_trace_store,
                    tracing=self.generation_tracing,
                    journal=self._gen_journal,
                    scheduling=self.generation_scheduling,
                    shed_headroom=self.generation_shed_headroom,
                    headroom_margin=self.generation_headroom_margin,
                    prefill_chunk=self.generation_prefill_chunk,
                    adaptive_block=self.generation_adaptive_block,
                    block_ladder=self.generation_block_ladder,
                    block_latency_target=(
                        self.generation_block_latency_target),
                    paged=self.generation_paged,
                    page_size=self.generation_page_size,
                    num_pages=self.generation_num_pages,
                    prefix_cache=self.generation_prefix_cache,
                    mesh=self.generation_mesh)
                if self.generation_supervised:
                    from .failures import EngineSupervisor
                    self._gen_supervisor = EngineSupervisor(
                        engine,
                        timeout=self.generation_supervisor_timeout,
                        max_restarts=self.generation_max_restarts).start()
                else:
                    engine.start()
                self._gen_engine = engine
                if self._gen_journal is not None and \
                        self.generation_recover:
                    # resume whatever a previous incarnation left
                    # unfinished BEFORE new work is admitted — recovery
                    # bypasses admission control like a takeover
                    from ..streaming.journal import recover_from_journal
                    self.last_recovery = recover_from_journal(
                        self._gen_journal,
                        self._gen_supervisor or self._gen_engine,
                        trace_store=self.generation_trace_store,
                        tracing=self.generation_tracing)
            return self._gen_supervisor or self._gen_engine

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, eos_id=None,
                 timeout: Optional[float] = None,
                 deadline: Optional[float] = None):
        """Generate a continuation for ONE prompt (1-D int array) through
        the shared continuous-batching engine; blocks until complete and
        returns the full [prompt + generated] id array. Thread-safe —
        concurrent callers share the device batch. ``deadline`` (seconds)
        is enforced BY THE ENGINE mid-decode (the slot is freed and
        DeadlineExceeded raised); ``timeout`` only bounds this caller's
        wait."""
        engine = self._ensure_gen_engine()
        req = engine.submit(prompt_ids, max_new_tokens,
                            temperature=temperature, eos_id=eos_id,
                            deadline=deadline)
        return req.result(timeout)

    def generate_async(self, prompt_ids, max_new_tokens: int,
                       temperature: float = 0.0, eos_id=None,
                       deadline: Optional[float] = None):
        """Queue a prompt and return its GenerationRequest handle
        (``.result()`` blocks; ``.done()`` polls; ``.cancel()`` frees
        its slot at the engine's next sweep)."""
        return self._ensure_gen_engine().submit(
            prompt_ids, max_new_tokens, temperature=temperature,
            eos_id=eos_id, deadline=deadline)

    def generation_stats(self) -> Optional[dict]:
        """Engine/supervisor counters (None before the first generate)."""
        with self._gen_lock:
            target = self._gen_supervisor or self._gen_engine
            return None if target is None else target.stats()

    def start_telemetry(self, port: int = 0, host: str = "127.0.0.1",
                        audit_compiles: bool = False):
        """Start (or return) this facade's telemetry endpoint
        (``observability/telemetry.py``): ``/metrics``, ``/snapshot``
        with the generation stats as a source, ``/traces/recent`` and the
        rest, over the registry and trace store the generation engine
        publishes to; ``shutdown()`` stops it. Loopback by default (the
        endpoint is unauthenticated)."""
        if self._telemetry is None:
            from ..observability.telemetry import TelemetryServer
            self._telemetry = TelemetryServer(
                registry=self.generation_registry,
                trace_store=self.generation_trace_store,
                host=host, port=port,
                audit_compiles=audit_compiles).add_source(
                "generation", lambda: self.generation_stats() or {})
            self._telemetry.start()
        return self._telemetry

    def shutdown(self):
        self._shutdown = True
        if self._telemetry is not None:
            self._telemetry.stop()
            self._telemetry = None
        # detach under the lock, stop OUTSIDE it: stop/shutdown
        # join the serve loop, and a generate() caller blocked on
        # _gen_lock would otherwise wait out the join too. _shutdown is
        # already latched, so _ensure_gen_engine cannot resurrect one.
        with self._gen_lock:
            sup, eng = self._gen_supervisor, self._gen_engine
            self._gen_supervisor = None
            self._gen_engine = None
        if sup is not None:
            sup.stop()
        elif eng is not None:
            eng.shutdown()
        jr = self._gen_journal
        self._gen_journal = None
        if jr is not None:
            jr.close()
