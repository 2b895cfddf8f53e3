"""Model-serving routes over a message broker — the JAX package's
``streaming/serving.py`` (reference dl4j-streaming
routes/DL4jServeRouteBuilder.java: a Camel route that consumes NDArrays
from a topic, runs the model and publishes outputs).

- :class:`ModelServingRoute` micro-batches: messages queued while the
  previous dispatch ran are drained, same-shape runs stacked into ONE
  forward, results split back per message, order preserved.
- :class:`GenerationServingRoute` consumes token-id prompts, generates
  through one shared slot engine (or a supervisor wrapping one) and
  publishes [prompt + generated] in submission order, with the request's
  trace spanning consume → publish."""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, Optional

import numpy as np

from ..observability.metrics import default_registry
from ..observability.tracing import interval_now
from ..parallel.faults import (Cancelled, DeadlineExceeded, NULL_INJECTOR,
                               RejectedError)
from .pubsub import MessageBroker, NDArrayPublisher, NDArraySubscriber

#: unique per-route metric label values (routes in tests reuse topics,
#: so the topic alone cannot key exact per-instance assertions)
_ROUTE_SEQ = itertools.count()

#: registry counter schema shared by both routes: attribute
#: name → help text; each route instance owns one labeled child per
#: counter and exposes the legacy attributes as read-only views
_ROUTE_COUNTERS = {
    "served": "messages served to the output topic",
    "errors": "bad payloads / dispatch failures (counted, not fatal)",
    "batches": "coalesced (>=2 message) dispatch attempts",
    "singles": "single-message dispatches (incl. fallbacks)",
    "shed": "admission-control rejections observed",
    "deadline_errors": "deadline-exceeded / cancelled requests popped",
    "publish_drops": "messages dropped after publish-retry exhaustion",
    "consume_errors": "transient consume failures skipped",
}


def _route_metrics(registry, label: str):
    reg = registry if registry is not None else default_registry()
    return {key: reg.counter(f"route_{key}_total", desc,
                             ("route",)).labels(label)
            for key, desc in _ROUTE_COUNTERS.items()}


class _RoutePublishMixin:
    """Retry-with-backoff publish shared by both routes: a transient
    broker failure is retried ``publish_retries`` times with exponential
    backoff; a persistent one DROPS the message and counts it
    (``publish_drops``) — graceful degradation, never a dead route
    thread. The ``route.publish`` injection point can force either
    path (a raise exercises retry, a drop-signal exercises shedding).

    Counters live on the metrics registry (``route_*_total{route=...}``);
    the legacy attributes (``route.publish_drops``, ...) are properties
    over the same children (installed at module bottom)."""

    def _publish_safe(self, arr: np.ndarray) -> bool:
        for attempt in range(self.publish_retries + 1):
            try:
                if self._faults.fire("route.publish"):
                    self._m["publish_drops"].inc()
                    return False          # injected drop: counted
                self.pub.publish(arr)
                return True
            except Exception:   # noqa: BLE001 — broker down ≠ route dead
                if attempt >= self.publish_retries:
                    break
                time.sleep(self.retry_backoff * (2 ** attempt))
        self._m["publish_drops"].inc()
        return False

    def _poll_safe(self, timeout: float) -> Optional[np.ndarray]:
        """Consume with the same degradation contract: a transient
        consume failure (or injected ``route.consume`` fault) is counted
        and skipped, never allowed to kill the consumer thread."""
        try:
            if self._faults.fire("route.consume"):
                # injected consume drop: swallow one message if present
                self.sub.poll(timeout=timeout)
                self._m["consume_errors"].inc()
                return None
            return self.sub.poll(timeout=timeout)
        except Exception:       # noqa: BLE001
            self._m["consume_errors"].inc()
            time.sleep(self.retry_backoff)
            return None


class ModelServingRoute(_RoutePublishMixin):
    """Consume feature arrays from ``input_topic``, publish ``net.output``
    results to ``output_topic`` — the serve-route the reference builds with
    Camel. ``start()`` spins the consumer thread; ``stop()`` drains it.
    ``max_batch``: cap on how many queued messages coalesce into one
    forward pass. ``batch_window``: max seconds to wait, after the first
    message of a batch, for more messages to coalesce (the windowed
    semantics of parallel/inference.py's BatchedInferenceObservable) — the
    latency SLA knob: 0.0 means flush immediately with whatever is already
    queued (a trickle serves singly; a burst still coalesces), >0 trades
    that much first-message latency for trickle coalescing."""

    def __init__(self, net, broker: MessageBroker,
                 input_topic: str = "dl4j-input",
                 output_topic: str = "dl4j-output",
                 max_batch: int = 32,
                 batch_window: float = 0.0,
                 publish_retries: int = 3, retry_backoff: float = 0.05,
                 fault_injector=None, registry=None):
        self.net = net
        self.broker = broker
        self.input_topic = input_topic
        self.sub = NDArraySubscriber(broker, input_topic)
        self.pub = NDArrayPublisher(broker, output_topic)
        self.max_batch = max(1, int(max_batch))
        self.batch_window = max(0.0, float(batch_window))
        self.publish_retries = int(publish_retries)
        self.retry_backoff = float(retry_backoff)
        self._faults = fault_injector if fault_injector is not None \
            else NULL_INJECTOR
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stopped = False
        # serving counters: registry children (thread-safe by
        # construction — the route thread writes, dashboards/tests read)
        self.route_id = f"serve{next(_ROUTE_SEQ)}:{input_topic}"
        self._m = _route_metrics(registry, self.route_id)

    def _drain(self, first: np.ndarray) -> List[np.ndarray]:
        arrs = [first]
        deadline = time.monotonic() + self.batch_window
        while len(arrs) < self.max_batch:
            # cap each wait so stop() is observed promptly even mid-window
            wait = min(deadline - time.monotonic(), 0.05)
            if wait > 0 and not self._stop.is_set():
                nxt = self._poll_safe(timeout=wait)
                if nxt is None:
                    continue
            else:
                nxt = self._poll_safe(timeout=None)
                if nxt is None:
                    break
            arrs.append(nxt)
        return arrs

    def _serve_batch(self, arrs: List[np.ndarray]) -> None:
        # coalesce maximal same-shape BATCHED (ndim>=2) runs so order is
        # preserved; vectors/scalars serve singly
        i = 0
        while i < len(arrs):
            j = i + 1
            while j < len(arrs) and arrs[i].ndim >= 2 and \
                    arrs[j].shape == arrs[i].shape:
                j += 1
            run = arrs[i:j]
            # count BEFORE publishing: a consumer that sees the output
            # must also see the counters (observable-order contract)
            if len(run) == 1:
                # runs only extend while ndim >= 2, so ndim<2 runs are
                # provably singletons
                self._serve_single(run[0])
            else:
                self._m["batches"].inc()   # one coalesced dispatch attempt
                try:
                    stacked = np.concatenate(
                        [a.astype(np.float32) for a in run], axis=0)
                    out = np.asarray(self.net.output(stacked))
                    splits = np.cumsum([a.shape[0] for a in run])[:-1]
                    pieces = np.split(out, splits, axis=0)
                    self._m["served"].inc(len(pieces))
                    for piece in pieces:
                        self._publish_safe(piece)
                except Exception:
                    # the COALESCED forward failed (e.g. the stacked
                    # batch is too big, or one payload is bad): retry
                    # each message singly so the blast radius is the
                    # actual bad input, not the whole run
                    for a in run:
                        self._serve_single(a)
            i = j

    def _serve_single(self, a: np.ndarray) -> None:
        self._m["singles"].inc()
        try:
            out = np.asarray(self.net.output(a.astype(np.float32)))
            self._m["served"].inc()
            self._publish_safe(out)
        except Exception:
            # a bad payload must not kill the route (Camel's route
            # error-handling role); counted per message
            self._m["errors"].inc()

    def _run(self) -> None:
        while not self._stop.is_set():
            first = self._poll_safe(timeout=0.1)
            if first is None:
                continue
            self._serve_batch(self._drain(first))

    def start(self) -> "ModelServingRoute":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stopped:                    # idempotent double-stop
            return
        self._stopped = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self.sub.close()
        self.pub.close()


class GenerationServingRoute(_RoutePublishMixin):
    """Autoregressive-generation serve route: consume int token-id prompt
    arrays from ``input_topic``, generate through a shared slot-based
    continuous-batching engine (models/generation.py), publish the full
    [prompt + generated] id arrays to ``output_topic`` in SUBMISSION
    order — the ModelServingRoute coalescing idea extended to the decode
    loop, where "coalescing" means prompts from the stream keep the
    engine's cache slots full while earlier requests are still decoding.

    ``engine`` may be a prebuilt SlotGenerationEngine, an
    EngineSupervisor wrapping one (crash/wedge restart with exactly-once
    recovery — parallel/failures.py), or None to build a plain engine
    from ``net``. Resilience: a shed request (engine admission control,
    RejectedError) or one that missed its ``deadline`` / was cancelled
    is counted (``shed`` / ``deadline_errors``) and dropped from the
    output stream instead of wedging the in-order publisher; publish
    failures retry with backoff then degrade to a counted drop
    (``publish_drops``) — the route threads never die."""

    def __init__(self, net, broker: MessageBroker,
                 input_topic: str = "dl4j-gen-input",
                 output_topic: str = "dl4j-gen-output",
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 eos_id: Optional[int] = None, num_slots: int = 8,
                 t_max: Optional[int] = None, engine=None,
                 max_inflight: int = 64, deadline: Optional[float] = None,
                 publish_retries: int = 3, retry_backoff: float = 0.05,
                 fault_injector=None, block_size: int = 1, registry=None,
                 trace_store=None, tracing: bool = True, mesh=None,
                 spec_layout=None, journal=None, scheduling: str = "fifo",
                 shed_headroom: bool = False,
                 headroom_margin: float = 1.0,
                 prefill_chunk: Optional[int] = None,
                 adaptive_block: bool = False, block_ladder=None,
                 block_latency_target: float = 0.25,
                 paged: bool = False, page_size: int = 16,
                 num_pages=None, prefix_cache: bool = True):
        self._owns_engine = engine is None
        self._faults = fault_injector if fault_injector is not None \
            else NULL_INJECTOR
        if engine is not None and mesh is not None:
            # a prebuilt engine (or supervisor) carries its own mesh:
            # ignoring mesh= here would let a caller believe decode is
            # sharded when it is not (the engine's shared-decoder guard,
            # one level up)
            inner = getattr(engine, "_engine", engine)
            if getattr(inner, "mesh", None) is not mesh:
                raise ValueError(
                    "prebuilt engine was built for a different mesh; "
                    "pass mesh= only when the route owns its engine "
                    "(give the engine/supervisor its mesh instead)")
        if engine is None:
            from ..models.generation import SlotGenerationEngine
            # block_size > 1: requests complete (and publish) at decode-
            # block boundaries; the observability sinks, the journal and
            # the mesh thread through to the route-owned engine (a
            # prebuilt engine or supervisor carries its own)
            engine = SlotGenerationEngine(
                net, num_slots=num_slots, t_max=t_max,
                fault_injector=self._faults, block_size=block_size,
                registry=registry, trace_store=trace_store,
                tracing=tracing, mesh=mesh, spec_layout=spec_layout,
                journal=journal, scheduling=scheduling,
                shed_headroom=shed_headroom,
                headroom_margin=headroom_margin,
                prefill_chunk=prefill_chunk,
                adaptive_block=adaptive_block, block_ladder=block_ladder,
                block_latency_target=block_latency_target, paged=paged,
                page_size=page_size, num_pages=num_pages,
                prefix_cache=prefix_cache)
        self.engine = engine
        self.broker = broker
        self.input_topic = input_topic
        self.sub = NDArraySubscriber(broker, input_topic)
        self.pub = NDArrayPublisher(broker, output_topic)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.deadline = None if deadline is None else float(deadline)
        self.publish_retries = int(publish_retries)
        self.retry_backoff = float(retry_backoff)
        self._stop = threading.Event()
        self._stopped = False
        self._consumer: Optional[threading.Thread] = None
        self._publisher: Optional[threading.Thread] = None
        # submission-ordered handles: deque, not list — the publisher
        # retires strictly from the head, and at fleet fan-in depths
        # (max_inflight 64+) a list's pop(0) is O(n) per publish
        self._inflight: "collections.deque" = collections.deque()
        self._inflight_lock = threading.Lock()
        self.max_inflight = max(1, int(max_inflight))
        # counters: registry children shared-safe between the consumer
        # and publisher threads; legacy attributes are property views
        self.route_id = f"gen{next(_ROUTE_SEQ)}:{input_topic}"
        self._m = _route_metrics(registry, self.route_id)

    def _consume(self) -> None:
        while not self._stop.is_set():
            with self._inflight_lock:
                full = len(self._inflight) >= self.max_inflight
            if full:
                # backpressure: stop draining the broker's BOUNDED
                # (drop-oldest) queue so overload sheds there instead of
                # growing the engine's pending deque without limit
                time.sleep(0.02)
                continue
            arr = self._poll_safe(timeout=0.1)
            if arr is None:
                continue
            t_c0 = interval_now()
            try:
                prompt = np.asarray(arr).astype(np.int64).reshape(-1)
                # route= labels the request's SLO record (attainment per
                # route in /slo); engine, supervisor, and fleet router
                # all accept it through the same submit surface
                req = self.engine.submit(prompt, self.max_new_tokens,
                                         temperature=self.temperature,
                                         eos_id=self.eos_id,
                                         deadline=self.deadline,
                                         route=self.route_id)
                # the engine opened the request's trace at submit; the
                # consume span closes over the route-side intake work
                # (message arrival → request queued)
                tr = getattr(req, "trace", None)
                if tr is not None:
                    tr.add_span("consume", t_c0, interval_now(),
                                topic=self.input_topic,
                                route=self.route_id)
                with self._inflight_lock:
                    self._inflight.append(req)
            except Exception:
                self._m["errors"].inc()      # bad payload must not kill it

    def _publish_in_order(self) -> None:
        while not self._stop.is_set():
            with self._inflight_lock:
                req = self._inflight[0] if self._inflight else None
            if req is None:
                time.sleep(0.02)
                continue
            try:
                out = req.result(timeout=0.2)
            except (DeadlineExceeded, Cancelled):
                # ordered BEFORE TimeoutError: DeadlineExceeded IS a
                # TimeoutError, but means the REQUEST is finished (shed
                # mid-decode) — pop it, or the publisher spins forever
                self._m["deadline_errors"].inc()
                out = None
            except RejectedError:
                self._m["shed"].inc()        # engine shed it at intake
                out = None
            except TimeoutError:
                continue                     # still decoding: wait more
            except Exception:
                self._m["errors"].inc()
                out = None
            with self._inflight_lock:
                self._inflight.popleft()
            if out is not None:
                t_p0 = interval_now()
                if self._publish_safe(np.asarray(out, np.int32)):
                    self._m["served"].inc()
                    # close the request's timeline: its trace is already
                    # in the ring (finished at completion); the publish
                    # span lands on the same object, so /traces/recent
                    # shows consume→publish coverage
                    tr = getattr(req, "trace", None)
                    if tr is not None:
                        tr.add_span("publish", t_p0, interval_now(),
                                    route=self.route_id)

    def start(self) -> "GenerationServingRoute":
        self.engine.start()
        self._consumer = threading.Thread(target=self._consume, daemon=True)
        self._publisher = threading.Thread(target=self._publish_in_order,
                                           daemon=True)
        self._consumer.start()
        self._publisher.start()
        return self

    def stop(self) -> None:
        if self._stopped:                    # idempotent: a double-stop
            return                           # must not re-join dead
        self._stopped = True                 # threads or re-close topics
        self._stop.set()
        for t in (self._consumer, self._publisher):
            if t is not None:
                t.join(timeout=2)
        if self._owns_engine:                # an injected engine is shared;
            self.engine.shutdown()           # its owner stops it
        self.sub.close()
        self.pub.close()


# Legacy counter attributes (``route.served``, ``route.publish_drops``,
# ...) as read-only properties over the registry children — the existing
# tests and dashboards keep their API while the registry owns the counts.
for _counter_name in _ROUTE_COUNTERS:
    for _route_cls in (ModelServingRoute, GenerationServingRoute):
        setattr(_route_cls, _counter_name,
                property(lambda self, _k=_counter_name:
                         int(self._m[_k].value),
                         doc=f"registry view: route_{_counter_name}_total"
                             f"{{route=<id>}}"))
del _counter_name, _route_cls
