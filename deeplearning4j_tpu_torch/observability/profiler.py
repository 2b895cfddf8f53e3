"""Hot-loop phase profiler: pipeline phase/bubble accounting + roofline
attainment for the decode serving path — the JAX package's
``observability/profiler.py``, copied. Everything is timed on the host
with the interval clock, as there; no device profiler runs in the loop.

- **Phase decomposition** — the engine stamps interval-clock times at
  the natural seams of each decode-block retire cycle (dispatch →
  ``device_fetch`` returns → host bookkeeping done → journal append done
  → completion publishes done) and :meth:`EngineChannel.record_block`
  turns them into a telescoping decomposition: ``device`` (dispatch →
  data ready), ``host``, ``journal``, ``publish``. The four phases sum
  EXACTLY to the block's wall time (t_publish − t_dispatch) by
  construction. Batched/paged admission and chunked-prefill windows get
  the same treatment (``kind="admission"`` / ``"chunk"``).

- **Pipeline bubble** — ``max(0, t_dispatch − t_last_device_done)``:
  the gap between the previous device completion (block retire, prefill
  readback, chunk dispatch) and the next dispatch, i.e. time the device
  certainly sat idle waiting on the host. The double-buffered block
  pipeline (block t+1 is dispatched BEFORE block t's readback) drives it
  toward zero. ``bubble_pct = bubble / (bubble + device)``.

- **Lane bubble** — idle cache slots × block device time while work was
  QUEUED, over total slot-time: the continuous-batching waste measure.

- **Roofline attainment** — joins :mod:`.devstats`' per-program analytic
  flops/bytes with the MEASURED steady block durations: attained
  GFLOP/s, GB/s, arithmetic intensity, and a memory-/compute-bound
  verdict per program. Peaks come from constructor args, else
  ``DL4J_TPU_PEAK_GFLOPS`` / ``DL4J_TPU_PEAK_GBS`` (the JAX package's
  variable names), else the card's data-sheet row
  (``devstats.device_peaks``); without them the verdict falls back to
  comparing arithmetic intensity against an assumed ridge point.

- **PhaseTimeline** — a bounded ring of per-block phase records (newest
  last). The ring lives on the PROFILER, not the engine, so it survives a
  supervisor engine rebuild (the supervisor passes the profiler through,
  like the SLO tracker).

Overhead: host-side interval-clock stamps plus O(#phases) histogram
observes per BLOCK (not per token); the ring is bounded; nothing here
touches the device.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import deque
from typing import Dict, List, Optional

from .devstats import device_peaks
from .metrics import MetricsRegistry, default_registry

#: phase names of the telescoping per-block decomposition (these sum to
#: the block's wall time); ``bubble`` rides alongside, not inside
PHASES = ("device", "host", "journal", "publish")

#: assumed roofline ridge point (flops/byte) when no hardware peaks are
#: configured: below it a kernel is called memory-bound. ~8 flops/byte
#: is a conservative accelerator-class ridge (an H100's bf16 ~295, a
#: desktop CPU ~5-10) — configure real peaks for a real verdict.
DEFAULT_RIDGE_FLOPS_PER_BYTE = 8.0

#: fine-grained phase buckets (seconds): decode phases live in the
#: 10µs..1s decade; the registry default ladder starts at 100µs
PHASE_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                 10.0, 30.0)


class PhaseTimeline:
    """Fixed-capacity ring of per-block phase records (newest last).
    Memory is O(capacity) forever; ``total_added`` counts everything
    ever recorded, so a ring that survived an engine rebuild shows
    continuity even after old entries rotate out."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._added = 0

    def add(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)
            self._added += 1

    def recent(self, n: Optional[int] = None) -> List[dict]:
        """Last ``n`` entries (all when None; empty for n <= 0 — a
        zero-entry round must read back zero entries, not the whole
        ring, and a negative query is a caller bug, not a slice)."""
        with self._lock:
            items = list(self._ring)
        if n is None:
            return items
        n = int(n)
        return items[-n:] if n > 0 else []

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_added(self) -> int:
        with self._lock:
            return self._added


class EngineChannel:
    """One engine's phase account inside a :class:`PhaseProfiler`.

    Keyed by the engine's STABLE ``slo_label`` (not the per-instance
    engine id), so a supervisor-rebuilt engine continues the same
    channel — phase history, bubble anchors, and per-impl steady
    durations all survive the takeover, like the SLO clocks do.

    All ``record_*`` methods are called from the engine's serve/readback
    thread with host interval-clock stamps; ``summary()`` may race them
    from the telemetry thread, hence the lock. Nothing here dispatches
    device work."""

    def __init__(self, profiler: "PhaseProfiler", name: str,
                 num_slots: int):
        self._profiler = profiler
        self.name = str(name)
        self.num_slots = int(num_slots)
        self._lock = threading.Lock()
        # bubble anchor: interval-clock time of the last KNOWN device
        # completion (block retire / prefill readback / chunk dispatch)
        self._last_done: Optional[float] = None
        # last block retire per impl, for steady pipelined spacing
        self._last_retire: Dict[str, float] = {}
        # plain accumulators (summary() reads these; the registry
        # histograms carry the same observations for /metrics)
        self._phase_s = {p: 0.0 for p in PHASES}
        self._bubble_s = 0.0
        self._blocks = 0
        self._admissions = 0
        self._chunks = 0
        # lane occupancy: slot-seconds busy vs idle-while-work-queued,
        # integrated over block device spans
        self._lane_busy_s = 0.0
        self._lane_idle_queued_s = 0.0
        self._lane_total_s = 0.0
        # per-impl measured steady durations:
        # impl -> [n, total_s, min_s, steps_per_dispatch]
        self._impl: Dict[str, List[float]] = {}
        # speculative-decode account: verify blocks, token
        # outcomes, and the draft/verify/rewind sub-phase sums
        self._spec = {"blocks": 0, "accepted": 0, "drafted": 0,
                      "draft_s": 0.0, "verify_s": 0.0, "rewind_s": 0.0}
        self._decoders: List[weakref.ref] = []
        reg = profiler.registry
        self._h_phase = {
            p: reg.histogram(
                "profiler_phase_seconds",
                "decode-cycle phase decomposition (device/host/journal/"
                "publish sum to block wall time; bubble = device idle "
                "gap before dispatch; draft/verify/rewind ride "
                "alongside, attributing speculative blocks)",
                ("engine", "phase"),
                buckets=PHASE_BUCKETS).labels(self.name, p)
            for p in PHASES + ("bubble", "draft", "verify", "rewind")}
        m_blocks = reg.counter(
            "profiler_records_total", "phase-profiled cycles, by kind",
            ("engine", "kind"))
        self._m_kind = {kind: m_blocks.labels(self.name, kind)
                        for kind in ("block", "admission", "chunk",
                                     "spec")}

    def attach_decoder(self, decoder) -> None:
        """Weakly remember a decoder whose ``_cost_seam`` the roofline
        join reads at snapshot time (never from the hot path)."""
        with self._lock:
            if all(w() is not decoder for w in self._decoders):
                self._decoders.append(weakref.ref(decoder))

    # ---------------------------------------------------------- recording
    def record_block(self, *, impl: str, k: int, lanes: int, queued: int,
                     t_dispatch: float, t_fetched: float, t_host: float,
                     t_journal: float, t_publish: float) -> None:
        """One retired decode block. The five stamps are interval-clock
        times at the retire cycle's seams; phases telescope so they sum
        to ``t_publish - t_dispatch`` exactly."""
        phases = {"device": t_fetched - t_dispatch,
                  "host": t_host - t_fetched,
                  "journal": t_journal - t_host,
                  "publish": t_publish - t_journal}
        with self._lock:
            bubble = 0.0 if self._last_done is None else \
                max(0.0, t_dispatch - self._last_done)
            self._last_done = t_fetched
            for p, v in phases.items():
                self._phase_s[p] += v
            self._bubble_s += bubble
            self._blocks += 1
            # lane occupancy over this block's device span: idle lanes
            # only count as waste while there was queued work they
            # could have served (continuous batching's whole claim)
            span = max(0.0, phases["device"])
            lanes = min(int(lanes), self.num_slots)
            self._lane_total_s += self.num_slots * span
            self._lane_busy_s += lanes * span
            if queued > 0:
                self._lane_idle_queued_s += (self.num_slots - lanes) * span
            # steady duration for the roofline: in pipelined steady
            # state (zero bubble) consecutive retirements are spaced by
            # the true per-block device time, which the dispatch→ready
            # delta OVERSTATES (it spans the overlapped host work);
            # serialized blocks use the direct delta
            last = self._last_retire.get(impl)
            if bubble == 0.0 and last is not None and \
                    0.0 < t_fetched - last < phases["device"]:
                steady = t_fetched - last
            else:
                steady = max(phases["device"], 1e-9)
            self._last_retire[impl] = t_fetched
            ent = self._impl.get(impl)
            if ent is None:
                # the FIRST observation of an impl absorbs its first-use
                # costs (kernel builds, allocator growth) — mark it seen but keep it out of
                # the steady aggregate (n stays 0 until the 2nd block)
                self._impl[impl] = [0, 0.0, steady, max(1, int(k))]
            else:
                ent[0] += 1
                ent[1] += steady
                ent[2] = min(ent[2], steady)
        for p, v in phases.items():
            self._h_phase[p].observe(max(0.0, v))
        self._h_phase["bubble"].observe(bubble)
        self._m_kind["block"].inc()
        # raw floats on purpose: rounding 6 values per block is real
        # cost on the readback thread; JSON renders them fine
        self._profiler.timeline.add({
            "engine": self.name, "kind": "block", "impl": impl,
            "k": k, "lanes": lanes, "queued": queued,
            "t": t_dispatch, "bubble_ms": bubble * 1e3,
            "phases_ms": {p: v * 1e3 for p, v in phases.items()},
        })

    def record_spec(self, *, impl: str, k: int, lanes: int, queued: int,
                    accepted: int, drafted: int, t_draft: float,
                    t_dispatch: float, t_fetched: float, t_rewind: float,
                    t_host: float, t_journal: float,
                    t_publish: float) -> None:
        """One retired speculative verify block. The generic
        telescoping account is unchanged — device/host/journal/publish
        still sum to ``t_publish - t_dispatch`` exactly, so every
        consumer of the classic decomposition reads spec blocks like any
        other block. The spec-specific attribution rides alongside
        (like ``bubble``): ``draft`` is the host-side drafting span
        BEFORE dispatch (``t_dispatch - t_draft``), ``verify`` the
        device span of the fused K+1-position forward, ``rewind`` the
        page-table/position rollback sub-span of host (``t_rewind -
        t_fetched``). Drafting is real work, not device idle: the
        bubble anchor compares against ``t_draft``."""
        phases = {"device": t_fetched - t_dispatch,
                  "host": t_host - t_fetched,
                  "journal": t_journal - t_host,
                  "publish": t_publish - t_journal}
        draft_s = max(0.0, t_dispatch - t_draft)
        rewind_s = max(0.0, t_rewind - t_fetched)
        with self._lock:
            bubble = 0.0 if self._last_done is None else \
                max(0.0, t_draft - self._last_done)
            self._last_done = t_fetched
            for p, v in phases.items():
                self._phase_s[p] += v
            self._bubble_s += bubble
            self._blocks += 1
            self._spec["blocks"] += 1
            self._spec["accepted"] += int(accepted)
            self._spec["drafted"] += int(drafted)
            self._spec["draft_s"] += draft_s
            self._spec["verify_s"] += max(0.0, phases["device"])
            self._spec["rewind_s"] += rewind_s
            span = max(0.0, phases["device"])
            lanes = min(int(lanes), self.num_slots)
            self._lane_total_s += self.num_slots * span
            self._lane_busy_s += lanes * span
            if queued > 0:
                self._lane_idle_queued_s += (self.num_slots - lanes) * span
            # the spec path never pipelines (the drafter needs the
            # retired suffix), so the dispatch→ready delta IS the steady
            # device duration — no retire-spacing correction needed
            steady = max(span, 1e-9)
            self._last_retire[impl] = t_fetched
            ent = self._impl.get(impl)
            if ent is None:
                # first observation absorbs first-use costs —
                # excluded from the steady aggregate like record_block
                self._impl[impl] = [0, 0.0, steady, max(1, int(k) + 1)]
            else:
                ent[0] += 1
                ent[1] += steady
                ent[2] = min(ent[2], steady)
        for p, v in phases.items():
            self._h_phase[p].observe(max(0.0, v))
        self._h_phase["bubble"].observe(bubble)
        self._h_phase["draft"].observe(draft_s)
        self._h_phase["verify"].observe(max(0.0, phases["device"]))
        self._h_phase["rewind"].observe(rewind_s)
        self._m_kind["spec"].inc()
        self._profiler.timeline.add({
            "engine": self.name, "kind": "spec", "impl": impl,
            "k": k, "lanes": lanes, "queued": queued,
            "accepted": int(accepted), "drafted": int(drafted),
            "t": t_dispatch, "bubble_ms": bubble * 1e3,
            "draft_ms": draft_s * 1e3, "rewind_ms": rewind_s * 1e3,
            "phases_ms": {p: v * 1e3 for p, v in phases.items()},
        })

    def record_admission(self, *, impl: str, count: int,
                         t_dispatch: float, t_fetched: float,
                         t_host: float, t_journal: float,
                         t_publish: float) -> None:
        """One batched admission wave (slab or paged): same telescoping
        decomposition; the prefill readback becomes the new bubble
        anchor (prefill IS device work — a decode block dispatched
        right after it shows only the host gap as bubble)."""
        phases = {"device": t_fetched - t_dispatch,
                  "host": t_host - t_fetched,
                  "journal": t_journal - t_host,
                  "publish": t_publish - t_journal}
        with self._lock:
            bubble = 0.0 if self._last_done is None else \
                max(0.0, t_dispatch - self._last_done)
            self._last_done = t_fetched
            for p, v in phases.items():
                self._phase_s[p] += v
            self._bubble_s += bubble
            self._admissions += 1
            ent = self._impl.get(impl)
            d = max(phases["device"], 1e-9)
            if ent is None:
                # same warmup exclusion as record_block: the first
                # admission wave pays the prefill compile
                self._impl[impl] = [0, 0.0, d, 1]
            else:
                ent[0] += 1
                ent[1] += d
                ent[2] = min(ent[2], d)
        for p, v in phases.items():
            self._h_phase[p].observe(max(0.0, v))
        self._h_phase["bubble"].observe(bubble)
        self._m_kind["admission"].inc()
        self._profiler.timeline.add({
            "engine": self.name, "kind": "admission", "impl": impl,
            "count": count, "t": t_dispatch,
            "bubble_ms": bubble * 1e3,
            "phases_ms": {p: v * 1e3 for p, v in phases.items()},
        })

    def record_chunk(self, *, t_dispatch: float, t_done: float,
                     final: bool) -> None:
        """One chunked-prefill window. Non-final windows never sync
        (t_done is dispatch-return), so only the device phase is
        attributed; the window still moves the bubble anchor — the
        device is busy with it either way."""
        d = t_done - t_dispatch
        with self._lock:
            bubble = 0.0 if self._last_done is None else \
                max(0.0, t_dispatch - self._last_done)
            self._last_done = t_done
            self._phase_s["device"] += d
            self._bubble_s += bubble
            self._chunks += 1
        self._h_phase["device"].observe(max(0.0, d))
        self._h_phase["bubble"].observe(bubble)
        self._m_kind["chunk"].inc()
        self._profiler.timeline.add({
            "engine": self.name, "kind": "chunk", "final": bool(final),
            "t": t_dispatch, "bubble_ms": bubble * 1e3,
            "phases_ms": {"device": d * 1e3},
        })

    # ------------------------------------------------------------- views
    def summary(self) -> dict:
        with self._lock:
            phase_s = dict(self._phase_s)
            bubble_s = self._bubble_s
            blocks, adm, chunks = self._blocks, self._admissions, \
                self._chunks
            lane_busy = self._lane_busy_s
            lane_idle_q = self._lane_idle_queued_s
            lane_total = self._lane_total_s
            impl = {k: list(v) for k, v in self._impl.items()}
            spec = dict(self._spec)
        device_s = phase_s["device"]
        total_s = sum(phase_s.values())
        out = {
            "blocks": blocks,
            "admissions": adm,
            "chunks": chunks,
            "phase_seconds": {p: round(v, 6) for p, v in phase_s.items()},
            "phase_pct": {p: round(100.0 * v / total_s, 2)
                          for p, v in phase_s.items()} if total_s else {},
            "bubble_seconds": round(bubble_s, 6),
            "bubble_pct": round(100.0 * bubble_s / (bubble_s + device_s),
                                2) if bubble_s + device_s > 0 else 0.0,
            "lane_bubble_pct": round(100.0 * lane_idle_q / lane_total, 2)
            if lane_total > 0 else 0.0,
            "lane_busy_pct": round(100.0 * lane_busy / lane_total, 2)
            if lane_total > 0 else 0.0,
            "impl_measured": {
                name: {"n": int(n),
                       "mean_s": round(tot / n if n else mn, 6),
                       "min_s": round(mn, 6),
                       "steps_per_dispatch": int(k)}
                for name, (n, tot, mn, k) in sorted(impl.items())},
        }
        if spec["blocks"]:
            # speculative-decode headline: acceptance rate is
            # THE observable — the fleet scrape's spec-acc column
            out["spec"] = {
                "blocks": spec["blocks"],
                "accepted": spec["accepted"],
                "drafted": spec["drafted"],
                "acceptance_rate": round(
                    spec["accepted"] / spec["drafted"], 4)
                if spec["drafted"] else 0.0,
                "draft_seconds": round(spec["draft_s"], 6),
                "verify_seconds": round(spec["verify_s"], 6),
                "rewind_seconds": round(spec["rewind_s"], 6),
            }
        return out

    def _measured_impls(self) -> Dict[str, List[float]]:
        with self._lock:
            return {k: list(v) for k, v in self._impl.items()}

    def _live_decoders(self) -> List:
        with self._lock:
            return [d for d in (w() for w in self._decoders)
                    if d is not None]


def _env_peak(name: str) -> Optional[float]:
    """Best-effort hardware-peak env parse: an empty/garbage value
    degrades to the no-peaks verdict path — it must never crash engine
    construction (every engine touches the default profiler)."""
    try:
        v = float(os.environ.get(name, "") or 0.0)
    except ValueError:
        return None
    return v if v > 0 else None


class PhaseProfiler:
    """Process-wide phase/bubble/roofline account over N engines.

    Engines call :meth:`channel` once at construction (keyed by their
    stable ``slo_label``); the telemetry server serves
    :meth:`snapshot` at ``GET /profile`` and embeds :meth:`summary`
    into ``/snapshot`` for the fleet scrape. Default-plus-injectable
    like every other observability sink."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 timeline_capacity: int = 256,
                 peak_gflops: Optional[float] = None,
                 peak_gbs: Optional[float] = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.timeline = PhaseTimeline(timeline_capacity)
        card = device_peaks() or (None, None)
        self.peak_gflops = peak_gflops if peak_gflops is not None else \
            _env_peak("DL4J_TPU_PEAK_GFLOPS") or card[0]
        self.peak_gbs = peak_gbs if peak_gbs is not None else \
            _env_peak("DL4J_TPU_PEAK_GBS") or card[1]
        self._lock = threading.Lock()
        self._channels: Dict[str, EngineChannel] = {}

    def channel(self, name: str, num_slots: int = 0,
                decoder=None) -> EngineChannel:
        """Get-or-create the channel for one engine label. Idempotent:
        a supervisor-rebuilt engine re-enters ITS channel (same
        ``slo_label``) and keeps accumulating — the timeline ring and
        phase history survive the rebuild."""
        with self._lock:
            ch = self._channels.get(str(name))
            if ch is None:
                ch = EngineChannel(self, str(name), num_slots)
                self._channels[str(name)] = ch
            elif num_slots:
                ch.num_slots = int(num_slots)
        if decoder is not None:
            ch.attach_decoder(decoder)
        return ch

    def channels(self) -> Dict[str, EngineChannel]:
        with self._lock:
            return dict(self._channels)

    # ----------------------------------------------------------- roofline
    def roofline(self) -> Dict[str, dict]:
        """Measured-vs-theoretical table per serving program: attained
        GFLOP/s and GB/s from the measured steady block duration joined
        with the analytic cost, arithmetic intensity, and the bound
        verdict. Costs are memoized on the decoder's cost seam."""
        from .devstats import impl_cost_analysis
        costs: Dict[str, dict] = {}
        measured: Dict[str, List[float]] = {}
        for ch in self.channels().values():
            for dec in ch._live_decoders():
                try:
                    costs.update(impl_cost_analysis(dec))
                except Exception:   # noqa: BLE001 — degrade per decoder
                    pass
            for impl, (n, tot, mn, k) in ch._measured_impls().items():
                ent = measured.get(impl)
                if ent is None:
                    measured[impl] = [n, tot, mn, k]
                else:
                    ent[0] += n
                    ent[1] += tot
                    ent[2] = min(ent[2], mn)
                    ent[3] = max(ent[3], k)
        out: Dict[str, dict] = {}
        for impl, (n, tot, mn, k) in sorted(measured.items()):
            # n counts post-warmup blocks (the compile-laden first
            # dispatch is excluded); with only the warmup seen, fall
            # back to its duration and say so
            mean_s = tot / n if n else mn
            row = {"n": int(n), "measured_mean_s": round(mean_s, 6),
                   "measured_min_s": round(mn, 6),
                   "steps_per_dispatch": int(k)}
            if not n:
                row["warmup_only"] = True
            cost = costs.get(impl)
            if not cost or "flops" not in cost:
                row["cost"] = cost or {
                    "error": "no cost_analysis for this impl"}
                out[impl] = row
                continue
            # the cost table counts one step of a decode_block{K}
            # program, while a dispatch runs K steps — join on the
            # per-step duration so K=1/4/8 rows are comparable and the
            # attained numbers are per executed step
            step_s = mean_s / max(1, k)
            step_min = mn / max(1, k)
            flops = float(cost["flops"])
            nbytes = float(cost.get("bytes_accessed", 0.0))
            row["measured_step_s"] = round(step_s, 6)
            row["flops"] = int(flops)
            row["bytes_accessed"] = int(nbytes)
            row["attained_gflops"] = round(flops / step_s / 1e9, 3)
            # best-case (min duration) attainment rides along: the mean
            # absorbs scheduler noise the device never saw
            row["attained_gflops_best"] = round(flops / step_min / 1e9, 3)
            if nbytes > 0:
                row["attained_gbs"] = round(nbytes / step_s / 1e9, 3)
                intensity = flops / nbytes
                row["intensity_flops_per_byte"] = round(intensity, 3)
                if self.peak_gflops and self.peak_gbs:
                    f_frac = (flops / step_s / 1e9) / self.peak_gflops
                    b_frac = (nbytes / step_s / 1e9) / self.peak_gbs
                    row["flops_attainment"] = round(f_frac, 4)
                    row["bandwidth_attainment"] = round(b_frac, 4)
                    row["bound"] = "memory_bound" if b_frac >= f_frac \
                        else "compute_bound"
                else:
                    row["ridge_assumed"] = DEFAULT_RIDGE_FLOPS_PER_BYTE
                    row["bound"] = "memory_bound" if intensity < \
                        DEFAULT_RIDGE_FLOPS_PER_BYTE else "compute_bound"
            out[impl] = row
        return out

    # -------------------------------------------------------------- views
    def summary(self) -> dict:
        """The lightweight per-engine summary ``/snapshot`` embeds (no
        cost lowering): phase/bubble/lane accounting plus a headline
        the fleet scrape's bubble-% column reads."""
        engines = {name: ch.summary()
                   for name, ch in sorted(self.channels().items())}
        headline = {}
        if engines:
            dev = sum(e["phase_seconds"]["device"]
                      for e in engines.values())
            bub = sum(e["bubble_seconds"] for e in engines.values())
            headline = {
                "blocks": sum(e["blocks"] for e in engines.values()),
                "bubble_pct": round(100.0 * bub / (bub + dev), 2)
                if bub + dev > 0 else 0.0,
            }
        return {"engines": engines, "headline": headline,
                "timeline": {"len": len(self.timeline),
                             "total_recorded":
                                 self.timeline.total_added}}

    def snapshot(self, timeline_n: Optional[int] = None) -> dict:
        """The full ``GET /profile`` document: per-engine phase
        decomposition + bubble accounting, the roofline join (attained
        vs theoretical per serving program), and optionally the last
        N timeline entries."""
        out = self.summary()
        try:
            out["roofline"] = self.roofline()
        except Exception as e:   # noqa: BLE001 — degrade, never 500
            out["roofline"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        if self.peak_gflops or self.peak_gbs:
            out["peaks"] = {"gflops": self.peak_gflops,
                            "gbs": self.peak_gbs}
        if timeline_n:
            out["timeline"]["recent"] = self.timeline.recent(timeline_n)
        return out


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: Optional[PhaseProfiler] = None


def default_profiler() -> PhaseProfiler:
    """Process-default profiler (bound to the default registry) every
    engine falls back to when none is injected — the same
    default-plus-injectable discipline as the registry, trace ring, and
    SLO tracker."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = PhaseProfiler()
        return _DEFAULT
