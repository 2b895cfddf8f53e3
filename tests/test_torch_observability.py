"""PyTorch port: the serving tier's observability against the JAX package,
on the CPU. The metrics registry (the same operations give equal
snapshots and byte-equal Prometheus exposition), percentiles against
numpy, SLO attainment and burn against the numpy oracle of the JAX tests,
flight-recorder post-mortem round trips in the JAX layout, and on a tiny
LM (2 slots): one finished trace per request with the JAX engine's span
names in its order, trace continuity across a supervisor takeover,
tracing off recording nothing, ``stats()`` as a view over the registry,
exact KV-cache bytes on the slab and the pool, the phase profiler's
telescoping phases, and the analytic program costs; the telemetry
endpoint (the same endpoints, statuses, content types, top-level JSON keys
and 404 listing as JAX's) and ``ParallelInference.start_telemetry``."""

import json

import numpy as np
import pytest

from deeplearning4j_tpu.models import (SlotGenerationEngine as JaxEngine,
                                       transformer_lm_conf as jax_lm_conf)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.observability import flightrec as jflightrec
from deeplearning4j_tpu.observability import metrics as jmetrics
from deeplearning4j_tpu.observability import slo as jslo
from deeplearning4j_tpu.observability import tracing as jtracing
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.observability import (
    FlightRecorder, Histogram, MetricsRegistry, PhaseProfiler, SLOTracker,
    TraceRing, device_memory_snapshot, impl_cost_analysis, interval_now,
    kv_cache_stats, percentiles)
from deeplearning4j_tpu_torch.observability import clock, tracing
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.parallel import EngineSupervisor, FaultInjector
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, port net on the CPU) on the same parameters, every
    weight matrix scaled by 4 so greedy tokens depend on the context."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    jnet.params = {v: {k: a * 4 if a.ndim == 2 else a for k, a in p.items()}
                   for v, p in jnet.params.items()}
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, net


def _prompts(seed, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(2, 6)))
            for _ in range(n)]


def _sinks(mod_metrics, mod_tracing, mod_flightrec, mod_slo):
    reg = mod_metrics.MetricsRegistry()
    return dict(registry=reg, trace_store=mod_tracing.TraceRing(),
                flight_recorder=mod_flightrec.FlightRecorder(registry=reg),
                slo=mod_slo.SLOTracker(registry=reg))


# ----------------------------------------------------------------- metrics
def _drive(mod):
    """One fixed sequence of registry operations."""
    reg = mod.MetricsRegistry()
    c = reg.counter("served_total", "requests served", ("route",))
    c.labels("r0").inc()
    c.labels("r1").inc(3)
    c.labels(route='we"ird\\n').inc(2)
    reg.counter("plain_total", "no labels").inc(5)
    g = reg.gauge("depth", "queue depth", ("engine",))
    g.labels("e0").set(4)
    g.labels("e1").inc(2.5)
    g.labels("e1").dec(1)
    g.labels("e2").set_function(lambda: 7)
    h = reg.histogram("lat_seconds", "latency", ("k",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.01, 0.1):
        h.labels("a").observe(v)
    h.labels("b").observe_many([0.2, 0.3])
    exact = reg.histogram("exact_seconds", "retained", sample_limit=None)
    exact.observe_many([3.0, 1.0, 2.0])
    return reg


def test_metrics_registry_matches_jax():
    got, want = _drive(jmetrics_port()), _drive(jmetrics)
    assert got.snapshot() == want.snapshot()
    assert got.render_prometheus().encode() == \
        want.render_prometheus().encode()


def jmetrics_port():
    from deeplearning4j_tpu_torch.observability import metrics
    return metrics


@pytest.mark.parametrize("seed", [0, 1])
def test_percentiles_match_numpy(seed):
    vals = np.random.default_rng(seed).exponential(size=257)
    qs = (1, 25, 50, 90, 99, 99.9)
    got = percentiles(vals, qs)
    for q in qs:
        assert got[f"p{q:g}"] == pytest.approx(float(np.percentile(vals, q)),
                                               abs=1e-12)
    h = Histogram("x_seconds", sample_limit=None)
    h.observe_many(vals)
    for q in qs:
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(vals, q)), abs=1e-12)
    assert got == jmetrics.percentiles(vals, qs)


def test_slo_attainment_and_burn_match_numpy_oracle():
    """The JAX tests' oracle: attainment = met / counted over the window
    (cancelled excluded), burn = (1 - attainment) / (1 - target); the
    port's tracker and JAX's agree on every window and snapshot."""
    rng = np.random.default_rng(3)
    trk = SLOTracker(registry=MetricsRegistry(), name="oracle",
                     target=0.95, capacity=2048)
    jtrk = jslo.SLOTracker(registry=jmetrics.MetricsRegistry(),
                           name="oracle", target=0.95, capacity=2048)
    times = np.sort(rng.uniform(0.0, 100.0, 600))
    status = rng.choice(["ok", "deadline", "cancelled", "shed"], 600,
                        p=[0.7, 0.15, 0.05, 0.1])
    headroom = rng.uniform(-2.0, 5.0, 600)
    for t, st, hr in zip(times, status, headroom):
        for tr in (trk, jtrk):
            tr.record(st, headroom=abs(hr) if st == "ok" else -abs(hr),
                      latency=0.1, queue_wait=0.01, now=float(t))
    now = 100.0
    for window in (10.0, 37.5, 80.0, None):
        counted = status != "cancelled"
        if window is not None:
            counted &= times >= now - window
        met = counted & (status == "ok")
        want = 1.0 if not counted.sum() else met.sum() / counted.sum()
        assert trk.attainment(window, now=now) == pytest.approx(want,
                                                                abs=1e-12)
        assert trk.burn_rate(window, now=now) == pytest.approx(
            (1.0 - want) / (1.0 - 0.95), abs=1e-9)
    assert trk.snapshot(now=now) == jtrk.snapshot(now=now)


def test_flight_recorder_postmortem_round_trip(tmp_path):
    """A post-mortem written by the port reads back with the JAX
    recorder's document layout for the same events and traces."""
    docs = []
    for mod, tmod, mmod, sub in ((jflightrec, jtracing, jmetrics, "jax"),
                                 (None, tracing, None, "port")):
        fr = FlightRecorder(registry=MetricsRegistry()) if mod is None \
            else mod.FlightRecorder(registry=mmod.MetricsRegistry())
        fr.record("admission", engine="e0", batch=2)
        fr.record("fault", point="engine.step", hit=3, mode="raise")
        tr = tmod.Trace(request_id="req-1")
        tr.add_span("prefill", 0.0, 0.5, batch=2)
        tr.finish("ok")
        path = fr.write_postmortem(str(tmp_path / sub), "sup",
                                   reason="takeover", traces=[tr],
                                   registry=(MetricsRegistry() if mod is None
                                             else mmod.MetricsRegistry()),
                                   extra={"recovered_request_ids":
                                          ["req-1"]})
        with open(path, encoding="utf-8") as f:
            docs.append(json.load(f))
        assert fr.dumps == [path]
    jdoc, doc = docs
    assert sorted(doc) == sorted(jdoc)
    assert [e["kind"] for e in doc["events"]] == \
        [e["kind"] for e in jdoc["events"]]
    assert doc["request_ids"] == jdoc["request_ids"] == ["req-1"]
    strip = lambda spans: [{k: v for k, v in sp.items()
                            if k not in ("t0", "t1")} for sp in spans]
    assert strip(doc["traces"][0]["spans"]) == \
        strip(jdoc["traces"][0]["spans"])
    assert doc["extra"] == jdoc["extra"]


def test_tracing_reexports_the_one_clock():
    assert tracing.interval_now is clock.interval_now is interval_now


# ------------------------------------------------------- the engine's hooks
def _run_both(nets, prompts, k=4, **eng_kw):
    jnet, net = nets
    jsinks = _sinks(jmetrics, jtracing, jflightrec, jslo)
    sinks = dict(registry=MetricsRegistry(), trace_store=TraceRing(),
                 flight_recorder=FlightRecorder(registry=MetricsRegistry()),
                 slo=SLOTracker(registry=MetricsRegistry()))
    jeng = JaxEngine(jnet, num_slots=2, block_size=k, **jsinks, **eng_kw)
    eng = SlotGenerationEngine(net, num_slots=2, block_size=k, **sinks,
                               **eng_kw)
    jreqs = [jeng.submit(p, 7) for p in prompts]
    reqs = [eng.submit(p, 7) for p in prompts]
    jeng.run_until_drained()
    eng.run_until_drained()
    return jeng, jreqs, eng, reqs, sinks


@pytest.mark.parametrize("k", [1, 4])
def test_one_trace_per_request_with_jax_span_names(nets, k):
    prompts = _prompts(0)
    jeng, jreqs, eng, reqs, sinks = _run_both(nets, prompts, k=k)
    for r, jr in zip(reqs, jreqs):
        np.testing.assert_array_equal(r.result(0), jr.result(0))
        assert r.trace is not None and r.trace.finished
        assert r.trace.span_names() == jr.trace.span_names()
    ring = sinks["trace_store"].recent()
    assert sorted(t.trace_id for t in ring) == \
        sorted(r.trace.trace_id for r in reqs)
    slo = sinks["slo"].snapshot()
    assert slo["requests"] == len(prompts) and slo["missed"] == 0


def test_stats_is_a_view_over_the_registry(nets):
    _, _, eng, reqs, sinks = _run_both(nets, _prompts(1))
    st = eng.stats()
    snap = sinks["registry"].snapshot()
    for key in ("emitted_tokens", "completed", "decode_blocks",
                "host_readbacks", "prefills"):
        fam = snap[f"generation_{key}_total"]["values"]
        assert fam[f"engine={eng.engine_id}"] == st[key] == \
            getattr(eng, key), key
    assert st["completed"] == len(reqs)
    assert st["emitted_tokens"] == sum(len(r.generated) for r in reqs)
    with pytest.raises(AttributeError):
        eng.completed = 0                       # a read-only view


def test_hooks_add_no_readback(nets):
    """At most one engine.decode readback per decode block, every hook
    on (a block still in flight when the engine drains is never read)."""
    _, net = nets
    eng = SlotGenerationEngine(net, num_slots=2, block_size=4,
                               registry=MetricsRegistry(),
                               trace_store=TraceRing(),
                               flight_recorder=FlightRecorder(),
                               slo=SLOTracker(registry=MetricsRegistry()),
                               profiler=PhaseProfiler(MetricsRegistry()))
    before = fetch_counts("engine.decode")["engine.decode"]
    for p in _prompts(2):
        eng.submit(p, 9)
    eng.run_until_drained()
    reads = fetch_counts("engine.decode")["engine.decode"] - before
    assert 0 < reads <= eng.stats()["decode_blocks"]


def test_tracing_off_records_nothing(nets):
    _, net = nets
    ring, fr = TraceRing(), FlightRecorder()
    prof = PhaseProfiler(MetricsRegistry())
    eng = SlotGenerationEngine(net, num_slots=2, block_size=4,
                               registry=MetricsRegistry(), trace_store=ring,
                               tracing=False, flight_recorder=fr,
                               profiler=prof)
    reqs = [eng.submit(p, 6) for p in _prompts(3)]
    eng.run_until_drained()
    assert all(r.trace is None for r in reqs)
    assert len(ring) == 0 and len(fr) == 0
    assert prof.timeline.total_added == 0 and not prof.channels()
    assert eng.stats()["completed"] == len(reqs)


def test_trace_continuity_across_a_takeover(nets, tmp_path):
    """A crash under the supervisor: every request keeps ONE trace, the
    recovered ones with a takeover span, and the post-mortem's trace ids
    are exactly the recovered requests'."""
    _, net = nets
    dec = TransformerDecoder(net)
    prompts = _prompts(4, 6)
    clean = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                                 tracing=False)
    want = [clean.submit(p, 8) for p in prompts]
    clean.run_until_drained()
    fr = FlightRecorder(registry=MetricsRegistry())
    inj = FaultInjector(registry=MetricsRegistry(), flight_recorder=fr)
    inj.raise_once("engine.step", RuntimeError("boom"), at=3)
    ring = TraceRing()
    eng = SlotGenerationEngine(net, num_slots=2, decoder=dec,
                               fault_injector=inj, trace_store=ring,
                               flight_recorder=fr,
                               registry=MetricsRegistry())
    sup = EngineSupervisor(eng, timeout=5.0, interval=0.05,
                           postmortem_dir=str(tmp_path)).start()
    reqs = [sup.submit(p, 8) for p in prompts]
    outs = [r.result(60) for r in reqs]
    sup.stop()
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w.result(0))
    ids = [r.trace.trace_id for r in reqs]
    assert len(set(ids)) == len(reqs)
    assert sorted(t.trace_id for t in ring.recent()) == sorted(ids)
    recovered = [r for r in reqs if "takeover" in r.trace.span_names()]
    assert recovered and sup.stats()["restarts"] == 1
    (path,) = fr.dumps
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    assert sorted(doc["request_ids"]) == \
        sorted(doc["extra"]["recovered_request_ids"]) == \
        sorted(r.trace.request_id for r in recovered)
    assert "fault" in {e["kind"] for e in doc["events"]}


def test_profiler_phases_telescope(nets):
    _, net = nets
    prof = PhaseProfiler(MetricsRegistry())
    eng = SlotGenerationEngine(net, num_slots=2, block_size=4,
                               registry=MetricsRegistry(),
                               trace_store=TraceRing(),
                               flight_recorder=FlightRecorder(),
                               profiler=prof, slo_label="replica-a")
    for p in _prompts(5):
        eng.submit(p, 9)
    eng.run_until_drained()
    summ = prof.channels()["replica-a"].summary()
    # every retired block, i.e. all but one dispatched after the last
    # lane finished (its tokens are overshoot and never read)
    assert summ["blocks"] in (eng.stats()["decode_blocks"] - 1,
                              eng.stats()["decode_blocks"])
    for e in prof.timeline.recent():
        assert all(v >= 0 for v in e["phases_ms"].values())
        assert e["bubble_ms"] >= 0
    roof = prof.roofline()
    assert "decode_block4" in roof and "prefill_slots" in roof
    assert roof["decode_block4"]["flops"] > 0


# ----------------------------------------------------------------- devstats
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "pool"])
def test_kv_cache_stats_exact(nets, paged):
    _, net = nets
    kw = dict(paged=True, page_size=8, num_pages=9) if paged else {}
    eng = SlotGenerationEngine(net, num_slots=2, **kw)
    layers, heads, dh = 2, 2, 16
    cells = 9 * 8 if paged else 2 * KW["max_length"]
    want = layers * 2 * heads * cells * dh * 4
    st = kv_cache_stats(eng)
    assert st["bytes"] == st["addressable_bytes"] == want
    assert st["layers"] == layers and st["dtype"] == "float32"
    assert st["slot_shape"] == ([9, heads, 8, dh] if paged else
                                [2, heads, KW["max_length"], dh])
    assert st["bytes_per_slot"] == want // st["slot_shape"][0]
    assert ("pages" in st) == paged
    if paged:
        assert st["pages"]["free"] == 8


def test_device_memory_snapshot_degrades_on_cpu():
    snap = device_memory_snapshot()
    assert snap["devices"] and snap["live_arrays"]["count"] > 0
    if snap["devices"][0]["platform"] == "cpu":
        assert snap["devices"][0]["memory_stats"] is None


def test_impl_cost_analysis_is_analytic(nets):
    _, net = nets
    eng = SlotGenerationEngine(net, num_slots=2, block_size=4)
    eng.submit(np.arange(5) % VOCAB, 6)
    eng.run_until_drained()
    costs = impl_cost_analysis(eng.decoder)
    weights = sum(p.numel() for v, ps in net.params.items()
                  for p in ps.values() if p.dim() >= 2) - \
        sum(p.numel() for p in net.params["embed"].values()
            if p.dim() >= 2) if "embed" in net.params else None
    step = costs["decode_block4"]
    hd = 2 * 16
    attn = 2 * 2 * 2 * 1 * KW["max_length"] * hd * 2    # 2 layers, q·k, p·v
    assert step["flops"] > attn
    if weights is not None:
        assert step["flops"] == 2 * 2 * weights + attn
    assert costs["prefill_slots"]["flops"] > step["flops"]


# ------------------------------------------------------------- telemetry
def _scrape(url):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


ENDPOINTS = ("/metrics", "/snapshot", "/slo", "/profile", "/traces/recent",
             "/traces/recent?n=2&status=done", "/healthz", "/profile?timeline=3",
             "/no/such/endpoint")


def _telemetry_docs(mods, engine_cls, net):
    """Serve 4 requests on a fresh set of sinks, then scrape every
    endpoint of a TelemetryServer over them: {path: (status, content
    type, body)}."""
    metrics, tracing_mod, flightrec, slo, profiler, telemetry = mods
    reg = metrics.MetricsRegistry()
    ring = tracing_mod.TraceRing()
    tracker = slo.SLOTracker(registry=reg)
    rec = flightrec.FlightRecorder(registry=reg)
    prof = profiler.PhaseProfiler(reg)
    eng = engine_cls(net, num_slots=2, registry=reg, trace_store=ring,
                     slo=tracker, flight_recorder=rec, profiler=prof)
    for p in _prompts(3, 4):
        eng.submit(p, 3)
    eng.run_until_drained()
    srv = telemetry.TelemetryServer(
        registry=reg, trace_store=ring, slo_tracker=tracker,
        flight_recorder=rec, profiler=prof).add_source(
        "generation", eng.stats).start()
    try:
        return {ep: _scrape(srv.url + ep) for ep in ENDPOINTS}
    finally:
        srv.stop()


def test_telemetry_endpoints_match_jax(nets):
    """The same endpoint set answers in both packages with the same status,
    content type and top-level JSON keys, and the same 404 listing; the
    Prometheus text carries the engine's families."""
    from deeplearning4j_tpu.observability import profiler as jprofiler
    from deeplearning4j_tpu.observability import telemetry as jtelemetry
    from deeplearning4j_tpu_torch.observability import (flightrec, metrics,
                                                        profiler, slo,
                                                        telemetry)
    jnet, net = nets
    want = _telemetry_docs((jmetrics, jtracing, jflightrec, jslo, jprofiler,
                            jtelemetry), JaxEngine, jnet)
    got = _telemetry_docs((metrics, tracing, flightrec, slo, profiler,
                           telemetry), SlotGenerationEngine, net)
    for ep in ENDPOINTS:
        (gs, gt, gb), (ws, wt, wb) = got[ep], want[ep]
        assert (gs, gt) == (ws, wt), ep
        if ep == "/metrics":
            assert gs == 200
            for fam in ("generation_completed_total",
                        "generation_queue_depth", "slo_requests_total"):
                assert fam in gb.decode() and fam in wb.decode(), fam
            continue
        g, w = json.loads(gb), json.loads(wb)
        assert set(g) == set(w), (ep, sorted(set(g) ^ set(w)))
        if ep == "/no/such/endpoint":
            assert gs == 404 and g == w
        elif ep.startswith("/traces"):
            assert g["count"] == w["count"]
    snap = json.loads(got["/snapshot"][2])
    assert snap["sources"]["generation"]["completed"] == 4
    assert snap["transfers"] == {}


def test_parallel_inference_start_telemetry(nets):
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    _, net = nets
    pi = ParallelInference(net, generation_slots=2,
                           generation_registry=MetricsRegistry(),
                           generation_trace_store=TraceRing())
    try:
        out = pi.generate(np.array([3, 5]), 4, timeout=30)
        srv = pi.start_telemetry(port=0)
        assert pi.start_telemetry() is srv
        status, _, body = _scrape(srv.url + "/snapshot")
        doc = json.loads(body)
        assert status == 200 and len(out) == 6
        assert doc["sources"]["generation"]["completed"] == 1
        status, _, body = _scrape(srv.url + "/traces/recent")
        assert json.loads(body)["count"] == 1
    finally:
        pi.shutdown()
    assert pi._telemetry is None
