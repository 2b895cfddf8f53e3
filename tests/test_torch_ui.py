"""The port's training UI (``deeplearning4j_tpu_torch/ui``) against the
JAX package's on the CPU: the listeners' records on one net with the same
weights fitted on the same batches (timestamps, rates, memory and timings
aside), the readbacks the stats listener makes, the storages, the
component and report HTML and the PNG encoder byte for byte, the web
server's every route against JAX's server over one storage, the remote
push, the t-SNE upload and the profiler trace.

Tolerances: the listeners' floats (score, magnitudes, histogram edges,
activation statistics) at 1e-5 relative: the two nets' f32 steps sum in
other orders."""

import base64
import json
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.cluster.stats import \
    ClusterTrainingStats as JaxClusterStats
from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.layers import ConvolutionLayer as JaxConv
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
import deeplearning4j_tpu.ui as jui
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import png as jpng
from deeplearning4j_tpu.ui import report as jreport
from deeplearning4j_tpu_torch.cluster.stats import ClusterTrainingStats
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph.graph_config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
import deeplearning4j_tpu_torch.ui as pui
from deeplearning4j_tpu_torch.ui import components as pcomp
from deeplearning4j_tpu_torch.ui import png as ppng
from deeplearning4j_tpu_torch.ui import report as preport
from deeplearning4j_tpu_torch.utils import graph_from_numpy, \
    network_from_numpy

RTOL = 1e-5
#: keys whose values are wall-clock readings, not results
CLOCK = {"timestamp", "iterations_per_sec", "max_rss_mb",
         "layer_timings_ms", "grid_b64"}
STEPS = 6


def _conv_pair():
    """Conv(4, 3x3 same) → Dense(8) → softmax(2) on 8x8x1, both packages,
    the JAX net's weights in the port's (CPU, f32)."""
    jconf = (JaxNNC.Builder().seed(3).learning_rate(0.05).updater("sgd")
             .weight_init("xavier").activation("relu").list()
             .layer(JaxConv(n_out=4, kernel_size=[3, 3],
                            convolution_mode="same"))
             .layer(JaxDense(n_out=8))
             .layer(JaxOut(n_out=2, loss="mcxent", activation="softmax"))
             .set_input_type(JaxInputType.convolutional(8, 8, 1)).build())
    jnet = JaxNet(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    arrays = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    return jnet, network_from_numpy(conf, arrays, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(8, 8, 8, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    return X, y


def _listeners(ui, storage, sample):
    return (ui.StatsListener(storage, session_id="tabs",
                             histograms_frequency=2),
            ui.HistogramIterationListener(storage, frequency=1),
            ui.FlowIterationListener(storage, frequency=1,
                                     timing_frequency=2),
            ui.ConvolutionalIterationListener(storage, sample, frequency=2))


@pytest.fixture(scope="module")
def fitted():
    """Both nets fitted STEPS batches with every listener attached:
    (JAX storage, port storage, port net, the port's ui.stats readbacks)."""
    jnet, pnet = _conv_pair()
    X, y = _batch()
    js, ps = jui.InMemoryStatsStorage(), pui.InMemoryStatsStorage()
    jnet.set_listeners(*_listeners(jui, js, X[:1]))
    pnet.set_listeners(*_listeners(pui, ps, X[:1]))
    jnet.fit([JaxDataSet(X, y)] * STEPS)
    before = fetch_counts().get("ui.stats", 0)
    pnet.fit([DataSet(X, y)] * STEPS)
    reads = fetch_counts()["ui.stats"] - before
    return js, ps, pnet, reads


def _same(got, want, path=""):
    """Equal structure and values, floats at RTOL, clock keys skipped."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k not in CLOCK:
                _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=RTOL), path
    else:
        assert got == want, path


@pytest.mark.parametrize("kind", ["update", "histogram", "flow",
                                  "convolutional"])
def test_listener_records_match_jax(fitted, kind):
    js, ps, _, _ = fitted
    sessions = {"update": "tabs", "histogram": "histogram", "flow": "flow",
                "convolutional": "conv"}
    want = [r for r in js.get_updates(sessions[kind]) if r["type"] == kind]
    got = [r for r in ps.get_updates(sessions[kind]) if r["type"] == kind]
    assert len(want) == {"update": STEPS, "histogram": STEPS, "flow": STEPS,
                         "convolutional": STEPS // 2}[kind]
    _same(got, want)
    if kind == "flow":
        assert all(len(r["layer_timings_ms"]) == 3 for r in got)
    if kind == "convolutional":
        for g, w in zip(got, want):
            for gl, wl in zip(g["layers"], w["layers"]):
                a, b = (np.frombuffer(base64.b64decode(x["grid_b64"]),
                                      np.uint8).astype(int)
                        for x in (gl, wl))
                assert np.abs(a - b).max() <= 1     # uint8 rounding


@pytest.mark.parametrize("session", ["tabs", "flow"])
def test_static_info_matches_jax(fitted, session):
    js, ps, _, _ = fitted
    _same(ps.get_static_info(session), js.get_static_info(session))


def test_stats_listener_readbacks(fitted):
    """One readback a reported step (the score), one more on a histogram
    step (the parameter table in one copy)."""
    *_, reads = fitted
    assert reads == STEPS + STEPS // 2


def test_flow_timing_on_a_graph():
    b = (JaxNNC.Builder().seed(1).learning_rate(0.1).updater("sgd")
         .weight_init("xavier").graph_builder().add_inputs("in")
         .add_layer("d", JaxDense(n_out=5, activation="tanh"), "in")
         .add_layer("out", JaxOut(n_out=3, loss="mcxent",
                                  activation="softmax"), "d")
         .set_outputs("out").set_input_types(JaxInputType.feed_forward(4)))
    jg = JaxGraph(b.build()).init()
    conf = ComputationGraphConfiguration.from_json(jg.conf.to_json())
    pg = graph_from_numpy(conf, {v: {k: np.asarray(a) for k, a in
                                     p.items()} for v, p in jg.params.items()},
                          device="cpu")
    rng = np.random.default_rng(2)
    X = rng.normal(size=(6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    js, ps = jui.InMemoryStatsStorage(), pui.InMemoryStatsStorage()
    jg.set_listeners(jui.FlowIterationListener(js, timing_frequency=1))
    pg.set_listeners(pui.FlowIterationListener(ps, timing_frequency=1))
    jg.fit([JaxDataSet(X, y)] * 2)
    pg.fit([DataSet(X, y)] * 2)
    _same(ps.get_updates("flow"), js.get_updates("flow"))
    _same(ps.get_static_info("flow"), js.get_static_info("flow"))
    assert [len(r["layer_timings_ms"]) for r in ps.get_updates("flow")] == \
        [len(conf.topological_order)] * 2
    assert pui.FlowIterationListener._time_layers(
        type("Bare", (), {"params": None})()) is None


@pytest.mark.parametrize("kind", ["memory", "file", "sqlite"])
def test_storages_round_trip(fitted, tmp_path, kind):
    """The port's records through each backend read back as written, and
    JAX's backend of the same kind reads the port's file (the sessions
    whose static record, if any, is an ``init`` one: the file backend
    files any other static record with the updates, as JAX's does)."""
    _, ps, _, _ = fitted
    sessions = ["conv", "histogram", "tabs"]
    make = {"memory": lambda ui: ui.InMemoryStatsStorage(),
            "file": lambda ui: ui.FileStatsStorage(tmp_path / "s.jsonl"),
            "sqlite": lambda ui: ui.SqliteStatsStorage(tmp_path / "s.db")}
    store = make[kind](pui)
    for session in sessions:
        if ps.get_static_info(session):
            store.put_static_info(ps.get_static_info(session))
        for r in ps.get_updates(session):
            store.put_update(r)
    readers = [store] + ([make[kind](jui)] if kind != "memory" else [])
    for reader in readers:
        assert reader.list_sessions() == sessions
        for session in sessions:
            assert reader.get_static_info(session) == \
                json.loads(json.dumps(ps.get_static_info(session)))
            got = reader.get_updates(session)
            want = json.loads(json.dumps(ps.get_updates(session)))
            if kind == "sqlite":         # ordered by iteration
                want = sorted(want, key=lambda r: r.get("iteration", 0))
            assert got == want


def _tree(m):
    return m.ComponentDiv([
        m.ComponentText("hello <b>"),
        m.ChartLine("scores").add_series("a", [0, 1, 2], [3.0, 2.0, 1.0])
        .add_series("b", [0, 1, 2], [1.0, 2.0, 3.0]),
        m.ChartScatter("pts").add_series("s", [0.0, 0.5], [1.0, 0.2]),
        m.ChartHistogram("w").add_bin(-1, 0, 5).add_bin(0, 1, 9),
        m.ChartStackedArea("mem")
        .add_series("heap", [0, 1, 2], [1.0, 1.5, 1.2])
        .add_series("offheap", [0, 1, 2], [0.5, 0.4, 0.6]),
        m.ChartTimeline("phases").add_lane("fit", [(0.0, 1.5, "fit")]),
        m.ComponentTable(["k", "v"], [["score", 0.5], ["iter", 10]]),
    ], style=m.Style(width=400, height=200))


def test_components_byte_equal():
    got, want = _tree(pcomp), _tree(jcomp)
    assert got.to_json() == want.to_json()
    assert got.render() == want.render()
    assert pcomp.render_page(got) == jcomp.render_page(want)
    blob = want.to_json()
    assert pcomp.component_from_json(blob).to_json() == blob


def test_reports_byte_equal(fitted, tmp_path):
    js, ps, _, _ = fitted
    # one storage through both renderers
    assert preport.export_stats_html(ps, tmp_path / "p.html", "tabs")
    jreport.export_stats_html(ps, tmp_path / "j.html", "tabs")
    assert (tmp_path / "p.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()
    events = [{"phase": "fit", "start": 100.0, "duration_ms": 7.5}]
    stats, jstats = ClusterTrainingStats(), JaxClusterStats()
    for s in (stats, jstats):
        s.add_worker_events(events)
    preport.export_cluster_stats_html(stats, tmp_path / "pc.html")
    jreport.export_cluster_stats_html(jstats, tmp_path / "jc.html")
    assert (tmp_path / "pc.html").read_bytes() == \
        (tmp_path / "jc.html").read_bytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64])
def test_png_byte_equal(dtype):
    rng = np.random.default_rng(4)
    img = (rng.random((7, 13)) * 255).astype(dtype)
    assert ppng.encode_gray_png(img) == jpng.encode_gray_png(img)
    act = rng.normal(size=(70, 20, 5)).astype(np.float32)
    np.testing.assert_array_equal(ppng.activation_grid(act, 3, 16),
                                  jpng.activation_grid(act, 3, 16))
    np.testing.assert_array_equal(ppng.to_uint8(act[..., 0]),
                                  jpng.to_uint8(act[..., 0]))


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(base, path, payload):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


ROUTES = ["/", "/train", "/train/overview", "/train/sessions",
          "/train/updates?session=tabs", "/train/info?session=tabs",
          "/train/histograms?session=tabs", "/train/model?session=tabs",
          "/train/system?session=tabs", "/train/flow?session=flow",
          "/train/activations", "/train/activations?session=conv",
          "/train/activations.png?layer=0", "/train/chart.js",
          "/train/sessions.js", "/train/model.html", "/train/system.html",
          "/train/histograms.html", "/train/flow.html",
          "/train/activations.html", "/tsne", "/tsne/coords"]


def test_server_routes_match_jax(fitted):
    """Each GET route of the port's server returns the bytes JAX's server
    returns over the same storage; a remote push lands in it."""
    _, ps, _, _ = fitted
    port = pui.UIServer(port=0, device="cpu").attach(ps)
    jax_srv = jui.UIServer(port=0).attach(ps)
    try:
        pb = f"http://127.0.0.1:{port.port}"
        jb = f"http://127.0.0.1:{jax_srv.port}"
        for route in ROUTES:
            assert _get(pb, route) == _get(jb, route), route
        assert json.loads(_get(pb, "/train/updates?session=tabs")[2]) and \
            len(json.loads(_get(pb, "/train/updates?session=tabs")[2])) == \
            STEPS
        router = pui.RemoteStatsRouter(pb)
        router.put_static_info({"session": "remote", "type": "init",
                                "timestamp": 1.0})
        router.put_update({"session": "remote", "type": "update",
                           "iteration": 1, "score": 0.5})
        assert "remote" in json.loads(_get(pb, "/train/sessions")[2])
        assert json.loads(_get(pb, "/train/updates?session=remote")[2]) == \
            [{"iteration": 1, "score": 0.5, "iterations_per_sec": None,
              "epoch": None, "timestamp": None, "max_rss_mb": None}]
    finally:
        port.stop()
        jax_srv.stop()


def test_tsne_upload_on_the_port():
    srv = pui.UIServer(port=0, device="cpu").attach(
        pui.InMemoryStatsStorage())
    base = f"http://127.0.0.1:{srv.port}"
    try:
        r = _post(base, "/tsne/upload", {"labels": ["a", "b"],
                                         "coords": [[0, 0], [1, 1]]})
        assert r == {"ok": True, "count": 2}
        rng = np.random.default_rng(0)
        vecs = np.concatenate([rng.normal(0, 0.05, (6, 8)),
                               rng.normal(3, 0.05, (6, 8))]).tolist()
        r = _post(base, "/tsne/upload", {"labels": [f"w{i}" for i in
                                                    range(12)],
                                         "vectors": vecs})
        assert r == {"ok": True, "count": 12}
        got = json.loads(_get(base, "/tsne/coords")[2])
        Y = np.asarray(got["coords"])
        assert Y.shape == (12, 2) and np.isfinite(Y).all()
        assert got["labels"] == [f"w{i}" for i in range(12)]
    finally:
        srv.stop()


def test_singleton_and_profiler_trace(fitted, tmp_path):
    _, _, pnet, _ = fitted
    ui = pui.UIServer.get_instance(port=0, device="cpu")
    assert pui.UIServer.get_instance() is ui
    ui.stop()
    assert pui.UIServer.get_instance(port=0) is not ui
    pui.UIServer._instance = None
    X, _ = _batch(1)
    with pui.profiler_trace(str(tmp_path / "trace")) as prof:
        pnet.output(X)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any("conv" in str(n) for n in names), sorted(names)[:20]
    assert prof is not None
    timer = pui.SparkStyntheticPhaseTimer()
    timer.start("fit")
    timer.end("fit")
    timer.export_html(tmp_path / "t.html")
    assert "<td>fit</td>" in (tmp_path / "t.html").read_text()
