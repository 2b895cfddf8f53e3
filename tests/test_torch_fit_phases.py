"""PyTorch port, the training step's phase spans on the CPU: under
``torch.profiler`` every update of ``ComputationGraph`` and
``MultiLayerNetwork`` is one ``dl4j.fit`` span holding its input,
forward, backward, update and listener phases, nested, in order and
disjoint; truncated BPTT makes one ``dl4j.fit`` a window; a data-parallel
step's update is ``dl4j.fit.update``; with no profiler a step enters no
``record_function`` and trains bitwise as under one.
``tracing.phase_times`` on synthetic Chrome traces: device work goes to
the span that launched it (from any thread), idle gaps to the span
holding their start, and the device seconds sum to the busy union;
``scripts/perf_fit_phases.py`` folds nested spans into their phase. The
roofline peaks come from the card's data-sheet row where no environment
variable sets them."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, GravesLSTM,
                                                     OutputLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.observability import (MetricsRegistry,
                                                    PhaseProfiler, devstats,
                                                    tracing)
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.optimize import CollectScoresIterationListener
from deeplearning4j_tpu_torch.parallel import (GraphDataParallelTrainer,
                                               make_mesh)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CHILDREN = ["dl4j.fit.input", "dl4j.fit.forward", "dl4j.fit.backward",
            "dl4j.fit.update", "dl4j.fit.listeners"]


def _net_conf(seed):
    return (NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.1)
            .updater("nesterovs").weight_init("xavier").activation("tanh"))


def _graph(seed=5):
    conf = (_net_conf(seed).graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=6), "in")
            .add_layer("out", OutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    net = ComputationGraph(conf, device="cpu").init()
    net.set_listeners(CollectScoresIterationListener())
    return net


def _rnn_graph(tbptt):
    conf = (_net_conf(9).graph_builder().add_inputs("in")
            .add_layer("lstm", GravesLSTM(n_out=5), "in")
            .add_layer("out", RnnOutputLayer(n_out=3, loss="mcxent",
                                             activation="softmax"), "lstm")
            .set_outputs("out").set_input_types(InputType.recurrent(4))
            .backprop_type("truncated_bptt").tbptt_fwd_length(tbptt)
            .tbptt_back_length(tbptt).build())
    return ComputationGraph(conf, device="cpu").init()


def _batch(seed, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    return DataSet(x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)])


def _profiled(run, tmp_path):
    """``run()`` under the CPU profiler; the ``dl4j.`` spans of its Chrome
    trace as (start, end, name), by start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and
                  e["name"].startswith("dl4j."))


def _inside(spans, outer):
    a, b, _ = outer
    return [s for s in spans if s is not outer and a <= s[0] and s[1] <= b]


def _assert_steps(spans, children, steps):
    fits = [s for s in spans if s[2] == "dl4j.fit"]
    assert len(fits) == steps
    for fit in fits:
        inner = _inside(spans, fit)
        assert [s[2] for s in inner] == children
        for prev, nxt in zip(inner, inner[1:]):
            assert prev[1] <= nxt[0], (prev, nxt)


def test_each_fit_batch_is_one_fit_span_with_five_phases(tmp_path):
    net = _graph()
    spans = _profiled(lambda: [net.fit_batch(_batch(i)) for i in range(3)],
                      tmp_path)
    _assert_steps(spans, CHILDREN, 3)
    assert len(spans) == 3 * 6


def test_truncated_bptt_makes_one_fit_span_a_window(tmp_path):
    net = _rnn_graph(tbptt=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 7))]
    spans = _profiled(lambda: net.fit_batch(DataSet(x, y)), tmp_path)
    _assert_steps(spans, CHILDREN[1:], 3)
    assert net.iteration == 3
    inputs = [s for s in spans if s[2] == "dl4j.fit.input"]
    assert len(inputs) == 1
    assert inputs[0][1] <= min(s[0] for s in spans if s[2] == "dl4j.fit")


def test_data_parallel_step_traces_its_update(tmp_path):
    net = _graph()
    trainer = GraphDataParallelTrainer(net, mesh=make_mesh(devices=[CPU] * 2))
    spans = _profiled(lambda: trainer.fit_batch(_batch(1)), tmp_path)
    assert [s[2] for s in spans].count("dl4j.fit.update") == 1
    assert [s[2] for s in spans].count("dl4j.fit.listeners") == 1


def test_multilayer_network_traces_in_the_same_names(tmp_path):
    conf = (_net_conf(2).list().layer(DenseLayer(n_out=6))
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    spans = _profiled(lambda: net.fit([_batch(1), _batch(2)]), tmp_path)
    _assert_steps(spans, CHILDREN, 2)


def test_no_profiler_enters_no_record_function(monkeypatch):
    entered = []
    recorded = tracing._recorded
    monkeypatch.setattr(tracing, "_recorded",
                        lambda *a: entered.append(a) or recorded(*a))
    net = _graph()
    for i in range(2):
        net.fit_batch(_batch(i))
    assert entered == []
    assert tracing.phase("fit") is tracing.phase("fit.update")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        net.fit_batch(_batch(3))
    assert [a[0] for a in entered] == ["fit"] + [c[len("dl4j."):]
                                                 for c in CHILDREN]
    assert entered[0][1] == 2


def test_profiled_steps_train_bitwise_as_unprofiled():
    plain, traced = _graph(seed=21), _graph(seed=21)
    losses = {"plain": [], "traced": []}
    for i in range(3):
        plain.fit_batch(_batch(10 + i))
        losses["plain"].append(plain.score_value.item())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(3):
            traced.fit_batch(_batch(10 + i))
            losses["traced"].append(traced.score_value.item())
    assert losses["plain"] == losses["traced"]
    assert np.array_equal(plain.params_flat(), traced.params_flat())


# -------------------------------------------------- phase_times, synthetic
def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _device(cat, name, ts, dur, corr, launched_at, tid=1):
    """A device op and the runtime call on thread ``tid`` launching it."""
    return [_x("cuda_runtime", "cudaLaunchKernel", launched_at, 1.0, tid=tid,
               correlation=corr),
            _x(cat, name, ts, dur, tid=7, correlation=corr)]


def _synthetic():
    """One step, host µs: fit [0, 100) holding input [0, 20), forward
    [20, 40), backward [40, 80) (its kernel launched from thread 2),
    update [80, 95); an op launched after the step."""
    ev = [_x("user_annotation", "dl4j.fit", 0, 100),
          _x("user_annotation", "dl4j.fit.input", 0, 20),
          _x("user_annotation", "dl4j.fit.forward", 20, 20),
          _x("user_annotation", "dl4j.fit.backward", 40, 40),
          _x("user_annotation", "dl4j.fit.update", 80, 15),
          _x("user_annotation", "portbench.fit_batch", 0, 100, tid=3)]
    ev += _device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 30,
                  1, 2)
    ev += _device("kernel", "fwd", 40, 10, 2, 25)
    ev += _device("kernel", "bwd", 50, 30, 3, 45, tid=2)
    ev += _device("kernel", "bwd_overlap", 70, 20, 4, 60, tid=2)
    ev += _device("kernel", "sgd", 100, 10, 5, 85)
    ev += _device("kernel", "late", 115, 5, 6, 101)
    return ev


def test_phase_times_files_work_under_the_span_that_launched_it():
    got = tracing.phase_times(_synthetic())
    assert got["dl4j.fit.input"]["device_s"] == pytest.approx(30e-6)
    assert got["dl4j.fit.forward"]["device_s"] == pytest.approx(10e-6)
    # launched from thread 2 while thread 1 waits inside backward; the
    # overlapping op counts only beyond the first one's end
    assert got["dl4j.fit.backward"]["device_s"] == pytest.approx(40e-6)
    assert got["dl4j.fit.backward"]["launches"] == 2
    assert got["dl4j.fit.update"]["device_s"] == pytest.approx(10e-6)
    assert got[tracing.OUTSIDE]["device_s"] == pytest.approx(5e-6)
    assert got["dl4j.fit.input"]["launches"] == 0
    assert "dl4j.fit" not in got


def test_phase_times_idle_goes_to_the_innermost_span_at_its_start():
    got = tracing.phase_times(_synthetic(), window=(0.0, 130.0))
    # gaps: [0, 5) input, [35, 40) forward, [90, 100) update; after the
    # step [110, 115) and [120, 130)
    assert got["dl4j.fit.input"]["idle_s"] == pytest.approx(5e-6)
    assert got["dl4j.fit.forward"]["idle_s"] == pytest.approx(5e-6)
    assert got["dl4j.fit.update"]["idle_s"] == pytest.approx(10e-6)
    assert got[tracing.OUTSIDE]["idle_s"] == pytest.approx(15e-6)
    ev = [e for e in _synthetic() if e["args"].get("correlation") != 5]
    ev += _device("kernel", "tail", 96, 1, 8, 86)
    got = tracing.phase_times(ev, window=(0.0, 120.0))
    # [90, 96) starts inside update, inside fit; [97, 115) starts where
    # only fit holds it, and runs on past the step
    assert got["dl4j.fit.update"]["idle_s"] == pytest.approx(6e-6)
    assert got["dl4j.fit"]["idle_s"] == pytest.approx(18e-6)
    assert got["dl4j.fit"]["device_s"] == 0.0


def test_phase_times_sum_to_the_busy_union():
    ev = _synthetic()
    got = tracing.phase_times(ev, window=(0.0, 130.0))
    ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                 if e["cat"] in tracing.DEVICE_CATS)
    busy, end = 0.0, -1.0
    for a, b in ops:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    assert sum(v["device_s"] for v in got.values()) == \
        pytest.approx(busy * 1e-6)
    assert sum(v["device_s"] + v["idle_s"] for v in got.values()) == \
        pytest.approx(130e-6)
    assert sum(v["launches"] for v in got.values()) == 5


def _nested():
    """:func:`_synthetic` with a layer's span inside forward, [25, 35),
    holding the forward kernel's launch."""
    return _synthetic() + [_x("user_annotation", "dl4j.swin.attention", 25,
                              10)]


def test_phase_times_gives_nested_spans_their_own_time():
    got = tracing.phase_times(_nested())
    assert got["dl4j.swin.attention"]["device_s"] == pytest.approx(10e-6)
    assert got["dl4j.swin.attention"]["launches"] == 1
    assert got["dl4j.fit.forward"]["device_s"] == 0.0


def _perf_fit_phases():
    spec = importlib.util.spec_from_file_location(
        "perf_fit_phases", ROOT / "scripts" / "perf_fit_phases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_times_by_training_phase_keeps_nested_time():
    plain = tracing.phase_times(_synthetic())
    got, nested = _perf_fit_phases().fold_nested(
        tracing.phase_times(_nested()), _nested())
    assert got == plain
    assert got["dl4j.fit.forward"]["device_s"] == pytest.approx(10e-6)
    assert "dl4j.swin.attention" not in got
    assert nested["dl4j.swin.attention"]["launches"] == 1
    assert _perf_fit_phases().fold_nested(plain, _synthetic()) == \
        (plain, {})


def test_phase_times_keeps_to_one_thread_of_spans():
    ev = _synthetic() + [_x("user_annotation", "dl4j.fit.update", 1, 200,
                            tid=5)]
    assert tracing.phase_times(ev) == tracing.phase_times(_synthetic())


# --------------------------------------------------------- roofline peaks
@pytest.mark.parametrize("card, env, want", [
    ("NVIDIA H100 80GB HBM3", {}, (989_000.0, 3_350.0)),
    ("NVIDIA H100 80GB HBM3", {"DL4J_TPU_PEAK_GFLOPS": "500",
                               "DL4J_TPU_PEAK_GBS": "100"}, (500.0, 100.0)),
    ("a card the table lacks", {}, (None, None)),
])
def test_phase_profiler_peaks_from_the_card(monkeypatch, card, env, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: card)
    for name in ("DL4J_TPU_PEAK_GFLOPS", "DL4J_TPU_PEAK_GBS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    prof = PhaseProfiler(MetricsRegistry())
    assert (prof.peak_gflops, prof.peak_gbs) == want
    assert devstats.device_peaks() == devstats.CARD_PEAKS.get(card)
