"""PyTorch port, the ComputationGraph's remaining API on the CPU, each
against the JAX graph with the same weights on the same seeded inputs:
truncated BPTT (parameters after every window, the iteration count, a
masked batch, and a truncated-BPTT configuration with no 3-D input that
trains whole), ``rnn_time_step`` / ``rnn_clear_previous_state`` (the cases
of ``tests/test_graph_rnn_state.py``), MultiDataSet training, a two-output
graph's ``evaluate_outputs``, ``evaluate*`` on the first head, listeners,
``summary``, ``clone`` and ``params_flat`` / ``set_params_flat``.

Tolerances: f32 parity at 1e-5 (ROADMAP rule 1); evaluation counts
exact."""

import numpy as np
import pytest

from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.conf.layers import GravesLSTM as JaxGravesLSTM
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer as JaxRnnOut
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.optimize.listeners import \
    CollectScoresIterationListener as JaxCollect
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.ops.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu_torch.nn.graph.graph_config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.optimize import (
    CollectScoresIterationListener, IterationListener)
from deeplearning4j_tpu_torch.ops.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.utils import graph_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _port(jg):
    """The JAX graph's configuration and weights as a CPU port graph."""
    conf = ComputationGraphConfiguration.from_json(jg.conf.to_json())
    return graph_from_numpy(conf, {v: {k: np.asarray(a) for k, a in
                                       p.items()}
                                   for v, p in jg.params.items()},
                            device="cpu")


def _rnn_pair(seed=3, tbptt=None, updater="sgd", lr=0.1):
    """GravesLSTM(8) → RnnOutputLayer(4) on 4 inputs, both packages."""
    b = (JaxNNC.Builder().seed(seed).learning_rate(lr).updater(updater)
         .weight_init("xavier").graph_builder().add_inputs("in")
         .add_layer("lstm", JaxGravesLSTM(n_out=8, activation="tanh"), "in")
         .add_layer("out", JaxRnnOut(n_out=4, loss="mcxent",
                                     activation="softmax"), "lstm")
         .set_outputs("out").set_input_types(JaxInputType.recurrent(4)))
    if tbptt:
        b = b.backprop_type("truncated_bptt").tbptt_fwd_length(tbptt) \
            .tbptt_back_length(tbptt)
    jg = JaxGraph(b.build()).init()
    return jg, _port(jg)


def _seq(n, t, seed, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 4)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (n, t))]
    mask = None
    if masked:
        mask = np.ones((n, t), np.float32)
        mask[0, 5:] = 0.0
        mask[1, 3:] = 0.0
    return x, y, mask


class _Snapshots(IterationListener):
    """params_flat after every update (works on either package)."""

    def __init__(self):
        self.flat = []

    def iteration_done(self, model, iteration):
        self.flat.append((iteration, model.params_flat()))


# ------------------------------------------------------------------ TBPTT
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_tbptt_matches_jax_window_by_window(masked):
    """T 20 in windows of 5 (masked: T 8 in windows of 4, two rows cut
    short): one update a window, the parameters after each window and the
    final score equal to the JAX graph's."""
    t, window = (8, 4) if masked else (20, 5)
    jg, g = _rnn_pair(tbptt=window)
    x, y, mask = _seq(3, t, 7, masked)
    js, ps = _Snapshots(), _Snapshots()
    jg.set_listeners(js)
    g.set_listeners(ps)
    jg.fit_batch(JaxDataSet(x, y, mask, None if mask is None
                            else mask.copy()))
    g.fit_batch(DataSet(x, y, mask, None if mask is None else mask.copy()))
    assert g.iteration == jg.iteration == t // window
    assert [i for i, _ in ps.flat] == [i for i, _ in js.flat] == \
        list(range(1, t // window + 1))
    for (_, a), (_, b) in zip(ps.flat, js.flat):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(float(g.score_value), float(jg.score_value),
                               **TOL)
    assert all(k not in st for st in g.state.values() for k in ("h", "c"))


def test_tbptt_trains_like_the_reference_graph_test():
    """test_graph_rnn_state.py's TBPTT case on the port (adam, lr 0.05):
    4 iterations a batch, the score falls over 11 batches."""
    jg, g = _rnn_pair(tbptt=5, updater="adam", lr=0.05)
    x, y, _ = _seq(4, 20, 1)
    ds = DataSet(x, y)
    s0 = g.score(ds)
    g.fit_batch(ds)
    assert g.iteration == 4
    for _ in range(10):
        g.fit_batch(ds)
    assert g.score(ds) < s0


def test_tbptt_configuration_without_a_sequence_trains_whole():
    """A truncated-BPTT configuration whose inputs are all 2-D trains as a
    plain step (the JAX graph's condition), matching its update."""
    b = (JaxNNC.Builder().seed(4).learning_rate(0.1).updater("sgd")
         .weight_init("xavier").graph_builder().add_inputs("in")
         .add_layer("d", JaxDense(n_out=5, activation="tanh"), "in")
         .add_layer("out", JaxOut(n_out=3, loss="mcxent",
                                  activation="softmax"), "d")
         .set_outputs("out").set_input_types(JaxInputType.feed_forward(4))
         .backprop_type("truncated_bptt").tbptt_fwd_length(3))
    jg = JaxGraph(b.build()).init()
    g = _port(jg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    jg.fit_batch(JaxDataSet(x, y))
    g.fit_batch(DataSet(x, y))
    assert g.iteration == jg.iteration == 1
    np.testing.assert_allclose(g.params_flat(), jg.params_flat(), **TOL)


# ---------------------------------------------------------- rnn_time_step
def test_rnn_time_step_streams_like_the_full_forward():
    """One step at a time, and T 4 then T 3 chunks, reproduce the full
    forward; each step equals the JAX graph's rnn_time_step; clearing
    restarts from zeros; one readback an output a call."""
    jg, g = _rnn_pair(seed=11)
    x, _, _ = _seq(3, 7, 5)
    full = g.output(x)[0]
    np.testing.assert_allclose(full, np.asarray(jg.output(x)[0]), **TOL)
    before = fetch_counts("graph.rnn_time_step")["graph.rnn_time_step"]
    steps = []
    for t in range(7):
        got = g.rnn_time_step(x[:, t])[0]
        np.testing.assert_allclose(got, np.asarray(
            jg.rnn_time_step(x[:, t])[0]), **TOL)
        steps.append(got)
    assert fetch_counts("graph.rnn_time_step")["graph.rnn_time_step"] - \
        before == 7
    np.testing.assert_allclose(np.stack(steps, 1), full, **TOL)
    g.rnn_clear_previous_state()
    a = g.rnn_time_step(x[:, :4])[0]
    b = g.rnn_time_step(x[:, 4:])[0]
    np.testing.assert_allclose(np.concatenate([a, b], 1), full, **TOL)
    g.rnn_clear_previous_state()
    np.testing.assert_allclose(g.rnn_time_step(x[:, 0])[0], steps[0],
                               rtol=1e-6, atol=0)


def test_rnn_time_step_samples_a_character_stream():
    """The serving loop: feed each argmax back as the next one-hot
    input; the same characters as the JAX graph."""
    jg, g = _rnn_pair(seed=5)
    seqs = []
    for net in (jg, g):
        x = np.eye(4, dtype=np.float32)[[0]]
        seq = [0]
        for _ in range(10):
            nxt = int(np.argmax(np.asarray(net.rnn_time_step(x)[0])[0]))
            seq.append(nxt)
            x = np.eye(4, dtype=np.float32)[[nxt]]
        seqs.append(seq)
    assert seqs[0] == seqs[1] and len(seqs[1]) == 11


# ------------------------------------------- multi-input / multi-output
def _two_head_pair(seed=6):
    """Two inputs (4 and 3 features), a dense layer each, added, into two
    heads: a 3-class softmax and a 2-unit regression."""
    from deeplearning4j_tpu.nn.graph import ElementWiseVertex
    b = (JaxNNC.Builder().seed(seed).learning_rate(0.1).updater("sgd")
         .weight_init("xavier").graph_builder().add_inputs("a", "b")
         .add_layer("da", JaxDense(n_out=5, activation="tanh"), "a")
         .add_layer("db", JaxDense(n_out=5, activation="tanh"), "b")
         .add_vertex("m", ElementWiseVertex(op="add"), "da", "db")
         .add_layer("cls", JaxOut(n_out=3, loss="mcxent",
                                  activation="softmax"), "m")
         .add_layer("reg", JaxOut(n_out=2, loss="mse",
                                  activation="identity"), "m")
         .set_outputs("cls", "reg")
         .set_input_types(JaxInputType.feed_forward(4),
                          JaxInputType.feed_forward(3)))
    jg = JaxGraph(b.build()).init()
    return jg, _port(jg)


def _multi(seed, n=8):
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(n, 4)).astype(np.float32)
    xb = rng.normal(size=(n, 3)).astype(np.float32)
    yc = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    yr = rng.normal(size=(n, 2)).astype(np.float32)
    return [xa, xb], [yc, yr]


def test_multidataset_fit_matches_jax():
    jg, g = _two_head_pair()
    jc, pc = JaxCollect(), CollectScoresIterationListener()
    jg.set_listeners(jc)
    g.set_listeners(pc)
    for seed in (1, 2):
        f, y = _multi(seed)
        jg.fit(JaxMultiDataSet(f, y))
        g.fit(MultiDataSet(f, y))
    np.testing.assert_allclose(g.params_flat(), jg.params_flat(), **TOL)
    assert [i for i, _ in pc.scores] == [i for i, _ in jc.scores] == [1, 2]
    np.testing.assert_allclose([float(s) for _, s in pc.scores],
                               [float(s) for _, s in jc.scores], **TOL)
    f, y = _multi(3)
    np.testing.assert_allclose(g.score(MultiDataSet(f, y)),
                               jg.score(JaxMultiDataSet(f, y)), **TOL)


def test_evaluate_outputs_of_a_two_head_graph_matches_jax():
    """Every head evaluated from one forward a batch, one readback a head
    a batch; the classification head's counts and the evaluate* wrappers
    on the first head equal the JAX graph's."""
    jg, g = _two_head_pair()
    batches = [_multi(s) for s in (4, 5, 6)]
    before = fetch_counts("graph.eval")["graph.eval"]
    evs = g.evaluate_outputs([MultiDataSet(f, y) for f, y in batches])
    assert fetch_counts("graph.eval")["graph.eval"] - before == 3 * 2
    jevs = jg.evaluate_outputs([JaxMultiDataSet(f, y) for f, y in batches])
    assert sorted(evs) == ["cls", "reg"]
    np.testing.assert_array_equal(evs["cls"].confusion,
                                  jevs["cls"].confusion)
    assert evs["reg"].total == jevs["reg"].total
    tds = [MultiDataSet(f, y) for f, y in batches]
    jds = [JaxMultiDataSet(f, y) for f, y in batches]
    np.testing.assert_array_equal(g.evaluate(tds).confusion,
                                  jg.evaluate(jds).confusion)
    roc, jroc = g.evaluate_roc_multi_class(tds), \
        jg.evaluate_roc_multi_class(jds)
    for c in range(3):
        np.testing.assert_allclose(roc.calculate_auc(c),
                                   jroc.calculate_auc(c), **TOL)


@pytest.mark.parametrize("kind", ["evaluate", "regression", "roc", "roc_mc"])
def test_single_head_evaluation_matches_jax(kind):
    """The evaluate* wrappers on a one-output sequence graph (a masked
    [N, T, C] head) against the JAX graph's."""
    jg, g = _rnn_pair(seed=9)
    x, y, mask = _seq(4, 6, 8, masked=True)
    args = (x, y, None, mask)
    t, j = [DataSet(*args)], [JaxDataSet(*args)]
    if kind == "evaluate":
        np.testing.assert_array_equal(g.evaluate(t).confusion,
                                      jg.evaluate(j).confusion)
    elif kind == "regression":
        r, jr = g.evaluate_regression(t), jg.evaluate_regression(j)
        for col in range(4):
            np.testing.assert_allclose(r.mean_squared_error(col),
                                       jr.mean_squared_error(col), **TOL)
    elif kind == "roc":
        yb = y[..., :1]
        jg2, g2 = jg, g
        r = g2.do_evaluation([DataSet(x, yb, None, mask)],
                             {"out": _roc_on_first_column()})["out"]
        jr = jg2.do_evaluation([JaxDataSet(x, yb, None, mask)],
                               {"out": _roc_on_first_column(jax=True)})[
            "out"]
        np.testing.assert_allclose(r.calculate_auc(), jr.calculate_auc(),
                                   **TOL)
    else:
        r, jr = g.evaluate_roc_multi_class(t), \
            jg.evaluate_roc_multi_class(j)
        np.testing.assert_allclose(r.calculate_average_auc(),
                                   jr.calculate_average_auc(), **TOL)


class _FirstColumn:
    """An evaluation that scores the output's first column against a
    one-column label (ROC on a 4-class head)."""

    def __init__(self, roc):
        self.roc = roc

    def eval(self, labels, out, mask=None):
        self.roc.eval(labels, out[..., :1], mask)

    def calculate_auc(self):
        return self.roc.calculate_auc()


def _roc_on_first_column(jax=False):
    if jax:
        from deeplearning4j_tpu.eval.roc import ROC
    else:
        from deeplearning4j_tpu_torch.eval.roc import ROC
    return _FirstColumn(ROC(0))


# ------------------------------------------------------------ param utils
def test_params_flat_round_trip_clone_and_summary():
    jg, g = _rnn_pair(seed=12)
    flat = g.params_flat()
    np.testing.assert_array_equal(flat, jg.params_flat())
    g.set_params_flat(flat * 2)
    np.testing.assert_allclose(g.params_flat(), flat * 2, rtol=0, atol=0)
    g.set_params_flat(flat)
    x, y, _ = _seq(2, 5, 3)
    g.fit_batch(DataSet(x, y))
    twin = g.clone()
    assert twin.iteration == g.iteration == 1
    np.testing.assert_array_equal(twin.params_flat(), g.params_flat())
    twin.fit_batch(DataSet(x, y))
    assert not np.array_equal(twin.params_flat(), g.params_flat())
    g.fit_batch(DataSet(x, y))
    np.testing.assert_array_equal(twin.params_flat(), g.params_flat())
    s = g.summary()
    assert "GravesLSTM" in s and "RnnOutputLayer" in s and \
        "Total params" in s
    assert f"{flat.size:,}" in s


def test_graph_builder_takes_the_tbptt_settings_like_jax():
    """The port's graph builder writes the same truncated-BPTT settings
    into the configuration JSON as the JAX builder."""
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (GravesLSTM,
                                                         RnnOutputLayer)
    jg, _ = _rnn_pair(tbptt=7)
    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("lstm", GravesLSTM(n_out=8, activation="tanh"), "in")
            .add_layer("out", RnnOutputLayer(n_out=4, loss="mcxent",
                                             activation="softmax"), "lstm")
            .set_outputs("out").set_input_types(InputType.recurrent(4))
            .backprop_type("truncated_bptt").tbptt_fwd_length(7)
            .tbptt_back_length(7).build())
    assert (conf.backprop_type, conf.tbptt_fwd_length,
            conf.tbptt_back_length) == ("truncated_bptt", 7, 7)
    assert conf.to_json() == ComputationGraphConfiguration.from_json(
        jg.conf.to_json()).to_json()
