"""PyTorch port, the ComputationGraph's vertices on the CPU, each against
the JAX package's on the same seeded inputs: every vertex's forward
(``LastTimeStepVertex`` with a mask that has an all-zero row), their
configuration JSON both ways, three ``fit_batch`` steps of a graph
holding Merge, Subset, Stack / Unstack, Scale, Shift, L2, L2Normalize,
Preprocessor and ElementWise vertices (parameters after each step),
truncated BPTT over ``LastTimeStep`` / ``DuplicateToTimeSeries``, and
finite-difference gradient checks in f64 through every vertex.

Tolerances: f32 parity at 1e-5 relative (ROADMAP rule 1); the gradient
checks at the JAX package's own 1e-3 relative error."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.preprocessors import \
    CnnToFeedForwardPreProcessor as JaxCnnToFF
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph import vertices as jv
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.ops.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu_torch.nn.conf.serde import (from_jsonable,
                                                    to_jsonable)
from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph import vertices as tv
from deeplearning4j_tpu_torch.nn.graph.graph_config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.ops.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.utils import graph_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _port_vertex(jax_vertex):
    """The JAX vertex's configuration read back by the port."""
    from deeplearning4j_tpu.nn.conf.serde import to_jsonable as jax_json
    return from_jsonable(jax_json(jax_vertex))


def _port(jg, dtype=None):
    conf = ComputationGraphConfiguration.from_json(jg.conf.to_json())
    return graph_from_numpy(conf, {v: {k: np.asarray(a) for k, a in
                                       p.items()}
                                   for v, p in jg.params.items()},
                            device="cpu", compute_dtype=dtype)


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


_LAST_MASK = np.array([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]],
                      np.float32)

# (id, JAX vertex, inputs, masks): every vertex the port has
VERTEX_CASES = [
    ("merge_ff", jv.MergeVertex(), [_rand(1, 4, 3), _rand(2, 4, 5)], None),
    ("merge_rnn", jv.MergeVertex(), [_rand(3, 2, 5, 3), _rand(4, 2, 5, 2)],
     None),
    ("merge_cnn", jv.MergeVertex(), [_rand(5, 2, 3, 3, 2),
                                     _rand(6, 2, 3, 3, 4)], None),
    ("elementwise_add", jv.ElementWiseVertex("add"),
     [_rand(7, 4, 3), _rand(8, 4, 3), _rand(9, 4, 3)], None),
    ("elementwise_subtract", jv.ElementWiseVertex("subtract"),
     [_rand(10, 4, 3), _rand(11, 4, 3)], None),
    ("elementwise_product", jv.ElementWiseVertex("product"),
     [_rand(12, 4, 3), _rand(13, 4, 3)], None),
    ("elementwise_average", jv.ElementWiseVertex("average"),
     [_rand(14, 4, 3), _rand(15, 4, 3)], None),
    ("elementwise_max", jv.ElementWiseVertex("max"),
     [_rand(16, 4, 3), _rand(17, 4, 3)], None),
    ("subset", jv.SubsetVertex(from_index=1, to_index=3), [_rand(18, 4, 6)],
     None),
    ("subset_rnn", jv.SubsetVertex(from_index=0, to_index=1),
     [_rand(19, 2, 3, 4)], None),
    ("stack", jv.StackVertex(), [_rand(20, 3, 4), _rand(21, 3, 4)], None),
    ("unstack", jv.UnstackVertex(index=1, num_stacks=3), [_rand(22, 6, 4)],
     None),
    ("scale", jv.ScaleVertex(scale=2.5), [_rand(23, 4, 3)], None),
    ("shift", jv.ShiftVertex(shift=-0.7), [_rand(24, 4, 3)], None),
    ("l2", jv.L2Vertex(), [_rand(25, 4, 5), _rand(26, 4, 5)], None),
    ("l2_rnn", jv.L2Vertex(), [_rand(27, 2, 3, 4), _rand(28, 2, 3, 4)],
     None),
    ("l2normalize", jv.L2NormalizeVertex(), [_rand(29, 4, 5)], None),
    ("l2normalize_cnn", jv.L2NormalizeVertex(), [_rand(30, 2, 3, 3, 2)],
     None),
    ("preprocessor", jv.PreprocessorVertex(
        preprocessor=JaxCnnToFF(height=3, width=3, channels=2)),
     [_rand(31, 2, 3, 3, 2)], None),
    ("last_time_step", jv.LastTimeStepVertex(), [_rand(32, 3, 5, 4)],
     None),
    ("last_time_step_masked", jv.LastTimeStepVertex(mask_input="in"),
     [_rand(33, 3, 5, 4)], [_LAST_MASK]),
    ("duplicate_to_time_series", jv.DuplicateToTimeSeriesVertex("ref"),
     [_rand(34, 3, 4), _rand(35, 3, 6, 2)], None),
]


@pytest.mark.parametrize("case", VERTEX_CASES, ids=[c[0] for c in
                                                    VERTEX_CASES])
def test_vertex_forward_matches_jax(case):
    _, jvert, xs, masks = case
    pvert = _port_vertex(jvert)
    assert type(pvert).__name__ == type(jvert).__name__
    want, _ = jvert.forward({}, {}, [jnp.asarray(x) for x in xs],
                            masks=None if masks is None else
                            [jnp.asarray(m) for m in masks])
    got, _ = pvert.forward({}, {}, [torch.from_numpy(x) for x in xs],
                           masks=None if masks is None else
                           [torch.from_numpy(m) for m in masks])
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_last_time_step_all_zero_row_takes_step_zero():
    """max(Σ mask − 1, 0): a row with no present step reads step 0."""
    x = _rand(36, 3, 5, 4)
    got, _ = tv.LastTimeStepVertex().forward(
        {}, {}, [torch.from_numpy(x)],
        masks=[torch.from_numpy(_LAST_MASK)])
    np.testing.assert_array_equal(got.numpy(), x[[0, 1, 2], [2, 0, 4]])


@pytest.mark.parametrize("case", VERTEX_CASES, ids=[c[0] for c in
                                                    VERTEX_CASES])
def test_vertex_json_round_trips_both_ways(case):
    from deeplearning4j_tpu.nn.conf.serde import from_jsonable as jax_from
    from deeplearning4j_tpu.nn.conf.serde import to_jsonable as jax_json
    jvert = case[1]
    pvert = _port_vertex(jvert)
    assert to_jsonable(pvert) == jax_json(jvert)
    assert jax_json(jax_from(to_jsonable(pvert))) == jax_json(jvert)


def test_vertex_output_types_match_jax():
    """The builder's shape inference through each vertex kind."""
    from deeplearning4j_tpu.nn.conf.serde import to_jsonable as jax_json
    jit = JaxInputType
    cases = [(jv.MergeVertex(), [jit.feed_forward(3), jit.feed_forward(5)]),
             (jv.MergeVertex(), [jit.recurrent(3, 7), jit.recurrent(2, 7)]),
             (jv.MergeVertex(), [jit.convolutional(4, 4, 2),
                                 jit.convolutional(4, 4, 3)]),
             (jv.SubsetVertex(from_index=2, to_index=5),
              [jit.recurrent(8, 4)]),
             (jv.L2Vertex(), [jit.feed_forward(3), jit.feed_forward(3)]),
             (jv.PreprocessorVertex(preprocessor=JaxCnnToFF(3, 3, 2)),
              [jit.convolutional(3, 3, 2)]),
             (jv.LastTimeStepVertex(), [jit.recurrent(6, 9)]),
             (jv.DuplicateToTimeSeriesVertex("r"),
              [jit.feed_forward(4), jit.recurrent(2, 11)])]
    for jvert, types in cases:
        want = jvert.output_type(types)
        got = _port_vertex(jvert).output_type(
            [from_jsonable(jax_json(t)) for t in types])
        assert jax_json(want) == to_jsonable(got), type(jvert).__name__


def _vertex_graph(updater="adam", dtype=None):
    """Two feed-forward inputs and an image through every non-recurrent
    vertex kind to one softmax head, both packages."""
    b = (JaxNNC.Builder().seed(21).learning_rate(0.05).updater(updater)
         .weight_init("xavier").activation("tanh").graph_builder()
         .add_inputs("a", "b", "img")
         .add_layer("d1", jl.DenseLayer(n_out=6), "a")
         .add_layer("d2", jl.DenseLayer(n_out=6), "b")
         .add_vertex("stack", jv.StackVertex(), "d1", "d2")
         .add_vertex("shift", jv.ShiftVertex(shift=0.5), "stack")
         .add_vertex("scale", jv.ScaleVertex(scale=0.8), "shift")
         .add_vertex("norm", jv.L2NormalizeVertex(), "scale")
         .add_vertex("u0", jv.UnstackVertex(index=0, num_stacks=2), "norm")
         .add_vertex("u1", jv.UnstackVertex(index=1, num_stacks=2), "norm")
         .add_vertex("merge", jv.MergeVertex(), "u0", "u1")
         .add_vertex("sub", jv.SubsetVertex(from_index=2, to_index=9),
                     "merge")
         .add_vertex("dist", jv.L2Vertex(), "d1", "d2")
         .add_vertex("flat", jv.PreprocessorVertex(
             preprocessor=JaxCnnToFF(height=2, width=2, channels=2)), "img")
         .add_layer("d3", jl.DenseLayer(n_out=8), "flat")
         .add_vertex("prod", jv.ElementWiseVertex("product"), "sub", "d3")
         .add_vertex("all", jv.MergeVertex(), "prod", "dist")
         .add_layer("out", jl.OutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"), "all")
         .set_outputs("out")
         .set_input_types(JaxInputType.feed_forward(4),
                          JaxInputType.feed_forward(4),
                          JaxInputType.convolutional(2, 2, 2)))
    jg = JaxGraph(b.build()).init()
    return jg, _port(jg, dtype)


def _vertex_batch(seed, n=5):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(n, 4)).astype(np.float32),
             rng.normal(size=(n, 4)).astype(np.float32),
             rng.normal(size=(n, 2, 2, 2)).astype(np.float32)]
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return feats, y


def test_vertex_graph_json_and_inferred_widths_match_jax():
    jg, pg = _vertex_graph()
    assert pg.conf.to_json() == jg.conf.to_json()
    assert pg.conf.vertices["out"].layer.n_in == 9
    assert pg.conf.vertices["d3"].layer.n_in == 8


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_vertex_graph_fit_batch_matches_jax(updater):
    jg, pg = _vertex_graph(updater)
    feats, y = _vertex_batch(4)
    np.testing.assert_allclose(pg.output(*feats)[0],
                               np.asarray(jg.output(*feats)[0]), **TOL)
    for step in range(3):
        jg.fit_batch(JaxMultiDataSet(feats, [y]))
        pg.fit_batch(MultiDataSet(feats, [y]))
        np.testing.assert_allclose(float(pg.score_value),
                                   float(jg.score_value), **TOL)
        np.testing.assert_allclose(pg.params_flat(), jg.params_flat(),
                                   **TOL, err_msg=f"step {step}")


def _seq2seq(tbptt):
    """LSTM encoder → LastTimeStep → Dense → DuplicateToTimeSeries, merged
    with the LSTM's sequence, → RnnOutputLayer (the JAX package's
    ``test_tbptt_graph_with_rnn_vertices``)."""
    b = (JaxNNC.Builder().seed(9).learning_rate(0.05).updater("adam")
         .weight_init("xavier").graph_builder().add_inputs("in")
         .add_layer("lstm", jl.LSTM(n_out=6, activation="tanh"), "in")
         .add_vertex("last", jv.LastTimeStepVertex(mask_input="in"), "lstm")
         .add_layer("summary", jl.DenseLayer(n_out=6, activation="tanh"),
                    "last")
         .add_vertex("dup", jv.DuplicateToTimeSeriesVertex("in"), "summary",
                     "in")
         .add_vertex("merge", jv.MergeVertex(), "lstm", "dup")
         .add_layer("out", jl.RnnOutputLayer(n_out=3, loss="mcxent",
                                             activation="softmax"), "merge")
         .set_outputs("out").set_input_types(JaxInputType.recurrent(4)))
    if tbptt:
        b = b.backprop_type("truncated_bptt").tbptt_fwd_length(tbptt) \
            .tbptt_back_length(tbptt)
    jg = JaxGraph(b.build()).init()
    return jg, _port(jg)


@pytest.mark.parametrize("masked", [False, True])
def test_tbptt_over_last_time_step_and_duplicate_matches_jax(masked):
    jg, pg = _seq2seq(tbptt=4)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 8))]
    mask = None
    if masked:
        mask = np.ones((3, 8), np.float32)
        mask[0, 5:] = 0.0
        mask[1, :] = 0.0
    for _ in range(2):
        jg.fit_batch(JaxDataSet(x, y, mask, mask))
        pg.fit_batch(DataSet(x, y, mask, mask))
        assert pg.iteration == jg.iteration
        np.testing.assert_allclose(pg.params_flat(), jg.params_flat(),
                                   **TOL)
    np.testing.assert_allclose(pg.output(x)[0], np.asarray(jg.output(x)[0]),
                               **TOL)


def test_sequence_graph_masked_whole_fit_matches_jax():
    """The masked mean under a features mask (no truncation)."""
    jg, pg = _seq2seq(tbptt=None)
    rng = np.random.default_rng(18)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 6))]
    mask = np.ones((3, 6), np.float32)
    mask[2, 2:] = 0.0
    for _ in range(3):
        jg.fit_batch(JaxDataSet(x, y, mask, mask))
        pg.fit_batch(DataSet(x, y, mask, mask))
    np.testing.assert_allclose(pg.params_flat(), jg.params_flat(), **TOL)


def _f64_graph(builder_fn):
    b = (JaxNNC.Builder().seed(5).learning_rate(0.1).updater("sgd")
         .weight_init("xavier").activation("tanh").graph_builder())
    conf = builder_fn(b).build()
    port_conf = ComputationGraphConfiguration.from_json(conf.to_json())
    return ComputationGraph(port_conf, compute_dtype=torch.float64,
                            device="cpu").init()


def _gc_vertex_graph(b):
    return (b.add_inputs("a", "b")
            .add_layer("d1", jl.DenseLayer(n_out=4), "a")
            .add_layer("d2", jl.DenseLayer(n_out=4), "b")
            .add_vertex("stack", jv.StackVertex(), "d1", "d2")
            .add_vertex("shift", jv.ShiftVertex(shift=0.3), "stack")
            .add_vertex("scale", jv.ScaleVertex(scale=1.5), "shift")
            .add_vertex("norm", jv.L2NormalizeVertex(), "scale")
            .add_vertex("u0", jv.UnstackVertex(index=0, num_stacks=2),
                        "norm")
            .add_vertex("u1", jv.UnstackVertex(index=1, num_stacks=2),
                        "norm")
            .add_vertex("merge", jv.MergeVertex(), "u0", "u1")
            .add_vertex("sub", jv.SubsetVertex(from_index=1, to_index=6),
                        "merge")
            .add_vertex("dist", jv.L2Vertex(), "d1", "d2")
            .add_vertex("diff", jv.ElementWiseVertex("subtract"), "u0", "u1")
            .add_vertex("all", jv.MergeVertex(), "sub", "dist", "diff")
            .add_layer("out", jl.OutputLayer(n_out=3, loss="mcxent",
                                             activation="softmax"), "all")
            .set_outputs("out")
            .set_input_types(JaxInputType.feed_forward(3),
                             JaxInputType.feed_forward(3)))


def _gc_seq_graph(b):
    return (b.add_inputs("in")
            .add_layer("lstm", jl.GravesLSTM(n_out=3), "in")
            .add_vertex("last", jv.LastTimeStepVertex(mask_input="in"),
                        "lstm")
            .add_vertex("dup", jv.DuplicateToTimeSeriesVertex("in"), "last",
                        "in")
            .add_vertex("merge", jv.MergeVertex(), "lstm", "dup")
            .add_layer("out", jl.RnnOutputLayer(n_out=2, loss="mcxent",
                                                activation="softmax"),
                       "merge")
            .set_outputs("out").set_input_types(JaxInputType.recurrent(2)))


def test_gradient_check_through_every_vertex_f64():
    net = _f64_graph(_gc_vertex_graph)
    rng = np.random.default_rng(3)
    ds = MultiDataSet([rng.normal(size=(4, 3)), rng.normal(size=(4, 3))],
                      [np.eye(3)[rng.integers(0, 3, 4)]])
    assert net.params_flat().dtype == np.float64
    assert check_gradients(net, ds)


@pytest.mark.parametrize("masked", [False, True])
def test_gradient_check_through_sequence_vertices_f64(masked):
    net = _f64_graph(_gc_seq_graph)
    rng = np.random.default_rng(4)
    mask = None
    if masked:
        mask = np.ones((3, 4))
        mask[0, 2:] = 0.0
    ds = DataSet(rng.normal(size=(3, 4, 2)),
                 np.eye(2)[rng.integers(0, 2, (3, 4))], mask, mask)
    assert check_gradients(net, ds, subsample=80)


def test_graph_takes_tensor_masks_like_host_masks():
    """Masks given as tensors (as ``AsyncDataSetIterator`` stages them)
    train the graph exactly as the same masks given as host arrays."""
    _, a = _seq2seq(tbptt=None)
    _, b = _seq2seq(tbptt=None)
    rng = np.random.default_rng(28)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, 6))]
    mask = np.ones((3, 6), np.float32)
    mask[1, 3:] = 0.0
    a.fit_batch(DataSet(x, y, mask, mask))
    b.fit_batch(DataSet(torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(mask), torch.from_numpy(mask)))
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
