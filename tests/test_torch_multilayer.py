"""PyTorch port, the sequential network and the char-RNN on the CPU: the
builder's JSON (char-RNN, preprocessors), ``output`` / ``feed_forward``
parity, rmsprop + l2 train steps, truncated BPTT, masked variable-length
``score`` and ``fit``, ``rnn_time_step`` streaming and sampling, every
loss's ``compute_loss``, a one-hot ComputationGraph loss, checkpoints both
ways, iterators and preprocessors — each against the JAX package on the
same seeded inputs, with weights carried across by ``network_from_numpy``.

Tolerances: f32 parity at 1e-5 (ROADMAP rule 1) unless a test says
otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterators as jit_
from deeplearning4j_tpu.models import CharacterIterator as JaxCharIter
from deeplearning4j_tpu.models import char_rnn_conf as jax_char_rnn_conf
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.conf import preprocessors as jpp
from deeplearning4j_tpu.nn.conf.config import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.layers import (DenseLayer as JaxDense,
                                               GravesLSTM as JaxGravesLSTM,
                                               OutputLayer as JaxOut)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.utils.serializer import ModelSerializer
from deeplearning4j_tpu_torch.datasets import iterators as tit
from deeplearning4j_tpu_torch.models import CharacterIterator, char_rnn_conf
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer, GravesLSTM,
                                                     OutputLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.graph.graph_config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.utils import (graph_from_numpy,
                                            network_from_numpy,
                                            restore_multi_layer_network,
                                            write_model)

TOL = dict(rtol=1e-5, atol=1e-5)
V, H = 12, 16


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _jax_arrays(jnet):
    return [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]


def _pair(tbptt=0, seed=5, lr=0.01):
    """The small char-RNN in both packages with the JAX net's weights. The
    learning rate is small because rmsprop's first step is ~lr·sign(g):
    at lr 0.1 a gradient's f32 rounding (~1e-5 relative) moves a weight by
    ~2e-5."""
    jnet = JaxNet(jax_char_rnn_conf(V, hidden=H, layers=2, learning_rate=lr,
                                    tbptt_length=tbptt, seed=seed)).init()
    conf = char_rnn_conf(V, hidden=H, layers=2, learning_rate=lr,
                         tbptt_length=tbptt, seed=seed)
    return jnet, network_from_numpy(conf, _jax_arrays(jnet), device="cpu")


def _onehot_batch(n=3, t=6, seed=0):
    rng = np.random.default_rng(seed)
    eye = np.eye(V, dtype=np.float32)
    return eye[rng.integers(0, V, (n, t))], eye[rng.integers(0, V, (n, t))]


def _assert_params(jnet, net, tol=TOL):
    for jp, tp in zip(jnet.params, net.params):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), **tol)


# ------------------------------------------------------------ configuration
def test_char_rnn_conf_json_identical_to_jax():
    for tbptt in (50, 0):
        want = jax_char_rnn_conf(V, hidden=H, layers=2, tbptt_length=tbptt)
        got = char_rnn_conf(V, hidden=H, layers=2, tbptt_length=tbptt)
        assert got.to_json() == want.to_json()
        again = MultiLayerConfiguration.from_json(got.to_json())
        assert again.to_json() == got.to_json()


def _mixed_conf(pkg):
    nnc, it, dense, lstm, out = pkg
    return (nnc.Builder().seed(3).learning_rate(0.05).updater("adam")
            .l1(1e-4).activation("relu").list()
            .layer(lstm(n_out=7, activation="tanh"))
            .layer(dense(n_out=5))
            .layer(out(n_out=4, loss="mse", activation="identity"))
            .set_input_type(it.recurrent(6, 5)).build())


JAX_PKG = (JaxNNC, JaxInputType, JaxDense, JaxGravesLSTM, JaxOut)
TORCH_PKG = (NeuralNetConfiguration, InputType, DenseLayer, GravesLSTM,
             OutputLayer)


def test_list_builder_with_preprocessors_matches_jax():
    """nIn inference and the auto-inserted rnn → ff preprocessor give the
    same JSON, and the net the same output."""
    want, got = _mixed_conf(JAX_PKG), _mixed_conf(TORCH_PKG)
    assert got.to_json() == want.to_json()
    assert sorted(got.input_preprocessors) == ["1"]
    jnet = JaxNet(want).init()
    net = network_from_numpy(got, _jax_arrays(jnet), device="cpu")
    x = np.random.default_rng(1).normal(size=(2, 5, 6)).astype(np.float32)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **TOL)
    for a, b in zip(net.feed_forward(x), jnet.feed_forward(x)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_regularization_cascade_matches_jax():
    """l1 / l2 cascade as 0 unless regularization is on."""
    for flag in (False, True):
        confs = [(nnc.Builder().l2(0.01).regularization(flag).list()
                  .layer(dense(n_in=3, n_out=2)).build())
                 for nnc, _, dense, _, _ in (JAX_PKG, TORCH_PKG)]
        assert confs[0].to_json() == confs[1].to_json()


# ---------------------------------------------------------------- inference
def test_output_predict_and_summary_match_jax():
    jnet, net = _pair()
    x, _ = _onehot_batch(seed=2)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **TOL)
    np.testing.assert_array_equal(net.predict(x), jnet.predict(x))
    assert net.num_params() == jnet.num_params()
    assert net.summary() == jnet.summary()
    np.testing.assert_array_equal(net.params_flat(), jnet.params_flat())
    assert sorted(net.param_table()) == sorted(jnet.param_table())


def test_set_params_flat_round_trip():
    _, net = _pair()
    flat = net.params_flat()
    net.set_params_flat(flat[::-1].copy())
    np.testing.assert_array_equal(net.params_flat(), flat[::-1])


def test_rnn_time_step_stream_matches_jax():
    """Single steps, a multi-step call and a cleared restart, against the
    JAX net's stateful calls (1e-5)."""
    jnet, net = _pair(seed=7)
    x, _ = _onehot_batch(n=2, t=9, seed=3)
    outs = {"jax": [], "port": []}
    for key, n_ in (("jax", jnet), ("port", net)):
        for t in range(4):
            outs[key].append(np.asarray(n_.rnn_time_step(x[:, t])))
        outs[key].append(np.asarray(n_.rnn_time_step(x[:, 4:])))
        n_.rnn_clear_previous_state()
        outs[key].append(np.asarray(n_.rnn_time_step(x[:, 0])))
    for a, b in zip(outs["port"], outs["jax"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    # streaming equals the full forward
    net.rnn_clear_previous_state()
    steps = np.stack([net.rnn_time_step(x[:, t]) for t in range(9)], 1)
    np.testing.assert_allclose(steps, net.output(x), **TOL)


def test_character_iterator_and_sample_match_jax():
    text = "the quick brown fox jumps over the lazy dog " * 8
    jit = JaxCharIter(text, seq_length=10, batch_size=4, seed=3)
    tit_ = CharacterIterator(text, seq_length=10, batch_size=4, seed=3)
    assert tit_.chars == jit.chars
    for a, b in zip(tit_, jit):
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
    v = jit.vocab_size
    jnet = JaxNet(jax_char_rnn_conf(v, hidden=H, seed=4)).init()
    net = network_from_numpy(char_rnn_conf(v, hidden=H, seed=4),
                             _jax_arrays(jnet), device="cpu")
    for temp in (1.0, 0.7):
        assert tit_.sample(net, "t", 40, temperature=temp, rng_seed=9) == \
            jit.sample(jnet, "t", 40, temperature=temp, rng_seed=9)


# ----------------------------------------------------------------- training
@pytest.mark.parametrize("labels", ["onehot", "sparse"])
def test_rmsprop_l2_steps_match_jax(labels):
    """3 ``_fit_batch`` steps (rmsprop, l2 1e-3): loss rtol 1e-5 and
    parameters atol 1e-5 after each; sparse class ids go through the fused
    sparse CE in both packages."""
    jnet, net = _pair(seed=9)
    x, y = _onehot_batch(n=4, t=7, seed=4)
    if labels == "sparse":
        y = y.argmax(-1).astype(np.int32)
    for _ in range(3):
        jnet._fit_batch(JaxDataSet(x, y))
        net._fit_batch(DataSet(x, y))
        np.testing.assert_allclose(float(net.score_value),
                                   float(jnet.score_value), rtol=1e-5)
        _assert_params(jnet, net)
        for ju, tu in zip(jnet.updater_state, net.updater_state):
            for k in ju:
                np.testing.assert_allclose(_np(tu[k]["e"]),
                                           np.asarray(ju[k]["e"]), **TOL)
    assert net.iteration == jnet.iteration == 3


def test_tbptt_fit_matches_jax():
    """``fit`` with a 4-step window over T 10 (3 windows, 3 updates, the
    carry crossing windows) ends at JAX's parameters."""
    jnet, net = _pair(tbptt=4, seed=11)
    x, y = _onehot_batch(n=3, t=10, seed=5)
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    assert net.iteration == jnet.iteration == 3
    np.testing.assert_allclose(float(net.score_value),
                               float(jnet.score_value), rtol=1e-5)
    _assert_params(jnet, net)


def test_tbptt_carries_state_across_windows():
    """The second window starts from the first's final (h, c): training on
    the windows as separate batches (zero state each) differs."""
    _, net = _pair(tbptt=4, seed=11)
    _, cut = _pair(tbptt=4, seed=11)
    x, y = _onehot_batch(n=3, t=8, seed=6)
    net.fit(DataSet(x, y))
    cut.fit([DataSet(x[:, :4], y[:, :4]), DataSet(x[:, 4:], y[:, 4:])])
    assert not np.allclose(net.params_flat(), cut.params_flat())


FMASK = np.array([[1, 1, 1, 0, 0],
                  [1, 1, 1, 1, 1],
                  [1, 1, 0, 0, 0]], np.float32)


def test_masked_variable_length_score_and_fit_match_jax():
    """The variable-length mask of tests/test_regression_helpers.py: score
    averages over present cells, and a fit step matches JAX."""
    jnet, net = _pair(seed=13)
    x, y = _onehot_batch(n=3, t=5, seed=7)
    ds = (x, y, FMASK, FMASK.copy())
    np.testing.assert_allclose(net.score(DataSet(*ds)),
                               jnet.score(JaxDataSet(*ds)), rtol=1e-5)
    jnet.fit([JaxDataSet(*ds)])
    net.fit([DataSet(*ds)])
    _assert_params(jnet, net)
    # padding invariance: the masked tail does not move the score
    x2 = x.copy()
    x2[FMASK == 0] = 0.5
    np.testing.assert_allclose(net.score(DataSet(x2, y, FMASK, FMASK)),
                               net.score(DataSet(*ds)), rtol=1e-6)


def test_compute_gradient_and_score_matches_jax():
    jnet, net = _pair(seed=15)
    x, y = _onehot_batch(n=2, t=5, seed=8)
    jg, js = jnet.compute_gradient_and_score(JaxDataSet(x, y))
    tg, ts = net.compute_gradient_and_score(DataSet(x, y))
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    for a, b in zip(tg, jg):
        for k in b:
            np.testing.assert_allclose(_np(a[k]), np.asarray(b[k]), **TOL)


def test_bf16_training_runs_on_a_cast_copy():
    """A bf16 compute dtype trains on a bf16 copy of f32 masters: the
    masters stay f32, the loss is close to the f32 one and falls."""
    jnet, net = _pair(seed=17, lr=0.005)
    conf = char_rnn_conf(V, hidden=H, layers=2, learning_rate=0.005,
                         tbptt_length=0, seed=17)
    bf = network_from_numpy(conf, _jax_arrays(jnet), device="cpu",
                            compute_dtype=torch.bfloat16)
    x, y = _onehot_batch(n=4, t=8, seed=9)
    losses = []
    for _ in range(4):
        bf._fit_batch(DataSet(x, y))
        losses.append(float(bf.score_value))
    assert all(p.dtype == torch.float32 for ps in bf.params
               for p in ps.values())
    np.testing.assert_allclose(losses[0], net.score(DataSet(x, y)),
                               rtol=2e-2)
    assert losses[-1] < losses[0]


def test_integer_labels_on_an_ineligible_head_raise():
    conf = (NeuralNetConfiguration.Builder().list()
            .layer(GravesLSTM(n_out=4, activation="tanh"))
            .layer(RnnOutputLayer(n_out=3, loss="mcxent",
                                  activation="sigmoid"))
            .set_input_type(InputType.recurrent(2)).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    with pytest.raises(ValueError, match="class-id labels"):
        net.score(DataSet(np.zeros((1, 3, 2), np.float32),
                          np.zeros((1, 3), np.int64)))


# -------------------------------------------------------------------- losses
LOSS_ACT = {"mcxent": "softmax", "categorical_crossentropy": "softmax",
            "negativeloglikelihood": "softmax", "kl_divergence": "softmax",
            "xent": "sigmoid", "binary_crossentropy": "sigmoid",
            "reconstruction_crossentropy": "sigmoid", "poisson": "softplus",
            "msle": "softplus", "mean_squared_logarithmic_error": "softplus",
            "hinge": "tanh", "squared_hinge": "tanh"}


def _loss_labels(name, shape, rng):
    if name in ("mcxent", "categorical_crossentropy",
                "negativeloglikelihood", "kl_divergence"):
        return np.eye(shape[-1], dtype=np.float32)[
            rng.integers(0, shape[-1], shape[:-1])]
    if name in ("xent", "binary_crossentropy",
                "reconstruction_crossentropy"):
        return (rng.random(shape) > 0.5).astype(np.float32)
    if name in ("hinge", "squared_hinge"):
        return np.where(rng.random(shape) > 0.5, 1.0, -1.0).astype(np.float32)
    return rng.random(shape).astype(np.float32) + 0.1


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("seq", [False, True], ids=["ff", "rnn"])
@pytest.mark.parametrize("name", jloss.loss_names())
def test_compute_loss_matches_jax(name, seq, masked):
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    shape = (3, 4, 5) if seq else (3, 5)
    labels = _loss_labels(name, shape, rng)
    pre = rng.normal(size=shape).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random(shape[:2] if seq else shape[:1]) > 0.3) \
            .astype(np.float32)
        mask.reshape(-1)[0] = 1.0
    act = LOSS_ACT.get(name, "identity")
    want = jloss.compute_loss(name, jnp.asarray(labels), jnp.asarray(pre),
                              act, None if mask is None else
                              jnp.asarray(mask))
    got = tloss.compute_loss(name, torch.from_numpy(labels),
                             torch.from_numpy(pre), act,
                             None if mask is None else
                             torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


def test_loss_registry_names_match_jax():
    assert tloss.loss_names() == jloss.loss_names()


def test_one_hot_graph_loss_matches_jax():
    """A ComputationGraph head with one-hot labels scores through
    ``compute_score`` (mcxent), as the JAX graph does; loss and gradients
    match."""
    from deeplearning4j_tpu.nn.conf.layers import RnnOutputLayer as JOut
    jconf = (JaxNNC.Builder().seed(3).learning_rate(0.05).updater("sgd")
             .graph_builder().add_inputs("in")
             .add_layer("lstm", JaxGravesLSTM(n_in=4, n_out=8,
                                              activation="tanh"), "in")
             .add_layer("out", JOut(n_in=8, n_out=4, loss="mcxent",
                                    activation="softmax"), "lstm")
             .set_outputs("out").build())
    jg = JaxGraph(jconf).init()
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    g = graph_from_numpy(conf, {v: {k: np.asarray(a) for k, a in p.items()}
                                for v, p in jg.params.items()}, device="cpu")
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 5, 4)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 5))]
    want_g, want_s = jg.compute_gradient_and_score(JaxDataSet(x, y))
    got_g, got_s = g.compute_gradient_and_score(DataSet(x, y))
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5)
    for v in want_g:
        for k in want_g[v]:
            np.testing.assert_allclose(_np(got_g[v][k]),
                                       np.asarray(want_g[v][k]), **TOL)


# -------------------------------------------------------------- checkpoints
def test_checkpoint_jax_to_port_and_back(tmp_path):
    """JAX writes after 2 steps → the port restores (params, rmsprop state,
    iteration) and takes step 3 → JAX restores that and matches a JAX run
    of 3 steps."""
    jnet, _ = _pair(seed=19)
    x, y = _onehot_batch(n=3, t=6, seed=10)
    for _ in range(2):
        jnet._fit_batch(JaxDataSet(x, y))
    ModelSerializer.write_model(jnet, tmp_path / "jax.zip")
    net = restore_multi_layer_network(tmp_path / "jax.zip", device="cpu")
    assert net.iteration == 2
    _assert_params(jnet, net, dict(rtol=0, atol=0))
    net._fit_batch(DataSet(x, y))
    jnet._fit_batch(JaxDataSet(x, y))
    write_model(net, tmp_path / "port.zip")
    back = ModelSerializer.restore_multi_layer_network(tmp_path / "port.zip")
    assert back.iteration == 3
    _assert_params(back, net, dict(rtol=0, atol=0))
    _assert_params(jnet, net)
    for ju, tu in zip(back.updater_state, net.updater_state):
        for k in ju:
            np.testing.assert_array_equal(np.asarray(ju[k]["e"]),
                                          _np(tu[k]["e"]))


# ----------------------------------------------- iterators, preprocessors
def test_array_iterator_batches_match_jax():
    rng = np.random.default_rng(21)
    f = rng.normal(size=(10, 3)).astype(np.float32)
    lab = rng.normal(size=(10, 2)).astype(np.float32)
    fm = rng.random((10, 3)).astype(np.float32)
    a = tit.ArrayDataSetIterator(f, lab, 4, shuffle=True, seed=2,
                                 features_mask=fm)
    b = jit_.ArrayDataSetIterator(f, lab, 4, shuffle=True, seed=2,
                                  features_mask=fm)
    for _ in range(2):
        for da, db in zip(a, b):
            np.testing.assert_array_equal(da.features, db.features)
            np.testing.assert_array_equal(da.labels, db.labels)
            np.testing.assert_array_equal(da.features_mask, db.features_mask)
    assert a.total_examples() == b.total_examples() == 10
    ds = DataSet(f, lab)
    assert list(tit.as_iterator(ds)) == [ds]
    assert tit.as_iterator([ds, ds]).total_examples() == 20
    with pytest.raises(TypeError):
        tit.as_iterator(3)


PREPROCESSORS = [
    ("CnnToFeedForwardPreProcessor", (2, 3, 4, 5), dict(height=3, width=4,
                                                         channels=5)),
    ("FeedForwardToCnnPreProcessor", (2, 60), dict(height=3, width=4,
                                                   channels=5)),
    ("FeedForwardToRnnPreProcessor", (6, 5), dict(timesteps=3)),
    ("RnnToFeedForwardPreProcessor", (2, 3, 5), {}),
    ("CnnToRnnPreProcessor", (6, 3, 4, 5), dict(height=3, width=4,
                                                channels=5, timesteps=3)),
    ("RnnToCnnPreProcessor", (2, 3, 60), dict(height=3, width=4,
                                              channels=5)),
]


@pytest.mark.parametrize("name,shape,kw", PREPROCESSORS,
                         ids=[p[0] for p in PREPROCESSORS])
def test_preprocessor_matches_jax(name, shape, kw):
    x = np.random.default_rng(22).normal(size=shape).astype(np.float32)
    jp, tp = getattr(jpp, name)(**kw), getattr(tpp, name)(**kw)
    np.testing.assert_array_equal(_np(tp.pre_process(torch.from_numpy(x))),
                                  np.asarray(jp.pre_process(jnp.asarray(x))))
    it = JaxInputType.convolutional(3, 4, 5) if "Cnn" in name.split("To")[0] \
        else JaxInputType.recurrent(5, 3)
    tin = InputType(**it.to_dict())
    assert tp.output_type(tin).to_dict() == jp.output_type(it).to_dict()


@pytest.mark.parametrize("kinds", [("cnn", "ff"), ("rnn", "ff"),
                                   ("ff", "rnn"), ("cnn", "rnn"),
                                   ("cnnflat", "cnn"), ("rnn", "rnn")])
def test_auto_preprocessor_matches_jax(kinds):
    prev, needed = kinds
    it = JaxInputType("cnnflat" if prev == "cnnflat" else prev, size=60,
                      timesteps=3, height=3, width=4, channels=5)
    want = jpp.auto_preprocessor(it, needed, timesteps=3)
    got = tpp.auto_preprocessor(InputType(**it.to_dict()), needed,
                                timesteps=3)
    assert type(got).__name__ == type(want).__name__
