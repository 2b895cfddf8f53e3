"""PyTorch port, the training API of queue A1 and A11 on the CPU, each
against the JAX package on the same seeded inputs and weights (carried
by ``utils/serializer.py``): the feed-forward layers (loss, dropout,
embedding, autoencoder, RBM, center loss) and the variational
autoencoder, their pretrain losses and gradients, the RBM's CD gradient,
the VAE's ELBO at a numpy ε, the center-loss head in training,
``pretrain`` on both model classes, transfer learning on both (the
configuration JSON after surgery, the copied parameters, fine-tune steps,
frozen parameters bit-identical under every updater, the helpers'
``featurize``), early stopping, checkpoints with the new layers both
ways, finite-difference gradient checks in f64, the line-search solvers,
and the iterators (sampling, multiple epochs, the asynchronous
prefetcher: exceptions, a failed device copy, the bounded queue, bf16
staging).

Noise cannot match: JAX draws from threefry, the port from torch
generators (ROADMAP rule 3, extended). Parity is held where nothing is
drawn (corruption 0, no generator, non-binary hidden units, inference
mode); noisy paths are held to determinism within the port and to their
rates. Tolerances: f32 parity at 1e-5 relative (ROADMAP rule 1); the
gradient checks at the JAX package's 1e-3 relative error; the
solvers' final scores at 1e-5 relative and their parameters at 1e-4
(f64 on both sides, but each accepted line-search step scales the
rounding of the gradient it followed); the bf16 embedding's output at
2e-2 (bf16 rounds the weights, ~0.4% each)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import iterators as jit_
from deeplearning4j_tpu.earlystopping import core as jes
from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn import transfer as jtr
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.serde import to_jsonable as jax_json
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.optimize import solvers as jsol
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.utils.serializer import ModelSerializer
from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator,
                                               DataSetIterator,
                                               ListDataSetIterator,
                                               MultipleEpochsIterator,
                                               SamplingDataSetIterator)
from deeplearning4j_tpu_torch import earlystopping as pes
from deeplearning4j_tpu_torch.earlystopping import (EarlyStoppingTrainer,
                                                    InMemoryModelSaver,
                                                    LocalFileModelSaver)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.serde import from_jsonable
from deeplearning4j_tpu_torch.nn.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.nn.graph.graph_config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.transfer import (
    FineTuneConfiguration, GraphTransferLearningHelper, TransferLearning,
    TransferLearningHelper)
from deeplearning4j_tpu_torch.optimize import Solver
from deeplearning4j_tpu_torch.optimize import solvers as psol
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.utils import (graph_from_numpy,
                                            network_from_numpy,
                                            restore_model,
                                            restore_multi_layer_network,
                                            write_model)

TOL = dict(rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ helpers
def _port_layer(jlayer):
    """The JAX layer's configuration read back by the port."""
    return from_jsonable(jax_json(jlayer))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(tree, dtype=None):
    return {k: torch.from_numpy(np.array(v)) if dtype is None else
            torch.from_numpy(np.array(v)).to(dtype) for k, v in tree.items()}


def _x(seed, *shape, unit=False):
    rng = np.random.default_rng(seed)
    a = rng.random(shape) if unit else rng.normal(size=shape)
    return a.astype(np.float32)


def _onehot(seed, n, c, dtype=np.float32):
    return np.eye(c, dtype=dtype)[np.random.default_rng(seed).integers(0, c,
                                                                      n)]


def _jparams(jlayer, seed=0):
    return jlayer.init_params(jax.random.PRNGKey(seed))


def _port_mln(jnet, dtype=None):
    """The JAX network's configuration, weights and state as a CPU port
    network."""
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return network_from_numpy(conf, [_np(p) for p in jnet.params],
                              device="cpu", compute_dtype=dtype,
                              state=[_np(s) for s in jnet.state])


def _port_graph(jg):
    conf = ComputationGraphConfiguration.from_json(jg.conf.to_json())
    return graph_from_numpy(conf, {v: _np(p) for v, p in jg.params.items()},
                            device="cpu",
                            state={v: _np(s) for v, s in jg.state.items()})


def _jmln(layers, n_in, updater="sgd", lr=0.1, seed=3, l2=None,
          activation="tanh", dtype=None, **kw):
    b = (JaxNNC.Builder().seed(seed).learning_rate(lr).updater(updater)
         .weight_init("xavier").activation(activation))
    if l2:
        b = b.regularization(True).l2(l2)
    lb = b.list()
    for layer in layers:
        lb.layer(layer)
    if kw.get("pretrain"):
        lb = lb.pretrain(True)
    conf = lb.set_input_type(JaxInputType.feed_forward(n_in)).build()
    return JaxMLN(conf, compute_dtype=dtype).init()


def _assert_params(pnet, jnet, tol=TOL, what=""):
    np.testing.assert_allclose(pnet.params_flat(), jnet.params_flat(),
                               **tol, err_msg=what)


# ------------------------------------------------- layers, noise-free forms
LAYER_CASES = [
    ("loss_softmax", jl.LossLayer(loss="mcxent", activation="softmax"),
     (4, 3)),
    ("dropout_inference", jl.DropoutLayer(drop_out=0.5), (4, 6)),
    ("embedding_float_ids", jl.EmbeddingLayer(n_in=10, n_out=4,
                                              activation="tanh",
                                              weight_init="xavier"), "ids"),
    ("embedding_one_hot", jl.EmbeddingLayer(n_in=10, n_out=4,
                                            activation="identity",
                                            weight_init="xavier"), "onehot"),
    ("autoencoder", jl.AutoEncoder(n_in=5, n_out=4, activation="sigmoid",
                                   weight_init="xavier"), (6, 5)),
    ("rbm", jl.RBM(n_in=5, n_out=4, activation="sigmoid",
                   weight_init="xavier"), (6, 5)),
    ("center_loss", jl.CenterLossOutputLayer(n_in=5, n_out=3,
                                             activation="softmax",
                                             weight_init="xavier"), (6, 5)),
    ("vae_bernoulli", jl.VariationalAutoencoder(
        n_in=6, n_out=3, encoder_layer_sizes=[5, 4],
        decoder_layer_sizes=[4], activation="tanh", weight_init="xavier"),
     (5, 6)),
    ("vae_gaussian", jl.VariationalAutoencoder(
        n_in=6, n_out=3, encoder_layer_sizes=[5], decoder_layer_sizes=[5, 4],
        activation="relu", pzx_activation="tanh",
        reconstruction_distribution="gaussian", weight_init="xavier"),
     (5, 6)),
]


def _layer_input(spec, seed=1):
    if spec == "ids":
        return np.random.default_rng(seed).integers(0, 10, (6, 1)) \
            .astype(np.float32)
    if spec == "onehot":
        return _onehot(seed, 6, 10)
    return _x(seed, *spec)


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in
                                                   LAYER_CASES])
def test_layer_forward_and_json_match_jax(case):
    _, jlayer, spec = case
    player = _port_layer(jlayer)
    assert type(player).__name__ == type(jlayer).__name__
    assert from_jsonable(jax_json(jlayer)) == player
    jp = _jparams(jlayer)
    assert sorted(jp) == sorted(player.init_params(
        torch.Generator().manual_seed(0)))
    x = _layer_input(spec)
    want, _ = jlayer.forward(jp, jlayer.init_state(), jnp.asarray(x))
    got, _ = player.forward(_t(jp), {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_integer_ids_and_model_cast_keep_ids():
    """Integer ids stay integers through the network's input cast (a bf16
    round trip corrupts ids >= 257)."""
    jnet = _jmln([jl.EmbeddingLayer(n_out=4, activation="identity"),
                  jl.OutputLayer(n_out=3, loss="mcxent",
                                 activation="softmax")], 1000)
    pnet = _port_mln(jnet, dtype=torch.bfloat16)
    ids = np.array([[3], [300], [999], [257]], np.int64)
    got = pnet.output(ids)
    want = np.asarray(jnet.output(ids))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    emb, _ = pnet.layers[0].forward(pnet.params[0], {},
                                    pnet._as_tensor(ids))
    np.testing.assert_array_equal(emb.numpy(),
                                  pnet.params[0]["W"][[3, 300, 999,
                                                       257]].numpy())


def test_autoencoder_decode_and_rbm_props_match_jax():
    jae = jl.AutoEncoder(n_in=5, n_out=4, activation="tanh",
                         weight_init="xavier")
    jp = _jparams(jae, 3)
    h = _x(4, 6, 4)
    np.testing.assert_allclose(
        _port_layer(jae).decode(_t(jp), torch.from_numpy(h)).numpy(),
        np.asarray(jae.decode(jp, jnp.asarray(h))), **TOL)
    for visible in ("binary", "gaussian"):
        jr = jl.RBM(n_in=5, n_out=4, visible_unit=visible,
                    weight_init="xavier")
        jp = _jparams(jr, 5)
        pr = _port_layer(jr)
        v = _x(6, 6, 5, unit=True)
        np.testing.assert_allclose(
            pr.propup(_t(jp), torch.from_numpy(v)).numpy(),
            np.asarray(jr.propup(jp, jnp.asarray(v))), **TOL)
        np.testing.assert_allclose(
            pr.propdown(_t(jp), torch.from_numpy(h)).numpy(),
            np.asarray(jr.propdown(jp, jnp.asarray(h))), **TOL)


@pytest.mark.parametrize("dist", ["bernoulli", "gaussian"])
def test_vae_reconstruct_and_regularizable_match_jax(dist):
    jv = jl.VariationalAutoencoder(n_in=6, n_out=3, encoder_layer_sizes=[5],
                                   decoder_layer_sizes=[5],
                                   reconstruction_distribution=dist,
                                   weight_init="xavier")
    pv = _port_layer(jv)
    jp = _jparams(jv, 2)
    x = _x(7, 5, 6, unit=True)
    np.testing.assert_allclose(
        pv.reconstruct(_t(jp), torch.from_numpy(x)).numpy(),
        np.asarray(jv.reconstruct(jp, jnp.asarray(x))), **TOL)
    assert pv.regularizable() == jv.regularizable()
    shapes = {k: tuple(v.shape) for k, v in pv.init_params(
        torch.Generator().manual_seed(1)).items()}
    assert shapes == {k: tuple(v.shape) for k, v in jp.items()}


# (id, JAX layer, input) for the noise-free pretrain losses
PRETRAIN_CASES = [
    ("autoencoder_mse_corruption0", jl.AutoEncoder(
        n_in=6, n_out=4, corruption_level=0.0, loss="mse",
        activation="sigmoid", weight_init="xavier"), False),
    ("autoencoder_xent_no_generator", jl.AutoEncoder(
        n_in=6, n_out=4, corruption_level=0.3, loss="xent",
        activation="sigmoid", weight_init="xavier"), True),
    ("rbm_binary", jl.RBM(n_in=6, n_out=4, weight_init="xavier"), True),
    ("rbm_gaussian", jl.RBM(n_in=6, n_out=4, visible_unit="gaussian",
                            weight_init="xavier"), False),
    ("vae_bernoulli_eps0", jl.VariationalAutoencoder(
        n_in=6, n_out=3, encoder_layer_sizes=[5], decoder_layer_sizes=[5],
        activation="tanh", weight_init="xavier"), True),
    ("vae_gaussian_eps0", jl.VariationalAutoencoder(
        n_in=6, n_out=3, encoder_layer_sizes=[5], decoder_layer_sizes=[5],
        activation="tanh", reconstruction_distribution="gaussian",
        num_samples=2, weight_init="xavier"), False),
]


@pytest.mark.parametrize("case", PRETRAIN_CASES, ids=[c[0] for c in
                                                      PRETRAIN_CASES])
def test_pretrain_loss_and_gradients_match_jax(case):
    name, jlayer, unit = case
    player = _port_layer(jlayer)
    jp = _jparams(jlayer, 4)
    x = _x(8, 7, 6, unit=unit)
    # corruption 0 draws nothing from the key; the VAE's ε is 0 without
    # one, and so is the port's without a generator
    key = jax.random.PRNGKey(1) if name.startswith("autoencoder_mse") \
        else None
    jloss, jgrad = jax.value_and_grad(
        lambda p: jlayer.pretrain_loss(p, jnp.asarray(x), key))(jp)
    leaves = {k: v.requires_grad_(True) for k, v in _t(jp).items()}
    gen = torch.Generator().manual_seed(1) if key is not None else None
    ploss = player.pretrain_loss(leaves, torch.from_numpy(x), gen)
    pgrad = torch.autograd.grad(ploss, list(leaves.values()))
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), **TOL)
    for k, g in zip(leaves, pgrad):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("k", [1, 2])
def test_cd_gradient_non_binary_hidden_matches_jax(k):
    jr = jl.RBM(n_in=6, n_out=4, hidden_unit="gaussian", k=k,
                weight_init="xavier")
    jp = _jparams(jr, 6)
    v = _x(9, 8, 6, unit=True)
    want = jr.cd_gradient(jp, jnp.asarray(v), jax.random.PRNGKey(0))
    got = _port_layer(jr).cd_gradient(_t(jp), torch.from_numpy(v), None)
    for name in ("W", "b", "vb"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), **TOL)


def test_cd_gradient_binary_hidden_is_seeded_and_sampled():
    r = _port_layer(jl.RBM(n_in=6, n_out=40, weight_init="xavier"))
    p = _t(_jparams(jl.RBM(n_in=6, n_out=40, weight_init="xavier"), 1))
    v = torch.from_numpy(_x(2, 64, 6, unit=True))
    a = r.cd_gradient(p, v, torch.Generator().manual_seed(5))
    b = r.cd_gradient(p, v, torch.Generator().manual_seed(5))
    c = r.cd_gradient(p, v, torch.Generator().manual_seed(6))
    for name in a:
        assert torch.equal(a[name], b[name])
    assert not torch.equal(a["W"], c["W"])


def _jax_elbo(jv, jp, x, eps_list):
    """The negative ELBO of the JAX layer's ``pretrain_loss`` formula on
    the given ε draws, through its own ``_encode`` / ``_decode``."""
    mu, logvar = jv._encode(jp, x)
    total = 0.0
    for eps in eps_list:
        out = jv._decode(jp, mu + jnp.exp(0.5 * logvar) * eps)
        if jv.reconstruction_distribution == "gaussian":
            rmu, rlv = out[:, :jv.n_in], out[:, jv.n_in:]
            nll = 0.5 * jnp.sum(rlv + (x - rmu) ** 2 / jnp.exp(rlv)
                                + jnp.log(2 * jnp.pi), axis=-1)
        else:
            nll = jnp.sum(jnp.maximum(out, 0) - out * x +
                          jnp.log1p(jnp.exp(-jnp.abs(out))), axis=-1)
        total = total + jnp.mean(nll)
    kl = -0.5 * jnp.mean(jnp.sum(1 + logvar - mu ** 2 - jnp.exp(logvar),
                                 axis=-1))
    return total / len(eps_list) + kl


@pytest.mark.parametrize("dist", ["bernoulli", "gaussian"])
def test_vae_elbo_at_numpy_eps_matches_jax(dist):
    jv = jl.VariationalAutoencoder(n_in=6, n_out=3, encoder_layer_sizes=[5],
                                   decoder_layer_sizes=[5], num_samples=2,
                                   reconstruction_distribution=dist,
                                   activation="tanh", weight_init="xavier")
    jp = _jparams(jv, 8)
    x = _x(10, 7, 6, unit=True)
    eps = [_x(11 + s, 7, 3) for s in range(2)]
    want = _jax_elbo(jv, jp, jnp.asarray(x), [jnp.asarray(e) for e in eps])
    got = _port_layer(jv)._elbo(_t(jp), torch.from_numpy(x),
                                [torch.from_numpy(e) for e in eps])
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_noisy_pretrain_losses_are_deterministic_per_seed():
    x = torch.from_numpy(_x(12, 16, 6, unit=True))
    for jlayer in (jl.AutoEncoder(n_in=6, n_out=4, corruption_level=0.4,
                                  weight_init="xavier"),
                   jl.VariationalAutoencoder(n_in=6, n_out=3,
                                             encoder_layer_sizes=[5],
                                             decoder_layer_sizes=[5],
                                             weight_init="xavier")):
        layer = _port_layer(jlayer)
        p = _t(_jparams(jlayer, 2))
        loss = lambda s: float(layer.pretrain_loss(
            p, x, torch.Generator().manual_seed(s)))
        assert loss(7) == loss(7)
        assert loss(7) != loss(8)


def _binomial_ok(keep, n, p):
    """The kept count within 5 standard deviations of n·p."""
    return abs(keep - n * p) <= 5 * np.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("p", [0.3, 0.8])
def test_dropout_layer_keep_rate_and_scale(p):
    layer = _port_layer(jl.DropoutLayer(drop_out=p))
    x = torch.ones(200, 100)
    y, _ = layer.forward({}, {}, x, train=True,
                         gen=torch.Generator().manual_seed(3))
    kept = y != 0
    assert _binomial_ok(int(kept.sum()), x.numel(), p)
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / p, rtol=1e-6)
    y2, _ = layer.forward({}, {}, x, train=True,
                          gen=torch.Generator().manual_seed(3))
    assert torch.equal(y, y2)


def test_autoencoder_corruption_keep_rate():
    """The corrupted input keeps each entry with probability 1 − c: the
    loss equals the corruption-free formula on the mask the generator
    draws."""
    c = 0.3
    jae = jl.AutoEncoder(n_in=50, n_out=8, corruption_level=c,
                         weight_init="xavier")
    layer = _port_layer(jae)
    p = _t(_jparams(jae, 1))
    x = torch.from_numpy(_x(13, 64, 50, unit=True))
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(4)) \
        < 1 - c
    assert _binomial_ok(int(keep.sum()), x.numel(), 1 - c)
    plain = _port_layer(jl.AutoEncoder(n_in=50, n_out=8,
                                       corruption_level=0.0))
    h = layer.encode(p, x * keep)
    recon = h @ p["W"].t() + p["vb"]
    want = ((x - torch.sigmoid(recon)) ** 2).mean()
    got = layer.pretrain_loss(p, x, torch.Generator().manual_seed(4))
    assert plain.pretrain_loss(p, x, None) != got
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------- center loss
def test_center_loss_and_update_matches_jax():
    jc = jl.CenterLossOutputLayer(n_in=5, n_out=4, alpha=0.3, lambda_=0.2)
    centers = _x(14, 4, 5)
    f = _x(15, 6, 5)
    labels = np.eye(4, dtype=np.float32)[[0, 1, 1, 3, 0, 1]]   # no class 2
    want_l, want_s = jc.center_loss_and_update(
        {"centers": jnp.asarray(centers)}, jnp.asarray(f),
        jnp.asarray(labels))
    got_l, got_s = _port_layer(jc).center_loss_and_update(
        {"centers": torch.from_numpy(centers)}, torch.from_numpy(f),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)
    np.testing.assert_allclose(got_s["centers"].numpy(),
                               np.asarray(want_s["centers"]), **TOL)
    np.testing.assert_array_equal(got_s["centers"][2].numpy(), centers[2])


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_center_loss_head_steps_match_jax(updater):
    jnet = _jmln([jl.DenseLayer(n_out=5),
                  jl.CenterLossOutputLayer(n_out=3, loss="mcxent",
                                           activation="softmax", alpha=0.2,
                                           lambda_=0.1)], 4, updater=updater)
    pnet = _port_mln(jnet)
    x, y = _x(16, 8, 4), _onehot(17, 8, 3)
    for step in range(3):
        jnet._fit_batch(JaxDataSet(x, y))
        pnet._fit_batch(DataSet(x, y))
        np.testing.assert_allclose(float(pnet.score_value),
                                   float(jnet.score_value), **TOL)
        _assert_params(pnet, jnet, what=f"step {step}")
        np.testing.assert_allclose(pnet.state[1]["centers"].numpy(),
                                   np.asarray(jnet.state[1]["centers"]),
                                   **TOL)
    assert float(pnet.state[1]["centers"].abs().sum()) > 0
    np.testing.assert_allclose(pnet.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), **TOL)


# ------------------------------------------------------------- pretrain
def _pretrain_net(updater):
    return _jmln([jl.AutoEncoder(n_out=6, corruption_level=0.0, loss="mse"),
                  jl.RBM(n_out=5),
                  jl.OutputLayer(n_out=3, loss="mcxent",
                                 activation="softmax")], 8, updater=updater,
                 lr=0.05, activation="sigmoid")


@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_mln_pretrain_matches_jax(updater):
    jnet = _pretrain_net(updater)
    pnet = _port_mln(jnet)
    batches = [(_x(20 + i, 10, 8, unit=True), _onehot(30 + i, 10, 3))
               for i in range(3)]
    jnet.pretrain([JaxDataSet(*b) for b in batches], num_epochs=1)
    pnet.pretrain([DataSet(*b) for b in batches], num_epochs=1)
    assert pnet.iteration == jnet.iteration == 6
    np.testing.assert_allclose(float(pnet.score_value),
                               float(jnet.score_value), **TOL)
    _assert_params(pnet, jnet)
    # the supervised head is untouched by pretraining
    np.testing.assert_array_equal(pnet.params[2]["W"].numpy(),
                                  np.asarray(jnet.params[2]["W"]))


def test_mln_fit_refuses_a_pretrain_configuration():
    jnet = _jmln([jl.AutoEncoder(n_out=4, corruption_level=0.0),
                  jl.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax")], 5, pretrain=True)
    pnet = _port_mln(jnet)
    ds = DataSet(_x(1, 4, 5), _onehot(2, 4, 2))
    with pytest.raises(ValueError, match=r"call pretrain\(data\)"):
        pnet.fit(ds)
    pnet.pretrain(ds)
    assert pnet.iteration == 1


def test_vae_pretrain_is_deterministic_and_learns():
    jnet = _jmln([jl.VariationalAutoencoder(n_out=3,
                                            encoder_layer_sizes=[8],
                                            decoder_layer_sizes=[8]),
                  jl.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax")], 6, updater="adam",
                 lr=0.02)
    data = [DataSet(_x(40, 32, 6, unit=True), _onehot(41, 32, 2))]
    a, b = _port_mln(jnet), _port_mln(jnet)
    a.pretrain(data, num_epochs=1)
    first = float(a.score_value)
    a.pretrain(data, num_epochs=30)
    b.pretrain(data, num_epochs=31)
    np.testing.assert_array_equal(a.params_flat(), b.params_flat())
    assert float(a.score_value) < first


def _ae_graph(updater="sgd"):
    g = (JaxNNC.Builder().seed(9).learning_rate(0.05).updater(updater)
         .weight_init("xavier").activation("sigmoid").graph_builder()
         .add_inputs("in")
         .add_layer("ae1", jl.AutoEncoder(n_out=6, corruption_level=0.0,
                                          loss="mse"), "in")
         .add_layer("rbm", jl.RBM(n_out=4), "ae1")
         .add_layer("out", jl.OutputLayer(n_out=2, loss="mcxent",
                                          activation="softmax"), "rbm")
         .set_outputs("out")
         .set_input_types(JaxInputType.feed_forward(8)).build())
    return JaxGraph(g).init()


@pytest.mark.parametrize("updater", ["sgd", "nesterovs"])
def test_graph_pretrain_matches_jax(updater):
    jg = _ae_graph(updater)
    pg = _port_graph(jg)
    batches = [(_x(50 + i, 12, 8, unit=True), _onehot(60 + i, 12, 2))
               for i in range(2)]
    jg.pretrain([JaxDataSet(*b) for b in batches], num_epochs=2)
    pg.pretrain([DataSet(*b) for b in batches], num_epochs=2)
    assert pg.iteration == jg.iteration == 8
    np.testing.assert_allclose(float(pg.score_value),
                               float(jg.score_value), **TOL)
    _assert_params(pg, jg)
    jg.pretrain_layer("rbm", [JaxDataSet(*batches[0])])
    pg.pretrain_layer("rbm", [DataSet(*batches[0])])
    _assert_params(pg, jg)
    with pytest.raises(ValueError, match="not pretrainable"):
        pg.pretrain_layer("out", [])
    with pytest.raises(ValueError, match="Unknown vertex"):
        pg.pretrain_layer("missing", [])


# ------------------------------------------------------ transfer learning
def _src_mln(updater, l2=1e-3):
    jnet = _jmln([jl.DenseLayer(n_out=8), jl.DenseLayer(n_out=6),
                  jl.OutputLayer(n_out=3, loss="mcxent",
                                 activation="softmax")], 4, updater=updater,
                 lr=0.05, l2=l2)
    return jnet, _port_mln(jnet)


@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "adam", "rmsprop"])
def test_transfer_builder_matches_jax_and_freezes_exactly(updater):
    jsrc, psrc = _src_mln(updater)
    x, y = _x(70, 16, 4), _onehot(71, 16, 3)
    jsrc._fit_batch(JaxDataSet(x, y))
    psrc._fit_batch(DataSet(x, y))

    ftc_kw = dict(learning_rate=0.1, l2=2e-3, seed=77)
    jnew = (jtr.TransferLearning.Builder(jsrc)
            .fine_tune_configuration(jtr.FineTuneConfiguration(**ftc_kw))
            .set_feature_extractor(0).remove_output_layer()
            .add_layer(jl.OutputLayer(n_out=2, loss="mcxent",
                                      activation="softmax")).build())
    pnew = (TransferLearning.Builder(psrc)
            .fine_tune_configuration(FineTuneConfiguration(**ftc_kw))
            .set_feature_extractor(0).remove_output_layer()
            .add_layer(_port_layer(jl.OutputLayer(
                n_out=2, loss="mcxent", activation="softmax"))).build())
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert pnew.frozen_until == jnew.frozen_until == 0
    for i in (0, 1):
        np.testing.assert_array_equal(pnew.params[i]["W"].numpy(),
                                      psrc.params[i]["W"].numpy())
        assert pnew.params[i]["W"].data_ptr() != \
            psrc.params[i]["W"].data_ptr()
    # the appended head is initialized by each package's own generator:
    # give the port JAX's to hold the fine-tune steps against it
    with torch.no_grad():
        for k, a in jnew.params[2].items():
            pnew.params[2][k].copy_(torch.from_numpy(np.array(a)))
    frozen = {k: v.clone() for k, v in pnew.params[0].items()}
    jfrozen = _np(jnew.params[0])
    y2 = _onehot(72, 16, 2)
    for step in range(3):
        jnew._fit_batch(JaxDataSet(x, y2))
        pnew._fit_batch(DataSet(x, y2))
        _assert_params(pnew, jnew, what=f"step {step}")
    for k in frozen:
        assert torch.equal(pnew.params[0][k], frozen[k]), k
        np.testing.assert_array_equal(np.asarray(jnew.params[0][k]),
                                      jfrozen[k])
    assert not torch.equal(pnew.params[1]["W"], psrc.params[1]["W"])


def test_transfer_n_out_replace_and_helper_match_jax():
    jsrc, psrc = _src_mln("sgd")
    jnew = jtr.TransferLearning.Builder(jsrc).n_out_replace(0, 10).build()
    pnew = TransferLearning.Builder(psrc).n_out_replace(0, 10).build()
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert tuple(pnew.params[1]["W"].shape) == (10, 6)
    np.testing.assert_array_equal(pnew.params[2]["W"].numpy(),
                                  np.asarray(jnew.params[2]["W"]))
    x, y = _x(73, 6, 4), _onehot(74, 6, 3)
    want = jtr.TransferLearningHelper(jsrc, 1).featurize(JaxDataSet(x, y))
    got = TransferLearningHelper(psrc, 1).featurize(DataSet(x, y))
    np.testing.assert_allclose(got.features, np.asarray(want.features),
                               **TOL)


def _small_graph(updater="sgd", seed=7):
    g = (JaxNNC.Builder().seed(seed).learning_rate(0.1).updater(updater)
         .weight_init("xavier").activation("tanh").graph_builder()
         .add_inputs("in")
         .add_layer("d1", jl.DenseLayer(n_out=8), "in")
         .add_layer("d2", jl.DenseLayer(n_out=6), "d1")
         .add_layer("out", jl.OutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"), "d2")
         .set_outputs("out")
         .set_input_types(JaxInputType.feed_forward(4)).build())
    jg = JaxGraph(g).init()
    return jg, _port_graph(jg)


@pytest.mark.parametrize("updater", ["sgd", "nesterovs", "adam", "rmsprop"])
def test_graph_builder_matches_jax_and_freezes_exactly(updater):
    jsrc, psrc = _small_graph(updater)
    x, y = _x(80, 16, 4), _onehot(81, 16, 3)
    jsrc.fit_batch(JaxDataSet(x, y))
    psrc.fit_batch(DataSet(x, y))

    def build(tl, ftc, head):
        return (tl.TransferLearning.GraphBuilder(
            jsrc if tl is jtr else psrc)
            .fine_tune_configuration(ftc(learning_rate=0.05, seed=3))
            .set_feature_extractor("d1")
            .remove_vertex_and_connections("out")
            .add_layer("new_out", head, "d2").set_outputs("new_out")
            .build())

    import deeplearning4j_tpu_torch.nn.transfer as ptr
    head = jl.OutputLayer(n_out=2, loss="mcxent", activation="softmax")
    jnew = build(jtr, jtr.FineTuneConfiguration, head)
    pnew = build(ptr, FineTuneConfiguration, _port_layer(head))
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert pnew.frozen_vertices == jnew.frozen_vertices == {"d1"}
    for v in ("d1", "d2"):
        for k in pnew.params[v]:
            np.testing.assert_array_equal(pnew.params[v][k].numpy(),
                                          psrc.params[v][k].numpy())
    with torch.no_grad():
        for k, a in jnew.params["new_out"].items():
            pnew.params["new_out"][k].copy_(torch.from_numpy(np.array(a)))
    frozen = {k: v.clone() for k, v in pnew.params["d1"].items()}
    y2 = _onehot(82, 16, 2)
    for step in range(3):
        jnew.fit_batch(JaxDataSet(x, y2))
        pnew.fit_batch(DataSet(x, y2))
        _assert_params(pnew, jnew, what=f"step {step}")
    for k in frozen:
        assert torch.equal(pnew.params["d1"][k], frozen[k]), k


GRAPH_SURGERY = {
    "n_out_replace": lambda b, L: b.n_out_replace("d1", 10),
    "keep_connections": lambda b, L: b.remove_vertex_keep_connections("d2")
    .add_layer("d2", L.DenseLayer(n_out=5, activation="relu"), "d1"),
}


@pytest.mark.parametrize("surgery", sorted(GRAPH_SURGERY))
def test_graph_builder_surgery_matches_jax(surgery):
    from deeplearning4j_tpu_torch.nn.conf import layers as pl
    jsrc, psrc = _small_graph()
    op = GRAPH_SURGERY[surgery]
    jnew = op(jtr.TransferLearning.GraphBuilder(jsrc), jl).build()
    pnew = op(TransferLearning.GraphBuilder(psrc), pl).build()
    assert pnew.conf.to_json() == jnew.conf.to_json()
    for v, p in jnew.params.items():
        for k, a in p.items():
            assert tuple(pnew.params[v][k].shape) == a.shape
    # "out" keeps its width under both: copied
    np.testing.assert_array_equal(pnew.params["out"]["b"].numpy(),
                                  psrc.params["out"]["b"].numpy())


def test_graph_builder_refuses_broken_surgery():
    _, psrc = _small_graph()
    for bad in (lambda b: b.remove_vertex_and_connections("nope"),
                lambda b: b.remove_vertex_and_connections("out"),
                lambda b: b.set_feature_extractor("missing"),
                lambda b: b.remove_vertex_and_connections("d1")):
        with pytest.raises(ValueError):
            bad(TransferLearning.GraphBuilder(psrc)).build()


def test_graph_helper_featurize_and_fit_featurized_match_jax():
    jsrc, psrc = _small_graph("adam")
    jnew = jtr.TransferLearning.GraphBuilder(jsrc) \
        .set_feature_extractor("d1").build()
    pnew = TransferLearning.GraphBuilder(psrc) \
        .set_feature_extractor("d1").build()
    jh = jtr.GraphTransferLearningHelper(jnew)
    ph = GraphTransferLearningHelper(pnew)
    assert ph.frontier == jh.frontier == ["d1"]
    assert set(ph.unfrozen_graph().conf.vertices) == {"d2", "out"}
    x, y = _x(90, 16, 4), _onehot(91, 16, 3)
    jf = jh.featurize(JaxDataSet(x, y))
    pf = ph.featurize(DataSet(x, y))
    np.testing.assert_allclose(pf.features[0], np.asarray(jf.features[0]),
                               **TOL)
    np.testing.assert_allclose(ph.output_from_featurized(pf)[0],
                               pnew.output(x)[0], **TOL)
    d1 = {k: v.clone() for k, v in pnew.params["d1"].items()}
    for _ in range(3):
        jh.fit_featurized(jf)
        ph.fit_featurized(pf)
    _assert_params(pnew, jnew)
    for k in d1:
        assert torch.equal(pnew.params["d1"][k], d1[k])
    assert GraphTransferLearningHelper(psrc, "d2").frozen == {"d1", "d2"}


# ------------------------------------------------------- early stopping
def _es_pair(lr):
    jnet = _jmln([jl.DenseLayer(n_out=6),
                  jl.OutputLayer(n_out=3, loss="mcxent",
                                 activation="softmax")], 4, updater="sgd",
                 lr=lr)
    return jnet, _port_mln(jnet)


@pytest.mark.parametrize("lr,terms", [
    (0.1, "max_epochs"), (0.0, "patience"), (1e4, "max_score")])
def test_early_stopping_matches_jax(lr, terms):
    """lr 0: nothing improves and the patience ends the run; lr 1e4: the
    score diverges and the iteration condition ends it (the two packages'
    f32 roundings, multiplied by 1e4, part their parameters, so only the
    run's course is compared there)."""
    jnet, pnet = _es_pair(lr)
    train = [(_x(100 + i, 12, 4), _onehot(110 + i, 12, 3))
             for i in range(3)]
    held = [(_x(120, 12, 4), _onehot(121, 12, 3))]

    def config(m, ds_cls, it_cls):
        iters = []
        epochs = [m.MaxEpochsTerminationCondition(6)]
        if terms == "patience":
            epochs.insert(0, m.ScoreImprovementEpochTerminationCondition(
                patience=1))
        if terms == "max_score":
            iters = [m.MaxScoreIterationTerminationCondition(3.0)]
        return m.EarlyStoppingConfiguration(
            score_calculator=m.DataSetLossCalculator(
                it_cls([ds_cls(*h) for h in held])),
            epoch_terminations=epochs, iteration_terminations=iters)

    jr = jes.EarlyStoppingTrainer(
        config(jes, JaxDataSet, jit_.ListDataSetIterator), jnet,
        [JaxDataSet(*t) for t in train]).fit()
    pr = EarlyStoppingTrainer(
        config(pes, DataSet, ListDataSetIterator), pnet,
        [DataSet(*t) for t in train]).fit()
    assert (pr.termination_reason, pr.termination_details,
            pr.best_model_epoch, pr.total_epochs) == \
        (jr.termination_reason, jr.termination_details,
         jr.best_model_epoch, jr.total_epochs)
    assert sorted(pr.score_vs_epoch) == sorted(jr.score_vs_epoch)
    assert pnet.iteration == jnet.iteration
    if terms == "max_score":
        assert pr.termination_details == \
            "MaxScoreIterationTerminationCondition"
        return
    for e, s in jr.score_vs_epoch.items():
        np.testing.assert_allclose(pr.score_vs_epoch[e], s, **TOL)
    if jr.best_model_epoch >= 0:
        _assert_params(pr.best_model, jr.best_model)
    _assert_params(pnet, jnet)


def test_local_file_saver_zips_cross_both_ways(tmp_path):
    """The port's saver writes what the JAX package restores, and a JAX
    checkpoint with autoencoder, RBM, VAE and center-loss layers (its
    centers in the layer state) restores in the port."""
    jnet = _jmln([jl.AutoEncoder(n_out=7), jl.RBM(n_out=6),
                  jl.VariationalAutoencoder(n_out=5,
                                            encoder_layer_sizes=[6],
                                            decoder_layer_sizes=[6]),
                  jl.DenseLayer(n_out=4),
                  jl.CenterLossOutputLayer(n_out=3, loss="mcxent",
                                           activation="softmax",
                                           lambda_=0.1)], 8, updater="adam")
    x, y = _x(130, 10, 8, unit=True), _onehot(131, 10, 3)
    for _ in range(2):
        jnet._fit_batch(JaxDataSet(x, y))
    ModelSerializer.write_model(jnet, tmp_path / "jax.zip")
    pnet = restore_multi_layer_network(tmp_path / "jax.zip", device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    _assert_params(pnet, jnet, tol=dict(rtol=0, atol=0))
    np.testing.assert_array_equal(pnet.state[4]["centers"].numpy(),
                                  np.asarray(jnet.state[4]["centers"]))
    assert pnet.iteration == jnet.iteration
    for _ in range(2):
        jnet._fit_batch(JaxDataSet(x, y))
        pnet._fit_batch(DataSet(x, y))
    _assert_params(pnet, jnet)
    saver = LocalFileModelSaver(tmp_path / "es", device="cpu")
    saver.save_best_model(pnet, 0.5)
    back = ModelSerializer.restore_multi_layer_network(
        tmp_path / "es" / "bestModel.zip")
    _assert_params(pnet, back, tol=dict(rtol=0, atol=0))
    np.testing.assert_array_equal(np.asarray(back.state[4]["centers"]),
                                  pnet.state[4]["centers"].numpy())
    again = saver.get_best_model()
    assert isinstance(again, MultiLayerNetwork)
    np.testing.assert_array_equal(again.params_flat(), pnet.params_flat())
    assert saver.get_latest_model() is None


def test_restore_model_guesses_the_graph(tmp_path):
    jg, pg = _small_graph()
    write_model(pg, tmp_path / "g.zip")
    got = restore_model(tmp_path / "g.zip", device="cpu")
    assert type(got).__name__ == "ComputationGraph"
    np.testing.assert_array_equal(got.params_flat(), pg.params_flat())


def test_in_memory_saver_keeps_a_clone():
    _, pnet = _es_pair(0.1)
    saver = InMemoryModelSaver()
    saver.save_best_model(pnet, 1.0)
    pnet._fit_batch(DataSet(_x(1, 4, 4), _onehot(2, 4, 3)))
    assert not np.array_equal(saver.get_best_model().params_flat(),
                              pnet.params_flat())


# ------------------------------------------------------- gradient checks
GC_CASES = [
    ("embedding", [jl.EmbeddingLayer(n_in=10, n_out=4,
                                     activation="identity")], 10, "ids",
     None),
    ("autoencoder", [jl.AutoEncoder(n_out=4, activation="sigmoid")], 5,
     (4, 5), None),
    ("rbm", [jl.RBM(n_out=4)], 3, (5, 3), None),
    ("vae", [jl.VariationalAutoencoder(n_out=4, encoder_layer_sizes=[6],
                                       decoder_layer_sizes=[6])], 5, (4, 5),
     None),
    ("dropout_layer", [jl.DenseLayer(n_out=5),
                       jl.DropoutLayer(drop_out=0.5)], 4, (6, 4), None),
    ("center_loss", [jl.DenseLayer(n_out=5)], 4, (6, 4), "center"),
    ("loss_layer", [jl.DenseLayer(n_out=3, activation="identity")], 4,
     (6, 4), "loss"),
]


@pytest.mark.parametrize("case", GC_CASES, ids=[c[0] for c in GC_CASES])
def test_gradient_check_new_layers_f64(case):
    _, layers, n_in, spec, head = case
    rng = np.random.default_rng(42)
    if head == "center":
        head_layer = jl.CenterLossOutputLayer(n_out=3, loss="mcxent",
                                              activation="softmax",
                                              lambda_=0.1)
    elif head == "loss":
        head_layer = jl.LossLayer(loss="mse", activation="identity")
    else:
        head_layer = jl.OutputLayer(n_out=3, loss="mcxent",
                                    activation="softmax")
    b = (JaxNNC.Builder().seed(42).learning_rate(0.1).updater("sgd")
         .weight_init("xavier").activation("tanh").list())
    for layer in layers + [head_layer]:
        b.layer(layer)
    jconf = b.set_input_type(JaxInputType.feed_forward(n_in)).build()
    net = MultiLayerNetwork(
        MultiLayerConfiguration.from_json(jconf.to_json()),
        compute_dtype=torch.float64, device="cpu").init()
    n = 6 if spec in ("ids",) else spec[0]
    x = rng.integers(0, 10, (6, 1)).astype(np.float64) if spec == "ids" \
        else rng.normal(size=spec)
    y = rng.normal(size=(n, 3)) if head == "loss" else \
        np.eye(3)[rng.integers(0, 3, n)]
    ds = DataSet(x, y)
    if head == "center":            # nonzero centers
        net.state[-1]["centers"] = torch.from_numpy(rng.normal(size=(3, 5)))
    assert net.params_flat().dtype == np.float64
    assert check_gradients(net, ds, subsample=60)


# -------------------------------------------------------------- solvers
def _solver_pair(algo):
    jnet = _jmln([jl.DenseLayer(n_out=6),
                  jl.OutputLayer(n_out=2, loss="mcxent",
                                 activation="softmax")], 3, seed=4,
                 dtype=jnp.float64)
    conf = jnet.conf
    conf.optimization_algo = algo
    jnet = JaxMLN(conf, compute_dtype=jnp.float64).init()
    pconf = MultiLayerConfiguration.from_json(conf.to_json())
    pnet = network_from_numpy(pconf, [_np(p) for p in jnet.params],
                              device="cpu", compute_dtype=torch.float64)
    return jnet, pnet


def _solver_data():
    rng = np.random.default_rng(150)
    x = rng.normal(size=(40, 3))
    y = np.eye(2)[np.argmax(x @ rng.normal(size=(3, 2)), axis=1)]
    return x, y


@pytest.mark.parametrize("solver", ["LBFGS", "ConjugateGradient",
                                    "LineGradientDescent"])
def test_solver_final_scores_match_jax(solver):
    jnet, pnet = _solver_pair("stochastic_gradient_descent")
    x, y = _solver_data()
    want = getattr(jsol, solver)(max_iterations=8).optimize(
        jnet, JaxDataSet(x, y))
    got = getattr(psol, solver)(max_iterations=8).optimize(pnet,
                                                           DataSet(x, y))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(pnet.params_flat(), jnet.params_flat(),
                               rtol=1e-4, atol=1e-6)
    assert got < jnet.score(JaxDataSet(x, y)) + 1e-12
    assert got == pnet.score_value


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient",
                                  "line_gradient_descent"])
def test_solver_builder_dispatch_matches_jax(algo):
    jnet, pnet = _solver_pair(algo)
    x, y = _solver_data()
    want = jsol.Solver.Builder().model(jnet).build().optimize(
        JaxDataSet(x, y), max_iterations=4)
    got = Solver.Builder().model(pnet).build().optimize(DataSet(x, y),
                                                        max_iterations=4)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------ iterators
def _batches(n=5, b=4, seed=160):
    return [(_x(seed + i, b, 3), _onehot(seed + 50 + i, b, 2))
            for i in range(n)]


def test_sampling_iterator_draws_the_jax_batches():
    x, y = _x(170, 20, 3), _onehot(171, 20, 2)
    want = list(jit_.SamplingDataSetIterator(JaxDataSet(x, y), 6, 15,
                                             seed=3))
    got = list(SamplingDataSetIterator(DataSet(x, y), 6, 15, seed=3))
    assert [g.num_examples() for g in got] == [6, 6, 3]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.features, w.features)
        np.testing.assert_array_equal(g.labels, w.labels)


def test_multiple_epochs_iterator_replays_the_source():
    src = _batches(3)
    got = list(MultipleEpochsIterator(2, ListDataSetIterator(
        [DataSet(*b) for b in src])))
    want = list(jit_.MultipleEpochsIterator(2, jit_.ListDataSetIterator(
        [JaxDataSet(*b) for b in src])))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.features, w.features)


def test_async_iterator_copies_every_batch_in_order():
    src = [DataSet(*b) for b in _batches(5)]
    got = list(AsyncDataSetIterator(ListDataSetIterator(src), prefetch=2,
                                    device="cpu"))
    assert len(got) == 5
    for g, s in zip(got, src):
        assert torch.is_tensor(g.features)
        np.testing.assert_array_equal(g.features.numpy(), s.features)
        np.testing.assert_array_equal(g.labels.numpy(), s.labels)


class _Failing(DataSetIterator):
    def __init__(self, batches, fail_at):
        self.batches, self.fail_at = batches, fail_at

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise KeyError("source broke")
            yield b


def test_async_iterator_raises_the_source_exception():
    src = [DataSet(*b) for b in _batches(4)]
    seen = []
    with pytest.raises(KeyError, match="source broke"):
        for ds in AsyncDataSetIterator(_Failing(src, 2), device="cpu"):
            seen.append(ds)
    assert len(seen) == 2


def test_async_iterator_raises_when_the_device_copy_fails():
    """No host batch comes back: an array that cannot become a tensor is
    an error on the consumer's side (the JAX package's copy would hand the
    host batch on)."""
    bad = DataSet(np.array([[object()]], dtype=object), None)
    good = DataSet(*_batches(1)[0])
    it = AsyncDataSetIterator(ListDataSetIterator([good, bad]),
                              device="cpu")
    seen = []
    with pytest.raises(TypeError):
        for ds in it:
            seen.append(ds)
    assert len(seen) == 1 and torch.is_tensor(seen[0].features)


def test_async_iterator_queue_is_bounded_and_stops_with_the_consumer():
    produced = []

    class Counting(DataSetIterator):
        def __iter__(self):
            for b in _batches(20):
                produced.append(1)
                yield DataSet(*b)

    before = threading.active_count()
    it = iter(AsyncDataSetIterator(Counting(), prefetch=2, device="cpu"))
    next(it)
    time.sleep(0.3)
    # one consumed, two queued, one in the producer's hand
    assert len(produced) <= 4
    it.close()
    assert threading.active_count() == before
    assert len(produced) <= 5


def test_async_iterator_stages_floats_in_bf16_only():
    x = _x(180, 4, 3)
    ids = np.array([3, 300, 299, 1000])
    mask = np.ones((4,), np.float32)
    out = list(AsyncDataSetIterator(
        ListDataSetIterator([DataSet(x, ids, mask, None)]),
        stage_dtype=torch.bfloat16, device="cpu"))[0]
    assert out.features.dtype == torch.bfloat16
    assert out.labels.dtype == torch.int64
    np.testing.assert_array_equal(out.labels.numpy(), ids)
    assert out.features_mask.dtype == torch.float32
    np.testing.assert_array_equal(out.features.float().numpy(),
                                  torch.from_numpy(x).bfloat16().float())


def test_fit_through_the_async_iterator_matches_jax():
    jnet, pnet = _es_pair(0.1)
    src = [(_x(190 + i, 6, 4), _onehot(195 + i, 6, 3)) for i in range(3)]
    jnet.fit([JaxDataSet(*b) for b in src], num_epochs=2)
    pnet.fit([DataSet(*b) for b in src], num_epochs=2)
    assert pnet.iteration == jnet.iteration == 6
    _assert_params(pnet, jnet)
