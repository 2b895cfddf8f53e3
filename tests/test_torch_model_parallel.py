"""PyTorch port, tensor / pipeline / expert parallelism on the CPU: every
test of ``tests/test_tp_pp_ep.py`` but the sequence-parallel one
(``test_torch_sequence_parallel.py`` has it) mirrored on the port, each
mesh a list of CPU devices (several shards on one device, as on one
card); then the port's trainers against the JAX package's on the same
numpy weights (``utils/serializer.py``'s carry) and seeded data, the JAX
side on the conftest's 8 host devices: TP on a dense net at (2, 2) and on
a small LeNet-shaped conv net with l2 and a clipped gradient norm at (1,
2), EP at (2, 2), PP at 4 stages, the MoE layer's forward, capacity, JSON
and ``coefficients`` both ways.

Tolerances: rtol 1e-5 / atol 1e-6 on parameters after the steps (the
shards' partial products are summed in shard order, JAX's GSPMD sums in
its own; f32 either way); pipeline outputs at rtol 1e-5 / atol 1e-6 and
their gradients at the JAX test's rtol 1e-4 / atol 1e-6. The runs held
against JAX take sgd or nesterovs: adam divides each step by √v, and the
two libraries' f32 summation orders already part their solo adam steps
by ~2e-6 on these nets (the port's trainers are held to their own solo
adam steps at 1e-6 above)."""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.parallel import (
    ExpertParallelTrainer as JaxEPTrainer,
    MixtureOfExpertsLayer as JaxMoE,
    PipelineParallelTrainer as JaxPPTrainer,
    TensorParallelTrainer as JaxTPTrainer, make_mesh as jax_mesh)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.parallel import (
    ExpertParallelTrainer, MixtureOfExpertsLayer, P, PipelineParallelTrainer,
    ShardedTensor, TensorParallelTrainer, make_mesh, pipeline_apply,
    tp_param_specs)
from deeplearning4j_tpu_torch.utils import network_from_numpy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the workers of a parallel run share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(names, shape):
    return make_mesh(axis_names=names, shape=shape,
                     devices=[CPU] * int(np.prod(shape)))


def _dense_conf(builder=NeuralNetConfiguration, layers=None, seed=7,
                updater="adam"):
    ly = layers or (DenseLayer, OutputLayer)
    it = InputType if builder is NeuralNetConfiguration else JaxInputType
    return (builder.Builder().seed(seed).learning_rate(0.05)
            .updater(updater).weight_init("xavier").activation("relu")
            .list()
            .layer(ly[0](n_out=16))
            .layer(ly[0](n_out=16))
            .layer(ly[1](n_out=5, loss="mcxent", activation="softmax"))
            .set_input_type(it.feed_forward(12)).build())


def _dense_net(seed=7):
    return MultiLayerNetwork(_dense_conf(seed=seed), device="cpu").init()


def _batches(rng, n_batches, b, n_in, n_out):
    out = []
    for _ in range(n_batches):
        X = rng.normal(size=(b, n_in)).astype(np.float32)
        y = np.eye(n_out)[rng.integers(0, n_out, b)].astype(np.float32)
        out.append(DataSet(X, y))
    return out


def _port(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return network_from_numpy(conf, [{k: np.asarray(v) for k, v in
                                       p.items()} for p in jnet.params],
                              device="cpu")


def _close_params(tnet, jnet, rtol=1e-5, atol=1e-6):
    for i, (pt, pj) in enumerate(zip(tnet.params, jnet.params)):
        for k in pj:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"layer {i} {k}")


def _close_nets(a, b, rtol=1e-5, atol=1e-6):
    for i, (pa, pb) in enumerate(zip(a.params, b.params)):
        for k in pa:
            np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"layer {i} {k}")


# =================================================== mirrors of the oracle
class TestTensorParallel:
    def test_tp_matches_single_device(self, rng_np):
        ref, tp_net = _dense_net(), _dense_net()
        trainer = TensorParallelTrainer(tp_net, _mesh(("data", "model"),
                                                      (2, 2)))
        for ds in _batches(rng_np, 4, 8, 12, 5):
            ref._fit_batch(ds)
            trainer.fit_batch(ds)
        _close_nets(tp_net, ref)

    def test_dp_tp_full_composed_mesh(self, rng_np):
        ref, tp_net = _dense_net(), _dense_net()
        trainer = TensorParallelTrainer(tp_net, _mesh(("data", "model"),
                                                      (2, 4)))
        assert trainer.batch_axis == "data" and trainer.batch_divisor == 2
        for ds in _batches(rng_np, 3, 8, 12, 5):
            ref._fit_batch(ds)
            trainer.fit_batch(ds)
        w0 = trainer.params[0]["W"]
        assert isinstance(w0, ShardedTensor)
        assert w0.local((1, 3)).shape[1] == w0.shape[1] // 4
        _close_nets(tp_net, ref)

    def test_tp_params_actually_sharded(self):
        net = _dense_net()
        trainer = TensorParallelTrainer(net, _mesh(("data", "model"),
                                                   (1, 4)))
        trainer.shard_params()
        w0 = trainer.params[0]["W"]          # column-parallel: dim 1
        assert tuple(w0.local((0, 2)).shape) == (12, 4)
        w1 = trainer.params[1]["W"]          # row-parallel: dim 0
        assert tuple(w1.local((0, 1)).shape) == (4, 16)
        m = trainer.updater_state[0]["W"]["m"]
        assert tuple(m.local((0, 3)).shape) == (12, 4)
        assert torch.equal(w0.gather(), net.params[0]["W"])

    def test_tp_specs_alternate(self):
        specs = tp_param_specs(_dense_net())
        assert specs[0]["W"] == P(None, "model")
        assert specs[1]["W"] == P("model", None)
        assert specs[2] == {}


class TestPipelineParallel:
    def test_pipeline_apply_equals_sequential(self, rng_np):
        block = DenseLayer(n_in=10, n_out=10, activation="tanh",
                           weight_init="xavier")
        params = [block.init_params(torch.Generator().manual_seed(i))
                  for i in range(8)]
        stacked = {k: torch.stack([p[k] for p in params]) for k in params[0]}
        x = torch.as_tensor(rng_np.normal(size=(6, 4, 10)), dtype=torch.float32)
        fn = lambda p, a: block.forward(p, {}, a)[0]
        piped = pipeline_apply(fn, stacked, x, _mesh(("pipe",), (4,)))
        seq = x.reshape(-1, 10)
        for p in params:
            seq = fn(p, seq)
        np.testing.assert_allclose(piped.numpy(), seq.reshape(6, 4, 10)
                                   .numpy(), rtol=1e-5, atol=1e-6)

    def test_pipeline_apply_differentiable(self, rng_np):
        block = DenseLayer(n_in=6, n_out=6, activation="tanh",
                           weight_init="xavier")
        params = [block.init_params(torch.Generator().manual_seed(10 + i))
                  for i in range(4)]
        x = torch.as_tensor(rng_np.normal(size=(4, 3, 6)), dtype=torch.float32)
        fn = lambda p, a: block.forward(p, {}, a)[0]

        def grads(piped):
            st = {k: torch.stack([p[k] for p in params]).requires_grad_(True)
                  for k in params[0]}
            if piped:
                out = pipeline_apply(fn, st, x, _mesh(("pipe",), (2,)))
            else:
                out = x.reshape(-1, 6)
                for i in range(4):
                    out = fn({k: v[i] for k, v in st.items()}, out)
            g = torch.autograd.grad((out ** 2).mean(), list(st.values()))
            return [a.numpy() for a in g]
        for a, b in zip(grads(True), grads(False)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)

    def test_pipeline_trainer_learns(self, rng_np):
        block = DenseLayer(n_in=8, n_out=8, activation="tanh",
                           weight_init="xavier")
        head = OutputLayer(n_in=8, n_out=3, loss="mcxent",
                           activation="softmax", weight_init="xavier")
        tr = PipelineParallelTrainer(block, depth=4, head_conf=head,
                                     mesh=_mesh(("pipe",), (4,)),
                                     num_microbatches=4, learning_rate=0.2)
        assert tuple(tr.block_params["W"].local((1,)).shape) == (1, 8, 8)
        X = rng_np.normal(size=(32, 8)).astype(np.float32)
        y = np.eye(3)[(X[:, 0] > 0).astype(int) +
                      (X[:, 1] > 0).astype(int)].astype(np.float32)
        ds = DataSet(X, y)
        tr.fit_batch(ds)
        first = float(tr.score_value)
        for _ in range(60):
            tr.fit_batch(ds)
        assert float(tr.score_value) < first
        out = tr.output(X)
        assert out.shape == (32, 3)
        np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-4)


def _moe_conf(builder=NeuralNetConfiguration, moe=MixtureOfExpertsLayer,
              out=OutputLayer, seed=11, updater="adam"):
    it = InputType if builder is NeuralNetConfiguration else JaxInputType
    return (builder.Builder().seed(seed).learning_rate(0.05).updater(updater)
            .weight_init("xavier").list()
            .layer(moe(n_out=16, num_experts=4, expert_hidden=32,
                       activation="relu"))
            .layer(out(n_out=4, loss="mcxent", activation="softmax"))
            .set_input_type(it.feed_forward(10)).build())


def _moe_net():
    return MultiLayerNetwork(_moe_conf(), device="cpu").init()


class TestExpertParallel:
    def test_moe_forward_shapes_and_capacity(self, rng_np):
        layer = MixtureOfExpertsLayer(n_in=6, n_out=6, num_experts=3,
                                      expert_hidden=8, activation="relu",
                                      weight_init="xavier",
                                      capacity_factor=1.0)
        p = layer.init_params(torch.Generator().manual_seed(0))
        x = torch.as_tensor(rng_np.normal(size=(9, 6)), dtype=torch.float32)
        y, _ = layer.forward(p, {}, x)
        assert y.shape == (9, 6)
        assert layer.capacity(9) == 3
        xs = torch.as_tensor(rng_np.normal(size=(2, 5, 6)),
                             dtype=torch.float32)
        assert layer.forward(p, {}, xs)[0].shape == (2, 5, 6)

    def test_ep_matches_single_device(self, rng_np):
        ref, ep_net = _moe_net(), _moe_net()
        trainer = ExpertParallelTrainer(ep_net, _mesh(("data", "ep"),
                                                      (2, 2)))
        for ds in _batches(rng_np, 3, 16, 10, 4):
            ref._fit_batch(ds)
            trainer.fit_batch(ds)
        _close_nets(ep_net, ref)

    def test_ep_experts_actually_sharded(self):
        net = _moe_net()
        trainer = ExpertParallelTrainer(net, _mesh(("data", "ep"), (1, 4)))
        trainer.shard_params()
        w = trainer.params[0]["We1"]
        assert w.local((0, 3)).shape[0] == w.shape[0] // 4
        assert tuple(trainer.params[0]["Wg"].local((0, 3)).shape) == (10, 4)

    def test_moe_gradcheck(self, rng_np):
        net = _moe_net()
        X = rng_np.normal(size=(8, 10)).astype(np.float32)
        y = np.eye(4)[rng_np.integers(0, 4, 8)].astype(np.float32)
        grads, score = net.compute_gradient_and_score(DataSet(X, y))
        assert np.isfinite(score)
        flat = [g for layer in grads for g in layer.values()]
        assert all(torch.isfinite(g).all() for g in flat)
        assert any(float(g.abs().max()) > 0 for g in flat)

    def test_load_balance_loss(self, rng_np):
        layer = MixtureOfExpertsLayer(n_in=6, n_out=6, num_experts=4,
                                      expert_hidden=8, weight_init="xavier")
        p = layer.init_params(torch.Generator().manual_seed(3))
        x = torch.as_tensor(rng_np.normal(size=(64, 6)), dtype=torch.float32)
        assert float(layer.load_balance_loss(p, x)) >= 1.0 - 1e-6


# ============================================ the port against the JAX package
def test_tp_dense_matches_jax(rng_np):
    """DP x TP at (data 2, model 2): the port's trainer against JAX's on
    carried weights, sgd, 3 steps."""
    jnet = JaxMLN(_dense_conf(JaxNNC, (jl.DenseLayer, jl.OutputLayer),
                              updater="sgd")).init()
    tnet = _port(jnet)
    jtr = JaxTPTrainer(jnet, jax_mesh(4, axis_names=("data", "model"),
                                      shape=(2, 2)))
    ttr = TensorParallelTrainer(tnet, _mesh(("data", "model"), (2, 2)))
    for ds in _batches(rng_np, 3, 8, 12, 5):
        jtr.fit_batch(JaxDataSet(ds.features, ds.labels))
        ttr.fit_batch(ds)
        np.testing.assert_allclose(float(tnet.score_value),
                                   float(jnet.score_value), rtol=1e-5)
    _close_params(tnet, jnet)


def _conv_conf(builder, layers, it):
    conv, pool, dense, out = layers
    return (builder.Builder().seed(3).learning_rate(0.02)
            .updater("nesterovs").momentum(0.9).weight_init("xavier")
            .regularization(True).l2(5e-4)
            .gradient_normalization("ClipL2PerLayer")
            .gradient_normalization_threshold(0.5).list()
            .layer(conv(n_out=4, kernel_size=[3, 3], stride=[1, 1],
                        activation="identity"))
            .layer(pool(kernel_size=[2, 2], stride=[2, 2],
                        pooling_type="max"))
            .layer(conv(n_out=6, kernel_size=[3, 3], stride=[1, 1],
                        activation="identity"))
            .layer(pool(kernel_size=[2, 2], stride=[2, 2],
                        pooling_type="max"))
            .layer(dense(n_out=8, activation="relu"))
            .layer(out(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(it.convolutional(14, 14, 1)).build())


def test_tp_lenet_shaped_conv_net_matches_jax(rng_np):
    """A LeNet-shaped net (conv column-parallel, pool per shard, conv
    row-parallel, dense column, head row) with l2 and a per-layer L2
    clip at (data 1, model 2), 2 nesterovs steps, against JAX's trainer:
    the penalty and the clip norm sum over the shards."""
    jnet = JaxMLN(_conv_conf(JaxNNC, (jl.ConvolutionLayer,
                                      jl.SubsamplingLayer, jl.DenseLayer,
                                      jl.OutputLayer), JaxInputType)).init()
    tnet = _port(jnet)
    jtr = JaxTPTrainer(jnet, jax_mesh(2, axis_names=("data", "model"),
                                      shape=(1, 2)))
    ttr = TensorParallelTrainer(tnet, _mesh(("data", "model"), (1, 2)))
    assert [s.get("W") for s in ttr.param_specs[:5]] == [
        P(None, None, None, "model"), None, P(None, None, "model", None),
        None, P(None, "model")]
    for _ in range(2):
        X = rng_np.normal(size=(8, 14, 14, 1)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng_np.integers(0, 3, 8)]
        jtr.fit_batch(JaxDataSet(X, y))
        ttr.fit_batch(DataSet(X, y))
    assert tuple(ttr.params[0]["W"].local((0, 1)).shape) == (3, 3, 1, 2)
    _close_params(tnet, jnet)


def test_ep_matches_jax(rng_np):
    """EP at (data 2, ep 2) on carried weights, sgd, 3 steps: the routing
    takes both data groups' tokens as one batch, as JAX's does."""
    jnet = JaxMLN(_moe_conf(JaxNNC, JaxMoE, jl.OutputLayer,
                            updater="sgd")).init()
    tnet = _port(jnet)
    jtr = JaxEPTrainer(jnet, jax_mesh(4, axis_names=("data", "ep"),
                                      shape=(2, 2)))
    ttr = ExpertParallelTrainer(tnet, _mesh(("data", "ep"), (2, 2)))
    for ds in _batches(rng_np, 3, 16, 10, 4):
        jtr.fit_batch(JaxDataSet(ds.features, ds.labels))
        ttr.fit_batch(ds)
    assert tuple(ttr.params[0]["be2"].local((1, 1)).shape) == (2, 16)
    _close_params(tnet, jnet)


def test_moe_layer_json_forward_and_load_balance_match_jax(rng_np):
    """The port's MoE configuration is JAX's JSON (both ways), and on JAX's
    coefficients the forward (capacity 1.0 drops tokens) and the
    load-balance loss agree."""
    jconf = _moe_conf(JaxNNC, JaxMoE, jl.OutputLayer)
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert isinstance(tconf.layers[0], MixtureOfExpertsLayer)
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    import jax.numpy as jnp
    layer = JaxMoE(n_in=6, n_out=5, num_experts=3, expert_hidden=8,
                   activation="relu", weight_init="xavier",
                   capacity_factor=1.0)
    import jax
    jp = layer.init_params(jax.random.PRNGKey(4))
    tl = MultiLayerConfiguration.from_json(
        JaxNNC.Builder().list().layer(layer).set_input_type(
            JaxInputType.feed_forward(6)).build().to_json()).layers[0]
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    x = rng_np.normal(size=(12, 6)).astype(np.float32)
    jy, _ = layer.forward(jp, {}, jnp.asarray(x))
    ty, _ = tl.forward(tp, {}, torch.as_tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(tl.load_balance_loss(tp, torch.as_tensor(x))),
        float(layer.load_balance_loss(jp, jnp.asarray(x))), rtol=1e-6)


def test_pipeline_trainer_matches_jax(rng_np):
    """4 stages, 4 microbatches, sgd: the port's trainer on JAX's block
    and head parameters, 3 steps: scores and parameters."""
    jblock = jl.DenseLayer(n_in=8, n_out=8, activation="tanh",
                           weight_init="xavier")
    jhead = jl.OutputLayer(n_in=8, n_out=3, loss="mcxent",
                           activation="softmax", weight_init="xavier")
    jtr = JaxPPTrainer(jblock, depth=8, head_conf=jhead,
                       mesh=jax_mesh(4, axis_names=("pipe",)),
                       num_microbatches=4, learning_rate=0.2)
    block = DenseLayer(n_in=8, n_out=8, activation="tanh",
                       weight_init="xavier")
    head = OutputLayer(n_in=8, n_out=3, loss="mcxent", activation="softmax",
                       weight_init="xavier")
    ttr = PipelineParallelTrainer(
        block, depth=8, head_conf=head, mesh=_mesh(("pipe",), (4,)),
        num_microbatches=4, learning_rate=0.2,
        block_params={k: np.asarray(v) for k, v in jtr.block_params.items()},
        head_params={k: np.asarray(v) for k, v in jtr.head_params.items()})
    for _ in range(3):
        X = rng_np.normal(size=(16, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng_np.integers(0, 3, 16)]
        jtr.fit_batch(JaxDataSet(X, y))
        ttr.fit_batch(DataSet(X, y))
        np.testing.assert_allclose(float(ttr.score_value),
                                   float(jtr.score_value), rtol=1e-5)
    for k, v in jtr.block_params.items():
        np.testing.assert_allclose(ttr.block_params[k].gather().numpy(),
                                   np.asarray(v), rtol=1e-5, atol=1e-6)
    for k, v in jtr.head_params.items():
        np.testing.assert_allclose(ttr.head_params[k].numpy(),
                                   np.asarray(v), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ttr.output(X), np.asarray(jtr.output(X)),
                               rtol=1e-5, atol=1e-6)


# ============================== dropout and a center-loss head, cut or not
def _drop_conf(kind):
    """A net that drops out every layer's input (retention 0.7): TP's
    column, row and column dense layers and its row-parallel head, or
    EP's Mixture-of-Experts layer (with router jitter) and its head."""
    b = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.05)
         .updater("sgd").weight_init("xavier").activation("relu")
         .drop_out(0.7).list())
    if kind == "tp":
        for _ in range(3):
            b = b.layer(DenseLayer(n_out=16))
    else:
        b = b.layer(MixtureOfExpertsLayer(n_out=16, num_experts=4,
                                          expert_hidden=32,
                                          router_jitter=0.1))
    return (b.layer(OutputLayer(n_out=5, loss="mcxent",
                                activation="softmax"))
            .set_input_type(InputType.feed_forward(12)).build())


@pytest.mark.parametrize("kind", ["tp", "ep"])
def test_sharded_dropout_matches_unsharded(kind, rng_np):
    """With dropout on every layer (and router jitter), the step cut over
    2 shards draws the masks of the uncut step from the same seed: each
    layer's dropout is drawn once, on its whole input, before the cut."""
    trainer, axis, kinds = (
        (TensorParallelTrainer, "model", ["col", "row", "col", "row"])
        if kind == "tp" else
        (ExpertParallelTrainer, "ep", ["experts", "whole"]))
    nets = [MultiLayerNetwork(_drop_conf(kind), device="cpu").init()
            for _ in range(2)]
    trs = [trainer(net, _mesh(("data", axis), (1, n)))
           for net, n in zip(nets, (1, 2))]
    assert trs[1]._kinds == kinds
    for ds in _batches(rng_np, 3, 8, 12, 5):
        for tr in trs:
            tr.fit_batch(ds)
        np.testing.assert_allclose(float(nets[1].score_value),
                                   float(nets[0].score_value), rtol=1e-5)
    _close_nets(nets[1], nets[0])


def _center_conf(builder, layers, it):
    dense, head = layers
    return (builder.Builder().seed(8).learning_rate(0.1).updater("sgd")
            .weight_init("xavier").activation("tanh").list()
            .layer(dense(n_out=8))
            .layer(head(n_out=3, loss="mcxent", activation="softmax",
                        alpha=0.3, lambda_=0.5))
            .set_input_type(it.feed_forward(6)).build())


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)],
                         ids=["model2", "data2_model2"])
def test_tp_center_loss_head_matches_jax(shape, rng_np):
    """A center-loss head cut row-parallel (its input column-parallel)
    under TP, sgd, 2 steps, against JAX's trainer: the score, the
    parameters and the centers (moved by the global batch's class
    means)."""
    jnet = JaxMLN(_center_conf(JaxNNC, (jl.DenseLayer,
                                        jl.CenterLossOutputLayer),
                               JaxInputType)).init()
    tnet = _port(jnet)
    jtr = JaxTPTrainer(jnet, jax_mesh(shape[0] * shape[1],
                                      axis_names=("data", "model"),
                                      shape=shape))
    ttr = TensorParallelTrainer(tnet, _mesh(("data", "model"), shape))
    assert ttr._kinds == ["col", "row"]
    for ds in _batches(rng_np, 2, 8, 6, 3):
        jtr.fit_batch(JaxDataSet(ds.features, ds.labels))
        ttr.fit_batch(ds)
        np.testing.assert_allclose(float(tnet.score_value),
                                   float(jnet.score_value), rtol=1e-5)
    _close_params(tnet, jnet)
    np.testing.assert_allclose(tnet.state[1]["centers"].numpy(),
                               np.asarray(jnet.state[1]["centers"]),
                               rtol=1e-5, atol=1e-6)
    assert float(np.abs(np.asarray(jnet.state[1]["centers"])).max()) > 0
