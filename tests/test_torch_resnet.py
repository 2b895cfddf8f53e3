"""PyTorch port, the convolutional nets on the CPU against the JAX package:
``resnet_tiny_conf`` (inference and three nesterovs + l2 training steps:
loss, every parameter, every running statistic) with the JAX net's
weights carried across; ``resnet50_conf`` / ``resnet_tiny_conf`` JSON and
inferred input types (configuration only: nothing is initialized at
224); graph shape inference with preprocessors; LeNet's three steps and
a 32x32 VGG16 forward; checkpoints in both directions with batch norm's
running statistics, for a graph and for a sequential net.

Tolerances: f32 parity at 1e-5 (ROADMAP rule 1). The ResNet inputs are
12x12 and 5 rows: at the smallest sizes (a final stage of 1x1 over a
few rows) batch norm's backward cancels so much that any reordering of
its sums is amplified step over step in both packages."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import lenet_conf as jax_lenet
from deeplearning4j_tpu.models import resnet50_conf as jax_resnet50
from deeplearning4j_tpu.models import resnet_tiny_conf as jax_resnet_tiny
from deeplearning4j_tpu.models import vgg16_conf as jax_vgg16
from deeplearning4j_tpu.models.vgg16 import \
    VGG16ImagePreProcessor as JaxVGGPre
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.conf.config import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxIT
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph.graph_config import \
    infer_graph_shapes as jax_infer
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.utils.serializer import ModelSerializer
from deeplearning4j_tpu_torch.models import (VGG16ImagePreProcessor,
                                             lenet_conf, resnet50_conf,
                                             resnet_tiny_conf, vgg16_conf)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration,
                                               infer_graph_shapes)
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.utils import (graph_from_numpy,
                                            network_from_numpy,
                                            restore_computation_graph,
                                            restore_multi_layer_network,
                                            write_model)

TOL = dict(rtol=1e-5, atol=1e-5)
TINY = dict(num_classes=4, height=12, width=12, channels=3)


def _np(t):
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


def _graph_arrays(jnet):
    return {v: {k: np.asarray(a) for k, a in p.items()}
            for v, p in jnet.params.items()}


def _graph_state(jnet):
    return {v: {k: np.asarray(a) for k, a in s.items()}
            for v, s in jnet.state.items()}


def _batch(shape, classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                       shape[0])]
    return x, y


def _flat(tree, prefix=""):
    """Nested dicts of arrays → {"a/b/c": array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_tree(got, want, tol=TOL):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   err_msg=k, **tol)


# ---------------------------------------------------------------- ResNet
def test_resnet_tiny_output_and_three_steps_match_jax():
    jnet = JaxGraph(jax_resnet_tiny(**TINY)).init()
    net = graph_from_numpy(resnet_tiny_conf(**TINY), _graph_arrays(jnet),
                           device="cpu")
    x, y = _batch((5, 12, 12, 3), 4, 0)
    np.testing.assert_allclose(net.output(x)[0],
                               np.asarray(jnet.output(x)[0]), **TOL)
    for _ in range(3):
        jnet.fit_batch(JaxDataSet(x, y))
        net.fit_batch(DataSet(x, y))
        np.testing.assert_allclose(float(net.score_value),
                                   float(jnet.score_value), **TOL)
    _assert_tree(net.params, jnet.params)
    _assert_tree(net.state, jnet.state)
    _assert_tree(net.updater_state, jnet.updater_state)
    np.testing.assert_allclose(net.output(x)[0],
                               np.asarray(jnet.output(x)[0]), **TOL)
    assert net.iteration == jnet.iteration == 3


def _relative_gaps(got, want):
    """{name: relative L2 of got against want} over flattened trees, and
    the same over everything concatenated (key "all")."""
    got, want = _flat(got), _flat(want)
    rel = lambda a, b: float(np.linalg.norm(a - b) /
                             max(np.linalg.norm(b), 1e-30))
    as64 = lambda t: _np(t).astype(np.float64)
    out = {k: rel(as64(got[k]), as64(want[k])) for k in want}
    cat = lambda tree: np.concatenate([as64(tree[k]).ravel()
                                       for k in sorted(want)])
    out["all"] = rel(cat(got), cat(want))
    return out


def test_resnet_tiny_bf16_gradients_match_jax_bf16():
    """C6: one set of weights in resnet_tiny in bf16 (plain helpers, no
    kernel) in both packages. The port's bf16 gradients and running
    statistics after one step sit closer to the JAX package's bf16 ones
    than JAX's bf16 sits to its own f32 (every parameter, the stem's conv
    included, and all of them together): the gap to f32 is bf16 rounding
    in both packages, by design. Prints both gaps."""
    tiny = dict(TINY, height=16, width=16)
    j32 = JaxGraph(jax_resnet_tiny(**tiny)).init()
    arrays = _graph_arrays(j32)
    j16 = JaxGraph(jax_resnet_tiny(**tiny), compute_dtype=jnp.bfloat16)
    j16.init()
    j16.params = {v: {k: jnp.asarray(a) for k, a in p.items()}
                  for v, p in arrays.items()}
    net = graph_from_numpy(resnet_tiny_conf(**tiny), arrays, device="cpu",
                           compute_dtype=torch.bfloat16)
    x, y = _batch((8, 16, 16, 3), 4, 0)
    g32, s32 = j32.compute_gradient_and_score(JaxDataSet(x, y))
    g16, s16 = j16.compute_gradient_and_score(JaxDataSet(x, y))
    got, score = net.compute_gradient_and_score(DataSet(x, y))
    port = _relative_gaps(got, g16)
    own = _relative_gaps(g16, g32)
    for jnet in (j32, j16):
        jnet.fit_batch(JaxDataSet(x, y))
    net.fit_batch(DataSet(x, y))
    port_state = _relative_gaps(net.state, j16.state)
    own_state = _relative_gaps(j16.state, j32.state)
    print(f"C6 gradients rel-L2, port bf16 vs JAX bf16: all "
          f"{port['all']:.4g}, stem_conv.W {port['/stem_conv/W']:.4g}, "
          f"max {max(port.values()):.4g}; JAX bf16 vs JAX f32: all "
          f"{own['all']:.4g}, stem_conv.W {own['/stem_conv/W']:.4g}, max "
          f"{max(own.values()):.4g}; running statistics max: port "
          f"{max(port_state.values()):.4g}, JAX {max(own_state.values()):.4g}"
          f"; loss {score:.6f} / {s16:.6f} / {s32:.6f}")
    assert abs(score - s16) <= 2 ** -8 * abs(s16)
    assert port["all"] <= own["all"]
    assert port["/stem_conv/W"] <= own["/stem_conv/W"]
    assert max(port.values()) <= max(own.values())
    assert max(port_state.values()) <= max(own_state.values())


def test_resnet_tiny_l2_applies_to_conv_weights_only():
    """The l2 penalty is ½ · l2 · Σ W² over the conv and head W only
    (batch norm's gamma and beta are not regularizable), as in the JAX
    package."""
    net = ComputationGraph(resnet_tiny_conf(**TINY), device="cpu").init()
    _, _, reg, *_ = net._forward(net.params, net.state,
                                 net._inputs_dict(np.zeros((1, 12, 12, 3),
                                                           np.float32)))
    want = sum(0.5 * 1e-4 * float((p["W"] ** 2).sum())
               for p in net.params.values() if "W" in p)
    np.testing.assert_allclose(float(reg), want, rtol=1e-5)


def test_resnet_state_lives_on_the_nets_device_and_is_detached():
    net = ComputationGraph(resnet_tiny_conf(**TINY), device="cpu").init()
    x, y = _batch((2, 12, 12, 3), 4, 1)
    net.fit_batch(DataSet(x, y))
    for st in net.state.values():
        for t in st.values():
            assert t.grad_fn is None and not t.requires_grad
            assert t.device == net.device and t.dtype == torch.float32


@pytest.mark.parametrize("which", ["resnet50", "tiny"])
def test_resnet_conf_json_and_inferred_types_match_jax(which):
    """Byte-identical JSON (every conv's n_in and every BN's n_out come
    from set_input_types) and the same input type at every vertex."""
    jconf, conf = ((jax_resnet50(), resnet50_conf()) if which == "resnet50"
                   else (jax_resnet_tiny(), resnet_tiny_conf()))
    assert conf.to_json() == jconf.to_json()
    again = ComputationGraphConfiguration.from_json(conf.to_json())
    assert again.to_json() == conf.to_json()
    jtypes = jax_infer(copy.deepcopy(jconf.vertices), jconf.vertex_inputs,
                       jconf.network_inputs, jconf.input_types,
                       jconf.topological_order)
    types = infer_graph_shapes(copy.deepcopy(conf.vertices),
                               conf.vertex_inputs, conf.network_inputs,
                               conf.input_types, conf.topological_order)
    assert {k: t.to_dict() for k, t in types.items()} == \
        {k: t.to_dict() for k, t in jtypes.items()}
    if which == "resnet50":
        assert types["avgpool"].to_dict()["size"] == 2048
        assert types["stem_pool"].to_dict()["height"] == 56


def _preproc_graph(pkg):
    """A graph whose dense layer needs the CNN → feed-forward flatten,
    inserted by shape inference."""
    nnc, it, layers = pkg
    g = (nnc.Builder().seed(4).learning_rate(0.05).updater("sgd")
         .graph_builder().add_inputs("in")
         .add_layer("conv", layers.ConvolutionLayer(
             n_out=3, kernel_size=[3, 3], activation="relu"), "in")
         .add_layer("dense", layers.DenseLayer(n_out=12, activation="tanh"),
                    "conv")
         .add_layer("out", layers.OutputLayer(n_out=2, loss="mcxent",
                                              activation="softmax"), "dense")
         .set_outputs("out")
         .set_input_types(it.convolutional(5, 6, 2)))
    return g.build()


def test_graph_shape_inference_inserts_preprocessors_like_jax():
    jconf = _preproc_graph((JaxNNC, JaxIT, JL))
    conf = _preproc_graph((NeuralNetConfiguration, InputType, TL))
    assert conf.to_json() == jconf.to_json()
    assert type(conf.vertices["dense"].preprocessor).__name__ == \
        "CnnToFeedForwardPreProcessor"
    jnet = JaxGraph(jconf).init()
    net = graph_from_numpy(conf, _graph_arrays(jnet), device="cpu")
    x, y = _batch((3, 5, 6, 2), 2, 2)
    np.testing.assert_allclose(net.output(x)[0],
                               np.asarray(jnet.output(x)[0]), **TOL)
    jnet.fit_batch(JaxDataSet(x, y))
    net.fit_batch(DataSet(x, y))
    _assert_tree(net.params, jnet.params)


# ------------------------------------------------------------ LeNet, VGG16
def test_lenet_conf_json_and_three_steps_match_jax():
    jconf, conf = jax_lenet(learning_rate=0.02), lenet_conf(
        learning_rate=0.02)
    assert conf.to_json() == jconf.to_json()
    assert sorted(conf.input_preprocessors) == ["4"]
    jnet = JaxNet(jconf).init()
    net = network_from_numpy(conf, [{k: np.asarray(a) for k, a in p.items()}
                                    for p in jnet.params], device="cpu")
    x, y = _batch((6, 28, 28, 1), 10, 3)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **TOL)
    for _ in range(3):
        jnet.fit(JaxDataSet(x, y))
        net.fit(DataSet(x, y))
        np.testing.assert_allclose(float(net.score_value),
                                   float(jnet.score_value), **TOL)
    for jp, tp in zip(jnet.params, net.params):
        for k in jp:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), **TOL)


@pytest.mark.parametrize("top", [True, False])
def test_vgg16_conf_json_matches_jax(top):
    """VGG16 and VGG16NoTop, at 224x224 and at 32x32."""
    assert vgg16_conf(top=top).to_json() == jax_vgg16(top=top).to_json()
    assert vgg16_conf(num_classes=10, top=top, height=32, width=32) \
        .to_json() == jax_vgg16(num_classes=10, top=top, height=32,
                                width=32).to_json()


def test_vgg16_forward_matches_jax():
    """VGG16 at 32x32 (five 2x2 pools leave 1x1x512 before the dense
    head) with the JAX net's weights."""
    jconf = jax_vgg16(num_classes=10, height=32, width=32)
    conf = vgg16_conf(num_classes=10, height=32, width=32)
    jnet = JaxNet(jconf).init()
    net = network_from_numpy(conf, [{k: np.asarray(a) for k, a in p.items()}
                                    for p in jnet.params], device="cpu")
    x, _ = _batch((2, 32, 32, 3), 10, 4)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **TOL)


def test_vgg16_image_preprocessor_matches_jax():
    x = np.random.default_rng(5).uniform(0, 255, (2, 4, 4, 3)) \
        .astype(np.float32)
    jds, ds = JaxDataSet(x.copy(), None), DataSet(x.copy(), None)
    JaxVGGPre()(jds)
    VGG16ImagePreProcessor()(ds)
    np.testing.assert_array_equal(ds.features, np.asarray(jds.features))


# ------------------------------------------------------------ checkpoints
def _trained_jax_resnet(steps=2):
    jnet = JaxGraph(jax_resnet_tiny(**TINY)).init()
    x, y = _batch((5, 12, 12, 3), 4, 6)
    for _ in range(steps):
        jnet.fit_batch(JaxDataSet(x, y))
    return jnet, x, y


def test_jax_resnet_checkpoint_restores_with_bn_state(tmp_path):
    """A JAX resnet_tiny written after 2 steps restores in the port with
    its running statistics: the same inference output at 1e-5 (without
    the state, the initial running statistics give another output), and
    a third step continues identically."""
    jnet, x, y = _trained_jax_resnet()
    path = tmp_path / "resnet.zip"
    ModelSerializer.write_model(jnet, path)
    net = restore_computation_graph(path, device="cpu")
    _assert_tree(net.state, jnet.state)
    want = np.asarray(jnet.output(x)[0])
    np.testing.assert_allclose(net.output(x)[0], want, **TOL)
    stateless = graph_from_numpy(net.conf, _graph_arrays(jnet), device="cpu")
    assert not np.allclose(stateless.output(x)[0], want, **TOL)
    jnet.fit_batch(JaxDataSet(x, y))
    net.fit_batch(DataSet(x, y))
    np.testing.assert_allclose(float(net.score_value),
                               float(jnet.score_value), **TOL)
    _assert_tree(net.params, jnet.params)


def test_port_resnet_checkpoint_restores_in_jax(tmp_path):
    jnet, x, y = _trained_jax_resnet(0)
    net = graph_from_numpy(resnet_tiny_conf(**TINY), _graph_arrays(jnet),
                           device="cpu")
    for _ in range(2):
        net.fit_batch(DataSet(x, y))
    path = tmp_path / "port_resnet.zip"
    write_model(net, path)
    back = ModelSerializer.restore_computation_graph(path)
    _assert_tree(net.state, _graph_state(back))
    np.testing.assert_allclose(np.asarray(back.output(x)[0]),
                               net.output(x)[0], **TOL)


def test_graph_from_numpy_takes_the_jax_state():
    jnet, x, _ = _trained_jax_resnet()
    net = graph_from_numpy(resnet_tiny_conf(**TINY), _graph_arrays(jnet),
                           device="cpu", state=_graph_state(jnet))
    np.testing.assert_allclose(net.output(x)[0],
                               np.asarray(jnet.output(x)[0]), **TOL)


def _bn_list(pkg):
    nnc, it, layers = pkg
    return (nnc.Builder().seed(9).learning_rate(0.05).updater("nesterovs")
            .momentum(0.9).list()
            .layer(layers.ConvolutionLayer(n_out=4, kernel_size=[3, 3],
                                           activation="identity"))
            .layer(layers.BatchNormalization(activation="relu"))
            .layer(layers.SubsamplingLayer(kernel_size=[2, 2],
                                           stride=[2, 2]))
            .layer(layers.OutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax"))
            .set_input_type(it.convolutional(8, 8, 2)).build())


def test_multilayer_bn_checkpoints_both_ways(tmp_path):
    """A sequential conv → BN → pool → softmax net: JAX's checkpoint
    after 2 steps restores in the port with its running statistics (same
    output; a third step continues identically), and the port's restores
    in JAX."""
    jconf = _bn_list((JaxNNC, JaxIT, JL))
    conf = _bn_list((NeuralNetConfiguration, InputType, TL))
    assert conf.to_json() == jconf.to_json()
    jnet = JaxNet(jconf).init()
    x, y = _batch((6, 8, 8, 2), 3, 7)
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y))
    path = tmp_path / "mln.zip"
    ModelSerializer.write_model(jnet, path)
    net = restore_multi_layer_network(path, device="cpu")
    for js, ts in zip(jnet.state, net.state):
        for k in js:
            np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), **TOL)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **TOL)
    jnet.fit(JaxDataSet(x, y))
    net.fit(DataSet(x, y))
    np.testing.assert_allclose(float(net.score_value),
                               float(jnet.score_value), **TOL)
    path2 = tmp_path / "mln_port.zip"
    write_model(net, path2)
    back = ModelSerializer.restore_multi_layer_network(path2)
    np.testing.assert_allclose(np.asarray(back.output(x)), net.output(x),
                               **TOL)
    again = network_from_numpy(
        conf, [{k: np.asarray(a) for k, a in p.items()} for p in jnet.params],
        device="cpu", state=[{k: np.asarray(a) for k, a in s.items()}
                             for s in jnet.state])
    np.testing.assert_allclose(again.output(x), np.asarray(jnet.output(x)),
                               **TOL)
    assert jnp.asarray(jnet.state[1]["mean"]).shape == (4,)
