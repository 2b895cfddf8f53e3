"""PyTorch port, Keras import and export on the CPU against the JAX
package: each case of the JAX package's ``tests/test_keras_import.py``
with the port's imported net held against JAX's on the same file (f32,
the port's ResNet tolerance 1e-5), the Keras case of
``tests/test_graph_transfer.py``, the Keras backend server,
``ModelGuesser`` on a Keras file, ``TrainedModels`` and
``ImageNetLabels``; and the port's own HDF5 reader and writer
(``keras/hdf5.py``) held against h5py both ways: every attribute and
dataset of the files h5py writes reads equal through the port, the files
the port writes read equal through h5py and import through JAX's
importer to the same predictions, and a chunked dataset raises naming
the feature. The ResNet-50 exports and imports (32x32, 16 classes, the
full [3, 4, 6, 3] graph) are built once for the module."""

import json
import urllib.request

import h5py
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.keras import KerasBackendServer as JaxServer
from deeplearning4j_tpu.keras import KerasModelImport as JaxImport
from deeplearning4j_tpu.keras.export import \
    export_resnet50_keras_h5 as jax_export_resnet50
from deeplearning4j_tpu.models import ImageNetLabels as JaxLabels
from deeplearning4j_tpu.models import TrainedModels as JaxTrained
from deeplearning4j_tpu.models import vgg16_conf as jax_vgg16
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.utils.serializer import ModelGuesser as JaxGuesser
from deeplearning4j_tpu_torch.keras import (KerasBackendServer,
                                            KerasModelImport, hdf5)
from deeplearning4j_tpu_torch.keras.export import (export_resnet50_keras_h5,
                                                   write_keras_h5)
from deeplearning4j_tpu_torch.models import (ImageNetLabels, TrainedModels,
                                             VGG16ImagePreProcessor,
                                             resnet50_conf, vgg16_conf)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.layers import (BatchNormalization,
                                                     ConvolutionLayer,
                                                     OutputLayer)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph.vertices import (ElementWiseVertex,
                                                        LayerVertex)
from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                  TransferLearning)
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.utils import ModelGuesser, write_model

TOL = dict(rtol=1e-5, atol=1e-5)
RESNET = dict(num_classes=16, height=32, width=32)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the test workers of a parallel run would spin
    on each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def resnet(tmp_path_factory):
    """ResNet-50 written by each package's exporter (seed 11); the port
    imports JAX's file and JAX imports the port's."""
    d = tmp_path_factory.mktemp("resnet")
    jax_path, port_path = d / "jax.h5", d / "port.h5"
    jax_w = jax_export_resnet50(jax_path, seed=11, **RESNET)
    port_w = export_resnet50_keras_h5(port_path, seed=11, **RESNET)
    return {"jax_path": jax_path, "port_path": port_path,
            "jax_weights": jax_w, "port_weights": port_w,
            "port_net": KerasModelImport.import_keras_model_and_weights(
                jax_path, device="cpu"),
            "jax_net": JaxImport.import_keras_model_and_weights(port_path)}


def _write_keras2_h5(path, model_config, layer_weights):
    """The JAX test's fixture writer (h5py): layer_weights maps a layer to
    its [(weight name, array), ...]."""
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(model_config)
        mw = f.create_group("model_weights")
        for lname, weights in layer_weights.items():
            lg = mw.create_group(lname)
            names = []
            for wname, arr in weights:
                full = f"{lname}/{wname}"
                lg.create_dataset(full.split("/", 1)[1], data=arr)
                names.append(full.encode())
            lg.attrs["weight_names"] = names


def _dense_cfg(name, units, activation, input_shape=None):
    cfg = {"name": name, "units": units, "activation": activation,
           "use_bias": True}
    if input_shape:
        cfg["batch_input_shape"] = [None] + list(input_shape)
    return {"class_name": "Dense", "config": cfg}


def _both(path, sequential=False):
    """(port net on the CPU, JAX net) imported from ``path``."""
    if sequential:
        return (KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cpu"),
            JaxImport.import_keras_sequential_model_and_weights(path))
    return (KerasModelImport.import_keras_model_and_weights(path,
                                                            device="cpu"),
            JaxImport.import_keras_model_and_weights(path))


def _softmax(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ----------------------------------------- the JAX package's import tests
def test_dense_mlp_predictions_match(tmp_path, rng_np):
    W1 = rng_np.normal(size=(4, 8)).astype(np.float32)
    b1 = rng_np.normal(size=(8,)).astype(np.float32)
    W2 = rng_np.normal(size=(8, 3)).astype(np.float32)
    b2 = rng_np.normal(size=(3,)).astype(np.float32)
    model_config = {"class_name": "Sequential", "config": {"layers": [
        _dense_cfg("dense_1", 8, "relu", input_shape=[4]),
        _dense_cfg("dense_2", 3, "softmax")]}}
    path = tmp_path / "mlp.h5"
    _write_keras2_h5(path, model_config, {
        "dense_1": [("kernel:0", W1), ("bias:0", b1)],
        "dense_2": [("kernel:0", W2), ("bias:0", b2)]})
    net, jnet = _both(path, sequential=True)
    assert isinstance(net, MultiLayerNetwork)
    assert json.loads(KerasModelImport.import_keras_model_configuration(
        path).to_json()) == json.loads(
            JaxImport.import_keras_model_configuration(path).to_json())
    X = rng_np.normal(size=(5, 4)).astype(np.float32)
    out = net.output(X)
    np.testing.assert_allclose(out, np.asarray(jnet.output(X)), **TOL)
    expect = _softmax(np.maximum(X @ W1 + b1, 0) @ W2 + b2)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_cnn_import_shapes(tmp_path, rng_np):
    K = rng_np.normal(size=(3, 3, 1, 4)).astype(np.float32)     # HWIO
    W = rng_np.normal(size=(4 * 13 * 13, 2)).astype(np.float32)
    model_config = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Conv2D", "config": {
            "name": "conv", "filters": 4, "kernel_size": [3, 3],
            "strides": [1, 1], "padding": "valid", "activation": "relu",
            "use_bias": True, "batch_input_shape": [None, 28, 28, 1]}},
        {"class_name": "MaxPooling2D", "config": {
            "name": "pool", "pool_size": [2, 2], "strides": [2, 2],
            "padding": "valid"}},
        {"class_name": "Flatten", "config": {"name": "flat"}},
        _dense_cfg("fc", 2, "softmax")]}}
    path = tmp_path / "cnn.h5"
    _write_keras2_h5(path, model_config, {
        "conv": [("kernel:0", K), ("bias:0", np.zeros(4, np.float32))],
        "fc": [("kernel:0", W), ("bias:0", np.zeros(2, np.float32))]})
    net, jnet = _both(path)
    X = rng_np.normal(size=(2, 28, 28, 1)).astype(np.float32)
    out = net.output(X)
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out.sum(axis=1), np.ones(2), rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(jnet.output(X)), **TOL)


@pytest.mark.parametrize("gates", ["sigmoid", "hard_sigmoid"])
def test_lstm_import(tmp_path, rng_np, gates):
    n_in, units = 3, 5
    kernel = rng_np.normal(size=(n_in, 4 * units)).astype(np.float32)
    rec = rng_np.normal(size=(units, 4 * units)).astype(np.float32)
    bias = rng_np.normal(size=(4 * units,)).astype(np.float32)
    W = rng_np.normal(size=(units, 2)).astype(np.float32)
    model_config = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "LSTM", "config": {
            "name": "lstm", "units": units, "activation": "tanh",
            "recurrent_activation": gates, "return_sequences": True,
            "batch_input_shape": [None, 7, n_in]}},
        {"class_name": "GlobalMaxPooling1D", "config": {"name": "gmp"}},
        _dense_cfg("fc", 2, "softmax")]}}
    path = tmp_path / "lstm.h5"
    _write_keras2_h5(path, model_config, {
        "lstm": [("kernel:0", kernel), ("recurrent_kernel:0", rec),
                 ("bias:0", bias)],
        "fc": [("kernel:0", W), ("bias:0", np.zeros(2, np.float32))]})
    net, jnet = _both(path)
    assert net.layers[0].gate_activation == \
        {"sigmoid": "sigmoid", "hard_sigmoid": "hardsigmoid"}[gates]
    np.testing.assert_array_equal(net.params[0]["W"].numpy(), kernel)
    X = rng_np.normal(size=(2, 7, n_in)).astype(np.float32)
    out = net.output(X)
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out, np.asarray(jnet.output(X)), **TOL)


def test_keras1_lstm_gate_order_and_theano_kernels(tmp_path, rng_np):
    """Keras 1's twelve per-gate LSTM arrays (i, c, f, o) and a Theano
    OIHW kernel (flipped to HWIO, a negative-stride view made contiguous)
    map as JAX maps them."""
    from deeplearning4j_tpu.keras.layers import map_weights as jax_map
    from deeplearning4j_tpu_torch.keras.layers import map_weights
    from deeplearning4j_tpu_torch.nn.conf.layers import LSTM
    arrays = [rng_np.normal(size=s).astype(np.float32)
              for _ in range(4) for s in ((3, 5), (5, 5), (5,))]
    got, _ = map_weights("LSTM", LSTM(n_out=5), arrays)
    want, _ = jax_map("LSTM", None, arrays)
    for k in ("W", "R", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    oihw = rng_np.normal(size=(6, 2, 3, 3)).astype(np.float32)
    got, _ = map_weights("Conv2D", ConvolutionLayer(n_out=6), [oihw],
                         dtype=torch.float64)
    want, _ = jax_map("Conv2D", ConvolutionLayer(n_out=6), [oihw])
    assert got["W"].dtype == torch.float64 and got["W"].is_contiguous()
    np.testing.assert_array_equal(got["W"].numpy(), np.asarray(want["W"]))


def test_two_branch_add(tmp_path, rng_np):
    W1 = rng_np.normal(size=(4, 6)).astype(np.float32)
    W2 = rng_np.normal(size=(4, 6)).astype(np.float32)
    W3 = rng_np.normal(size=(6, 2)).astype(np.float32)
    zeros6 = np.zeros(6, np.float32)

    def dense(name, units, act, inp):
        return {"class_name": "Dense", "name": name,
                "config": {"name": name, "units": units, "activation": act,
                           "use_bias": True},
                "inbound_nodes": [[[inp, 0, 0, {}]]]}
    model_config = {"class_name": "Model", "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "inp",
             "config": {"name": "inp", "batch_input_shape": [None, 4]},
             "inbound_nodes": []},
            dense("d1", 6, "relu", "inp"), dense("d2", 6, "relu", "inp"),
            {"class_name": "Add", "name": "add", "config": {"name": "add"},
             "inbound_nodes": [[["d1", 0, 0, {}], ["d2", 0, 0, {}]]]},
            dense("out", 2, "softmax", "add")],
        "input_layers": [["inp", 0, 0]], "output_layers": [["out", 0, 0]]}}
    path = tmp_path / "func.h5"
    _write_keras2_h5(path, model_config, {
        "d1": [("kernel:0", W1), ("bias:0", zeros6)],
        "d2": [("kernel:0", W2), ("bias:0", zeros6)],
        "out": [("kernel:0", W3), ("bias:0", np.zeros(2, np.float32))]})
    net, jnet = _both(path)
    assert isinstance(net, ComputationGraph)
    X = rng_np.normal(size=(3, 4)).astype(np.float32)
    out = net.output(X)[0]
    np.testing.assert_allclose(out, np.asarray(jnet.output(X)[0]), **TOL)
    expect = _softmax((np.maximum(X @ W1, 0) + np.maximum(X @ W2, 0)) @ W3)
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_vgg16_conf_shapes():
    conf = vgg16_conf(num_classes=1000)
    names = [type(la).__name__ for la in conf.layers]
    assert names == [type(la).__name__ for la in jax_vgg16(1000).layers]
    assert names.count("ConvolutionLayer") == 13
    assert names.count("SubsamplingLayer") == 5
    assert names.count("DenseLayer") == 2
    notop = vgg16_conf(top=False)
    assert all(type(la).__name__ != "DenseLayer" for la in notop.layers)
    assert json.loads(notop.to_json()) == json.loads(
        jax_vgg16(top=False).to_json())


def test_vgg16_tiny_forward(rng_np):
    """The JAX test's tiny VGG16 on the port (its forward against JAX's
    on the same weights is ``tests/test_torch_resnet.py``'s)."""
    net = MultiLayerNetwork(vgg16_conf(num_classes=4, height=32, width=32),
                            device="cpu").init()
    X = rng_np.normal(size=(2, 32, 32, 3)).astype(np.float32)
    out = net.output(X)
    assert out.shape == (2, 4)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


def test_preprocessor_and_labels(tmp_path, rng_np):
    from deeplearning4j_tpu_torch.models.vgg16 import VGG16_MEAN_RGB
    X = rng_np.uniform(0, 255, size=(2, 8, 8, 3)).astype(np.float32)
    ds = DataSet(X.copy(), np.zeros((2, 2), np.float32))
    TrainedModels.get_pre_processor().pre_process(ds)
    assert isinstance(TrainedModels.get_pre_processor(),
                      VGG16ImagePreProcessor)
    np.testing.assert_allclose(
        ds.features, X - np.asarray(VGG16_MEAN_RGB, np.float32), rtol=1e-6)
    listed = tmp_path / "labels.json"
    listed.write_text(json.dumps(["cat", "dog", "newt"]))
    keyed = tmp_path / "index.json"
    keyed.write_text(json.dumps({"0": ["n1", "cat"], "1": ["n2", "dog"],
                                 "2": ["n3", "newt"]}))
    preds = np.array([[0.1, 0.7, 0.2], [0.5, 0.2, 0.3]])
    for path in (listed, keyed):
        labels = ImageNetLabels(path=str(path))
        top = labels.decode_predictions(preds, top=2)
        assert [t["label"] for t in top[0]] == ["dog", "newt"]
        assert top == JaxLabels(path=str(path)).decode_predictions(preds,
                                                                   top=2)
        assert labels.get_label(2) == "newt"
    with pytest.raises(FileNotFoundError):
        ImageNetLabels(path=str(tmp_path / "missing.json"))


def test_residual_block_predictions(tmp_path, rng_np):
    C = 4
    kern = rng_np.normal(0, 0.3, (3, 3, C, C)).astype(np.float32)
    gamma = rng_np.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng_np.normal(0, 0.1, C).astype(np.float32)
    mean = rng_np.normal(0, 0.1, C).astype(np.float32)
    var = rng_np.uniform(0.5, 1.5, C).astype(np.float32)
    W = rng_np.normal(0, 0.3, (C, 3)).astype(np.float32)
    path = tmp_path / "resblock.h5"
    _write_keras2_h5(path, _resblock_config(C), {
        "conv": [("kernel:0", kern)],
        "bn": [("gamma:0", gamma), ("beta:0", beta),
               ("moving_mean:0", mean), ("moving_variance:0", var)],
        "out": [("kernel:0", W), ("bias:0", np.zeros(3, np.float32))]})
    net, jnet = _both(path)
    assert isinstance(net, ComputationGraph)
    np.testing.assert_array_equal(net.state["bn"]["mean"].numpy(), mean)
    np.testing.assert_array_equal(net.state["bn"]["var"].numpy(), var)
    X = rng_np.normal(size=(2, 8, 8, C)).astype(np.float32)
    got = net.output(X)[0]
    np.testing.assert_allclose(got, np.asarray(jnet.output(X)[0]), **TOL)
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(X).permute(0, 3, 1, 2),
        torch.from_numpy(kern).permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1).numpy()
    act = np.maximum((conv - mean) / np.sqrt(var + 1e-3) * gamma + beta + X,
                     0)
    expect = _softmax(act.mean(axis=(1, 2)) @ W)
    np.testing.assert_allclose(got, expect, rtol=2e-3, atol=2e-4)


def _resblock_config(C):
    def layer(cls, name, config, inputs):
        return {"class_name": cls, "name": name,
                "config": dict(config, name=name),
                "inbound_nodes": [[[i, 0, 0, {}] for i in inputs]]
                if inputs else []}
    return {"class_name": "Model", "config": {
        "name": "resblock",
        "layers": [
            layer("InputLayer", "inp", {"batch_input_shape": [None, 8, 8, C]},
                  []),
            layer("Conv2D", "conv", {"filters": C, "kernel_size": [3, 3],
                                     "strides": [1, 1], "padding": "same",
                                     "use_bias": False,
                                     "activation": "linear"}, ["inp"]),
            layer("BatchNormalization", "bn", {"epsilon": 1e-3}, ["conv"]),
            layer("Add", "add", {}, ["bn", "inp"]),
            layer("Activation", "relu", {"activation": "relu"}, ["add"]),
            layer("GlobalAveragePooling2D", "gap", {}, ["relu"]),
            layer("Dense", "out", {"units": 3, "activation": "softmax",
                                   "use_bias": True}, ["gap"])],
        "input_layers": [["inp", 0, 0]], "output_layers": [["out", 0, 0]]}}


def test_resnet50_import_structure_and_predictions_match_native(resnet,
                                                                rng_np):
    net = resnet["port_net"]
    assert isinstance(net, ComputationGraph)
    convs = [n for n, v in net.conf.vertices.items()
             if isinstance(v, LayerVertex)
             and isinstance(v.layer, ConvolutionLayer)]
    adds = [n for n, v in net.conf.vertices.items()
            if isinstance(v, ElementWiseVertex)]
    assert len(convs) == 53 and len(adds) == 16
    conf = resnet50_conf(**RESNET)
    for v in conf.vertices.values():
        if isinstance(v, LayerVertex) and \
                isinstance(v.layer, BatchNormalization):
            v.layer.eps = 1e-3           # Keras's epsilon
    native = ComputationGraph(conf, device="cpu").init()
    for name, arrs in resnet["port_weights"].items():
        t = [torch.from_numpy(a) for a in arrs]
        if name.endswith("_conv"):
            native.params[name]["W"] = t[0]
        elif name.endswith("_bn"):
            native.params[name].update(gamma=t[0], beta=t[1])
            native.state[name].update(mean=t[2], var=t[3])
        elif name == "fc":
            native.params["fc"].update(W=t[0], b=t[1])
    X = rng_np.normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = net.output(X)[0]
    np.testing.assert_allclose(got, native.output(X)[0], **TOL)
    # the port's import of JAX's file against JAX's import of the port's
    np.testing.assert_allclose(got, np.asarray(resnet["jax_net"].output(X)[0]),
                               **TOL)


def test_imported_resnet50_trains(resnet, rng_np):
    net = KerasModelImport.import_keras_model_and_weights(
        resnet["jax_path"], device="cpu")
    out_layer = net.conf.vertices["fc"].layer
    assert isinstance(out_layer, OutputLayer)
    assert out_layer.loss == "mcxent" and out_layer.updater == "nesterovs"
    X = rng_np.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = np.eye(16, dtype=np.float32)[rng_np.integers(0, 16, 8)]
    s0 = net.score(DataSet(X, y))
    np.testing.assert_allclose(s0, float(resnet["jax_net"].score(
        JaxDataSet(X, y))), **TOL)
    # each step's score_value is the loss before its update
    scores = []
    for _ in range(9):
        net.fit_batch(DataSet(X, y))
        scores.append(float(net.score_value))
    assert np.isfinite(scores).all()
    assert min(scores[1:]) < 0.5 * s0


def test_keras_resnet50_freeze_replace_finetune(resnet, rng_np):
    """The Keras case of the JAX package's graph transfer tests: import,
    freeze the trunk, replace the head, fine-tune; only the head moves."""
    src = KerasModelImport.import_keras_model_and_weights(
        resnet["port_path"], device="cpu")
    new = (TransferLearning.GraphBuilder(src)
           .fine_tune_configuration(FineTuneConfiguration(
               learning_rate=0.05, updater="sgd"))
           .set_feature_extractor("avgpool")
           .remove_vertex_and_connections("fc")
           .add_layer("new_fc", OutputLayer(n_out=4, loss="mcxent",
                                            activation="softmax"),
                      "avgpool")
           .set_outputs("new_fc")
           .build())
    trunk = [n for n in new.conf.vertices if n != "new_fc"]
    assert set(trunk) == set(new.frozen_vertices)
    assert new.conf.vertices["new_fc"].layer.n_in == 2048
    before = {n: {k: a.clone() for k, a in new.params[n].items()}
              for n in trunk if new.params[n]}
    head = new.params["new_fc"]["W"].clone()
    X = rng_np.normal(size=(4, 32, 32, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng_np.integers(0, 4, 4)]
    s0 = new.score(DataSet(X, y))
    for _ in range(6):
        new.fit_batch(DataSet(X, y))
    for n, p in before.items():
        for k, a in p.items():
            assert torch.equal(new.params[n][k], a), f"trunk {n}/{k} moved"
    assert (new.params["new_fc"]["W"] - head).abs().max() > 1e-6
    assert new.score(DataSet(X, y)) < s0


# ------------------------------------------------- server, guesser, VGG16
def _post(base, path, payload):
    req = urllib.request.Request(base + path, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _mlp_file(path, rng):
    W1 = rng.normal(size=(3, 8)).astype(np.float32)
    W2 = rng.normal(size=(8, 2)).astype(np.float32)
    write_keras_h5(path, {"class_name": "Sequential", "config": {"layers": [
        _dense_cfg("dense_1", 8, "tanh", input_shape=[3]),
        _dense_cfg("dense_2", 2, "softmax")]}},
        {"dense_1": [("kernel:0", W1), ("bias:0", np.zeros(8))],
         "dense_2": [("kernel:0", W2), ("bias:0", np.zeros(2))]},
        {"loss": "categorical_crossentropy",
         "optimizer_config": {"class_name": "SGD", "config": {"lr": 0.1}}})


def test_keras_backend_server_http(tmp_path):
    """The JAX package's server test on the port, with a Keras file
    imported and a port checkpoint loaded."""
    rng = np.random.default_rng(1)
    keras_path = tmp_path / "m.h5"
    _mlp_file(keras_path, rng)
    X = rng.normal(size=(16, 3)).tolist()
    y = np.eye(2)[rng.integers(0, 2, 16)].tolist()
    direct = KerasModelImport.import_keras_model_and_weights(keras_path,
                                                             device="cpu")
    zip_path = tmp_path / "m.zip"
    write_model(direct, zip_path)
    srv = KerasBackendServer(device="cpu").start()
    try:
        base = f"http://{srv.host}:{srv.port}"
        imported = _post(base, "/import", {"path": str(keras_path)})
        out = _post(base, "/predict", {"model_id": imported["model_id"],
                                       "features": X})
        np.testing.assert_allclose(np.asarray(out["output"]),
                                   direct.output(np.asarray(X, np.float32)),
                                   **TOL)
        mid = _post(base, "/load", {"path": str(zip_path)})["model_id"]
        score = _post(base, "/fit", {"model_id": mid, "features": X,
                                     "labels": y, "epochs": 2})["score"]
        assert np.isfinite(score)
        out = _post(base, "/predict", {"model_id": mid, "features": X})
        assert np.asarray(out["output"]).shape == (16, 2)
        ev = _post(base, "/evaluate", {"model_id": mid, "features": X,
                                       "labels": y})
        assert 0.0 <= ev["accuracy"] <= 1.0
        _post(base, "/save", {"model_id": mid,
                              "path": str(tmp_path / "out.zip")})
        again = _post(base, "/load", {"path": str(tmp_path / "out.zip")})
        np.testing.assert_array_equal(
            _post(base, "/predict", {"model_id": again["model_id"],
                                     "features": X})["output"],
            out["output"])
        with urllib.request.urlopen(base + "/models") as r:
            assert mid in json.loads(r.read())["models"]
    finally:
        srv.shutdown()
    # the same Keras file through JAX's server predicts the same
    jsrv = JaxServer().start()
    try:
        base = f"http://{jsrv.host}:{jsrv.port}"
        jid = _post(base, "/import", {"path": str(keras_path)})["model_id"]
        np.testing.assert_allclose(
            _post(base, "/predict", {"model_id": jid, "features": X})[
                "output"], direct.output(np.asarray(X, np.float32)), **TOL)
    finally:
        jsrv.shutdown()


def test_model_guesser_imports_a_keras_file(tmp_path, rng_np):
    W1 = rng_np.normal(size=(4, 8)).astype(np.float32)
    W2 = rng_np.normal(size=(8, 3)).astype(np.float32)
    cfg = {"class_name": "Sequential", "config": {"layers": [
        _dense_cfg("dense_1", 8, "relu", input_shape=[4]),
        _dense_cfg("dense_2", 3, "softmax")]}}
    path = tmp_path / "keras_mlp.h5"
    _write_keras2_h5(path, cfg, {
        "dense_1": [("kernel:0", W1), ("bias:0", np.zeros(8, np.float32))],
        "dense_2": [("kernel:0", W2), ("bias:0", np.zeros(3, np.float32))]})
    loaded = ModelGuesser.load_model_guess_type(path, device="cpu")
    assert isinstance(loaded, MultiLayerNetwork)
    X = rng_np.normal(size=(5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        loaded.output(X),
        np.asarray(JaxGuesser.load_model_guess_type(path).output(X)), **TOL)
    np.testing.assert_allclose(loaded.output(X),
                               _softmax(np.maximum(X @ W1, 0) @ W2),
                               rtol=1e-4, atol=1e-5)


def test_trained_models_vgg16(tmp_path):
    path = tmp_path / "seq.h5"
    _mlp_file(path, np.random.default_rng(3))
    net = TrainedModels.vgg16(weights_h5=str(path), device="cpu")
    X = np.random.default_rng(4).normal(size=(3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        net.output(X),
        np.asarray(JaxTrained.vgg16(weights_h5=str(path)).output(X)), **TOL)
    notop = TrainedModels.vgg16(top=False, device="cpu")
    assert isinstance(notop, MultiLayerNetwork)
    assert json.loads(notop.conf.to_json()) == json.loads(
        jax_vgg16(top=False).to_json())


# -------------------------------------------------- HDF5 against h5py
def _walk(node, out, prefix=""):
    """Every attribute and dataset under ``node`` as {path: value}."""
    for k, v in node.attrs.items():
        out[f"{prefix}@{k}"] = v
    if hasattr(node, "keys"):
        for k in node.keys():
            _walk(node[k], out, f"{prefix}/{k}")
    else:
        out[prefix] = node[()]
    return out


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), (k, type(g), type(w))
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


def test_hdf5_reads_jax_resnet50_export_as_h5py_does(resnet):
    with h5py.File(resnet["jax_path"], "r") as f:
        want = _walk(f, {})
    with hdf5.File(resnet["jax_path"]) as f:
        got = _walk(f, {})
    assert len(want) > 300
    _assert_same_tree(got, want)


def test_hdf5_port_export_reads_through_h5py_as_jax_export(resnet):
    """The port's ResNet-50 file holds, through h5py, exactly what JAX's
    (written by h5py) holds: the same attributes of the same types and
    bitwise the same arrays."""
    for name, arrs in resnet["jax_weights"].items():
        for a, b in zip(resnet["port_weights"][name], arrs):
            np.testing.assert_array_equal(a, b)
    with h5py.File(resnet["port_path"], "r") as f:
        got = _walk(f, {})
    with h5py.File(resnet["jax_path"], "r") as f:
        want = _walk(f, {})
    _assert_same_tree(got, want)


def test_hdf5_reads_what_h5py_writes(tmp_path):
    path = tmp_path / "h.h5"
    rng = np.random.default_rng(2)
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps({"a": [1, 2]})
        f.attrs["bytes"] = b"tensorflow"
        f.attrs["fixed"] = np.bytes_(b"2.2.4")
        f.attrs["names"] = [b"a", b"bcd"]
        f.attrs["strs"] = ["x", "yé"]
        f.attrs["floats"] = np.arange(5.0)
        f.attrs["int"] = np.int32(-3)
        g = f.create_group("g/h")
        g.create_dataset("x", data=rng.normal(size=(3, 4)).astype(np.float32))
        g.create_dataset("i", data=np.arange(7, dtype=np.int16))
        g.create_dataset("u", data=np.arange(4, dtype=np.uint64))
        g.create_dataset("s", data=np.float64(2.5))
        g.create_dataset("be", data=np.arange(3, dtype=">f4"))
        g.create_dataset("vs", data=np.array(["p", "qq"], dtype=object),
                         dtype=h5py.string_dtype())
        g.create_dataset("arr", data=np.zeros(2, dtype=("<f4", (3,))))
        g.create_dataset("empty", shape=(0, 3), dtype=np.float32)
        g.create_dataset("compact", data=np.arange(3, dtype=np.float32),
                         dcpl=_compact_dcpl())
        for i in range(300):            # a B-tree of more than one level
            f.create_group(f"many/k{i:03d}")
    with h5py.File(path, "r") as f:
        want = _walk(f, {})
    with hdf5.File(path) as f:
        got = _walk(f, {})
        assert f["many"].keys() == [f"k{i:03d}" for i in range(300)]
        assert "g/h/x" in f and "g/zz" not in f and "g/h/x/y" not in f
        assert f["g/h/x"].shape == (3, 4) and f["g/h/x"].dtype == np.float32
    want["/g/h/be"] = want["/g/h/be"].astype("<f4")  # read in native order
    _assert_same_tree(got, want)


def _compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def test_hdf5_writes_what_h5py_reads(tmp_path):
    path = tmp_path / "p.h5"
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 2)).astype(np.float32)
    with hdf5.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps({"b": 1})
        f.attrs["keras_version"] = b"2.2.4"
        f.attrs["fixed"] = np.bytes_(b"ab")
        f.attrs["names"] = np.array([b"w/kernel:0", b"w/bias:0"])
        f.attrs["strs"] = ["u", "vé"]
        f.attrs["vec"] = np.arange(3, dtype=np.int64)
        g = f.create_group("model_weights")
        g.create_dataset("w/kernel:0", data=x)
        g.create_dataset("w/bias:0", data=np.arange(2, dtype=np.int32))
        g.create_dataset("w/f64", data=x.astype(np.float64))
        g.create_dataset("w/none", data=np.zeros((0,), np.float32))
        f.create_group("empty")
        for i in range(300):
            f.create_group(f"many/k{i:03d}")
    with h5py.File(path, "r") as f:
        got = _walk(f, {})
        assert list(f["many"].keys()) == [f"k{i:03d}" for i in range(300)]
        assert list(f["empty"].keys()) == []
    assert got["@model_config"] == '{"b": 1}'
    assert got["@keras_version"] == "2.2.4"       # h5py's bytes: vlen ASCII
    assert got["@fixed"] == np.bytes_(b"ab")
    np.testing.assert_array_equal(got["@names"],
                                  np.array([b"w/kernel:0", b"w/bias:0"]))
    assert list(got["@strs"]) == ["u", "vé"]
    np.testing.assert_array_equal(got["/model_weights/w/kernel:0"], x)
    np.testing.assert_array_equal(got["/model_weights/w/bias:0"], [0, 1])
    assert got["/model_weights/w/f64"].dtype == np.float64
    assert got["/model_weights/w/none"].shape == (0,)
    with hdf5.File(path) as f:
        _assert_same_tree(_walk(f, {}), got)


def test_hdf5_chunked_dataset_raises_naming_the_feature(tmp_path):
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("w", data=np.ones((8, 8), np.float32),
                         chunks=(4, 4))
    with hdf5.File(path) as f:
        with pytest.raises(hdf5.HDF5FormatError,
                           match=r"chunked dataset storage.*file offset 0x"):
            np.asarray(f["w"])
    with pytest.raises(hdf5.HDF5FormatError, match="superblock version"):
        with h5py.File(tmp_path / "new.h5", "w", libver="latest") as f:
            f.create_group("g")
        hdf5.File(tmp_path / "new.h5")
