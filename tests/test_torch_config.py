"""PyTorch port: configuration JSON, weights carried across from JAX, and
the no-fallback device rules (deeplearning4j_tpu_torch vs the JAX
reference, on the CPU)."""

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm_conf as jax_lm_conf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.utils.serializer import ModelSerializer
from deeplearning4j_tpu_torch.kernels import cuda_lib
from deeplearning4j_tpu_torch.models import transformer_lm_conf
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph.graph_config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.helpers import get_helper
from deeplearning4j_tpu_torch.utils import (graph_from_numpy,
                                            params_from_numpy,
                                            restore_computation_graph)

LM_CONFIGS = [
    dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
         max_length=32),
    dict(vocab_size=32000, d_model=768, num_heads=12, num_layers=12,
         max_length=577),
    dict(vocab_size=50, d_model=48, num_heads=3, num_layers=1, ff_mult=2,
         max_length=16, drop_out=0.9, learning_rate=1e-2, seed=7),
]


@pytest.mark.parametrize("kw", LM_CONFIGS)
def test_lm_conf_json_identical(kw):
    """The port builds byte-identical configuration JSON."""
    assert transformer_lm_conf(**kw).to_json() == \
        jax_lm_conf(**kw).to_json()


@pytest.mark.parametrize("kw", LM_CONFIGS)
def test_lm_conf_json_round_trips(kw):
    """The port reads JSON the JAX package wrote and writes it back
    unchanged."""
    text = jax_lm_conf(**kw).to_json()
    conf = ComputationGraphConfiguration.from_json(text)
    assert conf.to_json() == text
    assert conf.topological_order == json.loads(text)["topological_order"]


def test_from_json_rejects_other_documents():
    with pytest.raises(ValueError):
        ComputationGraphConfiguration.from_json(
            json.dumps({"@type": "InputType", "kind": "ff", "size": 3}))


def test_checkpoint_loads_byte_equal(tmp_path):
    """A ModelSerializer.write_model zip loads into the port with every
    parameter byte-equal and the same configuration."""
    jnet = JaxGraph(jax_lm_conf(vocab_size=40, d_model=16, num_heads=2,
                                num_layers=2, max_length=24)).init()
    path = tmp_path / "lm.zip"
    ModelSerializer.write_model(jnet, path)
    net = restore_computation_graph(path, device="cpu")
    assert net.conf.to_json() == jnet.conf.to_json()
    assert set(net.params) == set(jnet.params)
    for v, p in jnet.params.items():
        assert set(net.params[v]) == set(p)
        for k, a in p.items():
            got = net.params[v][k]
            assert got.device.type == "cpu"
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == np.asarray(a).tobytes(), (v, k)


def test_params_from_numpy_rejects_unknown_vertex():
    conf = transformer_lm_conf(vocab_size=8, d_model=8, num_heads=1,
                               num_layers=1, max_length=8)
    with pytest.raises(ValueError, match="unknown vertices"):
        params_from_numpy(conf, {"nope": {"W": np.zeros(2, np.float32)}},
                          "cpu")


def test_graph_from_numpy_matches_restore(tmp_path):
    jnet = JaxGraph(jax_lm_conf(vocab_size=20, d_model=8, num_heads=2,
                                num_layers=1, max_length=8)).init()
    arrays = {v: {k: np.asarray(a) for k, a in p.items()}
              for v, p in jnet.params.items()}
    net = graph_from_numpy(transformer_lm_conf(
        vocab_size=20, d_model=8, num_heads=2, num_layers=1, max_length=8),
        arrays, device="cpu")
    x = np.arange(6, dtype=np.int64).reshape(1, 6)
    np.testing.assert_allclose(net.output(x)[0], np.asarray(jnet.output(
        x.astype(np.int32))[0]), rtol=1e-5, atol=1e-5)


def test_seeded_init_is_deterministic():
    conf = transformer_lm_conf(vocab_size=30, d_model=16, num_heads=2,
                               num_layers=1, max_length=8, seed=3)
    a = ComputationGraph(conf, device="cpu").init()
    b = ComputationGraph(conf, device="cpu").init()
    for v in a.params:
        for k in a.params[v]:
            assert torch.equal(a.params[v][k], b.params[v][k])
    assert a.num_params() == sum(np.asarray(x).size for p in JaxGraph(
        jax_lm_conf(vocab_size=30, d_model=16, num_heads=2, num_layers=1,
                    max_length=8, seed=3)).init().params.values()
        for x in p.values())


# ---- no fallback: without CUDA the card path raises, it never degrades
def test_kernel_loader_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_lib.load("shortseq_attention")
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_lib.build(["flash_forward"])


def test_graph_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = transformer_lm_conf(vocab_size=8, d_model=8, num_heads=1,
                               num_layers=1, max_length=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ComputationGraph(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph_from_numpy(conf, {}, device=None)


def test_cpu_tensors_get_no_attention_helper():
    """CPU tensors take the layer's materialized softmax; only CUDA
    tensors reach a kernel."""
    assert get_helper("attention", "cpu") is None


def test_kernel_args_must_be_cuda_tensors():
    q = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lib.check_attention_args(q, q, q, None, 1)
