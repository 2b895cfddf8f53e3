"""PyTorch port, the transformer layer confs in a sequential network on the
CPU: input-kind and shape inference of the four transformer layers (they
are recurrent-kind layers, as in the JAX package), a GravesLSTM →
SelfAttentionLayer → LayerNormalization → RnnOutputLayer list with no
preprocessors, the flagship graph's JSON, and TokenAndPositionEmbedding on
integer ids and on one-hot input — each against the JAX package on the
same seeded inputs, weights carried across by ``network_from_numpy``.

Tolerance: f32 parity at 1e-5 (ROADMAP rule 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm_conf as jax_lm_conf
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf.config import \
    NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu_torch.models import transformer_lm_conf
from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                              MultiLayerConfiguration,
                                              NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.utils import network_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)

LAYERS = [
    ("SelfAttentionLayer", dict(n_out=8, num_heads=2)),
    ("LayerNormalization", {}),
    ("TransformerFeedForward", {}),
    ("TransformerFeedForward", dict(n_out=6)),
    ("TokenAndPositionEmbedding", dict(n_out=8, max_length=16)),
]


@pytest.mark.parametrize("name,kw", LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(LAYERS)])
@pytest.mark.parametrize("it", [("recurrent", 6, 5), ("feed_forward", 6)])
def test_layer_input_kind_and_output_type_match_jax(name, kw, it):
    """input_kind, the n_in / n_out set from an input type and the output
    type, for each transformer layer conf, as in the JAX package."""
    jlay, tlay = getattr(jl, name)(**kw), getattr(tl, name)(**kw)
    jit_ = getattr(JaxInputType, it[0])(*it[1:])
    tit = getattr(InputType, it[0])(*it[1:])
    assert tlay.input_kind() == jlay.input_kind() == "rnn"
    jlay.set_n_in(jit_)
    tlay.set_n_in(tit)
    assert (tlay.n_in, tlay.n_out) == (jlay.n_in, jlay.n_out)
    assert (tlay.get_output_type(tit).to_dict()
            == jlay.get_output_type(jit_).to_dict())


def _stack_conf(nnc, it, lay):
    return (nnc.Builder().seed(4).list()
            .layer(lay.GravesLSTM(n_out=8, activation="tanh"))
            .layer(lay.SelfAttentionLayer(n_out=8, num_heads=2,
                                          activation="identity"))
            .layer(lay.LayerNormalization())
            .layer(lay.RnnOutputLayer(n_out=5, loss="mcxent",
                                      activation="softmax"))
            .set_input_type(it.recurrent(8, 12)).build())


def test_transformer_list_needs_no_preprocessors_like_jax():
    """GravesLSTM → SelfAttentionLayer → LayerNormalization →
    RnnOutputLayer stays recurrent throughout: no preprocessors, the same
    JSON, and the same output on [3, 12, 8]."""
    want = _stack_conf(JaxNNC, JaxInputType, jl)
    got = _stack_conf(NeuralNetConfiguration, InputType, tl)
    assert got.input_preprocessors == {} == want.input_preprocessors
    assert got.to_json() == want.to_json()
    again = MultiLayerConfiguration.from_json(got.to_json())
    assert again.to_json() == got.to_json()
    jnet = JaxNet(want).init()
    net = network_from_numpy(
        got, [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params],
        device="cpu")
    x = np.random.default_rng(1).normal(size=(3, 12, 8)).astype(np.float32)
    out = net.output(x)
    assert tuple(out.shape) == (3, 12, 5)
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)), **TOL)


def test_transformer_lm_conf_json_unchanged():
    """The graph path sets every n_in, so its JSON stays byte-identical."""
    for causal_kw in ({}, dict(max_length=64)):
        want = jax_lm_conf(50, d_model=16, num_heads=2, num_layers=2,
                           **causal_kw)
        got = transformer_lm_conf(50, d_model=16, num_heads=2, num_layers=2,
                                  **causal_kw)
        assert got.to_json() == want.to_json()


@pytest.mark.parametrize("form", ["int32", "int64", "float_ids", "one_hot"])
def test_embedding_ids_and_one_hot_match_jax(form):
    """Ids are cast to integers and a one-hot [N, T, V] input goes through
    argmax, as the JAX layer does."""
    kw = dict(n_in=11, n_out=8, max_length=16)
    jlay, tlay = jl.TokenAndPositionEmbedding(**kw), \
        tl.TokenAndPositionEmbedding(**kw)
    jp = jlay.init_params(jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ids = np.random.default_rng(7).integers(0, 11, (3, 9))
    x = {"int32": ids.astype(np.int32), "int64": ids,
         "float_ids": ids.astype(np.float32),
         "one_hot": np.eye(11, dtype=np.float32)[ids]}[form]
    want, _ = jlay.forward(jp, {}, jnp.asarray(x))
    got, _ = tlay.forward(tp, {}, torch.from_numpy(x))
    assert tuple(got.shape) == (3, 9, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
