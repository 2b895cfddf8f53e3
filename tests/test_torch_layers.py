"""PyTorch port: each transformer layer's forward / prefill_forward /
decode_forward, and the whole graph's logits, against the JAX package on
the same seeded inputs and copied parameters (f32 on the CPU, rtol = atol
= 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm_conf as jax_lm_conf
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu_torch.kernels.layernorm import layernorm
from deeplearning4j_tpu_torch.models import transformer_lm_conf
from deeplearning4j_tpu_torch.nn.conf import layers as tl
from deeplearning4j_tpu_torch.utils import graph_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(name, **kw):
    """(JAX layer, port layer, JAX params, port params) for one layer."""
    jlayer, tlayer = getattr(jl, name)(**kw), getattr(tl, name)(**kw)
    jp = jlayer.init_params(jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jlayer, tlayer, jp, tp


def _x(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


ATTN = dict(n_in=32, n_out=32, num_heads=4, activation="identity")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_self_attention_forward(causal, masked, fused):
    jlay, tlay, jp, tp = _pair("SelfAttentionLayer", causal=causal,
                               fused_qkv=fused, **ATTN)
    x = _x(3, 11, 32)
    mask = None
    if masked:
        mask = (np.arange(11)[None] < np.array([[11], [4], [1]])).astype(
            np.float32)
    want, _ = jlay.forward(jp, {}, jnp.asarray(x), mask=mask)
    got, _ = tlay.forward(tp, {}, torch.from_numpy(x), mask=None
                          if mask is None else torch.from_numpy(mask))
    _close(got, want)


def test_self_attention_prefill_and_decode():
    """prefill_forward fills the cache like JAX; decode_forward at ragged
    per-row positions (one overshooting past the cache depth, which the
    clamp keeps in its last cell) matches output and cache."""
    jlay, tlay, jp, tp = _pair("SelfAttentionLayer", causal=True, **ATTN)
    b, t, t_max = 3, 6, 10
    x = _x(b, t, 32, seed=1)
    mask = (np.arange(t)[None] < np.array([[6], [3], [5]])).astype(
        np.float32)
    jcache = jlay.init_cache(b, t_max)
    tcache = tlay.init_cache(b, t_max)
    jout, jcache = jlay.prefill_forward(jp, jnp.asarray(x), jcache,
                                        mask=mask)
    tout, tcache = tlay.prefill_forward(tp, torch.from_numpy(x), tcache,
                                        mask=torch.from_numpy(mask))
    _close(tout, jout)
    for kk in ("k", "v"):
        _close(tcache[kk], jcache[kk])
    pos = np.array([6, 3, 12], np.int32)
    xd = _x(b, 1, 32, seed=2)
    jout, jcache = jlay.decode_forward(jp, jnp.asarray(xd), jcache, pos)
    tout, tcache = tlay.decode_forward(tp, torch.from_numpy(xd), tcache,
                                       torch.from_numpy(pos.astype(np.int64)))
    _close(tout, jout)
    for kk in ("k", "v"):
        _close(tcache[kk], jcache[kk])


def test_prefill_into_chosen_slots():
    """prefill_forward(slots=...) writes rows into the named cache slots
    and leaves the others untouched."""
    _, tlay, _, tp = _pair("SelfAttentionLayer", causal=True, **ATTN)
    x = torch.from_numpy(_x(2, 5, 32, seed=3))
    full = tlay.init_cache(2, 8)
    tlay.prefill_forward(tp, x, full)
    slotted = tlay.init_cache(4, 8)
    tlay.prefill_forward(tp, x, slotted, slots=torch.tensor([3, 1]))
    for kk in ("k", "v"):
        assert torch.equal(slotted[kk][3], full[kk][0])
        assert torch.equal(slotted[kk][1], full[kk][1])
        assert not slotted[kk][0].any() and not slotted[kk][2].any()


def test_layernorm_forward():
    jlay, tlay, jp, _ = _pair("LayerNormalization", n_in=16, n_out=16)
    rng = np.random.default_rng(4)
    tp = {"gamma": torch.from_numpy(rng.normal(size=16).astype(np.float32)),
          "beta": torch.from_numpy(rng.normal(size=16).astype(np.float32))}
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = _x(2, 7, 16, seed=5) * 3 + 1
    want, _ = jlay.forward(jp, {}, jnp.asarray(x))
    got, _ = tlay.forward(tp, {}, torch.from_numpy(x))
    _close(got, want)


def test_layernorm_bf16_keeps_dtype_with_f32_statistics():
    x = torch.from_numpy(_x(4, 32, seed=6) * 50 + 200).to(torch.bfloat16)
    g, b = torch.ones(32), torch.zeros(32)
    y = layernorm(x, g.to(torch.bfloat16), b.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    ref = layernorm(x.float(), g, b)
    assert (y.float() - ref).abs().max() < 2e-2


def test_feed_forward_uses_tanh_gelu():
    jlay, tlay, jp, tp = _pair("TransformerFeedForward", n_in=16, n_out=16,
                               activation="identity")
    x = _x(2, 5, 16, seed=7) * 2
    want, _ = jlay.forward(jp, {}, jnp.asarray(x))
    got, _ = tlay.forward(tp, {}, torch.from_numpy(x))
    _close(got, want)


def test_embedding_forward_and_embed_at():
    jlay, tlay, jp, tp = _pair("TokenAndPositionEmbedding", n_in=20,
                               n_out=8, max_length=12)
    ids = np.random.default_rng(8).integers(0, 20, (2, 9))
    want, _ = jlay.forward(jp, {}, jnp.asarray(ids.astype(np.int32)))
    got, _ = tlay.forward(tp, {}, torch.from_numpy(ids))
    _close(got, want)
    pos = np.array([0, 15])               # 15 clamps to max_length - 1
    _close(tlay.embed_at(tp, torch.from_numpy(ids[:, 0]),
                         torch.from_numpy(pos)),
           jlay.embed_at(jp, ids[:, 0].astype(np.int32),
                         pos.astype(np.int32)))
    with pytest.raises(ValueError, match="max_length"):
        tlay.forward(tp, {}, torch.zeros(1, 13, dtype=torch.long))


def test_output_layer_preoutput_and_softmax():
    jlay, tlay, jp, tp = _pair("RnnOutputLayer", n_in=8, n_out=30,
                               activation="softmax", loss="mcxent")
    x = _x(2, 4, 8, seed=9)
    _close(tlay.preoutput(tp, torch.from_numpy(x)),
           jlay.preoutput(jp, jnp.asarray(x)))
    want, _ = jlay.forward(jp, {}, jnp.asarray(x))
    got, _ = tlay.forward(tp, {}, torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("t", [1, 9, 32])
def test_graph_output_logits_match(t):
    """ComputationGraph.output on a 2-layer, d=32, 2-head, vocab=64 LM
    with the JAX net's parameters carried across."""
    kw = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
              max_length=32)
    jnet = JaxGraph(jax_lm_conf(**kw)).init()
    net = graph_from_numpy(
        transformer_lm_conf(**kw),
        {v: {k: np.asarray(a) for k, a in p.items()}
         for v, p in jnet.params.items()}, device="cpu")
    ids = np.random.default_rng(t).integers(0, 64, (3, t))
    want = np.asarray(jnet.output(ids.astype(np.int32))[0])
    got = net.output(ids)[0]
    assert got.shape == (3, t, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_graph_bf16_compute_casts_a_copy():
    """A bf16 compute dtype keeps f32 master params and runs the forward
    in bf16, close to the f32 logits."""
    kw = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
              max_length=32)
    conf = transformer_lm_conf(**kw)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    f32 = ComputationGraph(conf, device="cpu").init()
    bf = ComputationGraph(conf, compute_dtype=torch.bfloat16,
                          device="cpu")
    bf.params, bf.state, bf._initialized = f32.params, f32.state, True
    assert all(a.dtype == torch.float32 for p in bf.params.values()
               for a in p.values())
    ids = np.random.default_rng(0).integers(0, 64, (2, 16))
    np.testing.assert_allclose(bf.output(ids)[0], f32.output(ids)[0],
                               atol=2e-2)
