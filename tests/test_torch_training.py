"""PyTorch port, training: LayerNorm's backward, the fused sparse
cross-entropy (stored and chunked branches), every updater, lr policy and
gradient normalization, adam steps of a small LM, dropout, checkpoints with
training state, and the kernel seam's autograd path — each against the JAX
package on the same seeded inputs, on the CPU.

Tolerances: f32 parity at 1e-5 (ROADMAP rule 1) unless a test says
otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels import fused_ce as jce
from deeplearning4j_tpu.kernels.layernorm import layernorm as jax_layernorm
from deeplearning4j_tpu.kernels.pallas_attention import \
    register_pallas_flash_attention
from deeplearning4j_tpu.models import transformer_lm_conf as jax_lm_conf
from deeplearning4j_tpu.nn import helpers as jhelpers
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops import updaters as jupd
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.utils.serializer import ModelSerializer
from deeplearning4j_tpu_torch.kernels import fused_ce as tce
from deeplearning4j_tpu_torch.kernels.flash_forward import cuda_attention
from deeplearning4j_tpu_torch.kernels.layernorm import layernorm
from deeplearning4j_tpu_torch.models import lm_batch_sparse, \
    transformer_lm_conf
from deeplearning4j_tpu_torch.nn.conf.layers import (SelfAttentionLayer,
                                                     attention as tattention)
from deeplearning4j_tpu_torch.ops import rng as rngmod
from deeplearning4j_tpu_torch.ops import updaters as tupd
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.utils import (graph_from_numpy,
                                            restore_computation_graph,
                                            write_model)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- LayerNorm
def test_layernorm_forward_and_backward_match_jax_vjp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 2 + 0.5
    gamma = rng.normal(size=16).astype(np.float32)
    beta = rng.normal(size=16).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a, g, b: jax_layernorm(a, g, b, 1e-5),
                          jnp.asarray(x), jnp.asarray(gamma),
                          jnp.asarray(beta))
    want = vjp(jnp.asarray(dy))
    xt, gt, bt = (_t(a).requires_grad_(True) for a in (x, gamma, beta))
    y = layernorm(xt, gt, bt, 1e-5)
    got = torch.autograd.grad(y, (xt, gt, bt), _t(dy))
    np.testing.assert_allclose(_np(y), np.asarray(want_y), **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


# ------------------------------------------------------------------ fused CE
def _ce_case(seq, mask_kind, seed=0, n=3, t=5, d=8, v=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, d) if seq else (n, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32) * 0.5
    b = rng.normal(size=v).astype(np.float32) * 0.1
    ids = rng.integers(0, v, (n, t) if seq else (n,)).astype(np.int32)
    mask = None
    if mask_kind == "cells":
        mask = (rng.random((n, t) if seq else (n,)) > 0.3).astype(np.float32)
    elif mask_kind == "examples":
        mask = np.array([1.0, 0.0, 1.0], np.float32)[:n]
    return x, w, b, ids, mask


@pytest.mark.parametrize("chunked", [False, True], ids=["stored", "chunked"])
@pytest.mark.parametrize("seq,mask_kind", [(True, None), (True, "cells"),
                                           (True, "examples"), (False, None),
                                           (False, "cells")])
def test_fused_ce_loss_and_grads_match_jax(monkeypatch, chunked, seq,
                                           mask_kind):
    """fused_sparse_ce_score and its dx / dW / db against the JAX custom
    VJP. The chunked branch is forced on both sides by lowering
    MATERIALIZE_LIMIT and CHUNK_ROWS (4 rows a chunk, a ragged last one)."""
    if chunked:
        for mod in (jce, tce):
            monkeypatch.setattr(mod, "MATERIALIZE_LIMIT", 16)
            monkeypatch.setattr(mod, "CHUNK_ROWS", 4)
    x, w, b, ids, mask = _ce_case(seq, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(x_, w_, b_):
        return jce.fused_sparse_ce_score({"W": w_, "b": b_}, x_,
                                         jnp.asarray(ids), jmask)
    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (_t(a).requires_grad_(True) for a in (x, w, b))
    got = tce.fused_sparse_ce_score({"W": wt, "b": bt}, xt, _t(ids),
                                    None if mask is None else _t(mask))
    got_g = torch.autograd.grad(got, (xt, wt, bt))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for g, wg in zip(got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(wg), **TOL)


def test_sparse_ce_sum_matches_jax_at_bf16():
    """The stored branch keeps bf16 logits like the JAX one: the f32 sum
    agrees to bf16 rounding of the logits (rtol 1e-2)."""
    x, w, b, ids, _ = _ce_case(False, None, seed=3, n=6)
    wts = np.ones(6, np.float32)
    want = jce.sparse_softmax_ce_sum(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
        jnp.asarray(ids), jnp.asarray(wts))
    got = tce.sparse_softmax_ce_sum(
        *(_t(a).to(torch.bfloat16) for a in (x, w, b)), _t(ids).long(),
        _t(wts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-2)


# ------------------------------------------------------------------ updaters
@pytest.mark.parametrize("name", list(tupd.UPDATER_NAMES))
def test_updater_matches_jax(name):
    """Three updates of every rule from the same gradients: steps and
    state agree."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(4, 3)).astype(np.float32)
    kw = dict(momentum=0.8, adam_mean_decay=0.85, adam_var_decay=0.99,
              rho=0.9, rms_decay=0.9, epsilon=1e-6)
    ju, tu = jupd.make_updater(name, **kw), tupd.make_updater(name, **kw)
    js, ts = ju.init(jnp.asarray(p)), tu.init(_t(p))
    for it in range(3):
        g = rng.normal(size=p.shape).astype(np.float32)
        jstep, js = ju.update(jnp.asarray(g), js, 0.05,
                              jnp.asarray(it, jnp.float32))
        tstep, ts = tu.update(_t(g), ts, 0.05, float(it))
        np.testing.assert_allclose(_np(tstep), np.asarray(jstep), **TOL)
        for k in (js or {}):
            np.testing.assert_allclose(_np(ts[k]), np.asarray(js[k]), **TOL)


@pytest.mark.parametrize("policy", [None, "exponential", "inverse", "poly",
                                    "sigmoid", "step", "torchstep",
                                    "schedule"])
def test_schedule_lr_matches_jax(policy):
    kw = dict(decay_rate=0.9, steps=3.0, power=0.75, max_iterations=20.0,
              schedule={0: 0.1, 4: 0.05, 9: 0.01})
    for it in (0, 1, 4, 7, 12, 25):
        want = jupd.schedule_lr(0.1, policy, jnp.asarray(it, jnp.float32),
                                **kw)
        np.testing.assert_allclose(tupd.schedule_lr(0.1, policy, it, **kw),
                                   np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("strategy", [None, "renormalizel2perlayer",
                                      "renormalizel2perparamtype",
                                      "clipelementwiseabsolutevalue",
                                      "clipl2perlayer", "clipl2perparamtype"])
@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_normalize_gradient_matches_jax(strategy, scale):
    """Each strategy, with norms below (0.1) and above (10) the threshold
    of 1.5."""
    rng = np.random.default_rng(2)
    grads = {"W": rng.normal(size=(3, 4)).astype(np.float32) * scale,
             "b": rng.normal(size=4).astype(np.float32) * scale}
    want = jupd.normalize_gradient({k: jnp.asarray(g) for k, g in
                                    grads.items()}, strategy, 1.5)
    got = tupd.normalize_gradient({k: _t(g) for k, g in grads.items()},
                                  strategy, 1.5)
    for k in grads:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), **TOL)


# ------------------------------------------------------------- adam LM steps
LM = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
          max_length=16, drop_out=0.0, learning_rate=3e-4)


def _lm_pair(**kw):
    """(JAX net, port net on the CPU) with the JAX net's initial
    weights."""
    kw = {**LM, **kw}
    jnet = JaxGraph(jax_lm_conf(**kw)).init()
    arrays = {v: {k: np.asarray(a) for k, a in p.items()}
              for v, p in jnet.params.items()}
    return jnet, graph_from_numpy(transformer_lm_conf(**kw), arrays,
                                  device="cpu")


def _lm_batch(seed=0, n=4, t=16, vocab=64):
    return lm_batch_sparse(np.random.default_rng(seed).integers(
        0, vocab, (n, t + 1)))


def _assert_params_close(jnet, tnet, atol=1e-5):
    for v, p in jnet.params.items():
        for k, a in p.items():
            np.testing.assert_allclose(_np(tnet.params[v][k]), np.asarray(a),
                                       rtol=0, atol=atol, err_msg=f"{v}.{k}")


@pytest.mark.parametrize("lengths", [None, [16, 9, 1, 5]],
                         ids=["unmasked", "ragged"])
def test_adam_steps_match_jax(lengths):
    """3 adam steps of a 2-layer LM (vocab 64, d 32, 2 heads, T 16, B 4,
    f32): each step's loss to rtol 1e-5 and the parameters after step 3 to
    atol 1e-5. The ragged features mask reaches attention as its key mask
    and averages the cross-entropy over present cells."""
    jnet, tnet = _lm_pair()
    x, y = _lm_batch()
    fm = None if lengths is None else \
        (np.arange(16)[None] < np.asarray(lengths)[:, None]).astype(
            np.float32)
    for _ in range(3):
        jnet.fit_batch(JaxDataSet(x, y, fm))
        tnet.fit_batch(DataSet(x, y, fm))
        assert torch.is_tensor(tnet.score_value)
        np.testing.assert_allclose(float(tnet.score_value),
                                   float(jnet.score_value), rtol=1e-5)
    assert tnet.iteration == jnet.iteration == 3
    _assert_params_close(jnet, tnet)


def test_score_and_gradient_match_jax():
    jnet, tnet = _lm_pair()
    x, y = _lm_batch(seed=1)
    np.testing.assert_allclose(tnet.score(DataSet(x, y)),
                               jnet.score(JaxDataSet(x, y)), rtol=1e-5)
    jg, js = jnet.compute_gradient_and_score(JaxDataSet(x, y))
    tg, ts = tnet.compute_gradient_and_score(DataSet(x, y))
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    for v, p in jg.items():
        for k, g in p.items():
            np.testing.assert_allclose(_np(tg[v][k]), np.asarray(g),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{v}.{k}")


def test_sparse_labels_on_a_consumed_head_raise():
    """Integer labels on an output whose activation another vertex reads
    cannot take the fused path, and raise instead of broadcasting."""
    _, tnet = _lm_pair()
    tnet.conf.vertex_inputs["extra"] = ["out"]
    x, y = _lm_batch()
    with pytest.raises(ValueError, match="fused-CE eligible"):
        tnet.fit_batch(DataSet(x, y))


# ------------------------------------------------------------------- dropout
def test_dropout_is_deterministic_and_inverted():
    layer = SelfAttentionLayer(n_in=8, n_out=8, drop_out=0.8)
    x = torch.ones(400, 500)

    def draw(it, idx=3):
        seed = rngmod.for_layer(rngmod.for_iteration(
            rngmod.for_purpose(42, "dropout"), it), idx)
        return layer.maybe_dropout(x, train=True,
                                   gen=rngmod.generator(seed, "cpu"))
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.005
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.8))
    assert torch.equal(layer.maybe_dropout(x, train=False, gen=None), x)


def test_dropout_in_fit_batch_is_seeded_per_iteration():
    """Two nets from the same weights and seed take identical dropout
    steps; without dropout the step differs."""
    nets = [_lm_pair(drop_out=0.9)[1] for _ in range(2)]
    plain = _lm_pair()[1]
    x, y = _lm_batch(seed=2)
    for net in nets + [plain]:
        net.fit_batch(DataSet(x, y))
    w = [n.params["attn0"]["Wq"] for n in nets + [plain]]
    assert torch.equal(w[0], w[1]) and not torch.allclose(w[0], w[2])


# --------------------------------------------------------------- checkpoints
def test_checkpoint_carries_training_state_both_ways(tmp_path):
    """JAX trains 2 steps and writes; the port restores (updater state and
    iteration included) and takes step 3 like JAX's step 3; the port
    writes, and JAX restores the same parameters, state and iteration."""
    jnet, _ = _lm_pair()
    x, y = _lm_batch(seed=3)
    for _ in range(2):
        jnet.fit_batch(JaxDataSet(x, y))
    ModelSerializer.write_model(jnet, tmp_path / "jax.zip")
    tnet = restore_computation_graph(tmp_path / "jax.zip", device="cpu")
    assert tnet.iteration == 2
    np.testing.assert_array_equal(
        _np(tnet.updater_state["ffn1"]["W1"]["v"]),
        np.asarray(jnet.updater_state["ffn1"]["W1"]["v"]))
    jnet.fit_batch(JaxDataSet(x, y))
    tnet.fit_batch(DataSet(x, y))
    np.testing.assert_allclose(float(tnet.score_value),
                               float(jnet.score_value), rtol=1e-5)
    _assert_params_close(jnet, tnet)

    write_model(tnet, tmp_path / "port.zip")
    back = ModelSerializer.restore_computation_graph(tmp_path / "port.zip")
    assert back.iteration == 3
    for v, p in tnet.params.items():
        for k, a in p.items():
            np.testing.assert_array_equal(np.asarray(back.params[v][k]),
                                          _np(a))
            for slot, s in tnet.updater_state[v][k].items():
                np.testing.assert_array_equal(
                    np.asarray(back.updater_state[v][k][slot]), _np(s))


# ------------------------------------------------------ the kernel seam path
def test_kernel_seam_trains_like_pallas_flash(monkeypatch):
    """The attention seam forced to cuda_attention on CPU tensors, so the
    ShortAttention autograd Function runs its plain forward and backward,
    against the JAX net with the Pallas flash kernels (interpret mode):
    2 train steps, losses to rtol 1e-5 and parameters to atol 1e-5."""
    monkeypatch.setattr(tattention, "get_helper",
                        lambda kind, device: cuda_attention)
    snapshot = jhelpers.snapshot_helper("attention")
    register_pallas_flash_attention(min_seq_len=1, q_block=8, k_block=8,
                                    interpret=True)
    try:
        jnet, tnet = _lm_pair()
        x, y = _lm_batch(seed=4)
        fm = (np.arange(16)[None] < np.array([[16], [11], [3], [8]])).astype(
            np.float32)
        for _ in range(2):
            jnet.fit_batch(JaxDataSet(x, y, fm))
            tnet.fit_batch(DataSet(x, y, fm))
            np.testing.assert_allclose(float(tnet.score_value),
                                       float(jnet.score_value), rtol=1e-5)
        _assert_params_close(jnet, tnet)
    finally:
        jhelpers.restore_helper("attention", snapshot)
