"""PyTorch port, sequence parallelism on the CPU: ``tests/
test_sequence_parallel.py``, ``test_transformer.py``'s
``TestTransformerSequenceParallel`` / ``TestSPRegressions`` and
``test_tp_pp_ep.py``'s SP trainer test mirrored on the port, each mesh a
list of CPU devices (several shards on one device, as on one card). The
ring runs its flash-kernel composition (``_RingFlash``; on CPU tensors
every pair takes the wrappers' plain versions) and its plain streaming
version (``impl="jnp"``). Then the port against the JAX package on the
same numpy inputs and carried weights, the JAX side on the conftest's host
devices through its jnp ring or its single-device reference (no Pallas
interpret mode): ring attention, the attention-block trainer, and the LM
trainer at sp 4 and at (data 2, sp 2).

Tolerances: ring outputs against the reference at rtol / atol 1e-5,
their gradients at the JAX tests' rtol 2e-3 / atol 2e-4; the LM's
parameters after an adam step at the JAX tests' rtol 2e-3 / atol 1e-4
(adam divides tiny gradients by √v + ε, which amplifies the ring's
reduction-order noise) and the score within 1e-4; the attention block's
SGD step at rtol 1e-5 / atol 1e-6."""

import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm_conf as jax_lm_conf
from deeplearning4j_tpu.nn.conf.layers.attention import \
    SelfAttentionLayer as JaxSelfAttention
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel.sequence import (
    GraphSequenceParallelTrainer as JaxGraphSP,
    SequenceParallelTrainer as JaxSPTrainer,
    attention_reference as jax_reference)
from deeplearning4j_tpu_torch.kernels import flash_backward as fb
from deeplearning4j_tpu_torch.kernels import flash_forward as ff
from deeplearning4j_tpu_torch.models import lm_batch, transformer_lm_conf
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.parallel import (
    GraphSequenceParallelTrainer, SequenceParallelTrainer,
    attention_reference, disable_ring_attention, make_mesh,
    ring_self_attention, sequence_sharded)
from deeplearning4j_tpu_torch.parallel.sequence import (_pairs, _ring_block,
                                                        _ring_streaming)
from deeplearning4j_tpu_torch.utils import graph_from_numpy

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the workers of a parallel run share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_attention_slot():
    """Every test leaves the process-wide ``attention`` claim as it found
    it."""
    snap = helpers.snapshot_helper("attention")
    yield
    helpers.restore_helper("attention", snap)


def _sp(n):
    return make_mesh(axis_names=("sp",), devices=[CPU] * n)


def _qkv(rng, b, t, h, d):
    return [torch.as_tensor(rng.normal(size=(b, t, h, d)),
                            dtype=torch.float32) for _ in range(3)]


def _tiny_lm(vocab=12, **kw):
    kw.setdefault("d_model", 32)
    kw.setdefault("num_heads", 2)
    kw.setdefault("num_layers", 2)
    kw.setdefault("max_length", 32)
    kw.setdefault("learning_rate", 1e-2)
    kw.setdefault("seed", 5)
    return ComputationGraph(transformer_lm_conf(vocab, **kw),
                            device="cpu").init()


def _cyclic_batch(rng, vocab=12, n=16, t=16):
    starts = rng.integers(0, vocab, (n, 1))
    seq = (starts + np.arange(t + 1)[None, :]) % vocab
    return DataSet(*lm_batch(seq, vocab))


def _close_graphs(a, b, rtol=2e-3, atol=1e-4):
    for name in b.params:
        for k in b.params[name]:
            np.testing.assert_allclose(a.params[name][k].numpy(),
                                       b.params[name][k].numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{name}/{k}")


# =================================================== mirrors of the oracle
class TestRingAttention:
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_reference(self, causal, rng_np):
        q, k, v = _qkv(rng_np, 2, 32, 4, 8)
        got = ring_self_attention(q, k, v, _sp(8), causal=causal)
        np.testing.assert_allclose(got.numpy(), attention_reference(
            q, k, v, causal).numpy(), rtol=1e-5, atol=1e-5)

    def test_grads_flow(self, rng_np):
        q, k, v = _qkv(rng_np, 1, 16, 2, 4)
        q.requires_grad_(True)
        g_ring, = torch.autograd.grad(
            (ring_self_attention(q, k, v, _sp(8)) ** 2).sum(), q)
        g_ref, = torch.autograd.grad(
            (attention_reference(q, k, v) ** 2).sum(), q)
        np.testing.assert_allclose(g_ring.numpy(), g_ref.numpy(),
                                   rtol=2e-3, atol=2e-4)


class TestRingKernelComposition:
    @pytest.mark.parametrize("causal", [False, True])
    def test_kernel_ring_matches_streaming_ring(self, causal, rng_np):
        q, k, v = _qkv(rng_np, 2, 32, 4, 8)
        ref = attention_reference(q, k, v, causal)
        for impl in ("jnp", "pallas"):
            got = ring_self_attention(q, k, v, _sp(8), causal=causal,
                                      impl=impl)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=impl)

    def test_kernel_ring_grads_match_reference(self, rng_np):
        qkv = [x.requires_grad_(True) for x in _qkv(rng_np, 1, 16, 2, 4)]
        gp = torch.autograd.grad((ring_self_attention(
            *qkv, _sp(8), causal=True) ** 2).sum(), qkv)
        gr = torch.autograd.grad((attention_reference(
            *qkv, causal=True) ** 2).sum(), qkv)
        for x, y, n in zip(gp, gr, "qkv"):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-3,
                                       atol=2e-4, err_msg=n)

    def test_long_t_parity(self, rng_np):
        """T 2048 over 8 shards (shard length 256): the kernel ring
        against the streaming ring."""
        q, k, v = _qkv(rng_np, 1, 2048, 2, 8)
        a = ring_self_attention(q, k, v, _sp(8), causal=True)
        b = ring_self_attention(q, k, v, _sp(8), causal=True, impl="jnp")
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)

    def test_any_shard_length_takes_kernel(self, rng_np):
        """JAX's ring falls back to its jnp ring where no TPU block tiles
        the shard (520); the port's kernels mask any length, so its ring
        keeps the pair kernels (the block table is kept for the API)."""
        assert _ring_block(520) is None
        assert _ring_block(101) == 101
        assert _ring_block(256) == 256
        assert _ring_block(1536) == 512
        q = _qkv(rng_np, 1, 4 * 130, 2, 4)[0]
        n0 = ff.flash_forward.launches
        got = ring_self_attention(q, q, q, _sp(4), causal=True)
        np.testing.assert_allclose(got.numpy(), attention_reference(
            q, q, q, causal=True).numpy(), rtol=2e-4, atol=2e-5)
        assert ff.flash_forward.launches == n0    # CPU: plain pairs

    def test_odd_small_shard(self, rng_np):
        q = _qkv(rng_np, 1, 8 * 101, 2, 4)[0]
        got = ring_self_attention(q, q, q, _sp(8), causal=True)
        np.testing.assert_allclose(got.numpy(), attention_reference(
            q, q, q, causal=True).numpy(), rtol=2e-4, atol=2e-5)

    @pytest.mark.parametrize("sp", [2, 4])
    def test_causal_ring_skips_future_pairs(self, sp):
        """Under causal masking the ring runs sp(sp+1)/2 pairs (the
        card's B3 / B4 / B5 launch count a layer); unmasked, sp²."""
        assert len(_pairs(sp, True)) == sp * (sp + 1) // 2
        assert len(_pairs(sp, False)) == sp * sp


class TestSequenceParallelTrainer:
    def test_sp_step_matches_single_device(self, rng_np):
        conf = SelfAttentionLayer(n_in=8, n_out=8, num_heads=2, causal=True,
                                  weight_init="xavier")
        sp = SequenceParallelTrainer(conf, _sp(4), learning_rate=0.1, seed=5)
        single = SequenceParallelTrainer(conf, _sp(1), learning_rate=0.1,
                                         seed=5)
        x = rng_np.normal(size=(2, 16, 8)).astype(np.float32)
        y = rng_np.normal(size=(2, 16, 8)).astype(np.float32)
        assert abs(sp.fit_batch(x, y) - single.fit_batch(x, y)) < 1e-5
        for k in single.params:
            np.testing.assert_allclose(sp.params[k].numpy(),
                                       single.params[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


class TestTransformerSequenceParallel:
    def test_sp_step_matches_single_device(self, rng_np):
        ds = _cyclic_batch(rng_np, n=4, t=16)
        solo = _tiny_lm()
        solo.fit_batch(ds)
        sp_net = _tiny_lm()
        trainer = GraphSequenceParallelTrainer(sp_net, mesh=_sp(8))
        try:
            trainer.fit_batch(ds)
        finally:
            disable_ring_attention()
        _close_graphs(sp_net, solo)
        assert abs(float(sp_net.score_value) - float(solo.score_value)) < 1e-4

    def test_sp_training_converges(self, rng_np):
        net = _tiny_lm()
        ds = _cyclic_batch(rng_np, n=8, t=16)
        s0 = net.score(ds)
        with GraphSequenceParallelTrainer(net, mesh=_sp(4)) as trainer:
            for _ in range(60):
                trainer.fit_batch(ds)
        assert net.score(ds) < 0.3 * s0

    def test_indivisible_sequence_rejected(self, rng_np):
        with GraphSequenceParallelTrainer(_tiny_lm(), mesh=_sp(8)) as tr:
            with pytest.raises(ValueError):
                tr.fit_batch(_cyclic_batch(rng_np, n=2, t=11))


class TestSPRegressions:
    def test_ring_helper_reenables_after_disable(self):
        helpers.restore_helper("attention", (None, False))
        GraphSequenceParallelTrainer(_tiny_lm(), _sp(2))
        assert helpers.get_helper("attention", "cpu") is not None
        disable_ring_attention()
        assert helpers.get_helper("attention", "cpu") is None
        GraphSequenceParallelTrainer(_tiny_lm(), _sp(2))
        assert helpers.get_helper("attention", "cpu") is not None

    def test_dp_sp_composed_mesh_matches_single_device(self, rng_np):
        ds = _cyclic_batch(rng_np, n=4, t=16)
        solo = _tiny_lm()
        solo.fit_batch(ds)
        sp_net = _tiny_lm()
        mesh = make_mesh(axis_names=("data", "sp"), shape=(2, 4),
                         devices=[CPU] * 8)
        with GraphSequenceParallelTrainer(sp_net, mesh=mesh,
                                          data_axis="data") as trainer:
            trainer.fit_batch(ds)
            assert trainer.data_axis == "data"
        assert abs(float(sp_net.score_value) -
                   float(solo.score_value)) < 1e-4
        _close_graphs(sp_net, solo)

    def test_dp_sp_rejects_indivisible_batch(self, rng_np):
        mesh = make_mesh(axis_names=("data", "sp"), shape=(2, 4),
                         devices=[CPU] * 8)
        with GraphSequenceParallelTrainer(_tiny_lm(), mesh=mesh,
                                          data_axis="data") as trainer:
            with pytest.raises(ValueError, match="batch"):
                trainer.fit_batch(_cyclic_batch(rng_np, n=3, t=16))

    def test_sp_long_t_step_matches_single_device(self, rng_np):
        """T 2048 at sp 4 (shard length 512): one SP step of the LM
        equals one single-device step."""
        kw = dict(d_model=16, num_heads=2, num_layers=1, max_length=2048)
        ds = _cyclic_batch(rng_np, n=1, t=2048)
        solo = _tiny_lm(**kw)
        solo.fit_batch(ds)
        sp_net = _tiny_lm(**kw)
        with GraphSequenceParallelTrainer(sp_net, mesh=_sp(4)) as trainer:
            trainer.fit_batch(ds)
        assert abs(float(sp_net.score_value) -
                   float(solo.score_value)) < 1e-3
        _close_graphs(sp_net, solo, rtol=5e-3, atol=2e-4)

    def test_trainer_close_restores_previous_helper(self):
        def marker_helper(conf, q, k, v, mask):
            return None

        helpers.restore_helper("attention", (None, False))
        helpers.register_helper("attention", marker_helper, ("cpu",))
        with GraphSequenceParallelTrainer(_tiny_lm(), _sp(2)):
            got = helpers.get_helper("attention", "cpu")
            assert got is not None and got is not marker_helper
        assert helpers.get_helper("attention", "cpu") is marker_helper
        helpers.restore_helper("attention", (None, False))
        t2 = GraphSequenceParallelTrainer(_tiny_lm(), _sp(2))
        assert helpers.get_helper("attention", "cpu") is not None
        t2.close()
        t2.close()                      # idempotent
        assert helpers._CLAIMED.get("attention") is None

    def test_non_lifo_close_does_not_resurrect_stale_ring(self, rng_np):
        def custom_fn(conf, q, k, v, mask):
            return None

        helpers.restore_helper("attention", (None, False))
        helpers.register_helper("attention", custom_fn, ("cpu",))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t1 = GraphSequenceParallelTrainer(_tiny_lm(), _sp(2))
            t2 = GraphSequenceParallelTrainer(_tiny_lm(), _sp(2))
        with pytest.warns(UserWarning, match="LIFO"):
            t1.close()
        assert helpers._CLAIMED["attention"][0] is t2._ring_helper
        with pytest.raises(RuntimeError, match="closed"):
            t1.fit_batch(_cyclic_batch(rng_np, n=2, t=16))
        t2.close()
        assert helpers.get_helper("attention", "cpu") is custom_fn
        with pytest.raises(RuntimeError, match="closed"):
            t2.fit_batch(_cyclic_batch(rng_np, n=2, t=16))

    def test_displaced_trainer_refuses_to_train(self, rng_np):
        t1 = GraphSequenceParallelTrainer(_tiny_lm(), _sp(2))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            helpers.register_helper("attention", lambda *a: None)
        with pytest.raises(RuntimeError, match="no longer holds"):
            t1.fit_batch(_cyclic_batch(rng_np, n=2, t=16))

    def test_key_mask_rejected(self, rng_np):
        ds = _cyclic_batch(rng_np, n=2, t=16)
        masked = DataSet(ds.features, ds.labels,
                         features_mask=np.ones((2, 16), np.float32))
        with GraphSequenceParallelTrainer(_tiny_lm(), _sp(2)) as tr:
            with pytest.raises(ValueError, match="key masks"):
                tr.fit_batch(masked)

    def test_sp_label_mask_matches_single_device(self, rng_np):
        """Per-token label masks shard over T; the loss divides by the
        global count of present cells."""
        ds0 = _cyclic_batch(rng_np, n=4, t=16)
        mask = np.ones((4, 16), np.float32)
        mask[:2, 8:] = 0.0
        ds = DataSet(ds0.features, ds0.labels, labels_mask=mask)
        solo = _tiny_lm()
        solo.fit_batch(ds)
        sp_net = _tiny_lm()
        with GraphSequenceParallelTrainer(sp_net, mesh=_sp(8)) as trainer:
            trainer.fit_batch(ds)
        assert abs(float(sp_net.score_value) -
                   float(solo.score_value)) < 1e-4
        np.testing.assert_allclose(sp_net.params["out"]["W"].numpy(),
                                   solo.params["out"]["W"].numpy(),
                                   rtol=2e-3, atol=1e-4)

    def test_sequence_sharded_layout(self, rng_np):
        x = rng_np.normal(size=(2, 8, 3)).astype(np.float32)
        st = sequence_sharded(_sp(4), x)
        assert tuple(st.local((1,)).shape) == (2, 2, 3)
        np.testing.assert_array_equal(st.gather().numpy(), x)


# ============================================ the port against the JAX package
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_reference(causal, rng_np):
    """The port's kernel ring and streaming ring at sp 4 against JAX's
    single-device reference on the same inputs."""
    q, k, v = (rng_np.normal(size=(2, 32, 4, 8)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_reference(q, k, v, causal=causal))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    for impl in (None, "jnp"):
        got = ring_self_attention(tq, tk, tv, _sp(4), causal=causal,
                                  impl=impl)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(impl))
    chunks = [torch.as_tensor(a).chunk(4, dim=1) for a in (q, k, v)]
    got = torch.cat(_ring_streaming(*chunks, causal), dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attention_block_trainer_matches_jax(rng_np):
    """SequenceParallelTrainer at sp 4 (JAX: its ring on 4 host devices)
    from JAX's parameters: the score and the SGD step."""
    jconf = JaxSelfAttention(n_in=8, n_out=8, num_heads=2, causal=True,
                             weight_init="xavier")
    jtr = JaxSPTrainer(jconf, jax_mesh(4, axis_names=("sp",)),
                       learning_rate=0.1, seed=5)
    conf = SelfAttentionLayer(n_in=8, n_out=8, num_heads=2, causal=True,
                              weight_init="xavier")
    ttr = SequenceParallelTrainer(
        conf, _sp(4), learning_rate=0.1,
        params={k: np.asarray(v) for k, v in jtr.params.items()})
    for _ in range(2):
        x = rng_np.normal(size=(2, 16, 8)).astype(np.float32)
        y = rng_np.normal(size=(2, 16, 8)).astype(np.float32)
        np.testing.assert_allclose(ttr.fit_batch(x, y), jtr.fit_batch(x, y),
                                   rtol=1e-5)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(ttr.params[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["sp4", "dp2xsp2"])
def test_lm_trainer_matches_jax(shape, rng_np):
    """GraphSequenceParallelTrainer on the 2-layer LM from JAX's weights,
    one adam step, against JAX's trainer (its jnp ring) on the same mesh
    shape: the score and every parameter."""
    kw = dict(d_model=32, num_heads=2, num_layers=2, max_length=32,
              learning_rate=1e-2, seed=5)
    jg = JaxGraph(jax_lm_conf(12, **kw)).init()
    tg = graph_from_numpy(transformer_lm_conf(12, **kw),
                          {v: {k: np.asarray(a) for k, a in p.items()}
                           for v, p in jg.params.items()}, device="cpu")
    ds = _cyclic_batch(rng_np, n=4, t=16)
    names = ("data", "sp")
    jmesh = jax_mesh(int(np.prod(shape)), axis_names=names, shape=shape)
    tmesh = make_mesh(axis_names=names, shape=shape,
                      devices=[CPU] * int(np.prod(shape)))
    da = "data" if shape[0] > 1 else None
    with JaxGraphSP(jg, mesh=jmesh, data_axis=da, ring_impl="jnp") as jtr:
        jtr.fit_batch(JaxDataSet(ds.features, ds.labels))
    with GraphSequenceParallelTrainer(tg, mesh=tmesh, data_axis=da) as ttr:
        ttr.fit_batch(ds)
    assert abs(float(tg.score_value) - float(jg.score_value)) < 1e-4
    for v, p in jg.params.items():
        for k, a in p.items():
            np.testing.assert_allclose(tg.params[v][k].numpy(),
                                       np.asarray(a), rtol=2e-3, atol=1e-4,
                                       err_msg=f"{v}/{k}")


def test_kernel_ring_counts_no_launch_on_cpu(rng_np):
    """On CPU tensors every pair takes the wrappers' plain versions: the
    launch counters do not move."""
    before = (ff.flash_forward.launches, fb.flash_backward_dq.launches,
              fb.flash_backward_dkv.launches)
    q, k, v = (x.requires_grad_(True) for x in _qkv(rng_np, 1, 16, 2, 8))
    torch.autograd.grad(ring_self_attention(q, k, v, _sp(2),
                                            causal=True).sum(), (q, k, v))
    assert (ff.flash_forward.launches, fb.flash_backward_dq.launches,
            fb.flash_backward_dkv.launches) == before
