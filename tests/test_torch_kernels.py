"""PyTorch port: the attention kernel modules, forward and backward,
against the JAX Pallas kernels (run in interpret mode on the CPU, as the
JAX tests run them). On the CPU each wrapper takes its plain PyTorch
version; tests/test_torch_kernels_cuda.py holds the hand-written kernels
against that plain version on a card.

Fully masked rows are checked for finiteness only: every implementation
averages such a row uniformly, but over different key sets (the TPU flash
kernel and the Hopper kernels skip causal-future tiles, the plain version
averages every key), so their values legitimately differ."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.pallas_attention import (
    _flash_bwd_impl, _flash_fwd_impl, pallas_flash_attention)
from deeplearning4j_tpu.kernels.pallas_shortseq import (
    _short_fwd_impl, pick_g, short_attention as jax_short_attention)
from deeplearning4j_tpu_torch.kernels import flash_backward as fb
from deeplearning4j_tpu_torch.kernels import flash_forward as ff
from deeplearning4j_tpu_torch.kernels import shortseq_attention as ss

TOL = dict(rtol=1e-5, atol=1e-5)      # f32 parity (ROADMAP rule 1)


def _qkv(rng, b, t, h, d):
    return [rng.normal(size=(b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _fold(x):
    b, t, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d))


def _mask(b, t, lengths):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def _compare(o_port, lse_port, o_jax, lse_jax, live_rows):
    o_port, lse_port = o_port.numpy(), lse_port.numpy()
    assert np.isfinite(o_port).all() and np.isfinite(lse_port).all()
    np.testing.assert_allclose(o_port[live_rows], np.asarray(o_jax)[live_rows],
                               **TOL)
    np.testing.assert_allclose(lse_port[live_rows],
                               np.asarray(lse_jax)[live_rows], **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths", [None, [177]], ids=["nomask", "ragged"])
def test_short_attention_matches_pallas(causal, lengths):
    """B=1, H=2, T=256, D=16: o and lse of the port's short-sequence
    forward (plain version on the CPU) against _short_fwd_impl."""
    b, t, h, d = 1, 256, 2, 16
    q, k, v = _qkv(np.random.default_rng(0), b, t, h, d)
    km = None if lengths is None else _mask(b, t, lengths)
    o_j, lse_j = _short_fwd_impl(
        _fold(q), _fold(k), _fold(v), km, h, causal,
        pick_g(b * h, h, km is not None), True)
    o_p, lse_p = ss.short_attention_fwd(
        *(torch.from_numpy(_fold(x)) for x in (q, k, v)),
        None if km is None else torch.from_numpy(km), h, causal)
    _compare(o_p, lse_p, o_j, np.asarray(lse_j)[..., 0], slice(None))


def test_short_attention_fully_masked_row_is_finite():
    """A fully masked batch row (length 0) stays finite; the other row
    matches the Pallas kernel."""
    b, t, h, d = 2, 256, 2, 16
    q, k, v = _qkv(np.random.default_rng(1), b, t, h, d)
    km = _mask(b, t, [0, 200])
    o_j, lse_j = _short_fwd_impl(_fold(q), _fold(k), _fold(v), km, h, True,
                                 pick_g(b * h, h, True), True)
    o_p, lse_p = ss.short_attention_fwd(
        *(torch.from_numpy(_fold(x)) for x in (q, k, v)),
        torch.from_numpy(km), h, True)
    _compare(o_p, lse_p, o_j, np.asarray(lse_j)[..., 0], slice(h, 2 * h))


def test_router_layout_matches_jax_short_attention():
    """The [B, T, H, D] attention helper folds and unfolds like the JAX
    short_attention wrapper (CPU tensors: the plain version)."""
    b, t, h, d = 1, 256, 2, 16
    q, k, v = _qkv(np.random.default_rng(2), b, t, h, d)
    km = _mask(b, t, [131])
    want = jax_short_attention(q, k, v, causal=True, key_mask=km,
                               interpret=True)

    class Conf:
        causal = True
    got = ff.cuda_attention(Conf(), *(torch.from_numpy(x)
                                      for x in (q, k, v)),
                            torch.from_numpy(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths", [None, [64, 23]], ids=["nomask",
                                                            "ragged"])
def test_flash_forward_matches_pallas(causal, lengths):
    """T=64 with 16-row blocks on the TPU side: o and lse (the carrier's
    column 0) of the port's flash forward against _flash_fwd_impl."""
    b, t, h, d = 2, 64, 2, 16
    q, k, v = _qkv(np.random.default_rng(3), b, t, h, d)
    km = None if lengths is None else _mask(b, t, lengths)
    o_j, lse_j = _flash_fwd_impl(_fold(q), _fold(k), _fold(v), km, h,
                                 causal, 16, 16, True)
    o_p, lse_p = ff.flash_forward(
        *(torch.from_numpy(_fold(x)) for x in (q, k, v)),
        None if km is None else torch.from_numpy(km), h, causal)
    _compare(o_p, lse_p, o_j, np.asarray(lse_j)[..., 0], slice(None))


def test_flash_forward_fully_masked_row_is_finite():
    b, t, h, d = 2, 64, 2, 16
    q, k, v = _qkv(np.random.default_rng(4), b, t, h, d)
    km = _mask(b, t, [40, 0])
    o_j, lse_j = _flash_fwd_impl(_fold(q), _fold(k), _fold(v), km, h, True,
                                 16, 16, True)
    o_p, lse_p = ff.flash_forward(
        *(torch.from_numpy(_fold(x)) for x in (q, k, v)),
        torch.from_numpy(km), h, True)
    _compare(o_p, lse_p, o_j, np.asarray(lse_j)[..., 0], slice(0, h))


def test_flash_ragged_t_matches_padded_pallas():
    """A T that is not a block multiple: the port masks in place, the JAX
    wrapper pads to the block multiple; the outputs agree."""
    b, t, h, d = 1, 50, 2, 8
    q, k, v = _qkv(np.random.default_rng(5), b, t, h, d)
    km = _mask(b, t, [37])
    want = pallas_flash_attention(q, k, v, causal=True, q_block=16,
                                  k_block=16, interpret=True, key_mask=km)
    o_p, _ = ff.flash_forward(*(torch.from_numpy(_fold(x))
                                for x in (q, k, v)),
                              torch.from_numpy(km), h, True)
    got = o_p.numpy().reshape(b, h, t, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_cpu_calls_launch_nothing():
    """A CPU tensor takes the plain version and counts no launch."""
    before = (ss.short_attention_fwd.launches, ff.flash_forward.launches)
    x = torch.zeros(2, 16, 8)
    ss.short_attention_fwd(x, x, x)
    ff.flash_forward(x, x, x)
    assert (ss.short_attention_fwd.launches,
            ff.flash_forward.launches) == before


@pytest.mark.parametrize("b,t,route", [(1, 64, "short"), (2, 512, "short"),
                                       (1, 513, "flash"), (3, 700, "flash")])
def test_router_hands_kernels_contiguous_folds(monkeypatch, b, t, route):
    """cuda_attention routes T <= 512 to the short kernel and longer T to
    the flash kernel, always with contiguous [B*H, T, D] operands (a B=1
    fold is a strided view unless made contiguous) and a [B, T] f32
    mask."""
    seen = []

    def spy(name):
        def fwd(q3, k3, v3, km, h, causal):
            assert all(x.is_contiguous() for x in (q3, k3, v3, km))
            assert q3.shape == (b * h, t, 8) and km.shape == (b, t)
            assert km.dtype == torch.float32 and causal
            seen.append(name)
            return ss.attention_fwd_plain(q3, k3, v3, km, h, causal)
        return fwd
    monkeypatch.setattr(ff, "short_attention_fwd", spy("short"))
    monkeypatch.setattr(ff, "flash_forward", spy("flash"))

    class Conf:
        causal = True
    h = 2
    q = torch.randn(b, t, h, 8)
    out = ff.cuda_attention(Conf(), q, q, q, torch.ones(b, t))
    assert seen == [route] and out.shape == (b, t, h, 8)


def _unfold(x3, b, h):
    bh, t, d = x3.shape
    return x3.reshape(b, h, t, d).transpose(1, 2).numpy()


def _plain_grads(q, k, v, km, h, causal, do, delta=None):
    """(dq, dk, dv) as [B, T, H, D] numpy from the port's plain backward,
    with o and lse from its plain forward."""
    b = q.shape[0]
    q3, k3, v3, do3 = (torch.from_numpy(_fold(x)) for x in (q, k, v, do))
    kmt = None if km is None else torch.from_numpy(km)
    o, lse = ss.attention_fwd_plain(q3, k3, v3, kmt, h, causal)
    grads = fb.flash_backward_plain(q3, k3, v3, kmt, h, causal, o, lse, do3,
                                    delta)
    return [_unfold(g, b, h) for g in grads]


def _live(lengths, b):
    """Batch rows that are not fully masked."""
    return slice(None) if lengths is None else \
        np.asarray(lengths)[:b] > 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths", [None, [177]], ids=["nomask", "ragged"])
def test_attention_bwd_plain_matches_short_attention_vjp(causal, lengths):
    """B=1, H=2, T=256, D=16: the plain backward against jax.vjp of
    short_attention (the fused backward kernel _short_bwd_kernel, in
    interpret mode)."""
    b, t, h, d = 1, 256, 2, 16
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, b, t, h, d)
    do = rng.normal(size=q.shape).astype(np.float32)
    km = None if lengths is None else _mask(b, t, lengths)
    _, vjp = jax.vjp(lambda a, bb, c: jax_short_attention(
        a, bb, c, causal=causal, key_mask=km, interpret=True), q, k, v)
    want = vjp(do)
    got = _plain_grads(q, k, v, km, h, causal, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths", [None, [64, 23, 0]],
                         ids=["nomask", "ragged"])
def test_attention_bwd_plain_matches_pallas_flash_vjp(causal, lengths):
    """T=64 with 16-row blocks: the plain backward against jax.vjp of
    pallas_flash_attention (_dq_kernel and _dkv_kernel in interpret mode).
    A fully masked batch row is checked for finiteness only."""
    b, t, h, d = 3, 64, 2, 16
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, b, t, h, d)
    do = rng.normal(size=q.shape).astype(np.float32)
    km = None if lengths is None else _mask(b, t, lengths)
    _, vjp = jax.vjp(lambda a, bb, c: pallas_flash_attention(
        a, bb, c, causal=causal, q_block=16, k_block=16, interpret=True,
        key_mask=km), q, k, v)
    want = vjp(do)
    got = _plain_grads(q, k, v, km, h, causal, do)
    live = _live(lengths, b)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[live], np.asarray(w)[live], **TOL)


def test_flash_backward_takes_an_external_delta():
    """_flash_bwd_impl(delta3=...) signature: a δ passed from outside (as
    the ring backward passes the global one) replaces rowsum(dO·O) in
    flash_backward, and the dq / dkv wrappers take it too."""
    b, t, h, d = 2, 32, 2, 8
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, b, t, h, d)
    do = rng.normal(size=q.shape).astype(np.float32)
    km = _mask(b, t, [32, 19])
    q3, k3, v3, do3 = (_fold(x) for x in (q, k, v, do))
    o, lse = _flash_fwd_impl(q3, k3, v3, km, h, True, 16, 16, True)
    delta = rng.normal(size=(b * h, t)).astype(np.float32)
    delta3 = np.broadcast_to(delta[..., None], (b * h, t, 8))
    want = _flash_bwd_impl(q3, k3, v3, km, h, o, lse, do3, True, 16, 16,
                           True, delta3=delta3)
    args = [torch.from_numpy(np.asarray(x)) for x in (q3, k3, v3)]
    kmt, lse_t = torch.from_numpy(km), torch.from_numpy(
        np.ascontiguousarray(np.asarray(lse)[..., 0]))
    do_t, delta_t = torch.from_numpy(do3), torch.from_numpy(delta)
    got = fb.flash_backward(*args, kmt, h, True, None, lse_t, do_t, delta_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    dq = fb.flash_backward_dq(*args, kmt, h, True, do_t, lse_t, delta_t)
    dk, dv = fb.flash_backward_dkv(*args, kmt, h, True, do_t, lse_t, delta_t)
    for g, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_cpu_backward_calls_launch_nothing():
    x = torch.zeros(2, 16, 8)
    rows = torch.zeros(2, 16)
    before = (ss.short_attention_bwd.launches, fb.flash_backward_dq.launches,
              fb.flash_backward_dkv.launches)
    ss.short_attention_bwd(x, x, x, None, 1, True, x, rows, x)
    fb.flash_backward(x, x, x, None, 1, True, x, rows, x)
    assert (ss.short_attention_bwd.launches, fb.flash_backward_dq.launches,
            fb.flash_backward_dkv.launches) == before


@pytest.mark.parametrize("t", [40, 530], ids=["short", "flash"])
def test_router_output_carries_gradients(t):
    """cuda_attention's output is differentiable (the autograd Functions
    over the kernel pairs; plain versions on CPU tensors): its gradients
    match autograd through the plain forward."""
    class Conf:
        causal = True
    b, h, d = 2, 2, 8
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn(b, t, h, d, generator=g, dtype=torch.float64)
               .float().requires_grad_(True) for _ in range(3))
    km = (torch.arange(t)[None] < torch.tensor([[t], [t // 3]])).float()
    w = torch.randn(b, t, h, d, generator=g)
    got = torch.autograd.grad((ff.cuda_attention(Conf(), q, k, v, km) *
                               w).sum(), (q, k, v))
    fold = lambda x: x.transpose(1, 2).reshape(b * h, t, d)
    o, _ = ss.attention_fwd_plain(fold(q), fold(k), fold(v), km, h, True)
    want = torch.autograd.grad((o.reshape(b, h, t, d).transpose(1, 2) *
                                w).sum(), (q, k, v))
    for x, y in zip(got, want):
        assert x.abs().sum() > 0
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
