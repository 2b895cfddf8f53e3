"""PyTorch port: the attention kernel modules, forward and backward,
against the JAX Pallas kernels (run in interpret mode on the CPU, as the
JAX tests run them). On the CPU each wrapper takes its plain PyTorch
version; tests/test_torch_kernels_cuda.py holds the hand-written kernels
against that plain version on a card.

Fully masked rows are checked for finiteness only: every implementation
averages such a row uniformly, but over different key sets (the TPU flash
kernel and the Hopper kernels skip causal-future tiles, the plain version
averages every key), so their values legitimately differ."""

import re
from pathlib import Path

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


def _unfold(x3, b, h):
    bh, t, d = x3.shape
    return x3.numpy().reshape(b, h, t, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("d", [4, 12, 36])
def test_padded_head_dims_match_jax(d):
    """C4: a head dim that is not a multiple of 8 reaches the kernels
    zero-padded to the next multiple, with the true D's 1/√D, and comes
    back sliced (``padded_fwd`` / ``padded_bwd``). That pad-and-slice
    function with the plain versions in the kernels' place equals JAX's
    Pallas flash attention (interpret mode), forward and backward, causal
    with a ragged key mask, at 1e-5."""
    b, t, h = 2, 64, 2
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, b, t, h, d)
    do = rng.normal(size=q.shape).astype(np.float32)
    km = _mask(b, t, [64, 23])
    o_j, vjp = jax.vjp(lambda a, bb, c: pallas_flash_attention(
        a, bb, c, causal=True, q_block=16, k_block=16, interpret=True,
        key_mask=km), q, k, v)
    want = vjp(do)
    q3, k3, v3, do3 = (torch.from_numpy(_fold(x)) for x in (q, k, v, do))
    km3 = torch.from_numpy(km)
    widths = []

    def fwd(qp, kp, vp, m, hh, causal, scale):
        widths.append(qp.shape[-1])
        return ss.attention_fwd_plain(qp, kp, vp, m, hh, causal, scale)

    def bwd(qp, kp, vp, m, hh, causal, lse, dop, delta, scale):
        widths.append(dop.shape[-1])
        return ss.attention_bwd_plain(qp, kp, vp, m, hh, causal, None, lse,
                                      dop, delta, scale)

    o3, lse = ss.padded_fwd(fwd, q3, k3, v3, km3, h, True)
    grads = ss.padded_bwd(bwd, q3, k3, v3, km3, h, True, lse, do3,
                          ss.row_delta(do3, o3))
    assert widths == [-(-d // 8) * 8] * 2
    assert o3.shape == q3.shape
    np.testing.assert_allclose(_unfold(o3, b, h), np.asarray(o_j), **TOL)
    for g, w in zip(grads, want):
        assert g.shape == q3.shape
        np.testing.assert_allclose(_unfold(g, b, h), np.asarray(w), **TOL)


def _wide_tile():
    """kWRows (keys a softmax tile), kWChunk (D columns a product pass)
    and kWSlice (output columns a CTA owns) as the kernels above D 256
    define them in ``csrc/attention_wide.cuh``."""
    src = (Path(ss.__file__).parents[1] / "csrc" /
           "attention_wide.cuh").read_text()
    return tuple(int(re.search(rf"constexpr int {k} = (\d+);", src)[1])
                 for k in ("kWRows", "kWChunk", "kWSlice"))


def _column_slices(d):
    """The [start, end) column slices of a D > 256 launch's output."""
    width = _wide_tile()[2]
    return [(s, min(s + width, d)) for s in range(0, d, width)]


def test_head_dim_above_the_kernels_raises():
    """D above 256 no longer raises (C4 closed): the pad helper keeps a
    multiple of 8 as it is, and the kernels split its output columns into
    128-wide slices, the last one ragged."""
    assert ss.head_dim_padded(264) == 264 and ss.head_dim_padded(258) == 264
    assert ss.head_dim_padded(256) == 256 and ss.head_dim_padded(129) == 136
    assert _wide_tile() == (32, 64, 128)
    assert _column_slices(264) == [(0, 128), (128, 256), (256, 264)]
    assert _column_slices(320) == [(0, 128), (128, 256), (256, 320)]
    assert _column_slices(512) == [(0, 128), (128, 256), (256, 384),
                                   (384, 512)]


def _split_plan(q3, k3, v3, km3, h, causal, do3):
    """The wide kernels' D-split plan in plain PyTorch, f32: every slice of
    the output's columns recomputes the full-D scores (q . k^T and
    dO . v^T) in 64-column chunks, the streaming softmax runs over 32-key
    tiles, o / dq / dk / dv are written slice by slice and lse by slice 0."""
    bh, t, d = q3.shape
    scale = d ** -0.5
    keep = torch.ones(bh, t, t, dtype=torch.bool)
    if km3 is not None:
        keep &= (km3.repeat_interleave(h, 0) > 0)[:, None, :]
    if causal:
        keep &= torch.ones(t, t, dtype=torch.bool).tril()

    rows, chunk, _ = _wide_tile()

    def chunked(a, b):
        return sum(a[..., c:c + chunk] @ b[..., c:c + chunk].transpose(1, 2)
                   for c in range(0, d, chunk))

    o, dq, dk, dv = (torch.zeros_like(q3) for _ in range(4))
    for s0, s1 in _column_slices(d):
        s = torch.where(keep, chunked(q3, k3) * scale, torch.tensor(-1e30))
        m = torch.full((bh, t, 1), -torch.inf)
        l = torch.zeros(bh, t, 1)
        acc = torch.zeros(bh, t, s1 - s0)
        for j0 in range(0, t, rows):
            blk = s[..., j0:j0 + rows]
            mn = torch.maximum(m, blk.amax(-1, keepdim=True))
            p = torch.exp(blk - mn)
            alpha = torch.exp(m - mn)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ v3[:, j0:j0 + rows, s0:s1]
            m = mn
        l = l.clamp_min(1e-20)
        o[..., s0:s1] = acc / l
        if s0 == 0:
            lse = (m + torch.log(l))[..., 0]
    delta = ss.row_delta(do3, o)
    for s0, s1 in _column_slices(d):
        s = torch.where(keep, chunked(q3, k3) * scale, torch.tensor(-1e30))
        p = torch.exp(s - lse[..., None])
        ds = p * (chunked(do3, v3) - delta[..., None]) * scale
        dq[..., s0:s1] = ds @ k3[..., s0:s1]
        dk[..., s0:s1] = ds.transpose(1, 2) @ q3[..., s0:s1]
        dv[..., s0:s1] = p.transpose(1, 2) @ do3[..., s0:s1]
    return o, lse, (dq, dk, dv)


@pytest.mark.parametrize("d", [264, 320])
def test_head_dim_split_plan_matches_jax(d):
    """C4: the plan of the kernels above D 256 (output columns split into
    128-wide slices, each recomputing the full-D scores) is exact against
    JAX's Pallas flash attention (interpret mode), forward and backward,
    causal with a ragged key mask, at 1e-5."""
    b, t, h = 1, 64, 2
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, b, t, h, d)
    do = rng.normal(size=q.shape).astype(np.float32)
    km = _mask(b, t, [41])
    o_j, vjp = jax.vjp(lambda a, bb, c: pallas_flash_attention(
        a, bb, c, causal=True, q_block=16, k_block=16, interpret=True,
        key_mask=km), q, k, v)
    want = vjp(do)
    q3, k3, v3, do3 = (torch.from_numpy(_fold(x)) for x in (q, k, v, do))
    o3, lse, grads = _split_plan(q3, k3, v3, torch.from_numpy(km), h, True,
                                 do3)
    assert ss.head_dim_padded(d) == d
    np.testing.assert_allclose(_unfold(o3, b, h), np.asarray(o_j), **TOL)
    _, lse_p = ss.attention_fwd_plain(q3, k3, v3, torch.from_numpy(km), h,
                                      True)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), **TOL)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(_unfold(g, b, h), np.asarray(w), **TOL)
