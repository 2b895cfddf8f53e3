"""PyTorch port, on the card: each hand-written attention kernel, forward
and backward, against its plain PyTorch version at small shapes (every
supported dtype, head dims 8-128, ragged and length-1 T, a fully masked
row), the shapes the wrappers refuse, and gradients through an attention
layer on the card. Every test here needs a CUDA card and skips without
one. The module imports no JAX, so it runs where JAX is not installed:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest``.

Fully masked rows are checked for finiteness only: the kernels average
such a row over the key tiles they visit, the plain version over every
key."""

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import flash_backward as fb
from deeplearning4j_tpu_torch.kernels import flash_forward as ff
from deeplearning4j_tpu_torch.kernels import shortseq_attention as ss
from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("kernel", ["short", "flash"])
@pytest.mark.parametrize("t,d", [(1, 8), (77, 32), (256, 64), (512, 128),
                                 (600, 64)])
def test_kernel_matches_plain_on_card(cuda_device, kernel, t, d, dtype, tol):
    if kernel == "short" and t > ss.MAX_T:
        pytest.skip("T above the short-sequence kernel's range")
    fwd = ss.short_attention_fwd if kernel == "short" else ff.flash_forward
    b, h = 3, 2
    g = torch.Generator(device=cuda_device).manual_seed(t * d)
    q3, k3, v3 = (torch.randn(b * h, t, d, generator=g, device=cuda_device)
                  .to(dtype) for _ in range(3))
    lengths = torch.tensor([t, max(t // 2, 1), 0], device=cuda_device)
    km = (torch.arange(t, device=cuda_device)[None] <
          lengths[:, None]).float()
    for causal in (True, False):
        before = fwd.launches
        o_k, lse_k = fwd(q3, k3, v3, km, h, causal)
        o_p, lse_p = ss.attention_fwd_plain(q3, k3, v3, km, h, causal)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1
        assert torch.isfinite(o_k).all() and torch.isfinite(lse_k).all()
        live = slice(0, 2 * h)            # batch row 2 is fully masked
        assert (o_k[live].float() - o_p[live].float()).abs().max() <= tol
        assert (lse_k[live] - lse_p[live]).abs().max() <= 1e-2


def test_kernel_rejects_unsupported_shapes(cuda_device):
    bad_d = torch.zeros(2, 16, 12, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ff.flash_forward(bad_d, bad_d, bad_d)
    ints = torch.zeros(2, 16, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float"):
        ss.short_attention_fwd(ints, ints, ints)
    long = torch.zeros(2, 520, 8, device=cuda_device)
    with pytest.raises(ValueError, match="T=520"):
        ss.short_attention_fwd(long, long, long)


def _rel_l2(got, want, floor=None):
    """||got - want|| / ||want||; with ``floor``, the denominator is at
    least ||floor||: at T = 1 every row's softmax is the constant 1, so dq
    and dk vanish by cancellation and are compared at dO's scale."""
    den = want.float().norm()
    if floor is not None:
        den = torch.maximum(den, floor.float().norm())
    return ((got.float() - want.float()).norm() /
            den.clamp_min(1e-30)).item()


#: relative L2 of dq / dk / dv against the plain f32 backward: f32 only
#: reorders sums; f16 and bf16 round p and ds before their products
BWD_TOL = {torch.float32: 1e-4, torch.float16: 5e-3, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("kernel", ["short", "flash"])
@pytest.mark.parametrize("t", [1, 77, 512, 600])
@pytest.mark.parametrize("d", [8, 64, 128])
def test_backward_kernels_match_plain_on_card(cuda_device, kernel, t, d,
                                              dtype):
    """B2 (short) or B4 + B5 (flash) against attention_bwd_plain on the
    same (q, k, v, o, lse, dO, δ), causal and not, with a ragged and a
    fully masked batch row."""
    if kernel == "short" and t > ss.MAX_T:
        pytest.skip("T above the short-sequence kernel's range")
    b, h = 3, 2
    g = torch.Generator(device=cuda_device).manual_seed(7 * t + d)
    q3, k3, v3, do = (torch.randn(b * h, t, d, generator=g,
                                  device=cuda_device).to(dtype)
                      for _ in range(4))
    lengths = torch.tensor([t, max(t // 2, 1), 0], device=cuda_device)
    km = (torch.arange(t, device=cuda_device)[None] <
          lengths[:, None]).float()
    live = slice(0, 2 * h)                # batch row 2 is fully masked
    for causal in (True, False):
        o, lse = ss.attention_fwd_plain(q3, k3, v3, km, h, causal)
        delta = ss.row_delta(do, o)
        want = ss.attention_bwd_plain(q3, k3, v3, km, h, causal, o, lse, do,
                                      delta)
        if kernel == "short":
            before = ss.short_attention_bwd.launches
            got = ss.short_attention_bwd(q3, k3, v3, km, h, causal, o, lse,
                                         do, delta)
            launched = ss.short_attention_bwd.launches - before
        else:
            before = (fb.flash_backward_dq.launches,
                      fb.flash_backward_dkv.launches)
            got = fb.flash_backward(q3, k3, v3, km, h, causal, o, lse, do,
                                    delta)
            launched = (fb.flash_backward_dq.launches - before[0]) * \
                (fb.flash_backward_dkv.launches - before[1])
        torch.cuda.synchronize()
        assert launched == 1
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.dtype == dtype and torch.isfinite(x).all(), name
            assert _rel_l2(x[live], y[live], do[live]) <= BWD_TOL[dtype], \
                name


def test_backward_kernels_reject_unsupported_shapes(cuda_device):
    x = torch.zeros(2, 520, 8, device=cuda_device)
    rows = torch.zeros(2, 520, device=cuda_device)
    with pytest.raises(ValueError, match="T=520"):
        ss.short_attention_bwd(x, x, x, None, 1, True, x, rows, x, rows)
    with pytest.raises(ValueError, match="dO"):
        fb.flash_backward_dq(x, x, x, None, 1, True, x[:, :, :4], rows, rows)
    with pytest.raises(ValueError, match="lse"):
        fb.flash_backward_dkv(x, x, x, None, 1, True, x, rows.double(),
                              rows)


@pytest.mark.parametrize("t", [37, 600], ids=["short", "flash"])
def test_attention_layer_gradients_flow_through_kernels(cuda_device, t):
    """The attention helper on a card is differentiable: the gradients of
    Wq / Wk / Wv through SelfAttentionLayer.forward are nonzero, come from
    the backward kernels, and match the plain path on the CPU."""
    layer = SelfAttentionLayer(n_in=32, n_out=32, num_heads=4, causal=True,
                               activation="identity")
    params = layer.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, t, 32, generator=g)
    w = torch.randn(2, t, 32, generator=g)
    mask = (torch.arange(t)[None] < torch.tensor([[t], [t // 2]])).float()

    def grads(device):
        ps = {k: p.to(device).requires_grad_(True) for k, p in
              params.items()}
        y, _ = layer.forward(ps, {}, x.to(device), mask.to(device))
        return torch.autograd.grad((y * w.to(device)).sum(),
                                   [ps[k] for k in ("Wq", "Wk", "Wv")])

    counters = (ss.short_attention_bwd, fb.flash_backward_dq,
                fb.flash_backward_dkv)
    before = [c.launches for c in counters]
    card = grads(cuda_device)
    torch.cuda.synchronize()
    launched = [c.launches - n for c, n in zip(counters, before)]
    assert launched == ([1, 0, 0] if t <= ss.MAX_T else [0, 1, 1])
    for got, want in zip(card, grads("cpu")):
        assert got.norm() > 0
        assert _rel_l2(got.cpu(), want) <= 1e-4
