"""PyTorch port, on the card: each hand-written attention kernel against
its plain PyTorch version at small shapes (every supported dtype, head
dims 8-128, ragged and length-1 T, a fully masked row), plus the shapes
the wrappers refuse. Every test here needs a CUDA card and skips without
one. The module imports no JAX, so it runs where JAX is not installed:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest``.

Fully masked rows are checked for finiteness only: the kernels average
such a row over the key tiles they visit, the plain version over every
key."""

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import flash_forward as ff
from deeplearning4j_tpu_torch.kernels import shortseq_attention as ss


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
