"""PyTorch port, on the card: each hand-written attention kernel, forward
and backward, against its plain PyTorch version at small shapes (every
supported dtype, head dims 8-128, T at every tile edge, a key mask with
holes, a fully masked row), the two forwards against each other, the
backward kernels' bitwise determinism over two calls, the shapes the
wrappers refuse, and gradients through an attention layer on the card;
the biased pair (SwinV2's windows: an f32 logit bias [P, H, T, T] and its
gradient) against its plain version at T 64 and 256, D 32, P 1 and 16,
its repeats and refusals, and a shifted SwinV2 block's gradients through
it;
the LSTM recurrence kernel (B6) against its plain version on both of its
routes (f32 / bf16, peepholes, masks, strided xw, T 1-128, N 1-200, H
16-1024), the route its plan picks, its refusals and its gradients; the
batch-norm kernels (plain, with the BN layer's ReLU folded in, and the
ReLU tail; f32 / bf16, M 3-20000, C 8-2048) against their plain version,
their bitwise reproducibility, one cooperative launch a direction with
no cast of bf16 gamma, their refusals (a refused launch raises), and a
small ResNet training through them. The shapes the card used to refuse
(fault C4) against their plain versions: batch norms of any C, f16 and
wide C on the general route; LSTMs with every activation, the row-wise
softmax / logsoftmax included, f16 and H 2048 on the streamed route (and
their gradients); attention at head dims that are not a multiple of 8
(zero-padded), up to 256 (the wide instance) and above (the output's
columns split over the grid); each with one kernel launch a wrapper call
(three for the general batch-norm route) and no plain-path operator.
The training API's paths: a frozen char-RNN layer bit-identical over
fine-tune steps on B6, ``AsyncDataSetIterator`` staging bf16 on the card,
and a frozen ResNet trunk whose BNs still launch their kernels at lr 0.
A (1, 2) serving mesh on one card: B1 on each tp shard's 6 heads.
Sync data-parallel training at data 2 on one card against solo steps,
with B1 and B2 launched once a layer a shard. The batch norm across data
shards (``batchnorm.cu``'s ``batchnorm_xs_*`` phases, every variant,
uneven row blocks) against the plain version on the whole batch, each
phase's launches counted, and sync DP of a BN net against a solo step;
the ring over B3 / B4 / B5 against the plain streaming ring, forward
and gradients, with sp(sp+1)/2 (causal) or sp² pair launches, and a
sequence-parallel LM step against a solo step. A Keras functional net
imported on the card runs its BN -> add -> ReLU tail on the fused
kernel and matches its CPU import. Word vectors trained on the card,
made into masked sequences by ``Word2VecDataSetIterator``, launch B6 once
a GravesLSTM forward and match the plain recurrence; the embedding
tables' segment update on the card is bitwise reproducible on both of its
numerics, and so is a seeded Word2Vec scan. ``analysis.CompileAudit``
over a fresh process's first ``cuda_lib.load`` counts one nvcc build and
one ctypes load, and a second load none. The feed's pinned stage
(``ops.transfer.stage_to_device``): a staged bf16 batch bit-identical to
a cast on the card, ``fit_batch`` steps on staged batches bit-identical
to the unstaged conversion (one staged features and one staged labels
transfer a step), a source overwritten right after ``fit_batch`` that
changes nothing, and a pinned block reused from the second stage on.
Every test here
needs a CUDA card and skips without one. The module imports no
JAX, so it runs where JAX is not installed:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest``.

Fully masked rows are checked for finiteness only: the kernels average
such a row over the key tiles they visit, the plain version over every
key."""

import ctypes

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import flash_backward as fb
from deeplearning4j_tpu_torch.kernels import flash_forward as ff
from deeplearning4j_tpu_torch.kernels import lstm as lk
from deeplearning4j_tpu_torch.kernels import shortseq_attention as ss
from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


#: max-abs of o against the plain version: f32 only reorders sums; f16 and
#: bf16 round p to the input type before p . v and o on the way out
FWD_TOL = {torch.float32: 1e-4, torch.float16: 1e-2, torch.bfloat16: 5e-2}
#: sequence lengths around the forward kernels' 64-key and 64 / 128-row
#: tile edges; B3 also takes T past the short-sequence range
FWD_T = [1, 63, 64, 65, 127, 128, 129, 511, 512]
FWD_CASES = [(kernel, t) for kernel in ("short", "flash")
             for t in FWD_T + ([577, 2049] if kernel == "flash" else [])]


def _holey_mask(t, lengths, device):
    """[3, T] key mask: batch row 0 keeps every key, row 1 a prefix of
    max(T // 2, 1) keys with every 7th key from key 3 on masked (holes,
    key 0 kept, so every causal row sees a real key), row 2 none (fully
    masked)."""
    j = torch.arange(t, device=device)[None]
    keep = j < torch.tensor(lengths, device=device)[:, None]
    return (keep & ((j % 7 != 3) | (torch.arange(3, device=device)[:, None]
                                    != 1))).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("d", [8, 24, 64, 128])
@pytest.mark.parametrize("kernel,t", FWD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, kernel, t, d, dtype):
    """B1 (short) or B3 (flash) against attention_fwd_plain, causal and
    not, with a key mask that has holes and a fully masked batch row
    (finite o and lse there)."""
    fwd = ss.short_attention_fwd if kernel == "short" else ff.flash_forward
    b, h = 3, 2
    g = torch.Generator(device=cuda_device).manual_seed(t * d)
    q3, k3, v3 = (torch.randn(b * h, t, d, generator=g, device=cuda_device)
                  .to(dtype) for _ in range(3))
    km = _holey_mask(t, [t, max(t // 2, 1), 0], cuda_device)
    for causal in (True, False):
        before = fwd.launches
        o_k, lse_k = fwd(q3, k3, v3, km, h, causal)
        o_p, lse_p = ss.attention_fwd_plain(q3, k3, v3, km, h, causal)
        torch.cuda.synchronize()
        assert fwd.launches == before + 1
        assert o_k.dtype == dtype and lse_k.shape == (b * h, t)
        assert torch.isfinite(o_k).all() and torch.isfinite(lse_k).all()
        live = slice(0, 2 * h)            # batch row 2 is fully masked
        assert (o_k[live].float() - o_p[live].float()).abs().max() <= \
            FWD_TOL[dtype]
        assert (lse_k[live] - lse_p[live]).abs().max() <= 1e-2


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t", [1, 64, 200, 512])
def test_short_and_flash_forwards_agree_on_card(cuda_device, t, causal):
    """B1 and B3 compute one function: at T <= 512 in bf16 they agree with
    each other within the bf16 tolerance of either against the plain
    version, on a holey key mask with a fully masked row included."""
    b, h, d = 3, 4, 64
    g = torch.Generator(device=cuda_device).manual_seed(t + 5)
    q3, k3, v3 = (torch.randn(b * h, t, d, generator=g, device=cuda_device)
                  .to(torch.bfloat16) for _ in range(3))
    km = _holey_mask(t, [t, max(t // 2, 1), 0], cuda_device)
    o_s, lse_s = ss.short_attention_fwd(q3, k3, v3, km, h, causal)
    o_f, lse_f = ff.flash_forward(q3, k3, v3, km, h, causal)
    torch.cuda.synchronize()
    assert (o_s.float() - o_f.float()).abs().max() <= FWD_TOL[torch.bfloat16]
    assert (lse_s - lse_f).abs().max() <= 1e-2


def test_kernel_rejects_unsupported_shapes(cuda_device):
    # every head dim is attention now (C4); B*H past the grid's y limit is
    # what is refused
    wide = torch.zeros(65536, 1, 8, device=cuda_device)
    with pytest.raises(ValueError, match="B\\*H=65536"):
        ff.flash_forward(wide, wide, wide)
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


#: the backward kernels' cases: T around the 64-key / 64-query tile edges
#: for both, and past the short-sequence range for B4 + B5
BWD_CASES = [(kernel, t) for kernel in ("short", "flash")
             for t in FWD_T + ([577, 2049] if kernel == "flash" else [])]


def _bwd_case(t, d, dtype, device, seed):
    """q, k, v, dO [6, T, D] (B 3, H 2) and the holey key mask of
    :func:`_holey_mask` (batch row 1 ragged with holes, row 2 fully
    masked)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q3, k3, v3, do = (torch.randn(6, t, d, generator=g, device=device)
                      .to(dtype) for _ in range(4))
    return q3, k3, v3, do, _holey_mask(t, [t, max(t // 2, 1), 0], device)


def _run_bwd(kernel, q3, k3, v3, km, h, causal, o, lse, do, delta):
    """(dq, dk, dv) from B2 (short) or B4 + B5 (flash), and the launches
    each of their counters took."""
    counters = ((ss.short_attention_bwd,) if kernel == "short" else
                (fb.flash_backward_dq, fb.flash_backward_dkv))
    before = [c.launches for c in counters]
    if kernel == "short":
        got = ss.short_attention_bwd(q3, k3, v3, km, h, causal, o, lse, do,
                                     delta)
    else:
        got = fb.flash_backward(q3, k3, v3, km, h, causal, o, lse, do, delta)
    return got, [c.launches - n for c, n in zip(counters, before)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("d", [8, 24, 64, 128])
@pytest.mark.parametrize("kernel,t", BWD_CASES)
def test_backward_kernels_match_plain_on_card(cuda_device, kernel, t, d,
                                              dtype):
    """B2 (short) or B4 + B5 (flash) against attention_bwd_plain on the
    same (q, k, v, o, lse, dO, δ), causal and not, with a key mask that
    has holes and a fully masked batch row (finite gradients there)."""
    h = 2
    q3, k3, v3, do, km = _bwd_case(t, d, dtype, cuda_device, 7 * t + d)
    live = slice(0, 2 * h)                # batch row 2 is fully masked
    for causal in (True, False):
        o, lse = ss.attention_fwd_plain(q3, k3, v3, km, h, causal)
        delta = ss.row_delta(do, o)
        want = ss.attention_bwd_plain(q3, k3, v3, km, h, causal, o, lse, do,
                                      delta)
        got, launched = _run_bwd(kernel, q3, k3, v3, km, h, causal, o, lse,
                                 do, delta)
        torch.cuda.synchronize()
        assert all(n == 1 for n in launched)
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            assert x.dtype == dtype and torch.isfinite(x).all(), name
            assert _rel_l2(x[live], y[live], do[live]) <= BWD_TOL[dtype], \
                name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kernel,t", [("short", 300), ("flash", 577)])
def test_backward_kernels_are_deterministic_on_card(cuda_device, kernel, t,
                                                    d, dtype):
    """Each gradient element is summed by one CTA in a fixed order: two
    calls of B2, or of B4 + B5, on the same inputs give the same bits."""
    h = 2
    q3, k3, v3, do, km = _bwd_case(t, d, dtype, cuda_device, t + d)
    o, lse = ss.attention_fwd_plain(q3, k3, v3, km, h, True)
    delta = ss.row_delta(do, o)
    first, _ = _run_bwd(kernel, q3, k3, v3, km, h, True, o, lse, do, delta)
    second, _ = _run_bwd(kernel, q3, k3, v3, km, h, True, o, lse, do, delta)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16)), name


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


#: relative L2 of the card's Wq / Wk / Wv / x gradients against the CPU
#: f32 plain path: f32 reorders sums; bf16 rounds x, the weights, q / k / v
#: and the kernels' p and ds (~0.4% each)
LAYER_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [37, 512, 600], ids=["short", "short512",
                                                   "flash"])
def test_attention_layer_gradients_flow_through_kernels(cuda_device, t,
                                                         dtype):
    """The attention helper on a card is differentiable: the gradients of
    Wq / Wk / Wv and x through SelfAttentionLayer.forward are nonzero, come
    from the forward and backward kernels (B1 + B2 for T <= 512, B3 + B4 +
    B5 above), and match the plain path on the CPU. Batch row 2 is fully
    masked: its output is finite and, with zero loss weight, it adds
    nothing to the gradients, which stay finite (the backward recomputes
    p = exp(s - lse) there from the forward's lse)."""
    layer = SelfAttentionLayer(n_in=32, n_out=32, num_heads=4, causal=True,
                               activation="identity")
    params = layer.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, t, 32, generator=g)
    w = torch.randn(3, t, 32, generator=g)
    w[2] = 0.0
    mask = (torch.arange(t)[None] <
            torch.tensor([[t], [t // 2], [0]])).float()

    def grads(device, dt):
        ps = {k: p.to(device, dt).requires_grad_(True) for k, p in
              params.items()}
        xs = x.to(device, dt).requires_grad_(True)
        y, _ = layer.forward(ps, {}, xs, mask.to(device))
        out = torch.autograd.grad((y.float() * w.to(device)).sum(),
                                  [ps[k] for k in ("Wq", "Wk", "Wv")] + [xs])
        return y, out

    counters = (ss.short_attention_fwd, ss.short_attention_bwd,
                ff.flash_forward, fb.flash_backward_dq,
                fb.flash_backward_dkv)
    before = [c.launches for c in counters]
    y, card = grads(cuda_device, dtype)
    torch.cuda.synchronize()
    launched = [c.launches - n for c, n in zip(counters, before)]
    assert launched == ([1, 1, 0, 0, 0] if t <= ss.MAX_T else
                        [0, 0, 1, 1, 1])
    assert torch.isfinite(y).all()
    for got, want in zip(card, grads("cpu", torch.float32)[1]):
        assert torch.isfinite(got).all() and got.norm() > 0
        assert _rel_l2(got.cpu(), want) <= LAYER_GRAD_TOL[dtype]


# ------------------------------------- biased attention (SwinV2's windows)
def _bias_case(t, p, device, seed, rows=32, h=4, d=32):
    """bf16 q / k / v / dO [rows·h, T, D] of SwinV2's scale (q and k unit
    rows, q times a temperature of 10) and an f32 bias [P, h, T, T] of its
    kind: 16·σ(noise), minus 100 on a quarter of each row's keys."""
    g = torch.Generator(device=device).manual_seed(seed)
    q3, k3, v3, do = (torch.randn(rows * h, t, d, generator=g,
                                  device=device) for _ in range(4))
    q3 = torch.nn.functional.normalize(q3, dim=-1) * 10.0
    k3 = torch.nn.functional.normalize(k3, dim=-1)
    bias = 16.0 * torch.sigmoid(torch.randn(p, h, t, t, generator=g,
                                            device=device))
    cut = torch.rand(p, 1, t, t, generator=g, device=device) < 0.25
    bias = bias - 100.0 * cut.float()
    return (*(x.to(torch.bfloat16) for x in (q3, k3, v3, do)),
            bias.contiguous(), h)


@pytest.mark.parametrize("p", [1, 16])
@pytest.mark.parametrize("t", [64, 256])
def test_biased_kernels_match_plain_on_card(cuda_device, t, p):
    """The biased forward and backward (``attention_bias_*_kernel``)
    against the plain version with the same bias at SwinV2's D 32, one
    call each: o and lse as B1's forward tolerance; dq, dk, dv as B2's;
    dbias, which its kernel sums over the batch rows of each block in f32
    from f32 p and dP, within 1e-3 relative L2 (the order of the sums and
    ex2.approx)."""
    q3, k3, v3, do, bias, h = _bias_case(t, p, cuda_device, 11 * t + p)
    before = (ss.short_attention_bias_fwd.launches,
              ss.short_attention_bias_bwd.launches)
    o_k, lse_k = ss.short_attention_bias_fwd(q3, k3, v3, bias, h, 1.0)
    o_p, lse_p = ss.attention_fwd_plain(q3, k3, v3, None, h, False, 1.0,
                                        bias)
    delta = ss.row_delta(do, o_p)
    got = ss.short_attention_bias_bwd(q3, k3, v3, bias, h, 1.0, o_p, lse_p,
                                      do, delta)
    want = ss.attention_bwd_plain(q3, k3, v3, None, h, False, o_p, lse_p,
                                  do, delta, 1.0, bias)
    torch.cuda.synchronize()
    assert (ss.short_attention_bias_fwd.launches,
            ss.short_attention_bias_bwd.launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert (o_k.float() - o_p.float()).abs().max() <= \
        FWD_TOL[torch.bfloat16]
    assert (lse_k - lse_p).abs().max() <= 1e-2
    for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert torch.isfinite(x).all(), name
        assert _rel_l2(x, y, do) <= BWD_TOL[torch.bfloat16], name
    assert got[3].shape == bias.shape and got[3].dtype == torch.float32
    assert _rel_l2(got[3], want[3]) <= 1e-3


@pytest.mark.parametrize("t, p", [(256, 16), (64, 1)])
def test_biased_backward_repeats_on_card(cuda_device, t, p):
    """Every gradient is summed in a fixed order: two calls give the same
    bits, dbias too, whether its kernel sums every image of a block in one
    CTA (T 256, P 16: 1,024 tiles) or in image groups added after it (T 64,
    P 1: 4 tiles, 32 groups)."""
    q3, k3, v3, do, bias, h = _bias_case(t, p, cuda_device, 5)
    assert ss.dbias_groups(q3.shape[0], h, p, t) == (1 if t == 256 else 32)
    o, lse = ss.short_attention_bias_fwd(q3, k3, v3, bias, h, 1.0)
    first, second = (ss.short_attention_bias_bwd(q3, k3, v3, bias, h, 1.0,
                                                 o, lse, do)
                     for _ in range(2))
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first[:3], second[:3]):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16)), name
    assert torch.equal(first[3], second[3])


def test_biased_kernels_reject_unsupported_inputs(cuda_device):
    q3, k3, v3, do, bias, h = _bias_case(64, 1, cuda_device, 3, rows=2)
    with pytest.raises(ValueError, match="float16 / bfloat16"):
        ss.short_attention_bias_fwd(q3.float(), k3.float(), v3.float(),
                                    bias, h, 1.0)
    with pytest.raises(ValueError, match="bias must be"):
        ss.short_attention_bias_fwd(q3, k3, v3, bias[:, :2], h, 1.0)
    with pytest.raises(ValueError, match="bias must be"):
        ss.short_attention_bias_fwd(q3, k3, v3, bias.half(), h, 1.0)
    wide = torch.zeros(2 * h, 64, 136, device=cuda_device,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D <= 128"):
        ss.short_attention_bias_fwd(wide, wide, wide, bias, h, 1.0)
    with pytest.raises(ValueError, match="whole groups"):
        ss.short_attention_bias_fwd(q3[:h], k3[:h], v3[:h],
                                    bias.expand(2, -1, -1, -1).contiguous(),
                                    h, 1.0)
    long = torch.zeros(h, 520, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T=520"):
        ss.short_attention_bias_fwd(long, long, long,
                                    torch.zeros(1, h, 520, 520,
                                                device=cuda_device), h, 1.0)


def test_swin_block_gradients_flow_through_biased_kernels(cuda_device):
    """A shifted SwinV2 block (window 8 over 16 x 16, so 4 windows and
    the shift mask) in bf16 on the card: one biased forward and one biased
    backward launch, every leaf's gradient finite and nonzero, and within
    5e-2 relative L2 of the CPU f32 plain path (bf16 rounds x, the weights,
    q / k / v and the kernels' p and ds, ~0.4% each), the CPB MLP's
    included (through dbias)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import SwinV2Block
    layer = SwinV2Block(n_in=64, num_heads=2, window_size=8, shift_size=4,
                        cpb_hidden=64)
    params = layer.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 64, generator=g)
    w = torch.randn(2, 16, 16, 64, generator=g)

    def grads(device, dt):
        ps = {k: p.to(device, dt).requires_grad_(True)
              for k, p in params.items()}
        xs = x.to(device, dt).requires_grad_(True)
        y, _ = layer.forward(ps, {}, xs)
        keys = sorted(ps)
        out = torch.autograd.grad((y.float() * w.to(device)).sum(),
                                  [ps[k] for k in keys] + [xs])
        return dict(zip(keys + ["x"], out))

    before = (ss.short_attention_bias_fwd.launches,
              ss.short_attention_bias_bwd.launches)
    card = grads(cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    assert (ss.short_attention_bias_fwd.launches - before[0],
            ss.short_attention_bias_bwd.launches - before[1]) == (1, 1)
    want = grads("cpu", torch.float32)
    for name, got in card.items():
        assert torch.isfinite(got).all() and got.float().norm() > 0, name
        assert _rel_l2(got.cpu(), want[name]) <= 5e-2, name


# ------------------------------------------------------------ LSTM (B6)
def _lstm_case(t, n, h, dtype, peephole, masked, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn(t, n, 4 * h, generator=g)
    r = torch.randn(h, 4 * h, generator=g) / h ** 0.5
    h0 = torch.randn(n, h, generator=g) * 0.5
    c0 = torch.randn(n, h, generator=g) * 0.5
    peep = tuple(torch.randn(h, generator=g) * 0.1 for _ in range(3)) \
        if peephole else None
    mask = (torch.rand(t, n, generator=g) > 0.3).float() if masked else None
    cast = lambda x: x.to(device, dtype)
    return (cast(xw), cast(r), cast(h0), cast(c0),
            None if peep is None else tuple(cast(p) for p in peep),
            None if mask is None else mask.to(device))


#: max-abs of y, hT and cT against the plain version: in f32 the two sum
#: the H products of a gate in other orders (~1e-6 per step, carried over
#: up to 128 dependent steps); in bf16 both round h and c to bf16 each
#: step, so an order difference can flip a rounding (4e-3 at |h| ~ 1) and
#: the flip carries forward
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("peephole", [False, True], ids=["plain", "peep"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("t", [1, 7, 128])
@pytest.mark.parametrize("n", [1, 64])
@pytest.mark.parametrize("h", [16, 512])
def test_lstm_kernel_matches_plain_on_card(cuda_device, t, n, h, masked,
                                           peephole, dtype):
    args = _lstm_case(t, n, h, dtype, peephole, masked, cuda_device,
                      seed=t * n + h)
    before = lk.lstm_recurrence_fwd.launches
    got = lk.lstm_recurrence_fwd(*args)
    want = lk.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.launches == before + 1
    assert got[0].shape == (t, n, h) and got[0].dtype == dtype
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= LSTM_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [18, 100, 1024])
def test_lstm_kernel_widths_and_staging_paths(cuda_device, h, dtype):
    """Widths whose rows do not split into 16-byte loads (18; 100 in bf16)
    take the kernel's element-wise staging, the others its vector loads;
    H 1024 needs 8 units per CTA. Masked, with peepholes, N 5."""
    args = _lstm_case(7, 5, h, dtype, True, True, cuda_device, seed=h)
    got = lk.lstm_recurrence_fwd(*args)
    want = lk.lstm_recurrence_plain(*args)
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= LSTM_TOL[dtype]


def test_lstm_kernel_reads_strided_xw(cuda_device):
    """xw_t may be the [T, N, 4H] view of an [N, T, 4H] projection (the
    layer's layout): the kernel takes its strides."""
    xw, r, h0, c0, _, _ = _lstm_case(9, 5, 32, torch.float32, False, False,
                                     cuda_device)
    strided = xw.transpose(0, 1).contiguous().transpose(0, 1)
    got = lk.lstm_recurrence_fwd(strided, r, h0, c0)
    want = lk.lstm_recurrence_plain(xw, r, h0, c0)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-4


def test_lstm_kernel_rejects_unsupported_inputs(cuda_device):
    xw, r, h0, c0, _, _ = _lstm_case(3, 2, 16, torch.float32, False, False,
                                     cuda_device)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        lk.lstm_recurrence_fwd(xw.double(), r.double(), h0.double(),
                               c0.double())
    with pytest.raises(ValueError, match="R must be"):
        lk.lstm_recurrence_fwd(xw, r[:, :32].contiguous(), h0, c0)
    with pytest.raises(ValueError, match="h0 must be"):
        lk.lstm_recurrence_fwd(xw, r, h0.bfloat16(), c0)
    with pytest.raises(ValueError, match="unit stride"):
        strided = torch.zeros(3 * 2 * 128, device=cuda_device).as_strided(
            (3, 2, 64), (256, 128, 2))
        lk.lstm_recurrence_fwd(strided, r, h0, c0)
    # softmax is row-wise and has a code now: it launches (C4 closed)
    before = lk.lstm_recurrence_fwd.launches
    lk.lstm_recurrence_fwd(xw, r, h0, c0, None, None, "softmax", "tanh")
    assert lk.lstm_recurrence_fwd.launches == before + 1


@pytest.mark.parametrize("strided", [False, True], ids=["dense", "strided"])
@pytest.mark.parametrize("peephole,masked", [(False, False), (True, True)],
                         ids=["plain", "peep-masked"])
@pytest.mark.parametrize("h", [32, 256, 512, 600])
@pytest.mark.parametrize("n", [1, 8, 13, 64, 200])
def test_lstm_cluster_route_matches_plain_on_card(cuda_device, n, h,
                                                  peephole, masked, strided):
    """bf16 on the route the plan names (the cluster route up to H 512,
    N any, including N not a multiple of a cluster's rows; H 600 is wider
    than 16 CTAs of 32 units and takes the cooperative route), with
    peepholes, masks and xw as the [T, N, 4H] view of an [N, T, 4H]
    projection."""
    args = _lstm_case(17, n, h, torch.bfloat16, peephole, masked,
                      cuda_device, seed=n * h + 3)
    if strided:
        args = (args[0].transpose(0, 1).contiguous().transpose(0, 1),) + \
            args[1:]
    route = lk.lstm_plan(n, h, torch.bfloat16)["route"]
    assert route == ("cluster" if h <= 512 else "cooperative")
    before = dict(lk.lstm_recurrence_fwd.routes)
    got = lk.lstm_recurrence_fwd(*args)
    want = lk.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    assert {r: c - before[r] for r, c in
            lk.lstm_recurrence_fwd.routes.items()} == {
        r: int(r == route) for r in lk.ROUTES}
    assert got[0].shape == (17, n, h) and got[0].dtype == torch.bfloat16
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= \
            LSTM_TOL[torch.bfloat16]


def test_lstm_plan_picks_the_route(cuda_device):
    """bf16 with H a multiple of 8 up to 512 takes the cluster route
    (ceil(H / 32) CTAs a cluster of 8, 16 or 32 batch rows); f32 (the
    sampling path's N 1 included), bf16 wider than 512 and bf16 widths
    that are not a multiple of 8 take the cooperative route."""
    for n, h, dtype, route, cluster in (
            (64, 512, torch.bfloat16, "cluster", 16),
            (1, 32, torch.bfloat16, "cluster", 1),
            (200, 256, torch.bfloat16, "cluster", 8),
            (64, 600, torch.bfloat16, "cooperative", 0),
            (64, 100, torch.bfloat16, "cooperative", 0),
            (64, 512, torch.float32, "cooperative", 0),
            (1, 512, torch.float32, "cooperative", 0)):
        plan = lk.lstm_plan(n, h, dtype)
        assert (plan["route"], plan["cluster"]) == (route, cluster), \
            (n, h, dtype, plan)
        if route == "cluster":
            assert plan["rows_per_cluster"] in (8, 16, 32)
            assert plan["ctas"] == cluster * -(-n // plan["rows_per_cluster"])
            assert plan["units"] == 32 and plan["per_sm"] >= 1


def test_lstm_refused_shape_raises(cuda_device):
    """No activation is refused any more (C4 closed): a row-wise one
    (logsoftmax) in bf16 is planned on the cooperative route, never the
    cluster route, and its launch computes the plain loop's values. H 2048,
    whose R slices fit neither a cluster's nor a co-resident grid's shared
    memory, is taken by the streamed route."""
    big = 2048
    assert lk.lstm_plan(1, big, torch.bfloat16)["route"] == "streamed"
    assert lk.lstm_plan(1, 64, torch.bfloat16, "sigmoid",
                        "logsoftmax")["route"] == "cooperative"
    from deeplearning4j_tpu_torch.ops.activations import get_activation
    args = _lstm_case(3, 1, 64, torch.bfloat16, False, False, cuda_device)
    before = dict(lk.lstm_recurrence_fwd.routes)
    got = lk.lstm_recurrence_fwd(*args, "sigmoid", "logsoftmax")
    want = lk.lstm_recurrence_plain(*args, torch.sigmoid,
                                    get_activation("logsoftmax"))
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.routes["cooperative"] == \
        before["cooperative"] + 1
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= \
            LSTM_TOL[torch.bfloat16]


@pytest.mark.parametrize("peephole,masked", [(False, False), (True, True)])
def test_lstm_gradients_on_card_match_cpu(cuda_device, peephole, masked):
    """LSTMRecurrence on the card (kernel forward, plain recompute backward)
    against autograd of the plain version on the CPU, f32."""
    cpu = _lstm_case(12, 6, 32, torch.float32, peephole, masked, "cpu")
    g = torch.Generator().manual_seed(5)
    dy = torch.randn(12, 6, 32, generator=g)

    def grads(device):
        xw, r, h0, c0, peep, mask = (
            None if a is None else
            tuple(p.to(device) for p in a) if isinstance(a, tuple) else
            a.to(device) for a in cpu)
        leaves = [xw, r, h0, c0] + list(peep or ())
        leaves = [x.detach().requires_grad_(True) for x in leaves]
        peep = tuple(leaves[4:]) if peephole else None
        y, ht, ct = lk.lstm_recurrence(*leaves[:4], peep, mask)
        loss = (y * dy.to(device)).sum() + ht.sum() + 0.5 * ct.sum()
        return torch.autograd.grad(loss, leaves)

    before = lk.lstm_recurrence_fwd.launches
    card = grads(cuda_device)
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.launches == before + 1
    for got, want in zip(card, grads("cpu")):
        assert got.norm() > 0
        assert _rel_l2(got.cpu(), want) <= 1e-4


# ------------------------------------------------------------ batch norm
#: relative L2 of the batch-norm kernels' y / dx / dres against the plain
#: version: bf16 rounds every elementwise op to bf16 in both, and a
#: per-channel scale one rounding apart (the statistics summed in another
#: order) moves an output by one bf16 step; f32 differs by summation order
#: only. mean / var / dgamma / dbeta are f32 sums of the same terms.
BN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
BN_STAT_TOL = 1e-5
#: (M, C): single rows, ragged M, every channel-tile shape (C / vector
#: lanes below, at and above the 32-lane warp, and not a power of two)
BN_SHAPES = [(3, 8), (7, 16), (100, 64), (1000, 72), (2047, 256),
             (300, 1024), (50, 2048), (20000, 64)]


def _bn_inputs(m, c, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    mu = r(c)
    x = (r(m, c) * (0.5 + r(c).abs()) + mu).to(dtype)
    return (x, r(m, c).to(dtype), r(m, c).to(dtype), 0.5 + r(c).abs(),
            0.1 * r(c), mu + 0.1 * r(c))


def _bn_run(kind, kernel, x, res, dy, gamma, beta, shift):
    """(y, mean, var, rstd), then the backward on those outputs. kind:
    "train" (identity BN), "relu" (its ReLU folded in; kernel only) or
    "add_act" (the ReLU tail)."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    relu = kind == "add_act"
    if kernel and kind == "relu":
        fwd = bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5, True)
        y, mean, _, rstd = fwd
        bwd = bnk.bn_train_bwd(dy, x, gamma, mean, rstd, beta, True)
    elif kernel:
        fwd = bnk.bn_add_act_fwd(x, gamma, beta, shift, res, 1e-5, True) \
            if relu else bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5)
        y, mean, _, rstd = fwd
        bwd = bnk.bn_add_act_bwd(dy, x, y, gamma, mean, rstd, True) \
            if relu else bnk.bn_train_bwd(dy, x, gamma, mean, rstd)
    else:
        fwd = bnk.bn_fwd_plain(x, gamma, beta, shift, 1e-5,
                               res if relu else None, relu)
        y, mean, _, rstd = fwd
        bwd = bnk.bn_bwd_plain(dy, x, gamma, mean, rstd, y, relu)
    return fwd, bwd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["train", "add_act"])
@pytest.mark.parametrize("m,c", BN_SHAPES)
def test_batchnorm_kernels_match_plain_on_card(cuda_device, m, c, kind,
                                               dtype):
    """Forward (y, mean, var) and backward (dx, dgamma, dbeta, and dres
    for the ReLU tail) of both batch-norm kernels against the plain
    version; the backward of both on the kernel forward's outputs (the
    same ReLU mask)."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    case = _bn_inputs(m, c, dtype, cuda_device, m + c)
    x, res, dy, gamma, beta, shift = case
    counter = bnk.bn_add_act_fwd if kind == "add_act" else bnk.bn_train_fwd
    before = counter.launches
    (y, mean, var, rstd), grads = _bn_run(kind, True, *case)
    (y_p, mean_p, var_p, _), _ = _bn_run(kind, False, *case)
    relu = kind == "add_act"
    grads_p = bnk.bn_bwd_plain(dy, x, gamma, mean, rstd, y, relu)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert y.dtype == dtype and grads[0].dtype == dtype
    assert _rel_l2(y, y_p) <= BN_TOL[dtype]
    assert _rel_l2(grads[0], grads_p[0]) <= BN_TOL[dtype]
    if relu:
        assert torch.equal(grads[3], grads_p[3])
    for got, want in ((mean, mean_p), (var, var_p), (grads[1], grads_p[1]),
                      (grads[2], grads_p[2])):
        assert _rel_l2(got, want) <= BN_STAT_TOL


@pytest.mark.parametrize("kind", ["train", "add_act", "relu"])
def test_batchnorm_kernels_are_bitwise_reproducible(cuda_device, kind):
    """No floating-point atomics: two runs give the same bits."""
    case = _bn_inputs(40000, 256, torch.bfloat16, cuda_device, 3)
    (fwd1, bwd1), (fwd2, bwd2) = (_bn_run(kind, True, *case)
                                  for _ in range(2))
    for a, b in zip(fwd1 + tuple(bwd1), fwd2 + tuple(bwd2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("m,c", BN_SHAPES)
def test_batchnorm_relu_fold_matches_plain_on_card(cuda_device, m, c,
                                                   dtype):
    """The BN layer's ReLU folded into batchnorm_train: relu(bn(x)) and the
    backward whose mask is recomputed from x against the plain version
    (one launch a direction); the recomputed mask is the forward's y > 0,
    so the identity backward on the masked dy gives the same bits."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    x, _, dy, gamma, beta, shift = _bn_inputs(m, c, dtype, cuda_device,
                                              m + c + 1)
    before = (bnk.bn_train_fwd.launches, bnk.bn_train_bwd.launches)
    y, mean, var, rstd = bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5, True)
    grads = bnk.bn_train_bwd(dy, x, gamma, mean, rstd, beta, True)
    after = (bnk.bn_train_fwd.launches, bnk.bn_train_bwd.launches)
    y_p, mean_p, var_p, _ = bnk.bn_fwd_plain(x, gamma, beta, shift, 1e-5,
                                             relu=True)
    grads_p = bnk.bn_bwd_plain(dy, x, gamma, mean, rstd, relu=True,
                               beta=beta)
    masked = torch.where(y > 0, dy, torch.zeros_like(dy))
    identity = bnk.bn_train_bwd(masked, x, gamma, mean, rstd)
    torch.cuda.synchronize()
    assert after == (before[0] + 1, before[1] + 1)
    assert (y >= 0).all() and y.dtype == dtype
    assert _rel_l2(y, y_p) <= BN_TOL[dtype]
    assert _rel_l2(grads[0], grads_p[0]) <= BN_TOL[dtype]
    for got, want in ((mean, mean_p), (var, var_p), (grads[1], grads_p[1]),
                      (grads[2], grads_p[2])):
        assert _rel_l2(got, want) <= BN_STAT_TOL
    for got, want in zip(grads, identity):
        assert torch.equal(got, want)


#: the spin kernel a profiled window runs before ``fn`` (its record is the
#: one _profiled_kernels leaves out) and the cycles it spins (~5 ms)
_SPIN_KERNEL, _SPIN_CYCLES = "spin_kernel", 10_000_000


def _profiled_kernels(fn):
    """Names of the CUDA kernels ``fn()`` launches, under torch.profiler.
    The profiler can drop the device records of the first kernels a
    window launches (in one run of this whole file it kept 0 or 1 of two
    batch-norm kernels; with a short spin kernel first, it dropped the
    spin's record and kept every later one). So the card first spins
    (``torch.cuda._sleep``) inside the window and ``fn``'s kernels run
    after it; the spin's record, kept or dropped, is left out."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(_SPIN_CYCLES)
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and
            _SPIN_KERNEL not in e.name]


@pytest.mark.parametrize("kind", ["train", "relu", "add_act"])
def test_batchnorm_one_launch_a_direction(cuda_device, kind):
    """A forward and a backward wrapper call launch one batch-norm kernel
    each and nothing else (no cast, copy or fill), at a resident site and
    at a streaming one."""
    for m, c in ((6272, 512), (25088, 1024)):
        case = _bn_inputs(m, c, torch.bfloat16, cuda_device, 9)
        _bn_run(kind, True, *case)          # build and plan outside
        names = _profiled_kernels(lambda: _bn_run(kind, True, *case))
        assert len(names) == 2, names
        assert all("dl4j_bn" in n for n in names), names


def test_batchnorm_takes_bf16_gamma_without_a_cast(cuda_device):
    """bf16 gamma and beta (a bf16 net's cast parameters) go to the kernel
    as they are: two launches and no other kernel, dgamma / dbeta come
    back in bf16, and the outputs agree with the plain version on the
    same bf16 parameters (dgamma / dbeta to one bf16 rounding)."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    x, _, dy, gamma, beta, shift = _bn_inputs(6272, 512, torch.bfloat16,
                                              cuda_device, 11)
    gamma, beta = gamma.bfloat16(), beta.bfloat16()
    out = {}

    def run():
        out["fwd"] = bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5, True)
        y, mean, _, rstd = out["fwd"]
        out["bwd"] = bnk.bn_train_bwd(dy, x, gamma, mean, rstd, beta, True)
    run()
    names = _profiled_kernels(run)
    assert len(names) == 2 and all("dl4j_bn" in n for n in names), names
    y, mean, _, rstd = out["fwd"]
    dx, dgamma, dbeta = out["bwd"]
    assert dgamma.dtype == dbeta.dtype == torch.bfloat16
    y_p = bnk.bn_fwd_plain(x, gamma, beta, shift, 1e-5, relu=True)[0]
    dx_p, dg_p, db_p, _ = bnk.bn_bwd_plain(dy, x, gamma, mean, rstd,
                                           relu=True, beta=beta)
    assert dg_p.dtype == torch.bfloat16
    assert _rel_l2(y, y_p) <= BN_TOL[torch.bfloat16]
    assert _rel_l2(dx, dx_p) <= BN_TOL[torch.bfloat16]
    assert _rel_l2(dgamma, dg_p) <= 2 ** -8
    assert _rel_l2(dbeta, db_p) <= 2 ** -8


def test_batchnorm_refused_cooperative_launch_raises(cuda_device):
    """A cooperative launch the card refuses (here a plan whose grid
    exceeds the co-resident CTAs) raises RuntimeError and counts no
    launch: there is no other route to fall back to."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    x, _, _, gamma, beta, shift = _bn_inputs(4096, 256, torch.bfloat16,
                                             cuda_device, 13)
    bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5)
    key = (x.device.index, 4096, 256, torch.bfloat16, bnk.FWD)
    saved = bnk._PLANS[key]
    arr = type(saved[0])(*saved[0])
    arr[0] = 4 * arr[0]                     # grid: 4x the co-resident CTAs
    arr[5] = 2 * 256 * arr[0] + 2 * 256     # its scratch
    bnk._PLANS[key] = (arr, ctypes.addressof(arr), arr[5])
    before = bnk.bn_train_fwd.launches
    try:
        with pytest.raises(RuntimeError):
            bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5)
    finally:
        bnk._PLANS[key] = saved
    assert bnk.bn_train_fwd.launches == before


def test_batchnorm_kernel_refuses_wide_rows_and_f16_parameters(cuda_device):
    """C above 512 vectors (4104 bf16, 2052 f32) and gamma in f16, which
    the fused route does not take, run on the general route (one launch
    counted a wrapper call) and agree with the plain version."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    for dtype, c, pdtype in ((torch.bfloat16, 4104, torch.float32),
                             (torch.float32, 2052, torch.float32),
                             (torch.bfloat16, 64, torch.float16)):
        x, _, dy, gamma, beta, shift = _bn_inputs(40, c, dtype, cuda_device,
                                                  c)
        gamma, beta = gamma.to(pdtype), beta.to(pdtype)
        assert bnk.route(x, gamma) == "general"
        before = dict(bnk.bn_train_fwd.routes)
        y, mean, var, rstd = bnk.bn_train_fwd(x, gamma, beta, shift, 1e-5)
        dx, dg, db = bnk.bn_train_bwd(dy, x, gamma, mean, rstd)
        assert bnk.bn_train_fwd.routes["general"] == before["general"] + 1
        y_p, mean_p, _, _ = bnk.bn_fwd_plain(x, gamma, beta, shift, 1e-5)
        dx_p, dg_p, _, _ = bnk.bn_bwd_plain(dy, x, gamma, mean, rstd)
        assert dg.dtype == pdtype
        assert _rel_l2(y, y_p) <= BN_TOL[dtype]
        assert _rel_l2(dx, dx_p) <= BN_TOL[dtype]
        assert _rel_l2(mean, mean_p) <= BN_STAT_TOL
        assert _rel_l2(dg.float(), dg_p.float()) <= \
            (BN_STAT_TOL if pdtype == torch.float32 else 2 ** -8)


def test_batchnorm_kernel_refuses_what_it_does_not_take(cuda_device):
    """What is not a batch norm the kernels take raises and nothing
    launches: a non-contiguous x, an x that is not [M, C], f64; f16 and C
    not a multiple of the 16-byte vector take the general route."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    ones = torch.ones(16, device=cuda_device)
    before = bnk.bn_train_fwd.launches
    for bad in (torch.zeros(8, 16, device=cuda_device, dtype=torch.float64),
                torch.zeros(2, 8, 8, device=cuda_device),
                torch.zeros(16, 8, device=cuda_device).t()):
        with pytest.raises(ValueError):
            bnk.bn_train_fwd(bad, ones[:bad.shape[1]], ones[:bad.shape[1]],
                             ones[:bad.shape[1]], 1e-5)
    assert bnk.bn_train_fwd.launches == before


def test_batchnorm_layer_on_card_raises_for_f16(cuda_device):
    """A BN layer in training on f16 CUDA tensors (f16 parameters, C 3)
    runs the general route's kernels and agrees with the layer's plain
    path on the CPU; nothing raises any more."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNormalization
    bn = BatchNormalization(n_out=3, activation="relu")
    state = bn.init_state()
    params = {k: v.half() for k, v in bn.init_params(
        torch.Generator()).items()}
    x = torch.randn(4, 9, 9, 3, generator=torch.Generator().manual_seed(1))
    before = bnk.bn_train_fwd.routes["general"]
    y, st = bn.forward({k: v.to(cuda_device) for k, v in params.items()},
                       {k: v.to(cuda_device) for k, v in state.items()},
                       x.half().to(cuda_device), train=True)
    y_p, st_p = bn.forward({k: v.float() for k, v in params.items()},
                           state, x, train=True)
    torch.cuda.synchronize()
    assert bnk.bn_train_fwd.routes["general"] == before + 1
    assert y.dtype == torch.float16
    assert _rel_l2(y.float().cpu(), y_p) <= 2e-3
    for k in ("mean", "var"):
        assert _rel_l2(st[k].cpu(), st_p[k]) <= 1e-3


def test_resnet_tiny_trains_through_the_batchnorm_kernels(cuda_device):
    """resnet_tiny on the card: the fusion plan takes its 2 residual tails,
    one step launches the fused kernel 2 times and batchnorm_train at the
    other 7 BNs, each with its backward; the f32 step's loss, gradients
    and running statistics agree with the CPU (TF32 off)."""
    import numpy as np
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    from deeplearning4j_tpu_torch.models import resnet_tiny_conf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from deeplearning4j_tpu_torch.utils import graph_from_numpy
    torch.backends.cudnn.allow_tf32 = False
    conf = lambda: resnet_tiny_conf(num_classes=4, height=16, width=16,
                                    channels=3)
    net = ComputationGraph(conf(), device=cuda_device).init()
    cpu = graph_from_numpy(conf(), {v: {k: a.cpu().numpy()
                                        for k, a in p.items()}
                                    for v, p in net.params.items()},
                           device="cpu")
    assert len(net._get_fusion_plan()[0]) == 2
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]
    counters = (bnk.bn_train_fwd, bnk.bn_train_bwd, bnk.bn_add_act_fwd,
                bnk.bn_add_act_bwd)
    before = [f.launches for f in counters]
    net.fit_batch(DataSet(x, y))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [7, 7, 2, 2]
    cpu.fit_batch(DataSet(x, y))
    assert abs(float(net.score_value) - float(cpu.score_value)) <= \
        1e-4 * abs(float(cpu.score_value))
    for v in cpu.params:
        for k in cpu.params[v]:
            assert _rel_l2(net.params[v][k].cpu(), cpu.params[v][k]) <= 1e-3
        for k in cpu.state[v]:
            assert _rel_l2(net.state[v][k].cpu(), cpu.state[v][k]) <= 1e-4


# ------------------------------------------- C4: the shapes the card refused
#: batch norms the fused route does not take: an RGB input's C 3, LeNet's
#: 20 and 50 channels (bf16, f16; f32 at 50), C above 512 vectors
C4_BN = [(m, c, dt) for m, c in ((4000, 3), (3000, 20), (2000, 50))
         for dt in (torch.bfloat16, torch.float16, torch.float32)
         if not (dt == torch.float32 and c == 20)] + \
    [(300, 8192, torch.bfloat16), (300, 4096, torch.float32)]


@pytest.mark.parametrize("kind", ["train", "relu", "add_act"])
@pytest.mark.parametrize("m,c,dtype", C4_BN,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_batchnorm_general_route_matches_plain_on_card(cuda_device, m, c,
                                                       dtype, kind):
    """The general route's three variants against the plain version, with
    bitwise repeats and one launch counted a wrapper call."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    case = _bn_inputs(m, c, dtype, cuda_device, m + c)
    x, res, dy, gamma, beta, shift = case
    assert bnk.route(x, gamma) == "general"
    counter = bnk.bn_add_act_fwd if kind == "add_act" else bnk.bn_train_fwd
    before = counter.launches
    fwd, grads = _bn_run(kind, True, *case)
    assert counter.launches == before + 1
    again = _bn_run(kind, True, *case)
    relu = kind != "train"
    y, mean, var, rstd = fwd
    y_p, mean_p, var_p, _ = bnk.bn_fwd_plain(
        x, gamma, beta, shift, 1e-5, res if kind == "add_act" else None,
        relu)
    grads_p = bnk.bn_bwd_plain(dy, x, gamma, mean, rstd,
                               y if kind == "add_act" else None, relu, beta)
    torch.cuda.synchronize()
    for a, b in zip(fwd + tuple(grads), again[0] + tuple(again[1])):
        assert torch.equal(a, b)
    assert _rel_l2(y, y_p) <= BN_TOL[dtype]
    assert _rel_l2(grads[0], grads_p[0]) <= BN_TOL[dtype]
    for got, want in ((mean, mean_p), (var, var_p), (grads[1], grads_p[1]),
                      (grads[2], grads_p[2])):
        assert _rel_l2(got, want) <= BN_STAT_TOL


def test_batchnorm_general_route_launches_its_kernels_only(cuda_device):
    """A general-route wrapper call launches its three kernels (statistics,
    finalize, elementwise) a direction and nothing else."""
    case = _bn_inputs(3000, 20, torch.bfloat16, cuda_device, 5)
    _bn_run("relu", True, *case)
    names = _profiled_kernels(lambda: _bn_run("relu", True, *case))
    assert len(names) == 6 and all("bn_gen" in n for n in names), names


#: every elementwise activation, as the gates' (with a tanh cell) and as
#: the cell's (with sigmoid gates); the row-wise ones have their own test
#: (a logsoftmax gate, whose values are about -log H, grows c
#: geometrically until it overflows, in the plain loop as well)
LSTM_ACTS = sorted(set(lk.ACT_CODES) - {"linear"} - set(lk.ROW_WISE))


@pytest.mark.parametrize("where", ["gate", "cell"])
@pytest.mark.parametrize("act", LSTM_ACTS)
def test_lstm_activations_match_plain_on_card(cuda_device, act, where):
    """B6 with each elementwise activation against the plain loop (f32,
    peepholes and a mask; inputs scaled down so unbounded activations
    stay in range), on the cooperative route unless sigmoid / tanh."""
    from deeplearning4j_tpu_torch.ops.activations import get_activation
    acts = (act, "tanh") if where == "gate" else ("sigmoid", act)
    xw, r, h0, c0, peep, mask = _lstm_case(9, 5, 48, torch.float32, True,
                                           True, cuda_device, seed=7)
    args = (xw * 0.3, r * 0.3, h0, c0, peep, mask)
    got = lk.lstm_recurrence_fwd(*args, *acts)
    want = lk.lstm_recurrence_plain(*args, *(get_activation(a)
                                             for a in acts))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= LSTM_TOL[torch.float32]


@pytest.mark.parametrize("dtype,h,route", [
    (torch.float16, 512, "cooperative"), (torch.float16, 100, "cooperative"),
    (torch.float32, 2048, "streamed"), (torch.bfloat16, 2048, "streamed"),
    (torch.float32, 1400, "streamed")])
def test_lstm_f16_and_streamed_route_match_plain_on_card(cuda_device, dtype,
                                                         h, route):
    """f16 on the cooperative route and widths whose R slices do not fit
    shared memory on the streamed route, against the plain loop; the plan
    names the route and the launch takes it."""
    args = _lstm_case(6, 4, h, dtype, True, True, cuda_device, seed=h)
    plan = lk.lstm_plan(4, h, dtype)
    assert plan["route"] == route
    if route == "streamed":
        assert 0 < plan["resident_rows"] < h
    before = dict(lk.lstm_recurrence_fwd.routes)
    got = lk.lstm_recurrence_fwd(*args)
    want = lk.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.routes[route] == before[route] + 1
    tol = LSTM_TOL.get(dtype, LSTM_TOL[torch.bfloat16])
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.parametrize("acts", [("hardsigmoid", "softsign"),
                                  ("relu", "identity")])
def test_lstm_activation_gradients_on_card_match_cpu(cuda_device, acts):
    """LSTMRecurrence with the layer's activations (kernel forward, plain
    recompute backward) against autograd of the plain loop on the CPU."""
    from deeplearning4j_tpu_torch.ops.activations import get_activation
    cpu = _lstm_case(8, 3, 32, torch.float32, True, False, "cpu")
    g = torch.Generator().manual_seed(5)
    dy = torch.randn(8, 3, 32, generator=g)

    def grads(device):
        xw, r, h0, c0, peep, _ = (
            None if a is None else
            tuple(p.to(device) for p in a) if isinstance(a, tuple) else
            a.to(device) for a in cpu)
        leaves = [x.detach().requires_grad_(True)
                  for x in [xw * 0.3, r * 0.3, h0, c0] + list(peep)]
        y, ht, ct = lk.lstm_recurrence(*leaves[:4], tuple(leaves[4:]), None,
                                       *acts)
        loss = (y * dy.to(device)).sum() + ht.sum() + 0.5 * ct.sum()
        return torch.autograd.grad(loss, leaves)

    before = lk.lstm_recurrence_fwd.launches
    card = grads(cuda_device)
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.launches == before + 1
    for got, want in zip(card, grads("cpu")):
        assert got.norm() > 0
        assert _rel_l2(got.cpu(), want) <= 1e-4


#: the row-wise pairs: a softmax gate with a tanh cell, sigmoid gates with
#: a logsoftmax cell
ROW_PAIRS = [("softmax", "tanh"), ("sigmoid", "logsoftmax")]


#: xw and R of a row-wise case are scaled by this where the cell is
#: logsoftmax: h = o * logsoftmax(c) (about -6 o at H 512) feeds back
#: through R, and at scale 1 the recurrence expands (the plain f32 loop
#: ends 1e11 off its f64 result at T 32, H 512); at 0.05 it contracts
LOGSOFTMAX_SCALE = 0.05


def _row_wise_reference(args, acts, dtype):
    """(y, hT, cT) of the plain loop in f64 on the same inputs, each with
    the limit a kernel output is held to: ``LSTM_TOL[dtype]`` times the
    output's largest |value| (a logsoftmax cell's h and c run to tens).
    The plain loop in ``dtype`` must meet the same limits, so an
    ill-conditioned case fails here rather than loosen the check."""
    from deeplearning4j_tpu_torch.ops.activations import get_activation
    fns = [get_activation(a) for a in acts]
    as64 = lambda x: None if x is None else \
        tuple(p.double() for p in x) if isinstance(x, tuple) else x.double()
    ref = lk.lstm_recurrence_plain(*(as64(a) for a in args), *fns)
    plain = lk.lstm_recurrence_plain(*args, *fns)
    out = []
    for r, p in zip(ref, plain):
        limit = LSTM_TOL[dtype] * r.abs().max().item()
        assert (p.double() - r).abs().max().item() <= limit, \
            "the plain loop misses its own limit: an ill-conditioned case"
        out.append((r, limit))
    return out


@pytest.mark.parametrize("acts", ROW_PAIRS, ids="-".join)
@pytest.mark.parametrize("dtype,t,n,h,route", [
    (torch.float32, 32, 64, 512, "cooperative"),
    (torch.bfloat16, 8, 64, 512, "cooperative"),
    (torch.float32, 5, 3, 2048, "streamed"),
    (torch.float32, 7, 200, 48, "cooperative")])
@pytest.mark.parametrize("peephole,masked", [(False, False), (True, True)],
                         ids=["plain", "peep-masked"])
def test_lstm_row_wise_activations_match_plain_on_card(
        cuda_device, acts, dtype, t, n, h, route, peephole, masked):
    """B6 with a row-wise gate or cell activation (two grid-wide row
    reductions a step) against the plain loop, on the route the plan
    names; N 200 takes several passes of rows a step. bf16 runs at T 8:
    its c is rounded to bf16 each step, and with peepholes a logsoftmax
    cell drives c to -200 by T 32, where a bf16 step rounds by 0.5."""
    args = _lstm_case(t, n, h, dtype, peephole, masked, cuda_device,
                      seed=h + n)
    if acts[1] == "logsoftmax":
        args = (args[0] * LOGSOFTMAX_SCALE, args[1] * LOGSOFTMAX_SCALE) + \
            args[2:]
    assert lk.lstm_plan(n, h, dtype, *acts)["route"] == route
    before = dict(lk.lstm_recurrence_fwd.routes)
    got = lk.lstm_recurrence_fwd(*args, *acts)
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.routes[route] == before[route] + 1
    for a, (want, limit) in zip(got, _row_wise_reference(args, acts, dtype)):
        assert torch.isfinite(a).all()
        assert (a.double() - want).abs().max().item() <= limit


@pytest.mark.parametrize("acts", ROW_PAIRS, ids="-".join)
def test_lstm_row_wise_gradients_on_card_match_cpu(cuda_device, acts):
    """LSTMRecurrence with a row-wise pair (kernel forward, plain recompute
    backward) against autograd of the plain loop on the CPU."""
    test_lstm_activation_gradients_on_card_match_cpu(cuda_device, acts)


def test_lstm_c4_launches_one_kernel(cuda_device):
    """A streamed or non-default-activation wrapper call launches one
    kernel and no plain-path operator (no GEMM)."""
    for h, acts in ((2048, ("sigmoid", "tanh")),
                    (64, ("hardsigmoid", "softsign")),
                    (64, ("softmax", "logsoftmax"))):
        args = _lstm_case(4, 2, h, torch.float32, False, False, cuda_device)
        lk.lstm_recurrence_fwd(*args, *acts)
        names = _profiled_kernels(lambda: lk.lstm_recurrence_fwd(*args,
                                                                 *acts))
        assert len(names) == 1 and "lstm_fwd_kernel" in names[0], names


#: head dims no kernel took before: not a multiple of 8 (zero-padded),
#: above 128 (the wide instance) and above 256 (columns split)
C4_D = [4, 12, 36, 136, 200, 256, 264, 320, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("d", C4_D)
@pytest.mark.parametrize("kernel,t", [("short", 65), ("short", 512),
                                      ("flash", 577)])
def test_attention_head_dims_match_plain_on_card(cuda_device, kernel, t, d,
                                                 dtype):
    """Forward (o, lse) and backward (dq, dk, dv) at a C4 head dim against
    the plain versions, causal, with a holey key mask."""
    fwd = ss.short_attention_fwd if kernel == "short" else ff.flash_forward
    b, h = 3, 2
    g = torch.Generator(device=cuda_device).manual_seed(t + d)
    q3, k3, v3, do = (torch.randn(b * h, t, d, generator=g,
                                  device=cuda_device).to(dtype)
                      for _ in range(4))
    km = _holey_mask(t, [t, max(t // 2, 1), 0], cuda_device)
    live = torch.tensor([True, True, False], device=cuda_device) \
        .repeat_interleave(h)
    o_k, lse_k = fwd(q3, k3, v3, km, h, True)
    o_p, lse_p = ss.attention_fwd_plain(q3, k3, v3, km, h, True)
    torch.cuda.synchronize()
    assert o_k.shape == q3.shape and torch.isfinite(o_k).all()
    assert (o_k[live].float() - o_p[live].float()).abs().max() <= \
        FWD_TOL[dtype]
    assert (lse_k[live] - lse_p[live]).abs().max() <= 1e-2
    delta = ss.row_delta(do, o_p)
    grads = _run_bwd(kernel, q3, k3, v3, km, h, True, o_p, lse_p, do,
                     delta)[0]
    want = ss.attention_bwd_plain(q3, k3, v3, km, h, True, o_p, lse_p, do,
                                  delta)
    for x, y in zip(grads, want):
        assert x.shape == q3.shape
        assert _rel_l2(x[live], y[live], do[live]) <= BWD_TOL[dtype]


@pytest.mark.parametrize("d", [36, 256, 264])
def test_attention_c4_launches_one_kernel(cuda_device, d):
    """A padded (D 36), wide (D 256) or split (D 264) forward wrapper call
    launches one
    attention kernel, beside the pad and slice copies, and no plain-path
    operator (no GEMM, no softmax)."""
    q3 = torch.randn(4, 128, d, device=cuda_device, dtype=torch.bfloat16)
    ss.short_attention_fwd(q3, q3, q3, None, 2, True)
    names = _profiled_kernels(
        lambda: ss.short_attention_fwd(q3, q3, q3, None, 2, True))
    attn = [n for n in names if "attention" in n or "shortseq" in n]
    assert len(attn) == 1, names
    assert not any("gemm" in n.lower() or "softmax" in n.lower()
                   for n in names), names


# ------------------------------------- the training API's paths on the card
def test_frozen_char_rnn_layer_stays_bit_identical_on_b6(cuda_device):
    """A char-RNN (2 x 64 GravesLSTM, bf16) fine-tuned after
    ``TransferLearning.Builder.set_feature_extractor(0)``: every step
    launches B6 for both layers, layer 0's f32 masters stay bit-identical
    under rmsprop with l2, layer 1 moves."""
    import numpy as np
    from deeplearning4j_tpu_torch.models import char_rnn_conf
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf.layers import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                      TransferLearning)
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    net = MultiLayerNetwork(char_rnn_conf(16, hidden=64, layers=2,
                                          learning_rate=0.01,
                                          tbptt_length=0),
                            compute_dtype=torch.bfloat16,
                            device=cuda_device).init()
    rng = np.random.default_rng(0)
    eye = np.eye(16, dtype=np.float32)
    toks = rng.integers(0, 16, (8, 33))
    ds = DataSet(eye[toks[:, :-1]], eye[toks[:, 1:]])
    net._fit_batch(ds)
    new = (TransferLearning.Builder(net)
           .fine_tune_configuration(FineTuneConfiguration(learning_rate=0.02))
           .set_feature_extractor(0).remove_output_layer()
           .add_layer(RnnOutputLayer(n_out=16, loss="mcxent",
                                     activation="softmax")).build())
    frozen = {k: v.clone() for k, v in new.params[0].items()}
    moving = new.params[1]["W"].clone()
    before = lk.lstm_recurrence_fwd.launches
    for _ in range(3):
        new._fit_batch(ds)
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.launches - before == 2 * 3
    for k, v in frozen.items():
        assert torch.equal(new.params[0][k], v), k
    assert not torch.equal(new.params[1]["W"], moving)
    assert np.isfinite(float(new.score_value))


def test_async_iterator_stages_bf16_on_the_card(cuda_device):
    """``AsyncDataSetIterator(stage_dtype=bf16)`` hands the consumer bf16
    features and labels already on the card (masks and integer ids in
    their own dtype), bit-equal to a cast of the host arrays."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import (AsyncDataSetIterator,
                                                   ListDataSetIterator)
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    rng = np.random.default_rng(1)
    src = [DataSet(rng.normal(size=(64, 128, 80)).astype(np.float32),
                   rng.integers(0, 80, (64, 128)),
                   np.ones((64, 128), np.float32), None) for _ in range(3)]
    got = list(AsyncDataSetIterator(ListDataSetIterator(src), prefetch=2,
                                    stage_dtype=torch.bfloat16,
                                    device=cuda_device))
    assert len(got) == 3
    for g, s in zip(got, src):
        assert g.features.is_cuda and g.features.dtype == torch.bfloat16
        assert g.labels.is_cuda and g.labels.dtype == torch.int64
        assert g.features_mask.dtype == torch.float32
        assert torch.equal(g.features.cpu(),
                           torch.from_numpy(s.features).bfloat16())
        assert torch.equal(g.labels.cpu(), torch.from_numpy(s.labels))


def test_frozen_resnet_trunk_still_launches_its_bn_kernels(cuda_device):
    """resnet_tiny with ``set_feature_extractor("avgpool")`` and a new
    head: a step still runs every BN of the frozen trunk on its kernels
    (7 + 2 a direction, lr 0 changes no launch), the trunk's parameters
    stay bit-identical, its running statistics move, the head moves."""
    import numpy as np
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    from deeplearning4j_tpu_torch.models import resnet_tiny_conf
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearning
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    net = ComputationGraph(resnet_tiny_conf(num_classes=4, height=16,
                                            width=16, channels=3),
                           device=cuda_device).init()
    new = (TransferLearning.GraphBuilder(net)
           .set_feature_extractor("avgpool")
           .remove_vertex_and_connections("fc")
           .add_layer("new_fc", OutputLayer(n_out=3, loss="mcxent",
                                            activation="softmax"), "avgpool")
           .set_outputs("new_fc").build())
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    trunk = {v: {k: a.clone() for k, a in new.params[v].items()}
             for v in new.frozen_vertices}
    stats = {v: {k: a.clone() for k, a in new.state[v].items()}
             for v in new.frozen_vertices if new.state[v]}
    head = new.params["new_fc"]["W"].clone()
    counters = (bnk.bn_train_fwd, bnk.bn_train_bwd, bnk.bn_add_act_fwd,
                bnk.bn_add_act_bwd)
    before = [f.launches for f in counters]
    new.fit_batch(DataSet(x, y))
    new.fit_batch(DataSet(x, y))
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == \
        [14, 14, 4, 4]
    for v, p in trunk.items():
        for k, a in p.items():
            assert torch.equal(new.params[v][k], a), (v, k)
    assert stats and all(not torch.equal(new.state[v]["mean"], s["mean"])
                         for v, s in stats.items())
    assert not torch.equal(new.params["new_fc"]["W"], head)


def test_mesh_prefill_runs_b1_on_local_heads(cuda_device, monkeypatch):
    """A (1, 2) serving mesh with both coordinates on the card, at the
    flagship's widths (d 768, 12 heads of 64; 2 layers, bf16): the
    prefill launches B1 once a layer a tp shard, each on the shard's 6
    heads, every launch matches the plain version on its own inputs, and
    the mesh's logits match the unsharded decoder's."""
    import numpy as np
    from deeplearning4j_tpu_torch.models import (TransformerDecoder,
                                                 transformer_lm_conf)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.parallel import generation_mesh
    net = ComputationGraph(transformer_lm_conf(32000, d_model=768,
                                               num_heads=12, num_layers=2,
                                               max_length=577),
                           compute_dtype=torch.bfloat16,
                           device=cuda_device).init()
    rng = np.random.default_rng(3)
    lengths = rng.integers(200, 513, 4)
    tokens = np.zeros((4, 512), np.int64)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, 32000, n)
    seen = []
    real = ff.short_attention_fwd

    def recording(q3, k3, v3, km, h, causal):
        seen.append((q3, k3, v3, km, h, causal))
        return real(q3, k3, v3, km, h, causal)

    monkeypatch.setattr(ff, "short_attention_fwd", recording)
    mesh = generation_mesh(1, 2, devices=[cuda_device] * 2)
    dec = TransformerDecoder(net, mesh=mesh)
    before = real.launches
    _, got, _ = dec.prefill(dec.init_cache(4), tokens, lengths)
    torch.cuda.synchronize()
    assert real.launches - before == 2 * 2
    assert [args[4] for args in seen] == [6] * 4
    for q3, k3, v3, km, h, causal in seen:
        assert q3.shape == (4 * 6, 512, 64)
        o_k, _ = real(q3, k3, v3, km, h, causal)
        o_p, _ = ss.attention_fwd_plain(q3, k3, v3, km, h, causal)
        assert (o_k.float() - o_p.float()).abs().max() <= \
            FWD_TOL[torch.bfloat16]
    monkeypatch.undo()
    plain = TransformerDecoder(net)
    _, want, _ = plain.prefill(plain.init_cache(4), tokens, lengths)
    rel = ((got.double() - want.double()).norm(dim=-1) /
           want.double().norm(dim=-1)).max().item()
    assert rel <= 5e-2


def test_sync_dp_matches_solo_on_card_with_b1_b2_per_shard(cuda_device):
    """Sync data-parallel training at data 2, both shards on the card: a
    2-layer LM (vocab 512, d 128, 2 heads of 64, T 128, B 6, f32, TF32
    off; 6 rows split 3 + 3), two steps of ``GraphDataParallelTrainer``
    against two solo ``fit_batch`` steps from the same weights: each
    step's loss within rel 1e-6, the parameters within rel-L2 1e-5, and
    B1 and B2 launched once a layer a shard a step (2 x 2 x 2 = 8 each)."""
    import numpy as np
    from deeplearning4j_tpu_torch.models import (lm_batch_sparse,
                                                 transformer_lm_conf)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (GraphDataParallelTrainer,
                                                   make_mesh)
    dev = torch.device("cuda", torch.cuda.current_device())
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        solo = ComputationGraph(transformer_lm_conf(
            512, d_model=128, num_heads=2, num_layers=2, max_length=128,
            learning_rate=3e-4), device=dev).init()
        dp = solo.clone()
        trainer = GraphDataParallelTrainer(
            dp, mesh=make_mesh(devices=[dev] * 2))
        fwd, bwd = ss.short_attention_fwd, ss.short_attention_bwd
        counted = [0, 0]
        for seed in (1, 2):
            x, y = lm_batch_sparse(np.random.default_rng(seed).integers(
                0, 512, (6, 129)))
            solo.fit_batch(DataSet(x, y))
            f0, b0 = fwd.launches, bwd.launches
            trainer.fit_batch(DataSet(x, y))
            torch.cuda.synchronize()
            counted[0] += fwd.launches - f0
            counted[1] += bwd.launches - b0
            want, got = float(solo.score_value), float(dp.score_value)
            assert abs(got - want) <= 1e-6 * abs(want)
        assert counted == [8, 8]
        a = torch.from_numpy(solo.params_flat()).double()
        b = torch.from_numpy(dp.params_flat()).double()
        assert ((a - b).norm() / a.norm()).item() <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


# ------------------------------------------- batch norm across data shards
def _rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("variant", ["identity", "relu", "tail"])
@pytest.mark.parametrize("m,c,shards", [(64, 8, 2), (3001, 64, 3),
                                        (20000, 256, 2), (777, 2048, 4)])
def test_cross_shard_batchnorm_matches_plain_on_card(cuda_device, m, c,
                                                     shards, variant,
                                                     dtype):
    """The batch norm over row blocks of one batch (``bn_train_shards``:
    each shard's partials, one finalize over all of them, each shard's
    elementwise pass, both ways; uneven blocks included) against the plain
    version on the whole batch: y, dx, dres within 1e-2 relative L2 in
    bf16 (1e-5 in f32), the statistics and dgamma / dbeta within 1e-5;
    each phase launched once a shard (the finalize once) a direction and
    no single-shard batch-norm kernel."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    x, res, dy, gamma, beta, shift = _bn_inputs(m, c, dtype, cuda_device, 9)
    tail, relu = variant == "tail", variant != "identity"
    rows = [m * i // shards for i in range(shards + 1)]
    cut = lambda t: [t[a:b].detach().requires_grad_(True)
                     for a, b in zip(rows, rows[1:])]
    xs, rs = cut(x), cut(res) if tail else None
    gl, bl = (p.detach().requires_grad_(True) for p in (gamma, beta))
    fns = (bnk.bn_xs_stats, bnk.bn_xs_finalize, bnk.bn_xs_apply,
           bnk.bn_train_fwd, bnk.bn_train_bwd, bnk.bn_add_act_fwd,
           bnk.bn_add_act_bwd)
    before = [(f.launches, getattr(f, "bwd_launches", 0)) for f in fns]
    ys, mean, var = bnk.bn_train_shards(xs, gl, bl, shift, 1e-5,
                                        "relu" if relu else "identity", rs)
    grads = torch.autograd.grad(ys, xs + [gl, bl] + (rs or []),
                                [dy[a:b] for a, b in zip(rows, rows[1:])])
    torch.cuda.synchronize()
    after = [(f.launches, getattr(f, "bwd_launches", 0)) for f in fns]
    delta = [(a[0] - b[0], a[1] - b[1]) for a, b in zip(after, before)]
    assert delta[:3] == [(shards, shards), (1, 1), (shards, shards)]
    assert all(d == (0, 0) for d in delta[3:])
    y_p, mean_p, var_p, rstd_p = bnk.bn_fwd_plain(
        x, gamma, beta, shift, 1e-5, res if tail else None, relu)
    dx_p, dg_p, db_p, dres_p = bnk.bn_bwd_plain(
        dy, x, gamma, mean_p, rstd_p, y_p if tail else None, relu, beta)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert _rel(torch.cat(ys), y_p) <= tol
    assert _rel(torch.cat(grads[:shards]), dx_p) <= tol
    for got, want in ((mean, mean_p), (var, var_p),
                      (grads[shards], dg_p), (grads[shards + 1], db_p)):
        assert _rel(got, want) <= 1e-5
    if tail:
        assert _rel(torch.cat(grads[shards + 2:]), dres_p) <= tol


def test_cross_shard_batchnorm_phases_match_plain_on_card(cuda_device):
    """Each cross-shard entry point against its plain version on the same
    inputs (the CPU path of the same wrapper, the inputs copied there):
    partials, finalize, apply, forward and backward, f32."""
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    x, res, dy, gamma, beta, shift = _bn_inputs(5000, 96, torch.float32,
                                                cuda_device, 10)
    cpu = lambda t: t.cpu()
    part = bnk.bn_xs_stats(x, shift, bnk.FWD)
    part_p = bnk.bn_xs_stats(cpu(x), cpu(shift), bnk.FWD)
    assert _rel(part.sum(0), part_p.sum(0).to(part.device)) <= 1e-5
    mean, var, rstd, coef = bnk.bn_xs_finalize(part, 5000, x.dtype,
                                               bnk.FWD_RES, gamma, beta,
                                               shift, 1e-5)
    got_p = bnk.bn_xs_finalize(cpu(part), 5000, x.dtype, bnk.FWD_RES,
                               cpu(gamma), cpu(beta), cpu(shift), 1e-5)
    for a, b in zip((mean, var, rstd, coef), got_p):
        assert _rel(a, b.to(a.device)) <= 1e-6
    y = bnk.bn_xs_apply(x, coef, bnk.FWD_RES, res2=res)
    y_p = bnk.bn_xs_apply(cpu(x), cpu(coef), bnk.FWD_RES, res2=cpu(res))
    assert _rel(y, y_p.to(y.device)) <= 1e-6
    bpart = bnk.bn_xs_stats(x, mean, bnk.BWD_RELU, dy2=dy, gamma=gamma,
                            rstd=rstd, beta=beta)
    bpart_p = bnk.bn_xs_stats(cpu(x), cpu(mean), bnk.BWD_RELU, dy2=cpu(dy),
                              gamma=cpu(gamma), rstd=cpu(rstd),
                              beta=cpu(beta))
    assert _rel(bpart.sum(0), bpart_p.sum(0).to(x.device)) <= 1e-5
    dg, db, bcoef = bnk.bn_xs_finalize(bpart, 5000, x.dtype, bnk.BWD_RELU,
                                       gamma)
    dx, _ = bnk.bn_xs_apply(x, bcoef, bnk.BWD_RELU, dy2=dy, gamma=gamma,
                            beta=beta, mean=mean, rstd=rstd)
    dx_p, _ = bnk.bn_xs_apply(cpu(x), cpu(bcoef), bnk.BWD_RELU,
                              dy2=cpu(dy), gamma=cpu(gamma), beta=cpu(beta),
                              mean=cpu(mean), rstd=cpu(rstd))
    assert _rel(dx, dx_p.to(dx.device)) <= 1e-5
    assert torch.isfinite(dg).all() and torch.isfinite(db).all()


def test_sync_dp_batch_norm_matches_solo_on_card(cuda_device):
    """A batch-norm MLP under sync DP at data 2 on one card (f32, TF32
    off) against a solo step: the parameters and running statistics
    within 1e-5 relative L2; the cross-shard phases launched, the
    single-shard kernel not."""
    import numpy as np
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (BatchNormalization,
                                                         DenseLayer,
                                                         OutputLayer)
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper, make_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    conf = (NeuralNetConfiguration.Builder().seed(2).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").activation("relu").list()
            .layer(DenseLayer(n_out=64)).layer(BatchNormalization())
            .layer(OutputLayer(n_out=4, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(16)).build())
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        solo = MultiLayerNetwork(conf, device=dev).init()
        dp = solo.clone()
        rng = np.random.default_rng(3)
        ds = DataSet(rng.normal(size=(64, 16)).astype(np.float32),
                     np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)])
        solo.fit([ds])
        n0 = (bnk.bn_xs_stats.launches, bnk.bn_train_fwd.launches)
        ParallelWrapper(dp, mesh=make_mesh(devices=[dev] * 2)).fit([ds])
        torch.cuda.synchronize()
        assert bnk.bn_xs_stats.launches - n0[0] == 2
        assert bnk.bn_train_fwd.launches == n0[1]
        a = torch.from_numpy(solo.params_flat()).double()
        b = torch.from_numpy(dp.params_flat()).double()
        assert ((a - b).norm() / a.norm()).item() <= 1e-5
        for k in ("mean", "var"):
            assert _rel(dp.state[1][k], solo.state[1][k]) <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@pytest.mark.parametrize("data", [1, 2])
def test_graph_dp_fused_tail_matches_solo_on_card(cuda_device, data):
    """resnet_tiny (2 BN → add → ReLU tails, 7 other batch norms) trained
    one step by GraphDataParallelTrainer on one card (f32, TF32 off)
    against a solo step: parameters and running statistics within 1e-5
    relative L2. At data 2 every batch norm and both tails take the
    cross-shard phases and the single-shard kernels launch no time; at
    data 1 the step takes the single-shard kernels, as the solo step
    does."""
    import numpy as np
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    from deeplearning4j_tpu_torch.models import resnet_tiny_conf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (GraphDataParallelTrainer,
                                                   make_mesh)
    dev = torch.device("cuda", torch.cuda.current_device())
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        solo = ComputationGraph(resnet_tiny_conf(
            num_classes=4, height=16, width=16, channels=3),
            device=dev).init()
        dp = solo.clone()
        assert len(solo._get_fusion_plan()[0]) == 2
        rng = np.random.default_rng(5)
        ds = DataSet(rng.normal(size=(16, 16, 16, 3)).astype(np.float32),
                     np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)])
        solo.fit_batch(ds)
        counters = (bnk.bn_train_fwd, bnk.bn_add_act_fwd, bnk.bn_xs_stats)
        before = [f.launches for f in counters]
        GraphDataParallelTrainer(
            dp, mesh=make_mesh(devices=[dev] * data)).fit_batch(ds)
        torch.cuda.synchronize()
        got = [f.launches - b for f, b in zip(counters, before)]
        assert got == ([7, 2, 0] if data == 1 else [0, 0, 9 * 2])
        for v in solo.params:
            for k in solo.params[v]:
                assert _rel(dp.params[v][k], solo.params[v][k]) <= 1e-5, \
                    (v, k)
            for k in solo.state[v]:
                assert _rel(dp.state[v][k], solo.state[v][k]) <= 1e-5, \
                    (v, k)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# ------------------------------------------------- the ring over B3 - B5
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp,t", [(2, 256), (4, 512), (3, 387)])
def test_ring_matches_plain_ring_on_card(cuda_device, sp, t, causal,
                                         dtype):
    """The flash-kernel ring (``_RingFlash``) over sp chunks of q / k / v
    [2, T, 4, 64] against the plain streaming ring run in f32 on the same
    inputs: o max-abs within the forward kernels' tolerance, dq / dk / dv
    within 2e-2 relative L2 (1e-4 in f32); B3, B4 and B5 each launched
    sp(sp+1)/2 times causal, sp² times unmasked."""
    from deeplearning4j_tpu_torch.parallel.sequence import ring_attend
    g = torch.Generator(device=cuda_device).manual_seed(sp + t)
    full = [torch.randn(2, t, 4, 64, generator=g, device=cuda_device)
            .to(dtype) for _ in range(4)]
    chunks = [list(x.chunk(sp, dim=1)) for x in full]

    def run(impl, cast):
        leaves = [c.to(cast).detach().requires_grad_(True)
                  for c in chunks[0] + chunks[1] + chunks[2]]
        outs = ring_attend(leaves[:sp], leaves[sp:2 * sp], leaves[2 * sp:],
                           causal, impl)
        grads = torch.autograd.grad(outs, leaves,
                                    [c.to(cast) for c in chunks[3]])
        return torch.cat(outs, 1), [torch.cat(grads[i * sp:(i + 1) * sp], 1)
                                    for i in range(3)]
    fns = (ff.flash_forward, fb.flash_backward_dq, fb.flash_backward_dkv)
    before = [f.launches for f in fns]
    o, grads = run(None, dtype)
    torch.cuda.synchronize()
    pairs = sp * (sp + 1) // 2 if causal else sp * sp
    assert [f.launches - b for f, b in zip(fns, before)] == [pairs] * 3
    o_p, grads_p = run("jnp", torch.float32)
    assert (o.float() - o_p).abs().max().item() <= FWD_TOL[dtype]
    gtol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in zip(grads, grads_p):
        assert _rel(got, want) <= gtol


def test_sequence_parallel_lm_step_matches_solo_on_card(cuda_device):
    """A 2-layer LM (vocab 512, d 128, 2 heads of 64, T 256, B 2, f32,
    TF32 off) trained one step by GraphSequenceParallelTrainer at sp 2 on
    one card against a solo step: the loss within rel 1e-5, the
    parameters within rel-L2 1e-4; the ring's pairs on B3 / B4 / B5 (3 a
    layer each), no B1 / B2."""
    import numpy as np
    from deeplearning4j_tpu_torch.models import (lm_batch_sparse,
                                                 transformer_lm_conf)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        GraphSequenceParallelTrainer, make_mesh)
    dev = torch.device("cuda", torch.cuda.current_device())
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        solo = ComputationGraph(transformer_lm_conf(
            512, d_model=128, num_heads=2, num_layers=2, max_length=256,
            learning_rate=3e-4), device=dev).init()
        sp = solo.clone()
        x, y = lm_batch_sparse(np.random.default_rng(4).integers(
            0, 512, (2, 257)))
        solo.fit_batch(DataSet(x, y))
        fns = (ff.flash_forward, fb.flash_backward_dq,
               fb.flash_backward_dkv, ss.short_attention_fwd,
               ss.short_attention_bwd)
        before = [f.launches for f in fns]
        with GraphSequenceParallelTrainer(sp, mesh=make_mesh(
                axis_names=("sp",), devices=[dev] * 2)) as tr:
            tr.fit_batch(DataSet(x, y))
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(fns, before)] == \
            [6, 6, 6, 0, 0]
        want, got = float(solo.score_value), float(sp.score_value)
        assert abs(got - want) <= 1e-5 * abs(want)
        a = torch.from_numpy(solo.params_flat()).double()
        b = torch.from_numpy(sp.params_flat()).double()
        assert ((a - b).norm() / a.norm()).item() <= 1e-4
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


# ------------------------------------------------------ a Keras import
def test_keras_import_fuses_its_bn_add_relu_tail_on_card(cuda_device,
                                                         tmp_path):
    """A Keras functional net written by the port's HDF5 writer (conv →
    BatchNormalization → Add(bn, input) → Activation(relu) → pooling →
    softmax Dense, trained with SGD) imported on the card: its tail is in
    the fusion plan, a training step launches the fused tail kernel once
    a direction and no plain BN kernel, and its output and one step's
    parameters and running statistics match the same file imported on
    the CPU (f32, TF32 off, 1e-5 relative L2)."""
    import numpy as np
    from deeplearning4j_tpu_torch.kernels import batchnorm as bnk
    from deeplearning4j_tpu_torch.keras import KerasModelImport
    from deeplearning4j_tpu_torch.keras.export import write_keras_h5
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    c = 8
    rng = np.random.default_rng(7)

    def layer(cls, name, config, inputs):
        return {"class_name": cls, "name": name,
                "config": dict(config, name=name),
                "inbound_nodes": [[[i, 0, 0, {}] for i in inputs]]
                if inputs else []}
    config = {"class_name": "Model", "config": {
        "name": "tail",
        "layers": [
            layer("InputLayer", "inp",
                  {"batch_input_shape": [None, 8, 8, c]}, []),
            layer("Conv2D", "conv", {"filters": c, "kernel_size": [3, 3],
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
    path = tmp_path / "tail.h5"
    write_keras_h5(path, config, {
        "conv": [("kernel:0", rng.normal(0, 0.3, (3, 3, c, c)))],
        "bn": [("gamma:0", rng.uniform(0.5, 1.5, c)),
               ("beta:0", rng.normal(0, 0.1, c)),
               ("moving_mean:0", rng.normal(0, 0.1, c)),
               ("moving_variance:0", rng.uniform(0.5, 1.5, c))],
        "out": [("kernel:0", rng.normal(0, 0.3, (c, 3))),
                ("bias:0", np.zeros(3))]},
        {"loss": "categorical_crossentropy",
         "optimizer_config": {"class_name": "SGD", "config": {"lr": 0.1}}})
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = KerasModelImport.import_keras_model_and_weights(
            path, device=cuda_device)
        cpu = KerasModelImport.import_keras_model_and_weights(path,
                                                              device="cpu")
        assert card.device.type == "cuda"
        assert list(card._get_fusion_plan()[0]) == ["relu"]
        x = rng.normal(size=(16, 8, 8, c)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
        assert _rel(torch.from_numpy(card.output(x)[0]),
                    torch.from_numpy(cpu.output(x)[0])) <= 1e-5
        counters = (bnk.bn_add_act_fwd, bnk.bn_add_act_bwd,
                    bnk.bn_train_fwd, bnk.bn_train_bwd)
        before = [f.launches for f in counters]
        card.fit_batch(DataSet(x, y))
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == \
            [1, 1, 0, 0]
        cpu.fit_batch(DataSet(x, y))
        for v in cpu.params:
            for k in cpu.params[v]:
                assert _rel(card.params[v][k].cpu(), cpu.params[v][k]) <= \
                    1e-5, (v, k)
        for k in ("mean", "var"):
            assert _rel(card.state["bn"][k].cpu(), cpu.state["bn"][k]) <= \
                1e-5, k
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# ------------------------------------------------ word vectors into B6
W2V_SENTENCES = ["the quick brown fox jumps over the lazy dog",
                 "the lazy dog sleeps in the warm sun",
                 "a quick red fox runs past the brown dog",
                 "cats chase the quick mice in the barn",
                 "the warm sun shines over the green field"] * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_word2vec_sequences_launch_b6_and_match_plain(cuda_device, dtype):
    """Word vectors trained on the card, turned into masked [N, T, F]
    sequences by Word2VecDataSetIterator (ragged sentences, so the mask
    has holes at the tails), feed a GravesLSTM: its forward launches B6
    once and matches lstm_recurrence_plain on the same inputs, and a fit
    step launches it once more."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp import (Word2Vec,
                                              Word2VecDataSetIterator)
    from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (GravesLSTM,
                                                         RnnOutputLayer)
    w2v = (Word2Vec.Builder().layer_size(16).window_size(3).epochs(4)
           .min_word_frequency(1).seed(11).iterate(W2V_SENTENCES)
           .device(cuda_device).build())
    w2v.fit()
    assert w2v.lookup.syn0.device.type == "cuda"
    labelled = [(s, ("animal", "nature")[i % 2])
                for i, s in enumerate(W2V_SENTENCES[:5] + [
                    "the dog", "sun over the field", "fox"])]
    ds = next(iter(Word2VecDataSetIterator(w2v, labelled,
                                           ["animal", "nature"], 8)))
    assert ds.features_mask.min() == 0.0        # ragged: a masked tail
    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.01)
            .updater("adam").list()
            .layer(GravesLSTM(n_out=32, activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(16)).build())
    net = MultiLayerNetwork(conf, compute_dtype=dtype,
                            device=cuda_device).init()
    layer, params = net.layers[0], net._cast_params(net.params)[0]
    x = torch.from_numpy(ds.features).to(cuda_device, dtype)
    mask = torch.from_numpy(ds.features_mask).to(cuda_device)
    before = lk.lstm_recurrence_fwd.launches
    y, st = layer.forward(params, {}, x, mask)
    torch.cuda.synchronize()
    assert lk.lstm_recurrence_fwd.launches == before + 1
    n, t, _ = x.shape
    xw_t = ((x.reshape(n * t, -1) @ params["W"]).reshape(n, t, 128) +
            params["b"]).transpose(0, 1)
    zeros = torch.zeros((n, 32), dtype=dtype, device=cuda_device)
    want = lk.lstm_recurrence_plain(
        xw_t, params["R"], zeros, zeros,
        tuple(params[k] for k in ("pi", "pf", "po")), mask.to(dtype).T,
        torch.sigmoid, torch.tanh)
    for a, b in zip((y.transpose(0, 1), st["h"], st["c"]), want):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= LSTM_TOL[dtype]
    net.fit(ds)
    assert lk.lstm_recurrence_fwd.launches == before + 2
    assert np.isfinite(float(net.score_value))


@pytest.mark.parametrize("rows", [300, 40000], ids=["onehot", "scatter"])
def test_segment_update_is_bitwise_reproducible_on_card(cuda_device, rows):
    """The embedding tables' segment update on the card sums a Zipf-hot
    index set (a few rows take most of the updates) in a fixed order:
    bitwise equal over two calls, and equal to the CPU's within f32
    order; a seeded Word2Vec scan with negatives drawn on the card gives
    the same syn0 twice."""
    from deeplearning4j_tpu_torch.kernels import segment_update as sgk
    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp.skipgram import (_segment_update,
                                                       segment_route)
    g = torch.Generator().manual_seed(rows)
    b, d = 8192, 100
    idx = torch.minimum((torch.rand(b, generator=g) ** 4 * rows).long(),
                        torch.tensor(rows - 1))
    upd = torch.randn(b, d, generator=g)
    w = (torch.rand(b, generator=g) > 0.1).float()
    table = torch.randn(rows, d, generator=g) * 0.1
    assert segment_route(rows, b) == ("onehot" if rows == 300
                                      else "scatter")
    before = sgk.segment_update.launches
    runs = [_segment_update(table.to(cuda_device), idx.to(cuda_device),
                            upd.to(cuda_device), w.to(cuda_device), 0.025)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert sgk.segment_update.launches == before + 2
    cpu = _segment_update(table.clone(), idx, upd, w, 0.025)
    delta = runs[0].cpu() - table
    assert _rel(delta, cpu - table) <= 1e-5
    corpus = [f"tok{i % 50} tok{(i * 7) % 50} tok{(i * 3) % 50}".split()
              for i in range(300)]
    syn0 = [(Word2Vec.Builder().layer_size(16).window_size(2)
             .negative_sample(5).epochs(1).seed(5).scan_min_tokens(0)
             .device(cuda_device).build().fit(corpus).lookup.syn0)
            for _ in range(2)]
    assert torch.equal(syn0[0], syn0[1])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,rows,d", [(1, 1, 1), (31, 7, 33), (33, 7, 257),
                                      (5000, 3, 8), (38760, 37165, 100),
                                      (4096, 50, 300)])
def test_segment_update_kernel_matches_plain_on_card(cuda_device, n, rows,
                                                     d, bf16):
    """The segment-update kernel against its plain version (index_add_
    into a dense buffer, then the update): one row, runs across the
    32-position tiles, more than 255 columns (a second column block), a
    few rows taking thousands of entries, rows named by no index left
    as they were, each value rounded to bf16 or not; bitwise equal over
    two calls, one launch a call; a row named once changes exactly as
    the plain version changes it."""
    from deeplearning4j_tpu_torch.kernels import segment_update as sgk
    g = torch.Generator().manual_seed(n + rows + d)
    idx = torch.minimum((torch.rand(n, generator=g) ** 3 * rows).long(),
                        torch.tensor(rows - 1)).to(cuda_device)
    upd = torch.randn(n, d, generator=g).to(cuda_device)
    w = (torch.rand(n, generator=g) > 0.2).float().to(cuda_device)
    table = (torch.randn(rows, d, generator=g) * 0.1).to(cuda_device)
    before = sgk.segment_update.launches
    got = sgk.segment_update(table.clone(), idx, upd, w, 0.05, bf16)
    again = sgk.segment_update(table.clone(), idx, upd, w, 0.05, bf16)
    torch.cuda.synchronize()
    assert sgk.segment_update.launches == before + 2
    assert torch.equal(got, again)
    want = sgk.segment_update_plain(table.cpu(), idx.cpu(), upd.cpu(),
                                    w.cpu(), 0.05, bf16)
    delta = want - table.cpu()
    assert (got.cpu() - want).abs().max().item() <= \
        1e-5 * max(delta.abs().max().item(), 1e-6)
    counts = torch.bincount(idx.cpu(), minlength=rows)
    assert torch.equal(got.cpu()[counts == 0], table.cpu()[counts == 0])
    assert torch.equal(got.cpu()[counts == 1], want[counts == 1])
    with pytest.raises(ValueError, match="f32"):
        sgk.segment_update(table.double(), idx, upd, w, 0.05, bf16)


@pytest.mark.parametrize("n,k", [(300, 9), (10000, 90)])
def test_segment_update_as_tsne_segment_sum_on_card(cuda_device, n, k):
    """Barnes-Hut t-SNE's attractive sum: the segment update at width 2 on
    a zero table with zero weights and lr 1 is the segment sum of the
    2·N·k edge forces (each row named k times as a source and by its
    in-neighbours), bitwise over two calls, against its plain version."""
    from deeplearning4j_tpu_torch.kernels import segment_update as sgk
    g = torch.Generator().manual_seed(n)
    rows = torch.arange(n).repeat_interleave(k)
    cols = torch.randint(0, n, (n * k,), generator=g)
    src = torch.cat([rows, cols]).to(cuda_device)
    vals = torch.randn(2 * n * k, 2, generator=g).to(cuda_device) * 1e-3
    zero = torch.zeros(2 * n * k, device=cuda_device)
    before = sgk.segment_update.launches
    got, again = (sgk.segment_update(torch.zeros(n, 2, device=cuda_device),
                                     src, vals, zero, 1.0, False)
                  for _ in range(2))
    assert sgk.segment_update.launches == before + 2
    assert torch.equal(got, again)
    want = torch.zeros(n, 2, dtype=torch.float64).index_add_(
        0, src.cpu(), vals.cpu().double())
    assert (got.cpu().double() - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()


def test_bhtsne_and_kmeans_are_seeded_on_card(cuda_device):
    """N 10,000 takes the negative-sampling route: two seeded runs give
    bitwise-equal embeddings, with one segment-update launch an
    iteration; k-means' seeded fits are bitwise equal too and agree with
    the CPU's assignments."""
    import numpy as np
    from deeplearning4j_tpu_torch.clustering import (BarnesHutTsne,
                                                     KMeansClustering)
    from deeplearning4j_tpu_torch.kernels import segment_update as sgk
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 3, (20, 16)).astype(np.float32)
    X = centers[rng.integers(0, 20, 10000)] + \
        rng.normal(0, 1, (10000, 16)).astype(np.float32)
    before = sgk.segment_update.launches
    Y = [BarnesHutTsne(n_iter=30, device=cuda_device).calculate(X)
         for _ in range(2)]
    assert sgk.segment_update.launches == before + 60
    np.testing.assert_array_equal(Y[0], Y[1])
    assert Y[0].shape == (10000, 2) and np.isfinite(Y[0]).all()
    fits = [KMeansClustering(20, max_iterations=30, seed=3,
                             device=d).apply_to(X)
            for d in (cuda_device, cuda_device, "cpu")]
    np.testing.assert_array_equal(fits[0][0], fits[1][0])
    np.testing.assert_array_equal(fits[0][1], fits[1][1])
    assert np.mean(fits[0][0] == fits[2][0]) >= 0.999


def test_dl4j_classifier_on_card(cuda_device):
    """The scikit-learn estimator trains on the card by default; clone
    keeps device=None."""
    import numpy as np
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from deeplearning4j_tpu_torch.cluster import DL4JClassifier
    rng = np.random.default_rng(1)
    X = np.concatenate([rng.normal((-2, 0), 0.6, (60, 2)),
                        rng.normal((2, 1), 0.6, (60, 2))]).astype(np.float32)
    y = np.array(["a"] * 60 + ["b"] * 60)
    clf = DL4JClassifier(hidden=8, epochs=8, seed=1).fit(X, y)
    assert clf.net_.device.type == "cuda"
    assert (clf.predict(X) == y).mean() > 0.95
    assert clone(clf).get_params()["device"] is None


def test_compile_audit_counts_one_build_and_one_load(cuda_device,
                                                     tmp_path):
    """A fresh process builds the segment-update library into an empty
    build directory under CompileAudit: one build and one load, under
    ``_lib_path``'s source hash; a second ``load`` in the same process
    builds and loads nothing, and the process never built or loaded a
    library twice under one hash."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    script = f"""
import json
from pathlib import Path
from deeplearning4j_tpu_torch.analysis import CompileAudit
from deeplearning4j_tpu_torch.kernels import cuda_lib
cuda_lib.BUILD_DIR = Path({str(tmp_path)!r})
with CompileAudit() as first:
    cuda_lib.load("segment_update")
with CompileAudit() as second:
    cuda_lib.load("segment_update")
whole = CompileAudit.process()
print(json.dumps({{
    "first": [first.builds("segment_update"),
              first.loads("segment_update")],
    "second": [second.builds("segment_update"),
               second.loads("segment_update"), second.total_compiles],
    "signatures": sorted(first.signatures["segment_update"]),
    "digest": cuda_lib._lib_path("segment_update").stem.rsplit("-", 1)[1],
    "duplicates": whole.duplicate_signature_compiles,
    "nvcc_runs": cuda_lib.nvcc_runs()}}))
"""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=str(root), env=env, timeout=600)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["first"] == [1, 1]
    assert got["second"] == [0, 0, 0]
    assert got["signatures"] == [f"build@{got['digest']}",
                                 f"load@{got['digest']}"]
    assert got["duplicates"] == 0 and got["nvcc_runs"] == 1


# ------------------------------------- the feed: pinned staging to the card
def test_staged_batch_is_bit_identical_to_a_cast_on_the_card(cuda_device):
    """A [64, 224, 224, 3] f32 noise batch, with ties, subnormals, ±inf,
    ±0 and NaN written into its first elements, staged to bf16 equals a
    pageable copy cast on the card bit for bit (NaN stays NaN)."""
    import numpy as np
    from deeplearning4j_tpu_torch.ops.transfer import stage_to_device
    x = np.random.default_rng(11).normal(size=(64, 224, 224, 3)) \
        .astype(np.float32)
    special = np.concatenate([
        np.array([0x3F808000, 0x3F818000, 0x00008000, 0x00018000,
                  0x7F7F8000, 0x007FFFFF, 0x80000001], np.uint32)
        .view(np.float32),
        np.array([1e-40, -1e-40, np.inf, -np.inf, 0.0, -0.0, np.nan],
                 np.float32)])
    x.reshape(-1)[:special.size] = special
    got = stage_to_device(x, cuda_device, torch.bfloat16)
    want = torch.from_numpy(x).to(cuda_device).to(torch.bfloat16)
    assert got.is_cuda and got.dtype == torch.bfloat16
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan) and int(nan.sum()) == 1
    assert torch.equal(got.view(torch.int16)[~nan],
                       want.view(torch.int16)[~nan])


def _twin_cnns(device):
    """Two resnet_tiny graphs in bf16 on ``device`` with the same masters
    and running statistics (and fresh updater states), and a batch of
    int32 ids."""
    import numpy as np
    from deeplearning4j_tpu_torch.models import resnet_tiny_conf
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    nets = [ComputationGraph(resnet_tiny_conf(num_classes=4, height=16,
                                              width=16, channels=3),
                             device=device,
                             compute_dtype=torch.bfloat16).init()
            for _ in range(2)]
    with torch.no_grad():
        for tree in ("params", "state"):
            src = getattr(nets[0], tree)
            for v, leaves in getattr(nets[1], tree).items():
                for k, a in leaves.items():
                    if torch.is_tensor(a):
                        a.copy_(src[v][k])
    rng = np.random.default_rng(12)
    x = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 4, 8).astype(np.int32)
    return nets, x, y


@pytest.fixture
def deterministic_cudnn():
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        flags


def _same_nets(a, b):
    return all(torch.equal(a.params[v][k], b.params[v][k])
               for v in a.params for k in a.params[v])


def test_staged_fit_batch_matches_the_unstaged_conversion(
        cuda_device, deterministic_cudnn):
    """Three fit_batch steps of a small CNN on staged batches give losses
    and masters bit-identical to the same steps on batches converted the
    unstaged way (a pageable copy, then the cast or widening on the card);
    each staged step counts one staged features and one staged labels
    transfer and no direct one."""
    import numpy as np
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    from deeplearning4j_tpu_torch.ops.transfer import stage_counts
    (staged, plain), x, y = _twin_cnns(cuda_device)

    def unstaged(a):
        t = torch.as_tensor(np.asarray(a)).to(cuda_device)
        return t.to(torch.bfloat16) if t.is_floating_point() else t.long()

    plain._to_device_dtype = unstaged
    for step in range(3):
        xs, ys = x + step, (y + step) % 4
        before = stage_counts()
        staged.fit_batch(DataSet(xs, ys))
        after = stage_counts()
        assert after["staged"] - before["staged"] == 2
        assert after["direct"] == before["direct"]
        assert after["staged_bytes"] - before["staged_bytes"] == \
            xs.size * 2 + ys.size * 4
        plain.fit_batch(DataSet(xs, ys))
        assert float(staged.score_value) == float(plain.score_value), step
    assert _same_nets(staged, plain)


def test_overwriting_the_source_after_fit_batch_changes_nothing(
        cuda_device, deterministic_cudnn):
    """The host batch may be overwritten as soon as fit_batch returns,
    before the device has run the step: the step consumed the batch as it
    was (the stage's cast read it before the call returned)."""
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    (a, b), x, y = _twin_cnns(cuda_device)
    src, keep = x.copy(), x.copy()
    a.fit_batch(DataSet(src, y))
    src[...] = 1e3                      # the device may still be busy
    b.fit_batch(DataSet(keep, y))
    assert float(a.score_value) == float(b.score_value)
    assert _same_nets(a, b)


def test_repeated_stages_reuse_the_pinned_block(cuda_device):
    """After the second staged transfer of a batch shape the caching host
    allocator allocates no more pinned memory: each later stage reuses
    the block the previous one's completed copy released."""
    import numpy as np
    from deeplearning4j_tpu_torch.ops.transfer import stage_to_device
    x = np.random.default_rng(13).normal(size=(64, 224, 224, 3)) \
        .astype(np.float32)
    seen = []
    for _ in range(5):
        stage_to_device(x, cuda_device, torch.bfloat16)
        torch.cuda.synchronize()
        s = torch.cuda.host_memory_stats()
        seen.append((s["allocations.allocated"],
                     s["allocated_bytes.allocated"]))
    assert seen[1:] == [seen[1]] * 4, seen
