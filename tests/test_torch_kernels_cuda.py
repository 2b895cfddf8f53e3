"""PyTorch port, on the card: each hand-written attention kernel, forward
and backward, against its plain PyTorch version at small shapes (every
supported dtype, head dims 8-128, T at every tile edge, a key mask with
holes, a fully masked row), the two forwards against each other, the
backward kernels' bitwise determinism over two calls, the shapes the
wrappers refuse, and gradients through an attention layer on the card;
the LSTM recurrence kernel (B6) against its plain version on both of its
routes (f32 / bf16, peepholes, masks, strided xw, T 1-128, N 1-200, H
16-1024), the route its plan picks, its refusals and its gradients. Every
test here needs a CUDA card and skips without one. The module imports no
JAX, so it runs where JAX is not installed:
``python -m pytest tests/test_torch_kernels_cuda.py --noconftest``.

Fully masked rows are checked for finiteness only: the kernels average
such a row over the key tiles they visit, the plain version over every
key."""

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
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lk.lstm_recurrence_fwd(xw.half(), r.half(), h0.half(), c0.half())
    with pytest.raises(ValueError, match="R must be"):
        lk.lstm_recurrence_fwd(xw, r[:, :32].contiguous(), h0, c0)
    with pytest.raises(ValueError, match="h0 must be"):
        lk.lstm_recurrence_fwd(xw, r, h0.bfloat16(), c0)
    with pytest.raises(ValueError, match="unit stride"):
        strided = torch.zeros(3 * 2 * 128, device=cuda_device).as_strided(
            (3, 2, 64), (256, 128, 2))
        lk.lstm_recurrence_fwd(strided, r, h0, c0)
    # a hidden width whose f32 R slices fit no co-resident grid: at most
    # ~227 KB of shared memory per SM holds H * 4H / 132 f32 weights
    big = 2048
    with pytest.raises(ValueError, match="no co-resident"):
        lk.lstm_recurrence_fwd(
            torch.zeros(1, 1, 4 * big, device=cuda_device),
            torch.zeros(big, 4 * big, device=cuda_device),
            torch.zeros(1, big, device=cuda_device),
            torch.zeros(1, big, device=cuda_device))


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
    """A bf16 width neither route takes (R slices of H 2048 fit neither a
    cluster's nor a co-resident grid's shared memory) raises from the plan
    and from the wrapper, which launches nothing."""
    big = 2048
    with pytest.raises(ValueError, match="no LSTM launch plan"):
        lk.lstm_plan(1, big, torch.bfloat16)
    before = lk.lstm_recurrence_fwd.launches
    z = lambda *shape: torch.zeros(*shape, device=cuda_device,
                                   dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no co-resident"):
        lk.lstm_recurrence_fwd(z(1, 1, 4 * big), z(big, 4 * big),
                               z(1, big), z(1, big))
    assert lk.lstm_recurrence_fwd.launches == before


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
