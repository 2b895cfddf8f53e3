"""PyTorch port, recurrent layers on the CPU: the LSTM recurrence's plain
version against the JAX package's Pallas kernel (interpret mode) and its
``_lstm_recurrence`` with masks, ``LSTMRecurrence``'s gradients against
``jax.vjp`` of ``_fused``, GravesLSTM / LSTM / GravesBidirectionalLSTM
forwards with their state, the helper routing on a card (every gate /
cell pair, row-wise ones included, goes through the kernel's wrapper: no
plain loop hides there), and the activation registry —
each on the same seeded inputs in both packages.

Tolerances: f32 parity at 1e-5 relative (ROADMAP rule 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.kernels.lstm import _fused, _pallas_forward
from deeplearning4j_tpu.nn.conf.layers import (
    GravesBidirectionalLSTM as JaxBiLSTM, GravesLSTM as JaxGravesLSTM,
    LSTM as JaxLSTM)
from deeplearning4j_tpu.nn.conf.layers.recurrent import _lstm_recurrence
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu_torch.kernels import lstm as lk
from deeplearning4j_tpu_torch.nn import helpers
from deeplearning4j_tpu_torch.nn.conf.layers import (
    GravesBidirectionalLSTM, GravesLSTM, LSTM)
from deeplearning4j_tpu_torch.nn.conf.layers import recurrent as trecurrent
from deeplearning4j_tpu_torch.ops import activations as tact

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(t, n, h, peephole, masked, seed=0):
    """f32 numpy inputs of the recurrence: xw_t, R, h0, c0, peep, mask_t."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    peep = (f(h) * 0.3, f(h) * 0.3, f(h) * 0.3) if peephole else None
    mask = (rng.random((t, n)) > 0.3).astype(np.float32) if masked else None
    r = f(h, 4 * h) / np.float32(np.sqrt(h))
    return f(t, n, 4 * h), r, f(n, h) * 0.5, f(n, h) * 0.5, peep, mask


def _torch_args(case):
    xw, r, h0, c0, peep, mask = case
    return (_t(xw), _t(r), _t(h0), _t(c0),
            None if peep is None else tuple(_t(p) for p in peep),
            None if mask is None else _t(mask))


# ----------------------------------------------------- the recurrence (B6)
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("peephole", [False, True])
def test_plain_recurrence_matches_pallas_kernel(t, n, peephole):
    """B6's plain version against the TPU kernel itself (``_pallas_forward``
    in interpret mode, as tests/test_regression_helpers.py runs it)."""
    case = _case(t, n, 8, peephole, False, seed=t * 10 + n)
    xw, r, h0, c0, peep, _ = case
    want = _pallas_forward(jnp.asarray(xw), jnp.asarray(r), jnp.asarray(h0),
                           jnp.asarray(c0),
                           None if peep is None else
                           tuple(jnp.asarray(p) for p in peep))
    got = lk.lstm_recurrence_plain(*_torch_args(case))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("peephole", [False, True])
def test_plain_recurrence_matches_jax_with_mask(t, n, peephole):
    """Masked steps freeze h and c, as in the JAX ``_lstm_recurrence``."""
    case = _case(t, n, 8, peephole, True, seed=t * 10 + n + 1)
    xw, r, h0, c0, peep, mask = case
    want = _lstm_recurrence(
        jnp.asarray(xw), jnp.asarray(r),
        None if peep is None else tuple(jnp.asarray(p) for p in peep),
        jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(mask)[..., None],
        jax.nn.sigmoid, jnp.tanh)
    got = lk.lstm_recurrence_plain(*_torch_args(case))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_plain_recurrence_other_activation_pair():
    """The CPU loop takes any gate / cell pair (the kernel does not)."""
    case = _case(5, 2, 8, True, True, seed=3)
    xw, r, h0, c0, peep, mask = case
    want = _lstm_recurrence(
        jnp.asarray(xw), jnp.asarray(r), tuple(jnp.asarray(p) for p in peep),
        jnp.asarray(h0), jnp.asarray(c0), jnp.asarray(mask)[..., None],
        jact.hardsigmoid, jact.softsign)
    got = lk.lstm_recurrence_plain(*_torch_args(case), tact.hardsigmoid,
                                   tact.softsign)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("peephole", [False, True])
def test_lstm_recurrence_function_gradients_match_jax_vjp(peephole):
    """LSTMRecurrence (forward through the wrapper, backward by recomputing
    the plain recurrence) against ``jax.vjp`` of the JAX kernel's
    ``_fused`` custom VJP, for every input."""
    case = _case(6, 3, 8, peephole, False, seed=7)
    xw, r, h0, c0, peep, _ = case
    rng = np.random.default_rng(8)
    dy = rng.normal(size=(6, 3, 8)).astype(np.float32)
    dh = rng.normal(size=(3, 8)).astype(np.float32)
    dc = rng.normal(size=(3, 8)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (xw, r, h0, c0)] + \
        ([jnp.asarray(p) for p in peep] if peephole else [None] * 3)
    _, vjp = jax.vjp(lambda *a: _fused(*a), *jargs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh), jnp.asarray(dc)))
    leaves = [_t(a).requires_grad_(True) for a in (xw, r, h0, c0)] + \
        ([_t(p).requires_grad_(True) for p in peep] if peephole else
         [None] * 3)
    outs = lk.LSTMRecurrence.apply(*leaves, None)
    diff = [x for x in leaves if x is not None]
    got = torch.autograd.grad(outs, diff, (_t(dy), _t(dh), _t(dc)))
    for g, w in zip(got, [w for w in want if w is not None]):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_lstm_recurrence_function_gradients_with_mask():
    """With a mask, the Function's gradients are autograd's through the
    masked plain loop (checked against jax.vjp of ``_lstm_recurrence``)."""
    case = _case(6, 3, 8, True, True, seed=9)
    xw, r, h0, c0, peep, mask = case
    dy = np.random.default_rng(10).normal(size=(6, 3, 8)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (xw, r, h0, c0, *peep)]

    def ref(xw_, r_, h0_, c0_, pi, pf, po):
        y, _, _ = _lstm_recurrence(xw_, r_, (pi, pf, po), h0_, c0_,
                                   jnp.asarray(mask)[..., None],
                                   jax.nn.sigmoid, jnp.tanh)
        return y
    _, vjp = jax.vjp(ref, *jargs)
    want = vjp(jnp.asarray(dy))
    leaves = [_t(a).requires_grad_(True) for a in (xw, r, h0, c0, *peep)]
    y, _, _ = lk.LSTMRecurrence.apply(*leaves, _t(mask))
    got = torch.autograd.grad(y, leaves, _t(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("acts", [("hardsigmoid", "softsign"),
                                  ("relu", "identity")])
def test_lstm_recurrence_function_gradients_with_other_activations(acts):
    """LSTMRecurrence with a layer's own activation pair (the pair now
    reaches its backward, which recomputes the plain loop with it) against
    jax.vjp of ``_lstm_recurrence`` with the same pair, masked, for every
    input."""
    case = _case(6, 3, 8, True, True, seed=12)
    xw, r, h0, c0, peep, mask = case
    xw, r = xw * np.float32(0.3), r * np.float32(0.3)
    dy = np.random.default_rng(13).normal(size=(6, 3, 8)).astype(np.float32)
    jfn = [jact.get_activation(a) for a in acts]

    def ref(xw_, r_, h0_, c0_, pi, pf, po):
        y, _, _ = _lstm_recurrence(xw_, r_, (pi, pf, po), h0_, c0_,
                                   jnp.asarray(mask)[..., None], *jfn)
        return y
    _, vjp = jax.vjp(ref, *[jnp.asarray(a) for a in (xw, r, h0, c0, *peep)])
    want = vjp(jnp.asarray(dy))
    leaves = [_t(a).requires_grad_(True) for a in (xw, r, h0, c0, *peep)]
    y, _, _ = lk.LSTMRecurrence.apply(*leaves, _t(mask), *acts)
    got = torch.autograd.grad(y, leaves, _t(dy))
    for g, w in zip(got, want):
        assert np.abs(_np(g)).max() > 0
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


def test_lstm_act_codes_cover_every_elementwise_activation():
    """Every activation of ops/activations.py has a kernel code, the two
    row-wise ones (softmax, logsoftmax) the last two."""
    for name in tact.activation_names():
        assert 0 <= lk.act_code(name) < 21
    assert [lk.act_code(n) for n in lk.ROW_WISE] == [19, 20]
    with pytest.raises(ValueError, match="Unknown activation"):
        lk.act_code("nonesuch")


def test_recurrence_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors neither the wrapper nor the layer launches (or
    counts) a kernel."""
    before = lk.lstm_recurrence_fwd.launches
    args = _torch_args(_case(3, 2, 8, True, True))
    for a, b in zip(lk.lstm_recurrence_fwd(*args),
                    lk.lstm_recurrence_plain(*args)):
        assert torch.equal(a, b)
    assert lk.lstm_recurrence_fwd.launches == before


# ------------------------------------------------------------------ layers
def _jax_layer_params(jlayer, seed):
    p = jlayer.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # nonzero peepholes / biases, so every term of the gate math counts
    return {k: np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(
        np.float32) for k, v in p.items()}


LAYERS = {
    "graves": (lambda: JaxGravesLSTM(n_in=5, n_out=6, activation="tanh"),
               lambda: GravesLSTM(n_in=5, n_out=6, activation="tanh")),
    "lstm": (lambda: JaxLSTM(n_in=5, n_out=6, activation="tanh"),
             lambda: LSTM(n_in=5, n_out=6, activation="tanh")),
    "bi_add": (lambda: JaxBiLSTM(n_in=5, n_out=6, activation="tanh"),
               lambda: GravesBidirectionalLSTM(n_in=5, n_out=6,
                                               activation="tanh")),
    "bi_concat": (lambda: JaxBiLSTM(n_in=5, n_out=6, activation="tanh",
                                    mode="concat"),
                  lambda: GravesBidirectionalLSTM(n_in=5, n_out=6,
                                                  activation="tanh",
                                                  mode="concat")),
}


@pytest.mark.parametrize("kind", sorted(LAYERS))
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carry"])
def test_layer_forward_and_state_match_jax(kind, masked, carried):
    jmake, tmake = LAYERS[kind]
    jlayer, tlayer = jmake(), tmake()
    params = _jax_layer_params(jlayer, 11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    state = {"h": rng.normal(size=(3, 6)).astype(np.float32),
             "c": rng.normal(size=(3, 6)).astype(np.float32)} \
        if carried and not kind.startswith("bi") else {}
    jy, jst = jlayer.forward({k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in state.items()},
                             jnp.asarray(x), train=False,
                             mask=None if mask is None else jnp.asarray(mask))
    ty, tst = tlayer.forward({k: _t(v) for k, v in params.items()},
                             {k: _t(v) for k, v in state.items()}, _t(x),
                             None if mask is None else _t(mask))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        np.testing.assert_allclose(_np(tst[k]), np.asarray(jst[k]), **TOL)


def test_layer_step_and_bf16_input_promotes_against_f32_params():
    """``step`` is one timestep of ``forward``; a bf16 input against f32
    weights computes (and carries) in f32, as JAX promotes."""
    jlayer = JaxGravesLSTM(n_in=5, n_out=6, activation="tanh")
    params = _jax_layer_params(jlayer, 13)
    x = np.random.default_rng(14).normal(size=(2, 5)).astype(np.float32)
    layer = GravesLSTM(n_in=5, n_out=6, activation="tanh")
    tp = {k: _t(v) for k, v in params.items()}
    y, st = layer.step(tp, {}, _t(x))
    jy, jst = jlayer.step({k: jnp.asarray(v) for k, v in params.items()}, {},
                          jnp.asarray(x))
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    y16, st16 = layer.step(tp, {}, _t(x).bfloat16())
    assert y16.dtype == torch.float32 and st16["c"].dtype == torch.float32


def test_init_params_shapes_and_forget_bias():
    gen = torch.Generator().manual_seed(0)
    p = GravesLSTM(n_in=5, n_out=6, forget_gate_bias_init=1.5).init_params(gen)
    jp = JaxGravesLSTM(n_in=5, n_out=6, forget_gate_bias_init=1.5) \
        .init_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    np.testing.assert_array_equal(_np(p["b"]), np.asarray(jp["b"]))
    bi = GravesBidirectionalLSTM(n_in=5, n_out=6).init_params(gen)
    assert sorted(bi) == sorted(JaxBiLSTM(n_in=5, n_out=6).init_params(
        jax.random.PRNGKey(0)))


# -------------------------------------------------- the card's routing
def test_helper_registry_routes_lstm_to_the_kernel():
    assert helpers.get_helper("lstm", "cpu") is None
    assert helpers._HELPERS[("lstm", "cuda", (9, 0))] is lk.cuda_lstm


def _force_card_helper(monkeypatch):
    """The LSTM helper forced on, as ``get_helper`` returns it for a CUDA
    tensor; returns a GravesLSTM's parameters and an input."""
    monkeypatch.setattr(trecurrent, "get_helper",
                        lambda kind, device: lk.cuda_lstm)
    params = {k: _t(v) for k, v in _jax_layer_params(
        JaxGravesLSTM(n_in=5, n_out=6), 15).items()}
    x = torch.randn(2, 4, 5, generator=torch.Generator().manual_seed(0))
    return params, x


@pytest.mark.parametrize("gate,cell", [("hardsigmoid", "tanh"),
                                       ("sigmoid", "softsign")])
def test_cuda_route_raises_for_other_activation_pairs(monkeypatch, gate,
                                                      cell):
    """On a card, an LSTM with a row-wise gate or cell activation (softmax,
    logsoftmax), whatever the other activation of the pair, goes through
    the kernel's wrapper with that pair (no longer a raise) and gives the
    plain loop's output and gradients."""
    params, x = _force_card_helper(monkeypatch)
    calls = []
    monkeypatch.setattr(lk, "lstm_recurrence",
                        lambda *a: calls.append(a[-2:]) or
                        lk.lstm_recurrence_plain(
                            *a[:-2], tact.get_activation(a[-2]),
                            tact.get_activation(a[-1])))
    for acts in (("softmax", cell), (gate, "logsoftmax")):
        conf = GravesLSTM(n_in=5, n_out=6, gate_activation=acts[0],
                          activation=acts[1])
        results = []
        for helper in (lk.cuda_lstm, None):
            monkeypatch.setattr(trecurrent, "get_helper",
                                lambda kind, device, h=helper: h)
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            y, _ = conf.forward(leaves, {}, x)
            results.append((y, torch.autograd.grad(y.square().sum(),
                                                   list(leaves.values()))))
        (got, got_g), (want, want_g) = results
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for a, b in zip(got_g, want_g):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert calls == [("softmax", cell), (gate, "logsoftmax")]


@pytest.mark.parametrize("peephole", [False, True],
                         ids=["lstm", "graves"])
def test_row_wise_lstm_matches_jax_layer(peephole):
    """The port's plain recurrence with a softmax gate and a logsoftmax
    cell (normalised over the H units of each row, for i, f, g, o and
    act(c)) against the JAX layer, peepholes on (GravesLSTM) and off
    (LSTM), masked, at 1e-5."""
    jcls, tcls = (JaxGravesLSTM, GravesLSTM) if peephole else \
        (JaxLSTM, LSTM)
    kw = dict(n_in=5, n_out=6, gate_activation="softmax",
              activation="logsoftmax")
    jlayer, tlayer = jcls(**kw), tcls(**kw)
    params = _jax_layer_params(jlayer, 21)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(3, 7, 5)).astype(np.float32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    jy, jst = jlayer.forward({k: jnp.asarray(v) for k, v in params.items()},
                             {}, jnp.asarray(x), train=False,
                             mask=jnp.asarray(mask))
    ty, tst = tlayer.forward({k: _t(v) for k, v in params.items()}, {},
                             _t(x), _t(mask))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    for k in jst:
        np.testing.assert_allclose(_np(tst[k]), np.asarray(jst[k]), **TOL)


@pytest.mark.parametrize("gate,cell", [("hardsigmoid", "tanh"),
                                       ("sigmoid", "softsign")])
def test_cuda_route_computes_elementwise_activation_pairs(monkeypatch, gate,
                                                          cell):
    """On a card, an LSTM with an elementwise activation pair goes through
    the kernel's wrapper with that pair and gives the plain loop's
    output."""
    params, x = _force_card_helper(monkeypatch)
    calls = []
    monkeypatch.setattr(lk, "lstm_recurrence",
                        lambda *a: calls.append(a[-2:]) or
                        lk.lstm_recurrence_plain(
                            *a[:-2], tact.get_activation(a[-2]),
                            tact.get_activation(a[-1])))
    conf = GravesLSTM(n_in=5, n_out=6, gate_activation=gate,
                      activation=cell)
    got, _ = conf.forward(params, {}, x)
    monkeypatch.setattr(trecurrent, "get_helper", lambda kind, device: None)
    want, _ = conf.forward(params, {}, x)
    assert calls == [(gate, cell)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -------------------------------------------------------------- activations
@pytest.mark.parametrize("name", jact.activation_names())
def test_activation_matches_jax(name):
    x = np.random.default_rng(16).normal(size=(4, 7)).astype(np.float32) * 3
    want = jact.get_activation(name)(jnp.asarray(x))
    got = tact.get_activation(name)(_t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_activation_registry_names_match_jax():
    assert tact.activation_names() == jact.activation_names()
