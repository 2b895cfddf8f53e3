"""LSTM recurrence (kernel B6): the counterpart of the JAX package's
``kernels/lstm.py``.

- :func:`lstm_recurrence_fwd` is the wrapper of the Hopper kernel
  ``csrc/lstm.cu`` (replacing the TPU kernel ``_make_kernel``,
  ``kernels/lstm.py:42``, driven by ``_pallas_forward``). On a CUDA tensor
  it launches the kernel or raises; on a CPU tensor it calls the plain
  version. Its ``launches`` attribute counts kernel launches, and
  ``routes`` counts them by route.
- :func:`lstm_plan` says which of the kernel's two routes a shape takes
  and how it is launched: ``"cluster"`` (bf16 with H a multiple of 8 up to
  512: thread-block clusters over slices of the batch, R resident in bf16,
  products on the tensor cores, h exchanged through distributed shared
  memory) or ``"cooperative"`` (f32, and bf16 shapes the cluster route
  does not take: one cooperative grid, f32 products on the CUDA cores).
- :func:`lstm_recurrence_plain` is the plain PyTorch version of the same
  function (a loop over T with the gate math of the JAX package's
  ``_lstm_recurrence``, ``nn/conf/layers/recurrent.py:33``, mask
  included), used by CPU tensors, by the backward and by ``chip_smoke.py``'s
  comparison on the card.
- :class:`LSTMRecurrence` is the ``torch.autograd.Function`` over the
  kernel. As in the JAX package (``_fused_bwd``), the backward has no
  kernel of its own: it recomputes the plain recurrence under autograd and
  takes ``torch.autograd.grad`` of it, so the gradients are exactly those
  of the plain path. :func:`lstm_recurrence` skips the Function when no
  gradient is wanted (its call costs host time on every ``rnn_time_step``).

Layout is that of the JAX ``_pallas_forward``: ``xw_t`` [T, N, 4H]
(already ``x @ W + b``, gate blocks [i, f, g, o]), ``R`` [H, 4H], ``h0`` /
``c0`` [N, H], optional peepholes ``(pi, pf, po)`` [H] and mask ``mask_t``
[T, N] (h and c keep their previous values where it is 0). Returns ``(y_t [T, N, H], hT, cT)``.
Products accumulate in at least f32, and h and c round to the input dtype
at every step, as the TPU kernel keeps them in scratch of the input dtype
(in f32 that rounding is the identity)."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import cuda_lib

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
#: cudaErrorCooperativeLaunchTooLarge: the kernel's planner found no grid
#: whose CTAs can all be resident at once
_NO_COOPERATIVE_GRID = 720
#: the C entries' route codes
ROUTES = ("cooperative", "cluster")
_PLAN_KEYS = ("route", "units", "ctas", "smem", "per_sm", "sms", "cluster",
              "rows_per_cluster")


def lstm_recurrence_plain(xw_t, R, h0, c0, peep: Optional[Sequence] = None,
                          mask_t=None, gate_act=torch.sigmoid,
                          cell_act=torch.tanh):
    """The recurrence as a loop over T in plain PyTorch (see the module
    docstring for shapes). ``gate_act`` / ``cell_act`` are the layer's gate
    and cell activations (the kernel takes sigmoid / tanh only)."""
    dtype = xw_t.dtype
    acc = torch.promote_types(dtype, torch.float32)
    H = R.shape[0]
    # unbind, not xw[t]: its backward is one stack, where indexing would
    # zero-fill and add a [T, N, 4H] gradient at every step
    xs, Rf = xw_t.to(acc).unbind(0), R.to(acc)
    ms = None if mask_t is None else mask_t.to(acc)[..., None].unbind(0)
    pi, pf, po = (None, None, None) if peep is None else \
        tuple(p.to(acc) for p in peep)
    h, c = h0, c0
    ys = []
    for t in range(xw_t.shape[0]):
        h_prev, c_prev = h.to(acc), c.to(acc)
        pre = torch.addmm(xs[t], h_prev, Rf)
        pre_i, pre_f, pre_g, pre_o = pre.split(H, dim=-1)
        if pi is not None:
            pre_i = pre_i + c_prev * pi
            pre_f = pre_f + c_prev * pf
        i = gate_act(pre_i)
        f = gate_act(pre_f)
        g = cell_act(pre_g)
        c_new = f * c_prev + i * g
        if po is not None:
            pre_o = pre_o + c_new * po
        h_new = gate_act(pre_o) * cell_act(c_new)
        if ms is not None:
            m = ms[t]
            h_new = m * h_new + (1 - m) * h_prev
            c_new = m * c_new + (1 - m) * c_prev
        h, c = h_new.to(dtype), c_new.to(dtype)
        ys.append(h)
    return torch.stack(ys), h, c


def check_lstm_args(xw_t, R, h0, c0, peep, mask_t) -> None:
    """Raise on anything the kernel does not take: CUDA tensors of one
    float32 or bfloat16 dtype on one device; xw_t [T, N, 4H] (T, N >= 1)
    with unit stride on its last axis; R [H, 4H], h0 / c0 [N, H] and the
    peepholes [H] contiguous; a [T, N] mask."""
    if xw_t.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got "
                         f"{xw_t.device}")
    if xw_t.dtype not in _DTYPE_CODE:
        raise ValueError(f"the LSTM kernel takes float32 or bfloat16, got "
                         f"{xw_t.dtype}")
    if xw_t.dim() != 3 or xw_t.shape[0] < 1 or xw_t.shape[1] < 1:
        raise ValueError(f"expected xw_t [T >= 1, N >= 1, 4H], got "
                         f"{tuple(xw_t.shape)}")
    t, n, h4 = xw_t.shape
    h = R.shape[0] if R.dim() == 2 else -1
    if tuple(R.shape) != (h, 4 * h) or h4 != 4 * h or h < 1:
        raise ValueError(f"R must be [H, 4H] matching xw_t's last axis "
                         f"{h4}, got {tuple(R.shape)}")
    if xw_t.stride(2) != 1:
        raise ValueError("xw_t needs unit stride on its last axis")
    named = [("R", R, (h, 4 * h)), ("h0", h0, (n, h)), ("c0", c0, (n, h))]
    if peep is not None:
        named += [(k, p, (h,)) for k, p in zip(("pi", "pf", "po"), peep)]
    for name, x, shape in named:
        if tuple(x.shape) != shape or x.dtype != xw_t.dtype or \
                x.device != xw_t.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {xw_t.dtype} "
                             f"{list(shape)} tensor on {xw_t.device}")
    if mask_t is not None and (tuple(mask_t.shape) != (t, n) or
                               mask_t.device != xw_t.device):
        raise ValueError(f"mask_t must be [{t}, {n}] on {xw_t.device}")


def lstm_plan(n: int, h: int, dtype) -> dict:
    """The kernel's launch plan for a batch of ``n`` rows and ``h`` hidden
    units in ``dtype`` on the current card (tensors 16-byte aligned, as
    PyTorch allocates them): ``route`` ("cluster" or "cooperative"), hidden
    ``units`` per CTA, ``ctas``, dynamic shared memory ``smem``,
    ``per_sm`` (co-resident CTAs an SM, or clusters the card holds at
    once), ``sms``, CTAs per ``cluster`` (0 on the cooperative route) and
    ``rows_per_cluster``. Raises when no route takes the shape."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    with torch.cuda.device(torch.cuda.current_device()):
        rc = cuda_lib.load("lstm").lstm_plan(n, h, _DTYPE_CODE[dtype], out)
    if rc != 0:
        raise ValueError(f"no LSTM launch plan for N={n}, H={h}, {dtype} "
                         f"(CUDA error {rc})")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["route"] = ROUTES[plan["route"]]
    return plan


def lstm_recurrence_fwd(xw_t, R, h0, c0, peep=None, mask_t=None):
    """The recurrence forward: the Hopper kernel on a CUDA tensor (one
    launch over all T, on the route :func:`lstm_plan` picks), the plain
    version on a CPU tensor. On the card y is laid out [N, T, H] and
    returned as its [T, N, H] view, so the layer's transpose back is
    free."""
    if xw_t.device.type == "cpu":
        return lstm_recurrence_plain(xw_t, R, h0, c0, peep, mask_t)
    check_lstm_args(xw_t, R, h0, c0, peep, mask_t)
    t, n, h4 = xw_t.shape
    h = h4 // 4
    y = torch.empty((n, t, h), dtype=xw_t.dtype, device=xw_t.device)
    y_t = y.transpose(0, 1)
    ht = torch.empty_like(h0)
    ct = torch.empty_like(c0)
    mask = None if mask_t is None else \
        mask_t.to(torch.float32).contiguous()
    pi, pf, po = (None, None, None) if peep is None else peep
    ptr = lambda x: None if x is None else x.data_ptr()
    route = ctypes.c_int(-1)
    with torch.cuda.device(xw_t.device):
        rc = cuda_lib.load("lstm").lstm_recurrence_fwd(
            xw_t.data_ptr(), R.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            ptr(pi), ptr(pf), ptr(po), ptr(mask), y.data_ptr(),
            ht.data_ptr(), ct.data_ptr(), xw_t.stride(0), xw_t.stride(1),
            y_t.stride(0), y_t.stride(1), t, n, h, _DTYPE_CODE[xw_t.dtype],
            torch.cuda.current_stream().cuda_stream, ctypes.byref(route))
    if rc == _NO_COOPERATIVE_GRID:
        raise ValueError(f"no co-resident LSTM grid for N={n}, H={h}, "
                         f"{xw_t.dtype} on either route: the R slices do "
                         "not fit the card's shared memory")
    if rc != 0:
        raise RuntimeError(f"lstm_recurrence_fwd kernel launch failed: CUDA "
                           f"error {rc} (T={t}, N={n}, H={h}, "
                           f"{xw_t.dtype})")
    lstm_recurrence_fwd.launches += 1
    lstm_recurrence_fwd.routes[ROUTES[route.value]] += 1
    return y_t, ht, ct


lstm_recurrence_fwd.launches = 0
lstm_recurrence_fwd.routes = dict.fromkeys(ROUTES, 0)


class LSTMRecurrence(torch.autograd.Function):
    """Forward through :func:`lstm_recurrence_fwd`; backward by recomputing
    :func:`lstm_recurrence_plain` under autograd (the JAX package's
    rematerialising ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, xw_t, R, h0, c0, pi, pf, po, mask_t):
        peep = None if pi is None else (pi, pf, po)
        out = lstm_recurrence_fwd(xw_t, R, h0, c0, peep, mask_t)
        ctx.save_for_backward(xw_t, R, h0, c0, pi, pf, po, mask_t)
        return out

    @staticmethod
    def backward(ctx, dy, dht, dct):
        xw_t, R, h0, c0, pi, pf, po, mask_t = ctx.saved_tensors
        inputs = (xw_t, R, h0, c0, pi, pf, po)
        wanted = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            leaves = [None if x is None else
                      x.detach().requires_grad_(w)
                      for x, w in zip(inputs, wanted)]
            peep = None if pi is None else tuple(leaves[4:7])
            outs = lstm_recurrence_plain(*leaves[:4], peep, mask_t)
            diff = [x for x, w in zip(leaves, wanted) if w]
            grads = iter(torch.autograd.grad(outs, diff, (dy, dht, dct),
                                             allow_unused=True)
                         if diff else ())
        return tuple(next(grads) if w else None for w in wanted) + (None,)


def lstm_recurrence(xw_t, R, h0, c0, peep=None, mask_t=None):
    """The recurrence with gradients. CPU tensors run the plain version
    (autograd differentiates it directly); on the card
    :class:`LSTMRecurrence` when autograd needs one of the inputs, else the
    kernel forward alone (no Function call)."""
    if xw_t.device.type == "cpu":
        return lstm_recurrence_plain(xw_t, R, h0, c0, peep, mask_t)
    pi, pf, po = (None, None, None) if peep is None else peep
    inputs = (xw_t, R, h0, c0, pi, pf, po)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in inputs):
        return LSTMRecurrence.apply(*inputs, mask_t)
    return lstm_recurrence_fwd(xw_t, R, h0, c0, peep, mask_t)


def cuda_lstm(conf, xw_t, R, h0, c0, peep=None, mask_t=None):
    """The helper registry's ``lstm`` entry on Hopper: the recurrence of
    layer ``conf`` through kernel B6, which computes sigmoid gates and a
    tanh cell only. Any other activation pair raises, naming it: the card
    has no plain-loop fallback."""
    gate, cell = conf.activation_names()
    if (gate, cell) != ("sigmoid", "tanh"):
        raise NotImplementedError(
            f"the LSTM kernel computes sigmoid gates and a tanh cell; "
            f"gate_activation={gate!r} with activation={cell!r} has no "
            "kernel on the card yet (run it on the CPU)")
    return lstm_recurrence(xw_t, R, h0, c0, peep, mask_t)
