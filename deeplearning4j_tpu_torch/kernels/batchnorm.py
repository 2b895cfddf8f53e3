"""Fused batch-norm training (the JAX package's ``kernels/batchnorm.py``):
``bn_train_fused`` and ``bn_add_act_train_fused``, jnp custom VJPs there
and ``torch.autograd.Function`` s here, behind the ``batchnorm_train``
and ``batchnorm_add_act_train`` helper seams.

The arithmetic follows the JAX functions line for line:

- forward: the shifted one-pass moments of d = x − s with the running
  mean as the shift s, mean = s + m1, var = max(m2 − m1², 0) (biased, f32),
  then y = x · scale + shift in the compute dtype (+ res, ReLU for the
  residual tail);
- backward: Σdy and Σdy · x̂ with x̂ recomputed from x, then the analytic
  dx = k · ((dy − c1) − x̂ · c2) with k = γ · rstd, c1 = Σdy / M,
  c2 = Σdy·x̂ / M cast to the compute dtype where JAX casts them, and
  dgamma / dbeta in gamma's dtype; the ReLU tail masks dy by its saved
  output y > 0 and returns the masked dy as the residual's gradient. The
  shift hint gets no gradient, and none flows through the returned mean /
  var (they exist for the running statistics). JAX returns a bf16 input's
  dx in f32; here it is cast to the input's dtype, as autograd requires.

``bn_train_fused`` also takes the BN layer's own activation when it is a
ReLU (``act="relu"``): relu(bn(x)), which the JAX layer computes as
``activation_fn()(helper(...))``. Its backward masks dy by the BN output
recomputed from x, gamma, beta and the saved statistics with the
forward's rounded operations, so the mask is y > 0 and y is not kept.

Activations are [..., C] with the channels last, normalized over every
other axis, seen as [M, C]. Each direction has a wrapper per helper that
launches a Hopper kernel of ``csrc/batchnorm.cu`` on a CUDA tensor and
calls the plain version (:func:`bn_fwd_plain`, :func:`bn_bwd_plain`) on a
CPU tensor; its ``launches`` attribute counts kernel launches and its
``routes`` counts them by route (:func:`route`):

- ``"fused"``: f32 or bf16 activations and parameters, C a whole number
  of 16-byte vectors and at most 512 of them (bf16 C % 8 == 0 up to 4096,
  f32 C % 4 == 0 up to 2048), 16-byte aligned rows: one persistent
  cooperative launch a direction;
- ``"general"``: every other batch norm the JAX package computes (any
  C >= 1, f16 activations or parameters, C above 512 vectors, a
  misaligned base pointer): three plain launches a direction (statistics
  partials, an f64 finalize, the elementwise pass) with the same
  arithmetic and the same determinism.

What neither takes (not [M, C], a device mismatch, a non-contiguous
tensor) raises, and so does a refused launch; nothing falls back."""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .cuda_lib import _DTYPE_CODE, load

#: dtypes the fused route takes, and its 16-byte vector width in elements
_VEC = {torch.float32: 4, torch.bfloat16: 8}
#: activation and parameter dtypes either route takes
_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
#: 16-byte channel vectors a row may hold on the fused route: one per thread
#: of a CTA
_MAX_VECTORS = 512
#: the kernel routes, as :func:`route` names them
ROUTES = ("fused", "general")
#: the kernel's variants, as ``csrc/batchnorm.cu`` numbers them
FWD, FWD_RELU, FWD_RES, FWD_RES_RELU, BWD, BWD_RELU, BWD_RES_RELU = range(7)
#: fields of a launch plan (``batchnorm_plan``)
PLAN_FIELDS = ("grid", "smem", "stages", "tile_rows", "resident",
               "scratch", "per_sm", "sms")


# ------------------------------------------------------------ plain versions
def bn_fwd_plain(x2, gamma, beta, shift_hint, eps, res2=None, relu=False):
    """x2 [M, C] → (y2, mean, var, rstd): ``_bn_fwd_impl`` /
    ``_bn_add_act_fwd_impl`` of the JAX package, with ``relu`` and no
    ``res2`` the BN layer's ReLU on top."""
    n = x2.shape[0]
    xf = x2.float()
    s = shift_hint.float()
    d = xf - s
    m1 = d.sum(dim=0) / n
    m2 = (d * d).sum(dim=0) / n
    mean = s + m1
    var = (m2 - m1 * m1).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = _bn_out_plain(x2, gamma, beta, mean, rstd)
    if res2 is not None:
        y = y + res2
    if relu:
        y = torch.clamp_min(y, 0)
    return y, mean, var, rstd


def _bn_out_plain(x2, gamma, beta, mean, rstd):
    """x · scale + shift in x's dtype, scale and shift rounded to it."""
    scale = gamma.float() * rstd
    shift = beta.float() - mean * scale
    return x2 * scale.to(x2.dtype) + shift.to(x2.dtype)


def bn_bwd_plain(dy2, x2, gamma, mean, rstd, y2=None, relu=False, beta=None):
    """(dx2, dgamma, dbeta, dy2 masked) of :func:`bn_fwd_plain`: ``_bn_bwd``
    / ``_bn_add_act_bwd`` of the JAX package (dx in x's dtype, dgamma /
    dbeta in gamma's). With ``relu`` dy is masked by the tail's saved
    output ``y2`` > 0, or without ``y2`` by the BN output recomputed from
    x, gamma, ``beta`` and the statistics."""
    if relu:
        if y2 is None:
            y2 = _bn_out_plain(x2, gamma, beta, mean, rstd)
        dy2 = torch.where(y2 > 0, dy2, torch.zeros_like(dy2))
    n = x2.shape[0]
    dyf = dy2.float()
    xhat = (x2.float() - mean) * rstd
    dbeta = dyf.sum(dim=0)
    dgamma = (dyf * xhat).sum(dim=0)
    k = (gamma.float() * rstd).to(x2.dtype)
    dx = k * ((dy2 - (dbeta / n).to(x2.dtype))
              - xhat * (dgamma / n).to(x2.dtype))
    return dx.to(x2.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), \
        dy2


# ---------------------------------------------------------- kernel wrappers
#: (device index, M, C, dtype, variant) → (ctypes plan, its address, f32
#: scratch it needs)
_PLANS = {}
#: the loaded kernel library, once loaded
_LIB = []


def check_args(x2, *others) -> None:
    """Raise on what is not a batch norm the kernels take: x [M, C] (M, C
    >= 1) contiguous on a CUDA device, f32, f16 or bf16; every other
    activation like x (shape, dtype, device, contiguous)."""
    if x2.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got "
                         f"{x2.device}")
    if x2.dtype not in _DTYPES:
        raise ValueError(f"the batch-norm kernels take float32, float16 or "
                         f"bfloat16 activations, got {x2.dtype}")
    if x2.dim() != 2 or x2.shape[0] < 1 or x2.shape[1] < 1:
        raise ValueError(f"expected [M, C] activations, got "
                         f"{tuple(x2.shape)}")
    for t in (x2,) + others:
        if t.shape != x2.shape or t.dtype != x2.dtype or \
                t.device != x2.device or not t.is_contiguous():
            raise ValueError("batch-norm activations must be contiguous "
                             "[M, C] tensors of one dtype on one device")


def route(x2, gamma, *others) -> str:
    """The kernel route of a batch norm over ``x2`` [M, C] with parameters
    of ``gamma``'s dtype (see the module docstring); the base pointers of
    ``x2`` and of the ``others`` the launch reads must be 16-byte aligned
    for the fused route."""
    vec = _VEC.get(x2.dtype)
    if vec is None or gamma.dtype not in _VEC or x2.shape[1] % vec or \
            x2.shape[1] > vec * _MAX_VECTORS or \
            any(t.data_ptr() % 16 for t in (x2,) + others):
        return "general"
    return "fused"


def general_chunks(m: int, c: int, device) -> int:
    """Row chunks of the general route's statistics pass: about 4 CTAs an
    SM over all channel blocks, never more chunks than row groups."""
    lanes = min(c, 32)
    blocks_y = -(-c // lanes)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = -(-m // (256 // lanes))
    return max(1, min(-(-4 * sms // blocks_y), groups, 1024))


def _check_channel(c, device, dtypes, *vs) -> None:
    """Per-channel operands: contiguous [C] on ``device``, all of one dtype
    among ``dtypes`` (the kernel reads them as they are)."""
    for v in vs:
        if v.device != device or v.dtype not in dtypes or \
                v.dtype != vs[0].dtype or v.shape != (c,) or \
                not v.is_contiguous():
            raise ValueError(
                f"per-channel operands must be contiguous ({c},) tensors of "
                f"one dtype among {[str(d) for d in dtypes]} on {device}, "
                f"got {tuple(v.shape)} {v.dtype} on {v.device}")


def plan(m, c, dtype, variant, device=None):
    """The cached launch plan of ``variant`` over [M, C] of ``dtype`` on
    ``device`` (the current CUDA device by default), as a dict of
    :data:`PLAN_FIELDS`; ``resident`` 1 where each CTA's slab stays in
    shared memory between the two sweeps."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    with torch.cuda.device(device):
        arr = _plan(_lib(), m, c, dtype, variant, device)[0]
    return dict(zip(PLAN_FIELDS, arr))


def _lib():
    if not _LIB:
        _LIB.append(load("batchnorm"))
    return _LIB[0]


def _plan(lib, m, c, dtype, variant, device):
    key = (device.index, m, c, dtype, variant)
    found = _PLANS.get(key)
    if found is None:
        arr = (ctypes.c_longlong * len(PLAN_FIELDS))()
        rc = lib.batchnorm_plan(m, c, _DTYPE_CODE[dtype], variant, arr)
        if rc != 0:
            raise RuntimeError(f"batchnorm_plan failed: CUDA error {rc}")
        found = _PLANS[key] = (arr, ctypes.addressof(arr), arr[5])
    return found


def _on(device):
    """``device`` made current for a launch (nothing to do when it is)."""
    return contextlib.nullcontext() \
        if device.index == torch.cuda.current_device() \
        else torch.cuda.device(device)


def _launch_fwd(x2, gamma, beta, shift_hint, eps, res2, relu):
    """Forward launch on the route the shape takes → ((y, mean, var, rstd),
    route)."""
    check_args(x2, *(() if res2 is None else (res2,)))
    m, c = x2.shape
    dev = x2.device
    _check_channel(c, dev, _DTYPES, gamma, beta)
    _check_channel(c, dev, (torch.float32,), shift_hint)
    variant = (FWD_RELU if relu else FWD) if res2 is None else \
        (FWD_RES_RELU if relu else FWD_RES)
    way = route(x2, gamma, *(() if res2 is None else (res2,)))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    res_ptr = None if res2 is None else res2.data_ptr()
    with _on(dev):
        lib = _lib()
        y = torch.empty_like(x2)
        if way == "fused":
            _, addr, scratch = _plan(lib, m, c, x2.dtype, variant, dev)
            # mean, var, rstd [3, C], then the kernel's scratch
            buf = torch.empty(3 * c + scratch, dtype=torch.float32,
                              device=dev)
            rc = lib.batchnorm_fwd(
                x2.data_ptr(), res_ptr, gamma.data_ptr(), beta.data_ptr(),
                shift_hint.data_ptr(), y.data_ptr(), buf.data_ptr(),
                buf.data_ptr() + 12 * c, addr, m, c, _DTYPE_CODE[x2.dtype],
                _DTYPE_CODE[gamma.dtype], variant, float(eps), stream)
        else:
            gx = general_chunks(m, c, dev)
            buf = torch.empty(3 * c + (2 * gx + 2) * c, dtype=torch.float32,
                              device=dev)
            rc = lib.batchnorm_gen_fwd(
                x2.data_ptr(), res_ptr, gamma.data_ptr(), beta.data_ptr(),
                shift_hint.data_ptr(), y.data_ptr(), buf.data_ptr(),
                buf.data_ptr() + 12 * c, m, c, gx, _DTYPE_CODE[x2.dtype],
                _DTYPE_CODE[gamma.dtype], variant, float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"batchnorm forward kernel launch failed "
                           f"({way} route): CUDA error {rc}")
    return (y, *buf[:3 * c].view(3, c).unbind(0)), way


def _launch_bwd(dy2, x2, gamma, mean, rstd, variant, y2=None, beta=None):
    """Backward launch → ((dx, dgamma, dbeta, dres), route)."""
    tail = variant == BWD_RES_RELU
    check_args(x2, dy2, *((y2,) if tail else ()))
    m, c = x2.shape
    dev = x2.device
    _check_channel(c, dev, _DTYPES, gamma,
                   *((beta,) if variant == BWD_RELU else ()))
    _check_channel(c, dev, (torch.float32,), mean, rstd)
    way = route(x2, gamma, dy2, *((y2,) if tail else ()))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with _on(dev):
        lib = _lib()
        dx = torch.empty_like(x2)
        dres = torch.empty_like(x2) if tail else dy2
        dgb = torch.empty((2, c), dtype=gamma.dtype, device=dev)
        common = (dy2.data_ptr(), x2.data_ptr(),
                  y2.data_ptr() if tail else None, gamma.data_ptr(),
                  beta.data_ptr() if variant == BWD_RELU else None,
                  mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                  dres.data_ptr() if tail else None, dgb.data_ptr())
        if way == "fused":
            _, addr, scratch = _plan(lib, m, c, x2.dtype, variant, dev)
            buf = torch.empty(scratch, dtype=torch.float32, device=dev)
            rc = lib.batchnorm_bwd(*common, buf.data_ptr(), addr, m, c,
                                   _DTYPE_CODE[x2.dtype],
                                   _DTYPE_CODE[gamma.dtype], variant, stream)
        else:
            gx = general_chunks(m, c, dev)
            buf = torch.empty((2 * gx + 2) * c, dtype=torch.float32,
                              device=dev)
            rc = lib.batchnorm_gen_bwd(*common, buf.data_ptr(), m, c, gx,
                                       _DTYPE_CODE[x2.dtype],
                                       _DTYPE_CODE[gamma.dtype], variant,
                                       stream)
    if rc != 0:
        raise RuntimeError(f"batchnorm backward kernel launch failed "
                           f"({way} route): CUDA error {rc}")
    return (dx, dgb[0], dgb[1], dres), way


def _count(fn, way):
    fn.launches += 1
    fn.routes[way] += 1


def bn_train_fwd(x2, gamma, beta, shift_hint, eps, relu=False):
    """batchnorm_train forward on [M, C] → (y, mean, var, rstd), y =
    relu(bn(x)) with ``relu``: the Hopper kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x2.device.type == "cpu":
        return bn_fwd_plain(x2, gamma, beta, shift_hint, eps, relu=relu)
    out, way = _launch_fwd(x2, gamma, beta, shift_hint, eps, None, relu)
    _count(bn_train_fwd, way)
    return out


def bn_train_bwd(dy2, x2, gamma, mean, rstd, beta=None, relu=False):
    """batchnorm_train backward → (dx, dgamma, dbeta), dgamma / dbeta in
    gamma's dtype; with ``relu`` dy is masked by the BN output recomputed
    from x, gamma, ``beta`` and the statistics."""
    if x2.device.type == "cpu":
        return bn_bwd_plain(dy2, x2, gamma, mean, rstd, None, relu,
                            beta)[:3]
    out, way = _launch_bwd(dy2, x2, gamma, mean, rstd,
                           BWD_RELU if relu else BWD, beta=beta)
    _count(bn_train_bwd, way)
    return out[:3]


def bn_add_act_fwd(x2, gamma, beta, shift_hint, res2, eps, relu):
    """batchnorm_add_act_train forward: act(bn(x) + res) on [M, C] →
    (y, mean, var, rstd)."""
    if x2.device.type == "cpu":
        return bn_fwd_plain(x2, gamma, beta, shift_hint, eps, res2, relu)
    out, way = _launch_fwd(x2, gamma, beta, shift_hint, eps, res2, relu)
    _count(bn_add_act_fwd, way)
    return out


def bn_add_act_bwd(dy2, x2, y2, gamma, mean, rstd, relu):
    """batchnorm_add_act_train backward → (dx, dgamma, dbeta, dres)."""
    if x2.device.type == "cpu":
        return bn_bwd_plain(dy2, x2, gamma, mean, rstd, y2, relu)
    out, way = _launch_bwd(dy2, x2, gamma, mean, rstd,
                           BWD_RES_RELU if relu else BWD, y2=y2)
    _count(bn_add_act_bwd, way)
    return out


for _fn in (bn_train_fwd, bn_train_bwd, bn_add_act_fwd, bn_add_act_bwd):
    _fn.launches = 0
    _fn.routes = dict.fromkeys(ROUTES, 0)


# ------------------------------------------------- batch norm across shards
# One controller runs a batch norm over several shards (row blocks of one
# global batch, each on its own device) with the statistics of the whole
# batch: every shard's partial sums (``bn_xs_stats``), one finalize over
# the partials of every shard concatenated in shard order on the home
# device (``bn_xs_finalize``), then every shard's elementwise pass with the
# global coefficients (``bn_xs_apply``); the backward the same three phases
# over Σdy and Σdy·x̂. On a CUDA tensor each wrapper launches one kernel of
# the general route (``batchnorm_xs_*`` in ``csrc/batchnorm.cu``) and
# counts it (``launches``, and ``bwd_launches`` for the backward
# variants); on a CPU tensor it runs its plain version, whose sums follow
# :func:`bn_fwd_plain` / :func:`bn_bwd_plain` with the shards' partials
# added in shard order.

def _wide(x2):
    """The plain versions' accumulation type: f32 (the kernels'), f64 for
    an f64 input, which no kernel takes."""
    return torch.float64 if x2.dtype == torch.float64 else torch.float32


def _masked_dy_plain(dy2, x2, variant, gamma, beta, mean, rstd, y2):
    """dy masked as the backward variant masks it (the tail by its saved
    output, a folded ReLU by the BN output recomputed from x)."""
    if variant == BWD_RES_RELU:
        return torch.where(y2 > 0, dy2, torch.zeros_like(dy2))
    if variant == BWD_RELU:
        y = _bn_out_plain(x2, gamma, beta, mean, rstd)
        return torch.where(y > 0, dy2, torch.zeros_like(dy2))
    return dy2


def _xs_check(x2, variant, others, channel):
    check_args(x2, *[t for t in others if t is not None])
    c, dev = x2.shape[1], x2.device
    _check_channel(c, dev, _DTYPES, *[t for t in channel if t is not None])


def bn_xs_stats(x2, center, variant, dy2=None, gamma=None, rstd=None,
                y2=None, beta=None):
    """One shard's partials [g, 2, C] f32: forward variants Σ(x − center)
    and Σ(x − center)² about the shared shift; backward variants Σg and
    Σg·x̂ with g the masked dy, x̂ = (x − center) · rstd about the global
    mean."""
    bwd = variant >= BWD
    if x2.device.type == "cpu":
        xf = x2.to(_wide(x2))
        if not bwd:
            d = xf - center.to(xf.dtype)
            return torch.stack([d.sum(dim=0), (d * d).sum(dim=0)])[None]
        g = _masked_dy_plain(dy2, x2, variant, gamma, beta, center, rstd,
                             y2).to(xf.dtype)
        xhat = (xf - center) * rstd
        return torch.stack([g.sum(dim=0), (g * xhat).sum(dim=0)])[None]
    _xs_check(x2, variant, (dy2, y2), (gamma, beta))
    m, c = x2.shape
    dev = x2.device
    _check_channel(c, dev, (torch.float32,),
                   *[t for t in (center, rstd) if t is not None])
    gx = general_chunks(m, c, dev)
    partial = torch.empty((gx, 2, c), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with _on(dev):
        rc = _lib().batchnorm_xs_stats(
            x2.data_ptr(), ptr(dy2), ptr(y2), ptr(gamma), ptr(beta),
            center.data_ptr(), ptr(rstd), partial.data_ptr(), m, c, gx,
            _DTYPE_CODE[x2.dtype],
            _DTYPE_CODE[(gamma if gamma is not None else x2).dtype],
            variant, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"batch-norm shard statistics launch failed: "
                           f"CUDA error {rc}")
    _count_xs(bn_xs_stats, bwd)
    return partial


def bn_xs_finalize(partials, m, dtype, variant, gamma, beta=None,
                   shift=None, eps=1e-5):
    """The finalize over every shard's partials ([G, 2, C], concatenated in
    shard order, summed in that order in f64) for ``m`` rows in all.
    Forward: (mean, var, rstd, coef [2, C]); backward: (dgamma, dbeta in
    gamma's dtype, coef [2, C]); coef rounded to the activations'
    ``dtype``."""
    bwd = variant >= BWD
    c = partials.shape[2]
    dev = partials.device
    if dev.type == "cpu":
        acc = partials[0].double()
        for p in partials[1:]:
            acc = acc + p.double()
        wide = partials.dtype
        q0, q1 = acc.to(wide)
        n = float(m)
        rnd = lambda t: t.to(dtype).to(wide)
        if not bwd:
            m1, m2 = q0 / n, q1 / n
            mean = shift.to(wide) + m1
            var = (m2 - m1 * m1).clamp_min(0.0)
            rstd = torch.rsqrt(var + eps)
            scale = gamma.to(wide) * rstd
            coef = torch.stack([rnd(scale),
                                rnd(beta.to(wide) - mean * scale)])
            return mean, var, rstd, coef
        return q1.to(gamma.dtype), q0.to(gamma.dtype), \
            torch.stack([rnd(q0 / n), rnd(q1 / n)])
    if partials.dtype != torch.float32 or not partials.is_contiguous() or \
            partials.dim() != 3 or partials.shape[1] != 2:
        raise ValueError("partials must be a contiguous [G, 2, C] float32 "
                         "tensor")
    _check_channel(c, dev, _DTYPES, gamma,
                   *((beta,) if beta is not None else ()))
    coef = torch.empty((2, c), dtype=torch.float32, device=dev)
    stats = dgb = None
    if bwd:
        dgb = torch.empty((2, c), dtype=gamma.dtype, device=dev)
    else:
        _check_channel(c, dev, (torch.float32,), shift)
        stats = torch.empty((3, c), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with _on(dev):
        rc = _lib().batchnorm_xs_finalize(
            partials.data_ptr(), m, c, partials.shape[0], gamma.data_ptr(),
            ptr(beta), ptr(shift), ptr(stats), ptr(dgb), coef.data_ptr(),
            _DTYPE_CODE[dtype], _DTYPE_CODE[gamma.dtype], variant,
            float(eps), torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"batch-norm shard finalize launch failed: CUDA "
                           f"error {rc}")
    _count_xs(bn_xs_finalize, bwd)
    if bwd:
        return dgb[0], dgb[1], coef
    return (*stats.unbind(0), coef)


def bn_xs_apply(x2, coef, variant, res2=None, dy2=None, y2=None, gamma=None,
                beta=None, mean=None, rstd=None):
    """One shard's elementwise pass with the global ``coef``: forward
    variants → y (+ res, ReLU); backward variants → (dx, dres) with dres
    the masked dy of the ReLU tail (dy itself otherwise)."""
    bwd = variant >= BWD
    if x2.device.type == "cpu":
        if not bwd:
            y = x2 * coef[0].to(x2.dtype) + coef[1].to(x2.dtype)
            if res2 is not None:
                y = y + res2
            if variant in (FWD_RELU, FWD_RES_RELU):
                y = torch.clamp_min(y, 0)
            return y
        g = _masked_dy_plain(dy2, x2, variant, gamma, beta, mean, rstd, y2)
        xhat = (x2.to(_wide(x2)) - mean) * rstd
        k = (gamma.to(xhat.dtype) * rstd).to(x2.dtype)
        dx = k * ((g - coef[0].to(x2.dtype)) - xhat * coef[1].to(x2.dtype))
        return dx.to(x2.dtype), g
    _xs_check(x2, variant, (res2, dy2, y2), (gamma, beta))
    m, c = x2.shape
    dev = x2.device
    _check_channel(c, dev, (torch.float32,),
                   *[t for t in (mean, rstd) if t is not None])
    if coef.shape != (2, c) or coef.dtype != torch.float32 or \
            coef.device != dev or not coef.is_contiguous():
        raise ValueError(f"coef must be a contiguous (2, {c}) float32 "
                         f"tensor on {dev}")
    out = torch.empty_like(x2)
    dres = torch.empty_like(x2) if variant == BWD_RES_RELU else None
    ptr = lambda t: None if t is None else t.data_ptr()
    with _on(dev):
        rc = _lib().batchnorm_xs_apply(
            x2.data_ptr(), ptr(res2), ptr(dy2), ptr(y2), ptr(gamma),
            ptr(beta), ptr(mean), ptr(rstd), coef.data_ptr(),
            out.data_ptr(), ptr(dres), m, c, _DTYPE_CODE[x2.dtype],
            _DTYPE_CODE[(gamma if gamma is not None else x2).dtype],
            variant, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"batch-norm shard apply launch failed: CUDA "
                           f"error {rc}")
    _count_xs(bn_xs_apply, bwd)
    if not bwd:
        return out
    return out, (dres if dres is not None else dy2)


def _count_xs(fn, bwd):
    if bwd:
        fn.bwd_launches += 1
    else:
        fn.launches += 1


for _fn in (bn_xs_stats, bn_xs_finalize, bn_xs_apply):
    _fn.launches = 0
    _fn.bwd_launches = 0


class CrossShardBatchNorm(torch.autograd.Function):
    """A batch norm over the shards ``xs`` (each [..., C] on its own
    device) with the statistics of all of them: (*ys, mean, var), ys =
    act(bn(x) [+ res]) per shard, mean / var f32 on ``gamma``'s device and
    not differentiable. ``spec`` = (shards, eps, act, tail): with ``tail``
    the arguments after the xs are the residuals, one a shard. dγ and dβ
    (the sums over every shard) flow to ``gamma`` / ``beta``."""

    @staticmethod
    def forward(ctx, spec, gamma, beta, shift, *args):
        n, eps, act, tail = spec
        xs, res = args[:n], (args[n:] if tail else (None,) * n)
        relu = act == "relu"
        variant = (FWD_RES_RELU if relu else FWD_RES) if tail else \
            (FWD_RELU if relu else FWD)
        home = gamma.device
        x2s = [_rows(x) for x in xs]
        parts = [bn_xs_stats(x2, shift.to(x2.device), variant)
                 for x2 in x2s]
        m = sum(x2.shape[0] for x2 in x2s)
        mean, var, rstd, coef = bn_xs_finalize(
            torch.cat([p.to(home) for p in parts]), m, xs[0].dtype, variant,
            gamma, beta, shift, eps)
        ys = []
        for x, x2, r in zip(xs, x2s, res):
            y = bn_xs_apply(x2, coef.to(x2.device), variant,
                            res2=None if r is None else _rows(r))
            ys.append(y.view(x.shape))
        ctx.spec = spec
        ctx.save_for_backward(gamma, beta, mean, rstd, *xs,
                              *(ys if tail else ()))
        ctx.mark_non_differentiable(mean, var)
        return (*ys, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        n, _eps, act, tail = ctx.spec
        gamma, beta, mean, rstd, *rest = ctx.saved_tensors
        xs, ys = rest[:n], (rest[n:] if tail else (None,) * n)
        relu = act == "relu"
        variant = BWD_RES_RELU if tail and relu else \
            (BWD_RELU if relu else BWD)
        home = gamma.device
        per = []
        for x, y, dy in zip(xs, ys, grads[:n]):
            dev = x.device
            per.append(dict(
                x2=_rows(x), dy2=_rows(dy.contiguous()),
                y2=None if y is None else _rows(y),
                gamma=gamma.to(dev), beta=beta.to(dev) if relu else None,
                mean=mean.to(dev), rstd=rstd.to(dev)))
        parts = [bn_xs_stats(p["x2"], p["mean"], variant, dy2=p["dy2"],
                             gamma=p["gamma"], rstd=p["rstd"], y2=p["y2"],
                             beta=p["beta"]) for p in per]
        m = sum(p["x2"].shape[0] for p in per)
        dgamma, dbeta, coef = bn_xs_finalize(
            torch.cat([q.to(home) for q in parts]), m, xs[0].dtype, variant,
            gamma)
        dxs, dres = [], []
        for x, p in zip(xs, per):
            dx, dr = bn_xs_apply(p["x2"], coef.to(x.device), variant,
                                 dy2=p["dy2"], y2=p["y2"], gamma=p["gamma"],
                                 beta=p["beta"], mean=p["mean"],
                                 rstd=p["rstd"])
            dxs.append(dx.view(x.shape))
            dres.append(dr.view(x.shape))
        return (None, dgamma, dbeta, None, *dxs,
                *(dres if tail else ()))


def bn_train_shards(xs, gamma, beta, shift_hint, eps, act="identity",
                    res=None):
    """Batch-norm training over shards (:class:`CrossShardBatchNorm`):
    (ys, mean, var); ``res`` (one residual a shard) makes it the
    BN → add → act tail."""
    _check_act(act, "the cross-shard batch norm")
    tail = res is not None
    out = CrossShardBatchNorm.apply((len(xs), float(eps), act, tail), gamma,
                                    beta, shift_hint, *xs,
                                    *(res if tail else ()))
    return list(out[:len(xs)]), out[-2], out[-1]


# --------------------------------------------------------- autograd Functions
def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _check_act(act, what):
    if act not in ("relu", "identity"):
        raise ValueError(f"{what} takes 'relu' or 'identity', got {act!r}")


class BatchNormTrain(torch.autograd.Function):
    """``bn_train_fused`` (with ``act`` "relu", relu of it): (y, mean,
    var) of x [..., C]; only y carries a gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, shift_hint, eps, act):
        relu = act == "relu"
        y, mean, var, rstd = bn_train_fwd(_rows(x), gamma, beta,
                                          shift_hint, eps, relu)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return y.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = bn_train_bwd(_rows(dy.contiguous()), _rows(x),
                                         gamma, mean, rstd, beta, ctx.relu)
        return dx.view(x.shape), dgamma, dbeta, None, None, None


class BatchNormAddActTrain(torch.autograd.Function):
    """``bn_add_act_train_fused``: (act(bn(x) + res), mean, var); y
    carries gradients to x, gamma, beta and res."""

    @staticmethod
    def forward(ctx, x, gamma, beta, shift_hint, res, eps, act):
        relu = act == "relu"
        y, mean, var, rstd = bn_add_act_fwd(_rows(x), gamma, beta,
                                            shift_hint, _rows(res), eps,
                                            relu)
        y = y.view(x.shape)
        ctx.save_for_backward(x, gamma, mean, rstd, y)
        ctx.relu = relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, rstd, y = ctx.saved_tensors
        dx, dgamma, dbeta, dres = bn_add_act_bwd(
            _rows(dy.contiguous()), _rows(x), _rows(y), gamma, mean, rstd,
            ctx.relu)
        return dx.view(x.shape), dgamma, dbeta, None, dres.view(x.shape), \
            None, None


def bn_train_fused(x, gamma, beta, shift_hint, eps, act="identity"):
    """Batch-norm training forward over every axis but the last: (y, mean,
    var), mean / var f32 and not differentiable; ``act`` "relu" gives
    relu(y), the BN layer's own activation folded in. The
    ``batchnorm_train`` helper."""
    _check_act(act, "the batch-norm helper")
    return BatchNormTrain.apply(x, gamma, beta, shift_hint, float(eps), act)


def bn_add_act_train_fused(x, gamma, beta, shift_hint, res, eps, act):
    """``act(batchnorm(x) + res)``, act "relu" or "identity": (y, mean,
    var). The ``batchnorm_add_act_train`` helper."""
    _check_act(act, "the fused batch-norm tail")
    return BatchNormAddActTrain.apply(x, gamma, beta, shift_hint, res,
                                      float(eps), act)
