"""Drive the PyTorch/H100 port (``deeplearning4j_tpu_torch``) on one card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one Hopper GPU and the CUDA toolkit (nvcc). It exits non-zero, and
prints no result, without a CUDA device.

Phases, each an uncaught exception on failure:

1. environment: torch/CUDA versions, capability (9, 0), the card's name
   and power limit; TF32 off for the plain references.
2. build: every kernel library from ``deeplearning4j_tpu_torch/csrc``
   with nvcc for sm_90a, one nvcc each, all started together.
3. kernel checks: each forward kernel against its plain PyTorch version
   on the card at the main path's shapes (o max-abs <= 5e-2, lse max-abs
   <= 1e-2), and each backward kernel against the plain backward (dq, dk,
   dv rel-L2 <= 2e-2 in bf16, and bitwise equal over two calls); fully
   masked batch rows are checked for finiteness only. Each with its time,
   the plain version's, scaled_dot_product_attention's (forward, or its
   backward of all three gradients through ``torch.autograd.grad`` on a
   saved graph, with a boolean mask and, unmasked, with ``is_causal``; the
   faster is the yardstick) (CUDA events, median of 20 samples of 10
   back-to-back launches), and the data-sheet bound. B1 is also checked
   and timed at the flagship train step's shape (B 32, no key mask) and a
   serving admission's (8 rows, bucket 512); those lines are repeated
   before the ``kernels`` line.
4. serving: the flagship LM (vocab 32000, d 768, 12 heads, 12 layers,
   max_length 577, bf16, random seeded weights) behind a
   SlotGenerationEngine (8 slots, K = 4) answering 16 greedy requests;
   the short-sequence kernel must launch on every admission, at most one
   readback per decode block, and the card's prefill logits must match
   the same weights run in f32 on the CPU.
4b. paged serving and speculation, on the same net with the engine at
   t_max 576 (pages of 16, 36 a slot). Prefix sharing: 8 slots, K = 4,
   the default pool (289 pages); after one warm request, 16 requests of
   one 256-token prefix plus 64-256-token tails, 64 new tokens each: at
   least 15 x 256 prefix hit tokens, at most one readback per decode
   block, the page audit clean and nothing mapped after the drain, and a
   hit's first-token logits (prefix in pages, tail on top) against the
   whole prompt in f32 on the CPU; then the prefill of 8 tails on the
   shared pages timed against the slab's prefill of the whole prompts,
   and each of them, a paged and a slab decode block profiled.
   Concurrency: 32 slots on the 8-slot slab's bytes (289 pages), 32
   requests of 32-64 prompt tokens: at least 24 slots active at once.
   Speculation (spec_k 4), slab and paged, against the same 8 requests
   (256-token prompts repeating a 32-token motif) decoded without it,
   with the default fallback and with none (spec_threshold 0): one
   readback per verify block, the audit clean, and verify_block's window
   logits against decode_block's at the same positions.
4c. the scheduling and resilience tier, on the same net, engine t_max
   576, every timed engine with EDF, adaptive K and the numerics sentinel
   (checked in (d) to change no token). (a) chunked prefill, slab and
   paged, windows of 128: 8 short requests (32-64 tokens, 256 new)
   decoding when 4 long ones (448-512 tokens) arrive, with and without
   chunking: the longest gap between decode-block retirements of the
   short lanes and the long requests' time to first token, at most one
   readback a decode block; a 480-token prompt's final-window logits
   (slab and paged) against the whole-prompt prefill on the card and the
   CPU f32 twin (rel-L2 <= 5e-2). (b) recompute_logits on 8 rows of 512:
   12 B1 launches, logits against the prefill's. (c) 32 requests with
   mixed deadlines under headroom shedding, 4 cancelled mid-decode: every
   request ends, no slot or page left held; the K adaptive block chose
   and the block latency against its target. (d) the sentinel: a clean
   run token-identical to a sentinel-off engine's in the same call (and
   both rates), a NaN injection failing exactly its request with
   NumericalFault and none of its block's tokens, a flipped shared-prefix
   page caught by the verifier at rate 1.0. (e) EngineSupervisor: a crash
   at engine.step mid-decode; every request completes once at full
   length, with no nvcc build and no weight cast after the restart. The
   phase prints its wall time.
5. long prompt: the same width at 2 layers, max_length 2048,
   TransformerDecoder.generate on 4 prompts of 1536 tokens (bucket
   T = 2048 > 512): the flash kernel must launch.
6. flagship training: ``bench.py``'s training configuration (vocab 32000,
   d 768, 12 heads, 12 layers, T 512, B 32, bf16, adam lr 3e-4) through
   ``ComputationGraph.fit_batch`` on seeded random tokens: the first-step
   loss and four gradients against the same weights in f32 on the CPU (2
   rows), then 2 warm and 8 timed steps on one batch; the short-sequence
   forward and backward kernels must launch 12 times a step and the loss
   must fall.
7. long-context training: the same width at 2 layers, T 2048, B 4, 3
   steps; the flash forward, dq and dkv kernels must launch 2 times a step
   and the loss must fall.
8. char-RNN training: ``bench.py``'s char-RNN configuration (GravesLSTM
   2 x 512, vocab 80, B 64, T 128, bf16, rmsprop, l2 1e-3; lr 0.002, see
   CHARRNN_LR) through ``MultiLayerNetwork._fit_batch`` on seeded one-hot
   sequences: the first-step loss and four gradients against the same
   weights in f32 on the CPU (2 rows), then 2 warm and 8 timed steps; the
   LSTM kernel must launch 2 times a step, on its cluster route, and the
   loss must fall.
9. truncated BPTT: ``fit`` with the example's 50-step window over the same
   T 128 batch (3 windows): 2 launches per window, the (h, c) carry handed
   from each window to the next.
10. sampling: ``CharacterIterator.sample`` of 100 characters through
   ``rnn_time_step`` on the trained net: 2 launches and one readback per
   character; the card's next-character probabilities match the CPU f32
   twin's.
11. the ``kernels`` JSON line, then the ``ok`` JSON line last.

The LSTM kernel (B6) is checked in phase 3 against its plain version on
both of its routes (``LSTM_CASES``): the cluster route at the char-RNN's
shape (T 128, N 64, H 512, bf16) with and without peepholes, masked, and
at N 61; the cooperative route in f32 and in bf16 at H 600. Each launch
must take the route named; each route is timed, beside the cuDNN LSTM
layer (``torch.nn.LSTM``, the same weights) as the yardstick. Phases 8
and 9 must run every LSTM launch on the cluster route, phase 10 (f32) on
the cooperative one. The B4 + B5 line before the ``kernels`` line sets
the flash backward's two kernels against SDPA's whole backward.
"""

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import cuda_lib
from deeplearning4j_tpu_torch.kernels.flash_backward import (
    flash_backward_dkv, flash_backward_dq)
from deeplearning4j_tpu_torch.kernels.flash_forward import (
    flash_forward, flash_forward_plain)
from deeplearning4j_tpu_torch.kernels import lstm as lk
from deeplearning4j_tpu_torch.kernels.shortseq_attention import (
    attention_bwd_plain, attention_fwd_plain, row_delta, short_attention_bwd,
    short_attention_fwd)
from deeplearning4j_tpu_torch.models import (CharacterIterator,
                                             SlotGenerationEngine,
                                             TransformerDecoder,
                                             char_rnn_conf, lm_batch_sparse,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTM
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.observability import (IntegrityConfig,
                                                    NumericalFault)
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.parallel import (EngineSupervisor,
                                               FaultInjector)
from deeplearning4j_tpu_torch.utils import (graph_from_numpy,
                                            network_from_numpy)

#: H100 SXM data-sheet peaks (not measured): HBM bytes/s, dense bf16 FLOP/s
#: on the tensor cores, f32 FLOP/s on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
O_TOL, LSE_TOL = 5e-2, 1e-2
#: relative L2 of a bf16 backward kernel's dq / dk / dv against the plain
#: f32 backward: p and ds round to bf16 (~0.4%) before their products
GRAD_TOL = 2e-2
#: card bf16 train step against the CPU f32 twin on the same 2 rows: the
#: first-step loss (relative) and the relative L2 of four gradients
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 2e-2, 5e-2
#: relative L2 of the card's bf16 kernel-path logits against the CPU f32
#: plain path: bf16 rounds activations and weights (~0.4% each) through
#: every layer; 5e-2 bounds that drift with margin and still catches a
#: wrong attention (which moves the logits by O(1))
LOGIT_REL_TOL = 5e-2
#: max-abs of the LSTM kernel's y, hT and cT against the plain version: in
#: f32 the two sum a gate's H products in other orders (~1e-6 per step,
#: carried through 128 dependent steps); in bf16 both round h and c to
#: bf16 every step, so an order difference can flip a rounding (4e-3 at
#: |h| ~ 1), and the flip carries forward
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: max-abs of the cuDNN LSTM layer against the port's in f32 (TF32 off):
#: a semantics check of the yardstick (gate order, weights), not a bound
CUDNN_AGREE_TOL = 1e-3
#: the char-RNN phases' learning rate. bench.py keeps char_rnn_conf's 0.1:
#: there rmsprop's first step moves every weight by ~0.45 and inflates the
#: l2 term, so the loss cannot be seen to fall in 10 steps; the step's
#: cost does not depend on it
CHARRNN_LR = 0.002
#: next-character probabilities of the card (kernel path, f32) against the
#: CPU f32 twin: summation order only
SAMPLE_PROB_TOL = 1e-4

#: every kernel of the port: its library (csrc/<lib>.cu), the TPU kernel
#: it replaces, its wrapper (which counts launches) and its plain version
KERNELS = {
    "shortseq_attention": {
        "lib": "shortseq_attention",
        "replaces": "deeplearning4j_tpu/kernels/pallas_shortseq.py:127",
        "wrapper": short_attention_fwd, "plain": attention_fwd_plain},
    "flash_forward": {
        "lib": "flash_forward",
        "replaces": "deeplearning4j_tpu/kernels/pallas_attention.py:67",
        "wrapper": flash_forward, "plain": flash_forward_plain},
    "shortseq_attention_bwd": {
        "lib": "shortseq_attention_bwd",
        "replaces": "deeplearning4j_tpu/kernels/pallas_shortseq.py:160",
        "wrapper": short_attention_bwd, "grads": (0, 1, 2)},
    "flash_backward_dq": {
        "lib": "flash_backward",
        "replaces": "deeplearning4j_tpu/kernels/pallas_attention.py:114",
        "wrapper": flash_backward_dq, "grads": (0,)},
    "flash_backward_dkv": {
        "lib": "flash_backward",
        "replaces": "deeplearning4j_tpu/kernels/pallas_attention.py:153",
        "wrapper": flash_backward_dkv, "grads": (1, 2)},
    "lstm_recurrence": {
        "lib": "lstm",
        "replaces": "deeplearning4j_tpu/kernels/lstm.py:42",
        "wrapper": lk.lstm_recurrence_fwd, "plain": lk.lstm_recurrence_plain},
}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, reps: int = 20, batch: int = 10) -> float:
    """Median over ``reps`` samples of the device time per ``fn()`` call in
    ms; each sample brackets ``batch`` back-to-back warm calls with CUDA
    events, so the host's enqueue time hides behind the device's work
    (``batch=1`` keeps host dispatch in, for host-bound paths)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def reset_launches():
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0
    lk.lstm_recurrence_fwd.routes = dict.fromkeys(lk.ROUTES, 0)


def read_launches():
    return {n: s["wrapper"].launches for n, s in KERNELS.items()}


def lstm_routes():
    """B6's launches by route since the last reset_launches()."""
    return dict(lk.lstm_recurrence_fwd.routes)


# ----------------------------------------------------------------- phase 1
def phase_environment() -> str:
    card = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"capability {cap}")
    log(f"card: {card}")
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"the port's kernels are built for sm_90a; "
                           f"device capability is {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------- phase 2
def phase_build():
    t0 = time.perf_counter()
    libs = sorted({spec["lib"] for spec in KERNELS.values()})
    logs = cuda_lib.build(libs)
    log(f"build: {time.perf_counter() - t0:.1f}s wall for {libs} "
        f"(nvcc {' '.join(cuda_lib.NVCC_FLAGS)})")
    for name, info in logs.items():
        log(f"  {name}: nvcc {info['seconds']:.1f}s")
        for kernel, usage in _ptxas_usage(info["log"]):
            log(f"    {kernel}: {usage}")


def _kernel_name(mangled):
    """A mangled kernel symbol as ``name<dtype, int args>``: the first
    length-prefixed identifier ending in "kernel", its 16-bit element type
    and its integer template arguments."""
    idents, i = [], 0
    while i < len(mangled):
        digits = re.match(r"\d+", mangled[i:])
        if digits:
            j = i + len(digits.group())
            idents.append(mangled[j:j + int(digits.group())])
            i = j + int(digits.group())
        else:
            i += 1
    name = next((w for w in idents if w.endswith("kernel")), mangled)
    args = [t for key, t in (("__nv_bfloat16", "bf16"), ("__half", "f16"))
            if key in mangled] + re.findall(r"Li(\d+)E", mangled)
    return f"{name}<{', '.join(args)}>"


def _ptxas_usage(text):
    """(kernel, "registers; spills") per kernel in nvcc's -Xptxas -v
    output."""
    out, kernel, spills = [], "?", ""
    for line in text.splitlines():
        if "Function properties for" in line:
            kernel = _kernel_name(line.split("Function properties for")[-1]
                                  .strip())
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((kernel, f"{line.split(':', 1)[-1].strip()}; "
                                f"{spills}"))
    return out


# ----------------------------------------------------------------- phase 3
def _attention_case(b, h, t, d, lengths, seed):
    """bf16 q/k/v [B*H, T, D] and a prefix key mask [B, T] on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b * h, t, d, generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lengths = np.asarray(lengths)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return q, k, v, torch.from_numpy(mask).cuda()


def _visible_pairs(h, lengths, t):
    """Causal query-key pairs whose key is real, over every head."""
    return sum(int(np.minimum(np.arange(1, t + 1), int(n)).sum())
               for n in lengths) * h


def _bound(q3, h, lengths, t, tensors=4, flop_per_pair=4, row_terms=1,
           masked=True):
    """(bound_ms, bound_by) at the data-sheet peaks: ``tensors`` [BH, T, D]
    tensors, ``row_terms`` [BH, T] f32 rows (lse, delta) and the [B, T]
    mask moved once each, against ``flop_per_pair`` * D FLOP per visible
    query-key pair. The forward moves q, k, v, o and lse and does 4 * D."""
    bh, _, d = q3.shape
    nbytes = tensors * q3.numel() * q3.element_size() + \
        row_terms * bh * t * 4 + (bh // h) * t * 4 * masked
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flop_per_pair * d * _visible_pairs(h, lengths, t) / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernel(name, b, h, t, d, lengths, seed, masked=True):
    """A forward kernel against its plain version on causal bf16 inputs
    with the prefix key mask of ``lengths`` (or none), with its times,
    SDPA's and the bound."""
    spec = KERNELS[name]
    q3, k3, v3, km = _attention_case(b, h, t, d, lengths, seed)
    km = km if masked else None
    o_k, lse_k = spec["wrapper"](q3, k3, v3, km, h, True)
    o_p, lse_p = spec["plain"](q3, k3, v3, km, h, True)
    torch.cuda.synchronize()
    dead = torch.from_numpy(np.repeat(np.asarray(lengths) == 0, h)).cuda()
    live = ~dead
    if not (torch.isfinite(o_k).all() and torch.isfinite(lse_k).all()):
        raise AssertionError(f"{name}: non-finite output")
    err_o = (o_k[live].float() - o_p[live].float()).abs().max().item()
    err_l = (lse_k[live] - lse_p[live]).abs().max().item()
    what = (f"lengths [{min(lengths)}..{max(lengths)}] fully-masked rows "
            f"{int(dead.sum()) * t}" if masked else "unmasked")
    log(f"{name} B={b} H={h} T={t} D={d} bf16 causal {what}: o max-abs "
        f"{err_o:.3e} (tol {O_TOL}), lse max-abs {err_l:.3e} (tol "
        f"{LSE_TOL})")
    if not (err_o <= O_TOL and err_l <= LSE_TOL):
        raise AssertionError(f"{name}: disagrees with its plain version")
    ms = time_ms(lambda: spec["wrapper"](q3, k3, v3, km, h, True))
    plain_ms = time_ms(lambda: spec["plain"](q3, k3, v3, km, h, True))
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q3, k3, v3))
    if masked:
        allowed = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
                   [None, None] & (km > 0)[:, None, None, :])
        sdpa = dict(attn_mask=allowed)
    else:
        sdpa = dict(is_causal=True)
    library_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q4, k4, v4, **sdpa))
    bound_ms, bound_by = _bound(q3, h, lengths, t, masked=masked)
    log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention"
        f"{'' if masked else ', is_causal'}) bound_us "
        f"{bound_ms * 1e3:.1f} ({bound_by})")
    return {"max_abs_err": err_o, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


#: per backward kernel: [BH, T, D] tensors moved (inputs q, k, v, dO and
#: its gradients), and FLOP per visible pair in units of D
BWD_WORK = {"shortseq_attention_bwd": (7, 10), "flash_backward_dq": (5, 6),
            "flash_backward_dkv": (6, 8)}


def _rel_l2(got, want):
    return ((got.float() - want.float()).norm() /
            want.float().norm().clamp_min(1e-30)).item()


def _sdpa_bwd_ms(q3, k3, v3, km, do, b, h, masked):
    """Time of scaled_dot_product_attention's backward (one
    ``torch.autograd.grad`` of q, k and v on a saved graph) on the same
    inputs: with the causal-and-key mask as a boolean ``attn_mask`` and,
    when there is no key mask, also with ``is_causal=True``, which lets
    SDPA take its flash backward. {"attn_mask" / "is_causal": ms}."""
    bh, t, d = q3.shape
    q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_(True)
                  for x in (q3, k3, v3))
    do4 = do.view(b, h, t, d)
    allowed = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    if masked:
        allowed = allowed[None, None] & (km > 0)[:, None, None, :]
    calls = {"attn_mask": dict(attn_mask=allowed)}
    if not masked:
        calls["is_causal"] = dict(is_causal=True)
    out = {}
    for what, kw in calls.items():
        o4 = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4,
                                                              **kw)
        out[what] = time_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), do4, retain_graph=True))
    return out


def check_bwd_kernel(name, b, h, t, d, lengths, seed, masked):
    """A backward kernel against the plain backward on the same (q, k, v,
    o, lse, dO, delta), bitwise equal over two calls, with its times, the
    library backward's (the faster of its two forms, see _sdpa_bwd_ms) and
    the bound."""
    spec = KERNELS[name]
    q3, k3, v3, km = _attention_case(b, h, t, d, lengths, seed)
    km = km if masked else None
    o, lse = attention_fwd_plain(q3, k3, v3, km, h, True)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(q3.shape, generator=g, device="cuda").to(q3.dtype)
    delta = row_delta(do, o)
    args = (q3, k3, v3, km, h, True)
    if name == "shortseq_attention_bwd":
        run = lambda: spec["wrapper"](*args, o, lse, do, delta)
    else:
        run = lambda: spec["wrapper"](*args, do, lse, delta)
    got = run()
    got = got if isinstance(got, tuple) else (got,)
    again = run()
    again = again if isinstance(again, tuple) else (again,)
    want = attention_bwd_plain(*args, o, lse, do, delta)
    torch.cuda.synchronize()
    if not all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(got, again)):
        raise AssertionError(f"{name}: two calls gave different bits")
    live = torch.from_numpy(np.repeat(np.asarray(lengths) > 0, h)).cuda()
    errs = {}
    for gi, x in zip(spec["grads"], got):
        gname = "dq dk dv".split()[gi]
        if not torch.isfinite(x).all():
            raise AssertionError(f"{name}: non-finite {gname}")
        errs[gname] = _rel_l2(x[live], want[gi][live])
    log(f"{name} B={b} H={h} T={t} D={d} bf16 causal "
        f"{'lengths [%d..%d]' % (min(lengths), max(lengths)) if masked else 'unmasked'}"
        f": rel-L2 {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} "
        f"(tol {GRAD_TOL})")
    if not all(e <= GRAD_TOL for e in errs.values()):
        raise AssertionError(f"{name}: disagrees with the plain backward")
    ms = time_ms(run)
    plain_ms = time_ms(lambda: attention_bwd_plain(*args, o, lse, do,
                                                   delta))
    library = _sdpa_bwd_ms(q3, k3, v3, km, do, b, h, masked)
    library_ms = min(library.values())
    tensors, per_pair = BWD_WORK[name]
    bound_ms, bound_by = _bound(q3, h, lengths, t, tensors, per_pair, 2,
                                masked)
    log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention backward, all "
        f"three gradients: "
        f"{', '.join(f'{k} {v:.4f}' for k, v in library.items())}) "
        f"bound_us {bound_ms * 1e3:.1f} ({bound_by}); bitwise equal over "
        f"two calls")
    return {"max_abs_err": max(
                (x[live].float() - want[gi][live].float()).abs().max().item()
                for gi, x in zip(spec["grads"], got)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _lstm_inputs(t, n, h, dtype, peephole, masked, seed):
    """B6's inputs on the card: xw_t [T, N, 4H], R [H, 4H] (scaled so the
    gates stay in range), h0 / c0, peepholes and a [T, N] mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    xw, r = rnd(t, n, 4 * h), rnd(h, 4 * h) / h ** 0.5
    h0, c0 = rnd(n, h) * 0.5, rnd(n, h) * 0.5
    peep = tuple(rnd(h) * 0.1 for _ in range(3)) if peephole else None
    mask = (torch.rand(t, n, generator=g, device="cuda") > 0.2).float() \
        if masked else None
    return (xw.to(dtype), r.to(dtype), h0.to(dtype), c0.to(dtype),
            None if peep is None else tuple(p.to(dtype) for p in peep), mask)


def _lstm_bound(t, n, h, dtype, peephole, masked):
    """(bound_ms, bound_by): xw in, y out, R, h0 / c0 / hT / cT and the
    peepholes (and the f32 mask) moved once, against 2·T·N·H·4H FLOP of
    recurrent products at the dtype's peak (bf16 tensor cores, f32 CUDA
    cores); the gate math is not counted."""
    es = torch.empty((), dtype=dtype).element_size()
    nbytes = es * (t * n * 4 * h + t * n * h + h * 4 * h + 4 * n * h +
                   3 * h * peephole) + 4 * t * n * masked
    t_bytes = nbytes / HBM_BYTES_PER_S
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    t_ops = 2 * t * n * h * 4 * h / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _cudnn_twin(params, n_in, h, dtype):
    """torch.nn.LSTM (cuDNN; no peepholes, gate order [i, f, g, o] as the
    port's) loaded with an LSTM layer's W, R and b."""
    ref = torch.nn.LSTM(n_in, h, batch_first=True).cuda()
    with torch.no_grad():
        ref.weight_ih_l0.copy_(params["W"].T)
        ref.weight_hh_l0.copy_(params["R"].T)
        ref.bias_ih_l0.copy_(params["b"])
        ref.bias_hh_l0.zero_()
    ref = ref.to(dtype)
    ref.flatten_parameters()      # one weight buffer, as cuDNN wants it
    return ref


def _lstm_check(t, n, h, dtype, peep, masked, seed, route):
    """B6 on one case against its plain version; the launch must take
    ``route``. Returns the max-abs error."""
    args = _lstm_inputs(t, n, h, dtype, peep, masked, seed)
    before = lstm_routes()
    got = lk.lstm_recurrence_fwd(*args)
    took = [r for r, c in lstm_routes().items() if c != before[r]]
    want = lk.lstm_recurrence_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in got):
        raise AssertionError("lstm_recurrence: non-finite output")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    log(f"lstm_recurrence T={t} N={n} H={h} {str(dtype)[6:]} "
        f"peepholes {peep} masked {masked}: route {took}, y/hT/cT max-abs "
        f"{err:.3e} (tol {LSTM_TOL[dtype]})")
    if took != [route]:
        raise AssertionError(f"lstm_recurrence took route {took}, expected "
                             f"{route}")
    if not err <= LSTM_TOL[dtype]:
        raise AssertionError("lstm_recurrence: disagrees with its plain "
                             "version")
    return err


#: B6's cases: (T, N, H, dtype, peepholes, masked, route). The cluster
#: route at the char-RNN shape (bf16), with and without peepholes, masked,
#: and with N not a multiple of a cluster's rows; the cooperative route in
#: f32 and at a bf16 width the cluster route does not take (H > 512)
LSTM_CASES = [
    (128, 64, 512, torch.bfloat16, False, False, "cluster"),
    (128, 64, 512, torch.bfloat16, True, False, "cluster"),
    (128, 64, 512, torch.bfloat16, True, True, "cluster"),
    (128, 61, 512, torch.bfloat16, True, True, "cluster"),
    (128, 64, 512, torch.float32, False, False, "cooperative"),
    (128, 64, 512, torch.float32, True, False, "cooperative"),
    (128, 64, 600, torch.bfloat16, True, False, "cooperative"),
]


def check_lstm_kernel(t=128, n=64, h=512):
    """B6 against its plain version on both routes (LSTM_CASES), then its
    time on each route, the plain version's and the layer-level
    comparison with cuDNN."""
    errs = {}
    for i, case in enumerate(LSTM_CASES):
        errs[case[:6]] = _lstm_check(*case[:6], 31 + i, case[6])
    log(f"  launch plans: {lk.lstm_plan(n, h, torch.bfloat16)} (bf16), "
        f"{lk.lstm_plan(n, 600, torch.bfloat16)} (bf16, H 600), "
        f"{lk.lstm_plan(1, h, torch.float32)} (f32, N=1)")
    # the main path's case: the char-RNN's GravesLSTM, bf16, unmasked
    args = _lstm_inputs(t, n, h, torch.bfloat16, True, False, 32)
    ms = time_ms(lambda: lk.lstm_recurrence_fwd(*args))
    plain_ms = time_ms(lambda: lk.lstm_recurrence_plain(*args), warmup=1,
                       reps=5, batch=2)
    f32_args = _lstm_inputs(t, n, h, torch.float32, True, False, 33)
    f32_ms = time_ms(lambda: lk.lstm_recurrence_fwd(*f32_args))
    wide_args = _lstm_inputs(t, n, 600, torch.bfloat16, True, False, 36)
    wide_ms = time_ms(lambda: lk.lstm_recurrence_fwd(*wide_args))
    bound_ms, bound_by = _lstm_bound(t, n, h, torch.bfloat16, True, False)
    f32_bound, _ = _lstm_bound(t, n, h, torch.float32, True, False)
    wide_bound, _ = _lstm_bound(t, n, 600, torch.bfloat16, True, False)
    # layer level: the port's LSTM layer (input projection + B6) against
    # cuDNN's with the same weights; agreement checked in f32
    layer = GravesLSTM(n_in=h, n_out=h, activation="tanh", peephole=False)
    params = layer.init_params(torch.Generator(device="cuda").manual_seed(34))
    x = torch.randn(n, t, h, generator=torch.Generator(device="cuda")
                    .manual_seed(35), device="cuda")
    with torch.no_grad():
        ref32 = _cudnn_twin(params, h, h, torch.float32)
        agree = (ref32(x)[0] - layer.forward(params, {}, x)[0]).abs().max() \
            .item()
        library_f32_ms = time_ms(lambda: ref32(x))
        layer_f32_ms = time_ms(lambda: layer.forward(params, {}, x))
        ref = _cudnn_twin(params, h, h, torch.bfloat16)
        p16 = {k: v.bfloat16() for k, v in params.items()}
        x16 = x.bfloat16()
        library_ms = time_ms(lambda: ref(x16))
        layer_ms = time_ms(lambda: layer.forward(p16, {}, x16))
        peep_layer = GravesLSTM(n_in=h, n_out=h, activation="tanh")
        pp16 = dict(p16, **{k: torch.zeros(h, device="cuda",
                                           dtype=torch.bfloat16)
                            for k in ("pi", "pf", "po")})
        peep_layer_ms = time_ms(lambda: peep_layer.forward(pp16, {}, x16))
    log(f"  cuDNN LSTM layer vs the port's LSTM layer, f32: max-abs "
        f"{agree:.3e} (tol {CUDNN_AGREE_TOL})")
    if not agree <= CUDNN_AGREE_TOL:
        raise AssertionError("the cuDNN yardstick computes another function")
    log(f"  kernel_ms {ms:.4f} (cluster route, bf16, {ms / t * 1e3:.2f} us "
        f"a step; cooperative route: f32 {f32_ms:.4f}, bf16 H 600 "
        f"{wide_ms:.4f}) plain_ms {plain_ms:.4f} bound_us "
        f"{bound_ms * 1e3:.1f} ({bound_by}; f32 {f32_bound * 1e3:.1f}, bf16 "
        f"H 600 {wide_bound * 1e3:.1f}) | layer (projection + recurrence, "
        f"nIn {h}, bf16): cuDNN {library_ms:.4f} ms, port {layer_ms:.4f} ms "
        f"(peepholes {peep_layer_ms:.4f} ms); f32: cuDNN "
        f"{library_f32_ms:.4f} ms, port {layer_f32_ms:.4f} ms")
    return {"max_abs_err": errs[(t, n, h, torch.bfloat16, True, False)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms}


def time_short_main_shapes():
    """B1 at the two other shapes the main path gives it, checked and timed
    as in check_kernel: the flagship train step's (B 32, T 512, no key
    mask, as fit_batch runs it) and a serving admission's (8 rows, bucket
    512, prefix key mask of 200-512 tokens). Returns a summary line each."""
    lines = []
    for what, b, lengths, masked in (
            ("train step (B 32, unmasked)", 32, [512] * 32, False),
            ("serving admission (8 rows, bucket 512)", 8,
             np.random.default_rng(7).integers(200, 513, 8), True)):
        r = check_kernel("shortseq_attention", b, 12, 512, 64, lengths, 8,
                         masked)
        lines.append(f"shortseq_attention at the {what}: kernel_ms "
                     f"{r['ms']:.4f} library_ms {r['library_ms']:.4f} "
                     f"bound_us {r['bound_ms'] * 1e3:.1f} ({r['bound_by']})")
    return lines


def phase_kernel_checks():
    rng = np.random.default_rng(0)
    # B1 at the flagship prefill: one length-1 row, one fully masked row
    lens = rng.integers(2, 513, 32)
    lens[0], lens[1] = 1, 0
    short = check_kernel("shortseq_attention", 32, 12, 512, 64, lens, 1)
    short["main_shapes"] = time_short_main_shapes()
    # B3 at T = 2048 and at the ragged T = 577 (one fully masked row)
    flash = check_kernel("flash_forward", 4, 12, 2048, 64,
                         [2048, 1536, 777, 1], 2)
    check_kernel("flash_forward", 4, 12, 577, 64, [577, 300, 1, 0], 3)
    measured = {"shortseq_attention": short, "flash_forward": flash}
    # B2 at the flagship train step (unmasked, timed) and ragged with a
    # length-1 and a fully masked row; B4 / B5 at the long-context train
    # step (unmasked, timed) and at the ragged T = 577
    measured["shortseq_attention_bwd"] = check_bwd_kernel(
        "shortseq_attention_bwd", 32, 12, 512, 64, [512] * 32, 4, False)
    check_bwd_kernel("shortseq_attention_bwd", 32, 12, 512, 64, lens, 5,
                     True)
    for name in ("flash_backward_dq", "flash_backward_dkv"):
        measured[name] = check_bwd_kernel(name, 4, 12, 2048, 64,
                                          [2048] * 4, 6, False)
        check_bwd_kernel(name, 4, 12, 577, 64, [577, 300, 1, 0], 7, True)
    dq, dkv = measured["flash_backward_dq"], measured["flash_backward_dkv"]
    short["main_shapes"].append(
        f"flash backward at B 4, H 12, T 2048, D 64 causal: B4 "
        f"{dq['ms']:.4f} ms + B5 {dkv['ms']:.4f} ms = "
        f"{dq['ms'] + dkv['ms']:.4f} ms; SDPA's whole backward in this run "
        f"{dq['library_ms']:.4f} / {dkv['library_ms']:.4f} ms (B4 alone "
        f"{dq['ms'] / dq['library_ms']:.2f}x, B4 + B5 "
        f"{(dq['ms'] + dkv['ms']) / dkv['library_ms']:.2f}x)")
    measured["lstm_recurrence"] = check_lstm_kernel()
    return measured


# ----------------------------------------------------------------- phase 4
def _cpu_twin(net):
    """The same configuration and weights on the CPU in f32 (plain path)."""
    return graph_from_numpy(net.conf, {
        v: {k: a.cpu().numpy() for k, a in p.items()}
        for v, p in net.params.items()}, device="cpu")


def _padded(prompts, tp):
    tokens = np.zeros((len(prompts), tp), np.int64)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    return tokens, np.asarray([len(p) for p in prompts], np.int64)


def check_logits(net, prompts, tp, what):
    """Prefill next-token logits on the card (kernel path, bf16) against
    the CPU f32 plain path; raises above LOGIT_REL_TOL."""
    tokens, lengths = _padded(prompts, tp)
    dec = TransformerDecoder(net)
    _, got, _ = dec.prefill(dec.init_cache(len(prompts)), tokens, lengths)
    ref_dec = TransformerDecoder(_cpu_twin(net))
    _, want, _ = ref_dec.prefill(ref_dec.init_cache(len(prompts)), tokens,
                                 lengths)
    got = got.cpu().double()
    want = want.double()
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    log(f"{what}: prefill logits rel-L2 card bf16 vs CPU f32 = {rel:.3e} "
        f"(tol {LOGIT_REL_TOL}), argmax agree {same}")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError(f"{what}: card logits disagree with the CPU "
                             "reference")


def phase_serving(card):
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=12, max_length=577)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(200, 513, 16)]
    new_tokens = 64
    engine = SlotGenerationEngine(net, num_slots=8, block_size=4)
    # warm the engine's programs once, outside the counted run
    engine.submit(prompts[0][:64], 4)
    engine.run_until_drained()
    torch.cuda.synchronize()

    reset_launches()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    stats0 = engine.stats()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = {k: v - stats0.get(k, 0) for k, v in engine.stats().items()}
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0

    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        if len(out) != len(p) + new_tokens or not (out[:len(p)] == p).all():
            raise AssertionError(f"request returned {len(out)} tokens, "
                                 f"expected {len(p) + new_tokens}")
    n_layers = 12
    log(f"serving: {len(reqs)} requests completed, {stats['completed']} "
        f"counted; admissions {stats['prefill_batches']}, decode blocks "
        f"{stats['decode_blocks']}, decode readbacks {fetched}, kernel "
        f"launches {launches}")
    if launches["shortseq_attention"] < n_layers * stats["prefill_batches"]:
        raise AssertionError("the short-sequence kernel did not launch on "
                             "every admission")
    if fetched > stats["decode_blocks"]:
        raise AssertionError("more than one readback per decode block")
    gen_tokens = len(reqs) * new_tokens
    log(f"serving [{card}]: engine end-to-end {gen_tokens / wall:.1f} "
        f"generated tok/s ({wall:.2f}s for {len(reqs)} requests)")

    # prefill and decode rates of the decoder alone, 8 rows
    dec = engine.decoder
    tokens, lengths = _padded(prompts[:8], 512)
    caches = dec.init_cache(8)
    pre_ms = time_ms(lambda: dec.prefill(caches, tokens, lengths),
                     warmup=2, reps=5, batch=1)
    log(f"serving [{card}]: prefill {lengths.sum() / pre_ms * 1e3:.0f} "
        f"prompt tok/s (8 prompts, bucket 512, {pre_ms:.2f} ms)")
    ids = np.zeros(8, np.int64)
    pos = lengths.copy()

    def blocks():
        for i in range(16):
            dec.decode_block(caches, ids, pos + 4 * i, block_size=4)
    dec_ms = time_ms(blocks, warmup=1, reps=3, batch=1)
    log(f"serving [{card}]: decode {8 * 64 / dec_ms * 1e3:.0f} tok/s "
        f"(8 slots, 16 blocks of K=4, {dec_ms / 64:.2f} ms per step)")

    check_logits(net, [prompts[1], prompts[2]], 512, "flagship 12-layer")
    return launches["shortseq_attention"], net


# ---------------------------------------------------------------- phase 4b
#: the paged phase's engine context: page_size 16 divides it, 36 pages a
#: slot; the embedding's max_length is 577
PAGED_T_MAX = 576
PAGE_SIZE = 16


def _rel_l2_rows(got, want):
    got, want = got.cpu().double(), want.cpu().double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _drive(engine, prompts, new_tokens):
    """Serve ``prompts`` to the end, sampling before every decode cycle
    the active slots and (paged) the page accounting. Returns (requests,
    wall s, stats delta, decode readbacks, peak active slots, page stats
    at the most pages mapped)."""
    peak = {"active": 0, "kv": None}
    step = engine._step

    def sampling_step():
        peak["active"] = max(peak["active"], engine.stats()["active_slots"])
        kv = engine.kv_page_stats()
        if kv is not None and (peak["kv"] is None or
                               kv["mapped"] > peak["kv"]["mapped"]):
            peak["kv"] = kv
        step()

    engine._step = sampling_step
    stats0 = engine.stats()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, new_tokens) for p in prompts]
    engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine._step = step
    stats = {k: v - stats0.get(k, 0) for k, v in engine.stats().items()}
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0
    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        if len(out) != len(p) + new_tokens or not (out[:len(p)] == p).all():
            raise AssertionError(f"request returned {len(out)} tokens, "
                                 f"expected {len(p) + new_tokens}")
    if fetched > stats["decode_blocks"]:
        raise AssertionError(f"{fetched} decode readbacks for "
                             f"{stats['decode_blocks']} decode blocks")
    return reqs, wall, stats, fetched, peak["active"], peak["kv"]


def _audit(engine, what):
    problems = engine._pager.audit(engine._slot_pages)
    if problems:
        raise AssertionError(f"{what}: page audit failed: {problems[:4]}")
    if engine.kv_page_stats()["mapped"]:
        raise AssertionError(f"{what}: pages left mapped after the drain")


def check_paged_hit_logits(net, prefix, tail):
    """First-token logits of a prefix-cache hit on the card (the prefix
    prefilled into pages, then the tail on top of them; bf16, plain
    paged attention) against the whole prompt through the CPU f32 twin;
    raises above LOGIT_REL_TOL."""
    dec = TransformerDecoder(net, t_max=PAGED_T_MAX)
    pool = dec.init_paged_pool(PAGED_T_MAX // PAGE_SIZE + 1, PAGE_SIZE)
    ptab = np.arange(1, PAGED_T_MAX // PAGE_SIZE + 1)[None]
    dec.paged_prefill(pool, prefix[None], [0], [len(prefix)], ptab)
    tokens = np.zeros((1, 256), np.int64)
    tokens[0, :len(tail)] = tail
    _, got, _ = dec.paged_prefill(pool, tokens, [len(prefix)], [len(tail)],
                                  ptab)
    prompt = np.concatenate([prefix, tail])
    ref = TransformerDecoder(_cpu_twin(net), t_max=PAGED_T_MAX)
    full, lengths = _padded([prompt], 512)
    _, want, _ = ref.prefill(ref.init_cache(1), full, lengths)
    rel = _rel_l2_rows(got, want)
    same = bool(got.argmax(-1).item() == want.argmax(-1).item())
    log(f"paged prefix hit: first-token logits rel-L2 card bf16 vs CPU "
        f"f32 = {rel:.3e} (tol {LOGIT_REL_TOL}), argmax agree {same}")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError("paged hit logits disagree with the CPU "
                             "reference")


def check_verify_logits(net, prompts):
    """verify_block's window logits against decode_block's (decode_step
    after decode_step) at the same positions, from identical slab caches;
    raises above LOGIT_REL_TOL."""
    dec = TransformerDecoder(net, t_max=PAGED_T_MAX)
    tokens, lengths = _padded(prompts, 256)
    ids0, _, caches = dec.prefill(dec.init_cache(len(prompts)), tokens,
                                  lengths)
    twin = {n: {kk: t.clone() for kk, t in kv.items()}
            for n, kv in caches.items()}
    ids, steps, emitted = ids0, [], []
    for j in range(5):
        ids, logits, caches = dec.decode_step(caches, ids, lengths + j)
        steps.append(logits)
        emitted.append(ids)
    draft = torch.stack(emitted[:4], dim=1)
    window = torch.cat([ids0[:, None], draft], dim=1)
    pos = torch.as_tensor(lengths, device=ids0.device)
    with torch.no_grad():
        got = dec._walk_window(dec._device_params(),
                               net._inference_state(), twin, window, pos,
                               torch.full_like(pos, 5))
    rel = max(_rel_l2_rows(got[:, j], steps[j]) for j in range(5))
    log(f"speculation: verify window logits vs decode_block's, rel-L2 "
        f"{rel:.3e} over 5 positions x {len(prompts)} rows (tol "
        f"{LOGIT_REL_TOL})")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError("verify window logits disagree with "
                             "decode_block's")


def phase_paged_serving(card, net):
    """The flagship net behind paged and speculative engines: prefix
    sharing, concurrency at the slab's bytes, speculation slab and paged
    with the same requests decoded plainly in the same call."""
    rng = np.random.default_rng(21)
    new_tokens = 64
    reset_launches()

    # -- prefix sharing: one 256-token prefix (16 full pages), 16 tails
    prefix = rng.integers(0, 32000, 256)
    prompts = [np.concatenate([prefix, rng.integers(0, 32000, int(n))])
               for n in rng.integers(64, 257, 16)]
    engine = SlotGenerationEngine(net, num_slots=8, block_size=4,
                                  t_max=PAGED_T_MAX, paged=True,
                                  page_size=PAGE_SIZE)
    engine.submit(np.concatenate([prefix, rng.integers(0, 32000, 64)]), 4)
    engine.run_until_drained()              # warm: publishes the prefix
    _, wall, st, fetched, _, kv = _drive(engine, prompts, new_tokens)
    log(f"paged prefix [{card}]: 16 requests (256-token shared prefix + "
        f"64-256-token tails, 64 new, 8 slots, K=4, {engine.num_pages} "
        f"pages of {PAGE_SIZE}): prefix hits {st['prefix_cache_hits']}, "
        f"misses {st['prefix_cache_misses']}, hit tokens "
        f"{st['prefix_cache_hit_tokens']}; engine "
        f"{16 * new_tokens / wall:.1f} generated tok/s ({wall:.2f}s); "
        f"readbacks {fetched} for {st['decode_blocks']} decode blocks "
        f"({fetched / st['decode_blocks']:.3f} a block); at the most pages "
        f"mapped: {kv['mapped']} mapped, {kv['shared']} shared, "
        f"fragmentation {kv['fragmentation']}, pool "
        f"{kv['pool_bytes'] / 2**20:.1f} MiB")
    if st["prefix_cache_hit_tokens"] < 15 * 256:
        raise AssertionError(f"prefix hit tokens "
                             f"{st['prefix_cache_hit_tokens']} < 15 x 256")
    _audit(engine, "paged prefix")
    check_paged_hit_logits(net, prefix, prompts[0][256:])

    # prefill rates in this call: 8 tails of 256 on the shared prefix's
    # pages against the slab's prefill of the same 8 whole prompts
    dec = engine.decoder
    n_pp = PAGED_T_MAX // PAGE_SIZE
    pool = dec.init_paged_pool(8 * n_pp + 1, PAGE_SIZE)
    dec.paged_prefill(pool, prefix[None], [0], [256],
                      np.arange(1, n_pp + 1)[None])
    tails = np.stack([rng.integers(0, 32000, 256) for _ in range(8)])
    ptab = np.zeros((8, n_pp), np.int64)
    ptab[:, :16] = np.arange(1, 17)
    ptab[:, 16:32] = n_pp + 1 + np.arange(8 * 16).reshape(8, 16)
    full = np.concatenate([np.tile(prefix, (8, 1)), tails], axis=1)
    tail_ms = time_ms(lambda: dec.paged_prefill(
        pool, tails, np.full(8, 256), np.full(8, 256), ptab),
        warmup=2, reps=5, batch=1)
    slab_caches = dec.init_cache(8)
    slab_ms = time_ms(lambda: dec.prefill(slab_caches, full,
                                          np.full(8, 512)),
                      warmup=2, reps=5, batch=1)
    log(f"paged prefix [{card}]: prefill of 8 x 256-token tails on the "
        f"shared pages {tail_ms:.2f} ms ({8 * 256 / tail_ms * 1e3:.0f} "
        f"tail tok/s, {8 * 512 / tail_ms * 1e3:.0f} prompt tok/s served); "
        f"slab prefill of the 8 whole 512-token prompts {slab_ms:.2f} ms "
        f"({8 * 512 / slab_ms * 1e3:.0f} prompt tok/s)")
    profile_step(lambda: dec.paged_prefill(
        pool, tails, np.full(8, 256), np.full(8, 256), ptab),
        "paged tail prefill (8 x 256 tokens on 256 shared)")
    profile_step(lambda: dec.prefill(slab_caches, full, np.full(8, 512)),
                 "slab prefill (8 x 512 tokens)")
    ids = np.zeros(8, np.int64)
    profile_step(lambda: dec.paged_decode_block(
        pool, ptab, ids, np.full(8, 500), block_size=4),
        "paged decode block (8 lanes at 500, K=4)")
    profile_step(lambda: dec.decode_block(
        slab_caches, ids, np.full(8, 500), block_size=4),
        "slab decode block (8 lanes at 500, K=4)")

    # -- concurrency at the 8-slot slab's bytes
    engine = SlotGenerationEngine(net, num_slots=32, block_size=4,
                                  t_max=PAGED_T_MAX, paged=True,
                                  page_size=PAGE_SIZE,
                                  num_pages=8 * n_pp + 1)
    slab_bytes = sum(t.numel() * t.element_size()
                     for kv_ in slab_caches.values() for t in kv_.values())
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(32, 65, 32)]
    _, wall, st, fetched, peak, kv = _drive(engine, prompts, new_tokens)
    log(f"paged concurrency [{card}]: 32 requests (32-64-token prompts, "
        f"64 new) on {engine.num_pages} pages ({engine._pool_bytes()} "
        f"bytes; the 8-slot slab {slab_bytes}): peak active slots {peak} "
        f"(bar 24 = 3 x the slab's 8), most pages mapped {kv['mapped']}, "
        f"preempted {st['page_preempted']}; engine "
        f"{32 * new_tokens / wall:.1f} generated tok/s ({wall:.2f}s); "
        f"readbacks {fetched} for {st['decode_blocks']} blocks")
    if peak < 24:
        raise AssertionError(f"peak active slots {peak} < 24")
    _audit(engine, "paged concurrency")

    # -- speculation: 256-token prompts repeating a 32-token motif
    prompts = [np.tile(rng.integers(0, 32000, 32), 8) for _ in range(8)]
    # each cache: plain blocks, the default speculative engine (with
    # random weights acceptance is low, so it soon falls back to plain
    # blocks), and one that never falls back (spec_threshold 0: every
    # block is a verify block)
    rates, outs = {}, {}
    for paged in (False, True):
        for mode in ("off", "on", "always"):
            kw = dict(paged=True, page_size=PAGE_SIZE) if paged else {}
            if mode != "off":
                kw.update(speculative=True, spec_k=4)
            if mode == "always":
                kw.update(spec_threshold=0.0)
            engine = SlotGenerationEngine(net, num_slots=8, block_size=4,
                                          t_max=PAGED_T_MAX, **kw)
            engine.submit(prompts[0][:64], 4)
            engine.run_until_drained()          # warm
            reqs, wall, st, fetched, _, _ = _drive(engine, prompts,
                                                   new_tokens)
            what = f"{'paged' if paged else 'slab'} spec {mode}"
            rates[what] = 8 * new_tokens / wall
            outs[what] = [r.result(0) for r in reqs]
            line = (f"speculation [{card}]: {what}: "
                    f"{rates[what]:.1f} generated tok/s ({wall:.2f}s), "
                    f"{st['decode_blocks']} decode blocks, readbacks "
                    f"{fetched}")
            if mode != "off":
                if not st["spec_blocks"]:
                    raise AssertionError(f"{what}: no verify block ran")
                line += (f"; {st['spec_blocks']} verify blocks, acceptance "
                         f"{st['spec_accepted_tokens']}/"
                         f"{st['spec_drafted']} = "
                         f"{st['spec_accepted_tokens'] / st['spec_drafted']:.3f}"
                         f", {st['spec_emitted_tokens'] / st['spec_blocks']:.2f}"
                         f" tokens emitted a verify block (8 lanes), "
                         f"fallback blocks {st['spec_fallbacks']}")
            log(line)
            if paged:
                _audit(engine, what)
    for paged in ("slab", "paged"):
        for mode in ("on", "always"):
            same = sum((a == b).all() for a, b in zip(
                outs[f"{paged} spec {mode}"], outs[f"{paged} spec off"]))
            log(f"speculation [{card}]: {paged} spec {mode} / off "
                f"{rates[f'{paged} spec {mode}'] / rates[f'{paged} spec off']:.3f}"
                f"x generated tok/s; {same}/8 outputs identical (bf16 "
                "verify windows and decode steps round differently: not a "
                "gate)")
    check_verify_logits(net, prompts)
    launches = read_launches()
    log(f"paged phase: kernel launches {launches} (paged admissions and "
        "every cache seam run plain attention; the slab engines' "
        "admissions run the short-sequence kernel)")
    if launches["shortseq_attention"] < 12:
        raise AssertionError("the slab engines' admissions did not launch "
                             "the short-sequence kernel")


# ---------------------------------------------------------------- phase 4c
#: phase 4c's window and the sentinel its timed engines run with (no page
#: verification: its readbacks would sit in the timings)
TIER_CHUNK = 128
SENTINEL = IntegrityConfig(kv_verify=False)


def _tier_engine(net, dec, **kw):
    """An engine of the tier as phase 4c times it: EDF, adaptive K and
    the sentinel (``dec`` must be a sentinel decoder)."""
    kw.setdefault("num_slots", 8)
    kw.setdefault("integrity", SENTINEL)
    return SlotGenerationEngine(net, decoder=dec, t_max=PAGED_T_MAX,
                                scheduling="edf", adaptive_block=True, **kw)


def _serve(engine, hook=None):
    """run_until_drained's loop with ``hook()`` after every admission and
    every cycle."""
    while True:
        engine._sweep_pending()
        engine._admit()
        if hook is not None:
            hook()
        if not engine._any_active():
            if not engine._pending:
                return
            continue
        engine._step()
        if hook is not None:
            hook()


def _stall_run(net, dec, paged, chunk, shorts, longs, warm):
    """8 short requests decoding (256 new tokens) when 4 long ones (16
    new) arrive, after the ``warm`` prompts (a long and a short one, no
    prefix shared with the measured ones). Returns (longest and median gap between decode-block
    retirements that carried a short lane, from the longs' arrival until
    the last long's first token; the longs' times to first token; decode
    readbacks, decode blocks)."""
    kw = dict(paged=True, page_size=PAGE_SIZE) if paged else {}
    engine = _tier_engine(net, dec, num_slots=12, prefill_chunk=chunk, **kw)
    for p in warm:
        engine.submit(p, 4)
    engine.run_until_drained()              # warm both prefill paths
    short_reqs = [engine.submit(p, 256) for p in shorts]
    retires = []
    retire = engine._retire_block

    def timed_retire(block):
        retire(block)
        if any(r in short_reqs for _, r in block[1]):
            retires.append(time.perf_counter())
    engine._retire_block = timed_retire
    engine._sweep_pending()
    engine._admit()
    for _ in range(4):                      # the shorts are decoding
        engine._step()
    torch.cuda.synchronize()
    stats0 = engine.stats()
    fetched0 = fetch_counts("engine.decode")["engine.decode"]
    t_sub = time.perf_counter()
    long_reqs = [engine.submit(p, 16) for p in longs]
    ttft = {}

    def first_tokens():
        now = time.perf_counter()
        for i, r in enumerate(long_reqs):
            if i not in ttft and r.generated:
                ttft[i] = now - t_sub
    _serve(engine, first_tokens)
    torch.cuda.synchronize()
    for p, r in zip(shorts + longs, short_reqs + long_reqs):
        want = len(p) + (256 if r in short_reqs else 16)
        if len(r.result(timeout=0)) != want:
            raise AssertionError(f"a request returned "
                                 f"{len(r.result(timeout=0))} tokens, "
                                 f"expected {want}")
    st = {k: v - stats0.get(k, 0) for k, v in engine.stats().items()}
    fetched = fetch_counts("engine.decode")["engine.decode"] - fetched0
    if fetched > st["decode_blocks"]:
        raise AssertionError(f"{fetched} decode readbacks for "
                             f"{st['decode_blocks']} decode blocks")
    if paged:
        _audit(engine, "stall run")
    t_last = t_sub + max(ttft.values())
    window = [t_sub] + [t for t in retires if t_sub < t]
    window = [t for t in window if t <= t_last] + \
        [t for t in window if t > t_last][:1]
    gaps = np.diff(window) * 1e3
    return (float(gaps.max()), float(np.median(gaps)),
            sorted(v * 1e3 for v in ttft.values()), fetched,
            st["decode_blocks"], st["prefill_chunks"])


def check_chunk_logits(net, dec, prompt):
    """A prompt's next-token logits after windows of TIER_CHUNK (one slab
    row through ``prefill_chunk``, and pages through ``paged_prefill``)
    against the whole prompt's prefill on the card (B1) and through the
    CPU f32 twin; raises above LOGIT_REL_TOL."""
    n = len(prompt)
    full, lengths = _padded([prompt], 512)
    _, whole, _ = dec.prefill(dec.init_cache(1), full, lengths)
    ref = TransformerDecoder(_cpu_twin(net), t_max=PAGED_T_MAX)
    _, twin, _ = ref.prefill(ref.init_cache(1), full, lengths)
    slab = dec.init_cache(1)
    n_pp = PAGED_T_MAX // PAGE_SIZE
    pool = dec.init_paged_pool(n_pp + 1, PAGE_SIZE)
    ptab = np.arange(1, n_pp + 1)[None]
    for pos0 in range(0, n, TIER_CHUNK):
        window = np.zeros((1, TIER_CHUNK), np.int64)
        valid = min(TIER_CHUNK, n - pos0)
        window[0, :valid] = prompt[pos0:pos0 + valid]
        _, got_slab, slab = dec.prefill_chunk(slab, window, pos0, valid, 0)
        _, got_paged, pool = dec.paged_prefill(pool, window, [pos0],
                                               [valid], ptab)
    errs = {f"{what} vs {against}": _rel_l2_rows(got, want)
            for what, got in (("slab windows", got_slab),
                              ("paged windows", got_paged))
            for against, want in (("card whole", whole),
                                  ("CPU f32", twin))}
    log(f"chunked prefill: final-window logits rel-L2 "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol "
        f"{LOGIT_REL_TOL}; {n} tokens, windows of {TIER_CHUNK})")
    if not all(np.isfinite(v) and v <= LOGIT_REL_TOL
               for v in errs.values()):
        raise AssertionError("chunked-prefill logits disagree")


def check_recompute(net, dec, rng):
    """recompute_logits on 8 rows of 512: one B1 launch a layer, logits
    as the cached prefill's."""
    tokens = rng.integers(0, 32000, (8, 512))
    lengths = np.full(8, 512)
    torch.cuda.synchronize()
    reset_launches()
    _, got = dec.recompute_logits(tokens, lengths)
    torch.cuda.synchronize()
    launched = read_launches()["shortseq_attention"]
    _, want, _ = dec.prefill(dec.init_cache(8), tokens, lengths)
    rel = _rel_l2_rows(got, want)
    rec_ms = time_ms(lambda: dec.recompute_logits(tokens, lengths),
                     warmup=1, reps=5, batch=1)
    caches = dec.init_cache(8)
    pre_ms = time_ms(lambda: dec.prefill(caches, tokens, lengths),
                     warmup=1, reps=5, batch=1)
    log(f"recompute_logits: 8 x 512, B1 launches {launched} (12 layers), "
        f"logits rel-L2 vs the cached prefill {rel:.3e} (tol "
        f"{LOGIT_REL_TOL}); {rec_ms:.2f} ms against the prefill's "
        f"{pre_ms:.2f} ms")
    if launched != 12:
        raise AssertionError(f"recompute_logits launched B1 {launched} "
                             "times, expected 12")
    if not (np.isfinite(rel) and rel <= LOGIT_REL_TOL):
        raise AssertionError("recompute logits disagree with the prefill's")


def _burst(card, net, dec, rng):
    """32 requests with mixed deadlines, EDF, headroom shedding, 4
    cancelled mid-decode, on a paged engine."""
    engine = _tier_engine(net, dec, paged=True, page_size=PAGE_SIZE,
                          shed_headroom=True)
    engine.submit(rng.integers(0, 32000, 64), 16)
    engine.submit(rng.integers(0, 32000, 128), 16)
    engine.run_until_drained()              # warm: the latency averages
    ks, lat = [], []
    choose, retire = engine._choose_block_size, engine._retire_block

    def recording_choose():
        ks.append(choose())
        return ks[-1]

    def timed_retire(block):
        retire(block)
        lat.append((time.perf_counter() - block[3]) * 1e3)
    engine._choose_block_size = recording_choose
    engine._retire_block = timed_retire
    deadlines = [None, 60.0, 3.0, 0.05] * 8
    reqs = [engine.submit(rng.integers(0, 32000, int(rng.integers(32, 257))),
                          int(rng.integers(32, 97)), deadline=d)
            for d in deadlines]
    targets = [r for r, d in zip(reqs, deadlines) if d is None][:4]

    def cancel_mid_decode():
        for r in targets:
            if len(r.generated) >= 2 and not r.done() and \
                    not r._cancel_requested:
                r.cancel()
    t0 = time.perf_counter()
    _serve(engine, cancel_mid_decode)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats()
    states = {}
    for r in reqs:
        states[r.state] = states.get(r.state, 0) + 1
    k_hist = {k: ks.count(k) for k in sorted(set(ks))}
    log(f"deadlines [{card}]: 32 requests (deadlines none / 60 s / 3 s / "
        f"0.05 s, 4 cancelled mid-decode), EDF, headroom shedding: "
        f"{states}; headroom_shed {st['headroom_shed']}, "
        f"deadline_exceeded {st['deadline_exceeded']}, cancelled "
        f"{st['cancelled']}, completed {st['completed'] - 2}; {wall:.2f}s")
    log(f"adaptive K [{card}]: blocks by K {k_hist}; block latency "
        f"(dispatch to retire) median {np.median(lat):.2f} ms, max "
        f"{max(lat):.2f} ms against block_latency_target "
        f"{engine.block_latency_target * 1e3:.0f} ms")
    if not all(r.done() for r in reqs):
        raise AssertionError("a request of the burst never ended")
    if st["cancelled"] != 4 or any(r.state != r.CANCELLED for r in targets):
        raise AssertionError(f"cancelled {st['cancelled']}, expected the 4 "
                             "targets")
    if st["headroom_shed"] < 1:
        raise AssertionError("no infeasible request was shed by headroom")
    if engine._any_active() or engine.stats()["queue_depth"]:
        raise AssertionError("a slot or a queued request is left over")
    _audit(engine, "deadline burst")


def _sentinel_checks(card, net, dec_s, rng):
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(64, 257, 8)]
    plain = TransformerDecoder(net, t_max=PAGED_T_MAX)
    rates, outs = {}, {}
    for what in ("off", "on", "on", "off"):
        engine = _tier_engine(net, plain if what == "off" else dec_s,
                              integrity=None if what == "off" else SENTINEL)
        engine.submit(prompts[0][:64], 4)
        engine.run_until_drained()
        reqs, wall, st, fetched, _, _ = _drive(engine, prompts, 64)
        rates.setdefault(what, []).append(8 * 64 / wall)
        outs[what] = [r.result(0) for r in reqs]
        if what == "on" and st["numerical_faults"]:
            raise AssertionError("the sentinel tripped on a clean run")
    same = sum((a == b).all() for a, b in zip(outs["on"], outs["off"]))
    log(f"sentinel [{card}]: generated tok/s off "
        f"{', '.join(f'{x:.1f}' for x in rates['off'])}, on "
        f"{', '.join(f'{x:.1f}' for x in rates['on'])} (runs off, on, on, "
        f"off; 8 requests of 64-256 tokens, 64 new, 8 slots); {same}/8 "
        f"outputs identical on and off")
    if same != 8:
        raise AssertionError("the sentinel changed tokens")
    # NaN logits on the first block's first lane, paged
    inj = FaultInjector()
    inj.corrupt("device.corrupt_logits", mode="nan", at=1)
    engine = _tier_engine(net, dec_s, paged=True, page_size=PAGE_SIZE,
                          fault_injector=inj)
    reqs = [engine.submit(p, 64) for p in prompts]
    engine.run_until_drained()
    faulted = [r for r in reqs if isinstance(r._error, NumericalFault)]
    done = [r for r in reqs if r.state == r.DONE and
            len(r.result(0)) == len(r.prompt) + 64]
    log(f"sentinel [{card}]: NaN injected at the first block: "
        f"{len(faulted)} NumericalFault (tokens kept "
        f"{[len(r.generated) for r in faulted]}), {len(done)} completed, "
        f"numerical_faults {engine.stats()['numerical_faults']}")
    if len(faulted) != 1 or len(faulted[0].generated) != 1 or \
            len(done) != 7:
        raise AssertionError("the NaN injection did not fail exactly its "
                             "request before any of its block's tokens")
    _audit(engine, "NaN injection")
    # a flipped page of a registered prefix, caught on the next hit
    inj = FaultInjector()
    engine = _tier_engine(net, dec_s, paged=True, page_size=PAGE_SIZE,
                          fault_injector=inj,
                          integrity=IntegrityConfig(kv_verify_rate=1.0))
    prefix = rng.integers(0, 32000, 256)
    tail = lambda: rng.integers(0, 32000, 32)          # noqa: E731
    engine.submit(np.concatenate([prefix, tail()]), 8)
    engine.run_until_drained()
    inj.corrupt("device.corrupt_page", mode="flip", at=1,
                where="registered")
    engine.submit(np.concatenate([prefix, tail()]), 8)
    engine.run_until_drained()
    last = engine.submit(np.concatenate([prefix, tail()]), 8)
    engine.run_until_drained()
    st = engine.stats()
    log(f"page verifier [{card}]: flipped shared-prefix page: "
        f"kv_page_corruptions {st['kv_page_corruptions']}, prefix hits "
        f"{st['prefix_cache_hits']}, the next request "
        f"{len(last.result(0)) - len(last.prompt)} tokens")
    if st["kv_page_corruptions"] != 1 or \
            len(last.result(0)) != len(last.prompt) + 8:
        raise AssertionError("the verifier missed the flipped page")
    _audit(engine, "page verifier")


def _supervised_restart(card, net, dec_s, rng):
    prompts = [rng.integers(0, 32000, int(n))
               for n in rng.integers(64, 257, 8)]
    inj = FaultInjector()
    inj.raise_once("engine.step", RuntimeError("injected crash"), at=12)
    engine = _tier_engine(net, dec_s, fault_injector=inj)
    sup = EngineSupervisor(engine, timeout=60.0, interval=0.1,
                           max_restarts=2)
    took = []
    restart = sup._restart

    def timed_restart(cause):
        t0 = time.perf_counter()
        restart(cause)
        took.append(time.perf_counter() - t0)
    sup._restart = timed_restart
    casts, builds = dec_s.param_casts, cuda_lib.NVCC_RUNS
    ends = []
    sup.start()
    try:
        t0 = time.perf_counter()
        reqs = [sup.submit(p, 64) for p in prompts]
        for r in reqs:
            r.add_done_callback(ends.append)
        outs = [r.result(timeout=300) for r in reqs]
        wall = time.perf_counter() - t0
        st = sup.stats()
    finally:
        sup.stop()
    log(f"supervisor [{card}]: crash at engine.step hit 12: restarts "
        f"{sup.restarts}, recovered {sup.recovered_requests}, requeued "
        f"{st['requeued']}, completed {st['completed']}, failed "
        f"{st['failed']}; restart "
        f"{took[0] * 1e3 if took else float('nan'):.2f} ms (quarantine, "
        f"rebuild, requeue); 8 requests in {wall:.2f}s; nvcc runs after "
        f"{cuda_lib.NVCC_RUNS - builds}, weight casts after "
        f"{dec_s.param_casts - casts}")
    if sup.restarts != 1 or st["completed"] != 8 or st["failed"] or \
            len(ends) != 8 or \
            any(len(o) != len(p) + 64 for o, p in zip(outs, prompts)):
        raise AssertionError("supervised recovery lost, duplicated or cut "
                             "a request")
    if cuda_lib.NVCC_RUNS != builds or dec_s.param_casts != casts:
        raise AssertionError("the restart built a kernel or cast weights")


def phase_tier(card, net):
    """Phase 4c: chunked prefill, recompute, deadlines / cancel /
    shedding / adaptive K, the sentinel and page verifier, and supervised
    restart, on the flagship net."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    dec_s = TransformerDecoder(net, t_max=PAGED_T_MAX, sentinel=True)
    reset_launches()
    shorts = [rng.integers(0, 32000, int(n)) for n in rng.integers(32, 65, 8)]
    longs = [rng.integers(0, 32000, int(n))
             for n in rng.integers(448, 513, 4)]
    warm = [rng.integers(0, 32000, 480), rng.integers(0, 32000, 48)]
    for paged in (False, True):
        rows = {}
        for chunk in (None, TIER_CHUNK):
            rows[chunk] = _stall_run(net, dec_s, paged, chunk, shorts,
                                     longs, warm)
        for chunk, (gmax, gmed, ttft, fetched, blocks, windows) in \
                rows.items():
            log(f"chunked prefill [{card}]: "
                f"{'paged' if paged else 'slab'}, "
                f"{'windows of ' + str(chunk) if chunk else 'whole'}: "
                f"short lanes' longest retire gap {gmax:.2f} ms (median "
                f"{gmed:.2f}) while 4 long prompts prefill; long TTFT ms "
                f"{[round(t, 2) for t in ttft]}; {windows} windows; "
                f"readbacks {fetched} for {blocks} decode blocks")
        log(f"chunked prefill [{card}]: {'paged' if paged else 'slab'} "
            f"chunked / whole: longest gap "
            f"{rows[TIER_CHUNK][0] / rows[None][0]:.3f}x, last long TTFT "
            f"{rows[TIER_CHUNK][2][-1] / rows[None][2][-1]:.3f}x")
    slab_b1 = read_launches()["shortseq_attention"]
    log(f"tier phase: B1 launches in the slab engines' admissions "
        f"{slab_b1}")
    # what a cycle's window costs against the whole admission it replaces
    caches = dec_s.init_cache(12)
    tokens, lengths = _padded(longs, 512)
    window = tokens[:1, 3 * TIER_CHUNK:4 * TIER_CHUNK]
    profile_step(lambda: dec_s.prefill_chunk(caches, window, 3 * TIER_CHUNK,
                                             TIER_CHUNK, 0),
                 "slab window (1 x 128 at 384)")
    profile_step(lambda: dec_s.prefill_slots(caches, tokens, lengths,
                                             np.arange(4)),
                 "slab admission of the 4 long prompts (bucket 512)")
    del caches
    if slab_b1 < 12:
        raise AssertionError("the slab engines' admissions did not launch "
                             "B1")
    check_chunk_logits(net, dec_s, rng.integers(0, 32000, 480))
    check_recompute(net, dec_s, rng)
    _burst(card, net, dec_s, rng)
    _sentinel_checks(card, net, dec_s, rng)
    _supervised_restart(card, net, dec_s, rng)
    log(f"tier phase: {time.perf_counter() - t_phase:.1f}s wall")


# ----------------------------------------------------------------- phase 5
def phase_long_prompt():
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=2, max_length=2048)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 32000, 1536) for _ in range(4)]
    dec = TransformerDecoder(net)
    reset_launches()
    outs = dec.generate(prompts, 16, block_size=4)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"long prompt: 4 x 1536 tokens, 16 new, K=4; kernel launches "
        f"{launches}")
    if any(len(o) != 1536 + 16 for o in outs):
        raise AssertionError("long-prompt generate returned wrong lengths")
    if launches["flash_forward"] < 2:
        raise AssertionError("the flash kernel did not launch on the "
                             "long-prompt prefill")
    check_logits(net, prompts[:1], 2048, "long-prompt 2-layer")
    return launches["flash_forward"]


# ----------------------------------------------------------------- phase 6
def check_train_twin(net, ds):
    """First-step loss and gradients of the card's bf16 kernel path
    against the same weights in f32 on the CPU (plain path)."""
    got_g, got_l = net.compute_gradient_and_score(ds)
    want_g, want_l = _cpu_twin(net).compute_gradient_and_score(ds)
    rel_l = abs(got_l - want_l) / abs(want_l)
    errs = {f"{v}.{k}": _rel_l2(got_g[v][k].cpu(), want_g[v][k])
            for v, k in (("embed", "W"), ("attn0", "Wq"), ("ffn11", "W2"),
                         ("out", "W"))}
    log(f"flagship train: first-step loss card bf16 {got_l:.6f} vs CPU f32 "
        f"{want_l:.6f} (rel {rel_l:.3e}, tol {TRAIN_LOSS_TOL}); gradient "
        f"rel-L2 {', '.join(f'{k} {e:.3e}' for k, e in errs.items())} "
        f"(tol {TRAIN_GRAD_TOL})")
    if not (rel_l <= TRAIN_LOSS_TOL and
            all(e <= TRAIN_GRAD_TOL for e in errs.values())):
        raise AssertionError("card training disagrees with the CPU f32 "
                             "reference")


def train_steps(net, ds, steps, step=None):
    """``steps`` train steps (``fit_batch``, or ``step``) with the launch
    counts zeroed just before; returns (losses as floats, wall seconds,
    launches)."""
    step = step or net.fit_batch
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        step(ds)
        losses.append(net.score_value)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    return [float(x) for x in losses], wall, launches


def _step_floor_ms(conf, b, t):
    """Data-sheet floor of one bf16 train step: 6 FLOP per matmul weight
    per token, plus attention's 4 * D (forward) + 10 * D (backward) per
    causal pair, at 989 TF/s."""
    d_model = conf.vertices["embed"].layer.n_out
    vocab = conf.vertices["out"].layer.n_out
    layers = sum(1 for n in conf.vertices if n.startswith("attn"))
    heads = conf.vertices["attn0"].layer.num_heads
    ff = conf.vertices["ffn0"].layer.hidden_mult
    weights = layers * (4 + 2 * ff) * d_model ** 2 + d_model * vocab
    pairs = b * heads * t * (t + 1) // 2
    flops = 6 * weights * b * t + layers * 14 * (d_model // heads) * pairs
    return flops / BF16_FLOPS * 1e3, flops


def phase_train_flagship(card):
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=12, max_length=512,
                               learning_rate=3e-4)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    b, t, n_layers = 32, 512, 12
    x, y = lm_batch_sparse(np.random.default_rng(13).integers(
        0, 32000, (b, t + 1)))
    ds = DataSet(x, y)
    check_train_twin(net, DataSet(x[:2], y[:2]))
    torch.cuda.reset_peak_memory_stats()
    warm, _, _ = train_steps(net, ds, 2)
    losses, wall, launches = train_steps(net, ds, 8)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = wall / 8 * 1e3
    floor_ms, flops = _step_floor_ms(conf, b, t)
    log(f"flagship train: losses {[round(x, 4) for x in warm + losses]}; "
        f"kernel launches in 8 steps {launches}")
    for name in ("shortseq_attention", "shortseq_attention_bwd"):
        if launches[name] != n_layers * 8:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in 8 steps, expected {n_layers * 8}")
    if not (np.isfinite(warm + losses).all() and losses[-1] < warm[0]):
        raise AssertionError("flagship training loss is not finite and "
                             "falling")
    log(f"flagship train [{card}]: {8 * b * t / wall:.1f} train tok/s, "
        f"{step_ms:.2f} ms per step (B {b}, T {t}), data-sheet floor "
        f"{floor_ms:.2f} ms ({flops:.3e} FLOP) = {floor_ms / step_ms:.3f} "
        f"of the step; peak memory {peak_gb:.2f} GB")
    profile_step(lambda: net.fit_batch(ds))
    return launches


def _kernel_us(event) -> float:
    """An averaged profiler event's device time if it is a kernel (CPU-side
    ops, whose device time repeats their kernels', give 0; the attribute's
    name differs across torch versions)."""
    if getattr(event, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_step(step, what="step"):
    """One more ``step()`` under torch.profiler: device time by kernel name
    and the device's busy share of the step's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, _kernel_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    log(f"profiled {what}: wall {wall_us / 1e3:.2f} ms, kernels "
        f"{busy / 1e3:.2f} ms ({busy / wall_us:.3f} of wall: the device's "
        f"busy share, one stream), {sum(r[2] for r in rows)} launches")
    for key, us, count in rows[:15]:
        log(f"  {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")


# ----------------------------------------------------------------- phase 7
def phase_train_long(card):
    conf = transformer_lm_conf(vocab_size=32000, d_model=768, num_heads=12,
                               num_layers=2, max_length=2048,
                               learning_rate=3e-4)
    net = ComputationGraph(conf, compute_dtype=torch.bfloat16).init()
    b, t, n_layers, steps = 4, 2048, 2, 3
    x, y = lm_batch_sparse(np.random.default_rng(17).integers(
        0, 32000, (b, t + 1)))
    losses, wall, launches = train_steps(net, DataSet(x, y), steps)
    log(f"long-context train: losses {[round(x, 4) for x in losses]}; "
        f"kernel launches in {steps} steps {launches}")
    for name in ("flash_forward", "flash_backward_dq", "flash_backward_dkv"):
        if launches[name] != n_layers * steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {steps} steps, expected "
                                 f"{n_layers * steps}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("long-context training loss is not finite "
                             "and falling")
    log(f"long-context train [{card}]: {steps * b * t / wall:.1f} train "
        f"tok/s, {wall / steps * 1e3:.2f} ms per step (B {b}, T {t}, 2 "
        f"layers; first step included)")
    return launches


# ----------------------------------------------------------- phases 8-10
def _motif_batch(b, t, vocab, seed):
    """One-hot (chars, next chars) [B, T, vocab] of seeded rows that each
    repeat a random motif of 5-16 characters: text a char-RNN can learn."""
    rng = np.random.default_rng(seed)
    toks = np.stack([np.resize(rng.integers(0, vocab, rng.integers(5, 17)),
                               t + 1) for _ in range(b)])
    eye = np.eye(vocab, dtype=np.float32)
    return eye[toks[:, :-1]], eye[toks[:, 1:]]


def _cpu_twin_mln(net):
    """The same configuration and weights on the CPU in f32 (plain path)."""
    return network_from_numpy(net.conf, [{k: a.cpu().numpy()
                                          for k, a in p.items()}
                                         for p in net.params], device="cpu")


def check_charrnn_twin(net, ds):
    """First-step loss and gradients of the card's bf16 kernel path against
    the same weights in f32 on the CPU (plain path)."""
    got_g, got_l = net.compute_gradient_and_score(ds)
    want_g, want_l = _cpu_twin_mln(net).compute_gradient_and_score(ds)
    rel_l = abs(got_l - want_l) / abs(want_l)
    errs = {f"{i}.{k}": _rel_l2(got_g[i][k].cpu(), want_g[i][k])
            for i, k in ((0, "W"), (0, "R"), (1, "R"), (2, "W"))}
    log(f"char-RNN train: first-step loss card bf16 {got_l:.6f} vs CPU f32 "
        f"{want_l:.6f} (rel {rel_l:.3e}, tol {TRAIN_LOSS_TOL}); gradient "
        f"rel-L2 {', '.join(f'{k} {e:.3e}' for k, e in errs.items())} "
        f"(tol {TRAIN_GRAD_TOL})")
    if not (rel_l <= TRAIN_LOSS_TOL and
            all(e <= TRAIN_GRAD_TOL for e in errs.values())):
        raise AssertionError("card char-RNN training disagrees with the CPU "
                             "f32 reference")


def _charrnn_conf(tbptt_length):
    return char_rnn_conf(vocab_size=80, hidden=512, layers=2,
                         learning_rate=CHARRNN_LR, tbptt_length=tbptt_length)


def phase_charrnn_train(card):
    """bench.py's char-RNN (2 x 512 GravesLSTM, vocab 80, B 64, T 128,
    bf16, rmsprop, l2 1e-3) through MultiLayerNetwork._fit_batch."""
    b, t, layers = 64, 128, 2
    net = MultiLayerNetwork(_charrnn_conf(0),
                            compute_dtype=torch.bfloat16).init()
    x, y = _motif_batch(b, t, 80, 19)
    check_charrnn_twin(net, DataSet(x[:2], y[:2]))
    ds = DataSet(torch.from_numpy(x).cuda().bfloat16(),
                 torch.from_numpy(y).cuda().bfloat16())
    torch.cuda.reset_peak_memory_stats()
    warm, _, _ = train_steps(net, ds, 2, net._fit_batch)
    losses, wall, launches = train_steps(net, ds, 8, net._fit_batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"char-RNN train: losses {[round(v, 4) for v in warm + losses]}; "
        f"kernel launches in 8 steps {launches}")
    routes = lstm_routes()
    log(f"char-RNN train: LSTM launches by route {routes}")
    if launches["lstm_recurrence"] != layers * 8 or \
            routes["cluster"] != layers * 8:
        raise AssertionError(f"lstm_recurrence launched {routes} times in 8 "
                             f"steps, expected {layers * 8} on the cluster "
                             "route")
    if not (np.isfinite(warm + losses).all() and losses[-1] < warm[0]):
        raise AssertionError("char-RNN training loss is not finite and "
                             "falling")
    step_ms = wall / 8 * 1e3
    log(f"char-RNN train [{card}]: {8 * b * t / wall:.1f} train chars/s, "
        f"{step_ms:.2f} ms per step (B {b}, T {t}, 2 x 512, bf16); peak "
        f"memory {peak_gb:.2f} GB")
    profile_step(lambda: net._fit_batch(ds))
    return net, ds, launches


def phase_charrnn_tbptt(card, ds):
    """fit() with the example's 50-step window over the T 128 batch: three
    windows, one update each, the (h, c) carry handed across."""
    layers, windows = 2, 3
    net = MultiLayerNetwork(_charrnn_conf(50),
                            compute_dtype=torch.bfloat16).init()
    carries = []
    step = net._train_step

    def recording_step(*args):
        carries.append(args[4])
        return step(*args)
    net._train_step = recording_step
    losses, wall, launches = train_steps(net, ds, 1, net.fit)
    del net._train_step
    log(f"char-RNN TBPTT: {net.iteration} updates from one batch (window "
        f"50 over T 128), score {losses[0]:.4f}; kernel launches "
        f"{launches}")
    routes = lstm_routes()
    log(f"char-RNN TBPTT: LSTM launches by route {routes}")
    if net.iteration != windows or \
            launches["lstm_recurrence"] != layers * windows or \
            routes["cluster"] != layers * windows:
        raise AssertionError("TBPTT did not run 3 windows of 2 launches on "
                             "the cluster route")
    handed = [sorted(k for c in carry for k in c) for carry in carries]
    if handed[0] or any(h != ["c", "c", "h", "h"] for h in handed[1:]) or \
            any(c[i]["h"].shape != (64, 512) for c in carries[1:]
                for i in range(layers)):
        raise AssertionError(f"the (h, c) carry did not cross windows: "
                             f"{handed}")
    log(f"char-RNN TBPTT [{card}]: {wall / windows * 1e3:.2f} ms per window "
        f"(B 64, T 50 / 50 / 28), carry handed to windows 2 and 3")
    return launches


def phase_charrnn_sample(card, net):
    """CharacterIterator.sample of 100 characters through rnn_time_step:
    2 launches and one readback per character, probabilities as on the
    CPU twin."""
    chars = "".join(chr(32 + i) for i in range(80))
    it = CharacterIterator(chars * 2, seq_length=16, batch_size=1)
    twin = _cpu_twin_mln(net)
    net.rnn_clear_previous_state()
    err = 0.0
    for c in chars[:10]:
        x = np.zeros((1, 80), np.float32)
        x[0, it.char_to_idx[c]] = 1.0
        err = max(err, float(np.abs(net.rnn_time_step(x) -
                                    twin.rnn_time_step(x)).max()))
    log(f"sampling: next-char probabilities card vs CPU f32 over 10 steps "
        f"max-abs {err:.3e} (tol {SAMPLE_PROB_TOL})")
    if not err <= SAMPLE_PROB_TOL:
        raise AssertionError("card sampling probabilities disagree with the "
                             "CPU reference")
    torch.cuda.synchronize()
    reset_launches()
    fetched0 = fetch_counts("rnn_time_step")["rnn_time_step"]
    t0 = time.perf_counter()
    text = it.sample(net, chars[33], 100, rng_seed=3)
    wall = time.perf_counter() - t0
    launches = read_launches()
    fetched = fetch_counts("rnn_time_step")["rnn_time_step"] - fetched0
    log(f"sampling: {text!r}; kernel launches {launches}, readbacks "
        f"{fetched}")
    if len(text) != 101 or set(text) - set(chars):
        raise AssertionError("sample returned a malformed string")
    routes = lstm_routes()
    if launches["lstm_recurrence"] != 2 * 100 or fetched != 100 or \
            routes["cooperative"] != 2 * 100:
        raise AssertionError(f"sampling did not launch the LSTM kernel "
                             f"twice (cooperative route, f32) and read back "
                             f"once per character: {routes}")
    log(f"sampling [{card}]: {wall / 100 * 1e3:.3f} ms per character "
        f"(rnn_time_step, N 1, f32 masters)")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    card = phase_environment()
    phase_build()
    measured = phase_kernel_checks()
    serving_launches, flagship = phase_serving(card)
    phase_paged_serving(card, flagship)
    phase_tier(card, flagship)
    del flagship
    launches = {"shortseq_attention": serving_launches,
                "flash_forward": phase_long_prompt()}
    train = phase_train_flagship(card)
    long = phase_train_long(card)
    charrnn, charrnn_ds, lstm_train = phase_charrnn_train(card)
    phase_charrnn_tbptt(card, charrnn_ds)
    phase_charrnn_sample(card, charrnn)
    launches["lstm_recurrence"] = lstm_train["lstm_recurrence"]
    launches["shortseq_attention_bwd"] = train["shortseq_attention_bwd"]
    for name in ("flash_backward_dq", "flash_backward_dkv"):
        launches[name] = long[name]
    for line in measured["shortseq_attention"].pop("main_shapes"):
        log(line)
    rows = []
    for name, spec in KERNELS.items():
        rows.append({"name": name, "route": "cuda",
                     "source": f"deeplearning4j_tpu_torch/csrc/"
                               f"{spec['lib']}.cu",
                     "replaces": spec["replaces"],
                     "launches": launches[name], **measured[name]})
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
