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
   dv rel-L2 <= 2e-2 in bf16); fully masked batch rows are checked for
   finiteness only. Each with its time, the plain version's,
   scaled_dot_product_attention's (forward, or its backward through
   ``torch.autograd.grad`` on a saved graph) as a yardstick (CUDA events,
   median of 20 samples of 10 back-to-back launches), and the data-sheet
   bound.
4. serving: the flagship LM (vocab 32000, d 768, 12 heads, 12 layers,
   max_length 577, bf16, random seeded weights) behind a
   SlotGenerationEngine (8 slots, K = 4) answering 16 greedy requests;
   the short-sequence kernel must launch on every admission, at most one
   readback per decode block, and the card's prefill logits must match
   the same weights run in f32 on the CPU.
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
8. the ``kernels`` JSON line, then the ``ok`` JSON line last.
"""

import json
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
from deeplearning4j_tpu_torch.kernels.shortseq_attention import (
    attention_bwd_plain, attention_fwd_plain, row_delta, short_attention_bwd,
    short_attention_fwd)
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             lm_batch_sparse,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.utils import graph_from_numpy

#: H100 SXM data-sheet peaks (not measured): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
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


def read_launches():
    return {n: s["wrapper"].launches for n, s in KERNELS.items()}


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
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")


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


def check_kernel(name, b, h, t, d, lengths, seed):
    spec = KERNELS[name]
    q3, k3, v3, km = _attention_case(b, h, t, d, lengths, seed)
    o_k, lse_k = spec["wrapper"](q3, k3, v3, km, h, True)
    o_p, lse_p = spec["plain"](q3, k3, v3, km, h, True)
    torch.cuda.synchronize()
    dead = torch.from_numpy(np.repeat(np.asarray(lengths) == 0, h)).cuda()
    live = ~dead
    if not (torch.isfinite(o_k).all() and torch.isfinite(lse_k).all()):
        raise AssertionError(f"{name}: non-finite output")
    err_o = (o_k[live].float() - o_p[live].float()).abs().max().item()
    err_l = (lse_k[live] - lse_p[live]).abs().max().item()
    log(f"{name} B={b} H={h} T={t} D={d} bf16 causal lengths "
        f"[{min(lengths)}..{max(lengths)}] fully-masked rows "
        f"{int(dead.sum()) * t}: o max-abs {err_o:.3e} (tol {O_TOL}), "
        f"lse max-abs {err_l:.3e} (tol {LSE_TOL})")
    if not (err_o <= O_TOL and err_l <= LSE_TOL):
        raise AssertionError(f"{name}: disagrees with its plain version")
    ms = time_ms(lambda: spec["wrapper"](q3, k3, v3, km, h, True))
    plain_ms = time_ms(lambda: spec["plain"](q3, k3, v3, km, h, True))
    q4, k4, v4 = (x.view(b, h, t, d) for x in (q3, k3, v3))
    allowed = (torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
               [None, None] & (km > 0)[:, None, None, :])
    library_ms = time_ms(lambda: torch.nn.functional
                         .scaled_dot_product_attention(q4, k4, v4,
                                                       attn_mask=allowed))
    bound_ms, bound_by = _bound(q3, h, lengths, t)
    log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention) bound_us "
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


def check_bwd_kernel(name, b, h, t, d, lengths, seed, masked):
    """A backward kernel against the plain backward on the same (q, k, v,
    o, lse, dO, delta), with its times and bound."""
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
    want = attention_bwd_plain(*args, o, lse, do, delta)
    torch.cuda.synchronize()
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
    q4, k4, v4 = (x.view(b, h, t, d).detach().requires_grad_(True)
                  for x in (q3, k3, v3))
    allowed = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    if masked:
        allowed = allowed[None, None] & (km > 0)[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=allowed)
    do4 = do.view(b, h, t, d)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, (q4, k4, v4), do4, retain_graph=True))
    tensors, per_pair = BWD_WORK[name]
    bound_ms, bound_by = _bound(q3, h, lengths, t, tensors, per_pair, 2,
                                masked)
    log(f"  kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{library_ms:.4f} (scaled_dot_product_attention backward) "
        f"bound_us {bound_ms * 1e3:.1f} ({bound_by})")
    return {"max_abs_err": max(
                (x[live].float() - want[gi][live].float()).abs().max().item()
                for gi, x in zip(spec["grads"], got)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_kernel_checks():
    rng = np.random.default_rng(0)
    # B1 at the flagship prefill: one length-1 row, one fully masked row
    lens = rng.integers(2, 513, 32)
    lens[0], lens[1] = 1, 0
    short = check_kernel("shortseq_attention", 32, 12, 512, 64, lens, 1)
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
    return launches["shortseq_attention"]


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


def train_steps(net, ds, steps):
    """``steps`` fit_batch calls with the launch counts zeroed just before;
    returns (losses as floats, wall seconds, launches)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for _ in range(steps):
        net.fit_batch(ds)
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
    profile_step(net, ds)
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


def profile_step(net, ds):
    """One more step under torch.profiler: device time by kernel name and
    the device's busy share of the step's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        net.fit_batch(ds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, _kernel_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    log(f"profiled step: wall {wall_us / 1e3:.2f} ms, kernels "
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    card = phase_environment()
    phase_build()
    measured = phase_kernel_checks()
    launches = {"shortseq_attention": phase_serving(card),
                "flash_forward": phase_long_prompt()}
    train = phase_train_flagship(card)
    long = phase_train_long(card)
    launches["shortseq_attention_bwd"] = train["shortseq_attention_bwd"]
    for name in ("flash_backward_dq", "flash_backward_dkv"):
        launches[name] = long[name]
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
