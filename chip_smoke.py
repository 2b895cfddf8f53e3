"""Drive the PyTorch/H100 port (``deeplearning4j_tpu_torch``) on one card.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one Hopper GPU and the CUDA toolkit (nvcc). It exits non-zero, and
prints no result, without a CUDA device.

Phases, each an uncaught exception on failure:

1. environment: torch/CUDA versions, capability (9, 0), the card's name
   and power limit; TF32 off for the plain references.
2. build: both attention kernels from ``deeplearning4j_tpu_torch/csrc``
   with nvcc for sm_90a, one nvcc each, in parallel.
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the main path's shapes (o max-abs <= 5e-2, lse max-abs <= 1e-2,
   fully masked rows finite only), with its time, the plain version's,
   scaled_dot_product_attention's as a yardstick (CUDA events, median of
   20 samples of 10 back-to-back launches), and the data-sheet bound.
4. serving: the flagship LM (vocab 32000, d 768, 12 heads, 12 layers,
   max_length 577, bf16, random seeded weights) behind a
   SlotGenerationEngine (8 slots, K = 4) answering 16 greedy requests;
   the short-sequence kernel must launch on every admission, at most one
   readback per decode block, and the card's prefill logits must match
   the same weights run in f32 on the CPU.
5. long prompt: the same width at 2 layers, max_length 2048,
   TransformerDecoder.generate on 4 prompts of 1536 tokens (bucket
   T = 2048 > 512): the flash kernel must launch.
6. the ``kernels`` JSON line, then the ``ok`` JSON line last.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.kernels import cuda_lib
from deeplearning4j_tpu_torch.kernels.flash_forward import (
    flash_forward, flash_forward_plain)
from deeplearning4j_tpu_torch.kernels.shortseq_attention import (
    attention_fwd_plain, short_attention_fwd)
from deeplearning4j_tpu_torch.models import (SlotGenerationEngine,
                                             TransformerDecoder,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.utils import graph_from_numpy

#: H100 SXM data-sheet peaks (not measured): HBM bytes/s, dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
O_TOL, LSE_TOL = 5e-2, 1e-2
#: relative L2 of the card's bf16 kernel-path logits against the CPU f32
#: plain path: bf16 rounds activations and weights (~0.4% each) through
#: every layer; 5e-2 bounds that drift with margin and still catches a
#: wrong attention (which moves the logits by O(1))
LOGIT_REL_TOL = 5e-2

KERNELS = {
    "shortseq_attention": {
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/shortseq_attention.cu",
        "replaces": "deeplearning4j_tpu/kernels/pallas_shortseq.py:127",
        "fwd": short_attention_fwd, "plain": attention_fwd_plain},
    "flash_forward": {
        "route": "cuda",
        "source": "deeplearning4j_tpu_torch/csrc/flash_forward.cu",
        "replaces": "deeplearning4j_tpu/kernels/pallas_attention.py:67",
        "fwd": flash_forward, "plain": flash_forward_plain},
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
        spec["fwd"].launches = 0


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
    logs = cuda_lib.build(list(KERNELS))
    log(f"build: {time.perf_counter() - t0:.1f}s wall for {sorted(KERNELS)} "
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


def _bound(q3, h, lengths, t):
    """(bound_ms, bound_by): q, k, v, o, lse and mask moved once, against
    the causal, key-masked products this input needs (4 * D FLOP per
    visible query-key pair), at the data-sheet peaks."""
    bh, _, d = q3.shape
    elem = q3.element_size()
    nbytes = 4 * q3.numel() * elem + bh * t * 4 + (bh // h) * t * 4
    pairs = sum(int(np.minimum(np.arange(1, t + 1), int(n)).sum())
                for n in lengths) * h
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * d * pairs / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_kernel(name, b, h, t, d, lengths, seed):
    spec = KERNELS[name]
    q3, k3, v3, km = _attention_case(b, h, t, d, lengths, seed)
    o_k, lse_k = spec["fwd"](q3, k3, v3, km, h, True)
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
    ms = time_ms(lambda: spec["fwd"](q3, k3, v3, km, h, True))
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
    return {"shortseq_attention": short, "flash_forward": flash}


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
    launches = {n: s["fwd"].launches for n, s in KERNELS.items()}
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
    launches = {n: s["fwd"].launches for n, s in KERNELS.items()}
    log(f"long prompt: 4 x 1536 tokens, 16 new, K=4; kernel launches "
        f"{launches}")
    if any(len(o) != 1536 + 16 for o in outs):
        raise AssertionError("long-prompt generate returned wrong lengths")
    if launches["flash_forward"] < 2:
        raise AssertionError("the flash kernel did not launch on the "
                             "long-prompt prefill")
    check_logits(net, prompts[:1], 2048, "long-prompt 2-layer")
    return launches["flash_forward"]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(1)
    card = phase_environment()
    phase_build()
    measured = phase_kernel_checks()
    launches = {"shortseq_attention": phase_serving(card),
                "flash_forward": phase_long_prompt()}
    rows = []
    for name, spec in KERNELS.items():
        rows.append({"name": name, "route": spec["route"],
                     "source": spec["source"], "replaces": spec["replaces"],
                     "launches": launches[name], **measured[name]})
    log(f"card: {card}")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
