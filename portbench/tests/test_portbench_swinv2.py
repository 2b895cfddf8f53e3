"""The SwinV2 cell's yardstick: its counts equal the hand counts, and the
window-attention reader takes the device time of every biased kernel
(forward, backward, dbias) and of no other."""

import math
import re
from pathlib import Path

import pytest

from portbench import harness
from portbench.costs import swinv2
from portbench.metrics import attn_roofline, winattn_roofline
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = tiny.bench()
CELL = "swinv2b-train-b256"


def _cfg(name):
    return harness.load_json(ROOT / "portbench" / "configs" / f"{name}.json")


@pytest.mark.parametrize("what, got, want", [
    ("swinv2-b forward multiply-adds an image (the paper's 21.8 G)",
     lambda: swinv2.forward_macs(_cfg("swinv2-base-w16-256")), 2.1786e10),
    ("swinv2-b step at B 256",
     lambda: swinv2.step_flops(_cfg("swinv2-base-w16-256"),
                               {"batch": 256}), 3.3451e13),
])
def test_counts_equal_the_hand_counts(what, got, want):
    assert math.isclose(got(), want, rel_tol=5e-5), what


def _stage_macs(c, tokens, t):
    """One SwinV2 block's multiply-adds an image by hand: qkv 3C², q·kᵀ
    and p·v M²·C each, the projection C², the 4x MLP 8C², a token."""
    return tokens * (3 * c * c + 2 * t * c + c * c + 8 * c * c)


def test_swinv2_macs_by_hand():
    # the 4x4 embedding, 2 + 2 + 18 + 2 blocks at 64², 32², 16², 8²
    # tokens (windows of 256, 256, 256, 64), three 4C -> 2C mergings,
    # the 1024 x 1000 head
    want = (64 * 64 * 48 * 128 +
            2 * _stage_macs(128, 64 * 64, 256) +
            2 * _stage_macs(256, 32 * 32, 256) +
            18 * _stage_macs(512, 16 * 16, 256) +
            2 * _stage_macs(1024, 8 * 8, 64) +
            32 * 32 * 512 * 256 + 16 * 16 * 1024 * 512 +
            8 * 8 * 2048 * 1024 + 1024 * 1000)
    assert swinv2.forward_macs(_cfg("swinv2-base-w16-256")) == want


def test_window_attention_bound_counts_bias_bytes():
    cfg, traffic = _cfg("swinv2-base-w16-256"), {"batch": 256}
    bound = swinv2.window_attention_bound_s(cfg, traffic, 989e12, 3.35e12)
    ops_only = swinv2.window_attention_bound_s(cfg, traffic, 989e12,
                                               math.inf)
    assert bound > ops_only > 0


#: the biased kernels as the profiler names them, with a trace's seconds
BIASED = [
    ("void dl4j::attention_bias_fwd_kernel<__nv_bfloat16, 64>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, dl4j::FwdArgs, dl4j::BiasArgs)", 0.2),
    ("void dl4j::attention_bias_bwd_kernel<__nv_bfloat16, 64>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, dl4j::BwdArgs, "
     "dl4j::BiasArgs)", 0.5),
    ("void dl4j::attention_bias_dbias_kernel<__nv_bfloat16, 64>("
     "CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, dl4j::BwdArgs, "
     "dl4j::BiasArgs)", 0.3),
]
#: kernels of the same step that are not the biased attention's
OTHERS = [
    ("void attention_dkv_kernel<64, true>(Params)", 0.02),
    ("void attention_fwd_kernel<64>(Params)", 0.02),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.4),
]


def _context(kernels):
    cell = harness.resolve(CELL, BENCH)
    peak = harness.load_json(ROOT / "portbench" / "peaks.json")[
        "NVIDIA H100 80GB HBM3"]
    window = {"steps": 10, "seconds": 5.0, "flops_per_step": 2e13}
    trace = {"steps": 2, "window_s": 1.0, "busy_s": 0.8,
             "kernels": kernels}
    return harness.Context(cell["config"], cell["traffic"], window, trace,
                           peak)


def test_window_roofline_reads_all_three_biased_kernels():
    ctx = _context(BIASED + OTHERS)
    p = ctx.peak
    bound = swinv2.window_attention_bound_s(ctx.config, ctx.traffic,
                                            p["bf16_dense_flops_per_s"],
                                            p["hbm_bytes_per_s"])
    spent = sum(s for _, s in BIASED)
    assert winattn_roofline.read(ctx) == pytest.approx(
        100.0 * bound * 2 / spent)
    assert 0.0 < winattn_roofline.read(ctx) <= 100.0


@pytest.mark.parametrize("left_out", range(len(BIASED)))
def test_each_biased_kernel_counts_in_the_window_roofline(left_out):
    fewer = BIASED[:left_out] + BIASED[left_out + 1:]
    assert winattn_roofline.read(_context(fewer + OTHERS)) > \
        winattn_roofline.read(_context(BIASED + OTHERS))


def test_the_lm_attention_reader_leaves_the_biased_kernels_out():
    for name, _ in BIASED:
        assert re.search(winattn_roofline.KERNELS, name), name
        assert not re.search(attn_roofline.KERNELS, name), name
    assert winattn_roofline.read(_context(OTHERS)) is None
