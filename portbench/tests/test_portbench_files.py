"""Every cell of BENCHMARK.json resolves by name to its files, the
yardstick's counts equal the hand counts, and no module under
portbench/ loads JAX or the JAX package (the reference not the program
either)."""

import ast
import json
import math
from pathlib import Path

import pytest

from portbench import harness
from portbench.costs import gpt2, resnet
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = tiny.bench()
CELLS = tiny.CELLS


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.resolve(name, BENCH)
    assert cell["config"]["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert set(cell["limits"]) <= {"loss_gap", "grad_gap",
                                   "grad_gap_median", "change_gap",
                                   "change_gap_median"}
    assert cell["limits"]
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in names
        assert callable(harness.reader(m["name"]))


def test_config_files_are_the_configs_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


def _cfg(name):
    return harness.load_json(ROOT / "portbench" / "configs" / f"{name}.json")


@pytest.mark.parametrize("what, got, want", [
    ("gpt2 step at B 16 x T 1024",
     lambda: gpt2.step_flops(_cfg("gpt2-small"),
                                {"batch": 16, "seq_len": 1024}), 1.3227e13),
    ("resnet50 step at B 128",
     lambda: resnet.batch_flops(_cfg("resnet50"), 128), 2.9327e12),
    ("resnet50 step at B 256",
     lambda: resnet.batch_flops(_cfg("resnet50"), 256), 5.8654e12),
    ("resnet50 batch-norm bytes at B 128 (5.31 ms at 3.35 TB/s)",
     lambda: resnet.bn_bytes(_cfg("resnet50"), 128), 1.7790e10),
])
def test_counts_equal_the_hand_counts(what, got, want):
    assert math.isclose(got(), want, rel_tol=5e-5), what


def test_lm_weights_by_hand():
    # 12 layers x 12 d^2 + the 768 x 50257 head
    assert gpt2.matmul_weights(_cfg("gpt2-small")) == \
        12 * 12 * 768 ** 2 + 768 * 50257


def test_attention_bound_is_bytes_bound_at_t1024():
    cfg, traffic = _cfg("gpt2-small"), {"batch": 16, "seq_len": 1024}
    bound = gpt2.attention_bound_s(cfg, traffic, 989e12, 3.35e12)
    ops_only = gpt2.attention_bound_s(cfg, traffic, 989e12, math.inf)
    assert bound > ops_only > 0


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix()
                              for p in SOURCES])
def test_no_jax_and_a_plain_reference(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "deeplearning4j_tpu"}
    if "reference" in path.relative_to(ROOT / "portbench").parts:
        assert "deeplearning4j_tpu_torch" not in tops
    if "tests" not in path.relative_to(ROOT / "portbench").parts:
        text = path.read_text(encoding="utf-8")
        assert "bench.py" not in text.replace("portbench", "")
        assert "BENCH_" not in text and "MULTICHIP_" not in text


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["deeplearning4j_tpu_torch.nn", "jax_utils", "torch"]) == []
    assert harness.forbidden_modules(
        ["deeplearning4j_tpu.nn", "jax.numpy", "flax"]) == \
        ["deeplearning4j_tpu", "flax", "jax"]


def _context(name, kernels):
    cell = harness.resolve(name, BENCH)
    peak = harness.load_json(ROOT / "portbench" / "peaks.json")[
        "NVIDIA H100 80GB HBM3"]
    window = {"steps": 10, "seconds": 5.0, "flops_per_step": 2e13}
    trace = {"steps": 2, "window_s": 1.0, "busy_s": 0.8,
             "kernels": kernels}
    return harness.Context(cell["config"], cell["traffic"], window, trace,
                           peak)


KERNELS = [
    ("void dl4j_bn::batchnorm_fwd<2, true>(dl4j_bn::Args)", 0.05),
    ("void dl4j_bn_gen::batchnorm_bwd<2>(dl4j_bn_gen::Args)", 0.05),
    ("void flash_fwd_f32_kernel<64>(Params)", 0.02),
    ("void attention_dkv_kernel<64, true>(Params)", 0.02),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.4),
]


@pytest.mark.parametrize("name", CELLS)
def test_each_per_layer_reader_reads_a_trace(name):
    ctx = _context(name, KERNELS)
    for m in harness.resolve(name, BENCH)["per_layer"]:
        value = harness.reader(m["name"])(ctx)
        assert value is not None and math.isfinite(value) and value > 0, \
            m["name"]
        if m["unit"] == "%":
            assert value <= 100.0, m["name"]


@pytest.mark.parametrize("name", CELLS)
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    ctx = _context(name, [])
    for m in harness.resolve(name, BENCH)["per_layer"]:
        if m["name"].split(".")[0] != "mfu":
            assert harness.reader(m["name"])(ctx) is None, m["name"]
