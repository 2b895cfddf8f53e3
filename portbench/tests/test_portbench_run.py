"""A run of each cell at tiny sizes on the CPU: the plain reference
agrees with the program's float32 path, the result line has the keys
the contract names, and each fault planted under the timed path makes
``correct`` false. The card tests run each cell for a few seconds at its
own sizes: ``python -m pytest portbench/tests -q`` on a machine with a
card."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, feeds, harness, train, trace
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = tiny.CELLS
BENCH_CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
CPU = torch.device("cpu")
INFO = {"platform": "cpu", "kind": "cpu", "count": 1}


def _run(cell, seed=2 ** 31 + 11, seconds=0.3):
    return harness.run(cell, seed, seconds, False, CPU, time.perf_counter(),
                       INFO)[:2]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_programs_f32_path(name):
    cell = tiny.cell(name)
    cell["config"]["training"]["compute_dtype"] = "float32"
    line, _ = _run(cell)
    assert line["correct"]
    for c in line["checks"].values():
        assert c["value"] <= 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_the_contracts_keys(name):
    cell = tiny.cell(name)
    line, where = _run(cell)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(cell["limits"]) == set(where)
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert line["attempted"] > 0 and line["failed"] == 0
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("fault", train.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    cell = tiny.cell(name)
    with train.program_fault(fault):
        line, _ = _run(cell)
    assert not line["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_in_the_programs_place_is_not_correct(
        name, monkeypatch):
    def control(net, cfg, traffic, ring, seed, device):
        return train.reference_readings(cfg, traffic, ring, seed, device,
                                        "fp8")
    monkeypatch.setattr(train, "program_readings", control)
    line, _ = _run(tiny.cell(name))
    assert not line["correct"]


def test_a_nan_reading_fails_its_limit():
    got = {"losses": [float("nan")], "grads": {"a": 1.0},
           "change": {"a": 1.0}}
    want = {"losses": [1.0], "grads": {"a": 1.0}, "change": {"a": 1.0}}
    checked = compare.checks(got, want, {"loss_gap": 1.0, "grad_gap": 1.0,
                                         "change_gap": 1.0})
    assert not compare.correct(checked)


@pytest.mark.parametrize("name", CELLS)
def test_the_ring_is_drawn_from_the_seed(name):
    cell = tiny.cell(name)
    cfg, traffic = cell["config"], cell["traffic"]
    a = feeds.make_ring(cfg, traffic, 2 ** 31 + 5, CPU)
    b = feeds.make_ring(cfg, traffic, 2 ** 31 + 5, CPU)
    c = feeds.make_ring(cfg, traffic, 2 ** 31 + 6, CPU)
    assert len(a) == traffic["ring"]
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b))
    assert not np.array_equal(a[0][0], c[0][0])
    assert a[0][0].shape[0] == a[0][1].shape[0] == traffic["batch"]
    if traffic["feed"] == "tokens":
        assert a[0][0].shape == (traffic["batch"], traffic["seq_len"])
        assert 0 <= a[0][0].min() and a[0][0].max() < cfg["vocab_size"]
        assert np.array_equal(a[0][0][:, 1:], a[0][1][:, :-1])


def test_trace_summary_unions_device_time_and_labels_gaps():
    X = dict(ph="X", tid=1)
    events = [
        dict(X, cat="user_annotation", name=trace.WINDOW, ts=0, dur=100),
        dict(X, cat="user_annotation", name="portbench.fit_batch", ts=0,
             dur=60),
        dict(X, cat="cpu_op", name="aten::mm", ts=5, dur=30),
        dict(X, cat="cpu_op", name="aten::copy_", ts=40, dur=40),
        dict(ph="X", tid=2, cat="cpu_op", name="ConvolutionBackward0",
             ts=65, dur=20),
        dict(ph="X", tid=7, cat="kernel", name="k1", ts=10, dur=20),
        dict(ph="X", tid=7, cat="kernel", name="k2", ts=20, dur=20),
        dict(ph="X", tid=8, cat="gpu_memcpy", name="HtoD", ts=60, dur=10),
        dict(ph="X", tid=7, cat="kernel", name="k1", ts=95, dur=20),
    ]
    s = trace.summarize(events, steps=2)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(45e-6)     # 10-40, 60-70, 95-100
    assert len(s["kernels"]) == 3
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({
        "fit_batch": 10e-6,                                     # 0-10
        "fit_batch: aten::copy_": 20e-6,                        # 40-60
        "outside spans: ConvolutionBackward0": 25e-6})          # 70-95
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(25e-6)


def test_without_a_card_the_run_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", BENCH_CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


@pytest.mark.card
@pytest.mark.parametrize("name", BENCH_CELLS)
def test_each_cell_runs_correct_on_the_card(card, name):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 3), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
