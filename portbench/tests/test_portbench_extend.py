"""A later change adds a configuration of a new architecture, its feed, its
traffic, its cell and a per-layer metric as new files and entries alone:
here a made-up two-layer classifier is dropped into a copy of the
benchmark and runs there on the CPU, with no file of the copy edited
but ``BENCHMARK.json``."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

FILES = {
    "configs/toy-mlp.json": {
        "name": "toy-mlp", "architecture": "toymlp",
        "source": "a made-up two-layer classifier", "reduced": [],
        "n_in": 24, "hidden": 40, "classes": 6,
        "training": {"compute_dtype": "float32", "master_dtype": "float32",
                     "updater": "nesterovs", "learning_rate": 0.05,
                     "momentum": 0.9},
        "tiny": {}},
    "traffic/toy_vectors.json": {
        "name": "toy_vectors", "kind": "train", "feed": "vectors",
        "batch": 32, "ring": 4, "readback_every": 5, "check_steps": 3,
        "warm_steps": 1, "trace_steps": 2, "units": "rows",
        "tiny": {}},
    "limits/toy-train.json": {"loss_gap": 1e-5, "grad_gap": 1e-4,
                              "change_gap": 1e-4},
}

MODULES = {
    "reference/toymlp.py": '''
        import torch.nn.functional as F


        def param_specs(cfg):
            n, h, c = cfg["n_in"], cfg["hidden"], cfg["classes"]
            return [("hidden", "W", (n, h), "normal:0.2"),
                    ("hidden", "b", (h,), "zeros"),
                    ("out", "W", (h, c), "normal:0.2"),
                    ("out", "b", (c,), "zeros")]


        def state_specs(cfg):
            return {}


        def loss(cfg, params, state, batch, precision="f32"):
            x, y = batch
            h = F.relu(x @ params["hidden"]["W"] + params["hidden"]["b"])
            logits = h @ params["out"]["W"] + params["out"]["b"]
            return F.cross_entropy(logits, y.long()), state
        ''',
    "program/toymlp.py": '''
        from deeplearning4j_tpu_torch.nn.conf.config import \\
            NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
        from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, \\
            OutputLayer


        def conf(cfg):
            t = cfg["training"]
            g = (NeuralNetConfiguration.Builder()
                 .learning_rate(t["learning_rate"]).updater(t["updater"])
                 .momentum(t["momentum"]).graph_builder()
                 .add_inputs("input"))
            g.add_layer("hidden", DenseLayer(n_out=cfg["hidden"],
                                             activation="relu"), "input")
            g.add_layer("out", OutputLayer(n_out=cfg["classes"],
                                           loss="mcxent",
                                           activation="softmax"), "hidden")
            return (g.set_outputs("out")
                    .set_input_types(InputType.feed_forward(cfg["n_in"]))
                    .build())
        ''',
    "costs/toymlp.py": '''
        def step_flops(cfg, traffic):
            weights = cfg["n_in"] * cfg["hidden"] + \\
                cfg["hidden"] * cfg["classes"]
            return 6 * weights * traffic["batch"]
        ''',
    "feeds/vectors.py": '''
        import torch


        def make(cfg, traffic, g, device):
            ring, b = traffic["ring"], traffic["batch"]
            x = torch.randn((ring, b, cfg["n_in"]), generator=g,
                            device=device).cpu().numpy()
            y = torch.randint(0, cfg["classes"], (ring, b), generator=g,
                              device=device).to(torch.int32).cpu().numpy()
            return [(x[i], y[i]) for i in range(ring)]


        def units_per_step(traffic):
            return traffic["batch"]
        ''',
}

SCRIPT = '''
import json, time, torch
from portbench import harness
from portbench.tests import tiny
cell = tiny.cell("toy-train")
line, *_ = harness.run(cell, 2 ** 31 + 17, 0.3, False, torch.device("cpu"),
                       time.perf_counter(),
                       {"platform": "cpu", "kind": "cpu", "count": 1})
print(json.dumps({"line": line,
                  "reader": harness.reader("mfu.toy").__module__}))
'''


def test_a_made_up_architecture_dropped_in_as_files_runs(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    for rel, data in FILES.items():
        (tmp_path / "portbench" / rel).write_text(json.dumps(data))
    for rel, text in MODULES.items():
        (tmp_path / "portbench" / rel).write_text(textwrap.dedent(text))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-mlp", "source": "made up",
                             "file": "portbench/configs/toy-mlp.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-train", "config": "toy-mlp",
                               "traffic": "toy_vectors", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "train_rows_per_s", "unit": "rows/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy-train"]})
    bench["per_layer"].append({"name": "mfu.toy", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "whole step", "moves":
                               "train_rows_per_s", "workloads": ["toy-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    line = out["line"]
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_rows_per_s", "setup_s"}
    assert out["reader"] == "portbench.metrics._mfu"
    for path, data in before.items():
        assert path.read_bytes() == data, path
