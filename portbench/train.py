"""The driver of a training cell (a traffic file of ``kind`` "train").

Set-up builds one ``ComputationGraph`` from the configuration, copies in
the weights drawn from the seed, and drives that same object through the
traffic's ``check_steps`` steps by ``fit_batch`` on the ring's first
batches (all rows differ), reading what the comparison takes: each
step's loss, each leaf's first gradient as the optimizer got it (worked
out from its state after step 1) and each leaf's change after the last
check step. ``warm_steps`` more steps follow; then the window runs
``fit_batch`` over the ring for ``--seconds``, reading the loss back
every ``readback_every`` steps, and ends with a device synchronisation.
A traced run then profiles ``trace_steps`` more steps.

Once the window has closed and the peak memory is read, the program is
freed and the plain reference (``reference/<architecture>.py``) runs the
same check steps in float32 from the same seed; ``compare.py`` decides
``correct``."""

from __future__ import annotations

import gc
import importlib
import math
import time
from typing import Dict

import torch

from . import compare, costs, feeds, trace
from .reference import common


def _modules(cfg: Dict):
    arch = cfg["architecture"]
    return (importlib.import_module(f"portbench.reference.{arch}"),
            importlib.import_module(f"portbench.program.{arch}"))


def build_program(cfg: Dict, device):
    """The program's network for ``cfg`` on ``device``."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    _, program = _modules(cfg)
    dtype = getattr(torch, cfg["training"]["compute_dtype"])
    return ComputationGraph(program.conf(cfg), compute_dtype=dtype,
                            device=device).init()


def load_weights(net, cfg: Dict, seed: int, device) -> None:
    """Copy the weights drawn from ``seed`` into the program's masters;
    raises where the program's leaves are not the reference's."""
    ref, _ = _modules(cfg)
    specs = ref.param_specs(cfg)
    want = {f"{v}.{k}": tuple(s) for v, k, s, _ in specs}
    have = {f"{v}.{k}": tuple(p.shape) for v, ps in net.params.items()
            for k, p in ps.items()}
    if want != have:
        raise RuntimeError(f"the program's leaves differ from the "
                           f"reference's: {sorted(set(want) ^ set(have))[:8]}"
                           f" or their shapes")
    weights = common.make_params(specs, feeds.sub_seed(seed, "weights"),
                                 device)
    with torch.no_grad():
        for v, ps in weights.items():
            for k, w in ps.items():
                net.params[v][k].copy_(w)


def _dataset(batch):
    from deeplearning4j_tpu_torch.ops.dataset import DataSet
    return DataSet(*batch)


def program_readings(net, cfg: Dict, traffic: Dict, ring, seed: int,
                     device) -> Dict:
    """Drive ``net`` through the check steps and read each step's loss,
    the first gradients and the changes (see the module's docstring)."""
    ref, _ = _modules(cfg)
    upd = common.updater_of(cfg)
    losses, grads = [], {}
    for i in range(traffic["check_steps"]):
        with trace.span("fit_batch"):
            net.fit_batch(_dataset(ring[i % len(ring)]))
        losses.append(net.score_value)
        if i == 0:
            with torch.no_grad():
                grads = {f"{v}.{k}": upd.first_gradient(s).norm()
                         for v, st in net.updater_state.items()
                         for k, s in st.items()}
    start = common.make_params(ref.param_specs(cfg),
                               feeds.sub_seed(seed, "weights"), device)
    start_state = common.make_state(ref.state_specs(cfg), device)
    with torch.no_grad():
        change = {f"{v}.{k}": (net.params[v][k] - p).norm()
                  for v, ps in start.items() for k, p in ps.items()}
        change.update({f"{v}.{k}": (net.state[v][k] - s).norm()
                       for v, st in start_state.items()
                       for k, s in st.items()})
    del start, start_state
    return {"losses": [float(x) for x in losses],
            "grads": {k: float(x) for k, x in grads.items()},
            "change": {k: float(x) for k, x in change.items()}}


def reference_readings(cfg: Dict, traffic: Dict, ring, seed: int, device,
                       precision: str = "f32") -> Dict:
    """The plain reference's readings of the same check steps from the
    same seed, its products in ``precision``."""
    ref, _ = _modules(cfg)
    common.set_strict_f32()
    params = common.make_params(ref.param_specs(cfg),
                                feeds.sub_seed(seed, "weights"), device)
    state = common.make_state(ref.state_specs(cfg), device)
    batches = [tuple(torch.from_numpy(a).to(device) for a in ring[i])
               for i in range(traffic["check_steps"])]
    return common.train_readings(ref, cfg, params, state, batches, precision)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(net, ring, start: int, traffic: Dict, seconds: float, device):
    """``fit_batch`` over the ring from batch ``start`` for ``seconds``;
    (its start on the host clock, steps, seconds, steps whose read-back
    loss was not finite, the seconds from the start at each read-back)."""
    every = traffic["readback_every"]
    _sync(device)
    t0 = time.perf_counter()
    steps = failed = 0
    marks = []
    while True:
        with trace.span("handoff"):
            ds = _dataset(ring[(start + steps) % len(ring)])
        with trace.span("fit_batch"):
            net.fit_batch(ds)
        steps += 1
        last = steps % every == 0
        if last:
            with trace.span("readback"):
                loss = float(net.score_value)
            failed += 0 if math.isfinite(loss) else every
            marks.append(time.perf_counter() - t0)
        if time.perf_counter() - t0 >= seconds:
            break
    if not last:
        loss = float(net.score_value)
        failed += 0 if math.isfinite(loss) else steps % every
    _sync(device)
    return t0, steps, time.perf_counter() - t0, failed, marks


def run(cell: Dict, seed: int, seconds: float, traced: bool, device,
        t_process: float) -> Dict:
    """One run of a training cell: the result line's fields and the
    numbers compared beside their limits (``checks``)."""
    cfg, traffic = cell["config"], cell["traffic"]
    ring = feeds.make_ring(cfg, traffic, seed, device)
    net = build_program(cfg, device)
    load_weights(net, cfg, seed, device)
    got = program_readings(net, cfg, traffic, ring, seed, device)
    at = traffic["check_steps"]
    for i in range(at, at + traffic["warm_steps"]):
        net.fit_batch(_dataset(ring[i % len(ring)]))
    at += traffic["warm_steps"]
    t_window, steps, window_s, failed, marks = _window(net, ring, at,
                                                       traffic, seconds,
                                                       device)
    at += steps
    flops = costs.step_flops(cfg, traffic)
    rate = steps * feeds.units_per_step(traffic) / window_s
    out = {"attempted": steps, "failed": failed,
           "end_to_end": {"setup_s": t_window - t_process,
                          f"train_{traffic['units']}_per_s": rate},
           "window": {"steps": steps, "seconds": window_s,
                      "flops_per_step": flops,
                      "readback_every": traffic["readback_every"],
                      "readbacks_s": marks}}
    if traced:
        def step(i):
            with trace.span("handoff"):
                ds = _dataset(ring[(at + i) % len(ring)])
            with trace.span("fit_batch"):
                net.fit_batch(ds)
        out["trace"] = trace.run_traced(step, traffic["trace_steps"])
    _sync(device)
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del net
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_readings(cfg, traffic, ring, seed, device)
    out["checks"] = compare.checks(got, want, cell["limits"])
    return out


def program_fault(name: str):
    """Context managers that break the program's timed path underneath,
    for the tests that see ``correct`` come out false. ``state``: a step
    that leaves the parameters unchanged; ``half_batch``: half of each
    batch left out, the loss the mean over the rest."""
    from contextlib import contextmanager
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    @contextmanager
    def patched(attr, make):
        orig = getattr(ComputationGraph, attr)
        setattr(ComputationGraph, attr, make(orig))
        try:
            yield
        finally:
            setattr(ComputationGraph, attr, orig)

    if name == "state":
        return patched("_apply_gradients", lambda orig: (
            lambda self, by_vertex: None))
    if name == "half_batch":
        def make(orig):
            def fit_batch(self, ds):
                n = ds.features.shape[0] // 2
                return orig(self, type(ds)(ds.features[:n], ds.labels[:n]))
            return fit_batch
        return patched("fit_batch", make)
    raise ValueError(f"unknown fault {name!r}")


FAULTS = ("state", "half_batch")
