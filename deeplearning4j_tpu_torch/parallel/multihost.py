"""Multi-process training (the JAX package's ``parallel/multihost.py``):
process wiring, a host-side mean across processes, and atomic interval
checkpoints.

:func:`initialize` joins this process to the others of a run through a
``torch.distributed.TCPStore`` that process 0 hosts at the coordinator
address; one process (no address) is a no-op. Each process then trains
over its own devices (:func:`global_mesh`), and ``ParallelWrapper``
completes the step's (or the averaging round's) reduction across
processes with :func:`host_allreduce_mean`: every process publishes its
flat f64 buffer under the reduction's tag, reads every peer's and takes
the mean, in process order, so every process holds the same bytes. No
NCCL or gloo rank is involved: the store carries the bytes.
:class:`CheckpointManager` saves from process 0 only, atomically, on an
interval, and every process restores the same file."""

from __future__ import annotations

import atexit
import base64
import os
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .mesh import make_mesh

#: the store and this process's place in the run, set by initialize()
_RUN = {"store": None, "count": 1, "index": 0}


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 300.0) -> None:
    """Join the run at ``coordinator_address`` (``host:port``; process 0
    hosts the store there), with the environment's COORDINATOR_ADDRESS,
    NUM_PROCESSES and PROCESS_ID in place of absent arguments. No address
    means a single process: nothing happens. Blocks until every process
    has joined."""
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address is None:
        return
    count = int(num_processes if num_processes is not None
                else os.environ.get("NUM_PROCESSES", 1))
    index = int(process_id if process_id is not None
                else os.environ.get("PROCESS_ID", 0))
    host, _, port = address.rpartition(":")
    from torch.distributed import TCPStore
    store = TCPStore(host, int(port), world_size=count,
                     is_master=index == 0,
                     timeout=timedelta(seconds=timeout_s),
                     wait_for_workers=True)
    _RUN.update(store=store, count=count, index=index)
    atexit.register(shutdown)


def shutdown(timeout_s: float = 60.0) -> None:
    """Leave the run: wait until every process has reached this point (so
    process 0 keeps hosting the store while peers still read from it),
    then forget the store."""
    store = _RUN["store"]
    if store is None:
        return
    store.set(f"dl4j/done/{_RUN['index']}", "1")
    store.wait([f"dl4j/done/{p}" for p in range(_RUN["count"])],
               timedelta(seconds=timeout_s))
    _RUN.update(store=None, count=1, index=0)


def process_index() -> int:
    return int(_RUN["index"])


def process_count() -> int:
    return int(_RUN["count"])


def distributed_client():
    """The run's TCPStore (None before :func:`initialize`)."""
    return _RUN["store"]


def global_mesh(axis_names=("data",), shape=None, devices=None):
    """A Mesh over this process's devices (default: every CUDA device;
    ``devices`` may repeat one, e.g. ``[torch.device("cpu")] * 2``)."""
    if devices is not None:
        devices = list(devices)
        if shape is None:
            shape = (len(devices),)
    return make_mesh(axis_names=axis_names, shape=shape, devices=devices)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _as_host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", torch.float64).numpy()
    return np.asarray(leaf, np.float64)


def _like(piece: np.ndarray, leaf):
    if torch.is_tensor(leaf):
        return torch.from_numpy(piece).to(leaf.device, leaf.dtype)
    return piece.astype(np.asarray(leaf).dtype)


def _blocking_get(store, key: str, timeout_ms: int) -> str:
    store.wait([key], timedelta(milliseconds=timeout_ms))
    return store.get(key).decode("ascii")


def host_allreduce_mean(tree, tag: str, timeout_ms: int = 60_000):
    """The mean across processes of a tree (dicts, lists) of tensors or
    arrays, each leaf back in its own dtype and device. Each process
    publishes its flat f64 buffer under ``tag``, blocks for every peer's
    and averages them in process order. A single process returns ``tree``
    unchanged.

    Keys are WRITE-ONCE: the buffer is published with
    ``compare_set(key, "", payload)``, which never overwrites. ``tag``
    must be unique per logical reduction and the same on every process.
    Re-publishing the same payload (an idempotent retry) is benign; a
    reused tag with a different payload raises and names the tag, since
    every peer would otherwise read the earlier reduction's buffers. (A
    reused tag whose payload happens to be byte-identical cannot be told
    from a retry here.)"""
    store = distributed_client()
    n = process_count()
    if store is None or n <= 1:
        return tree
    leaves = _leaves(tree)
    arrs = [_as_host(leaf) for leaf in leaves]
    flat = np.concatenate([a.ravel() for a in arrs]) if arrs \
        else np.zeros(0, np.float64)
    key = f"dl4j/hostavg/{tag}"
    payload = base64.b64encode(flat.tobytes()).decode("ascii")
    held = store.compare_set(f"{key}/{process_index()}", "", payload)
    if isinstance(held, bytes):
        held = held.decode("ascii")
    if held != payload:
        raise ValueError(
            f"host_allreduce_mean tag '{tag}' was already used with a "
            f"different payload: store keys are write-once, so reusing a "
            f"tag returns every peer's STALE buffers. Use a unique tag per "
            f"logical reduction (e.g. suffix a step counter).")
    acc = np.zeros_like(flat)
    for p in range(n):
        acc += np.frombuffer(
            base64.b64decode(_blocking_get(store, f"{key}/{p}", timeout_ms)),
            np.float64)
    acc /= n
    out, off = [], 0
    for a, leaf in zip(arrs, leaves):
        out.append(_like(acc[off:off + a.size].reshape(a.shape), leaf))
        off += a.size
    return _rebuild(tree, iter(out))


class CheckpointManager:
    """Interval checkpoints for preemption-safe resume: process 0 writes
    ``checkpoint_iter<N>.zip`` (with updater state, and a normalizer when
    given) through a temporary file and ``os.replace``, keeps the newest
    ``keep``; every process restores the newest."""

    def __init__(self, directory, interval_seconds: float = 600.0,
                 keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.interval = float(interval_seconds)
        self.keep = int(keep)
        self._last = 0.0

    def maybe_save(self, net, normalizer=None, force: bool = False) -> bool:
        if process_index() != 0:
            return False
        now = time.monotonic()
        if not force and now - self._last < self.interval:
            return False
        self._last = now
        from ..utils.serializer import write_model
        tmp_fd, tmp_path = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        os.close(tmp_fd)
        try:
            write_model(net, tmp_path, save_updater=True,
                        normalizer=normalizer)
            os.replace(tmp_path,
                       self.dir / f"checkpoint_iter{net.iteration}.zip")
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
        self._gc()
        return True

    def _checkpoints(self):
        return sorted(self.dir.glob("checkpoint_iter*.zip"),
                      key=lambda p: int(p.stem.split("iter")[1]))

    def _gc(self):
        for p in self._checkpoints()[:-self.keep]:
            p.unlink()

    def latest(self) -> Optional[Path]:
        ckpts = self._checkpoints()
        return ckpts[-1] if ckpts else None

    def restore_latest(self, graph: bool = False, device=None,
                       compute_dtype=None):
        """The newest checkpoint as a ComputationGraph (``graph``) or a
        MultiLayerNetwork, None when there is none; ``device=None`` means
        the card."""
        from ..utils.serializer import (restore_computation_graph,
                                        restore_multi_layer_network)
        path = self.latest()
        if path is None:
            return None
        restore = restore_computation_graph if graph \
            else restore_multi_layer_network
        return restore(path, device, compute_dtype)
