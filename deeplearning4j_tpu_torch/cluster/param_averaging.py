"""Cluster-synchronous parameter-averaging DP (the JAX package's
``cluster/param_averaging.py``; reference
spark/impl/paramavg/ParameterAveragingTrainingMaster.java,
ParameterAveragingTrainingWorker.java:172).

Semantics:
- the dataset is cut into *splits*; one split per averaging round;
- each split's partitions are fitted by workers starting from the current
  master's parameters (the Spark broadcast: each task clones the
  master's net, on that net's device);
- worker results (params [+ updater state] + counts) are aggregated with
  element-add / combine functions (reference :860) and averaged;
- the averaged params are set on the master's net before the next split;
- optional export approach: minibatches are written to files once and
  streamed back per split (RDDTrainingApproach.Export);
- per-phase timings are collected when ``collect_training_stats`` is on.

This is the cluster orchestration layer; the single-controller
collective over a device mesh is ``parallel/wrapper.py``'s local-steps
mode."""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import tempfile
from typing import List, Optional

import numpy as np

from ..parallel.wrapper import tree_map
from .api import (RDDTrainingApproach, Repartition, TrainingMaster,
                  TrainingWorker, WorkerConfiguration)
from .rdd import DistributedDataSet
from .stats import ClusterTrainingStats, PhaseTimer


class ParameterAveragingTrainingWorker(TrainingWorker):
    """Executor-side worker: fit the local replica on partition minibatches
    (reference ParameterAveragingTrainingWorker.java:172 processMinibatch)."""

    def __init__(self, net, conf: WorkerConfiguration, hooks=None):
        self.net = net
        self.conf = conf
        self.hooks = hooks or []
        self.timer = PhaseTimer()

    def get_initial_model(self):
        with self.timer.phase("model_broadcast_copy"):
            return self.net.clone()

    def process_minibatch(self, dataset, model, is_last: bool):
        for h in self.hooks:
            h.pre_update(dataset, model)
        with self.timer.phase("fit"):
            model.fit([dataset])
        for h in self.hooks:
            h.post_update(dataset, model)

    def get_final_result(self, model):
        with self.timer.phase("result_serialization"):
            return {"params": model.params_flat(),
                    "updater": model.updater_state,
                    "count": 1,
                    "score": float(model.score_value)
                    if model.score_value is not None else 0.0,
                    "events": list(self.timer.events)}


class ParameterAveragingTrainingMaster(TrainingMaster):
    def __init__(self, batch_size_per_worker: Optional[int] = None,
                 averaging_frequency: int = 1,
                 num_workers: Optional[int] = None,
                 average_updaters: bool = True,
                 repartition: Repartition = Repartition.ALWAYS,
                 rdd_training_approach: RDDTrainingApproach =
                 RDDTrainingApproach.DIRECT,
                 export_directory: Optional[str] = None,
                 collect_training_stats: bool = False):
        self.worker_conf = WorkerConfiguration(
            batch_size_per_worker=batch_size_per_worker,
            collect_training_stats=collect_training_stats)
        self.averaging_frequency = max(1, int(averaging_frequency))
        self.num_workers = num_workers
        self.average_updaters = average_updaters
        self.repartition = repartition
        self.approach = rdd_training_approach
        self.export_directory = export_directory
        self.hooks: List = []
        self.stats: Optional[ClusterTrainingStats] = \
            ClusterTrainingStats() if collect_training_stats else None

    # ------------------------------------------------------------------ SPI
    def set_collect_training_stats(self, flag: bool) -> None:
        self.stats = ClusterTrainingStats() if flag else None

    def get_training_stats(self):
        return self.stats

    def add_hook(self, hook) -> None:
        self.hooks.append(hook)

    def get_worker(self, network) -> ParameterAveragingTrainingWorker:
        return ParameterAveragingTrainingWorker(network, self.worker_conf,
                                                self.hooks)

    # ------------------------------------------------------------- training
    def execute_training(self, network, data: DistributedDataSet) -> None:
        if self.worker_conf.batch_size_per_worker is not None:
            data = self._rebatch(data,
                                 self.worker_conf.batch_size_per_worker)
        if self.approach is RDDTrainingApproach.EXPORT:
            data = self._export_and_reload(data)
        n_workers = self.num_workers or data.num_executors
        if self.repartition is Repartition.ALWAYS or (
                self.repartition is
                Repartition.NUM_PARTITIONS_WORKERS_DIFFERS
                and data.num_partitions != n_workers):
            data = data.repartition(n_workers)
        # reference semantics: parameters are averaged after each worker has
        # fitted ``averaging_frequency`` minibatches — so one split holds
        # n_workers * averaging_frequency batches and the split count grows
        # as frequency shrinks (frequency=1 → tightest sync)
        per_split = n_workers * self.averaging_frequency
        num_splits = max(1, data.count() // per_split)
        splits = data.random_split(num_splits) if num_splits > 1 else [data]
        for split in splits:
            self._run_split(network, split)

    def _run_split(self, network, split: DistributedDataSet) -> None:
        stats = self.stats

        max_batches = self.worker_conf.max_batches_per_worker

        def fit_partition(partition):
            if not partition:
                return None      # empty partition: no replica to average in
            # one worker (and thus one PhaseTimer) PER TASK: partitions run
            # concurrently and events must not bleed between results
            worker = self.get_worker(network)
            model = worker.get_initial_model()
            n_fit = len(partition) if max_batches is None \
                else min(len(partition), max_batches)
            for i in range(n_fit):
                ds = partition[i]
                if isinstance(ds, str):      # export-approach path entry
                    ds = _load_file(ds)
                worker.process_minibatch(ds, model, i == n_fit - 1)
            return worker.get_final_result(model)

        if stats:
            stats.timer.start("map_partitions")
        results = [r for r in split.map_partitions(fit_partition)
                   if r is not None]
        if not results:
            return
        if stats:
            stats.timer.end("map_partitions")
            for r in results:
                stats.add_worker_events(r.pop("events", []))
            stats.timer.start("aggregate_average")
        else:
            for r in results:
                r.pop("events", None)

        # element-add params/updater/counts across workers, then divide
        # (ParameterAveragingElementAdd/CombineFunction analog)
        def add(a, b):
            out = {"params": a["params"] + b["params"],
                   "count": a["count"] + b["count"],
                   "score": a["score"] + b["score"]}
            if self.average_updaters and a.get("updater") is not None \
                    and b.get("updater") is not None:
                out["updater"] = tree_map(lambda x, y: x + y,
                                          a["updater"], b["updater"])
            else:
                out["updater"] = None
            return out

        agg = functools.reduce(add, results)
        n = max(1, agg["count"])
        network.set_params_flat(np.asarray(agg["params"]) / n)
        if self.average_updaters and agg["updater"] is not None:
            network.updater_state = tree_map(lambda x: x / n,
                                             agg["updater"])
        network.score_value = agg["score"] / n
        network.iteration += 1
        if stats:
            stats.timer.end("aggregate_average")

    # ---------------------------------------------------------- re-batching
    @staticmethod
    def _rebatch(data: DistributedDataSet, bs: int) -> DistributedDataSet:
        """Concatenate the dataset's examples and re-slice into minibatches
        of ``batch_size_per_worker`` (the reference worker's re-batching).
        Masked sequence batches are passed through unchanged — their time
        dimensions may disagree across batches."""
        from ..ops.dataset import DataSet
        flat = [d for p in data.partitions for d in p]
        if not flat or any(isinstance(d, str) or d.features_mask is not None
                           or d.labels_mask is not None for d in flat):
            return data
        shapes = {d.features.shape[1:] for d in flat}
        if len(shapes) > 1:
            return data
        feats = np.concatenate([d.features for d in flat])
        labels = None if flat[0].labels is None else \
            np.concatenate([d.labels for d in flat])
        batches = [DataSet(feats[i:i + bs],
                           None if labels is None else labels[i:i + bs])
                   for i in range(0, len(feats), bs)]
        return DistributedDataSet.from_datasets(
            batches, data.num_partitions, num_executors=data.num_executors,
            max_task_retries=data.max_task_retries)

    # ------------------------------------------------------------ export IO
    def _export_and_reload(self, data: DistributedDataSet) \
            -> DistributedDataSet:
        """Write minibatches as files ONCE, rebuild the dataset as partitions
        of file *paths* streamed back inside the worker tasks (reference
        export-based RDDTrainingApproach). A matching prior export in the
        same directory is reused (epoch 2+ pays no serialization I/O)."""
        outdir = self.export_directory or tempfile.mkdtemp(
            prefix="dl4j_export_")
        self.export_directory = outdir     # re-fit reuses the same export
        os.makedirs(outdir, exist_ok=True)
        n = data.count()
        paths = [os.path.join(outdir, f"dataset_{i:06d}.bin")
                 for i in range(n)]
        # content fingerprint guards against silently reusing a stale export
        # of a DIFFERENT same-sized dataset in the same directory
        flat = [d for p in data.partitions for d in p]
        fp = hashlib.sha256()
        fp.update(str(n).encode())
        for ds in (flat[0], flat[-1]) if flat else ():
            fp.update(str(np.asarray(ds.features).shape).encode())
            fp.update(np.ascontiguousarray(ds.features).tobytes())
        fingerprint = fp.hexdigest()
        manifest = os.path.join(outdir, "export_manifest.txt")
        stale = True
        if os.path.exists(manifest) and all(os.path.exists(p)
                                            for p in paths):
            with open(manifest) as f:
                stale = f.read().strip() != fingerprint
        if stale:
            i = 0
            for part in data.partitions:
                for ds in part:
                    with open(paths[i], "wb") as f:
                        pickle.dump(ds, f)
                    i += 1
            with open(manifest, "w") as f:
                f.write(fingerprint)
        return DistributedDataSet.from_datasets(
            paths, data.num_partitions, num_executors=data.num_executors,
            max_task_retries=data.max_task_retries)


def _load_file(path):
    with open(path, "rb") as f:
        return pickle.load(f)
