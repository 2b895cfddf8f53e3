"""User-facing cluster wrappers (the JAX package's ``cluster/network.py``;
reference spark/impl/multilayer/SparkDl4jMultiLayer.java:582 fit /
evaluate / scoreExamples, spark/impl/graph/SparkComputationGraph.java).
The network trains and evaluates on its own device: the card unless it
was built on the CPU."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .api import TrainingMaster
from .rdd import DistributedDataSet


class _ClusterModelBase:
    def __init__(self, network, training_master: TrainingMaster):
        network._ensure_init()
        self.network = network
        self.training_master = training_master

    def fit(self, data, num_epochs: int = 1):
        if not isinstance(data, DistributedDataSet):
            data = DistributedDataSet.from_datasets(list(data))
        for _ in range(num_epochs):
            self.training_master.execute_training(self.network, data)
            self.network.epoch += 1
        return self.network

    def evaluate(self, data):
        """Distributed evaluation: per-partition Evaluation merged on the
        master (reference SparkDl4jMultiLayer.evaluate merge path). Graph
        networks route through ComputationGraph.do_evaluation (first output
        head; use evaluate_outputs for all heads)."""
        from ..eval import Evaluation
        if not isinstance(data, DistributedDataSet):
            data = DistributedDataSet.from_datasets(list(data))
        net = self.network

        def eval_partition(partition):
            if hasattr(net, "evaluate_outputs"):   # ComputationGraph only
                first = net.conf.network_outputs[0]
                return net.do_evaluation(partition,
                                         {first: Evaluation()})[first]
            ev = Evaluation()
            for ds in partition:
                out = net.output(ds.features)
                ev.eval(np.asarray(ds.labels), np.asarray(out),
                        mask=None if ds.labels_mask is None
                        else np.asarray(ds.labels_mask))
            return ev

        parts = data.map_partitions(eval_partition)
        merged = parts[0]
        for other in parts[1:]:
            merged.merge(other)
        return merged

    def evaluate_outputs(self, data):
        """Distributed per-output evaluation for multi-output graphs:
        {output_name: Evaluation}, partition results merged per head
        (reuses ComputationGraph.do_evaluation)."""
        if not isinstance(data, DistributedDataSet):
            data = DistributedDataSet.from_datasets(list(data))
        net = self.network
        if not hasattr(net, "evaluate_outputs"):
            raise TypeError("evaluate_outputs requires a ComputationGraph")

        parts = data.map_partitions(net.evaluate_outputs)
        merged = parts[0]
        for other in parts[1:]:
            for name, ev in other.items():
                merged[name].merge(ev)
        return merged

    def score_examples(self, data):
        """Per-example scores across the cluster (scoreExamples analog)."""
        if not isinstance(data, DistributedDataSet):
            data = DistributedDataSet.from_datasets(list(data))
        net = self.network

        def score_partition(partition):
            return [net.score(ds) for ds in partition]

        return [s for part in data.map_partitions(score_partition)
                for s in part]

    def get_score(self) -> Optional[float]:
        v = self.network.score_value
        return None if v is None else float(v)


class ClusterDl4jMultiLayer(_ClusterModelBase):
    pass


class ClusterComputationGraph(_ClusterModelBase):
    pass
