"""Synchronous data-parallel trainer for ComputationGraph (the JAX
package's ``parallel/graph_wrapper.py``; the reference ParallelWrapper
accepts a MultiLayerNetwork or a ComputationGraph).

The batch (a DataSet or a MultiDataSet) is padded to divide evenly with
zero-weight rows and split into one row block per ``data`` shard of the
mesh; :func:`~.wrapper.sync_step` runs every shard and applies the summed
gradient once, as ``ParallelWrapper``'s sync mode does (through the
vertex-synchronous walk where a batch norm needs the whole batch)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .mesh import Mesh, make_mesh
from .wrapper import data_devices, pad_dataset, split_rows, sync_step


class GraphDataParallelTrainer:
    def __init__(self, net, mesh: Optional[Mesh] = None):
        self.net = net
        self.mesh = mesh if mesh is not None else make_mesh()
        self.devices = data_devices(self.mesh)

    @property
    def num_workers(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))

    def fit_batch(self, ds):
        net = self.net
        net._ensure_init()
        padded = pad_dataset(ds, self.num_workers)
        score, new_state = sync_step(net, self.devices,
                                     split_rows(padded, len(self.devices)))
        net._after_step(score, new_state)

    def fit(self, data, num_epochs: int = 1):
        from ..datasets.iterators import AsyncDataSetIterator, as_iterator
        for _ in range(num_epochs):
            it = as_iterator(data)
            if getattr(it, "async_supported", True):
                it = AsyncDataSetIterator(it, device_put=False)
            for ds in it:
                self.fit_batch(ds)
            self.net.epoch += 1
        return self
