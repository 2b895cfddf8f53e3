"""Device-affine data queue (the JAX package's ``parallel/magic_queue.py``;
reference core/parallelism/MagicQueue.java).

One queue per device: ``add`` puts a DataSet, copied onto the next device
round-robin (or onto every device, ``mode="broadcast"``), and ``poll(i)``
takes from device ``i``'s queue, so a worker polls batches that already
live on its device. ``devices`` defaults to every CUDA device; a list may
repeat a device (``[torch.device("cpu")] * 4`` in the tests)."""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence

import torch

from ..ops.dataset import DataSet
from .mesh import make_mesh


class MagicQueue:
    def __init__(self, num_devices: Optional[int] = None, capacity: int = 8,
                 mode: str = "sequential",
                 devices: Optional[Sequence] = None):
        devs = list(make_mesh(devices=devices).devices.flat)
        self.num_devices = num_devices or len(devs)
        self._devices = [devs[i % len(devs)]
                         for i in range(self.num_devices)]
        self._queues: List[queue.Queue] = [
            queue.Queue(maxsize=capacity) for _ in range(self.num_devices)]
        self._next = 0
        self._lock = threading.Lock()
        self.mode = mode  # "sequential" round-robin | "broadcast"

    def _put_on_device(self, ds, dev) -> DataSet:
        def put(a):
            if a is None:
                return None
            t = a if torch.is_tensor(a) else torch.as_tensor(a)
            return t.to(dev)
        return DataSet(put(ds.features), put(ds.labels),
                       put(ds.features_mask), put(ds.labels_mask))

    def add(self, ds) -> None:
        if self.mode == "broadcast":
            for i, q in enumerate(self._queues):
                q.put(self._put_on_device(ds, self._devices[i]))
            return
        with self._lock:
            i = self._next
            self._next = (self._next + 1) % self.num_devices
        self._queues[i].put(self._put_on_device(ds, self._devices[i]))

    def poll(self, device_index: int, timeout: Optional[float] = None):
        """Non-blocking when ``timeout`` is None (an empty queue gives
        None, the reference's poll contract), else a bounded wait."""
        try:
            if timeout is None:
                return self._queues[device_index].get_nowait()
            return self._queues[device_index].get(timeout=timeout)
        except queue.Empty:
            return None

    def size(self, device_index: Optional[int] = None) -> int:
        if device_index is not None:
            return self._queues[device_index].qsize()
        return sum(q.qsize() for q in self._queues)
