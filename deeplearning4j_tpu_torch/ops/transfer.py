"""Host-transfer seam: every deliberate device→host readback on the serving
path goes through :func:`device_fetch`, counted per tag, as in the JAX
package's ``ops/transfer.py``.

On the card a readback has two halves. :func:`start_fetch` enqueues a
non-blocking copy of a just-computed tensor into pinned host memory and
records an event right behind it, at dispatch time; :func:`device_fetch`
later waits for that event only. A plain ``.cpu()`` at fetch time would
queue its copy behind everything dispatched since, so the double-buffered
decode pipeline would wait for the NEXT block too. :func:`to_device` is the
matching host→device half: it copies from pinned memory without the stream
synchronisation a copy from pageable memory implies."""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

_LOCK = threading.Lock()
_COUNTS: Counter = Counter()


class HostCopy:
    """A device→host copy in flight: the host tensor and the event that
    marks its completion (None for a tensor that already lives on the
    CPU)."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event


def start_fetch(x: torch.Tensor) -> HostCopy:
    """Start copying ``x`` to the host behind the work already queued on
    the current stream, without waiting for it."""
    if x.device.type != "cuda":
        return HostCopy(x.detach().clone(), None)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x.detach(), non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return HostCopy(host, event)


def device_fetch(x, tag: str = "default") -> np.ndarray:
    """Blocking device→host readback, counted under ``tag``. ``x`` is a
    tensor or a :class:`HostCopy` started earlier; for the latter only its
    own copy is waited for. Use one call per decode BLOCK, never per
    token."""
    with _LOCK:
        _COUNTS[tag] += 1
    if isinstance(x, HostCopy):
        if x.event is not None:
            x.event.synchronize()
        return x.host.numpy()
    return x.detach().cpu().numpy()


def fetch_counts(tag: Optional[str] = None) -> Dict[str, int]:
    """Snapshot of the per-tag readback counters (all tags, or one)."""
    with _LOCK:
        if tag is not None:
            return {tag: _COUNTS.get(tag, 0)}
        return dict(_COUNTS)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """Host array → tensor on ``device`` without a host/device sync: on
    the card the bytes go through pinned memory and a non-blocking copy
    (the caching host allocator keeps the pinned block alive until the
    copy completes)."""
    t = torch.from_numpy(np.array(a))     # a writable, contiguous copy
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
