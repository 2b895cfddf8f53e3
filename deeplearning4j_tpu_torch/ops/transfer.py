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
synchronisation a copy from pageable memory implies.

:func:`stage_to_device` is the training feed's host→device half: a host
batch bound for the card is cast, in one multi-threaded pass, straight
into a pinned block of the caching host allocator in the narrower of its
own and its target dtype, and copied from there without a stream
synchronisation; what the wire dtype leaves undone (an int32 → int64
widening) runs on the card. The host's cast rounds to nearest even as
the card's does, so a float batch lands bit-identical to a copy followed
by a cast on the card. Inputs already on the device, inputs already in
pinned memory and CPU targets take the direct path. :func:`stage_counts`
counts both paths.

A mesh-sharded decoder gathers its shards' results on its controller
device and marks the gathered tensor with their count
(:func:`mark_shards`); the one readback of it records that count under
its tag (:func:`fetch_shards`: data x tp on a serving mesh, 1 without
one), as the JAX package's seam records a sharded array's device set."""

from __future__ import annotations

import threading
import warnings
from collections import Counter
from typing import Dict, Optional

import numpy as np
import torch

_LOCK = threading.Lock()
_COUNTS: Counter = Counter()
#: per tag: the mesh shards the most recent fetch under it gathered
_SHARDS: Dict[str, int] = {}
#: host→device transfers: ``staged`` (and their ``staged_bytes``, the
#: bytes on the wire) through a pinned stage, ``direct`` without one
_STAGE: Counter = Counter()


class HostCopy:
    """A device→host copy in flight: the host tensor, the event that
    marks its completion (None for a tensor that already lives on the
    CPU) and the mesh shards its source was gathered from."""

    __slots__ = ("host", "event", "shards")

    def __init__(self, host: torch.Tensor, event, shards: int = 1):
        self.host = host
        self.event = event
        self.shards = shards


def mark_shards(x: torch.Tensor, n: int) -> torch.Tensor:
    """Mark ``x`` as gathered from ``n`` mesh shards; returns ``x``."""
    if n > 1:
        x.mesh_shards = int(n)
    return x


def start_fetch(x: torch.Tensor) -> HostCopy:
    """Start copying ``x`` to the host behind the work already queued on
    the current stream, without waiting for it."""
    shards = getattr(x, "mesh_shards", 1)
    if x.device.type != "cuda":
        return HostCopy(x.detach().clone(), None, shards)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x.detach(), non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return HostCopy(host, event, shards)


def device_fetch(x, tag: str = "default") -> np.ndarray:
    """Blocking device→host readback, counted under ``tag``. ``x`` is a
    tensor or a :class:`HostCopy` started earlier; for the latter only its
    own copy is waited for. Use one call per decode BLOCK, never per
    token. One call stays one count however many mesh shards ``x`` was
    gathered from; the shard count is recorded beside it."""
    shards = x.shards if isinstance(x, HostCopy) else \
        getattr(x, "mesh_shards", 1)
    with _LOCK:
        _COUNTS[tag] += 1
        _SHARDS[tag] = int(shards)
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


def fetch_shards(tag: Optional[str] = None) -> Dict[str, int]:
    """Mesh shards gathered by the most recent fetch per tag (1 on one
    device; data x tp on a serving mesh)."""
    with _LOCK:
        if tag is not None:
            return {tag: _SHARDS.get(tag, 1)}
        return dict(_SHARDS)


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


def host_tensor(a) -> torch.Tensor:
    """``a`` as a tensor, without a copy wherever torch can view it: a
    tensor as it is, a numpy array (strided or read-only) in place, any
    other array-like through ``np.asarray``. Negative strides, which
    torch cannot view, are copied."""
    if torch.is_tensor(a):
        return a
    arr = np.asarray(a)
    if any(s < 0 for s in arr.strides):
        arr = np.ascontiguousarray(arr)
    if arr.flags.writeable:
        return torch.from_numpy(arr)
    with warnings.catch_warnings():     # the view is only ever read
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        return torch.from_numpy(arr)


def _takes_stage(t: torch.Tensor, device: torch.device) -> bool:
    """A tensor in pageable host memory bound for the card is staged."""
    return device.type == "cuda" and t.device.type == "cpu" and \
        not t.is_pinned()


def _host_stage(t: torch.Tensor, dtype: torch.dtype,
                pin_memory: bool = True) -> torch.Tensor:
    """The host half of a stage: ``t`` cast in one multi-threaded pass
    into a new (pinned) block in the wire dtype, the narrower of its own
    and ``dtype`` (equal widths take ``dtype``), counted as staged."""
    wire = dtype if dtype.itemsize <= t.element_size() else t.dtype
    stage = torch.empty(t.shape, dtype=wire, pin_memory=pin_memory)
    stage.copy_(t)
    with _LOCK:
        _STAGE["staged"] += 1
        _STAGE["staged_bytes"] += stage.nbytes
    return stage


def stage_to_device(a, device, dtype=None) -> torch.Tensor:
    """A host array or tensor on ``device`` in ``dtype`` (None keeps its
    own). From pageable host memory to the card it is staged: cast on the
    host into a pinned block of the caching host allocator (which keeps
    the block alive until the copy that reads it completes, and reuses
    it), copied without a host/device sync, and converted to ``dtype`` on
    the card where the wire dtype is not yet it. The caller may overwrite
    ``a`` once this returns. Anything else is direct: a pinned tensor is
    copied without a sync and converted on the card; a tensor already on
    a device, or a CPU target, converts as ``Tensor.to`` does."""
    t = host_tensor(a)
    device = torch.device(device)
    dtype = t.dtype if dtype is None else dtype
    if _takes_stage(t, device):
        return _host_stage(t, dtype).to(device, non_blocking=True).to(dtype)
    with _LOCK:
        _STAGE["direct"] += 1
    if t.device.type == "cpu" and device.type == "cuda":
        return t.to(device, non_blocking=True).to(dtype)
    return t.to(device, dtype)


def stage_counts() -> Dict[str, int]:
    """Snapshot of the host→device transfer counters: ``staged``,
    ``staged_bytes`` and ``direct``."""
    with _LOCK:
        return {k: _STAGE.get(k, 0)
                for k in ("staged", "staged_bytes", "direct")}
