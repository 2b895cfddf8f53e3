"""Device meshes for one controller (the JAX package's
``parallel/mesh.py``): a named grid of ``torch.device`` entries, the
canonical ``(data, tp)`` serving mesh, its validation, and
:class:`ShardedTensor`, a tensor laid out over such a grid.

One process drives every shard. A mesh entry is only a device: the
decoder that runs on the mesh keeps each coordinate's slice of the
weights and caches on that coordinate's device and combines the shards
with explicit reductions, in a fixed order, on the host's schedule. The
device list may repeat a device, which is how one card holds a 2 x 2
mesh (every coordinate on ``cuda:0``), as the JAX package's tests put
every shard on a virtual CPU device.

:func:`make_mesh` builds named multi-axis meshes with clear validation
errors (axis arity, device budget), :func:`generation_mesh` is the
canonical 2-axis ``(data, tp)`` serving mesh, and
:func:`validate_decode_mesh` checks the decode divisibility contract
(attention heads over ``tp``, cache slots over ``data``) before anything
is dispatched, where the message can name the knob to change."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

#: canonical serving-mesh axis names: batch / cache slots shard over
#: ``data``, attention heads / projection columns over ``tp``
DATA_AXIS = "data"
TP_AXIS = "tp"


class P(tuple):
    """A partition spec: for each tensor dim, the mesh axis name it splits
    over (or a tuple of names, split row-major), None where every
    coordinate holds the whole extent. Trailing dims left out are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class Mesh:
    """Named axes over a numpy object array of ``torch.device``:
    ``devices`` has one dim per axis, ``shape`` maps axis name → size in
    axis order (``mesh.shape.get("tp", 1)`` reads as in JAX)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(str(a) for a in axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"Mesh: devices of rank {arr.ndim} but "
                             f"{len(axis_names)} axis names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"Mesh: repeated axis name in {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, arr.shape))

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    def coords(self):
        """Every coordinate tuple, row-major."""
        return list(np.ndindex(*self.devices.shape))

    def device(self, coord) -> torch.device:
        return self.devices[tuple(coord)]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def _default_devices():
    return [torch.device(f"cuda:{i}")
            for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A Mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device). For multi-axis meshes pass ``shape``, e.g. shape=(4, 2),
    axis_names=("data", "tp"). ``devices`` may repeat a device, e.g.
    ``[torch.device("cuda:0")] * 4`` puts a 2 x 2 mesh on one card."""
    defaulted = devices is None
    devs = _default_devices() if defaulted else \
        [torch.device(d) for d in devices]
    budget = (f"torch.cuda.device_count()={len(devs)}" if defaulted else
              f"{len(devs)} listed")
    fix = ("list a device more than once to put several shards on it, "
           "e.g. devices=[torch.device(\"cuda:0\")] * N")
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"make_mesh(n_devices={n_devices}) but only {len(devs)} "
                f"device(s) are available ({budget}); {fix}")
        devs = devs[:n_devices]
    axis_names = tuple(axis_names)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(
                f"make_mesh: {len(axis_names)} axis names {axis_names} "
                "but no shape — pass shape=(...), one size per axis "
                "(e.g. shape=(2, 2) for axes ('data', 'tp'))")
        shape = (len(devs),)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"make_mesh: shape {shape} has {len(shape)} dims but "
            f"axis_names {axis_names} has {len(axis_names)} — one size "
            "per named axis")
    if any(s < 1 for s in shape):
        raise ValueError(f"make_mesh: shape {shape} — every axis size "
                         "must be >= 1")
    need = int(np.prod(shape))
    if need > len(devs):
        raise ValueError(
            f"mesh shape {shape} ({dict(zip(axis_names, shape))}) needs "
            f"{need} devices but only {len(devs)} are available "
            f"({budget}); shrink an axis or {fix}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devs[:need]):
        arr[i] = d
    return Mesh(arr.reshape(shape), axis_names)


def generation_mesh(data: int = 1, tp: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """The canonical serving mesh: ``(data, tp)`` with cache slots / batch
    rows sharded over ``data`` and attention heads over ``tp``."""
    return make_mesh(axis_names=(DATA_AXIS, TP_AXIS),
                     shape=(int(data), int(tp)), devices=devices)


def parse_mesh_shape(text: str) -> Tuple[int, int]:
    """``"2x1"`` → ``(2, 1)``; a bare ``"2"`` means ``(2, 1)`` (data-
    parallel decode). The soak and probe CLIs share this grammar."""
    s = str(text).strip().lower()
    parts = s.split("x")
    if len(parts) == 1:
        parts = [parts[0], "1"]
    if len(parts) != 2:
        raise ValueError(f"mesh shape '{text}' — expected 'DATAxTP' "
                         "(e.g. '2x1') or a bare device count")
    try:
        data, tp = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"mesh shape '{text}' — sizes must be integers "
                         "('DATAxTP', e.g. '1x2')") from None
    if data < 1 or tp < 1:
        raise ValueError(f"mesh shape '{text}' — axis sizes must be >= 1")
    return data, tp


def mesh_axis_sizes(mesh: Mesh, data_axis: str = DATA_AXIS,
                    tp_axis: str = TP_AXIS) -> Tuple[int, int]:
    """(data size, tp size); an absent axis counts as size 1, so 1-axis
    data meshes and 2-axis serving meshes share one code path."""
    return (int(mesh.shape.get(data_axis, 1)),
            int(mesh.shape.get(tp_axis, 1)))


def validate_decode_mesh(mesh: Mesh, num_heads: Optional[int] = None,
                         num_slots: Optional[int] = None,
                         data_axis: str = DATA_AXIS,
                         tp_axis: str = TP_AXIS) -> None:
    """Decode divisibility contract, checked before any device work:
    attention heads shard over ``tp`` (the [S, H, T, Dh] cache splits on
    H), cache slots over ``data`` (the cache splits on S). Pass only the
    quantities the caller owns (the decoder checks heads, the engine
    slots)."""
    data, tp = mesh_axis_sizes(mesh, data_axis, tp_axis)
    if num_heads is not None and tp > 1 and int(num_heads) % tp:
        raise ValueError(
            f"num_heads {num_heads} is not divisible by the '{tp_axis}' "
            f"axis size {tp} — the KV cache shards heads over "
            f"'{tp_axis}'; use a head count divisible by {tp} or a "
            "smaller tp axis")
    if num_slots is not None and data > 1 and int(num_slots) % data:
        raise ValueError(
            f"num_slots {num_slots} is not divisible by the "
            f"'{data_axis}' axis size {data} — cache slots shard over "
            f"'{data_axis}'; use a slot count divisible by {data} or a "
            "smaller data axis")


def serving_grid(mesh: Mesh, data_axis: str = DATA_AXIS,
                 tp_axis: str = TP_AXIS) -> np.ndarray:
    """[data, tp] object array of mesh coordinate tuples: entry (d, t) is
    the coordinate of data group d's tp shard t. A mesh axis other than
    these two must have size 1."""
    extra = {a: n for a, n in mesh.shape.items()
             if a not in (data_axis, tp_axis) and n > 1}
    if extra:
        raise ValueError(f"a serving mesh shards over '{data_axis}' and "
                         f"'{tp_axis}' only; axes {extra} have size > 1")
    data, tp = mesh_axis_sizes(mesh, data_axis, tp_axis)
    grid = np.empty((data, tp), dtype=object)
    for d in range(data):
        for t in range(tp):
            grid[d, t] = tuple(d if a == data_axis else
                               t if a == tp_axis else 0
                               for a in mesh.axis_names)
    return grid


def mesh_tag(mesh: Optional[Mesh]) -> str:
    """Short attribution tag for a mesh ("2x1" for a (data=2, tp=1)
    serving mesh; generic meshes join every axis size): the suffix of the
    decoder's per-mesh program names."""
    if mesh is None:
        return ""
    return "x".join(str(int(mesh.shape[a])) for a in mesh.axis_names)


def replicated(mesh: Mesh) -> P:
    """The spec of a tensor every coordinate holds whole."""
    return P()


def batch_sharded(mesh: Mesh, axis: str = DATA_AXIS) -> P:
    """The spec of a tensor whose dim 0 (batch) splits over ``axis``."""
    if axis not in mesh.shape:
        raise ValueError(f"axis '{axis}' absent from the mesh axes "
                         f"{mesh.axis_names}")
    return P(axis)


def shard_batch_spec(ndim: int, axis: str = DATA_AXIS) -> P:
    """Spec sharding dim 0 (batch) over ``axis``."""
    return P(axis, *([None] * (ndim - 1)))


# ------------------------------------------------------------ placement
def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _split_of(mesh: Mesh, entry, coord) -> Tuple[int, int]:
    """(this coordinate's part index, number of parts) along one dim whose
    spec entry is ``entry`` (several axes split row-major)."""
    idx, n = 0, 1
    for a in _axes(entry):
        size = mesh.shape[a]
        idx = idx * size + coord[mesh.axis_index(a)]
        n *= size
    return idx, n


def local_slice(mesh: Mesh, spec, coord, t: torch.Tensor) -> torch.Tensor:
    """The part of ``t`` that coordinate ``coord`` holds under ``spec``
    (a view, on ``t``'s device)."""
    out = t
    for dim, entry in enumerate(tuple(spec)):
        idx, n = _split_of(mesh, entry, coord)
        if n > 1:
            step = t.shape[dim] // n
            out = out.narrow(dim, idx * step, step)
    return out


class ShardedTensor:
    """A tensor laid out over a mesh by ``spec``: ``shards`` is an object
    array shaped like ``mesh.devices`` whose entry at a coordinate is the
    local part on that coordinate's device (:func:`local_slice` of the
    global tensor). ``shape`` and ``numel()`` are the global tensor's; a
    dim no axis splits is held whole by every coordinate (the paged pool
    replicates over data that way), so ``addressable_bytes`` counts every
    copy."""

    def __init__(self, mesh: Mesh, spec, shards: np.ndarray, shape,
                 dtype: torch.dtype):
        self.mesh = mesh
        self.spec = P(*tuple(spec))
        self.shards = shards
        self.shape = torch.Size(shape)
        self.dtype = dtype

    @classmethod
    def zeros(cls, mesh: Mesh, spec, shape, dtype) -> "ShardedTensor":
        """Born sharded: each coordinate allocates only its part."""
        shards = np.empty(mesh.devices.shape, dtype=object)
        for c in mesh.coords():
            local = list(shape)
            for dim, entry in enumerate(tuple(spec)):
                local[dim] //= _split_of(mesh, entry, c)[1]
            shards[c] = torch.zeros(local, dtype=dtype,
                                    device=mesh.device(c))
        return cls(mesh, spec, shards, shape, dtype)

    @classmethod
    def from_global(cls, mesh: Mesh, spec, t: torch.Tensor
                    ) -> "ShardedTensor":
        """``t`` laid out by ``spec``: each coordinate a contiguous copy of
        its :func:`local_slice` on its device."""
        shards = np.empty(mesh.devices.shape, dtype=object)
        for c in mesh.coords():
            shards[c] = local_slice(mesh, spec, c, t).to(
                mesh.device(c), copy=True).contiguous()
        return cls(mesh, spec, shards, t.shape, t.dtype)

    def local(self, coord) -> torch.Tensor:
        return self.shards[tuple(coord)]

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (coordinate 0's by default),
        each coordinate's part copied to its place."""
        first = tuple([0] * self.shards.ndim)
        device = self.shards[first].device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for c in self.mesh.coords():
            view = out
            for dim, entry in enumerate(tuple(self.spec)):
                idx, n = _split_of(self.mesh, entry, c)
                if n > 1:
                    step = self.shape[dim] // n
                    view = view.narrow(dim, idx * step, step)
            view.copy_(self.shards[c])
        return out

    @property
    def num_shards(self) -> int:
        """Mesh coordinates the tensor spans (data x tp on a serving mesh,
        however many distinct devices they name)."""
        return int(self.shards.size)

    def numel(self) -> int:
        return int(np.prod(self.shape)) if len(self.shape) else 1

    def element_size(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def addressable_bytes(self) -> int:
        return sum(int(s.numel()) * s.element_size()
                   for s in self.shards.flat)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, spec={self.spec}, "
                f"mesh={mesh_tag(self.mesh)})")
