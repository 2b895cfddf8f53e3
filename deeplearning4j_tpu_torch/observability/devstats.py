"""Device-side cost accounting, sampled OFF the serving hot path — the JAX
package's ``observability/devstats.py`` rewritten for torch.

- **Device memory** — per-device allocator stats from
  ``torch.cuda.memory_stats`` (a CPU-only process reports one ``cpu``
  device with ``memory_stats: None``, as the JAX package does for its
  CPU backend) plus a live-tensor census (count + bytes of distinct
  storages). Read at COLLECTION time, never from the decode loop.
- **KV-cache bytes** — exact per-engine accounting from the engine's
  ACTUAL cache tensors (slots × heads × T_max × Dh × itemsize summed over
  attention layers and k / v on the slab; pages × heads × page_size × Dh
  on the pool), not a formula that can drift from the allocation; a paged
  engine adds its page-granular account (``kv_page_stats``).
- **Per-impl static cost** — the JAX package reads flops / bytes from
  XLA's cost analysis of each compiled program. The port compiles
  nothing, so :func:`impl_cost_analysis` computes them analytically from
  the decoder's layers for every serving program the decoder has
  dispatched (the shapes of its first dispatch, which it records once per
  program): matrix products at 2 flops a multiply-add and attention over
  the cells a program reads (the whole slab row or the mapped pages);
  bytes are the weights read once, the KV cells read and written, and the
  token and logit rows. A ``decode_block{K}`` row is per STEP, as the JAX
  package's rows are (XLA counts a scan body once). This is the
  theoretical side of :mod:`.profiler`'s roofline join.
- **Card peaks** — :func:`device_peaks`, the data-sheet dense bf16 and
  memory peaks of the card the process runs on (:data:`CARD_PEAKS`), the
  roofline join's peaks where no ``DL4J_TPU_PEAK_*`` variable sets them.

Everything here is host-side observation: nothing launches device work,
and every probe degrades to a partial snapshot instead of failing the
view.
"""

from __future__ import annotations

import gc
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from .metrics import MetricsRegistry, default_registry


def _live_census() -> dict:
    """Count and bytes of the distinct tensor storages alive in this
    process (a gc walk: collection time only)."""
    seen = set()
    count = total = 0
    for obj in gc.get_objects():
        try:
            if not torch.is_tensor(obj):
                continue
            st = obj.untyped_storage()
            key = (st.device.type, st.device.index, st.data_ptr())
        except Exception:   # noqa: BLE001 — meta / sparse tensors
            continue
        if key in seen:
            continue
        seen.add(key)
        count += 1
        total += int(st.nbytes())
    return {"count": count, "bytes": total}


def device_memory_snapshot() -> dict:
    """Per-device allocator stats + the live-tensor census. Guarded end to
    end: without a CUDA device the one ``cpu`` row reports
    ``memory_stats: None`` and the census still stands."""
    devices = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            row = {"id": i, "platform": "gpu",
                   "kind": torch.cuda.get_device_name(i)}
            try:
                ms = torch.cuda.memory_stats(i)
                row["memory_stats"] = {
                    "bytes_in_use": int(ms.get(
                        "allocated_bytes.all.current", 0)),
                    "peak_bytes_in_use": int(ms.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(torch.cuda.get_device_properties(
                        i).total_memory),
                    "largest_alloc_size": int(ms.get(
                        "max_split_size", 0) or 0),
                    "pool_bytes": int(ms.get(
                        "reserved_bytes.all.current", 0)),
                }
            except Exception:   # noqa: BLE001 — a probe must not fail
                row["memory_stats"] = None
            devices.append(row)
    else:
        devices.append({"id": 0, "platform": "cpu", "kind": "cpu",
                        "memory_stats": None})
    try:
        census = _live_census()
    except Exception:   # noqa: BLE001
        census = {"count": None, "bytes": None}
    return {"devices": devices, "live_arrays": census}


def kv_cache_stats(engine) -> dict:
    """Exact KV-cache byte accounting from the engine's cache tensors.
    ``bytes`` is the global logical allocation; ``addressable_bytes`` is
    what the devices hold (on a mesh a page pool's copy per data group
    counts each time) and ``shards`` the mesh coordinates one layer's k
    spans (1 on one device); ``slot_shape`` is [S, H, T_max, Dh] on the
    slab and the POOL shape [P, H, page_size, Dh] on a paged engine,
    whose ``bytes_per_slot`` is bytes per page. A sharded engine's stats
    carry its ``mesh`` tag ("2x2")."""
    from ..parallel.mesh import ShardedTensor, mesh_tag
    caches = getattr(engine, "_caches", None)
    if not caches:
        return {"bytes": 0, "layers": 0}
    leaves = [x for layer in caches.values() for x in layer.values()
              if torch.is_tensor(x) or isinstance(x, ShardedTensor)]
    total = sum(x.numel() * x.element_size() for x in leaves)
    addressable = sum(x.addressable_bytes if isinstance(x, ShardedTensor)
                      else x.numel() * x.element_size() for x in leaves)
    first = leaves[0]
    out = {
        "bytes": int(total),
        "addressable_bytes": int(addressable),
        "shards": max(x.num_shards if isinstance(x, ShardedTensor) else 1
                      for x in leaves),
        "layers": len(caches),
        "slot_shape": list(first.shape),
        "dtype": str(first.dtype).replace("torch.", ""),
        "bytes_per_slot": int(total) // max(1, int(first.shape[0])),
    }
    try:
        fn = getattr(engine, "kv_page_stats", None)
        pages = fn() if fn is not None else None
    except Exception:   # noqa: BLE001 — a probe must not fail the view
        pages = None
    if pages is not None:
        out["paged"] = True
        out["pages"] = pages
        used = pages.get("used", 0)
        out["pages"]["share_ratio"] = round(
            pages.get("shared", 0) / used, 4) if used else 0.0
    mesh = getattr(engine, "mesh", None)
    if mesh is not None:
        out["mesh"] = mesh_tag(mesh)
    return out


def _decoder_dims(decoder) -> dict:
    """Layer sizes the analytic costs need: weight elements of every
    matrix product a token goes through (attention projections, feed
    forward, output head; the embedding is a gather), attention layers,
    heads and head size, and the compute itemsize."""
    net = decoder.net
    embed_names = {name for name, v in net.conf.vertices.items()
                   if getattr(v, "layer", None) is decoder.embed}
    matmul = 0
    for vname, params in net.params.items():
        if vname in embed_names:
            continue
        for p in params.values():
            if torch.is_tensor(p) and p.dim() >= 2:
                matmul += p.numel()
    layer = net.conf.vertices[decoder.attn_names[0]].layer
    heads = int(layer.num_heads)
    dh = int(layer._head_size())
    return {"matmul": int(matmul), "layers": len(decoder.attn_names),
            "heads": heads, "dh": dh,
            "itemsize": torch.empty((), dtype=net.compute_dtype)
            .element_size(), "vocab": int(decoder.vocab_size)}


def program_cost(decoder, name: str, shape: dict) -> dict:
    """flops / bytes_accessed of serving program ``name`` at ``shape``
    (rows ``b``, query tokens a row ``q``, cells read a row ``ctx``):
    2 flops a multiply-add over every weight for every query token, q·kᵀ
    and p·v over the cells read, the weights once, the cells read and the
    new cells written once, int64 tokens in and logits rows out."""
    d = _decoder_dims(decoder)
    b, q, ctx = int(shape["b"]), int(shape["q"]), int(shape["ctx"])
    tokens = b * q
    hd = d["heads"] * d["dh"]
    flops = 2 * tokens * d["matmul"] + \
        d["layers"] * 2 * 2 * b * q * ctx * hd
    kv_read = d["layers"] * 2 * b * ctx * hd * d["itemsize"]
    kv_write = d["layers"] * 2 * tokens * hd * d["itemsize"]
    nbytes = d["matmul"] * d["itemsize"] + kv_read + kv_write + \
        tokens * 8 + b * d["vocab"] * 4
    return {"flops": int(flops), "bytes_accessed": int(nbytes)}


def impl_cost_analysis(decoder, refresh: bool = False) -> Dict[str, dict]:
    """flops / bytes-accessed per serving program the decoder has
    dispatched (its ``_cost_seam``: program name → [shape of the first
    dispatch, memoized cost]), computed on first request and memoized on
    the seam. ``decode_block{K}`` rows are per step."""
    seam = getattr(decoder, "_cost_seam", None)
    if not seam:
        return {}
    out: Dict[str, dict] = {}
    for name, entry in sorted(seam.items()):
        shape, cost = entry
        if cost is None or refresh:
            try:
                cost = program_cost(decoder, name, shape)
            except Exception as e:   # noqa: BLE001 — best-effort telemetry
                cost = {"error": f"{type(e).__name__}: {e}"[:200]}
            entry[1] = cost
        out[name] = cost
    return out


#: data-sheet peaks by ``torch.cuda.get_device_name()``: (dense bf16
#: GFLOP/s, memory GB/s). H100 SXM5: 989 TFLOP/s, HBM3 3.35 TB/s.
CARD_PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989_000.0, 3_350.0),
}


def device_peaks() -> Optional[Tuple[float, float]]:
    """(dense bf16 GFLOP/s, memory GB/s) of the current CUDA card; None
    without a card or for a card :data:`CARD_PEAKS` lacks."""
    if not torch.cuda.is_available():
        return None
    return CARD_PEAKS.get(torch.cuda.get_device_name())


class DeviceStats:
    """Aggregating view: engines attach once; ``snapshot()`` assembles
    device memory + per-engine KV bytes + per-impl cost on demand.

    Registry integration: ``devstats_live_array_bytes`` /
    ``devstats_live_arrays`` gauges (collection-time callbacks) and a
    ``devstats_kv_cache_bytes{engine=...}`` gauge per attached engine —
    all weakref'd, so a retired engine reads 0 instead of being pinned
    (with its device caches) by the registry."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._registry = registry if registry is not None \
            else default_registry()
        self._lock = threading.Lock()
        self._engines: Dict[str, weakref.ref] = {}
        reg = self._registry
        self._g_kv = reg.gauge("devstats_kv_cache_bytes",
                               "KV-cache bytes allocated (global)",
                               ("engine",))
        reg.gauge("devstats_live_arrays",
                  "live tensor storages").set_function(_live_count)
        reg.gauge("devstats_live_array_bytes",
                  "live tensor storage bytes").set_function(_live_bytes)

    def attach_engine(self, name: str, engine) -> "DeviceStats":
        wref = weakref.ref(engine)
        with self._lock:
            self._engines[str(name)] = wref
        self._g_kv.labels(str(name)).set_function(
            lambda: (lambda e: 0 if e is None else
                     kv_cache_stats(e).get("bytes", 0))(wref()))
        return self

    def snapshot(self) -> dict:
        out = device_memory_snapshot()
        kv = {}
        costs = {}
        with self._lock:
            engines = dict(self._engines)
        for name, wref in sorted(engines.items()):
            eng = wref()
            if eng is None:
                continue
            try:
                kv[name] = kv_cache_stats(eng)
            except Exception as e:   # noqa: BLE001 — degrade per engine
                kv[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
            dec = getattr(eng, "decoder", None)
            if dec is not None:
                try:
                    costs.update(impl_cost_analysis(dec))
                except Exception as e:   # noqa: BLE001
                    costs[name] = {"error":
                                   f"{type(e).__name__}: {e}"[:200]}
        out["kv_cache"] = kv
        out["impl_cost"] = costs
        return out


def _live_count() -> int:
    try:
        return _live_census()["count"]
    except Exception:   # noqa: BLE001
        return 0


def _live_bytes() -> int:
    try:
        return _live_census()["bytes"]
    except Exception:   # noqa: BLE001
        return 0


__all__: List[str] = ["DeviceStats", "device_memory_snapshot",
                      "impl_cost_analysis", "kv_cache_stats",
                      "program_cost"]
