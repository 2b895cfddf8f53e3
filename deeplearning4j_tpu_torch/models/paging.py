"""Paged KV-cache allocation and the content-hashed prefix cache (the JAX
package's ``models/paging.py``): the host-side half of the paged serving
path. The pools and the gather/scatter attention over page tables live in
``nn/conf/layers/attention.py`` and ``models/generation.py``.

- :class:`PageAllocator`: a free-list allocator over ``page_size``-token
  pages. Page 0 is the reserved null page: unmapped table entries point
  at it and redirected writes land in it; it is never attended.
  Allocation is all-or-nothing and evicts cache-only prefix pages
  LRU-first under pressure.
- The prefix cache publishes every full page of a served context under a
  running chain digest (blake2b over the previous page's digest and this
  page's int32 token bytes), so a digest commits to the whole prefix. A
  prompt whose chain prefix is resident maps those pages read-only
  (refcount + 1) and prefills only its tail; a shared page is always full
  and never written again.
- Refcounts: one per slot mapping plus one retention ref held by the
  prefix index; :meth:`PageAllocator.audit` proves the balance.
- :class:`PageFrameSet`: one context's pages on the host, with a bulk and
  a per-page wire encoding, both byte-identical to the JAX package's.
  bfloat16 pages travel as raw 2-byte words under the dtype name
  ``"bfloat16"``, so neither JAX nor ``ml_dtypes`` is needed to read or
  write them.

All public allocator methods are atomic under one internal lock."""

from __future__ import annotations

import collections
import hashlib
import json
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability.integrity import page_content_checksum

#: default page size (tokens per page); the fleet's routing key hashes the
#: same page boundaries as the engine's prefix cache
DEFAULT_PAGE_SIZE = 16

#: reserved null/trash page
NULL_PAGE = 0

#: chain-digest domain separator (versioned)
_CHAIN_SEED = b"dl4j-tpu-kv-chain-v1"


def _page_digest(prev: bytes, tokens: np.ndarray) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(np.ascontiguousarray(np.asarray(tokens, np.int32)).tobytes())
    return h.digest()


def chain_digests(tokens: Sequence, page_size: int) -> List[bytes]:
    """Running prefix digests, one per FULL page of ``tokens``: ``out[j]``
    commits to tokens[0 : (j+1)*page_size]. Tokens hash as int32 bytes, so
    int64 and int32 prompts hash identically."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    out: List[bytes] = []
    prev = _CHAIN_SEED
    for j in range(len(toks) // int(page_size)):
        prev = _page_digest(prev, toks[j * page_size:(j + 1) * page_size])
        out.append(prev)
    return out


def prefix_route_key(tokens: Sequence,
                     page_size: int = DEFAULT_PAGE_SIZE) -> str:
    """Sticky-routing key: the hex chain digest of the last full page of
    ``tokens``, with a trailing sub-page remainder chained in, so the key
    commits to the whole slice the caller chose."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    full = (len(toks) // int(page_size)) * int(page_size)
    ds = chain_digests(toks[:full], page_size)
    prev = ds[-1] if ds else _CHAIN_SEED
    rem = toks[full:]
    if len(rem) or not ds:
        return _page_digest(prev, rem).hex()
    return prev.hex()


class PageAllocator:
    """Free-list page allocator plus the content-hashed prefix index.

    ``num_pages`` includes the null page 0, so ``num_pages - 1`` pages are
    usable. Under pressure :meth:`alloc` evicts cache-only pages (refcount
    exactly 1, the index's) in LRU order; matched chains are touched
    parent-last, so leaves age out before the prefixes they extend."""

    def __init__(self, num_pages: int, page_size: int,
                 prefix_cache: bool = True):
        if int(page_size) < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if int(num_pages) < 2:
            raise ValueError(
                f"num_pages must be >= 2 (page {NULL_PAGE} is the "
                f"reserved null/trash page), got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.prefix_cache = bool(prefix_cache)
        self._lock = threading.Lock()
        self._free: collections.deque = collections.deque(
            range(1, self.num_pages))
        self._refs = np.zeros(self.num_pages, np.int64)
        # chain digest -> page id (one cache ref each), its reverse, and
        # the eviction order (front = coldest)
        self._chains: Dict[bytes, int] = {}
        self._digest_of: Dict[int, bytes] = {}
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self.evictions = 0
        self.alloc_failures = 0

    # -------------------------------------------------------- allocation
    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages, each born with one ref (the caller's
        mapping), or None: never a partial grant. An unsatisfiable request
        fails before evicting anything."""
        n = int(n)
        if n <= 0:
            return []
        with self._lock:
            short = n - len(self._free)
            if short > 0:
                evictable = sum(1 for pid in self._chains.values()
                                if self._refs[pid] == 1)
                if short > evictable:
                    self.alloc_failures += 1
                    return None
                self._evict_locked(short)
            out = [self._free.popleft() for _ in range(n)]
            for pid in out:
                self._refs[pid] += 1
            return out

    def _evict_locked(self, need: int) -> None:
        for dg in list(self._lru):
            if need <= 0:
                return
            pid = self._chains.get(dg)
            if pid is None or self._refs[pid] != 1:
                continue          # still mapped by a slot: not evictable
            del self._chains[dg]
            self._lru.pop(dg, None)
            self._digest_of.pop(pid, None)
            self._unref_locked(pid)     # the cache ref was the last holder
            self.evictions += 1
            need -= 1

    def ref(self, pid: int) -> None:
        """One more holder for an already-held page."""
        with self._lock:
            if self._refs[pid] <= 0:
                raise RuntimeError(f"page {pid}: ref() on an unheld page")
            self._refs[pid] += 1

    def unref(self, pid: int) -> None:
        """Drop one holder; the page returns to the free list at zero."""
        with self._lock:
            self._unref_locked(pid)

    def _unref_locked(self, pid: int) -> None:
        self._refs[pid] -= 1
        if self._refs[pid] < 0:
            raise RuntimeError(f"page {pid}: refcount underflow")
        if self._refs[pid] == 0:
            dg = self._digest_of.pop(pid, None)
            if dg is not None:
                self._chains.pop(dg, None)
                self._lru.pop(dg, None)
            self._free.append(pid)

    # ------------------------------------------------------ prefix cache
    def match_and_ref(self, tokens: Sequence,
                      max_tokens: Optional[int] = None
                      ) -> Tuple[List[int], int]:
        """Longest resident chain prefix of ``tokens`` (whole pages, capped
        at ``max_tokens``), each matched page ref'd for the caller's
        mapping in the same critical section, so no eviction can race the
        map. Returns (page ids, matched tokens)."""
        if not self.prefix_cache:
            return [], 0
        toks = np.asarray(tokens, np.int32).reshape(-1)
        limit = len(toks) if max_tokens is None \
            else min(len(toks), int(max_tokens))
        digests = chain_digests(
            toks[:(limit // self.page_size) * self.page_size],
            self.page_size)
        with self._lock:
            matched: List[Tuple[bytes, int]] = []
            for dg in digests:
                pid = self._chains.get(dg)
                if pid is None:
                    break
                matched.append((dg, pid))
            for _, pid in matched:
                self._refs[pid] += 1
            for dg, _ in reversed(matched):       # parents most recent
                self._lru.move_to_end(dg)
            return ([pid for _, pid in matched],
                    len(matched) * self.page_size)

    def register_chain(self, tokens: Sequence, pages: Sequence[int]) -> int:
        """Publish a served context's FULL pages: ``pages[j]`` holds
        tokens[j*ps : (j+1)*ps]. Resident digests keep their page; new
        entries take one retention ref. Returns the count published."""
        if not self.prefix_cache:
            return 0
        digests = chain_digests(tokens, self.page_size)
        added = 0
        with self._lock:
            n = min(len(digests), len(pages))
            for j in range(n):
                dg = digests[j]
                if dg in self._chains:
                    continue
                pid = int(pages[j])
                if pid == NULL_PAGE or self._refs[pid] <= 0:
                    continue
                self._refs[pid] += 1            # the index's retention
                self._chains[dg] = pid
                self._digest_of[pid] = dg
                self._lru[dg] = None
                added += 1
            for dg in reversed(digests[:n]):    # parents most recent
                if dg in self._lru:
                    self._lru.move_to_end(dg)
        return added

    def cached_page(self, digest: bytes) -> Optional[int]:
        """The page the prefix index holds for ``digest``, or None."""
        with self._lock:
            return self._chains.get(digest)

    def evict_digests(self, digests: Sequence[bytes]) -> int:
        """Drop prefix-index entries by digest (each loses the index's
        retention ref; pages still mapped stay alive until released).
        Returns the entries dropped."""
        n = 0
        with self._lock:
            for dg in digests:
                pid = self._chains.pop(dg, None)
                if pid is None:
                    continue
                self._lru.pop(dg, None)
                self._digest_of.pop(pid, None)
                self._unref_locked(pid)
                n += 1
        return n

    def evict_pages(self, pids: Sequence[int]) -> List[bytes]:
        """Drop any prefix-index entry held on one of ``pids``; returns the
        evicted chain digests."""
        with self._lock:
            dgs = [self._digest_of.get(int(p)) for p in pids]
        dgs = [d for d in dgs if d is not None]
        self.evict_digests(dgs)
        return dgs

    def free_subset(self, pids: Sequence[int]) -> List[int]:
        """The subset of ``pids`` currently on the free list (unheld)."""
        with self._lock:
            return sorted({int(p) for p in pids
                           if int(p) != NULL_PAGE and
                           self._refs[int(p)] == 0})

    # ------------------------------------------------------ observation
    def stats(self) -> Dict[str, int]:
        """Pool state by page: usable, free, used, cached (indexed),
        shared (two or more holders besides the index's retention)."""
        with self._lock:
            free = len(self._free)
            indexed = np.zeros(self.num_pages, np.int64)
            for pid in self._chains.values():
                indexed[pid] = 1
            return {
                "num_pages": self.num_pages - 1,
                "page_size": self.page_size,
                "free": free,
                "used": self.num_pages - 1 - free,
                "cached": len(self._chains),
                "shared": int(np.sum((self._refs - indexed) >= 2)),
                "evictions": int(self.evictions),
                "alloc_failures": int(self.alloc_failures),
            }

    def audit(self, mappings: Sequence[Sequence[int]]) -> List[str]:
        """Refcount balance proof: every page's refcount equals its
        observed holders (one per appearance in ``mappings``, the engine's
        per-slot page lists, plus one if the index retains it); free pages
        are unheld and listed once; page 0 is unheld. [] when clean."""
        problems: List[str] = []
        with self._lock:
            counts = np.zeros(self.num_pages, np.int64)
            for table in mappings:
                for pid in table:
                    counts[int(pid)] += 1
            for pid in self._chains.values():
                counts[int(pid)] += 1
            if counts[NULL_PAGE] or self._refs[NULL_PAGE]:
                problems.append(
                    f"null page held: mapped {int(counts[NULL_PAGE])}x, "
                    f"refcount {int(self._refs[NULL_PAGE])}")
            for pid in range(1, self.num_pages):
                if self._refs[pid] != counts[pid]:
                    problems.append(
                        f"page {pid}: refcount {int(self._refs[pid])} "
                        f"!= {int(counts[pid])} observed holders")
            seen = collections.Counter(self._free)
            for pid, k in seen.items():
                if k != 1:
                    problems.append(f"page {pid}: on the free list "
                                    f"{k} times")
                if self._refs[pid] != 0:
                    problems.append(f"page {pid}: free but refcount "
                                    f"{int(self._refs[pid])}")
            live = self.num_pages - 1 - len(seen)
            held = int(np.sum(self._refs[1:] > 0))
            if live != held:
                problems.append(f"{live} pages off the free list but "
                                f"{held} pages held")
        return problems


# --------------------------------------------------------- page frames
class PageFrameError(ValueError):
    """A page-frame payload failed validation (magic, version, CRC,
    truncation, a hostile length prefix, or a header out of range)."""


class PageCorruptionError(PageFrameError):
    """A page frame's content does not hash to the checksum stamped at
    export, although every CRC passed."""


#: a decoded frame set may claim at most this many times the received
#: bytes, so a forged header raises PageFrameError instead of allocating
_MAX_CLAIM_RATIO = 2

#: dtype names whose pages travel as raw words of another numpy dtype
_RAW_STORAGE = {"bfloat16": np.dtype(np.uint16)}


def _storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a page of dtype ``name`` is held in on the host."""
    raw = _RAW_STORAGE.get(name)
    return raw if raw is not None else np.dtype(name)


def host_frames(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor of page frames → (host array, dtype name); bfloat16 comes
    back as its raw uint16 words."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def device_frames(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """Host page frames (raw words for bfloat16) → a tensor on ``device``
    of the named dtype."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype_name == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def _pack_buf(raw: bytes) -> bytes:
    return struct.pack("<QI", len(raw), zlib.crc32(raw)) + raw


def _unpack_buf(data: bytes, off: int) -> Tuple[bytes, int]:
    if off + 12 > len(data):
        raise PageFrameError("page frame truncated in buffer header")
    n, crc = struct.unpack_from("<QI", data, off)
    off += 12
    if off + n > len(data):
        raise PageFrameError("page frame truncated in buffer body")
    raw = data[off:off + n]
    if zlib.crc32(raw) != crc:
        raise PageFrameError("page frame CRC mismatch — corrupt buffer")
    return raw, off + n


class PageFrameSet:
    """Host snapshot of one context's KV pages.

    ``layers`` maps each attention vertex to ``{"k", "v"}`` arrays
    [n_pages, H, page_size, Dh]; page ``j`` holds the KV of tokens
    [j*page_size, (j+1)*page_size) of ``tokens``. ``dtype`` names the
    frames' dtype where the arrays hold raw words (``"bfloat16"`` over
    uint16); by default it is the arrays' own. Per-page content checksums
    are stamped at construction (``checksums=None``), taken as given, or
    left out (``checksums=False``).

    Two CRC-framed, versioned wire encodings: :meth:`to_bytes` (one bulk
    buffer) and :meth:`to_frames` (a header frame plus one frame per
    page)."""

    MAGIC = b"DKVF"
    FRAME_MAGIC = b"DKVP"
    VERSION = 1

    def __init__(self, page_size: int, tokens: Sequence,
                 layers: Dict[str, Dict[str, np.ndarray]],
                 checksums=None, dtype: Optional[str] = None):
        self.page_size = int(page_size)
        self.tokens = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1))
        self.layers = {str(n): {kk: np.ascontiguousarray(kv[kk])
                                for kk in ("k", "v")}
                       for n, kv in layers.items()}
        if not self.layers:
            raise PageFrameError("PageFrameSet needs >= 1 layer")
        first = next(iter(self.layers.values()))["k"]
        self.n_pages = int(first.shape[0])
        self.dtype = str(first.dtype) if dtype is None else str(dtype)
        if _storage_dtype(self.dtype) != first.dtype:
            raise PageFrameError(f"frames held as {first.dtype} cannot "
                                 f"carry dtype {self.dtype!r}")
        for n, kv in self.layers.items():
            for kk in ("k", "v"):
                a = kv[kk]
                if a.ndim != 4 or int(a.shape[0]) != self.n_pages or \
                        int(a.shape[2]) != self.page_size or \
                        a.dtype != first.dtype:
                    raise PageFrameError(
                        f"layer {n!r} {kk} frames have shape "
                        f"{tuple(a.shape)} {a.dtype}; expected "
                        f"[{self.n_pages}, H, {self.page_size}, Dh] "
                        f"{first.dtype}")
        if checksums is False:
            self.page_checksums: Optional[List[bytes]] = None
        elif checksums is None:
            self.page_checksums = [self._page_sum(j)
                                   for j in range(self.n_pages)]
        else:
            self.page_checksums = [bytes(c) for c in checksums]
            if len(self.page_checksums) != self.n_pages:
                raise PageFrameError(
                    f"{len(self.page_checksums)} page checksums for "
                    f"{self.n_pages} pages")

    @classmethod
    def from_tensors(cls, page_size: int, tokens: Sequence,
                     frames: Dict[str, Dict[str, torch.Tensor]],
                     checksums=None) -> "PageFrameSet":
        """Build from ``TransformerDecoder.kv_export``'s tensors."""
        layers, names = {}, set()
        for n, kv in frames.items():
            layers[n] = {}
            for kk in ("k", "v"):
                layers[n][kk], name = host_frames(kv[kk])
                names.add(name)
        if len(names) != 1:
            raise PageFrameError(f"mixed frame dtypes {sorted(names)}")
        return cls(page_size, tokens, layers, checksums=checksums,
                   dtype=names.pop())

    def tensors(self, device) -> Dict[str, Dict[str, torch.Tensor]]:
        """The frames as tensors on ``device`` (for
        ``TransformerDecoder.kv_import``)."""
        return {n: {kk: device_frames(kv[kk], self.dtype, device)
                    for kk in ("k", "v")}
                for n, kv in self.layers.items()}

    def _page_sum(self, j: int) -> bytes:
        return page_content_checksum(
            [self.layers[n][kk][j] for n in sorted(self.layers)
             for kk in ("k", "v")])

    def verify(self) -> List[int]:
        """Indices of pages whose content no longer hashes to its stamped
        checksum ([] when clean or when none was stamped)."""
        if self.page_checksums is None:
            return []
        return [j for j in range(self.n_pages)
                if self._page_sum(j) != self.page_checksums[j]]

    @property
    def nbytes(self) -> int:
        """Payload bytes a handoff moves (tokens + every page frame)."""
        return int(self.tokens.nbytes) + sum(
            int(kv[kk].nbytes) for kv in self.layers.values()
            for kk in ("k", "v"))

    def _header(self) -> Dict:
        head = {"v": self.VERSION, "page_size": self.page_size,
                "n_ctx": len(self.tokens), "n_pages": self.n_pages,
                "dtype": self.dtype,
                "layers": {n: list(map(int, kv["k"].shape[1:]))
                           for n, kv in self.layers.items()}}
        if self.page_checksums is not None:
            head["sums"] = [c.hex() for c in self.page_checksums]
        return head

    @classmethod
    def _validate_header(cls, head: Dict, budget: int):
        """Every dimension a sane positive int, and the bytes the header
        claims within :data:`_MAX_CLAIM_RATIO` of those received. Returns
        (dtype name, storage dtype, n_pages, n_ctx, shape map)."""
        try:
            n_pages = int(head["n_pages"])
            n_ctx = int(head["n_ctx"])
            page_size = int(head["page_size"])
            layer_shapes = {str(n): tuple(int(x) for x in sh)
                            for n, sh in dict(head["layers"]).items()}
            name = str(head["dtype"])
            dt = _storage_dtype(name)
        except (KeyError, TypeError, ValueError, AttributeError,
                OverflowError) as e:
            raise PageFrameError(f"malformed page-frame header: {e}")
        if n_pages < 0 or n_ctx < 0 or page_size < 1 or not layer_shapes:
            raise PageFrameError(
                f"page-frame header out of range: n_pages={n_pages} "
                f"n_ctx={n_ctx} page_size={page_size} "
                f"layers={len(layer_shapes)}")
        claimed = n_ctx * 4
        for n, sh in layer_shapes.items():
            if len(sh) != 3 or any(x < 1 for x in sh) or \
                    sh[1] != page_size:
                raise PageFrameError(
                    f"layer {n!r} header shape {sh} invalid for "
                    f"page_size {page_size}")
            per_page = 1                 # Python ints: no int64 wrap
            for x in sh:
                per_page *= int(x)
            claimed += 2 * n_pages * per_page * int(dt.itemsize)
        if claimed > max(1024, int(budget)) * _MAX_CLAIM_RATIO:
            raise PageFrameError(
                f"page-frame header claims {claimed} bytes against a "
                f"{budget}-byte payload — hostile length prefix")
        return name, dt, n_pages, n_ctx, layer_shapes

    def _checked(self) -> "PageFrameSet":
        """Content verification after a decode: raises
        :class:`PageCorruptionError` naming the corrupt pages; a clean set
        is marked ``_verified``, so an engine's adopt intake does not
        sweep the same frames again."""
        bad = self.verify()
        if bad:
            raise PageCorruptionError(
                f"page content checksum mismatch on page(s) {bad} — "
                "silent corruption between export and intake (every CRC "
                "passed)")
        self._verified = True
        return self

    # ------------------------------------------------------ bulk encoding
    def to_bytes(self) -> bytes:
        head = json.dumps(self._header(), sort_keys=True).encode()
        parts = [self.MAGIC, struct.pack("<II", self.VERSION, len(head)),
                 head, _pack_buf(self.tokens.tobytes())]
        for n in sorted(self.layers):
            for kk in ("k", "v"):
                parts.append(_pack_buf(self.layers[n][kk].tobytes()))
        return b"".join(parts)

    @classmethod
    def _parse_header(cls, data: bytes, magic: bytes) -> Tuple[Dict, int]:
        if len(data) < 12:
            raise PageFrameError("page frame truncated in magic/version")
        if data[:4] != magic:
            raise PageFrameError(f"bad page-frame magic {data[:4]!r}")
        ver, hlen = struct.unpack_from("<II", data, 4)
        if ver != cls.VERSION:
            raise PageFrameError(f"page-frame version {ver} unsupported "
                                 f"(this build speaks {cls.VERSION})")
        if 12 + hlen > len(data):
            raise PageFrameError("page frame truncated in header "
                                 "(hostile header length)")
        try:
            head = json.loads(data[12:12 + hlen])
        except ValueError as e:
            raise PageFrameError(f"unparseable page-frame header: {e}")
        if not isinstance(head, dict):
            raise PageFrameError("page-frame header is not an object")
        return head, 12 + hlen

    @staticmethod
    def _header_sums(head: Dict, n_pages: int) -> Optional[List[bytes]]:
        sums = head.get("sums")
        if sums is None:                 # a sender that stamped none
            return None
        try:
            out = [bytes.fromhex(str(s)) for s in sums]
        except (TypeError, ValueError) as e:
            raise PageFrameError(f"malformed page checksums: {e}")
        if len(out) != n_pages:
            raise PageFrameError(f"{len(out)} page checksums for "
                                 f"{n_pages} pages")
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> "PageFrameSet":
        head, off = cls._parse_header(data, cls.MAGIC)
        name, dt, n_pages, n_ctx, layer_shapes = cls._validate_header(
            head, len(data))
        raw, off = _unpack_buf(data, off)
        tokens = np.frombuffer(raw, np.int32)
        if len(tokens) != n_ctx:
            raise PageFrameError("token buffer does not match header")
        layers = {}
        for n in sorted(layer_shapes):
            shape = (n_pages,) + layer_shapes[n]
            kv = {}
            for kk in ("k", "v"):
                raw, off = _unpack_buf(data, off)
                if len(raw) % dt.itemsize:
                    raise PageFrameError(f"layer {n!r} {kk} buffer is not "
                                         f"whole {name} words")
                arr = np.frombuffer(raw, dt)
                if arr.size != int(np.prod(shape)):
                    raise PageFrameError(
                        f"layer {n!r} {kk} buffer does not match header "
                        f"shape {shape}")
                kv[kk] = arr.reshape(shape)
            layers[n] = kv
        sums = cls._header_sums(head, n_pages)
        out = cls(int(head["page_size"]), tokens, layers,
                  checksums=sums if sums is not None else False, dtype=name)
        return out._checked()

    # ------------------------------------------------- per-page streaming
    def to_frames(self) -> List[bytes]:
        """Header frame + one frame per page, in fill order."""
        head = json.dumps(self._header(), sort_keys=True).encode()
        out = [self.MAGIC + struct.pack("<II", self.VERSION, len(head)) +
               head + _pack_buf(self.tokens.tobytes())]
        for j in range(self.n_pages):
            parts = [self.FRAME_MAGIC, struct.pack("<I", j)]
            for n in sorted(self.layers):
                for kk in ("k", "v"):
                    parts.append(_pack_buf(self.layers[n][kk][j].tobytes()))
            out.append(b"".join(parts))
        return out

    @classmethod
    def from_frames(cls, frames: Sequence[bytes]) -> "PageFrameSet":
        if not frames:
            raise PageFrameError("empty page-frame stream")
        head, off = cls._parse_header(frames[0], cls.MAGIC)
        name, dt, n_pages, n_ctx, layer_shapes = cls._validate_header(
            head, sum(len(f) for f in frames))
        raw, _ = _unpack_buf(frames[0], off)
        tokens = np.frombuffer(raw, np.int32)
        if len(tokens) != n_ctx:
            raise PageFrameError("token buffer does not match header")
        if len(frames) != n_pages + 1:
            raise PageFrameError(f"page-frame stream carries "
                                 f"{len(frames) - 1} pages; header "
                                 f"promises {n_pages}")
        layers = {n: {kk: np.zeros((n_pages,) + sh, dt)
                      for kk in ("k", "v")}
                  for n, sh in layer_shapes.items()}
        seen = set()
        for fr in frames[1:]:
            if len(fr) < 8 or fr[:4] != cls.FRAME_MAGIC:
                raise PageFrameError(f"bad page frame magic {fr[:4]!r}")
            (j,) = struct.unpack_from("<I", fr, 4)
            if j >= n_pages or j in seen:
                raise PageFrameError(f"page frame index {j} out of range "
                                     "or duplicated")
            seen.add(j)
            off = 8
            for n in sorted(layer_shapes):
                for kk in ("k", "v"):
                    raw, off = _unpack_buf(fr, off)
                    page = layers[n][kk][j]
                    if len(raw) != page.nbytes:
                        raise PageFrameError(
                            f"page {j} layer {n!r} {kk} buffer size "
                            "mismatch")
                    layers[n][kk][j] = np.frombuffer(raw, dt).reshape(
                        page.shape)
        sums = cls._header_sums(head, n_pages)
        out = cls(int(head["page_size"]), tokens, layers,
                  checksums=sums if sums is not None else False, dtype=name)
        return out._checked()
