"""Silent-data-corruption defence of the serving engine (the JAX package's
``observability/integrity.py``).

- The numerics sentinel: :func:`logits_fault` reduces each row of logits
  to a verdict (any non-finite value, or an absolute value past the
  bound). The decoder folds it into the carries its programs already
  return, so the verdict crosses to the host as one more column of a
  readback the engine makes anyway. A tripped request fails with
  :class:`NumericalFault`, and the tokens of the poisoned block are
  dropped.
- KV-page content verification: :class:`PageVerifier` keeps a blake2b
  checksum (:func:`page_content_checksum`) per prefix-cache chain digest,
  recorded when a page is registered and compared when a later request
  maps it; a mismatch evicts the chain.
- :func:`corrupt_host_frames` is the chaos payload for host page frames.

The fleet's golden canary and corrupt-replica quarantine belong to the
serving host tier and are not ported."""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class NumericalFault(RuntimeError):
    """The numerics sentinel tripped: a request's logits went non-finite
    or past the configured bound. The engine dropped the poisoned block's
    tokens and failed the request with this error."""


@dataclass(frozen=True)
class IntegrityConfig:
    """The defence's knobs (``integrity=True`` means these defaults).

    - ``sentinel`` / ``logit_bound``: the per-row finite check over the
      serving logits, plus ``|logit| <= logit_bound`` when the bound is
      set (None: finite only).
    - ``kv_verify`` / ``kv_verify_rate``: checksum prefix-cache pages at
      registration, and verify every ``1 / kv_verify_rate``-th hit.

    The JAX config's fleet fields (the golden canary, the corrupt-replica
    threshold) come with the fleet tier."""

    sentinel: bool = True
    logit_bound: Optional[float] = 1e4
    kv_verify: bool = True
    kv_verify_rate: float = 0.25

    @property
    def verify_every(self) -> int:
        """Sampling stride of hit verification: every Nth hit is verified
        (a counter, so a schedule reproduces exactly); 0 = never."""
        rate = max(0.0, min(1.0, float(self.kv_verify_rate)))
        if rate <= 0.0:
            return 0
        return max(1, int(round(1.0 / rate)))


def as_integrity(cfg) -> Optional[IntegrityConfig]:
    """Normalize an ``integrity=`` argument: None stays None (defence
    off), True means the defaults, a config passes through."""
    if cfg is None or isinstance(cfg, IntegrityConfig):
        return cfg
    if cfg is True:
        return IntegrityConfig()
    raise TypeError(f"integrity= wants IntegrityConfig, True or None; "
                    f"got {type(cfg).__name__}")


def logits_fault(logits: torch.Tensor,
                 bound: Optional[float]) -> torch.Tensor:
    """Per-row verdict over ``logits`` [B, V] → bool [B] on their device:
    True where any logit is non-finite or, with a bound, where the largest
    absolute logit exceeds it. Two reductions; nothing is read back."""
    bad = ~torch.isfinite(logits).all(dim=-1)
    if bound is not None:
        bad = bad | (logits.abs().amax(dim=-1) > bound)
    return bad


# ------------------------------------------------------------ checksums
def page_content_checksum(arrays: Sequence) -> bytes:
    """16-byte blake2b over a page's KV content: every layer's k then v
    bytes, in the caller's (sorted-layer) order."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.digest()


class PageVerifier:
    """Content checksums keyed by prefix-cache chain digest, each pinned
    to the physical page it was recorded from: a chain re-registered on
    another page (whose bytes may differ in the last bits) refreshes its
    reference instead of reading as corrupt. Past ``capacity`` the oldest
    reference is forgotten, which costs a re-record, never a false
    verdict. Thread-safe."""

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._sums: Dict[bytes, Tuple[int, bytes]] = {}
        self.capacity = int(capacity)
        self.recorded = 0
        self.mismatches = 0

    def expected(self, digest: bytes, pid: int) -> Optional[bytes]:
        """The reference for ``digest`` held on page ``pid``; None when
        unrecorded or recorded from another page."""
        with self._lock:
            ref = self._sums.get(digest)
            if ref is None or ref[0] != int(pid):
                return None
            return ref[1]

    def record(self, digest: bytes, pid: int, checksum: bytes) -> None:
        with self._lock:
            if digest not in self._sums:
                self.recorded += 1
            self._sums[digest] = (int(pid), checksum)
            while len(self._sums) > self.capacity:
                self._sums.pop(next(iter(self._sums)))

    def check(self, digest: bytes, pid: int,
              checksum: bytes) -> Optional[bool]:
        """True = match, False = corrupt, None = no valid reference (the
        checksum is recorded as the new one)."""
        with self._lock:
            ref = self._sums.get(digest)
            if ref is not None and ref[0] == int(pid):
                if ref[1] == checksum:
                    return True
                self.mismatches += 1
                return False
        self.record(digest, pid, checksum)
        return None

    def forget(self, digests: Sequence[bytes]) -> None:
        """Drop references (a chain evicted as corrupt records afresh the
        next time it is registered)."""
        with self._lock:
            for dg in digests:
                self._sums.pop(dg, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._sums)


#: raw-word payloads for frames held as uint16 bfloat16 words
_BF16_NAN, _BF16_SIGN = np.uint16(0x7FC0), np.uint16(0x8000)


def corrupt_host_frames(state, mode: str = "nan", page: int = 0) -> None:
    """Chaos only: corrupt page ``page`` of a host frame set
    (:class:`~..models.paging.PageFrameSet`) in place, after its content
    checksums were stamped: NaN fill (``"nan"``) or sign flip
    (``"flip"``). bfloat16 frames are raw uint16 words, so their payloads
    are written as words."""
    j = int(page) % max(1, int(state.n_pages))
    words = getattr(state, "dtype", None) == "bfloat16"
    for n in sorted(state.layers):
        for kk in ("k", "v"):
            arr = state.layers[n][kk]
            if not arr.flags.writeable:
                arr = arr.copy()
                state.layers[n][kk] = arr
            if words:
                arr[j] = _BF16_NAN if mode == "nan" else arr[j] ^ _BF16_SIGN
            elif mode == "nan":
                arr[j] = np.asarray(float("nan"), arr.dtype)
            else:
                arr[j] = -arr[j]
