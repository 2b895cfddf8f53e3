"""Content checksums of KV pages (the JAX package's
``observability/integrity.py``). The page frames of a handoff are stamped
with :func:`page_content_checksum` at export and verified at intake; the
numerics sentinel and the page verifier of that module are not ported."""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np


def page_content_checksum(arrays: Sequence) -> bytes:
    """16-byte blake2b over a page's KV content: every layer's k then v
    bytes, in the caller's (sorted-layer) order."""
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.digest()
