"""Prompt-lookup speculative drafter (the JAX package's
``models/speculative.py``).

No parameters: a host-side per-slot suffix index over each stream's own
context (prompt + generated so far). At each speculative block the engine
asks for K candidate continuations of the lane's current suffix; one
verify forward (``TransformerDecoder.verify_block``) scores all K + 1
positions and accepts the longest prefix the model itself would have
emitted.

The index maps every n-gram (n = 1..max_n) of the stream to its two most
recent END positions. Drafting looks the current suffix up from the
longest gram down; the most recent occurrence that is not the suffix
itself supplies the continuation. ``sync`` extends the index
incrementally, and rebuilds it when the slot's occupant or its history
changed (a refill, a requeue after preemption)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["NGramDrafter"]


class NGramDrafter:
    """Per-slot prompt-lookup drafter over one stream's context."""

    __slots__ = ("max_n", "_owner", "_tokens", "_index")

    def __init__(self, max_n: int = 3):
        self.max_n = max(1, int(max_n))
        self._owner: Optional[object] = None
        self._tokens: List[int] = []
        #: gram -> (most recent end position, previous end position);
        #: "end" points one past the gram, at its continuation
        self._index: Dict[Tuple[int, ...], Tuple[int, int]] = {}

    def __len__(self) -> int:
        return len(self._tokens)

    @staticmethod
    def _tok(prompt, generated, i: int) -> int:
        return int(prompt[i]) if i < len(prompt) \
            else int(generated[i - len(prompt)])

    def sync(self, owner: object, prompt, generated) -> None:
        """Bring the index up to date with ``owner``'s context (``prompt``
        + ``generated``). Same owner (by identity) and append-only growth
        extends it; anything else rebuilds it from scratch."""
        total = len(prompt) + len(generated)
        n = len(self._tokens)
        if owner is not self._owner or total < n or \
                (n > 0 and
                 self._tok(prompt, generated, n - 1) != self._tokens[n - 1]):
            self._owner = owner
            self._tokens = []
            self._index = {}
            n = 0
        for i in range(n, total):
            self._extend(self._tok(prompt, generated, i))

    def _extend(self, tok: int) -> None:
        toks = self._tokens
        toks.append(tok)
        e = len(toks)
        for n in range(1, self.max_n + 1):
            if e < n:
                break
            gram = tuple(toks[e - n:e])
            cur = self._index.get(gram)
            self._index[gram] = (e, cur[0] if cur is not None else -1)

    def draft(self, k: int) -> np.ndarray:
        """``k`` candidate continuation tokens ([k] int32). The longest
        suffix with a prior occurrence (lag ``d``) predicts token ``i`` as
        token ``i - d``, wrapping by the lag past the end of history, so
        periodic text keeps being drafted for any ``k``. With no prior
        occurrence the draft repeats the last token."""
        out = np.zeros(k, np.int32)
        toks = self._tokens
        ln = len(toks)
        if ln == 0:
            return out
        src = -1
        for n in range(min(self.max_n, ln), 0, -1):
            ent = self._index.get(tuple(toks[ln - n:ln]))
            if ent is None:
                continue
            # the suffix gram itself ends at ln: take the previous
            # occurrence when the most recent one is the suffix
            e = ent[0] if ent[0] < ln else ent[1]
            if 0 <= e < ln:
                src = e
                break
        if src < 0:
            out[:] = toks[-1]
            return out
        d = ln - src
        for j in range(k):
            i = src + j
            while i >= ln:
                i -= d
            out[j] = toks[i]
        return out
