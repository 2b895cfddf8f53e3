"""Batched skip-gram / CBOW training steps: the counterpart of the JAX
package's ``nlp/skipgram.py`` (reference
models/embeddings/learning/impl/elements/{SkipGram,CBOW}.java; the
reference batches pairs into a native ``AggregateSkipGram`` op, SURVEY.md
§3.5). Here a batch is a fixed-shape tensor on the tables' device and one
step does the whole aggregate: gather → dot → sigmoid loss → segment-sum
update of the tables, in place.

Every step function keeps the JAX function's name and arguments and
returns the updated tables with the loss, as the JAX functions do; the
tables are updated in place (JAX donates their buffers). Randomness comes
from an explicit ``torch.Generator`` (the per-batch ``*_rng`` steps) or
from an integer seed folded with the absolute step (the corpus scans), so
a scan's segmentation changes nothing. The bits differ from JAX's
threefry by design.

**The segment update** (:func:`_segment_update`) keeps JAX's two numerics.
While the table has at most :data:`ONEHOT_SEGMENT_MAX_V` rows and the
one-hot would have at most :data:`ONEHOT_SEGMENT_MAX_ELEMS` elements, JAX
sums through a bf16 one-hot matmul accumulating in f32: the updates and the
occurrence weights are rounded to bf16 and summed in f32. Otherwise it
scatter-adds in f32. The port keeps the switch (:func:`segment_route`)
and runs both routes through ``kernels/segment_update.py`` (on the card
its deterministic kernel, on the CPU ``index_add_`` into a dense
``[V, D + 1]`` buffer), rounding the values to bf16 first on the one-hot
route; the other table writes go through :func:`_index_sum`. Every sum
has a fixed order, so a seeded fit gives the same tables on every run
(float atomics would sum hot Zipf rows in a different order each
time)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..kernels.segment_update import segment_update
from ..ops.rng import fold_in

# bounds for the one-hot segment-sum route (the JAX package's MXU
# contraction): beyond either one it scatter-adds in f32
ONEHOT_SEGMENT_MAX_V = 32768
ONEHOT_SEGMENT_MAX_ELEMS = 1 << 28


def _index_sum(out, idx, values):
    """out[idx_i] += values_i, in place, summing in a fixed order: on a
    CUDA tensor ``index_put_(accumulate=True)``, which sorts the indices
    and adds each row's values in order (``index_add_`` there adds with
    float atomics); elsewhere ``index_add_``, which sums serially. For the
    in-place writes whose rows repeat a few times a batch (GloVe's
    AdaGrad rows, the k shared negatives); the segment update's hot rows
    go through the segment-update kernel."""
    if out.device.type == "cuda":
        return out.index_put_((idx,), values, accumulate=True)
    return out.index_add_(0, idx, values)


def segment_route(n_rows: int, n_updates: int) -> str:
    """Which numerics :func:`_segment_update` uses for a table of
    ``n_rows`` rows and ``n_updates`` updates: ``"onehot"`` (values
    rounded to bf16, summed in f32) or ``"scatter"`` (f32)."""
    if n_rows <= ONEHOT_SEGMENT_MAX_V and \
            n_updates * n_rows <= ONEHOT_SEGMENT_MAX_ELEMS:
        return "onehot"
    return "scatter"


def _segment_update(table, idx, updates, weights, lr):
    """table[v] += lr * Σ_{i: idx_i=v} updates_i / sqrt(Σ weights_i), in
    place — the sqrt-count-normalized segment update behind every embedding
    table write. Returns ``table``."""
    onehot = segment_route(table.shape[0], int(idx.shape[0])) == "onehot"
    return segment_update(table, idx, updates, weights.to(updates.dtype),
                          lr, onehot)


def _scatter_mean_add(table, idx, updates, lr):
    """Add lr * (per-row summed updates / sqrt(occurrence count)) — the
    stable batched analog of word2vec's sequential per-pair updates. Plain
    scatter-add amplifies hot rows (the Huffman root appears in every
    pair's path) linearly in batch size; full mean-normalization
    under-trains; sqrt scaling keeps word2vec's convergence at standard
    learning rates across batch sizes."""
    return _segment_update(table, idx, updates,
                           torch.ones(idx.shape, dtype=table.dtype,
                                      device=table.device), lr)


def _log_likelihood(label, sig, mask):
    """Σ mask · log(clip(σ or 1 − σ by label)) — the summed binary
    log-likelihood the steps report (negated) as their loss."""
    p = torch.where(label > 0.5, sig, 1.0 - sig)
    return torch.sum(mask * torch.log(torch.clamp(p, 1e-10, 1.0)))


def _hs_grads(h, codes, points, lmask, syn1):
    """The hierarchical-softmax head: (g [B, L], v [B, L, D], loss sum)."""
    v = syn1[points]                               # [B, L, D]
    dots = torch.einsum("bd,bld->bl", h, v)
    label = 1.0 - codes
    sig = torch.sigmoid(dots)
    g = (label - sig) * lmask
    return g, v, -_log_likelihood(label, sig, lmask)


def _code_mask(codes, lengths, dtype):
    return (torch.arange(codes.shape[1], device=codes.device)[None, :] <
            lengths[:, None]).to(dtype)


def skipgram_hs_step(syn0, syn1, centers, targets, codes, points, lengths,
                     lr, hs: bool = True):
    """Hierarchical-softmax skip-gram batch.

    syn0 [V, D] input vectors; syn1 [V-1, D] inner-node vectors;
    centers [B] int; targets [B] int (the word whose code we predict);
    codes [B, L] float 0/1; points [B, L] int; lengths [B] int.
    Returns (syn0, syn1, mean_loss)."""
    h = syn0[centers]                              # [B, D]
    mask = _code_mask(codes, lengths, syn0.dtype)  # [B, L]
    g, v, loss_sum = _hs_grads(h, codes, points, mask, syn1)
    loss = loss_sum / torch.clamp(torch.sum(mask), min=1.0)
    dh = torch.einsum("bl,bld->bd", g, v)          # neu1e
    dv = torch.einsum("bl,bd->bld", g, h)
    _scatter_mean_add(syn0, centers, dh, lr)
    _scatter_mean_add(syn1, points.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                      lr)
    return syn0, syn1, loss


def _ns_head(h, syn1neg, pos, negs):
    """(tgt [B, 1+K], label, v [B, 1+K, D], sig) of the NS head."""
    tgt = torch.cat([pos[:, None], negs], dim=1)   # [B, 1+K]
    label = torch.cat([torch.ones((pos.shape[0], 1), dtype=h.dtype,
                                  device=h.device),
                       torch.zeros(negs.shape, dtype=h.dtype,
                                   device=h.device)], dim=1)
    v = syn1neg[tgt]                               # [B, 1+K, D]
    sig = torch.sigmoid(torch.einsum("bd,bkd->bk", h, v))
    return tgt, label, v, sig


def _skipgram_ns_core(syn0, syn1neg, centers, pos, negs, lr):
    h = syn0[centers]                              # [B, D]
    tgt, label, v, sig = _ns_head(h, syn1neg, pos, negs)
    g = label - sig
    loss = -_log_likelihood(label, sig, 1.0) / label.numel()
    dh = torch.einsum("bk,bkd->bd", g, v)
    dv = torch.einsum("bk,bd->bkd", g, h)
    _scatter_mean_add(syn0, centers, dh, lr)
    _scatter_mean_add(syn1neg, tgt.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                      lr)
    return syn0, syn1neg, loss


def skipgram_ns_step(syn0, syn1neg, centers, pos, negs, lr):
    """Negative-sampling skip-gram batch.

    centers [B], pos [B], negs [B, K] sampled negatives.
    syn1neg [V, D] output vectors. Returns (syn0, syn1neg, mean_loss)."""
    return _skipgram_ns_core(syn0, syn1neg, centers, pos, negs, lr)


def _context_mean(syn0, context, context_mask):
    cm = context_mask.to(syn0.dtype)
    vecs = syn0[context] * cm[..., None]           # [B, C, D]
    denom = torch.clamp(torch.sum(cm, dim=1, keepdim=True), min=1.0)
    return cm, denom, torch.sum(vecs, dim=1) / denom


def _spread_to_context(syn0, context, cm, denom, dh, lr):
    dctx = (dh / denom)[:, None, :] * cm[..., None]    # distribute to context
    _scatter_mean_add(syn0, context.reshape(-1),
                      dctx.reshape(-1, dctx.shape[-1]), lr)


def cbow_hs_step(syn0, syn1, context, context_mask, target, codes, points,
                 lengths, lr):
    """CBOW with hierarchical softmax: context [B, C] int (padded),
    context_mask [B, C], target [B]."""
    cm, denom, h = _context_mean(syn0, context, context_mask)
    lmask = _code_mask(codes, lengths, syn0.dtype)
    g, v, loss_sum = _hs_grads(h, codes, points, lmask, syn1)
    loss = loss_sum / torch.clamp(torch.sum(lmask), min=1.0)
    dh = torch.einsum("bl,bld->bd", g, v)          # [B, D]
    dv = torch.einsum("bl,bd->bld", g, h)
    _scatter_mean_add(syn1, points.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                      lr)
    _spread_to_context(syn0, context, cm, denom, dh, lr)
    return syn0, syn1, loss


def _draw_negatives(neg_table, shape, generator):
    return neg_table[torch.randint(0, neg_table.shape[0], shape,
                                   generator=generator,
                                   device=neg_table.device)]


def skipgram_ns_step_rng(syn0, syn1neg, centers, pos, neg_table, key, lr,
                         k: int):
    """Negative-sampling step with negatives drawn on the tables' device
    from the unigram table by ``key`` (a ``torch.Generator`` there)."""
    negs = _draw_negatives(neg_table, (centers.shape[0], k), key)
    return _skipgram_ns_core(syn0, syn1neg, centers, pos, negs, lr)


def _masked_ns_update(syn0, syn1neg, centers, ctx, valid, negs, lr, dtype):
    """Negative-sampling update over a FIXED-SHAPE masked pair block
    [B] centers, [B] contexts, [B] validity. Invalid pairs contribute zero
    gradient and zero occurrence count, so padding/out-of-window/cross-
    sentence slots are exactly neutral. Returns (syn0, syn1neg, loss_sum,
    pair_count)."""
    vm = valid.to(dtype)
    c_safe = torch.where(valid, centers, 0)
    t_safe = torch.where(valid, ctx, 0)
    h = syn0[c_safe]                                    # [B, D]
    tgt, label, v, sig = _ns_head(h, syn1neg, t_safe, negs)
    g = (label - sig) * vm[:, None]
    loss_sum = -_log_likelihood(label, sig, vm[:, None])
    dh = torch.einsum("bk,bkd->bd", g, v)
    dv = torch.einsum("bk,bd->bkd", g, h)
    # sqrt-count normalization counting only VALID occurrences
    _segment_update(syn0, c_safe, dh, vm, lr)
    _segment_update(syn1neg, tgt.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                    torch.repeat_interleave(vm, tgt.shape[1]), lr)
    return syn0, syn1neg, loss_sum, torch.sum(vm)


def _masked_ns_update_shared(syn0, syn1neg, centers, ctx, valid, negs, lr,
                             dtype):
    """Shared-negative variant: the SAME ``k`` negative rows serve every
    pair in the block (the BlazingText / GPU-word2vec batching of
    word2vec.c's per-pair draws). Per-pair expectation of the gradient is
    unchanged; what changes is covariance within one step, and the
    [B, K, D] gather of per-pair negatives becomes a [B, D] x [D, K]
    matmul against a K-row slice of the table.

    negs: [K] shared negative indices."""
    vm = valid.to(dtype)
    c_safe = torch.where(valid, centers, 0)
    t_safe = torch.where(valid, ctx, 0)
    h = syn0[c_safe]                                    # [B, D]
    vpos = syn1neg[t_safe]                              # [B, D]
    vneg = syn1neg[negs]                                # [K, D]
    sig_pos = torch.sigmoid(torch.sum(h * vpos, dim=1))     # [B]
    sig_neg = torch.sigmoid(h @ vneg.T)                 # [B, K]
    g_pos = (1.0 - sig_pos) * vm                        # [B]
    g_neg = -sig_neg * vm[:, None]                      # [B, K]
    loss_sum = -(torch.sum(vm * torch.log(torch.clamp(sig_pos, 1e-10, 1.0)))
                 + torch.sum(vm[:, None] * torch.log(
                     torch.clamp(1.0 - sig_neg, 1e-10, 1.0))))
    dh = g_pos[:, None] * vpos + g_neg @ vneg           # [B, D]
    n_valid = torch.sum(vm)
    dv_neg = g_neg.T @ h                                # [K, D]
    _segment_update(syn0, c_safe, dh, vm, lr)
    # positive rows: per-pair segment update; negative rows: dense [K, D]
    _segment_update(syn1neg, t_safe, g_pos[:, None] * h, vm, lr)
    _index_sum(syn1neg, negs, lr * dv_neg / torch.sqrt(
        torch.clamp(n_valid, min=1.0)))
    return syn0, syn1neg, loss_sum, n_valid


# ----------------------------------------------------------- corpus scans
def scan_geometry(p: int, window: int, device):
    """(idx [p, 2W], dmag [2W]) of a scan step's window reads: the context
    positions of its ``p`` centers within the step's slice of the corpus
    (offsets -1, +1, -2, +2, ..., the JAX scan's order) and their
    distances. The same for every step, so a scan builds it once."""
    offs = [d * sgn for d in range(1, window + 1) for sgn in (-1, 1)]
    dmag = [d for d in range(1, window + 1) for _ in (0, 1)]
    local = window + torch.arange(p, device=device)
    idx = local[:, None] + torch.tensor(offs, dtype=torch.int64,
                                        device=device)[None, :]
    return idx, torch.tensor(dmag, dtype=torch.int64, device=device)


def scan_step_seed(key: int, step: int) -> int:
    """The seed of absolute scan step ``step`` of a chunk whose seed is
    ``key``: every draw of that step comes from one generator seeded with
    it (the window shrinks ``b`` first, then the negatives)."""
    return fold_in(key, step)


def scan_lr(lr0, lr_min, frac0, frac_per_step, step: int) -> float:
    """word2vec's linear decay at absolute scan step ``step``, in f32 as
    the JAX scan computes it: max(lr0·(1 − min(frac, 1)), lr_min)."""
    f32 = np.float32
    frac = f32(frac0) + f32(step) * f32(frac_per_step)
    lr = f32(lr0) * (f32(1.0) - min(frac, f32(1.0)))
    return float(max(lr, f32(lr_min)))


def scan_step_pairs(corpus, sep_cum, step: int, p: int, window: int,
                    geometry, b):
    """The masked pair block of scan step ``step``: (cflat [p·2W], ctx
    [p·2W], valid [p·2W]) for the ``p`` centers at corpus positions
    step·p + window + j, given :func:`scan_geometry` and the window
    shrink draws ``b`` [p]. Windows never cross a separator (the
    ``sep_cum`` prefix-sum guard)."""
    idx, dmag = geometry
    s0 = step * p
    win = corpus[s0:s0 + p + 2 * window]
    cum = sep_cum[s0:s0 + p + 2 * window]
    centers = win[window:window + p]
    ctx = win[idx]
    valid = ((centers >= 0)[:, None] & (ctx >= 0) &
             (cum[idx] == cum[window:window + p][:, None]) &
             (b[:, None] >= dmag[None, :]))
    cflat = centers[:, None].expand(p, 2 * window).reshape(-1)
    return cflat, ctx.reshape(-1), valid.reshape(-1)


def skipgram_ns_corpus_scan(syn0, syn1neg, corpus, sep_cum, neg_table, key,
                            start_step, lr0, lr_min, frac0, frac_per_step,
                            k: int, window: int, n_steps: int, p: int,
                            shared_negatives: bool = True):
    """Whole-chunk skip-gram NS training (the AggregateSkipGram role,
    SkipGram.java:271-279) as a loop of ``n_steps`` steps over the corpus
    already on the device.

    ``corpus`` is the indexed corpus (−1 sentence separators, padded with
    −1 so that every step's window read stays in range), ``sep_cum`` its
    separator prefix sum. Step ``i`` takes the ``p`` center positions
    starting at (start_step + i)·p + window, draws the dynamic window and
    the negatives from a generator seeded with
    :func:`scan_step_seed` (key, start_step + i), masks the 2·window
    contexts by window draw / separator crossing / validity and applies
    the masked segment-sum update in place. Nothing inside the loop reads
    back to the host: the loss and the pair count stay device tensors.

    lr decays linearly in scan progress (:func:`scan_lr`).
    Returns (syn0, syn1neg, loss_sum, pair_count)."""
    dev, dtype = syn0.device, syn0.dtype
    geometry = scan_geometry(p, window, dev)
    gen = torch.Generator(device=dev)
    loss_sum = torch.zeros((), dtype=dtype, device=dev)
    cnt = torch.zeros((), dtype=dtype, device=dev)
    for i in range(n_steps):
        step = int(start_step) + i
        gen.manual_seed(scan_step_seed(key, step))
        b = torch.randint(1, window + 1, (p,), generator=gen, device=dev)
        cflat, ctx, valid = scan_step_pairs(corpus, sep_cum, step, p, window,
                                            geometry, b)
        lr = scan_lr(lr0, lr_min, frac0, frac_per_step, step)
        if shared_negatives:
            negs = _draw_negatives(neg_table, (k,), gen)
            _, _, ls, n = _masked_ns_update_shared(
                syn0, syn1neg, cflat, ctx, valid, negs, lr, dtype)
        else:
            negs = _draw_negatives(neg_table, (cflat.shape[0], k), gen)
            _, _, ls, n = _masked_ns_update(
                syn0, syn1neg, cflat, ctx, valid, negs, lr, dtype)
        loss_sum += ls
        cnt += n
    return syn0, syn1neg, loss_sum, cnt


def _masked_hs_update(syn0, syn1, cflat, ctx, valid, codes_tab, points_tab,
                      lengths_tab, lr, dtype):
    """Hierarchical-softmax update over a masked pair block (the body of
    :func:`skipgram_hs_corpus_scan`). Returns (loss_sum, pair_count)."""
    vm = valid.to(dtype)
    c_safe = torch.where(valid, cflat, 0)
    t_safe = torch.where(valid, ctx, 0)
    h = syn0[c_safe]                               # [B, D]
    codes = codes_tab[t_safe]                      # [B, L]
    pts = points_tab[t_safe]                       # [B, L]
    lmask = _code_mask(codes, lengths_tab[t_safe], dtype) * vm[:, None]
    g, v, loss_sum = _hs_grads(h, codes, pts, lmask, syn1)
    dh = torch.einsum("bl,bld->bd", g, v)
    dv = torch.einsum("bl,bd->bld", g, h)
    _segment_update(syn0, c_safe, dh, vm, lr)
    _segment_update(syn1, pts.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                    lmask.reshape(-1), lr)
    return loss_sum, torch.sum(vm)


def skipgram_hs_corpus_scan(syn0, syn1, corpus, sep_cum, codes_tab,
                            points_tab, lengths_tab, key, start_step,
                            lr0, lr_min, frac0, frac_per_step,
                            window: int, n_steps: int, p: int):
    """Hierarchical-softmax sibling of :func:`skipgram_ns_corpus_scan`:
    the Huffman code / point tables stay on the device ([V, L]) and are
    gathered per target inside each step; the window draws come from the
    same per-step generator."""
    dev, dtype = syn0.device, syn0.dtype
    geometry = scan_geometry(p, window, dev)
    gen = torch.Generator(device=dev)
    loss_sum = torch.zeros((), dtype=dtype, device=dev)
    cnt = torch.zeros((), dtype=dtype, device=dev)
    for i in range(n_steps):
        step = int(start_step) + i
        gen.manual_seed(scan_step_seed(key, step))
        b = torch.randint(1, window + 1, (p,), generator=gen, device=dev)
        cflat, ctx, valid = scan_step_pairs(corpus, sep_cum, step, p, window,
                                            geometry, b)
        lr = scan_lr(lr0, lr_min, frac0, frac_per_step, step)
        ls, n = _masked_hs_update(syn0, syn1, cflat, ctx, valid, codes_tab,
                                  points_tab, lengths_tab, lr, dtype)
        loss_sum += ls
        cnt += n
    return syn0, syn1, loss_sum, cnt


# --------------------------------------------------- host pair builders
def generate_skipgram_pairs(indexed_seq: np.ndarray, window: int,
                            rng: np.random.Generator,
                            dynamic_window: bool = True
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side pair generation: (center, context) with word2vec's random
    window shrink (reference SkipGram.learnSequence iteration order)."""
    centers, contexts = [], []
    n = len(indexed_seq)
    for i in range(n):
        b = rng.integers(1, window + 1) if dynamic_window else window
        lo, hi = max(0, i - b), min(n, i + b + 1)
        for j in range(lo, hi):
            if j != i:
                centers.append(indexed_seq[i])
                contexts.append(indexed_seq[j])
    return (np.asarray(centers, np.int32), np.asarray(contexts, np.int32))


def vectorized_skipgram_pairs(corpus: np.ndarray, window: int,
                              rng: np.random.Generator,
                              dynamic_window: bool = True
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Corpus-wide vectorized pair generation. ``corpus`` is the whole
    (sub-sampled) token-index stream with ``-1`` sentence separators; one
    numpy pass per window offset replaces the per-token Python loop of
    :func:`generate_skipgram_pairs` (same (center, context) multiset given
    the same window draws)."""
    corpus = np.asarray(corpus, np.int32)
    n = len(corpus)
    if n < 2:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    b = rng.integers(1, window + 1, n) if dynamic_window \
        else np.full(n, window)
    # segment id per position: a pair is valid only within one sentence —
    # endpoint checks alone would let d>=2 windows jump a short sentence
    seg = np.cumsum(corpus < 0)
    centers, contexts = [], []
    for d in range(1, window + 1):
        # context d positions to the right of the center...
        c, t, bb = corpus[:n - d], corpus[d:], b[:n - d]
        same = seg[:n - d] == seg[d:]
        valid = (c >= 0) & (t >= 0) & same & (bb >= d)
        centers.append(c[valid])
        contexts.append(t[valid])
        # ...and d positions to the left
        c, t, bb = corpus[d:], corpus[:n - d], b[d:]
        valid = (c >= 0) & (t >= 0) & same & (bb >= d)
        centers.append(c[valid])
        contexts.append(t[valid])
    return (np.concatenate(centers), np.concatenate(contexts))


def vectorized_cbow_windows(corpus: np.ndarray, window: int,
                            rng: np.random.Generator,
                            dynamic_window: bool = True):
    """Corpus-wide CBOW window extraction: returns (targets [M],
    context [M, 2*window] zero-padded, context_mask [M, 2*window]).
    Separator-aware like :func:`vectorized_skipgram_pairs`."""
    corpus = np.asarray(corpus, np.int32)
    n = len(corpus)
    if n < 2:
        return (np.zeros(0, np.int32),
                np.zeros((0, 2 * window), np.int32),
                np.zeros((0, 2 * window), np.float32))
    b = rng.integers(1, window + 1, n) if dynamic_window \
        else np.full(n, window)
    seg = np.cumsum(corpus < 0)     # same-sentence guard as skip-gram pairs
    ctx = np.full((n, 2 * window), -1, np.int32)
    slot = 0
    for d in range(1, window + 1):
        for sign in (-1, 1):
            src = np.full(n, -1, np.int32)
            same = np.zeros(n, bool)
            if sign < 0:
                src[d:] = corpus[:n - d]
                same[d:] = seg[d:] == seg[:n - d]
            else:
                src[:n - d] = corpus[d:]
                same[:n - d] = seg[:n - d] == seg[d:]
            ctx[:, slot] = np.where((b >= d) & same, src, -1)
            slot += 1
    mask = ctx >= 0
    rows = (corpus >= 0) & mask.any(axis=1)
    ctx = ctx[rows]
    mask = mask[rows]
    return (corpus[rows],
            np.where(mask, ctx, 0).astype(np.int32),
            mask.astype(np.float32))


def cbow_ns_step_rng(syn0, syn1neg, context, context_mask, target,
                     neg_table, key, lr, k: int):
    """CBOW negative-sampling step with negatives drawn on the device by
    ``key`` (see :func:`skipgram_ns_step_rng`)."""
    negs = _draw_negatives(neg_table, (target.shape[0], k), key)
    return _cbow_ns_core(syn0, syn1neg, context, context_mask, target, negs,
                         lr)


def cbow_ns_step(syn0, syn1neg, context, context_mask, target, negs, lr):
    """CBOW with negative sampling: mean-of-context hidden vector, same
    pos/neg head as skip-gram NS, gradient distributed over the context."""
    return _cbow_ns_core(syn0, syn1neg, context, context_mask, target, negs,
                         lr)


def _cbow_ns_core(syn0, syn1neg, context, context_mask, target, negs, lr):
    cm, denom, h = _context_mean(syn0, context, context_mask)
    tgt, label, v, sig = _ns_head(h, syn1neg, target, negs)
    g = label - sig
    loss = -_log_likelihood(label, sig, 1.0) / label.numel()
    dh = torch.einsum("bk,bkd->bd", g, v)
    dv = torch.einsum("bk,bd->bkd", g, h)
    _scatter_mean_add(syn1neg, tgt.reshape(-1), dv.reshape(-1, dv.shape[-1]),
                      lr)
    _spread_to_context(syn0, context, cm, denom, dh, lr)
    return syn0, syn1neg, loss
