"""PyTorch port: the paged KV cache's host half (``models/paging.py``)
against the JAX package's. Chain digests and routing keys byte-equal, the
allocator's cases of the JAX suite on the port's allocator, page frame
sets byte-compatible across the packages in f32 and bfloat16 (the port
with neither JAX nor ml_dtypes), and hostile payloads refused."""

import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import paging as jpaging
from deeplearning4j_tpu_torch.models.paging import (
    NULL_PAGE, PageAllocator, PageCorruptionError, PageFrameError,
    PageFrameSet, chain_digests, device_frames, host_frames,
    prefix_route_key)


# ------------------------------------------------------------ digests
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n, page_size", [(0, 4), (7, 4), (16, 4), (37, 8),
                                          (256, 16)])
def test_chain_digests_and_route_key_equal_jax(dtype, n, page_size):
    toks = np.random.default_rng(n).integers(0, 32000, n).astype(dtype)
    assert chain_digests(toks, page_size) == \
        jpaging.chain_digests(toks, page_size)
    assert prefix_route_key(toks, page_size) == \
        jpaging.prefix_route_key(toks, page_size)


def test_digests_canonicalize_and_commit_to_the_prefix():
    a = np.arange(8, dtype=np.int64)
    assert chain_digests(a, 4) == chain_digests(a.astype(np.int32), 4)
    assert prefix_route_key([1, 2], 4) != prefix_route_key([2, 1], 4)
    assert prefix_route_key(np.arange(8), 4) != \
        prefix_route_key(np.arange(8), 8)
    other = np.concatenate([a[:4], [99] * 4])
    assert chain_digests(other, 4)[0] == chain_digests(a, 4)[0]
    assert chain_digests(other, 4)[1] != chain_digests(a, 4)[1]


# ---------------------------------------------------------- allocator
def test_null_page_reserved_and_bounds():
    pa = PageAllocator(5, 4)
    got = pa.alloc(4)
    assert got is not None and NULL_PAGE not in got
    assert sorted(got) == [1, 2, 3, 4]
    assert pa.alloc(1) is None              # exhausted, never partial
    assert pa.alloc_failures == 1
    with pytest.raises(ValueError):
        PageAllocator(1, 4)
    with pytest.raises(ValueError):
        PageAllocator(8, 0)


def test_ref_unref_and_underflow():
    pa = PageAllocator(4, 4)
    (pid,) = pa.alloc(1)
    pa.ref(pid)
    pa.unref(pid)
    pa.unref(pid)
    assert sorted(pa.alloc(3)) == [1, 2, 3]
    pa.unref(pid)
    with pytest.raises(RuntimeError, match="underflow"):
        pa.unref(pid)
    with pytest.raises(RuntimeError, match="unheld"):
        PageAllocator(4, 4).ref(1)


def test_match_register_and_cap():
    pa = PageAllocator(8, 4)
    toks = np.arange(12)
    pages = pa.alloc(3)
    assert pa.register_chain(toks, pages) == 3
    got, n = pa.match_and_ref(toks)
    assert got == pages and n == 12
    for pid in got:
        pa.unref(pid)
    got, n = pa.match_and_ref(toks, max_tokens=11)
    assert got == pages[:2] and n == 8
    for pid in got:
        pa.unref(pid)
    assert pa.register_chain(toks, pages) == 0


def test_divergent_content_misses_from_divergence_on():
    pa = PageAllocator(8, 4)
    toks = np.arange(12)
    pages = pa.alloc(3)
    pa.register_chain(toks, pages)
    got, n = pa.match_and_ref(np.concatenate([toks[:4], [99] * 8]))
    assert got == pages[:1] and n == 4
    for pid in got:
        pa.unref(pid)


def test_eviction_lru_leaves_before_parents():
    pa = PageAllocator(4, 4)
    toks = np.arange(12)
    pages = pa.alloc(3)
    pa.register_chain(toks, pages)
    for pid in pages:
        pa.unref(pid)                       # cache-only now
    (fresh,) = pa.alloc(1)
    assert fresh == pages[-1] and pa.evictions == 1
    got, n = pa.match_and_ref(toks)
    assert n == 8 and got == pages[:2]
    for pid in got:
        pa.unref(pid)
    pa.unref(fresh)


def test_still_mapped_pages_are_not_evictable():
    pa = PageAllocator(3, 4)
    toks = np.arange(8)
    pages = pa.alloc(2)
    pa.register_chain(toks, pages)          # refs: map + index each
    assert pa.alloc(1) is None
    assert pa.stats()["shared"] == 0        # retention is not sharing
    got, _ = pa.match_and_ref(toks)
    assert pa.stats()["shared"] == 2
    for pid in got:
        pa.unref(pid)


def test_unsatisfiable_alloc_never_evicts_the_cache():
    pa = PageAllocator(4, 4)
    pages = pa.alloc(3)
    pa.register_chain(np.arange(12), pages)
    for pid in pages:
        pa.unref(pid)
    assert pa.alloc(4) is None
    assert pa.evictions == 0
    got, n = pa.match_and_ref(np.arange(12))
    assert n == 12
    for pid in got:
        pa.unref(pid)


def test_audit_balance_and_detection():
    pa = PageAllocator(6, 4)
    pages = pa.alloc(2)
    pa.register_chain(np.arange(8), pages)
    assert pa.audit([pages]) == []
    assert any("refcount" in p for p in pa.audit([]))


def test_prefix_cache_off_is_inert():
    pa = PageAllocator(6, 4, prefix_cache=False)
    pages = pa.alloc(2)
    assert pa.register_chain(np.arange(8), pages) == 0
    assert pa.match_and_ref(np.arange(8)) == ([], 0)


def test_evict_pages_and_free_subset():
    pa = PageAllocator(6, 4)
    pages = pa.alloc(2)
    pa.register_chain(np.arange(8), pages)
    dgs = pa.evict_pages([pages[1]])
    assert dgs == [chain_digests(np.arange(8), 4)[1]]
    assert pa.stats()["cached"] == 1
    pa.unref(pages[1])
    assert pa.free_subset(pages) == [pages[1]]
    assert pa.evict_digests(chain_digests(np.arange(8), 4)) == 1
    pa.unref(pages[0])
    assert pa.audit([]) == []


def test_allocator_sequence_matches_jax():
    """One scripted history through both allocators: the same page ids,
    matches, evictions and stats at every step."""
    rng = np.random.default_rng(3)
    prompts = [np.concatenate([np.arange(8), rng.integers(0, 50, 6)])
               for _ in range(5)]
    ours, theirs = PageAllocator(9, 4), jpaging.PageAllocator(9, 4)
    for p in prompts:
        rows = []
        for pa in (ours, theirs):
            shared, start = pa.match_and_ref(p, max_tokens=len(p) - 1)
            fresh = pa.alloc(len(p) // 4 + 1 - len(shared))
            pages = shared + (fresh or [])
            pa.register_chain(p, pages[:len(p) // 4])
            for pid in pages:
                pa.unref(pid)
            rows.append((shared, start, fresh, pa.stats()))
        assert rows[0] == rows[1]
    assert ours.audit([]) == theirs.audit([]) == []


# -------------------------------------------------------- page frames
def _frames(dtype, n_pages=3, seed=0):
    """The same page data as (JAX-side ndarray layers, port layers,
    port dtype name); bfloat16 rounds the f32 draw in both."""
    rng = np.random.default_rng(seed)
    shapes = {"attn0": (n_pages, 2, 4, 8), "attn1": (n_pages, 2, 4, 8)}
    jl, pl = {}, {}
    for n, sh in shapes.items():
        jl[n], pl[n] = {}, {}
        for kk in ("k", "v"):
            x = rng.standard_normal(sh).astype(np.float32)
            if dtype == "bfloat16":
                ja = np.asarray(jnp.asarray(x, jnp.bfloat16))
                pa, name = host_frames(torch.from_numpy(x).to(
                    torch.bfloat16))
                assert name == "bfloat16"
                np.testing.assert_array_equal(pa, ja.view(np.uint16))
            else:
                ja = pa = x
            jl[n][kk], pl[n][kk] = ja, pa
    return jl, pl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_frame_sets_byte_equal_across_packages(dtype):
    jl, pl = _frames(dtype)
    toks = np.arange(11, dtype=np.int64)
    theirs = jpaging.PageFrameSet(4, toks, jl)
    ours = PageFrameSet(4, toks, pl, dtype=dtype)
    assert ours.dtype == theirs.dtype == dtype
    assert ours.page_checksums == theirs.page_checksums
    assert ours.nbytes == theirs.nbytes
    assert ours.to_bytes() == theirs.to_bytes()
    assert ours.to_frames() == theirs.to_frames()

    for got in (PageFrameSet.from_bytes(theirs.to_bytes()),
                PageFrameSet.from_frames(theirs.to_frames())):
        assert got.dtype == dtype and got.verify() == []
        np.testing.assert_array_equal(got.tokens, toks)
        for n in pl:
            for kk in ("k", "v"):
                np.testing.assert_array_equal(got.layers[n][kk], pl[n][kk])
    for got in (jpaging.PageFrameSet.from_bytes(ours.to_bytes()),
                jpaging.PageFrameSet.from_frames(ours.to_frames())):
        assert got.dtype == dtype
        for n in jl:
            for kk in ("k", "v"):
                assert got.layers[n][kk].tobytes() == jl[n][kk].tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_page_frames_from_and_to_tensors(dtype):
    x = torch.randn(3, 2, 4, 8, generator=torch.Generator().manual_seed(1))
    frames = {"a": {"k": x.to(dtype), "v": (2 * x).to(dtype)}}
    fs = PageFrameSet.from_tensors(4, np.arange(9), frames)
    back = PageFrameSet.from_bytes(fs.to_bytes()).tensors("cpu")
    for kk in ("k", "v"):
        assert back["a"][kk].dtype == dtype
        assert torch.equal(back["a"][kk], frames["a"][kk])
    raw, name = host_frames(frames["a"]["k"])
    assert torch.equal(device_frames(raw, name, "cpu"), frames["a"]["k"])


def test_frames_without_checksums_read_back():
    _, pl = _frames("float32")
    fs = PageFrameSet(4, np.arange(5), pl, checksums=False)
    assert "sums" not in fs._header()
    assert PageFrameSet.from_bytes(fs.to_bytes()).page_checksums is None


def _forge_header(data: bytes, **changes) -> bytes:
    """Rewrite the JSON header of a bulk payload (lengths kept valid)."""
    import json
    hlen = struct.unpack_from("<II", data, 4)[1]
    head = json.loads(data[12:12 + hlen])
    head.update(changes)
    new = json.dumps(head, sort_keys=True).encode()
    return data[:4] + struct.pack("<II", 1, len(new)) + new + \
        data[12 + hlen:]


def test_corrupt_and_forged_payloads_raise():
    _, pl = _frames("float32")
    fs = PageFrameSet(4, np.arange(10), pl)
    data = fs.to_bytes()
    bad = [data[:8],                                   # truncated
           b"XXXX" + data[4:],                         # magic
           data[:4] + struct.pack("<I", 2) + data[8:],  # version
           data[:-1] + bytes([data[-1] ^ 1]),          # CRC
           data[:4] + struct.pack("<II", 1, 1 << 30) + data[12:],
           _forge_header(data, n_pages=1 << 40),       # hostile claim
           _forge_header(data, layers=7),
           _forge_header(data, dtype="no-such-dtype"),
           _forge_header(data, sums=123)]
    for payload in bad:
        with pytest.raises(PageFrameError):
            PageFrameSet.from_bytes(payload)
    frames = fs.to_frames()
    for stream in ([], frames[:-1], frames[:1] + [frames[1], frames[1]] +
                   frames[3:], frames[:1] + [b"DKVQ" + frames[1][4:]] +
                   frames[2:]):
        with pytest.raises(PageFrameError):
            PageFrameSet.from_frames(stream)


def test_silently_corrupted_content_fails_its_checksum():
    """Bytes flipped after the stamp: every CRC passes, the content
    checksum does not."""
    _, pl = _frames("float32")
    fs = PageFrameSet(4, np.arange(10), pl)
    fs.layers["attn1"]["v"][2, 0, 0, 0] *= -1
    assert fs.verify() == [2]
    with pytest.raises(PageCorruptionError):
        PageFrameSet.from_bytes(fs.to_bytes())
    with pytest.raises(PageCorruptionError):
        PageFrameSet.from_frames(fs.to_frames())
    with pytest.raises(PageFrameError):
        PageFrameSet(4, np.arange(10), pl, checksums=[b"x"])


def test_crc_framing_matches_zlib():
    _, pl = _frames("float32", n_pages=1)
    data = PageFrameSet(4, np.arange(3), pl).to_bytes()
    hlen = struct.unpack_from("<II", data, 4)[1]
    n, crc = struct.unpack_from("<QI", data, 12 + hlen)
    raw = data[24 + hlen:24 + hlen + n]
    assert n == 12 and crc == zlib.crc32(raw)
    np.testing.assert_array_equal(np.frombuffer(raw, np.int32), [0, 1, 2])
