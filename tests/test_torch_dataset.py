"""PyTorch port, the data containers and normalizers on the CPU: the
port's own ``ops/dataset.py`` (DataSet's split / shuffle / batch / merge,
MultiDataSet, NormalizerStandardize, NormalizerMinMaxScaler,
ImagePreProcessingScaler) and ``models/transformer.py::lm_batch`` against
the JAX package's on the same seeded numpy inputs, serialized normalizers
read both ways.

Tolerances: both packages run the same numpy code on the same arrays, so
arrays agree exactly (shuffles draw from the same numpy generator) and
fitted statistics to 1e-12."""

import numpy as np
import pytest

from deeplearning4j_tpu.models import lm_batch as jax_lm_batch
from deeplearning4j_tpu.ops import dataset as jds
from deeplearning4j_tpu_torch.datasets.iterators import as_iterator
from deeplearning4j_tpu_torch.models import lm_batch
from deeplearning4j_tpu_torch.ops import dataset as tds

STAT = dict(rtol=1e-12, atol=1e-12)


def _arrays(seed=0, n=10, t=None):
    rng = np.random.default_rng(seed)
    shape = (n, 3) if t is None else (n, 3, t)
    f = rng.normal(size=shape).astype(np.float32) * 4 + 2
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    fm = (rng.random((n, 5)) > 0.3).astype(np.float32)
    lm = (rng.random((n, 5)) > 0.3).astype(np.float32)
    return f, y, fm, lm


def _fields(ds):
    return [ds.features, ds.labels, ds.features_mask, ds.labels_mask]


def _same(a, b):
    for x, y in zip(_fields(a), _fields(b)):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("op", ["split", "shuffle", "batch_by", "merge"])
def test_dataset_methods_match_jax(op):
    arrs = _arrays(1)
    j, p = jds.DataSet(*arrs), tds.DataSet(*arrs)
    if op == "split":
        for a, b in zip(p.split_test_and_train(7), j.split_test_and_train(7)):
            _same(a, b)
    elif op == "shuffle":
        p.shuffle(np.random.default_rng(3))
        j.shuffle(np.random.default_rng(3))
        _same(p, j)
        assert not np.array_equal(p.features, arrs[0])
    elif op == "batch_by":
        pb, jb = p.batch_by(4), j.batch_by(4)
        assert [b.num_examples() for b in pb] == [4, 4, 2]
        for a, b in zip(pb, jb):
            _same(a, b)
    else:
        merged = tds.DataSet.merge(p.batch_by(3))
        _same(merged, jds.DataSet.merge(j.batch_by(3)))
        _same(merged, p)


def test_multidataset_matches_jax_and_iterates():
    f, y, fm, lm = _arrays(2)
    args = ([f, f[:, :2]], [y, y[:, :1]], [fm, None], [lm, lm])
    p, j = tds.MultiDataSet(*args), jds.MultiDataSet(*args)
    assert p.num_examples() == j.num_examples() == 10
    assert [b is p for b in as_iterator(p)] == [True]
    assert len(list(as_iterator([p, p]))) == 2


@pytest.mark.parametrize("t", [None, 6], ids=["ff", "time-series"])
@pytest.mark.parametrize("kind", ["standardize", "standardize-labels",
                                  "minmax", "image"])
def test_normalizers_match_jax_and_round_trip(kind, t):
    """fit on an iterator (merged) or a DataSet, transform, revert and
    to_bytes / from_bytes: the same statistics and arrays as the JAX
    package's, and each package reads the other's bytes."""
    f, y, fm, lm = _arrays(3, t=t)
    if kind == "image":
        f = np.abs(f) * 30
    make = {"standardize": lambda m: m.NormalizerStandardize(),
            "standardize-labels": lambda m: m.NormalizerStandardize(
                fit_labels=True),
            "minmax": lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0),
            "image": lambda m: m.ImagePreProcessingScaler(0.0, 1.0, 255.0)}
    pn, jn = make[kind](tds), make[kind](jds)
    pd = tds.DataSet(f, y, fm, lm)
    jd = jds.DataSet(f, y, fm, lm)
    pn.fit(as_iterator(pd.batch_by(4)))
    jn.fit(jd)
    for k, v in jn.__dict__.items():
        got = pn.__dict__[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_allclose(got, v, **STAT)
        else:
            assert got == v
    out, want = pn.transform(pd), jn.transform(jd)
    _same(out, want)
    np.testing.assert_allclose(pn.revert_features(out.features), f,
                               rtol=1e-5, atol=1e-4)
    for blob, reader in ((pn.to_bytes(), jds.DataNormalizer.from_bytes),
                         (jn.to_bytes(), tds.DataNormalizer.from_bytes),
                         (pn.to_bytes(), tds.DataNormalizer.from_bytes)):
        again = reader(blob)
        assert again.kind == pn.kind
        _same(again.transform(jd if reader is jds.DataNormalizer.from_bytes
                              else pd), want)


def test_lm_batch_matches_jax():
    tokens = np.random.default_rng(4).integers(0, 50, (3, 9))
    x, y = lm_batch(tokens, 50)
    jx, jy = jax_lm_batch(tokens, 50)
    assert x.dtype == np.int32 and y.dtype == np.float32
    assert y.shape == (3, 8, 50)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(y.argmax(-1), tokens[:, 1:])
