"""PyTorch port, the dataset iterators on the CPU against the JAX package:
IDX files (plain and gzipped), MNIST, Iris, CIFAR-10, LFW and Curves
(the files on disk, written here, and the synthetic stand-ins), the
DataVec record readers and their iterators, and the native loader
(``csrc/dataloader.cpp`` built by g++ into ``build/native/``). Every
array and batch is compared bitwise: both packages draw from numpy's
generator in the same order, and the two native libraries are built from
the same C++ source by the same compiler."""

import gzip
import shutil
import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import datavec as jdv
from deeplearning4j_tpu.datasets import fetchers as jfe
from deeplearning4j_tpu.datasets import mnist as jmn
from deeplearning4j_tpu.datasets import native_loader as jnl
from deeplearning4j_tpu_torch import datasets as tds
from deeplearning4j_tpu_torch.datasets import datavec as tdv
from deeplearning4j_tpu_torch.datasets import mnist as tmn
from deeplearning4j_tpu_torch.datasets import native_loader as tnl


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the test workers of a parallel run would spin
    on each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_local_datasets(tmp_path, monkeypatch):
    """No dataset directory is found unless a test points at one: HOME and
    the working directory are empty, the dataset variables unset."""
    home = tmp_path / "home"
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.chdir(home)
    for var in ("MNIST_DIR", "CIFAR_DIR", "LFW_DIR"):
        monkeypatch.delenv(var, raising=False)


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("features", "labels", "features_mask", "labels_mask"):
            a, b = getattr(g, field), getattr(w, field)
            if b is None:
                assert a is None, field
            else:
                assert a.dtype == np.asarray(b).dtype, field
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=field)


def _write_idx(path, arr):
    arr = np.ascontiguousarray(arr, np.uint8)
    head = struct.pack(">I", 0x0800 | arr.ndim) + \
        b"".join(struct.pack(">I", d) for d in arr.shape)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(head + arr.tobytes())


def _mnist_dir(root, n_train=300, n_test=200, gz=False):
    """IDX files of synthetic glyphs in MNIST's layout under ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    sfx = ".gz" if gz else ""
    for prefix, n, train in (("train", n_train, True), ("t10k", n_test,
                                                        False)):
        imgs, labels = tmn._synthetic(n, train)
        _write_idx(root / f"{prefix}-images-idx3-ubyte{sfx}",
                   np.round(imgs * 255))
        _write_idx(root / f"{prefix}-labels-idx1-ubyte{sfx}", labels)
    return root


# --------------------------------------------------------------------- IDX
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_read_idx_matches_jax(tmp_path, gz):
    arr = np.random.default_rng(1).integers(0, 256, (7, 5, 3))
    path = tmp_path / ("a.idx.gz" if gz else "a.idx")
    _write_idx(path, arr)
    got = tmn._read_idx(path)
    assert got.dtype == np.uint8 and got.shape == (7, 5, 3)
    np.testing.assert_array_equal(got, jmn._read_idx(path))
    np.testing.assert_array_equal(got, arr)


# ------------------------------------------------------------------- MNIST
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_mnist_from_idx_files_matches_jax(tmp_path, monkeypatch, gz, train):
    monkeypatch.setenv("MNIST_DIR", str(_mnist_dir(tmp_path / "m", gz=gz)))
    for kw in (dict(shuffle=True, seed=3), dict(shuffle=False),
               dict(flatten=True, num_examples=130)):
        got = tds.MnistDataSetIterator(32, train=train, **kw)
        want = jmn.MnistDataSetIterator(32, train=train, **kw)
        assert not got.is_synthetic and not want.is_synthetic
        assert got.total_examples() == want.total_examples()
        _same_batches(got, want)
        _same_batches(got, want)          # the second epoch reshuffles


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_mnist_synthetic_matches_jax(train):
    a, b = tmn._synthetic(400, train), jmn._synthetic(400, train)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    got = tds.MnistDataSetIterator(64, num_examples=400, train=train)
    want = jmn.MnistDataSetIterator(64, num_examples=400, train=train)
    assert got.is_synthetic and want.is_synthetic
    _same_batches(got, want)


def test_iris_matches_jax():
    for kw in (dict(), dict(batch_size=40, num_examples=90, seed=5)):
        got, want = tds.IrisDataSetIterator(**kw), \
            jmn.IrisDataSetIterator(**kw)
        np.testing.assert_array_equal(got.features, want.features)
        np.testing.assert_array_equal(got.labels, want.labels)
        _same_batches(got, want)


# ------------------------------------------------------------ CIFAR / LFW
def test_cifar_synthetic_matches_jax():
    for kw in (dict(num_examples=64), dict(num_examples=48, train=False,
                                           shuffle=False, seed=1)):
        got = tds.CifarDataSetIterator(16, **kw)
        want = jfe.CifarDataSetIterator(16, **kw)
        assert got.is_synthetic and want.is_synthetic
        _same_batches(got, want)


def test_cifar_binary_batches_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + \
            ["test_batch.bin"]:
        rec = rng.integers(0, 256, (20, 3073), dtype=np.uint8)
        rec[:, 0] %= 10
        (tmp_path / name).write_bytes(rec.tobytes())
    monkeypatch.setenv("CIFAR_DIR", str(tmp_path))
    for train in (True, False):
        got = tds.CifarDataSetIterator(8, train=train, seed=2)
        want = jfe.CifarDataSetIterator(8, train=train, seed=2)
        assert not got.is_synthetic and got.total_examples() == \
            (100 if train else 20)
        _same_batches(got, want)


def test_lfw_synthetic_matches_jax():
    got = tds.LFWDataSetIterator(4, num_examples=32, image_size=48,
                                 num_identities=5)
    want = jfe.LFWDataSetIterator(4, num_examples=32, image_size=48,
                                  num_identities=5)
    assert got.is_synthetic
    _same_batches(got, want)


def test_lfw_images_match_jax(tmp_path, monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(6)
    for person in ("ann", "bob", "cy"):
        (tmp_path / "lfw" / person).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)
                            ).save(tmp_path / "lfw" / person / f"{i}.jpg")
    monkeypatch.setenv("LFW_DIR", str(tmp_path / "lfw"))
    got = tds.LFWDataSetIterator(2, image_size=16, seed=1)
    want = jfe.LFWDataSetIterator(2, image_size=16, seed=1)
    assert not got.is_synthetic and got.num_identities == 3
    _same_batches(got, want)


def test_curves_matches_jax():
    _same_batches(tds.CurvesDataSetIterator(10, num_examples=30, seed=4),
                  jfe.CurvesDataSetIterator(10, num_examples=30, seed=4))


# -------------------- the JAX package's TestFetchers cases, on the port
def test_fetchers_cifar_shapes():
    ds = next(iter(tds.CifarDataSetIterator(8, num_examples=64)))
    assert ds.features.shape == (8, 32, 32, 3)
    assert ds.labels.shape == (8, 10)
    assert 0.0 <= ds.features.min() and ds.features.max() <= 1.0
    assert np.allclose(ds.labels.sum(1), 1.0)


def test_fetchers_cifar_deterministic_classes():
    a = tds.CifarDataSetIterator(16, num_examples=64, shuffle=False, seed=1)
    b = tds.CifarDataSetIterator(16, num_examples=64, shuffle=False, seed=1)
    np.testing.assert_array_equal(next(iter(a)).features,
                                  next(iter(b)).features)


def test_fetchers_lfw_shapes():
    ds = next(iter(tds.LFWDataSetIterator(4, num_examples=32, image_size=48,
                                          num_identities=5)))
    assert ds.features.shape == (4, 48, 48, 3)
    assert ds.labels.shape == (4, 5)


def test_fetchers_curves_autoencoder_target():
    ds = next(iter(tds.CurvesDataSetIterator(10, num_examples=30)))
    assert ds.features.shape == (10, 784)
    np.testing.assert_array_equal(ds.features, ds.labels)
    assert 0 < ds.features.sum() < 784 * 10 * 0.5


# ---------------------------------------------------------------- DataVec
def _records():
    return [[1.0, 2.0, 0], [3.0, 4.0, 1], [5.0, 6.0, 2], [7.0, 8.0, 1],
            [9.0, 1.0, 0]]


def _seqs():
    return [[[1.0, 0], [2.0, 1], [3.0, 0]], [[4.0, 1]],
            [[5.0, 1], [6.0, 0]]]


DATAVEC_CASES = {
    "classification": lambda m: m.RecordReaderDataSetIterator(
        m.CollectionRecordReader(_records()), batch_size=2, label_index=2,
        num_classes=3),
    "regression": lambda m: m.RecordReaderDataSetIterator(
        m.CollectionRecordReader([[1.0, 2.0, 0.5], [3.0, 4.0, 1.5]]),
        batch_size=2, label_index=2, regression=True),
    "regression_range": lambda m: m.RecordReaderDataSetIterator(
        m.CollectionRecordReader(_records()), batch_size=3, label_index=1,
        label_index_to=2),
    "no_labels": lambda m: m.RecordReaderDataSetIterator(
        m.CollectionRecordReader(_records()), batch_size=4),
    "sequence_masks": lambda m: m.SequenceRecordReaderDataSetIterator(
        m.CollectionSequenceRecordReader(_seqs()), batch_size=2,
        label_index=1, num_classes=2),
    "sequence_regression": lambda m: m.SequenceRecordReaderDataSetIterator(
        m.CollectionSequenceRecordReader(_seqs()), batch_size=3,
        label_index=1, regression=True),
    "sequence_unlabelled": lambda m: m.SequenceRecordReaderDataSetIterator(
        m.CollectionSequenceRecordReader(_seqs()), batch_size=3),
}


@pytest.mark.parametrize("case", sorted(DATAVEC_CASES))
def test_datavec_iterators_match_jax(case):
    _same_batches(DATAVEC_CASES[case](tdv), DATAVEC_CASES[case](jdv))


def test_multi_dataset_iterator_matches_jax():
    def build(m):
        return (m.RecordReaderMultiDataSetIterator.Builder(2)
                .add_reader("in", m.CollectionRecordReader(_records()))
                .add_reader("aux", m.CollectionRecordReader(
                    [[float(i), float(i) / 2] for i in range(5)]))
                .add_input("in", 0, 1).add_input("aux")
                .add_output_one_hot("in", 2, 3).add_output("aux", 1)
                .build())
    got, want = list(build(tdv)), list(build(jdv))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            np.testing.assert_array_equal(a, b)


def test_csv_record_reader_matches_jax(tmp_path):
    path = tmp_path / "r.csv"
    path.write_text("a;b;c\n1.5;2;0\n3;;1\n\n5;6.25;2\n")
    for m in (tdv, jdv):
        assert list(m.CSVRecordReader(path, skip_lines=1, delimiter=";")) \
            == [[1.5, 2.0, 0.0], [3.0, 0.0, 1.0], [5.0, 6.25, 2.0]]
    _same_batches(
        tdv.RecordReaderDataSetIterator(tdv.CSVRecordReader(
            path, 1, ";"), 2, label_index=2, num_classes=3),
        jdv.RecordReaderDataSetIterator(jdv.CSVRecordReader(
            path, 1, ";"), 2, label_index=2, num_classes=3))


# the JAX package's TestDataVec cases, on the port
def test_datavec_classification_iterator():
    records = [[1.0, 2.0, 0], [3.0, 4.0, 1], [5.0, 6.0, 2], [7.0, 8.0, 1]]
    batches = list(tds.RecordReaderDataSetIterator(
        tds.CollectionRecordReader(records), batch_size=2, label_index=2,
        num_classes=3))
    assert len(batches) == 2
    assert batches[0].features.shape == (2, 2)
    assert batches[0].labels.shape == (2, 3)
    np.testing.assert_allclose(batches[0].labels[1], [0, 1, 0])


def test_datavec_regression_iterator():
    ds = next(iter(tds.RecordReaderDataSetIterator(
        tds.CollectionRecordReader([[1.0, 2.0, 0.5], [3.0, 4.0, 1.5]]),
        batch_size=2, label_index=2, regression=True)))
    np.testing.assert_allclose(ds.labels[:, 0], [0.5, 1.5])


def test_datavec_sequence_iterator_masks():
    seqs = [[[1.0, 0], [2.0, 1], [3.0, 0]], [[4.0, 1]]]
    ds = next(iter(tds.SequenceRecordReaderDataSetIterator(
        tds.CollectionSequenceRecordReader(seqs), batch_size=2,
        label_index=1, num_classes=2)))
    assert ds.features.shape == (2, 3, 1)
    np.testing.assert_allclose(ds.features_mask, [[1, 1, 1], [1, 0, 0]])
    np.testing.assert_allclose(ds.labels[0, 1], [0, 1])


def test_datavec_multi_dataset_iterator():
    it = (tds.RecordReaderMultiDataSetIterator.Builder(2)
          .add_reader("in", tds.CollectionRecordReader([[1, 2, 0],
                                                        [3, 4, 1]]))
          .add_input("in", 0, 1)
          .add_output_one_hot("in", 2, 2)
          .build())
    mds = next(iter(it))
    assert mds.features[0].shape == (2, 2)
    assert mds.labels[0].shape == (2, 2)


# ----------------------------------------------------------- native loader
def test_native_loader_builds_into_build_native():
    assert tnl.native_available()
    path = tnl.library_path()
    assert path.exists() and path.parent.name == "native" and \
        path.parent.parent.name == "build"
    assert path.name.startswith("libdl4j_loader-")


def test_native_mnist_matches_python_iterator_and_jax(tmp_path, monkeypatch):
    root = _mnist_dir(tmp_path / "m", n_train=200, n_test=100)
    monkeypatch.setenv("MNIST_DIR", str(root))
    images = root / "train-images-idx3-ubyte"
    labels = root / "train-labels-idx1-ubyte"
    native = list(tnl.NativeMnistDataSetIterator(images, labels, 64,
                                                 shuffle=False))
    python = list(jmn.MnistDataSetIterator(64, shuffle=False, flatten=True))
    # the Python iterator drops the last partial batch, the native ring
    # hands it over
    assert [b.num_examples() for b in native] == [64, 64, 64, 8]
    _same_batches(native[:3], python)
    _same_batches(native[:3], tds.MnistDataSetIterator(64, shuffle=False,
                                                       flatten=True))
    if jnl.native_available():
        for seed in (0, 9):
            got = tnl.NativeMnistDataSetIterator(images, labels, 48,
                                                 shuffle=True, seed=seed)
            want = jnl.NativeMnistDataSetIterator(images, labels, 48,
                                                  shuffle=True, seed=seed)
            for _ in range(2):           # the second epoch: seed + 1
                _same_batches(got, want)


def test_native_csv_matches_record_reader_and_jax(tmp_path):
    rng = np.random.default_rng(8)
    rows = np.concatenate([rng.integers(0, 4, (90, 1)),
                           rng.integers(0, 256, (90, 12))], axis=1)
    path = tmp_path / "d.csv"
    path.write_text("label,px\n" + "\n".join(",".join(map(str, r))
                                              for r in rows) + "\n")
    native = tnl.NativeCSVDataSetIterator(path, 32, label_index=0,
                                          num_classes=4, shuffle=False,
                                          skip_lines=1)
    assert native.total_examples() == 90
    for reader in (tdv, jdv):
        _same_batches(native, reader.RecordReaderDataSetIterator(
            reader.CSVRecordReader(path, skip_lines=1), 32, label_index=0,
            num_classes=4))
    if jnl.native_available():
        got = tnl.NativeCSVDataSetIterator(path, 16, label_index=0,
                                           num_classes=4, seed=5,
                                           skip_lines=1)
        want = jnl.NativeCSVDataSetIterator(path, 16, label_index=0,
                                            num_classes=4, seed=5,
                                            skip_lines=1)
        for _ in range(2):
            _same_batches(got, want)


def test_native_loader_failed_build_raises_with_gxx_stderr(tmp_path):
    broken = tmp_path / "dataloader.cpp"
    shutil.copy(tnl.SOURCE, broken)
    broken.write_text(broken.read_text() + "\nint broken( {\n")
    with pytest.raises(tnl.NativeBuildError, match="error"):
        tnl.build_library(broken, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so"))


def test_native_loader_missing_file_raises(tmp_path):
    with pytest.raises(IOError, match="cannot load"):
        tnl.NativeCSVDataSetIterator(tmp_path / "none.csv", 4)
