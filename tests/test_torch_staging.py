"""PyTorch port, the training feed's host→device stage
(``ops.transfer.stage_to_device``) on the CPU: the host's cast into the
stage's wire dtype rounds f32 to bf16 to nearest even, bit for bit as
``Tensor.to`` and as an integer-arithmetic reference, ties, subnormals,
infinities and zeros included (NaN stays NaN); the wire dtype is the
narrower of the source's and the target's, so int32 ids cross as int32
and widen to int64 after; strided, reversed, broadcast and read-only
numpy inputs are read in place where torch can view them; the counters
split staged from direct transfers, and the telemetry snapshot shows
them; CPU targets and inputs already on a device take the direct path,
as ``Tensor.to`` converts, and so do the networks' input conversions on
a CPU net. The staged copy to the card and its pinned blocks are held in
``test_torch_kernels_cuda.py``."""

import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.observability.telemetry import TelemetryServer
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.ops.transfer import (_host_stage, _takes_stage,
                                                   host_tensor, stage_counts,
                                                   stage_to_device)

CUDA = torch.device("cuda")


def _f32(*bits):
    return np.array(bits, np.uint32).view(np.float32)


#: f32 values by the case of round-to-nearest-even they exercise
SPECIALS = {
    # exact halfway between two bf16 values: the even one wins, upward
    # into the next binade and into infinity included
    "ties": _f32(0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                 0x00008000, 0x00018000, 0x7F7F8000, 0x3FFF8000),
    # below the smallest normal: kept, not flushed to zero
    "subnormals": np.concatenate([
        np.array([1e-40, -1e-40, 1.4e-45, -1.4e-45, 5e-39], np.float32),
        _f32(0x007FFFFF, 0x00400000, 0x80000001, 0x0000FFFF)]),
    "inf_and_zero": np.array([np.inf, -np.inf, 0.0, -0.0, 3.4028235e38,
                              -3.4028235e38], np.float32),
    "noise": (np.random.default_rng(7).normal(size=4096)
              * 10.0 ** np.random.default_rng(8).integers(-44, 38, 4096)
              ).astype(np.float32),
}


def _rne_bf16_bits(x: np.ndarray) -> np.ndarray:
    """bf16 bit patterns of finite-or-infinite f32 ``x``, rounded to
    nearest even in integer arithmetic."""
    u = x.view(np.uint32).astype(np.uint64)
    return (((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF) \
        .astype(np.uint16).view(np.int16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("case", sorted(SPECIALS))
def test_host_cast_rounds_as_tensor_to(case):
    x = SPECIALS[case]
    got = _host_stage(torch.from_numpy(x), torch.bfloat16, pin_memory=False)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(got), _bits(torch.from_numpy(x).to(torch.bfloat16)))
    np.testing.assert_array_equal(_bits(got), _rne_bf16_bits(x))


def test_host_cast_keeps_nan_a_nan():
    x = np.concatenate([np.array([np.nan, -np.nan], np.float32),
                        _f32(0x7F800001, 0xFFC00001, 0x7FBFFFFF)])
    got = _host_stage(torch.from_numpy(x), torch.bfloat16, pin_memory=False)
    assert torch.isnan(got).all()


#: (source dtype, target dtype, the dtype that crosses the wire)
WIRE = [(np.float32, torch.bfloat16, torch.bfloat16),
        (np.float64, torch.float32, torch.float32),
        (np.float16, torch.float32, torch.float16),
        (np.int32, torch.int64, torch.int32),
        (np.int64, torch.int64, torch.int64),
        (np.int32, torch.float32, torch.float32),
        (np.bool_, torch.bfloat16, torch.bool)]


@pytest.mark.parametrize("src,dst,wire", WIRE, ids=lambda v: str(v))
def test_the_narrower_dtype_crosses_the_wire(src, dst, wire):
    x = (np.random.default_rng(3).normal(size=(5, 7)) * 50).astype(src)
    staged = _host_stage(torch.from_numpy(x), dst, pin_memory=False)
    assert staged.dtype == wire
    want = torch.from_numpy(x).to(dst)
    assert torch.equal(staged.to(dst), want)
    got = stage_to_device(x, "cpu", dst)
    assert got.dtype == dst and torch.equal(got, want)


def test_int32_ids_stay_integers_and_widen_to_long():
    ids = np.array([0, 1, 257, 4097, 2 ** 24 + 1, 2 ** 31 - 1], np.int32)
    staged = _host_stage(torch.from_numpy(ids), torch.long, pin_memory=False)
    assert staged.dtype == torch.int32
    np.testing.assert_array_equal(staged.numpy(), ids)
    got = stage_to_device(ids, "cpu", torch.long)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ids.astype(np.int64))


def _read_only(a):
    a = a.copy()
    a.setflags(write=False)
    return a


#: numpy inputs torch must read as they lie (the last one it cannot view)
LAYOUTS = {
    "transposed": lambda a: a.transpose(0, 2, 1),
    "strided": lambda a: a[:, ::2, 1:],
    "fortran": np.asfortranarray,
    "read_only": _read_only,
    "broadcast": lambda a: np.broadcast_to(a[:1], a.shape),
    "reversed": lambda a: a[::-1, :, ::-1],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_strided_and_read_only_numpy_inputs(layout):
    base = np.random.default_rng(4).normal(size=(3, 6, 5)).astype(np.float32)
    a = LAYOUTS[layout](base)
    want = torch.from_numpy(np.ascontiguousarray(a))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = host_tensor(a)
        staged = _host_stage(t, torch.bfloat16, pin_memory=False)
        direct = stage_to_device(a, "cpu", torch.bfloat16)
    assert torch.equal(t, want)
    if layout != "reversed":            # a view, not a copy
        assert t.data_ptr() == a.__array_interface__["data"][0]
    np.testing.assert_array_equal(_bits(staged),
                                  _bits(want.to(torch.bfloat16)))
    assert torch.equal(direct, want.to(torch.bfloat16))


def test_counters_split_staged_from_direct():
    x = np.ones((4, 8), np.float32)
    before = stage_counts()
    stage_to_device(x, "cpu", torch.bfloat16)
    stage_to_device(torch.from_numpy(x), torch.device("cpu"))
    _host_stage(torch.from_numpy(x), torch.bfloat16, pin_memory=False)
    _host_stage(torch.from_numpy(x), torch.float64, pin_memory=False)
    after = stage_counts()
    assert after["direct"] - before["direct"] == 2
    assert after["staged"] - before["staged"] == 2
    assert after["staged_bytes"] - before["staged_bytes"] == 32 * 2 + 32 * 4


def test_telemetry_snapshot_shows_the_stage_counters():
    srv = TelemetryServer(port=0).start()
    try:
        stage_to_device(np.zeros(3, np.float32), "cpu")
        stage_to_device(np.zeros(3, np.float32), "cpu")
        _host_stage(torch.zeros(3), torch.bfloat16, pin_memory=False)
        deltas = srv.snapshot()["transfers"]
    finally:
        srv.stop()
    assert deltas["h2d.direct"] == 2
    assert deltas["h2d.staged"] == 1 and deltas["h2d.staged_bytes"] == 6


@pytest.mark.parametrize("where,target,staged", [
    ("cpu", CUDA, True),
    ("cpu", torch.device("cpu"), False),
    ("meta", CUDA, False),          # any tensor already on a device
    ("meta", torch.device("cpu"), False),
])
def test_only_pageable_host_tensors_bound_for_the_card_are_staged(
        where, target, staged):
    assert _takes_stage(torch.empty(4, 3, device=where), target) is staged


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16,
                                   torch.int64])
def test_cpu_target_converts_as_tensor_to(dtype):
    t = torch.randn(6, 4)
    got = stage_to_device(t, "cpu", dtype)
    want = t.to("cpu", dtype or t.dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if dtype in (None, torch.float32):
        assert got is t                 # no copy, as Tensor.to


def _conf():
    return (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").activation("tanh"))


def _graph(dtype):
    conf = (_conf().graph_builder().add_inputs("in")
            .add_layer("d", DenseLayer(n_out=6), "in")
            .add_layer("out", OutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"), "d")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(conf, device="cpu", compute_dtype=dtype).init()


def _mln(dtype):
    conf = (_conf().list().layer(DenseLayer(n_out=6))
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu", compute_dtype=dtype).init()


@pytest.mark.parametrize("make", [_graph, _mln], ids=["graph", "multilayer"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cpu_nets_convert_their_batches_directly(make, dtype):
    """A CPU net's features land in its compute dtype, int32 ids as int64,
    every transfer counted direct, and fit_batch trains as before."""
    net = make(dtype)
    graph = isinstance(net, ComputationGraph)
    convert = net._to_device_dtype if graph else net._as_tensor
    step = net.fit_batch if graph else net._fit_batch
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 4))                       # float64 on the host
    ids = rng.integers(0, 3, 8).astype(np.int32)
    got_x, got_ids = convert(x), convert(ids)
    assert got_x.dtype == dtype
    assert torch.equal(got_x, torch.from_numpy(x).to(dtype))
    assert got_ids.dtype == torch.int64
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    before = stage_counts()
    step(DataSet(x.astype(np.float32), np.eye(3, dtype=np.float32)[ids]))
    after = stage_counts()
    assert after["direct"] - before["direct"] == 2
    assert after["staged"] == before["staged"]
    assert np.isfinite(float(net.score_value))
