"""PyTorch port, scale-out training on the CPU: every test of
``tests/test_scaleout.py`` mirrored on the port (the asynchronous
parameter servers, Python and native, the cluster TrainingMaster,
EarlyStoppingParallelTrainer, MagicQueue, the CLI, local-steps DP with
masks, threshold-encoded sharing and ragged-batch padding), each mesh a
list of CPU devices (``[cpu] * n``: several data shards on one device, as
on one card). Then the port against the JAX package on the same numpy
weights (``utils/serializer.py``'s carry) and seeded data, the JAX side on
the conftest's host devices: sync DP of a small MLP on a ragged batch and
on fewer rows than shards, the graph trainer on a ragged batch, a graph
with two outputs whose label masks differ, a 2-layer transformer LM at
data 2, local steps on the masked LSTM, compressed local steps, and
``threshold_encode`` over one residual sequence; sync DP over two data
shards of nets with a batch norm or a center-loss head (the global
batch's statistics and class means, against JAX and the solo step; ROADMAP
A9b-bn); and checkpoints with
updater state and normalizer both ways through ``ModelSerializer`` and
``ModelGuesser``.

Tolerances: f32 parity at the JAX tests' own (rtol 1e-5, atol 1e-7 on
the MLP parameters; 1e-6 on the LSTM, whose recurrence compounds the
summation-order differences of both sides over its steps); the LM's
parameters after adam steps at atol 1e-5, as
``test_torch_training.py::test_adam_steps_match_jax`` holds solo steps;
threshold encoding exactly (elementwise f32 arithmetic on both sides)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm_conf as jax_lm_conf
from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.nn.graph.graph_config import \
    ComputationGraphConfiguration as JaxCGC
from deeplearning4j_tpu.ops.dataset import DataNormalizer as JaxNormalizer
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.ops.dataset import MultiDataSet as JaxMultiDataSet
from deeplearning4j_tpu.parallel import compression as jcomp
from deeplearning4j_tpu.parallel import make_mesh as jax_mesh
from deeplearning4j_tpu.parallel.graph_wrapper import \
    GraphDataParallelTrainer as JaxGraphDP
from deeplearning4j_tpu.parallel.wrapper import \
    ParallelWrapper as JaxParallelWrapper
from deeplearning4j_tpu.utils.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.models import (lm_batch_sparse,
                                             transformer_lm_conf)
from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import (LSTM, BatchNormalization,
                                                     DenseLayer, OutputLayer,
                                                     RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.ops.dataset import (DataSet, MultiDataSet,
                                                  NormalizerStandardize)
from deeplearning4j_tpu_torch.parallel import (GraphDataParallelTrainer,
                                               ParallelWrapper, make_mesh)
from deeplearning4j_tpu_torch.parallel.compression import (sent_fraction,
                                                           threshold_encode)
from deeplearning4j_tpu_torch.utils import (ModelGuesser, ModelSerializer,
                                            graph_from_numpy,
                                            network_from_numpy)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for these tiny CPU tensors. With torch's
    default of a thread a core, the test workers of a parallel run spin
    on each other's cores: the compression tests took ~450 s each under
    six concurrent runs, ~10 s with one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n):
    return make_mesh(devices=[CPU] * n)


def _net(seed=7, lr=0.1):
    conf = (NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
            .updater("sgd").weight_init("xavier").activation("tanh").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _batches(rng, n=12, b=16):
    out = []
    for _ in range(n):
        X = rng.normal(size=(b, 4)).astype(np.float32)
        y = np.eye(3)[(np.abs(X).sum(1) * 3).astype(int) % 3]
        out.append(DataSet(X, y.astype(np.float32)))
    return out


def _fit_score(net, batches):
    ev = Evaluation()
    for ds in batches:
        ev.eval(np.asarray(ds.labels), np.asarray(net.output(ds.features)))
    return ev.accuracy()


def _pw(net, n, k=1, **kw):
    """A ParallelWrapper of ``n`` CPU shards, averaging every ``k``."""
    b = ParallelWrapper.Builder(net).workers(n, devices=[CPU] * n) \
        .averaging_frequency(k)
    if "compression" in kw:
        b = b.gradient_compression(kw["compression"])
    return b.build()


# =================================================== mirrors of the oracle
class TestParameterServer:
    def test_inmemory_push_pull(self):
        from deeplearning4j_tpu_torch.parallel import InMemoryParameterServer
        srv = InMemoryParameterServer(np.zeros(4), alpha=0.5)
        srv.push(np.ones(4))
        np.testing.assert_allclose(srv.pull(), 0.5 * np.ones(4))
        srv.push(np.ones(4))
        np.testing.assert_allclose(srv.pull(), 0.75 * np.ones(4))

    def test_tcp_transport(self):
        from deeplearning4j_tpu_torch.parallel import (ParameterServerClient,
                                                       ParameterServerNode)
        node = ParameterServerNode(np.zeros(8), alpha=1.0)
        try:
            clients = [ParameterServerClient(node.host, node.port)
                       for _ in range(3)]
            threads = [threading.Thread(
                target=lambda c=c, i=i: c.push_ndarray(np.full(8, float(i))))
                for i, c in enumerate(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10)
                assert not t.is_alive()
            got = clients[0].get_ndarray()
            assert got.shape == (8,)
            # pushes are fire-and-forget: poll until the server drains them
            deadline = time.time() + 5.0
            while node.store.pushes < 3 and time.time() < deadline:
                time.sleep(0.02)
            assert node.store.pushes == 3
            for c in clients:
                c.close()
        finally:
            node.shutdown()

    def test_async_training_learns(self, rng_np):
        """The loss over the batches falls by at least 5% (it falls by
        ~11% in every run). The oracle compares accuracy, but from the
        port's initial weights accuracy sits at the majority class's
        0.367 and moves by an example or two either way with the workers'
        interleaving, which a loaded host changes."""
        from deeplearning4j_tpu_torch.parallel import \
            ParameterServerParallelWrapper
        net = _net()
        batches = _batches(rng_np, n=24)
        loss = lambda: float(np.mean([net.score(d) for d in batches]))
        before = loss()
        pw = ParameterServerParallelWrapper(net, num_workers=2,
                                            push_frequency=2)
        pw.fit(batches, num_epochs=3)
        assert loss() < 0.95 * before
        assert pw.server.pushes == 3 * 24 // 2

    def test_push_updates_server(self, rng_np):
        from deeplearning4j_tpu_torch.parallel import (
            InMemoryParameterServer, ParameterServerTrainer)
        net = _net()
        srv = InMemoryParameterServer(net.params_flat(), num_workers=1)
        replica = net.clone()
        tr = ParameterServerTrainer(replica, srv, push_frequency=1)
        tr.feed_dataset(_batches(rng_np, n=1)[0])
        assert srv.pushes == 1
        # the replica pulled the aggregate back
        np.testing.assert_allclose(replica.params_flat(), srv.pull(),
                                   rtol=1e-6)


class TestClusterTraining:
    def test_param_averaging_master_learns(self, rng_np):
        from deeplearning4j_tpu_torch.cluster import (
            ClusterDl4jMultiLayer, DistributedDataSet,
            ParameterAveragingTrainingMaster)
        net = _net()
        batches = _batches(rng_np, n=16)
        rdd = DistributedDataSet.from_datasets(batches, num_partitions=4,
                                               num_executors=4)
        master = ParameterAveragingTrainingMaster(
            averaging_frequency=2, collect_training_stats=True)
        cluster_net = ClusterDl4jMultiLayer(net, master)
        before = _fit_score(net, batches)
        cluster_net.fit(rdd, num_epochs=3)
        after = _fit_score(net, batches)
        assert after > before
        stats = master.get_training_stats()
        keys = stats.get_keys()
        assert "map_partitions" in keys and "fit" in keys
        assert stats.summary()["fit"]["count"] > 0

    def test_cluster_evaluate_and_score(self, rng_np):
        from deeplearning4j_tpu_torch.cluster import (
            ClusterDl4jMultiLayer, DistributedDataSet,
            ParameterAveragingTrainingMaster)
        net = _net()
        rdd = DistributedDataSet.from_datasets(_batches(rng_np, n=8),
                                               num_partitions=3)
        cnet = ClusterDl4jMultiLayer(net, ParameterAveragingTrainingMaster())
        ev = cnet.evaluate(rdd)
        assert 0.0 <= ev.accuracy() <= 1.0
        scores = cnet.score_examples(rdd)
        assert len(scores) == 8 and all(np.isfinite(s) for s in scores)

    def test_task_retry_recomputes(self):
        from deeplearning4j_tpu_torch.cluster import DistributedDataSet
        rdd = DistributedDataSet.from_datasets(list(range(12)),
                                               num_partitions=3,
                                               max_task_retries=2)
        failures = {"n": 0}

        def injector(idx, attempt):
            if idx == 1 and attempt == 0:
                failures["n"] += 1
                raise RuntimeError("simulated lost task")

        res = rdd.map_partitions(sum, fault_injector=injector)
        assert failures["n"] == 1
        assert sum(res) == sum(range(12))

    def test_task_retry_exhausted_fails(self):
        from deeplearning4j_tpu_torch.cluster import DistributedDataSet
        rdd = DistributedDataSet.from_datasets(list(range(4)),
                                               num_partitions=2,
                                               max_task_retries=1)

        def always_fail(idx, attempt):
            if idx == 0:
                raise RuntimeError("permanent failure")

        with pytest.raises(RuntimeError, match="failed after"):
            rdd.map_partitions(sum, fault_injector=always_fail)

    def test_single_batch_not_diluted_by_empty_partitions(self, rng_np):
        """1 batch + 4 executors: empty partitions must NOT average in
        unfitted replicas (the update would shrink 4x)."""
        from deeplearning4j_tpu_torch.cluster import (
            ClusterDl4jMultiLayer, DistributedDataSet,
            ParameterAveragingTrainingMaster)
        ds = _batches(rng_np, n=1)[0]
        serial = _net(seed=7)
        p0 = serial.params_flat()
        serial.fit([ds])
        serial_delta = serial.params_flat() - p0
        clustered = _net(seed=7)
        rdd = DistributedDataSet.from_datasets([ds], num_partitions=1,
                                               num_executors=4)
        ClusterDl4jMultiLayer(
            clustered, ParameterAveragingTrainingMaster()).fit(rdd)
        np.testing.assert_allclose(clustered.params_flat() - p0,
                                   serial_delta, rtol=1e-5, atol=1e-7)

    def test_averaging_frequency_counts_batches_per_worker(self, rng_np):
        """averaging_frequency=k means k minibatches per worker between
        averages: 16 batches / (4 workers * 2) = 2 averaging rounds."""
        from deeplearning4j_tpu_torch.cluster import (
            ClusterDl4jMultiLayer, DistributedDataSet,
            ParameterAveragingTrainingMaster)
        net = _net()
        rdd = DistributedDataSet.from_datasets(_batches(rng_np, n=16),
                                               num_partitions=4,
                                               num_executors=4)
        master = ParameterAveragingTrainingMaster(averaging_frequency=2,
                                                  num_workers=4)
        ClusterDl4jMultiLayer(net, master).fit(rdd)
        assert net.iteration == 2      # one increment per averaging round

    def test_rebatch_and_max_batches(self, rng_np):
        from deeplearning4j_tpu_torch.cluster import (
            ClusterDl4jMultiLayer, DistributedDataSet,
            ParameterAveragingTrainingMaster)
        net = _net()
        rdd = DistributedDataSet.from_datasets(_batches(rng_np, n=4, b=16),
                                               num_partitions=2)
        master = ParameterAveragingTrainingMaster(batch_size_per_worker=8)
        rebatched = master._rebatch(rdd, 8)
        assert rebatched.count() == 8           # 64 examples / 8
        assert all(d.features.shape[0] == 8
                   for p in rebatched.partitions for d in p)
        master.worker_conf.max_batches_per_worker = 1
        p0 = net.params_flat()
        ClusterDl4jMultiLayer(net, master).fit(rdd)
        assert np.isfinite(net.params_flat()).all()
        assert not np.array_equal(net.params_flat(), p0)

    def test_export_approach(self, rng_np, tmp_path):
        from deeplearning4j_tpu_torch.cluster import (
            ClusterDl4jMultiLayer, DistributedDataSet,
            ParameterAveragingTrainingMaster, RDDTrainingApproach)
        net = _net()
        rdd = DistributedDataSet.from_datasets(_batches(rng_np, n=6),
                                               num_partitions=2)
        master = ParameterAveragingTrainingMaster(
            rdd_training_approach=RDDTrainingApproach.EXPORT,
            export_directory=str(tmp_path))
        ClusterDl4jMultiLayer(net, master).fit(rdd)
        assert list(tmp_path.glob("dataset_*.bin"))

    def test_stats_export(self, rng_np, tmp_path):
        from deeplearning4j_tpu_torch.cluster import (
            ClusterDl4jMultiLayer, DistributedDataSet,
            ParameterAveragingTrainingMaster)
        net = _net()
        rdd = DistributedDataSet.from_datasets(_batches(rng_np, n=4))
        master = ParameterAveragingTrainingMaster(collect_training_stats=True)
        ClusterDl4jMultiLayer(net, master).fit(rdd)
        stats = master.get_training_stats()
        stats.export_json(tmp_path / "stats.json")
        stats.export_html(tmp_path / "stats.html")
        assert (tmp_path / "stats.json").stat().st_size > 0
        assert b"timeline" in (tmp_path / "stats.html").read_bytes()


class TestEarlyStoppingParallel:
    def test_stops_and_returns_best(self, rng_np):
        from deeplearning4j_tpu_torch.earlystopping import (
            DataSetLossCalculator, EarlyStoppingConfiguration,
            InMemoryModelSaver, MaxEpochsTerminationCondition)
        from deeplearning4j_tpu_torch.parallel import \
            EarlyStoppingParallelTrainer
        net = _net()
        batches = _batches(rng_np, n=8)
        cfg = EarlyStoppingConfiguration(
            score_calculator=DataSetLossCalculator(batches),
            model_saver=InMemoryModelSaver(),
            epoch_terminations=[MaxEpochsTerminationCondition(3)])
        trainer = EarlyStoppingParallelTrainer(cfg, net, batches,
                                               mesh=_mesh(4))
        result = trainer.fit()
        assert result.total_epochs <= 4
        assert result.best_model is not None
        assert np.isfinite(result.best_model_score)


class TestMagicQueue:
    def test_round_robin_and_broadcast(self, rng_np):
        from deeplearning4j_tpu_torch.parallel import MagicQueue
        ds = _batches(rng_np, n=1)[0]
        q = MagicQueue(num_devices=4, devices=[CPU])
        for _ in range(8):
            q.add(ds)
        assert [q.size(i) for i in range(4)] == [2, 2, 2, 2]
        got = q.poll(0, timeout=1.0)
        assert got is not None and got.features.shape == ds.features.shape
        assert torch.is_tensor(got.features) and \
            got.features.device.type == "cpu"
        assert q.poll(0) is not None and q.poll(0) is None
        qb = MagicQueue(num_devices=4, mode="broadcast", devices=[CPU])
        qb.add(ds)
        assert [qb.size(i) for i in range(4)] == [1, 1, 1, 1]


class TestParallelWrapperMainCLI:
    def test_end_to_end(self, rng_np, tmp_path):
        from deeplearning4j_tpu_torch.parallel.main import main
        net = _net()
        model_path = tmp_path / "model.zip"
        out_path = tmp_path / "trained.zip"
        ModelSerializer.write_model(net, model_path)
        mod = sys.modules.setdefault("_torch_cli_test_factory",
                                     type(sys)("_torch_cli_test_factory"))
        rng = np.random.default_rng(3)

        def make_iterator():
            from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
            return ListDataSetIterator(_batches(rng, n=4))

        mod.make_iterator = make_iterator
        rc = main(["--model-path", str(model_path),
                   "--iterator-factory",
                   "_torch_cli_test_factory:make_iterator",
                   "--workers", "2", "--epochs", "1", "--device", "cpu",
                   "--output-path", str(out_path)])
        assert rc == 0 and out_path.exists()
        restored = ModelSerializer.restore_multi_layer_network(
            out_path, device="cpu")
        assert restored.num_params() == net.num_params()
        assert restored.iteration == 4
        assert not np.array_equal(restored.params_flat(), net.params_flat())


class TestNativeParameterServer:
    """The C++ store (csrc/param_server.cpp) against the Python one: the
    same aggregation, GIL-free pushes, the raw-f32 TCP protocol."""

    def test_aggregation_matches_python_store(self):
        from deeplearning4j_tpu_torch.parallel import InMemoryParameterServer
        from deeplearning4j_tpu_torch.parallel.native_ps import (
            NativeParameterServer, native_available)
        if not native_available():
            pytest.skip("no C++ toolchain")
        init = np.zeros(64, np.float32)
        nat = NativeParameterServer(init, alpha=0.25)
        py = InMemoryParameterServer(init, alpha=0.25)
        rng = np.random.default_rng(3)
        for _ in range(5):
            v = rng.normal(size=64).astype(np.float32)
            nat.push(v)
            py.push(v)
        np.testing.assert_allclose(nat.pull(), py.pull(), rtol=1e-6)
        assert nat.pushes == py.pushes == 5
        nat.shutdown()

    def test_tcp_roundtrip_and_concurrent_pushes(self):
        from deeplearning4j_tpu_torch.parallel.native_ps import (
            NativeParameterServer, NativeParameterServerClient,
            native_available)
        if not native_available():
            pytest.skip("no C++ toolchain")
        srv = NativeParameterServer(np.zeros(512, np.float32), alpha=0.5,
                                    serve=True)
        errors = []
        try:
            def worker(val):
                try:
                    cli = NativeParameterServerClient(srv.host, srv.port)
                    for _ in range(3):
                        cli.push_ndarray(np.full(512, val, np.float32))
                    assert cli.get_ndarray().shape == (512,)
                    cli.close()
                except BaseException as e:   # surfaced below
                    errors.append(e)
            ts = [threading.Thread(target=worker, args=(float(i + 1),))
                  for i in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=10)
                assert not t.is_alive()
            assert not errors, errors
            assert srv.pushes == 12
            assert 0.0 < float(srv.pull().mean()) <= 4.0
        finally:
            srv.shutdown()

    def test_wrapper_uses_native_backend(self, rng_np):
        from deeplearning4j_tpu_torch.parallel import \
            ParameterServerParallelWrapper
        from deeplearning4j_tpu_torch.parallel.native_ps import (
            NativeParameterServer, native_available)
        if not native_available():
            pytest.skip("no C++ toolchain")
        net = _net()
        pw = ParameterServerParallelWrapper(net, num_workers=2,
                                            backend="native")
        assert isinstance(pw.server, NativeParameterServer)
        assert pw.backend == "native"
        pw.fit(_batches(rng_np, n=8), num_epochs=1)
        assert pw.server.pushes >= 8


def _rnn_net(seed=13):
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .learning_rate(0.05).updater("sgd").weight_init("xavier")
            .list()
            .layer(LSTM(n_out=6, activation="tanh"))
            .layer(RnnOutputLayer(n_out=2, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(InputType.recurrent(3)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _rnn_batches(rng, n_batches, b=8, t=6, masked=True):
    out = []
    for _ in range(n_batches):
        X = rng.normal(size=(b, t, 3)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (b, t))]
        if masked:
            mask = np.ones((b, t), np.float32)
            mask[: b // 2, t // 2:] = 0.0      # half the rows are short
            out.append(DataSet(X, y, features_mask=mask,
                               labels_mask=mask.copy()))
        else:
            out.append(DataSet(X, y))
    return out


class TestLocalStepsMaskedDP:
    """averaging_frequency > 1 with mask arrays (any DataSet, padded
    variable-length RNN batches included)."""

    def test_masked_rnn_trains_with_averaging(self, rng_np):
        net = _rnn_net()
        pw = _pw(net, 4, k=2)
        batches = _rnn_batches(rng_np, 4)
        s0 = net.score(batches[0])
        for _ in range(8):
            pw.fit(batches)
        assert np.isfinite(float(net.score_value))
        assert net.score(batches[0]) < s0

    def test_all_ones_mask_matches_unmasked(self, rng_np):
        """An all-ones mask must train identically to no mask at all."""
        plain = _rnn_batches(rng_np, 2, masked=False)
        ones = [DataSet(np.asarray(d.features), np.asarray(d.labels),
                        features_mask=np.ones(d.features.shape[:2],
                                              np.float32),
                        labels_mask=np.ones(d.labels.shape[:2], np.float32))
                for d in plain]
        net_a, net_b = _rnn_net(seed=5), _rnn_net(seed=5)
        _pw(net_a, 4, k=2).fit(plain)
        _pw(net_b, 4, k=2).fit(ones)
        np.testing.assert_allclose(net_a.params_flat(), net_b.params_flat(),
                                   rtol=1e-6, atol=1e-7)


class TestEncodedGradientSharing:
    """Threshold-encoded delta sharing with error feedback
    (parallel/compression.py)."""

    def test_encode_is_lossless_bookkeeping(self, rng_np):
        v = torch.from_numpy(rng_np.normal(0, 0.01, (1000,))
                             .astype(np.float32))
        enc, new_r = threshold_encode(v, torch.zeros_like(v), 0.02)
        np.testing.assert_allclose((enc + new_r).numpy(), v.numpy(),
                                   rtol=1e-6)
        nz = enc.abs().numpy()
        nz = nz[nz > 0]
        assert nz.size and np.allclose(nz, 0.02)   # every sent element = ±t
        assert float(sent_fraction(enc)) < 0.5     # most elements held back

    def test_error_feedback_accumulates_small_updates(self, rng_np):
        """A threshold above one round's deltas may send nothing at first,
        but the residual carries and accumulates past it, and the
        parameters still move, in multiples of threshold / replicas."""
        net = _net(seed=11, lr=0.05)
        p0 = net.params_flat().copy()
        pw = _pw(net, 4, k=2, compression=0.05)
        batches = _batches(rng_np, 4)
        for _ in range(20):
            pw.fit(batches)
        moved = np.abs(net.params_flat() - p0).max()
        quantum = 0.05 / 4
        assert moved >= quantum - 1e-6
        deltas = (net.params_flat() - p0) / quantum
        np.testing.assert_allclose(deltas, np.round(deltas), atol=1e-3)

    def test_compressed_training_converges(self, rng_np):
        net = _net(seed=3, lr=0.2)
        pw = _pw(net, 4, k=2, compression=1e-3)
        batches = _batches(rng_np, 4)
        s0 = net.score(batches[0])
        for _ in range(15):
            pw.fit(batches)
        assert net.score(batches[0]) < s0
        frac = float(pw.last_sent_fraction)
        assert 0.0 < frac < 1.0        # genuinely sparse sharing happened


class TestRaggedBatchPadding:
    """A batch that does not divide evenly across the shards trains
    IDENTICALLY to the single-device run: padded rows carry zero loss
    weight."""

    def test_sync_dp_matches_single_device_exactly(self, rng_np):
        X = rng_np.normal(size=(10, 4)).astype(np.float32)   # 10 % 4 != 0
        y = np.eye(3, dtype=np.float32)[rng_np.integers(0, 3, 10)]
        ds = DataSet(X, y)
        solo = _net(seed=21)
        solo.fit([ds])
        dp = _net(seed=21)
        _pw(dp, 4).fit([ds])
        np.testing.assert_allclose(dp.params_flat(), solo.params_flat(),
                                   rtol=1e-5, atol=1e-7)

    def test_sync_dp_rnn_ragged_matches_single_device(self, rng_np):
        X = rng_np.normal(size=(6, 5, 3)).astype(np.float32)  # 6 % 4 != 0
        y = np.eye(2, dtype=np.float32)[rng_np.integers(0, 2, (6, 5))]
        mask = np.ones((6, 5), np.float32)
        mask[:3, 3:] = 0.0
        ds = DataSet(X, y, features_mask=mask, labels_mask=mask.copy())
        solo = _rnn_net(seed=31)
        solo.fit([ds])
        dp = _rnn_net(seed=31)
        _pw(dp, 4).fit([ds])
        np.testing.assert_allclose(dp.params_flat(), solo.params_flat(),
                                   rtol=1e-5, atol=1e-6)

    def test_local_steps_autopad_equals_explicit_zero_weight_pad(self,
                                                                 rng_np):
        """Local steps: auto-padding a 10-row batch equals padding it by
        hand to 12 rows with an explicit zero labels mask."""
        X = rng_np.normal(size=(10, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng_np.integers(0, 3, 10)]
        idx = np.concatenate([np.arange(10), np.arange(2)])
        lmask = np.concatenate([np.ones(10), np.zeros(2)]).astype(np.float32)
        auto, manual = _net(seed=41), _net(seed=41)
        _pw(auto, 4, k=2).fit([DataSet(X, y)] * 2)
        _pw(manual, 4, k=2).fit([DataSet(X[idx], y[idx],
                                         labels_mask=lmask)] * 2)
        np.testing.assert_allclose(auto.params_flat(), manual.params_flat(),
                                   rtol=1e-6, atol=1e-7)

    def test_graph_trainer_ragged_matches_single_device(self, rng_np):
        X = rng_np.normal(size=(10, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng_np.integers(0, 3, 10)]
        ds = DataSet(X, y)
        solo = _graph()
        solo.fit_batch(ds)
        dp_net = _graph()
        GraphDataParallelTrainer(dp_net, mesh=_mesh(8)).fit_batch(ds)
        np.testing.assert_allclose(dp_net.params_flat(), solo.params_flat(),
                                   rtol=1e-5, atol=1e-7)

    def test_per_example_mask_count_semantics(self, rng_np):
        """compute_loss: a [N] zero/one mask counts present examples in the
        denominator, so zero-weight padded rows are exactly neutral."""
        from deeplearning4j_tpu_torch.ops.losses import compute_loss
        labels = np.eye(3, dtype=np.float32)[rng_np.integers(0, 3, 5)]
        pre = rng_np.normal(size=(5, 3)).astype(np.float32)
        t = torch.from_numpy
        base = float(compute_loss("mcxent", t(labels), t(pre), "softmax"))
        labels_p = np.concatenate([labels, labels[:3]])
        pre_p = np.concatenate([pre, pre[:3]])
        mask = np.concatenate([np.ones(5), np.zeros(3)]).astype(np.float32)
        padded = float(compute_loss("mcxent", t(labels_p), t(pre_p),
                                    "softmax", t(mask)))
        np.testing.assert_allclose(padded, base, rtol=1e-6)


class TestCompressionSteadyState:
    """With the threshold near the per-round delta magnitude, the
    steady-state sent fraction reaches the few-percent regime; smaller
    thresholds send more."""

    @staticmethod
    def _task(rng):
        conf = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
                .updater("sgd").weight_init("xavier").activation("tanh")
                .list()
                .layer(DenseLayer(n_out=32))
                .layer(OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
                .set_input_type(InputType.feed_forward(8)).build())
        net = MultiLayerNetwork(conf, device="cpu").init()
        X = rng.normal(size=(128, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[
            (np.abs(X).sum(1) * 3).astype(int) % 3]
        return net, [DataSet(X[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16])
                     for i in range(8)]

    def _steady_fraction(self, rng, threshold, epochs=40):
        net, batches = self._task(rng)
        pw = _pw(net, 8, k=4, compression=threshold)
        fr = []
        s0 = net.score(batches[0])
        for _ in range(epochs):
            pw.fit(batches)
            fr.append(float(pw.last_sent_fraction))
        return np.mean(fr[-8:]), s0, net.score(batches[0])

    def test_steady_state_reaches_sparse_regime(self, rng_np):
        frac, s0, s1 = self._steady_fraction(rng_np, 3e-1)
        assert frac < 0.06, frac          # ~97% zeros on the wire
        assert s1 < s0                    # and training still converges

    def test_fraction_decreases_with_threshold(self):
        f_small, _, _ = self._steady_fraction(
            np.random.default_rng(9), 3e-3, epochs=20)
        f_big, _, _ = self._steady_fraction(
            np.random.default_rng(9), 1e-1, epochs=20)
        assert f_big < f_small


# ============================================ the port against the JAX package
def _graph(seed=17):
    g = (NeuralNetConfiguration.Builder().seed(seed).learning_rate(0.1)
         .updater("sgd").weight_init("xavier").activation("tanh")
         .graph_builder()
         .add_inputs("in")
         .add_layer("d", DenseLayer(n_out=6), "in")
         .add_layer("out", OutputLayer(n_out=3, loss="mcxent",
                                       activation="softmax"), "d")
         .set_outputs("out")
         .set_input_types(InputType.feed_forward(4)).build())
    return ComputationGraph(g, device="cpu").init()


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_mlp(seed=21, lr=0.1, updater="sgd"):
    conf = (JaxNNC.Builder().seed(seed).learning_rate(lr).updater(updater)
            .weight_init("xavier").activation("tanh").list()
            .layer(jl.DenseLayer(n_out=8))
            .layer(jl.OutputLayer(n_out=3, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _jax_lstm(seed=13):
    conf = (JaxNNC.Builder().seed(seed).learning_rate(0.05).updater("sgd")
            .weight_init("xavier").list()
            .layer(jl.LSTM(n_out=6, activation="tanh"))
            .layer(jl.RnnOutputLayer(n_out=2, loss="mcxent",
                                     activation="softmax"))
            .set_input_type(JaxInputType.recurrent(3)).build())
    return JaxMLN(conf).init()


def _port_mln(jnet):
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    return network_from_numpy(conf, [_np_tree(p) for p in jnet.params],
                              device="cpu")


def _port_graph(jg):
    conf = ComputationGraphConfiguration.from_json(jg.conf.to_json())
    return graph_from_numpy(conf, {v: _np_tree(p)
                                   for v, p in jg.params.items()},
                            device="cpu")


def _jds(ds):
    return JaxDataSet(ds.features, ds.labels, ds.features_mask,
                      ds.labels_mask)


def _close(tnet, jnet, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(tnet.params_flat(),
                               np.asarray(jnet.params_flat()),
                               rtol=rtol, atol=atol)


def _xy(rng, n, c=3, f=4):
    X = rng.normal(size=(n, f)).astype(np.float32)
    return X, np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]


@pytest.mark.parametrize("rows", [10, 3], ids=["ragged", "fewer_than_shards"])
def test_sync_dp_mlp_matches_jax(rows):
    """Sync DP over 4 shards: 10 rows (padded to 12) and 3 rows (one shard
    all padding, whose count 0 adds exactly nothing); two steps."""
    rng = np.random.default_rng(rows)
    batches = [DataSet(*_xy(rng, rows)) for _ in range(2)]
    jnet = _jax_mlp()
    tnet = _port_mln(jnet)
    jpw = JaxParallelWrapper.Builder(jnet).mesh(jax_mesh(4)).build()
    tpw = _pw(tnet, 4)
    for ds in batches:
        jpw.fit([_jds(ds)])
        tpw.fit([ds])
        np.testing.assert_allclose(float(tnet.score_value),
                                   float(jnet.score_value), rtol=1e-5)
    _close(tnet, jnet)
    assert tnet.iteration == jnet.iteration == 2


def test_graph_dp_ragged_matches_jax():
    rng = np.random.default_rng(5)
    ds = DataSet(*_xy(rng, 10))
    jg = JaxGraph(JaxCGC.from_json(_graph().conf.to_json())).init()
    tg = _port_graph(jg)
    JaxGraphDP(jg, mesh=jax_mesh(4)).fit_batch(_jds(ds))
    GraphDataParallelTrainer(tg, mesh=_mesh(4)).fit_batch(ds)
    np.testing.assert_allclose(float(tg.score_value), float(jg.score_value),
                               rtol=1e-5)
    _close(tg, jg)


def _two_head_conf_json():
    """in (recurrent 3) -> LSTM 5 -> two softmax heads, o1 (2 classes)
    and o2 (3 classes)."""
    return (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").graph_builder()
            .add_inputs("in")
            .add_layer("l", LSTM(n_out=5, activation="tanh"), "in")
            .add_layer("o1", RnnOutputLayer(n_out=2, loss="mcxent",
                                            activation="softmax"), "l")
            .add_layer("o2", RnnOutputLayer(n_out=3, loss="mcxent",
                                            activation="softmax"), "l")
            .set_outputs("o1", "o2")
            .set_input_types(InputType.recurrent(3)).build().to_json())


def test_two_outputs_with_different_label_masks_match_jax_and_solo():
    """Each output divides by its own global count: o1's mask keeps 20 of
    30 cells, o2's 11; 6 rows over 4 shards (padded to 8)."""
    rng = np.random.default_rng(11)
    n, t = 6, 5
    X = rng.normal(size=(n, t, 3)).astype(np.float32)
    y1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (n, t))]
    y2 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, t))]
    m1 = (np.arange(t)[None] < np.array([5, 5, 4, 3, 2, 1])[:, None]) \
        .astype(np.float32)
    m2 = (np.arange(t)[None] < np.array([1, 2, 3, 0, 5, 0])[:, None]) \
        .astype(np.float32)
    conf_json = _two_head_conf_json()
    jg = JaxGraph(JaxCGC.from_json(conf_json)).init()
    tg, solo = _port_graph(jg), _port_graph(jg)
    mds = MultiDataSet([X], [y1, y2], None, [m1, m2])
    JaxGraphDP(jg, mesh=jax_mesh(4)).fit_batch(
        JaxMultiDataSet([X], [y1, y2], None, [m1, m2]))
    GraphDataParallelTrainer(tg, mesh=_mesh(4)).fit_batch(mds)
    solo.fit_batch(mds)
    np.testing.assert_allclose(float(tg.score_value), float(jg.score_value),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tg.score_value),
                               float(solo.score_value), rtol=1e-6)
    _close(tg, jg, atol=1e-6)
    np.testing.assert_allclose(tg.params_flat(), solo.params_flat(),
                               rtol=1e-5, atol=1e-7)


def test_transformer_lm_sync_dp_matches_jax():
    """A 2-layer LM (vocab 64, d 32, 2 heads, T 16, B 4, adam, f32) under
    sync DP at data 2, two steps: each step's loss to rtol 1e-5 and the
    parameters to atol 1e-5."""
    kw = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
              max_length=16, drop_out=0.0, learning_rate=3e-4)
    jg = JaxGraph(jax_lm_conf(**kw)).init()
    tg = graph_from_numpy(transformer_lm_conf(**kw),
                          {v: _np_tree(p) for v, p in jg.params.items()},
                          device="cpu")
    jtr = JaxGraphDP(jg, mesh=jax_mesh(2))
    ttr = GraphDataParallelTrainer(tg, mesh=_mesh(2))
    for seed in (0, 1):
        x, y = lm_batch_sparse(np.random.default_rng(seed).integers(
            0, 64, (4, 17)))
        jtr.fit_batch(JaxDataSet(x, y))
        ttr.fit_batch(DataSet(x, y))
        np.testing.assert_allclose(float(tg.score_value),
                                   float(jg.score_value), rtol=1e-5)
    for v, p in jg.params.items():
        for k, a in p.items():
            np.testing.assert_allclose(tg.params[v][k].numpy(),
                                       np.asarray(a), rtol=0, atol=1e-5,
                                       err_msg=f"{v}.{k}")


def test_local_steps_masked_lstm_matches_jax():
    rng = np.random.default_rng(2)
    batches = _rnn_batches(rng, 4)
    jnet = _jax_lstm()
    tnet = _port_mln(jnet)
    JaxParallelWrapper.Builder(jnet).mesh(jax_mesh(4)) \
        .averaging_frequency(2).build().fit([_jds(d) for d in batches])
    _pw(tnet, 4, k=2).fit(batches)
    np.testing.assert_allclose(float(tnet.score_value),
                               float(jnet.score_value), rtol=1e-5)
    _close(tnet, jnet, atol=1e-6)
    assert tnet.iteration == jnet.iteration == 4


def test_compressed_local_steps_match_jax():
    """k 2 over 4 shards with threshold 1e-3, two fits (4 rounds): the
    parameters and the last round's sent fraction."""
    rng = np.random.default_rng(4)
    batches = [DataSet(*_xy(rng, 16)) for _ in range(4)]
    jnet = _jax_mlp(seed=3, lr=0.2)
    tnet = _port_mln(jnet)
    jpw = JaxParallelWrapper.Builder(jnet).mesh(jax_mesh(4)) \
        .averaging_frequency(2).gradient_compression(1e-3).build()
    tpw = _pw(tnet, 4, k=2, compression=1e-3)
    for _ in range(2):
        jpw.fit([_jds(d) for d in batches])
        tpw.fit(batches)
    _close(tnet, jnet)
    np.testing.assert_allclose(float(tpw.last_sent_fraction),
                               float(jpw.last_sent_fraction), rtol=1e-6)


def test_threshold_encode_sequence_matches_jax():
    rng = np.random.default_rng(8)
    jr = np.zeros(256, np.float32)
    tr = torch.zeros(256)
    for _ in range(6):
        v = rng.normal(0, 0.02, 256).astype(np.float32)
        jenc, jr = jcomp.threshold_encode(v, jr, 0.03)
        tenc, tr = threshold_encode(torch.from_numpy(v), tr, 0.03)
        np.testing.assert_array_equal(tenc.numpy(), np.asarray(jenc))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert float(sent_fraction(tenc)) == \
            float(jcomp.sent_fraction(jenc))


# ================================================================= A9b-bn
def _bn_net():
    conf = (NeuralNetConfiguration.Builder().seed(1).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").activation("tanh").list()
            .layer(DenseLayer(n_out=8))
            .layer(BatchNormalization())
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def test_sync_dp_refuses_batch_norm_over_data_shards():
    """Named for the refusal it held until the vertex-synchronous walk
    (ROADMAP A9b-bn): sync DP over data shards now trains a batch-norm
    net, by the whole batch's statistics, as one solo step does; one data
    shard and local steps (a replica per shard) train it as before."""
    ds = DataSet(*_xy(np.random.default_rng(0), 8))
    solo, dp = _bn_net(), _bn_net()
    solo._fit_batch(ds)
    _pw(dp, 2).fit([ds])
    _close(dp, solo, atol=1e-6)
    one = _bn_net()
    _pw(one, 1).fit([ds])
    assert one.iteration == 1
    local = _bn_net()
    _pw(local, 2, k=2).fit([ds, ds])
    assert local.iteration == 2 and np.isfinite(float(local.score_value))


def test_one_shard_sync_dp_computes_no_vertex_across_shards():
    """One data shard takes no cross-shard point: its own forward (on a
    card the single-shard kernels) sees the whole batch, and trains as
    the solo step does. Two shards take the batch norm and the center
    loss across them."""
    from deeplearning4j_tpu_torch.parallel.sharded import (ShardPlan,
                                                           cross_points)
    net = _port_mln(_jax_bn_mlp(center=True))
    cpu = torch.device("cpu")
    assert cross_points(net, ShardPlan([cpu])) == set()
    assert cross_points(net, ShardPlan([cpu, cpu])) == {1, "center"}
    ds = DataSet(*_xy(np.random.default_rng(2), 8))
    solo, one = _port_mln(_jax_bn_mlp(center=True)), net
    solo._fit_batch(ds)
    _pw(one, 1).fit([ds])
    _close(one, solo, atol=1e-6)
    np.testing.assert_allclose(one.state[3]["centers"].numpy(),
                               solo.state[3]["centers"].numpy(),
                               rtol=1e-5, atol=1e-6)


def _jax_bn_mlp(center=False):
    head = jl.CenterLossOutputLayer(n_out=3, loss="mcxent",
                                    activation="softmax", alpha=0.3,
                                    lambda_=0.5) if center else \
        jl.OutputLayer(n_out=3, loss="mcxent", activation="softmax")
    conf = (JaxNNC.Builder().seed(4).learning_rate(0.1).updater("sgd")
            .weight_init("xavier").activation("tanh").list()
            .layer(jl.DenseLayer(n_out=8))
            .layer(jl.BatchNormalization())
            .layer(jl.DenseLayer(n_out=6))
            .layer(head)
            .set_input_type(JaxInputType.feed_forward(4)).build())
    return JaxMLN(conf).init()


def _close_state(tnet, jnet):
    for i, (ts, js) in enumerate(zip(tnet.state, jnet.state)):
        for k, a in js.items():
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(a),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"state {i} {k}")


@pytest.mark.parametrize("rows", [8, 7], ids=["even", "ragged"])
@pytest.mark.parametrize("center", [False, True], ids=["bn", "bn_center"])
def test_sync_dp_batch_norm_matches_jax_and_solo(center, rows):
    """A batch norm (and a center-loss head) under sync DP at data 2, two
    steps: parameters, running statistics and centers against JAX's
    ParallelWrapper on 2 host devices (its GSPMD step takes them over the
    global, padded batch) and, on an even batch, against the port's solo
    step."""
    rng = np.random.default_rng(rows + 10 * center)
    batches = [DataSet(*_xy(rng, rows)) for _ in range(2)]
    jnet = _jax_bn_mlp(center)
    tnet = _port_mln(jnet)
    solo = _port_mln(jnet)
    jpw = JaxParallelWrapper.Builder(jnet).mesh(jax_mesh(2)).build()
    tpw = _pw(tnet, 2)
    jpw.fit([_jds(d) for d in batches])
    tpw.fit(batches)
    _close(tnet, jnet, atol=1e-6)
    _close_state(tnet, jnet)
    np.testing.assert_allclose(float(tnet.score_value),
                               float(jnet.score_value), rtol=1e-5)
    if rows % 2 == 0:
        for ds in batches:
            solo._fit_batch(ds)
        _close(tnet, solo, atol=1e-6)
        for ts, ss in zip(tnet.state, solo.state):
            for k in ss:
                np.testing.assert_allclose(ts[k].numpy(), ss[k].numpy(),
                                           rtol=1e-5, atol=1e-6)


def test_graph_dp_batch_norm_matches_jax_and_solo():
    """GraphDataParallelTrainer at data 2 on a graph with a batch norm
    feeding a residual add and a ReLU (the BN → add → act tail, vertex by
    vertex on the CPU): against JAX's trainer and the solo step."""
    def build(nnc, lay, it, vertex):
        return (nnc.Builder().seed(9).learning_rate(0.1).updater("sgd")
                .weight_init("xavier").activation("tanh").graph_builder()
                .add_inputs("in")
                .add_layer("d", lay.DenseLayer(n_out=6), "in")
                .add_layer("bn", lay.BatchNormalization(), "d")
                .add_vertex("add", vertex(op="add"), "bn", "d")
                .add_layer("act", lay.ActivationLayer(activation="relu"),
                           "add")
                .add_layer("d2", lay.DenseLayer(n_out=6), "act")
                .add_layer("out", lay.OutputLayer(
                    n_out=3, loss="mcxent", activation="softmax"), "d2")
                .set_outputs("out")
                .set_input_types(it.feed_forward(4)).build())
    from deeplearning4j_tpu.nn.graph import ElementWiseVertex
    from deeplearning4j_tpu_torch.nn.conf import layers as tl
    jg = JaxGraph(build(JaxNNC, jl, JaxInputType, ElementWiseVertex)).init()
    tg = _port_graph(jg)
    solo = _port_graph(jg)
    jtr = JaxGraphDP(jg, mesh=jax_mesh(2))
    ttr = GraphDataParallelTrainer(tg, mesh=_mesh(2))
    rng = np.random.default_rng(3)
    for _ in range(2):
        ds = DataSet(*_xy(rng, 8))
        jtr.fit_batch(_jds(ds))
        ttr.fit_batch(ds)
        solo.fit_batch(ds)
    assert isinstance(tg.conf.vertices["bn"].layer, tl.BatchNormalization)
    for v, p in jg.params.items():
        for k, a in p.items():
            np.testing.assert_allclose(tg.params[v][k].numpy(),
                                       np.asarray(a), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{v}.{k}")
            np.testing.assert_allclose(tg.params[v][k].numpy(),
                                       solo.params[v][k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{v}.{k}")
    for k, a in jg.state["bn"].items():
        np.testing.assert_allclose(tg.state["bn"][k].numpy(),
                                   np.asarray(a), rtol=1e-5, atol=1e-6)


def test_graph_dp_batch_norm_f64_equals_solo():
    """resnet_tiny in f64 (9 batch norms, 2 of them feeding a residual add
    and a ReLU) under GraphDataParallelTrainer at data 2: the parameters
    and running statistics equal the solo step's to f64 rounding. In f32
    the one-pass statistics about the running mean (0 at the first step)
    round Σx² to f32, so any other order of the sums moves the update; in
    f64 that is gone and only a wrong statistic would show."""
    from deeplearning4j_tpu_torch.models import resnet_tiny_conf
    solo = ComputationGraph(resnet_tiny_conf(
        num_classes=4, height=16, width=16, channels=3),
        compute_dtype=torch.float64, device="cpu").init()
    dp = solo.clone()
    rng = np.random.default_rng(1)
    ds = DataSet(rng.normal(size=(8, 16, 16, 3)),
                 np.eye(4)[rng.integers(0, 4, 8)])
    solo.fit_batch(ds)
    GraphDataParallelTrainer(dp, mesh=_mesh(2)).fit_batch(ds)
    for tree in ("params", "state"):
        got, want = getattr(dp, tree), getattr(solo, tree)
        for v in want:
            for k in want[v]:
                np.testing.assert_allclose(
                    got[v][k].numpy(), want[v][k].numpy(), rtol=1e-10,
                    atol=1e-12, err_msg=f"{tree} {v}.{k}")


# ============================================================= checkpoints
def test_checkpoint_api_round_trips_with_jax(tmp_path):
    """ModelSerializer with updater state and a normalizer: a port zip
    restores in the JAX package and a JAX zip in the port (and through
    ModelGuesser); save_updater=False writes no updater entry."""
    rng = np.random.default_rng(6)
    X, y = _xy(rng, 16)
    norm = NormalizerStandardize().fit(DataSet(X, y))
    tnet = _net()
    tnet.fit([DataSet(X, y)])
    ModelSerializer.write_model(tnet, tmp_path / "port.zip",
                                normalizer=norm)
    jnet = JaxModelSerializer.restore_multi_layer_network(
        tmp_path / "port.zip")
    np.testing.assert_array_equal(np.asarray(jnet.params_flat()),
                                  tnet.params_flat())
    assert jnet.iteration == 1
    jnorm = JaxModelSerializer.restore_normalizer(tmp_path / "port.zip")
    np.testing.assert_array_equal(jnorm.mean, norm.mean)

    jg = _jax_mlp(updater="adam")
    jg.fit([JaxDataSet(X, y)])
    JaxModelSerializer.write_model(jg, tmp_path / "jax.zip",
                                   normalizer=JaxNormalizer.from_bytes(
                                       norm.to_bytes()))
    back = ModelGuesser.load_model_guess_type(tmp_path / "jax.zip",
                                              device="cpu")
    assert isinstance(back, MultiLayerNetwork) and back.iteration == 1
    np.testing.assert_array_equal(back.params_flat(),
                                  np.asarray(jg.params_flat()))
    np.testing.assert_array_equal(
        back.updater_state[0]["W"]["m"].numpy(),
        np.asarray(jg.updater_state[0]["W"]["m"]))
    restored = ModelSerializer.restore_normalizer(tmp_path / "jax.zip")
    np.testing.assert_array_equal(restored.std, norm.std)
    fresh = ModelSerializer.restore_multi_layer_network(
        tmp_path / "jax.zip", load_updater=False, device="cpu")
    assert not fresh.updater_state[0]["W"]["m"].any()
    ModelSerializer.write_model(tnet, tmp_path / "bare.zip",
                                save_updater=False)
    import zipfile
    with zipfile.ZipFile(tmp_path / "bare.zip") as z:
        assert "updaterState.npz" not in z.namelist()
        assert "normalizer.bin" not in z.namelist()
    assert ModelSerializer.restore_normalizer(tmp_path / "bare.zip") is None
