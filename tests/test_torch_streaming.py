"""PyTorch port: the serving host tier's streaming side against the JAX
package, on the CPU. The in-process broker and the TCP broker (round
trip, the stalled-subscriber disconnect, a small publish / subscribe
storm), ``GenerationServingRoute`` and ``ModelServingRoute`` giving the
JAX routes' outputs on the same weights, ``ParallelInference.output`` /
``generate`` giving JAX's (concurrent callers coalesced into one engine),
the ``mesh=`` raise naming queue A9, and a walk over the port's sources
that finds no JAX import and no import of the JAX package."""

import ast
import pathlib
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import transformer_lm_conf as jax_lm_conf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from deeplearning4j_tpu.observability.tracing import TraceRing as JaxRing
from deeplearning4j_tpu.parallel.inference import \
    ParallelInference as JaxParallelInference
from deeplearning4j_tpu.streaming import pubsub as jpubsub
from deeplearning4j_tpu.streaming.serving import (
    GenerationServingRoute as JaxGenRoute, ModelServingRoute as JaxRoute)
from deeplearning4j_tpu_torch.models import transformer_lm_conf
from deeplearning4j_tpu_torch.observability import (MetricsRegistry,
                                                    TraceRing)
from deeplearning4j_tpu_torch.parallel import (InferenceMode,
                                               ParallelInference)
from deeplearning4j_tpu_torch.streaming import (
    GenerationServingRoute, MessageBroker, ModelServingRoute,
    NDArrayPublisher, NDArrayStreamClient, NDArraySubscriber,
    TcpBrokerServer, TcpMessageBroker, create_broker)
from deeplearning4j_tpu_torch.streaming import pubsub as tpubsub
from deeplearning4j_tpu_torch.utils import graph_from_numpy

VOCAB = 12
KW = dict(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=2,
          max_length=32, seed=5)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _nets(scale):
    """(JAX net, port net on the CPU) on the same parameters, every weight
    matrix scaled by ``scale``."""
    jnet = JaxGraph(jax_lm_conf(**KW)).init()
    jnet.params = {v: {k: a * scale if a.ndim == 2 else a
                       for k, a in p.items()}
                   for v, p in jnet.params.items()}
    net = graph_from_numpy(transformer_lm_conf(**KW),
                           {v: {k: np.asarray(a) for k, a in p.items()}
                            for v, p in jnet.params.items()}, device="cpu")
    return jnet, net


@pytest.fixture(scope="module")
def nets():
    """Weights ×4: greedy tokens depend on the context."""
    return _nets(4)


@pytest.fixture(scope="module")
def init_nets():
    """The nets at init, for f32 outputs held at 1e-5."""
    return _nets(1)


def _prompts(seed, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, int(rng.integers(2, 6))).astype(np.int64)
            for _ in range(n)]


# ----------------------------------------------------------------- brokers
@pytest.mark.parametrize("impl", ["port", "jax"])
def test_memory_broker_round_trip(impl):
    mod = jpubsub if impl == "jax" else None
    client = (mod.NDArrayStreamClient() if mod else NDArrayStreamClient())
    sub = client.subscriber("t1")
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    client.publisher("t1").publish(arr)
    np.testing.assert_array_equal(sub.poll(timeout=1.0), arr)
    assert sub.poll() is None
    sub.close()
    assert type(create_broker("memory://")) is MessageBroker


def test_tcp_broker_round_trip_and_topic_isolation():
    server = TcpBrokerServer().start()
    try:
        a, b = create_broker(server.url), create_broker(server.url)
        sub = NDArrayStreamClient(broker=b).subscriber("t")
        time.sleep(0.1)
        NDArrayStreamClient(broker=a).publisher("t").publish(
            np.arange(6.0).reshape(2, 3))
        np.testing.assert_allclose(sub.poll(timeout=5),
                                   np.arange(6.0).reshape(2, 3))
        NDArrayStreamClient(broker=a).publisher("other").publish(np.ones(3))
        assert sub.poll(timeout=0.2) is None
        a.close()
        b.close()
    finally:
        server.close()


def test_tcp_stalled_subscriber_is_disconnected():
    """A subscriber that never reads fills its bounded outbound queue and
    is disconnected; the healthy subscriber still gets every message."""
    server = TcpBrokerServer(max_queued_frames=4).start()
    stalled = healthy = publisher = None
    try:
        stalled = socket.socket()
        stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        stalled.connect((server.host, server.port))
        stalled.sendall(b"S" + struct.pack(">I", 1) + b"t" +
                        struct.pack(">Q", 0))
        healthy = TcpMessageBroker(server.host, server.port)
        q = healthy.subscribe("t")
        publisher = TcpMessageBroker(server.host, server.port)
        time.sleep(0.2)
        payload = b"x" * 262_144
        for _ in range(24):
            publisher.publish("t", payload)
        for _ in range(24):
            assert q.get(timeout=10) == payload
        deadline = time.monotonic() + 5
        while server.disconnects == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server.disconnects >= 1
    finally:
        for c in (healthy, publisher):
            if c is not None:
                c.close()
        if stalled is not None:
            stalled.close()
        server.close()


def test_tcp_publish_subscribe_storm():
    """4 publishers × 50 messages into one topic, 2 subscribers: each
    gets all 200, each publisher's in its publish order."""
    server = TcpBrokerServer().start()
    clients = []
    try:
        subs = []
        for _ in range(2):
            c = TcpMessageBroker(server.host, server.port)
            clients.append(c)
            subs.append(c.subscribe("storm"))
        time.sleep(0.2)

        def pub(k):
            c = TcpMessageBroker(server.host, server.port)
            clients.append(c)
            for i in range(50):
                c.publish("storm", f"{k}:{i}".encode())

        threads = [threading.Thread(target=pub, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for q in subs:
            got = [q.get(timeout=10).decode() for _ in range(200)]
            for k in range(4):
                mine = [int(m.split(":")[1]) for m in got
                        if m.startswith(f"{k}:")]
                assert mine == list(range(50))
    finally:
        for c in clients:
            c.close()
        server.close()


# ------------------------------------------------------------------ routes
def _serve(route_cls, net, broker_mod, prompts, **kw):
    broker = broker_mod.MessageBroker()
    out = broker_mod.NDArraySubscriber(broker, "dl4j-gen-output")
    route = route_cls(net, broker, max_new_tokens=6, num_slots=2,
                      block_size=4, **kw).start()
    try:
        pub = broker_mod.NDArrayPublisher(broker, "dl4j-gen-input")
        for p in prompts:
            pub.publish(p)
        return [out.poll(timeout=30) for _ in prompts], route
    finally:
        route.stop()
        out.close()


def test_generation_route_matches_jax(nets):
    jnet, net = nets
    prompts = _prompts(0)
    jring = JaxRing()
    want, _ = _serve(JaxGenRoute, jnet, jpubsub, prompts, trace_store=jring)
    ring = TraceRing()
    got, route = _serve(GenerationServingRoute, net, tpubsub, prompts,
                        registry=MetricsRegistry(), trace_store=ring)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert route.served == len(prompts)
    traces = ring.recent()
    assert len(traces) == len(prompts)
    for tr in traces:
        names = tr.span_names()
        assert names.count("consume") == 1 and names[-1] == "publish"
    assert sorted(tr.span_names() for tr in traces) == \
        sorted(tr.span_names() for tr in jring.recent())


def test_model_serving_route_matches_jax(init_nets):
    jnet, net = init_nets
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, VOCAB, (2, 7)).astype(np.float32)
               for _ in range(3)]
    outs = []
    for route_cls, model, mod in ((JaxRoute, jnet, jpubsub),
                                  (ModelServingRoute, net, None)):
        broker = mod.MessageBroker() if mod else MessageBroker()
        sub = (mod.NDArraySubscriber if mod else NDArraySubscriber)(
            broker, "dl4j-output")
        route = route_cls(model, broker).start()
        pub = (mod.NDArrayPublisher if mod else NDArrayPublisher)(
            broker, "dl4j-input")
        for b in batches:
            pub.publish(b)
        outs.append([sub.poll(timeout=30) for _ in batches])
        route.stop()
        sub.close()
    for g, w in zip(outs[1], outs[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_generation_route_mesh_raises_naming_a9(nets):
    # mesh= is served since the port's mesh slice (tests/test_torch_mesh.py
    # drives it); what still raises is a mesh that is not a Mesh
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        GenerationServingRoute(nets[1], MessageBroker(), mesh=object())


# ------------------------------------------------------- ParallelInference
def test_parallel_inference_output_matches_jax(init_nets):
    jnet, net = init_nets
    x = np.random.default_rng(2).integers(0, VOCAB, (5, 7)).astype(
        np.float32)
    want = JaxParallelInference(jnet).output(x)
    pi = ParallelInference(net)
    got = pi.output(x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    seq = ParallelInference(net, inference_mode=InferenceMode.SEQUENTIAL)
    np.testing.assert_allclose(seq.output(x), got, rtol=0, atol=0)
    pi.shutdown()


def test_parallel_inference_generate_coalesces_and_matches_jax(nets):
    jnet, net = nets
    prompts = _prompts(3, 8)
    jpi = JaxParallelInference(jnet, generation_slots=2)
    want = [jpi.generate(p, 6) for p in prompts]
    jpi.shutdown()
    pi = ParallelInference(net, generation_slots=2,
                           generation_registry=MetricsRegistry())
    got = [None] * len(prompts)

    def call(i):
        got[i] = pi.generate(prompts[i], 6, timeout=60)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = pi.generation_stats()
    engines = {id(pi._gen_engine)}
    pi.shutdown()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # every caller went through the one shared engine
    assert len(engines) == 1 and st["completed"] == len(prompts)
    assert st["prefills"] == len(prompts)


def test_parallel_inference_mesh_raises_naming_a9(nets):
    # mesh= and generation_mesh= are served since the port's mesh slice
    # (tests/test_torch_mesh.py); a mesh that is not a Mesh raises, and
    # workers(n) beyond the CUDA devices there are names the fix
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ParallelInference(nets[1], mesh=object())
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ParallelInference(nets[1], generation_mesh=object())
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="only .* device"):
            ParallelInference.Builder(nets[1]).workers(4)


# ------------------------------------------------------------ source walk
def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for new in ("observability/metrics.py", "observability/tracing.py",
                "observability/slo.py", "observability/flightrec.py",
                "observability/profiler.py", "observability/devstats.py",
                "streaming/journal.py", "streaming/pubsub.py",
                "streaming/tcp_broker.py", "streaming/serving.py",
                "streaming/fleet.py", "parallel/preemption.py",
                "parallel/inference.py", "tools/chaos_soak.py",
                "streaming/disagg.py", "streaming/autoscale.py",
                "observability/telemetry.py", "ui/server.py",
                "streaming/remote.py", "nn/transfer.py",
                "nn/gradientcheck.py", "nn/conf/layers/variational.py",
                "earlystopping/core.py", "optimize/solvers.py",
                "datasets/iterators.py", "parallel/mesh.py",
                "parallel/spec_layout.py", "datasets/mnist.py",
                "datasets/fetchers.py", "datasets/datavec.py",
                "datasets/native_loader.py", "keras/hdf5.py",
                "keras/layers.py", "keras/importer.py", "keras/export.py",
                "keras/server.py", "keras/__init__.py",
                "clustering/__init__.py", "clustering/kmeans.py",
                "clustering/tsne.py", "clustering/bhtsne.py",
                "clustering/trees.py", "ui/__init__.py", "ui/stats.py",
                "ui/legacy_listeners.py", "ui/storage.py",
                "ui/components.py", "ui/report.py", "ui/png.py",
                "cluster/ml_pipeline.py", "cluster/sklearn_compat.py",
                "utils/fleet.py", "utils/object_store.py",
                "analysis/__init__.py", "analysis/lint.py",
                "analysis/callgraph.py", "analysis/concurrency.py",
                "analysis/sharding.py", "analysis/lock_audit.py",
                "analysis/compile_audit.py"):
        assert f"deeplearning4j_tpu_torch/{new}" in names
    assert (ROOT / "deeplearning4j_tpu_torch/csrc/dataloader.cpp").exists()
    bad = []
    for p in files:
        for mod in _imports(p):
            top = mod.split(".")[0]
            # h5py: the card's machine has none (keras/hdf5.py reads and
            # writes the files instead)
            if top in ("jax", "jaxlib", "flax", "optax", "h5py") or \
                    top == "deeplearning4j_tpu":
                bad.append((p.relative_to(ROOT).as_posix(), mod))
    assert bad == []
