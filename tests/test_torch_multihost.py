"""PyTorch port, multi-process training on the CPU (mirrors of
``tests/test_multihost.py``): ``host_allreduce_mean``'s write-once tags
over a fake store with TCPStore's ``compare_set`` semantics (the mean over
fake peers, a reused tag with another payload raising and naming the tag,
an idempotent retry passing), and two real processes that import only the
port, joined by a TCPStore on a free localhost port, each training over
its own two-shard CPU mesh with the step's parameters averaged across
processes, process 0 checkpointing, then a restarted pair restoring the
checkpoint and training on. Last, a JAX ``CheckpointManager`` zip
restored by the port's ``restore_latest``, updater state and normalizer
included (bitwise: the zip carries the bytes)."""

import base64
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.ops.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.ops.dataset import \
    NormalizerStandardize as JaxStandardize
from deeplearning4j_tpu.parallel.multihost import \
    CheckpointManager as JaxCheckpointManager
from deeplearning4j_tpu_torch.parallel import multihost
from deeplearning4j_tpu_torch.utils import ModelSerializer

_WORKER = r'''
import sys
import numpy as np
import torch

pid = int(sys.argv[1]); port = sys.argv[2]; ckdir = sys.argv[3]
phase = sys.argv[4]

from deeplearning4j_tpu_torch.parallel import multihost
multihost.initialize(coordinator_address="127.0.0.1:" + port,
                     num_processes=2, process_id=pid, timeout_s=60)
assert multihost.process_count() == 2
assert "jax" not in sys.modules and "deeplearning4j_tpu" not in sys.modules
mesh = multihost.global_mesh(devices=[torch.device("cpu")] * 2)

from deeplearning4j_tpu_torch.nn import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.ops.dataset import DataSet
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.multihost import CheckpointManager

def build():
    conf = (NeuralNetConfiguration.Builder().seed(5).learning_rate(0.1)
            .updater("sgd").weight_init("xavier").activation("tanh").list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()

ck = CheckpointManager(ckdir, interval_seconds=0.0)
if phase == "resume":
    net = ck.restore_latest(device="cpu")
    assert net is not None, "no checkpoint to restore"
    start_iter = net.iteration
    assert start_iter >= 3, start_iter
else:
    net = build()
    start_iter = 0

pw = ParallelWrapper.Builder(net).mesh(mesh).build()
# each process its own rows: the cross-process mean is real averaging
rng = np.random.default_rng(7 + pid)
X = rng.normal(size=(16, 4)).astype(np.float32)
y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
for _ in range(3):
    pw.fit([DataSet(X, y)])
assert np.isfinite(float(net.score_value))
assert net.iteration == start_iter + 3
digest = float(np.abs(net.params_flat()).sum())
saved = ck.maybe_save(net, force=True)
assert saved == (multihost.process_index() == 0)
print("WORKER_OK", pid, phase, net.iteration, repr(digest), flush=True)
'''


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


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_phase(port, ckdir, phase):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), str(port), str(ckdir), phase],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out))
    return outs


def _digests(outs):
    """Each worker's parameter digest from its WORKER_OK line."""
    got = []
    for rc, out in outs:
        assert rc == 0, out[-2000:]
        line = [ln for ln in out.splitlines() if ln.startswith("WORKER_OK")]
        assert line, out[-2000:]
        got.append(line[-1].split()[-1])
    return got


class _WriteOnceStore:
    """Fake store with TCPStore's semantics: ``compare_set(key, "", v)``
    writes only an absent key and returns the value held; ``wait`` raises
    for an absent key (instead of blocking)."""

    def __init__(self):
        self.store = {}

    def compare_set(self, key, expected, desired):
        if key not in self.store:
            if expected == "":
                self.store[key] = desired
                return desired.encode()
            return expected.encode()
        if self.store[key] == expected:
            self.store[key] = desired
        return self.store[key].encode()

    def wait(self, keys, timeout=None):
        for k in keys:
            if k not in self.store:
                raise TimeoutError(f"no value for {k}")

    def get(self, key):
        return self.store[key].encode()


def _encode(arr):
    return base64.b64encode(
        np.asarray(arr, np.float64).ravel().tobytes()).decode("ascii")


@pytest.fixture
def fake_peers(monkeypatch):
    """A write-once store and a 2-process run, this process index 0."""
    kv = _WriteOnceStore()
    monkeypatch.setattr(multihost, "distributed_client", lambda: kv)
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 0)
    return kv


class TestHostAllreduceTagReuse:
    """Keys are write-once: a reused tag would hand every peer the
    earlier reduction's buffers, so it raises naming the tag, and an
    idempotent retry (the same payload re-published) passes."""

    def test_mean_across_fake_peers(self, fake_peers):
        fake_peers.store["dl4j/hostavg/step1/1"] = _encode([4.0, 8.0])
        out = multihost.host_allreduce_mean(
            np.array([2.0, 4.0], np.float32), tag="step1")
        np.testing.assert_allclose(np.asarray(out), [3.0, 6.0])
        assert out.dtype == np.float32

    def test_reused_tag_with_different_payload_raises_naming_tag(
            self, fake_peers):
        # an EARLIER reduction already used this tag with other data
        fake_peers.store["dl4j/hostavg/epoch/0"] = _encode([9.0, 9.0])
        fake_peers.store["dl4j/hostavg/epoch/1"] = _encode([9.0, 9.0])
        with pytest.raises(ValueError, match="tag 'epoch'"):
            multihost.host_allreduce_mean(np.array([1.0, 2.0]), tag="epoch")

    def test_idempotent_retry_same_payload_is_benign(self, fake_peers):
        fake_peers.store["dl4j/hostavg/retry/0"] = _encode([1.0, 2.0])
        fake_peers.store["dl4j/hostavg/retry/1"] = _encode([3.0, 4.0])
        out = multihost.host_allreduce_mean(
            {"w": torch.tensor([1.0, 2.0])}, tag="retry")
        np.testing.assert_allclose(out["w"].numpy(), [2.0, 3.0])
        assert out["w"].dtype == torch.float32


def test_two_process_train_checkpoint_resume(tmp_path):
    ckdir = tmp_path / "ckpts"
    # a fresh two-process run trains 3 steps, process 0 checkpoints
    first = _digests(_run_phase(_free_port(), ckdir, "fresh"))
    assert first[0] == first[1]       # both hold the averaged parameters
    assert list(ckdir.glob("checkpoint_iter3.zip"))
    # the "restarted after preemption" run restores the checkpoint on both
    # processes and trains on from iteration 3
    again = _digests(_run_phase(_free_port(), ckdir, "resume"))
    assert again[0] == again[1]
    assert list(ckdir.glob("checkpoint_iter6.zip"))


def test_jax_checkpoint_restores_in_port(tmp_path):
    conf = (JaxNNC.Builder().seed(9).learning_rate(0.01).updater("adam")
            .weight_init("xavier").activation("tanh").list()
            .layer(jl.DenseLayer(n_out=8))
            .layer(jl.OutputLayer(n_out=3, loss="mcxent",
                                  activation="softmax"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = JaxMLN(conf).init()
    rng = np.random.default_rng(1)
    X = rng.normal(size=(8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    norm = JaxStandardize().fit(JaxDataSet(X, y))
    jnet.fit([JaxDataSet(X, y)] * 2)
    JaxCheckpointManager(tmp_path, interval_seconds=0.0).maybe_save(
        jnet, normalizer=norm, force=True)
    cm = multihost.CheckpointManager(tmp_path)
    assert cm.latest().name == "checkpoint_iter2.zip"
    net = cm.restore_latest(device="cpu")
    assert net.iteration == 2
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    for i, upd in enumerate(jnet.updater_state):
        for name, slots in upd.items():
            for slot, a in slots.items():
                np.testing.assert_array_equal(
                    net.updater_state[i][name][slot].numpy(), np.asarray(a))
    back = ModelSerializer.restore_normalizer(cm.latest())
    np.testing.assert_array_equal(back.mean, norm.mean)
    np.testing.assert_array_equal(back.std, norm.std)
