"""The port's ML pipeline, scikit-learn bridge, fleet provisioning and
object store against the JAX package's on the CPU: the Pipeline's and
NetworkClassifier's predictions from the same weights (trained locally
and through a parameter-averaging master), DL4JClassifier under
scikit-learn, then ``tests/test_fleet.py``'s provisioning cases and
``tests/test_interop_streaming.py::TestObjectStore`` on the port's copies.

Tolerance: predicted probabilities at 1e-5 (ROADMAP rule 1: the two
packages' f32 steps sum in other orders); predicted classes equal."""

import subprocess as sp

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.cluster import ml_pipeline as jml
from deeplearning4j_tpu.cluster.param_averaging import \
    ParameterAveragingTrainingMaster as JaxMaster
from deeplearning4j_tpu.nn import InputType as JaxInputType
from deeplearning4j_tpu.nn import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOut
from deeplearning4j_tpu.ops.dataset import NormalizerStandardize as JaxNorm
from deeplearning4j_tpu_torch import cluster as pcluster
from deeplearning4j_tpu_torch.cluster import ml_pipeline as pml
from deeplearning4j_tpu_torch.cluster.param_averaging import \
    ParameterAveragingTrainingMaster
from deeplearning4j_tpu_torch.datasets.mnist import IrisDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.ops.dataset import NormalizerStandardize
from deeplearning4j_tpu_torch.ops.transfer import fetch_counts
from deeplearning4j_tpu_torch.utils import network_from_numpy
from deeplearning4j_tpu_torch.utils.fleet import (Boto3Ec2Driver,
                                                  Ec2BoxCreator,
                                                  GcloudTpuDriver,
                                                  InMemoryDriver)
from deeplearning4j_tpu_torch.utils.object_store import (
    FleetSpec, LocalFileSystemObjectStore, S3ObjectStore)

TOL = dict(rtol=1e-5, atol=1e-5)


def _iris():
    it = IrisDataSetIterator(150, 150, seed=7)
    return it.features, it.labels


def _pair(seed=4):
    jconf = (JaxNNC.Builder().seed(seed).learning_rate(0.1).updater("sgd")
             .weight_init("xavier").activation("tanh").list()
             .layer(JaxDense(n_out=8))
             .layer(JaxOut(n_out=3, loss="mcxent", activation="softmax"))
             .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = JaxNet(jconf).init()
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    arrays = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    return jnet, network_from_numpy(conf, arrays, device="cpu")


@pytest.mark.parametrize("master", [False, True])
def test_pipeline_matches_jax(master):
    """NormalizerStage + NetworkClassifier on Iris, 3 epochs of batch 32,
    locally or through a parameter-averaging master (2 workers, averaging
    every batch): JAX's probabilities and classes, one readback a
    predict_proba call."""
    X, y = _iris()
    jnet, pnet = _pair()
    kw = dict(averaging_frequency=1, num_workers=2) if master else None
    jclf = jml.NetworkClassifier(
        jnet, batch_size=32, epochs=3,
        training_master=JaxMaster(**kw) if master else None)
    pclf = pml.NetworkClassifier(
        pnet, batch_size=32, epochs=3, device="cpu",
        training_master=ParameterAveragingTrainingMaster(**kw)
        if master else None)
    jp = jml.Pipeline([("norm", jml.NormalizerStage(JaxNorm())),
                       ("net", jclf)]).fit(X, y)
    pp = pml.Pipeline([("norm", pml.NormalizerStage(NormalizerStandardize())),
                       ("net", pclf)]).fit(X, y)
    np.testing.assert_allclose(pp.stages[0][1].transform(X),
                               jp.stages[0][1].transform(X), **TOL)
    before = fetch_counts().get("pipeline.predict", 0)
    got = pp.transform(X)
    assert fetch_counts()["pipeline.predict"] - before == 1
    np.testing.assert_allclose(got, jp.transform(X), **TOL)
    np.testing.assert_array_equal(pp.predict(X), jp.predict(X))
    assert pp.score(X, y) == jp.score(X, y)
    assert pp.score(X, y) > 0.75          # chance is 1/3
    assert pclf.num_classes_ == jclf.num_classes_ == 3
    # one-hot labels take the same path
    onehot = np.eye(3, dtype=np.float32)[y]
    assert pclf.score(pp._pre(X), onehot) == pp.score(X, y)


def test_network_classifier_checks_its_device():
    _, pnet = _pair()
    with pytest.raises(ValueError, match="device"):
        pml.NetworkClassifier(pnet, device="meta")
    with pytest.raises(ValueError, match="labels"):
        pml.NetworkClassifier(pnet, device="cpu").fit(np.zeros((2, 4)))


def _blobs(n=120, seed=0):
    rng = np.random.default_rng(seed)
    X0 = rng.normal(loc=(-2, 0), scale=0.6, size=(n // 2, 2))
    X1 = rng.normal(loc=(2, 1), scale=0.6, size=(n - n // 2, 2))
    X = np.concatenate([X0, X1]).astype(np.float32)
    y = np.array(["a"] * (n // 2) + ["b"] * (n - n // 2))
    perm = rng.permutation(n)
    return X[perm], y[perm]


def test_dl4j_classifier_under_sklearn():
    """tests/test_sklearn_compat.py's cases on the port: string labels,
    a scikit-learn Pipeline, clone / get_params (``device`` kept) and a
    grid search over the port's estimator."""
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.model_selection import GridSearchCV
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    X, y = _blobs()
    clf = pcluster.DL4JClassifier(hidden=8, epochs=8, seed=1,
                                  device="cpu").fit(X, y)
    assert set(clf.classes_) == {"a", "b"}
    pred = clf.predict(X)
    assert pred.dtype == y.dtype and (pred == y).mean() > 0.95
    np.testing.assert_allclose(clf.predict_proba(X).sum(1), 1.0, rtol=1e-4)
    assert clf.net_.device.type == "cpu"
    pipe = Pipeline([("scale", StandardScaler()),
                     ("net", pcluster.DL4JClassifier(hidden=8, epochs=8,
                                                     device="cpu"))])
    assert pipe.fit(X, y).score(X, y) > 0.9
    c = clone(clf)
    assert c.get_params()["device"] == "cpu" and c.get_params()["hidden"] == 8
    c.set_params(hidden=4)
    assert c.hidden == 4 and clf.hidden == 8
    grid = GridSearchCV(pcluster.DL4JClassifier(epochs=4, device="cpu"),
                        {"hidden": [4, 8]}, cv=2).fit(X, y)
    assert grid.best_estimator_.device == "cpu"
    assert grid.best_score_ > 0.85


def test_entry_points_default_to_the_card():
    """device=None is the CUDA card: without one each entry point raises
    (DL4JClassifier keeps device as a plain hyperparameter and looks it up
    at fit)."""
    from deeplearning4j_tpu_torch.clustering import (BarnesHutTsne,
                                                     KMeansClustering, Tsne)
    _, pnet = _pair()
    X, y = _blobs(8)
    makers = [lambda d: KMeansClustering(3, device=d),
              lambda d: Tsne(device=d), lambda d: BarnesHutTsne(device=d),
              lambda d: Tsne.Builder().device(d).build(),
              lambda d: BarnesHutTsne.Builder().device(d).build(),
              lambda d: pcluster.DL4JClassifier(epochs=1, device=d)
              .fit(X, y).net_]
    for make in makers:
        assert make("cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert make(None).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(None)
    assert pml.NetworkClassifier(pnet, device="cpu").device.type == "cpu"
    # a CPU network under a classifier that asks for the card
    with pytest.raises(ValueError if torch.cuda.is_available()
                       else RuntimeError, match="device"):
        pml.NetworkClassifier(pnet)
    assert pcluster.DL4JClassifier().device is None


# ----------------------------------------------------- fleet provisioning
class _RecordedEc2Client:
    """tests/test_fleet.py's recorded-response EC2 client."""

    def __init__(self):
        self.calls = []
        self._n = 0
        self._states = {}

    def run_instances(self, **kwargs):
        self.calls.append(("run_instances", kwargs))
        out = []
        for _ in range(kwargs["MinCount"]):
            iid = f"i-0abc{self._n:08x}"
            self._n += 1
            self._states[iid] = "pending"
            out.append({"InstanceId": iid,
                        "State": {"Code": 0, "Name": "pending"}})
        return {"Instances": out}

    def describe_instances(self, InstanceIds):
        self.calls.append(("describe_instances", InstanceIds))
        for iid in InstanceIds:
            if self._states.get(iid) == "pending":
                self._states[iid] = "running"
        instances = [{"InstanceId": iid,
                      "State": {"Code": 16, "Name": self._states[iid]},
                      "PublicIpAddress": f"54.1.2.{i + 10}",
                      "PrivateIpAddress": f"10.0.0.{i + 10}"}
                     for i, iid in enumerate(InstanceIds)]
        return {"Reservations": [{"Instances": instances[:1]},
                                 {"Instances": instances[1:]}]}

    def terminate_instances(self, InstanceIds):
        self.calls.append(("terminate_instances", InstanceIds))


class _RecordedGcloudRunner:
    """tests/test_fleet.py's recorded gcloud outputs: CREATING on a
    name's first describe, READY afterwards."""

    def __init__(self, fail_create=False):
        self.argvs = []
        self.fail_create = fail_create
        self._described = set()

    def __call__(self, argv):
        self.argvs.append(argv)
        if "create" in argv:
            return sp.CompletedProcess(argv, 1 if self.fail_create else 0,
                                       stdout=b"", stderr=b"boom")
        if "describe" in argv:
            first = argv[5] not in self._described
            self._described.add(argv[5])
            return sp.CompletedProcess(
                argv, 0, stdout=b"CREATING\n" if first else b"READY\n",
                stderr=b"")
        return sp.CompletedProcess(argv, 0, stdout=b"", stderr=b"")


@pytest.mark.parametrize("driver", ["memory", "boto3", "gcloud", "dry_run"])
def test_box_creator_lifecycle(driver):
    client, runner = _RecordedEc2Client(), _RecordedGcloudRunner()
    drv = {"memory": lambda: InMemoryDriver(),
           "boto3": lambda: Boto3Ec2Driver(client=client),
           "gcloud": lambda: GcloudTpuDriver(runner=runner),
           "dry_run": lambda: GcloudTpuDriver(dry_run=True)}[driver]()
    creator = Ec2BoxCreator(num_boxes=3, size="c5.xlarge",
                            security_group_id="sg-1", key_pair="kp",
                            ami_id="ami-42", driver=drv)
    assert not creator.all_running()
    creator.create()
    assert len(creator.get_boxes_created()) == 3
    creator.block_till_all_running(timeout=5, poll=0.01)
    assert creator.all_running()
    hosts = creator.get_hosts()
    assert len(hosts) == 3 and all(hosts)
    ids = creator.blowup_boxes()
    assert set(ids) == set(creator.get_boxes_created())
    if driver == "memory":
        assert not creator.all_running()
    if driver == "boto3":
        assert hosts == ["54.1.2.10", "54.1.2.11", "54.1.2.12"]
        assert ("terminate_instances", ids) in client.calls
        run = client.calls[0][1]
        assert run["ImageId"] == "ami-42" and \
            run["SecurityGroupIds"] == ["sg-1"]
        assert "InstanceMarketOptions" not in run
    if driver == "gcloud":
        assert any("delete" in a for a in runner.argvs)
        assert "--zone=us-central2-b" in \
            [a for a in runner.argvs if "create" in a][0]
    if driver == "dry_run":
        cmds = drv.commands_run
        assert len(set(cmds)) == len(cmds) and \
            any("delete" in c for c in cmds)


def test_spot_delay_and_timeout():
    creator = Ec2BoxCreator(num_boxes=2,
                            driver=InMemoryDriver(startup_delay=0.2))
    creator.create_spot()
    assert not creator.all_running()
    creator.block_till_all_running(timeout=5, poll=0.05)
    assert creator.all_running()
    slow = Ec2BoxCreator(num_boxes=1, driver=InMemoryDriver(startup_delay=60))
    slow.create()
    with pytest.raises(TimeoutError):
        slow.block_till_all_running(timeout=0.3, poll=0.05)
    client = _RecordedEc2Client()
    Ec2BoxCreator(num_boxes=1, ami_id="ami-1",
                  driver=Boto3Ec2Driver(client=client)).create_spot()
    assert client.calls[0][1]["InstanceMarketOptions"] == \
        {"MarketType": "spot"}


def test_gcloud_failures():
    drv = GcloudTpuDriver(runner=_RecordedGcloudRunner(fail_create=True))
    with pytest.raises(RuntimeError, match="boom"):
        Ec2BoxCreator(num_boxes=1, driver=drv).create()
    calls = {"n": 0}

    def runner(argv):
        if "describe" in argv:
            calls["n"] += 1
            if calls["n"] == 1:              # a transient gcloud error
                return sp.CompletedProcess(argv, 1, b"", b"transient")
            return sp.CompletedProcess(argv, 0, b"READY\n", b"")
        return sp.CompletedProcess(argv, 0, b"", b"")

    drv = GcloudTpuDriver(runner=runner)
    box = drv.launch(1, {}, False)[0].instance_id
    assert drv.describe([box])[0].state == "pending"
    assert drv.describe([box])[0].state == "running"


def test_boto3_gates():
    """Neither package's image has boto3: both S3 and EC2 say so."""
    try:
        import boto3  # noqa: F401
        pytest.skip("boto3 is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="boto3"):
        S3ObjectStore()
    with pytest.raises(ImportError, match="boto3"):
        Boto3Ec2Driver()


def test_object_store_and_fleet_spec(tmp_path):
    store = LocalFileSystemObjectStore(tmp_path / "store")
    src = tmp_path / "a.bin"
    src.write_bytes(b"hello")
    store.upload(src, "models", "run1/best.zip")
    assert store.list_keys("models") == ["run1/best.zip"]
    assert store.list_keys("models", "run2") == []
    dst = tmp_path / "b.bin"
    store.download("models", "run1/best.zip", dst)
    assert dst.read_bytes() == b"hello"
    with pytest.raises(ValueError, match="escapes"):
        store.upload(src, "models", "../../outside")
    store.delete("models", "run1/best.zip")
    assert store.list_keys("models") == []
    cmds = FleetSpec(num_workers=2,
                     startup_commands=["echo up"]).render_launch_commands()
    assert len(cmds) == 3 and "tpu-vm create" in cmds[0]
    assert cmds[-1] == "echo up"
