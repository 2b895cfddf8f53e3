"""ML-pipeline Estimator / Model wrappers: the JAX package's
``cluster/ml_pipeline.py`` on the port's nets (reference dl4j-spark-ml:
Spark-ML ``Estimator`` / ``Model`` pipeline stages wrapping DL4J nets).

Spark ML's fit / transform contract in the scikit-learn idiom: an
Estimator's ``fit`` returns a fitted Model with ``transform`` /
``predict`` / ``predict_proba``; stages compose in a ``Pipeline``.
Networks and DataNormalizers both slot in as stages. A
:class:`NetworkClassifier` trains its network on the network's device,
which must be the classifier's ``device`` (``None``: the CUDA card), and
reads its predictions back once a call (``pipeline.predict``)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.platform import resolve_device
from ..ops.transfer import device_fetch


class PipelineStage:
    def fit(self, X: np.ndarray, y: Optional[np.ndarray] = None):
        raise NotImplementedError

    def transform(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class NormalizerStage(PipelineStage):
    """Wraps a DataNormalizer (fit = collect statistics)."""

    def __init__(self, normalizer):
        self.normalizer = normalizer

    def fit(self, X, y=None):
        from ..ops.dataset import DataSet
        self.normalizer.fit([DataSet(np.asarray(X, np.float32), None)])
        return self

    def transform(self, X):
        from ..ops.dataset import DataSet
        ds = self.normalizer.transform(
            DataSet(np.asarray(X, np.float32), None))
        return np.asarray(ds.features)


class NetworkClassifier(PipelineStage):
    """Estimator/Model in one object (reference SparkDl4jNetwork /
    SparkDl4jModel): fit trains the wrapped net, transform/predict run it."""

    def __init__(self, network, batch_size: int = 32, epochs: int = 1,
                 training_master=None, device=None):
        self.device = resolve_device(device)
        if network.device != self.device:
            raise ValueError(f"the network is on {network.device}, the "
                             f"classifier on {self.device}: build the "
                             f"network with device={self.device}")
        self.network = network
        self.batch_size = int(batch_size)
        self.epochs = int(epochs)
        self.training_master = training_master
        self.num_classes_: Optional[int] = None

    def _batches(self, X, y):
        from ..ops.dataset import DataSet
        X = np.asarray(X, np.float32)
        n_classes = self.num_classes_
        out = []
        for i in range(0, len(X), self.batch_size):
            labels = np.eye(n_classes, dtype=np.float32)[
                np.asarray(y[i:i + self.batch_size], np.int64)]
            out.append(DataSet(X[i:i + self.batch_size], labels))
        return out

    def fit(self, X, y=None):
        if y is None:
            raise ValueError("NetworkClassifier.fit requires labels")
        y = np.asarray(y)
        self.num_classes_ = int(y.max()) + 1 if y.ndim == 1 else y.shape[-1]
        if y.ndim > 1:
            y = y.argmax(-1)
        batches = self._batches(X, y)
        if self.training_master is not None:
            from .network import ClusterDl4jMultiLayer
            from .rdd import DistributedDataSet
            ClusterDl4jMultiLayer(self.network, self.training_master).fit(
                DistributedDataSet.from_datasets(batches),
                num_epochs=self.epochs)
        else:
            self.network.fit(batches, num_epochs=self.epochs)
        return self

    def predict_proba(self, X) -> np.ndarray:
        X = np.asarray(X, np.float32)
        net = self.network
        if hasattr(net, "_output_tensor"):
            return device_fetch(net._output_tensor(X), "pipeline.predict")
        return device_fetch(net._output_tensors(X)[0], "pipeline.predict")

    def predict(self, X) -> np.ndarray:
        return self.predict_proba(X).argmax(-1)

    def transform(self, X) -> np.ndarray:
        return self.predict_proba(X)

    def score(self, X, y) -> float:
        """Accuracy (Spark-ML evaluator analog)."""
        y = np.asarray(y)
        if y.ndim > 1:
            y = y.argmax(-1)
        return float((self.predict(X) == y).mean())


class Pipeline(PipelineStage):
    """Ordered stages; all but the last transform, the last fits/predicts
    (Spark ML Pipeline contract)."""

    def __init__(self, stages: Sequence[Tuple[str, PipelineStage]]):
        self.stages = list(stages)

    def fit(self, X, y=None):
        for name, stage in self.stages[:-1]:
            stage.fit(X, y)
            X = stage.transform(X)
        self.stages[-1][1].fit(X, y)
        return self

    def _pre(self, X):
        for name, stage in self.stages[:-1]:
            X = stage.transform(X)
        return X

    def transform(self, X):
        return self.stages[-1][1].transform(self._pre(X))

    def predict(self, X):
        return self.stages[-1][1].predict(self._pre(X))

    def score(self, X, y) -> float:
        return self.stages[-1][1].score(self._pre(X), y)
