"""scikit-learn compatibility shim: the JAX package's
``cluster/sklearn_compat.py`` on the port's nets (reference dl4j-spark-ml:
DL4J nets as first-class Estimator / Model stages of an existing
pipeline ecosystem).

``DL4JClassifier`` is a real ``sklearn.base.BaseEstimator`` +
``ClassifierMixin``: it composes with ``sklearn.pipeline.Pipeline``,
``clone``, ``GridSearchCV`` and ``cross_val_score`` (the get_params /
set_params contract comes from storing constructor args verbatim,
``device`` among them: ``None`` is the CUDA card, looked up at ``fit``).
The in-repo Pipeline (``cluster/ml_pipeline.py``) is the dependency-free
variant; this shim is the ecosystem bridge."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..ops.transfer import device_fetch

try:
    from sklearn.base import BaseEstimator, ClassifierMixin
except ImportError:                     # pragma: no cover - sklearn absent
    class BaseEstimator:               # type: ignore
        pass

    class ClassifierMixin:             # type: ignore
        pass


def _default_conf(n_in: int, n_classes: int, est: "DL4JClassifier"):
    from ..nn.conf.config import NeuralNetConfiguration
    from ..nn.conf.layers import DenseLayer, OutputLayer
    return (NeuralNetConfiguration.Builder().seed(est.seed)
            .learning_rate(est.learning_rate).updater(est.updater)
            .weight_init("xavier").activation("relu").list()
            .layer(DenseLayer(n_in=n_in, n_out=est.hidden))
            .layer(OutputLayer(n_in=est.hidden, n_out=n_classes,
                               loss="mcxent", activation="softmax"))
            .build())


class DL4JClassifier(BaseEstimator, ClassifierMixin):
    """MultiLayerNetwork as a scikit-learn classifier.

    ``conf_builder(n_in, n_classes, estimator) -> MultiLayerConfiguration``
    customizes the architecture (default: one hidden ReLU layer). All
    constructor args are plain hyperparameters, so ``clone()`` and
    ``GridSearchCV`` see them via ``get_params``."""

    def __init__(self, conf_builder: Optional[Callable] = None,
                 hidden: int = 16, epochs: int = 5, batch_size: int = 32,
                 learning_rate: float = 0.1, updater: str = "adam",
                 seed: int = 0, device=None):
        self.conf_builder = conf_builder
        self.hidden = hidden
        self.epochs = epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.updater = updater
        self.seed = seed
        self.device = device

    # ------------------------------------------------------------- fit
    def fit(self, X, y):
        from ..nn import MultiLayerNetwork
        from ..ops.dataset import DataSet
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        if X.ndim != 2:
            X = X.reshape(len(X), -1)
        self.classes_, y_idx = np.unique(y, return_inverse=True)
        n_classes = len(self.classes_)
        builder = self.conf_builder or _default_conf
        conf = builder(X.shape[1], n_classes, self)
        self.net_ = MultiLayerNetwork(conf, device=self.device).init()
        onehot = np.eye(n_classes, dtype=np.float32)[y_idx]
        batches = [DataSet(X[i:i + self.batch_size],
                           onehot[i:i + self.batch_size])
                   for i in range(0, len(X), self.batch_size)]
        self.net_.fit(batches, num_epochs=self.epochs)
        self.n_features_in_ = X.shape[1]
        return self

    # --------------------------------------------------------- predict
    def _check_fitted(self):
        if not hasattr(self, "net_"):
            try:
                from sklearn.exceptions import NotFittedError
            except ImportError:        # pragma: no cover - sklearn absent
                NotFittedError = RuntimeError
            raise NotFittedError("DL4JClassifier is not fitted yet")

    def predict_proba(self, X) -> np.ndarray:
        self._check_fitted()
        X = np.asarray(X, np.float32)
        if X.ndim != 2:
            X = X.reshape(len(X), -1)
        return device_fetch(self.net_._output_tensor(X), "pipeline.predict")

    def predict(self, X) -> np.ndarray:
        self._check_fitted()
        return self.classes_[np.argmax(self.predict_proba(X), axis=-1)]
