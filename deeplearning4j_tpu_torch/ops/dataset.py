"""The DataSet minibatch container (the JAX package's ``ops/dataset.py``):
host-side numpy arrays with optional masks for variable-length sequences.
Device placement happens at the train-step boundary. MultiDataSet and the
normalizers are not ported."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class DataSet:
    """One minibatch: features [N, ...], labels [N, ...], optional masks."""
    features: np.ndarray
    labels: Optional[np.ndarray] = None
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])
