"""Network configuration: the fluent global-hyperparameter builder, copied
from the JAX package's ``nn/conf/config.py`` so the port builds and reads
the same configuration JSON. Globals cascade into every per-layer field
left at None, exactly as there.

Only what the transformer LM's builder chain calls is ported; the
sequential-net ``ListBuilder`` / ``MultiLayerConfiguration`` are not on
that path."""

from __future__ import annotations

import copy

from .layers.base import LayerConf

# Global defaults, matching the JAX package's builder field defaults.
GLOBAL_DEFAULTS = dict(
    activation="sigmoid",
    weight_init="xavier",
    bias_init=0.0,
    learning_rate=1e-1,
    bias_learning_rate=None,
    updater="sgd",
    momentum=0.5,
    rho=0.95,
    rms_decay=0.95,
    adam_mean_decay=0.9,
    adam_var_decay=0.999,
    epsilon=1e-8,
    l1=0.0,
    l2=0.0,
    drop_out=0.0,
    gradient_normalization=None,
    gradient_normalization_threshold=1.0,
)


class NeuralNetConfiguration:
    """``NeuralNetConfiguration.Builder()`` starts a config."""

    class Builder:
        def __init__(self):
            self._g = dict(GLOBAL_DEFAULTS)
            self._seed = 12345

        def seed(self, s):
            self._seed = int(s)
            return self

        def learning_rate(self, lr):
            self._g["learning_rate"] = float(lr)
            return self

        def weight_init(self, wi):
            self._g["weight_init"] = str(wi).lower()
            return self

        def updater(self, u):
            self._g["updater"] = str(u).lower()
            return self

        def graph_builder(self):
            from ..graph.graph_config import GraphBuilder
            return GraphBuilder(self)

        def _apply_globals(self, layer: LayerConf) -> LayerConf:
            layer = copy.deepcopy(layer)
            for field, value in self._g.items():
                if hasattr(layer, field) and getattr(layer, field) is None:
                    setattr(layer, field, value)
            return layer
