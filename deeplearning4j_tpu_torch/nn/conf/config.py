"""Network configuration: the fluent global-hyperparameter builder and the
sequential-net configuration it produces, copied from the JAX package's
``nn/conf/config.py`` so the port builds and reads the same configuration
JSON.

Globals cascade into every per-layer field left at None, exactly as
there, including its rule that l1 / l2 cascade as 0 unless
``regularization(True)`` (or an ``l1`` / ``l2`` call) turned them on.
``.list()`` returns a ``ListBuilder`` whose ``build`` infers each layer's
nIn from the input type and inserts the input preprocessors, giving a
``MultiLayerConfiguration``; ``.graph_builder()`` starts a
ComputationGraph configuration."""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Dict, List, Optional

from .input_type import InputType
from .layers.base import LayerConf
from .preprocessors import InputPreProcessor, auto_preprocessor
from .serde import from_jsonable, register_config, to_jsonable

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


@register_config
@dataclasses.dataclass
class MultiLayerConfiguration:
    """The sequential-net configuration: layers, input preprocessors (keyed
    by the layer index as a string), training flags and the lr policy."""
    layers: List[LayerConf] = dataclasses.field(default_factory=list)
    input_preprocessors: Dict[str, Optional[InputPreProcessor]] = \
        dataclasses.field(default_factory=dict)
    seed: int = 12345
    optimization_algo: str = "stochastic_gradient_descent"
    iterations: int = 1
    minibatch: bool = True
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"     # standard | truncated_bptt
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    max_num_line_search_iterations: int = 5
    lr_policy: Optional[str] = None
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    max_iterations: int = 1
    learning_rate_schedule: Optional[Dict[int, float]] = None
    input_type: Optional[InputType] = None
    dtype: str = "float32"

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(to_jsonable(self), indent=indent)

    @staticmethod
    def from_json(data: str) -> "MultiLayerConfiguration":
        obj = from_jsonable(json.loads(data))
        if not isinstance(obj, MultiLayerConfiguration):
            raise ValueError("JSON does not encode a MultiLayerConfiguration")
        # JSON turns the schedule's integer keys into strings
        if obj.learning_rate_schedule:
            obj.learning_rate_schedule = {int(k): float(v) for k, v in
                                          obj.learning_rate_schedule.items()}
        if isinstance(obj.input_type, dict):
            obj.input_type = InputType.from_dict(obj.input_type)
        return obj

    def preprocessor_for(self, idx: int) -> Optional[InputPreProcessor]:
        return self.input_preprocessors.get(str(idx))


class NeuralNetConfiguration:
    """``NeuralNetConfiguration.Builder()`` starts a config."""

    class Builder:
        def __init__(self):
            self._g = dict(GLOBAL_DEFAULTS)
            self._seed = 12345
            self._opt = "stochastic_gradient_descent"
            self._iterations = 1
            self._minibatch = True
            self._lr_policy = None
            self._lr_decay = 0.0
            self._lr_steps = 1.0
            self._lr_power = 1.0
            self._lr_schedule = None
            self._max_line_search = 5
            self._use_regularization = False

        def seed(self, s):
            self._seed = int(s)
            return self

        def iterations(self, n):
            self._iterations = int(n)
            return self

        def optimization_algo(self, algo):
            self._opt = str(algo).lower()
            return self

        def learning_rate(self, lr):
            self._g["learning_rate"] = float(lr)
            return self

        def bias_learning_rate(self, lr):
            self._g["bias_learning_rate"] = float(lr)
            return self

        def learning_rate_decay_policy(self, policy):
            self._lr_policy = str(policy).lower()
            return self

        def lr_policy_decay_rate(self, r):
            self._lr_decay = float(r)
            return self

        def lr_policy_steps(self, s):
            self._lr_steps = float(s)
            return self

        def lr_policy_power(self, p):
            self._lr_power = float(p)
            return self

        def learning_rate_schedule(self, sched: Dict[int, float]):
            self._lr_schedule = dict(sched)
            self._lr_policy = "schedule"
            return self

        def activation(self, a):
            self._g["activation"] = a
            return self

        def weight_init(self, wi):
            self._g["weight_init"] = str(wi).lower()
            return self

        def dist(self, d):
            self._g["dist"] = d
            self._g["weight_init"] = "distribution"
            return self

        def bias_init(self, b):
            self._g["bias_init"] = float(b)
            return self

        def updater(self, u):
            self._g["updater"] = str(u).lower()
            return self

        def momentum(self, m):
            self._g["momentum"] = float(m)
            return self

        def rho(self, r):
            self._g["rho"] = float(r)
            return self

        def rms_decay(self, r):
            self._g["rms_decay"] = float(r)
            return self

        def adam_mean_decay(self, b):
            self._g["adam_mean_decay"] = float(b)
            return self

        def adam_var_decay(self, b):
            self._g["adam_var_decay"] = float(b)
            return self

        def epsilon(self, e):
            self._g["epsilon"] = float(e)
            return self

        def l1(self, v):
            self._g["l1"] = float(v)
            self._use_regularization = True
            return self

        def l2(self, v):
            self._g["l2"] = float(v)
            self._use_regularization = True
            return self

        def regularization(self, flag=True):
            self._use_regularization = bool(flag)
            return self

        def drop_out(self, p):
            self._g["drop_out"] = float(p)
            return self

        def gradient_normalization(self, strategy):
            self._g["gradient_normalization"] = strategy
            return self

        def gradient_normalization_threshold(self, t):
            self._g["gradient_normalization_threshold"] = float(t)
            return self

        def minibatch(self, flag):
            self._minibatch = bool(flag)
            return self

        def max_num_line_search_iterations(self, n):
            self._max_line_search = int(n)
            return self

        def list(self) -> "ListBuilder":
            return ListBuilder(self)

        def graph_builder(self):
            from ..graph.graph_config import GraphBuilder
            return GraphBuilder(self)

        def _apply_globals(self, layer: LayerConf) -> LayerConf:
            layer = copy.deepcopy(layer)
            for field, value in self._g.items():
                if hasattr(layer, field) and getattr(layer, field) is None:
                    if field in ("l1", "l2") and \
                            not self._use_regularization:
                        setattr(layer, field, 0.0)
                    else:
                        setattr(layer, field, value)
            return layer


class ListBuilder:
    """``Builder().list()``: layers in order → MultiLayerConfiguration."""

    def __init__(self, parent: NeuralNetConfiguration.Builder):
        self._parent = parent
        self._layers: List[LayerConf] = []
        self._preprocessors: Dict[str, InputPreProcessor] = {}
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._input_type: Optional[InputType] = None

    def layer(self, index_or_conf, conf: LayerConf = None) -> "ListBuilder":
        """``layer(conf)`` or the reference's ``layer(i, conf)``."""
        self._layers.append(index_or_conf if conf is None else conf)
        return self

    def input_preprocessor(self, index: int, pp: InputPreProcessor):
        self._preprocessors[str(index)] = pp
        return self

    def backprop(self, flag):
        self._backprop = bool(flag)
        return self

    def pretrain(self, flag):
        self._pretrain = bool(flag)
        return self

    def backprop_type(self, t):
        self._backprop_type = str(t).lower()
        return self

    def tbptt_fwd_length(self, n):
        self._tbptt_fwd = int(n)
        self._backprop_type = "truncated_bptt"
        return self

    def tbptt_back_length(self, n):
        self._tbptt_back = int(n)
        return self

    def set_input_type(self, it: InputType):
        self._input_type = it
        return self

    def input_type(self, it: InputType):
        return self.set_input_type(it)

    def build(self) -> MultiLayerConfiguration:
        """Cascade the globals into each layer; with an input type, infer
        each nIn and insert the preprocessors where a layer's input kind
        changes."""
        p = self._parent
        layers = [p._apply_globals(layer) for layer in self._layers]
        preproc = dict(self._preprocessors)
        if self._input_type is not None:
            current = self._input_type
            for i, layer in enumerate(layers):
                pp = preproc.get(str(i))
                needed = layer.input_kind()
                if pp is None and needed != "any":
                    pp = auto_preprocessor(current, needed,
                                           timesteps=current.timesteps or 0)
                    if pp is not None:
                        preproc[str(i)] = pp
                if pp is not None:
                    current = pp.output_type(current)
                layer.set_n_in(current)
                current = layer.get_output_type(current)
        return MultiLayerConfiguration(
            layers=layers,
            input_preprocessors=preproc,
            seed=p._seed,
            optimization_algo=p._opt,
            iterations=p._iterations,
            minibatch=p._minibatch,
            backprop=self._backprop,
            pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            max_num_line_search_iterations=p._max_line_search,
            lr_policy=p._lr_policy,
            lr_policy_decay_rate=p._lr_decay,
            lr_policy_steps=p._lr_steps,
            lr_policy_power=p._lr_power,
            learning_rate_schedule=p._lr_schedule,
            input_type=self._input_type,
        )
