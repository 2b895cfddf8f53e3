"""ComputationGraph configuration (the JAX package's
``nn/graph/graph_config.py``): vertices, inputs, outputs and the
topological order computed once at build time with Kahn's algorithm, and
input-type shape inference (``set_input_types``: every layer's n_in, and
a preprocessor where a layer's input kind differs). The dataclass fields
match the JAX package's, so ``to_json`` writes the same JSON and
``from_json`` reads JSON the JAX package wrote."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from ..conf.input_type import InputType
from ..conf.preprocessors import auto_preprocessor
from ..conf.serde import from_jsonable, register_config, to_jsonable
from .vertices import GraphVertexConf, LayerVertex


@register_config
@dataclasses.dataclass
class ComputationGraphConfiguration:
    vertices: Dict[str, GraphVertexConf] = dataclasses.field(
        default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)
    network_inputs: List[str] = dataclasses.field(default_factory=list)
    network_outputs: List[str] = dataclasses.field(default_factory=list)
    topological_order: List[str] = dataclasses.field(default_factory=list)
    input_types: Optional[List[InputType]] = None
    seed: int = 12345
    optimization_algo: str = "stochastic_gradient_descent"
    iterations: int = 1
    minibatch: bool = True
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    lr_policy: Optional[str] = None
    lr_policy_decay_rate: float = 0.0
    lr_policy_steps: float = 1.0
    lr_policy_power: float = 1.0
    max_iterations: int = 1
    learning_rate_schedule: Optional[Dict[int, float]] = None

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(to_jsonable(self), indent=indent)

    @staticmethod
    def from_json(data: str) -> "ComputationGraphConfiguration":
        obj = from_jsonable(json.loads(data))
        if not isinstance(obj, ComputationGraphConfiguration):
            raise ValueError("JSON does not encode a "
                             "ComputationGraphConfiguration")
        if obj.learning_rate_schedule:
            obj.learning_rate_schedule = {int(k): float(v) for k, v in
                                          obj.learning_rate_schedule.items()}
        if obj.input_types:
            obj.input_types = [
                InputType.from_dict(t) if isinstance(t, dict) else t
                for t in obj.input_types]
        return obj


def topological_sort(vertex_inputs: Dict[str, List[str]],
                     network_inputs: List[str]) -> List[str]:
    """Kahn's algorithm over the vertex DAG; raises on cycles/missing
    inputs."""
    all_nodes = list(vertex_inputs.keys())
    known = set(all_nodes) | set(network_inputs)
    for name, ins in vertex_inputs.items():
        for i in ins:
            if i not in known:
                raise ValueError(f"Vertex '{name}' input '{i}' is undefined")
    indegree = {n: 0 for n in all_nodes}
    dependents: Dict[str, List[str]] = {n: [] for n in known}
    for name, ins in vertex_inputs.items():
        for i in ins:
            dependents.setdefault(i, []).append(name)
            if i not in network_inputs:
                indegree[name] += 1
    queue = [n for n in all_nodes if indegree[n] == 0]
    order = []
    while queue:
        n = queue.pop(0)
        order.append(n)
        for d in dependents.get(n, []):
            indegree[d] -= 1
            if indegree[d] == 0:
                queue.append(d)
    if len(order) != len(all_nodes):
        raise ValueError("Graph contains a cycle")
    return order


def with_ancestors(names, vertex_inputs: Dict[str, List[str]],
                   network_inputs: List[str], vertices=None) -> set:
    """The named vertices and every vertex they depend on, network inputs
    excluded; a name missing from ``vertices`` raises when it is given."""
    found, stack = set(), list(names)
    while stack:
        cur = stack.pop()
        if cur in found or cur in network_inputs:
            continue
        if vertices is not None and cur not in vertices:
            raise ValueError(f"Feature-extractor vertex '{cur}' does not "
                             "exist")
        found.add(cur)
        stack.extend(vertex_inputs.get(cur, []))
    return found


def infer_graph_shapes(vertices: Dict[str, GraphVertexConf],
                       vertex_inputs: Dict[str, List[str]],
                       network_inputs: List[str],
                       input_types: List[InputType],
                       order: List[str]) -> Dict[str, InputType]:
    """Propagate input types through the DAG in topological order: each
    LayerVertex gets its n_in (``set_n_in`` keeps one already set) and, where
    its layer expects another input kind, the auto preprocessor. Returns
    every vertex's output type."""
    types: Dict[str, InputType] = dict(zip(network_inputs, input_types))
    for name in order:
        v = vertices[name]
        in_types = [types[i] for i in vertex_inputs[name]]
        if isinstance(v, LayerVertex):
            it = in_types[0]
            needed = v.layer.input_kind()
            if v.preprocessor is None and needed != "any":
                pp = auto_preprocessor(it, needed,
                                       timesteps=it.timesteps or 0)
                if pp is not None:
                    v.preprocessor = pp
            if v.preprocessor is not None:
                it = v.preprocessor.output_type(it)
            v.layer.set_n_in(it)
            types[name] = v.layer.get_output_type(it)
        else:
            types[name] = v.output_type(in_types)
    return types


class GraphBuilder:
    """``NeuralNetConfiguration.Builder().graph_builder()``, with the
    graph's truncated-BPTT and pretrain settings."""

    def __init__(self, parent):
        self._parent = parent
        self._vertices: Dict[str, GraphVertexConf] = {}
        self._inputs: Dict[str, List[str]] = {}
        self._network_inputs: List[str] = []
        self._network_outputs: List[str] = []
        self._input_types: Optional[List[InputType]] = None
        self._backprop_type = "standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20
        self._pretrain = False

    def add_inputs(self, *names: str):
        self._network_inputs.extend(names)
        return self

    def add_layer(self, name: str, layer, *inputs: str):
        self._vertices[name] = LayerVertex(layer=layer)
        self._inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertexConf, *inputs: str):
        self._vertices[name] = vertex
        self._inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str):
        self._network_outputs = list(names)
        return self

    def set_input_types(self, *types: InputType):
        self._input_types = list(types)
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

    def pretrain(self, flag):
        self._pretrain = bool(flag)
        return self

    def build(self) -> ComputationGraphConfiguration:
        p = self._parent
        for out in self._network_outputs:
            if out not in self._vertices:
                raise ValueError(f"Output '{out}' is not a vertex")
        order = topological_sort(self._inputs, self._network_inputs)
        vertices = {}
        for name, v in self._vertices.items():
            if isinstance(v, LayerVertex):
                vertices[name] = LayerVertex(layer=p._apply_globals(v.layer),
                                             preprocessor=v.preprocessor)
            else:
                vertices[name] = v
        if self._input_types is not None:
            infer_graph_shapes(vertices, self._inputs, self._network_inputs,
                               self._input_types, order)
        return ComputationGraphConfiguration(
            vertices=vertices,
            vertex_inputs=dict(self._inputs),
            network_inputs=list(self._network_inputs),
            network_outputs=list(self._network_outputs),
            topological_order=order,
            input_types=self._input_types,
            seed=p._seed,
            optimization_algo=p._opt,
            iterations=p._iterations,
            minibatch=p._minibatch,
            backprop_type=self._backprop_type,
            pretrain=self._pretrain,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
            lr_policy=p._lr_policy,
            lr_policy_decay_rate=p._lr_decay,
            lr_policy_steps=p._lr_steps,
            lr_policy_power=p._lr_power,
            learning_rate_schedule=p._lr_schedule,
        )
