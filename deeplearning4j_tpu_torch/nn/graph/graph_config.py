"""ComputationGraph configuration (the JAX package's
``nn/graph/graph_config.py``): vertices, inputs, outputs and the
topological order computed once at build time with Kahn's algorithm. The
dataclass fields match the JAX package's, so ``to_json`` writes the same
JSON and ``from_json`` reads JSON the JAX package wrote."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from ..conf.input_type import InputType
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


class GraphBuilder:
    """``NeuralNetConfiguration.Builder().graph_builder()``. Input-type
    shape inference (``set_input_types``) is not ported: the layers of the
    transformer LM carry explicit n_in/n_out, and the builder's other
    settings keep the configuration's defaults."""

    def __init__(self, parent):
        self._parent = parent
        self._vertices: Dict[str, GraphVertexConf] = {}
        self._inputs: Dict[str, List[str]] = {}
        self._network_inputs: List[str] = []
        self._network_outputs: List[str] = []

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
        return ComputationGraphConfiguration(
            vertices=vertices,
            vertex_inputs=dict(self._inputs),
            network_inputs=list(self._network_inputs),
            network_outputs=list(self._network_outputs),
            topological_order=order,
            seed=p._seed,
        )
