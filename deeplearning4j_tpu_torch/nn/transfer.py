"""Transfer learning (the JAX package's ``nn/transfer.py``): copy a trained
network, freeze the layers below a boundary, remove and append layers,
override hyperparameters on the rest, and featurize through the frozen
part.

Frozen means a learning rate of 0 and an exact copy of the source's
parameters: every update rule the port has moves a parameter by a step
proportional to the learning rate, so a frozen parameter stays
bit-identical however long the network trains. Layer state is copied, not
frozen: batch norm's running statistics of a frozen layer still move in
training, as in the JAX package. ``TransferLearning.GraphBuilder`` is the
ComputationGraph variant: it freezes named vertices and every ancestor on
their path from the inputs."""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..ops.dataset import DataSet, MultiDataSet
from .graph.computation_graph import ComputationGraph
from .graph.graph_config import (ComputationGraphConfiguration,
                                 infer_graph_shapes, topological_sort,
                                 with_ancestors)
from .graph.vertices import LayerVertex
from .multilayer import MultiLayerNetwork, _clone_tree, _to_numpy


@dataclasses.dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides applied to every layer that is neither
    frozen nor copied unchanged, and the seed of the new network."""
    learning_rate: Optional[float] = None
    updater: Optional[str] = None
    momentum: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    drop_out: Optional[float] = None
    activation: Optional[str] = None
    seed: Optional[int] = None

    def apply(self, layer):
        for f in ("learning_rate", "updater", "momentum", "l1", "l2",
                  "drop_out", "activation"):
            v = getattr(self, f)
            if v is not None and hasattr(layer, f):
                setattr(layer, f, v)


class TransferLearning:
    class Builder:
        """MultiLayerNetwork surgery."""

        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._removed_from: Optional[int] = None
            self._added: List = []
            self._n_out_overrides: Dict[int, int] = {}

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_index: int):
            """Freeze layers [0, layer_index]."""
            self._freeze_until = int(layer_index)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            self._removed_from = len(self._net.layers) - int(n)
            return self

        def add_layer(self, conf):
            self._added.append(conf)
            return self

        def n_out_replace(self, layer_index: int, n_out: int):
            """Change a layer's n_out, re-initializing it and the next
            layer (whose n_in follows)."""
            self._n_out_overrides[int(layer_index)] = int(n_out)
            return self

        def build(self) -> MultiLayerNetwork:
            """The new network: the configuration after surgery, the
            source's parameters and state copied for every layer that was
            not re-initialized, fresh updater state."""
            src = self._net
            src._ensure_init()
            conf = copy.deepcopy(src.conf)
            keep = self._removed_from if self._removed_from is not None \
                else len(conf.layers)
            layers = conf.layers[:keep]
            reinit = set()
            for idx, n_out in self._n_out_overrides.items():
                layers[idx].n_out = n_out
                reinit.add(idx)
                if idx + 1 < len(layers) and hasattr(layers[idx + 1], "n_in"):
                    layers[idx + 1].n_in = n_out
                    reinit.add(idx + 1)
            # appended layers take n_in from the running output type
            current = conf.input_type
            if current is not None:
                for i, l in enumerate(layers):
                    pp = conf.preprocessor_for(i)
                    if pp is not None:
                        current = pp.output_type(current)
                    current = l.get_output_type(current)
            for l in self._added:
                l = copy.deepcopy(l)
                if self._fine_tune:
                    self._fine_tune.apply(l)
                if current is not None:
                    l.set_n_in(current)
                    current = l.get_output_type(current)
                layers.append(l)
                reinit.add(len(layers) - 1)
            frozen_upto = -1 if self._freeze_until is None \
                else self._freeze_until
            for i, l in enumerate(layers):
                if i <= frozen_upto:
                    l.learning_rate = 0.0
                elif self._fine_tune and i not in reinit:
                    self._fine_tune.apply(l)
            conf.layers = layers
            conf.input_preprocessors = {
                k: v for k, v in conf.input_preprocessors.items()
                if int(k) < len(layers)}
            if self._fine_tune and self._fine_tune.seed is not None:
                conf.seed = self._fine_tune.seed
            new_net = MultiLayerNetwork(conf, src.compute_dtype,
                                        src.device).init()
            for i in range(min(len(layers), len(src.params))):
                if i not in reinit:
                    new_net.params[i] = _clone_tree(src.params[i])
                    new_net.state[i] = _clone_tree(src.state[i])
            new_net.frozen_until = frozen_upto
            return new_net

    class GraphBuilder:
        """ComputationGraph surgery: freeze by vertex name, remove and
        append vertices, change n_out and the outputs."""

        def __init__(self, graph: ComputationGraph):
            self._graph = graph
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._frozen_names: List[str] = []
            self._removed: List[tuple] = []        # (name, keep_connections)
            self._added: List[tuple] = []          # (name, vertex, inputs)
            self._outputs: Optional[List[str]] = None
            self._n_out_overrides: Dict[str, int] = {}

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and every ancestor on their path
            from the network inputs."""
            self._frozen_names.extend(vertex_names)
            return self

        def remove_vertex_and_connections(self, name: str):
            """Delete the vertex, drop it from its consumers' inputs and
            from the outputs."""
            self._removed.append((name, False))
            return self

        def remove_vertex_keep_connections(self, name: str):
            """Delete the vertex but keep the edges that name it: a vertex
            added under the same name takes its place."""
            self._removed.append((name, True))
            return self

        def add_layer(self, name: str, layer, *inputs: str):
            return self.add_vertex(name, LayerVertex(layer=layer), *inputs)

        def add_vertex(self, name: str, vertex, *inputs: str):
            self._added.append((name, vertex, list(inputs)))
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        def n_out_replace(self, vertex_name: str, n_out: int):
            """Change a layer vertex's n_out, re-initializing it and every
            layer downstream whose n_in follows it."""
            self._n_out_overrides[vertex_name] = int(n_out)
            return self

        def build(self) -> ComputationGraph:
            src = self._graph
            src._ensure_init()
            conf = copy.deepcopy(src.conf)
            vertices = dict(conf.vertices)
            vinputs = {k: list(v) for k, v in conf.vertex_inputs.items()}
            outputs = list(conf.network_outputs)
            reinit = set()

            def downstream_layers(start_names):
                """Layer vertices fed by ``start_names``, directly or
                through non-layer vertices."""
                found, frontier, seen = [], list(start_names), set()
                while frontier:
                    cur = frontier.pop()
                    for k, ins in vinputs.items():
                        if cur not in ins or k in seen:
                            continue
                        seen.add(k)
                        if isinstance(vertices.get(k), LayerVertex):
                            found.append((k, cur))
                        else:
                            frontier.append(k)
                return found

            for name, keep in self._removed:
                if name not in vertices:
                    raise ValueError(f"Cannot remove unknown vertex '{name}'")
                vertices.pop(name)
                vinputs.pop(name)
                outputs = [o for o in outputs if o != name]
                if keep:
                    continue
                affected = [k for k, ins in vinputs.items() if name in ins]
                for k in vinputs:
                    vinputs[k] = [i for i in vinputs[k] if i != name]
                for k in affected:
                    dv = vertices.get(k)
                    if isinstance(dv, LayerVertex) and \
                            hasattr(dv.layer, "n_in"):
                        raise ValueError(
                            f"removeVertexAndConnections('{name}') leaves "
                            f"layer vertex '{k}' without its input; remove "
                            "or replace it too")
                # consumers that lost an input change width (a merge
                # shrinks): the layers downstream re-infer n_in
                for k, _ in downstream_layers(affected):
                    layer = vertices[k].layer
                    if hasattr(layer, "n_in") and layer.n_in:
                        if not conf.input_types:
                            raise ValueError(
                                f"removing '{name}' changes the input width "
                                f"of layer '{k}'; the graph conf needs "
                                "input_types for n_in re-inference")
                        layer.n_in = None
                        reinit.add(k)

            for name, n_out in self._n_out_overrides.items():
                v = vertices.get(name)
                if not isinstance(v, LayerVertex):
                    raise ValueError(f"nOutReplace target '{name}' is not a "
                                     "layer vertex")
                v.layer.n_out = n_out
                reinit.add(name)
                for k, via in downstream_layers([name]):
                    layer = vertices[k].layer
                    if not hasattr(layer, "n_in"):
                        continue
                    if conf.input_types:
                        layer.n_in = None            # re-inferred below
                    elif via == name:
                        layer.n_in = n_out
                    else:
                        raise ValueError(
                            f"nOutReplace('{name}') reaches layer '{k}' "
                            "through non-layer vertices; the graph conf "
                            "needs input_types for n_in re-inference")
                    reinit.add(k)

            for name, vconf, ins in self._added:
                vcopy = copy.deepcopy(vconf)
                if isinstance(vcopy, LayerVertex) and self._fine_tune:
                    self._fine_tune.apply(vcopy.layer)
                vertices[name] = vcopy
                vinputs[name] = list(ins)
                reinit.add(name)

            if self._outputs is not None:
                outputs = list(self._outputs)
            for out in outputs:
                if out not in vertices:
                    raise ValueError(f"Output '{out}' is not a vertex")
            if not outputs:
                raise ValueError("Resulting graph has no outputs (call "
                                 "set_outputs after removing the head)")
            order = topological_sort(vinputs, conf.network_inputs)
            if conf.input_types:
                infer_graph_shapes(vertices, vinputs, conf.network_inputs,
                                   conf.input_types, order)

            frozen = with_ancestors(self._frozen_names, vinputs,
                                     conf.network_inputs, vertices)
            for nm in frozen:
                v = vertices[nm]
                if isinstance(v, LayerVertex):
                    v.layer.learning_rate = 0.0
                    if getattr(v.layer, "bias_learning_rate", None):
                        v.layer.bias_learning_rate = 0.0
            if self._fine_tune:
                for nm, v in vertices.items():
                    if nm not in frozen and nm not in reinit and \
                            isinstance(v, LayerVertex):
                        self._fine_tune.apply(v.layer)

            conf.vertices = vertices
            conf.vertex_inputs = vinputs
            conf.network_outputs = outputs
            conf.topological_order = order
            if self._fine_tune and self._fine_tune.seed is not None:
                conf.seed = self._fine_tune.seed

            new_net = ComputationGraph(conf, src.compute_dtype,
                                       src.device).init()
            for nm in vertices:
                if nm not in reinit and nm in src.params:
                    new_net.params[nm] = _clone_tree(src.params[nm])
                    new_net.state[nm] = _clone_tree(src.state[nm])
            new_net.frozen_vertices = frozen
            return new_net


class TransferLearningHelper:
    """Featurize through a MultiLayerNetwork's frozen layers
    [0, frozen_until] once."""

    def __init__(self, net: MultiLayerNetwork, frozen_until: int):
        self.net = net
        self.frozen_until = int(frozen_until)

    def featurize(self, ds: DataSet) -> DataSet:
        """``ds`` with its features replaced by the frozen layers' output
        (inference mode, as host arrays)."""
        act = self.net._featurize(self.frozen_until + 1, ds.features)
        return DataSet(_to_numpy(act), ds.labels, ds.features_mask,
                       ds.labels_mask)


class GraphTransferLearningHelper:
    """Split a ComputationGraph at its frozen frontier: featurize datasets
    through the frozen vertices once, then train only the unfrozen
    subgraph. ``frozen`` defaults to the graph's ``frozen_vertices`` (set
    by ``TransferLearning.GraphBuilder``); named vertices freeze with their
    ancestors."""

    def __init__(self, graph: ComputationGraph, *frozen: str):
        self.graph = graph
        graph._ensure_init()
        conf = graph.conf
        self.frozen = with_ancestors(frozen, conf.vertex_inputs,
                                      conf.network_inputs) if frozen \
            else set(getattr(graph, "frozen_vertices", set()))
        if not self.frozen:
            raise ValueError("No frozen vertices: pass vertex names or build "
                             "the graph with TransferLearning.GraphBuilder"
                             ".set_feature_extractor")
        # the frozen vertices an unfrozen vertex consumes: the unfrozen
        # subgraph's inputs
        self.frontier: List[str] = []
        for name in conf.topological_order:
            if name in self.frozen:
                continue
            for i in conf.vertex_inputs[name]:
                if (i in self.frozen or i in conf.network_inputs) and \
                        i not in self.frontier:
                    self.frontier.append(i)
        self._unfrozen = self._build_unfrozen()

    def _build_unfrozen(self) -> ComputationGraph:
        src = self.graph
        conf = src.conf
        keep = [n for n in conf.topological_order if n not in self.frozen]
        vinputs = {n: list(conf.vertex_inputs[n]) for n in keep}
        sub = ComputationGraphConfiguration(
            vertices={n: copy.deepcopy(conf.vertices[n]) for n in keep},
            vertex_inputs=vinputs,
            network_inputs=list(self.frontier),
            network_outputs=list(conf.network_outputs),
            topological_order=topological_sort(vinputs, self.frontier),
            seed=conf.seed,
            backprop_type=conf.backprop_type,
            tbptt_fwd_length=conf.tbptt_fwd_length,
            tbptt_back_length=conf.tbptt_back_length,
            lr_policy=conf.lr_policy,
            lr_policy_decay_rate=conf.lr_policy_decay_rate,
            lr_policy_steps=conf.lr_policy_steps,
            lr_policy_power=conf.lr_policy_power,
            max_iterations=conf.max_iterations,
            learning_rate_schedule=conf.learning_rate_schedule)
        net = ComputationGraph(sub, src.compute_dtype, src.device).init()
        for n in keep:
            net.params[n] = _clone_tree(src.params[n])
            net.state[n] = _clone_tree(src.state[n])
        return net

    def unfrozen_graph(self) -> ComputationGraph:
        """The trainable subgraph."""
        return self._unfrozen

    def featurize(self, ds) -> MultiDataSet:
        """One inference pass of the frozen vertices → a MultiDataSet whose
        features are the frontier's activations (host arrays). Feature
        masks follow the frozen vertices to the frontier and label masks
        ride along, so :meth:`fit_featurized` weighs padded cells as
        fitting the whole graph does."""
        import torch

        g = self.graph
        features = list(ds.features) if isinstance(ds, MultiDataSet) \
            else ds.features
        imasks, lmasks = g._masks_of(ds)
        with torch.no_grad():
            acts, _, _, masks, _, _ = g._forward(
                g._cast_params(g.params), g._inference_state(),
                g._inputs_dict(features), input_masks=imasks,
                only=self.frozen)
        labels = ds.labels if isinstance(ds.labels, (list, tuple)) \
            else [ds.labels]
        host = lambda a: None if a is None else \
            (_to_numpy(a) if torch.is_tensor(a) else np.asarray(a))
        fmasks = [host(masks.get(n)) for n in self.frontier]
        lmask_list = None
        if lmasks:
            lmask_list = [host(lmasks.get(n))
                          for n in g.conf.network_outputs]
        return MultiDataSet([host(acts[n]) for n in self.frontier],
                            [host(l) for l in labels],
                            features_masks=fmasks if any(
                                m is not None for m in fmasks) else None,
                            labels_masks=lmask_list)

    def fit_featurized(self, data, num_epochs: int = 1):
        """Train the unfrozen subgraph on featurized data and copy its
        parameters and state back into the whole graph."""
        if isinstance(data, MultiDataSet):
            data = [data]
        self._unfrozen.fit(data, num_epochs)
        for n in self._unfrozen.conf.topological_order:
            self.graph.params[n] = _clone_tree(self._unfrozen.params[n])
            self.graph.state[n] = _clone_tree(self._unfrozen.state[n])
        return self

    def output_from_featurized(self, featurized):
        """Predictions of the unfrozen subgraph from featurized inputs."""
        return self._unfrozen.output(featurized.features
                                     if hasattr(featurized, "features")
                                     else featurized)
