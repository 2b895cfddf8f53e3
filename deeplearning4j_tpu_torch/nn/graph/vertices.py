"""Graph vertices (the JAX package's ``nn/graph/vertices.py``):
``LayerVertex`` wraps a layer conf (and its input preprocessor) and owns
its params; the others are parameter-free functions of a LIST of input
activations: ``MergeVertex``, ``ElementWiseVertex``, ``SubsetVertex``,
``StackVertex`` / ``UnstackVertex`` (along the batch axis),
``ScaleVertex``, ``ShiftVertex``, ``L2Vertex``, ``L2NormalizeVertex``,
``PreprocessorVertex`` and the sequence vertices ``LastTimeStepVertex``
and ``DuplicateToTimeSeriesVertex``.

The graph hands every vertex its inputs' masks and gives the vertex's
output its first input's mask, as the JAX graph does."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..conf.input_type import InputType
from ..conf.layers.base import LayerConf
from ..conf.serde import register_config


class GraphVertexConf:
    """Base: parameter-free vertex over a LIST of input activations."""

    def n_inputs(self):
        """The number of inputs the vertex takes (None: any)."""
        return None

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {}

    def init_state(self) -> Dict:
        return {}

    def output_type(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def forward(self, params, state, inputs: List, *, train=False, gen=None,
                masks=None):
        raise NotImplementedError


@register_config
@dataclasses.dataclass
class LayerVertex(GraphVertexConf):
    """Wraps a layer conf; single input, through ``preprocessor`` first
    when one is set."""
    layer: LayerConf = None
    preprocessor: Optional[object] = None

    def n_inputs(self):
        return 1

    def init_params(self, gen, dtype=torch.float32):
        return self.layer.init_params(gen, dtype)

    def init_state(self):
        return self.layer.init_state()

    def output_type(self, input_types):
        it = input_types[0]
        if self.preprocessor is not None:
            it = self.preprocessor.output_type(it)
        return self.layer.get_output_type(it)

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        """The layer on ``inputs[0]``, with ``masks[0]`` (the input's
        [N, T] mask) as its mask: a features mask reaches attention as the
        key mask."""
        x = inputs[0]
        mask = masks[0] if masks else None
        if self.preprocessor is not None:
            x = self.preprocessor.pre_process(x, mask)
            mask = self.preprocessor.feed_forward_mask(mask)
        return self.layer.forward(params, state, x, mask, train=train,
                                  gen=gen)


@register_config
@dataclasses.dataclass
class MergeVertex(GraphVertexConf):
    """Concatenation along the feature (last) axis: features, or channels
    of NHWC activations."""

    def output_type(self, input_types):
        it = input_types[0]
        if it.kind == "ff":
            return InputType.feed_forward(
                sum(t.flat_size() for t in input_types))
        if it.kind == "rnn":
            return InputType.recurrent(sum(t.size for t in input_types),
                                       it.timesteps)
        return InputType.convolutional(
            it.height, it.width, sum(t.channels for t in input_types))

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        return torch.cat(inputs, dim=-1), state


@register_config
@dataclasses.dataclass
class ElementWiseVertex(GraphVertexConf):
    """Pointwise add / subtract / product / average / max of its
    inputs."""
    op: str = "add"

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
        elif op == "subtract":
            out = inputs[0] - inputs[1]
        elif op in ("product", "prod", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
        elif op in ("average", "avg"):
            out = sum(inputs) / len(inputs)
        elif op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
        else:
            raise ValueError(f"Unknown elementwise op {self.op}")
        return out, state


@register_config
@dataclasses.dataclass
class SubsetVertex(GraphVertexConf):
    """Features [from_index, to_index] (inclusive) of the last axis."""
    from_index: int = 0
    to_index: int = 0

    def output_type(self, input_types):
        size = self.to_index - self.from_index + 1
        it = input_types[0]
        if it.kind == "rnn":
            return InputType.recurrent(size, it.timesteps)
        return InputType.feed_forward(size)

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        return inputs[0][..., self.from_index:self.to_index + 1], state


@register_config
@dataclasses.dataclass
class StackVertex(GraphVertexConf):
    """Its inputs stacked along the batch axis: [k·N, ...]."""

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        return torch.cat(inputs, dim=0), state


@register_config
@dataclasses.dataclass
class UnstackVertex(GraphVertexConf):
    """Batch slice ``index`` of ``num_stacks`` equal slices."""
    index: int = 0
    num_stacks: int = 1

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        x = inputs[0]
        size = x.shape[0] // self.num_stacks
        return x[self.index * size:(self.index + 1) * size], state


@register_config
@dataclasses.dataclass
class ScaleVertex(GraphVertexConf):
    """Multiplication by a fixed scalar."""
    scale: float = 1.0

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        return inputs[0] * self.scale, state


@register_config
@dataclasses.dataclass
class ShiftVertex(GraphVertexConf):
    """Addition of a fixed scalar."""
    shift: float = 0.0

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        return inputs[0] + self.shift, state


@register_config
@dataclasses.dataclass
class L2Vertex(GraphVertexConf):
    """Euclidean distance between two inputs, per example: [N, 1]."""
    eps: float = 1e-8

    def output_type(self, input_types):
        return InputType.feed_forward(1)

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        a, b = inputs
        d = a - b
        sq = (d * d).sum(dim=tuple(range(1, d.dim())))
        return torch.sqrt(sq + self.eps)[:, None], state


@register_config
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertexConf):
    """Each example scaled to unit L2 norm over all its features."""
    eps: float = 1e-8

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        x = inputs[0]
        sq = (x * x).sum(dim=tuple(range(1, x.dim())), keepdim=True)
        return x / torch.sqrt(sq + self.eps), state


@register_config
@dataclasses.dataclass
class PreprocessorVertex(GraphVertexConf):
    """An input preprocessor as a vertex of its own."""
    preprocessor: object = None

    def output_type(self, input_types):
        return self.preprocessor.output_type(input_types[0])

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        return self.preprocessor.pre_process(inputs[0]), state


@register_config
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertexConf):
    """[N, T, F] → [N, F]: each row's last present timestep, index
    max(Σ mask − 1, 0) under the input's mask, T − 1 without one.
    ``mask_input`` names the network input whose mask applies (the graph
    hands the vertex its own input's mask, as the JAX graph does)."""
    mask_input: Optional[str] = None

    def output_type(self, input_types):
        return InputType.feed_forward(input_types[0].size)

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        x = inputs[0]
        mask = masks[0] if masks else None
        if mask is None:
            return x[:, -1, :], state
        idx = (mask.to(torch.int32).sum(dim=1) - 1).clamp_min(0).long()
        return x[torch.arange(x.shape[0], device=x.device), idx], state


@register_config
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertexConf):
    """[N, F] → [N, T, F], the features repeated over the time axis of the
    second input (``ts_input`` names it), which supplies T."""
    ts_input: Optional[str] = None

    def output_type(self, input_types):
        t = input_types[1].timesteps if len(input_types) > 1 else None
        return InputType.recurrent(input_types[0].flat_size(), t)

    def forward(self, params, state, inputs, *, train=False, gen=None,
                masks=None):
        x, ref = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], ref.shape[1],
                                    x.shape[-1]), state
