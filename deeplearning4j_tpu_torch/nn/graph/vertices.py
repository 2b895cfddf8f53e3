"""Graph vertices on the transformer-LM path (the JAX package's
``nn/graph/vertices.py``): LayerVertex wraps a layer conf and owns its
params; ElementWiseVertex adds the residual stream."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..conf.layers.base import LayerConf
from ..conf.serde import register_config


class GraphVertexConf:
    """Base: parameter-free vertex over a LIST of input activations."""

    def init_params(self, gen, dtype=torch.float32) -> Dict:
        return {}

    def init_state(self) -> Dict:
        return {}

    def forward(self, params, state, inputs: List):
        raise NotImplementedError


@register_config
@dataclasses.dataclass
class LayerVertex(GraphVertexConf):
    """Wraps a layer conf; single input. Input preprocessors are not
    ported (the transformer LM has none), so a non-None one raises."""
    layer: LayerConf = None
    preprocessor: Optional[object] = None

    def init_params(self, gen, dtype=torch.float32):
        return self.layer.init_params(gen, dtype)

    def init_state(self):
        return self.layer.init_state()

    def forward(self, params, state, inputs):
        if self.preprocessor is not None:
            raise NotImplementedError("input preprocessors are not ported")
        return self.layer.forward(params, state, inputs[0])


@register_config
@dataclasses.dataclass
class ElementWiseVertex(GraphVertexConf):
    """Pointwise combination of its inputs; the port implements ``add``."""
    op: str = "add"

    def forward(self, params, state, inputs):
        if self.op.lower() != "add":
            raise NotImplementedError(f"ElementWiseVertex op '{self.op}' is "
                                      "not ported (only 'add')")
        out = inputs[0]
        for x in inputs[1:]:
            out = out + x
        return out, state
