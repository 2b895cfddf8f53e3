"""ComputationGraph: DAG networks."""

from .graph_config import (ComputationGraphConfiguration, GraphBuilder,
                           topological_sort)
from .computation_graph import ComputationGraph
from .vertices import GraphVertexConf, LayerVertex, ElementWiseVertex

__all__ = ["ComputationGraphConfiguration", "GraphBuilder",
           "topological_sort", "ComputationGraph", "GraphVertexConf",
           "LayerVertex", "ElementWiseVertex"]
