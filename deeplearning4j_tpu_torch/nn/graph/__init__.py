"""ComputationGraph: DAG networks."""

from .graph_config import (ComputationGraphConfiguration, GraphBuilder,
                           infer_graph_shapes, topological_sort)
from .computation_graph import ComputationGraph
from .vertices import (GraphVertexConf, LayerVertex, MergeVertex,
                       ElementWiseVertex, SubsetVertex, StackVertex,
                       UnstackVertex, ScaleVertex, ShiftVertex, L2Vertex,
                       L2NormalizeVertex, PreprocessorVertex,
                       LastTimeStepVertex, DuplicateToTimeSeriesVertex)

__all__ = [
    "ComputationGraphConfiguration", "GraphBuilder", "topological_sort",
    "infer_graph_shapes", "ComputationGraph", "GraphVertexConf",
    "LayerVertex", "MergeVertex", "ElementWiseVertex", "SubsetVertex",
    "StackVertex", "UnstackVertex", "ScaleVertex", "ShiftVertex", "L2Vertex",
    "L2NormalizeVertex", "PreprocessorVertex", "LastTimeStepVertex",
    "DuplicateToTimeSeriesVertex",
]
