"""Graph embeddings (reference deeplearning4j-graph; SURVEY.md §2.6):
IGraph API, random walks, DeepWalk trainer, GraphVectors serialization.
The counterpart of the JAX package's ``graph_embeddings``; DeepWalk's
tables live on ``device`` (``None``: the CUDA card)."""

from .graph import Graph, Vertex, Edge
from .walks import RandomWalkIterator, WeightedWalkIterator
from .deepwalk import DeepWalk, GraphVectorSerializer

__all__ = ["Graph", "Vertex", "Edge", "RandomWalkIterator",
           "WeightedWalkIterator", "DeepWalk", "GraphVectorSerializer"]
