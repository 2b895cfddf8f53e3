"""Clustering and space-partitioning trees: the JAX package's
``clustering/`` (reference deeplearning4j-core clustering/: k-means, the
kd / vp trees, quadtree / sptree for t-SNE). The device code (k-means'
Lloyd step, the exact t-SNE gradient, Barnes-Hut t-SNE's kNN and
iterations) runs on ``device`` (``None``: the CUDA card); the trees and
the perplexity searches are the same host numpy."""

from .kmeans import KMeansClustering
from .trees import KDTree, QuadTree, SpTree, VPTree
from .tsne import Tsne
from .bhtsne import BarnesHutTsne

__all__ = ["KMeansClustering", "KDTree", "VPTree", "Tsne",
           "BarnesHutTsne", "QuadTree", "SpTree"]
