"""The graph algorithms of the first slice, expressed as BlockAlgorithms."""
from .bfs import bfs, bfs_algorithm
from .pagerank import pagerank, pagerank_algorithm
from .tc import orient_dag, tc_algorithm, triangle_count

__all__ = [
    "pagerank", "pagerank_algorithm",
    "bfs", "bfs_algorithm",
    "triangle_count", "tc_algorithm", "orient_dag",
]
