"""The paper's graph algorithms, expressed as BlockAlgorithms."""
from .pagerank import pagerank, pagerank_algorithm
from .sv import shiloach_vishkin, sv_algorithm
from .cc import connected_components, afforest_algorithm
from .bfs import bfs, bfs_algorithm
from .tc import orient_dag, tc_algorithm, triangle_count
from .kcore import k_core, kcore_algorithm
from .hits import hits, hits_algorithm

__all__ = [
    "pagerank", "pagerank_algorithm",
    "shiloach_vishkin", "sv_algorithm",
    "connected_components", "afforest_algorithm",
    "bfs", "bfs_algorithm",
    "triangle_count", "tc_algorithm", "orient_dag",
    "k_core", "kcore_algorithm",
    "hits", "hits_algorithm",
]
