"""Graph benchmark suite: synthetic stand-ins for the paper's 44-graph
dataset (SuiteSparse/Konect/SNAP classes), scaled to one host.

The port's copy of ``repro/data/graphs.py``: the same names, generators,
seeds and quadrant probabilities, so that both packages build the same
host arrays."""
from __future__ import annotations

from ..core.graph import Graph, erdos_renyi, grid_road, rmat, star_skew

__all__ = ["benchmark_suite"]


def benchmark_suite(scale: str = "small") -> dict[str, Graph]:
    """Graphs keyed by the paper's seven detailed classes.

    scale: "small" (tests, ~1e4 edges), "bench" (benchmarks, ~1e6 edges).
    """
    if scale == "small":
        return {
            "social": rmat(10, 8, seed=1, name="social"),        # orkut-ish
            "twitter": star_skew(2048, hubs=4, seed=2, name="twitter"),
            "web": rmat(10, 6, a=0.45, b=0.25, c=0.2, seed=3, name="web"),
            "gene": erdos_renyi(4096, 3.0, seed=4, name="gene"),  # kmer-ish
            "road": grid_road(48, name="road"),                   # eu_osm-ish
            "synthA": rmat(9, 16, seed=5, name="myciel-ish"),
            "kron": rmat(10, 16, seed=6, name="kron"),
        }
    return {
        "social": rmat(15, 16, seed=1, name="social"),
        "twitter": star_skew(1 << 15, hubs=6, seed=2, name="twitter"),
        "web": rmat(15, 12, a=0.45, b=0.25, c=0.2, seed=3, name="web"),
        "gene": erdos_renyi(1 << 16, 3.0, seed=4, name="gene"),
        "road": grid_road(256, name="road"),
        "synthA": rmat(14, 24, seed=5, name="myciel-ish"),
        "kron": rmat(15, 16, seed=6, name="kron"),
    }
