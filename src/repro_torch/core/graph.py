"""Graph containers, generators and I/O (host side, numpy).

Host-side (numpy) graph representation.  The paper's I/O handler reads
ASCII edge lists in parallel (PIGO) and caches a custom binary format; we
mirror that with a numpy-based edge-list reader and an ``.npz`` binary
cache that is ~2 orders of magnitude faster to re-load.

All graphs are stored as CSR over ``int32`` vertex ids.  PGAbB's
preprocessing (paper §5.1) is reproduced: symmetrize (make undirected),
remove duplicate edges and self loops.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Graph",
    "from_edges",
    "read_edge_list",
    "load_binary",
    "save_binary",
    "rmat",
    "erdos_renyi",
    "grid_road",
    "star_skew",
    "degree_order",
    "csr_prefix",
]


@dataclass(frozen=True)
class Graph:
    """CSR graph.  ``indptr``/``indices`` follow scipy conventions."""

    indptr: np.ndarray      # (n+1,) int64
    indices: np.ndarray     # (m,)  int32, sorted within each row
    n: int
    directed: bool = False
    name: str = "graph"
    # cached degree array (out-degree == degree for undirected graphs)
    _degrees: np.ndarray | None = field(default=None, repr=False, compare=False)

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_edges_undirected(self) -> int:
        return self.m // (1 if self.directed else 2)

    @property
    def degrees(self) -> np.ndarray:
        d = np.diff(self.indptr).astype(np.int64)
        return d

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    def coo(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (src, dst) arrays of all stored edges."""
        src = np.repeat(np.arange(self.n, dtype=np.int32), self.degrees)
        return src, self.indices.astype(np.int32)

    def checksum(self) -> str:
        h = hashlib.sha1()
        h.update(self.indptr.tobytes())
        h.update(self.indices.tobytes())
        return h.hexdigest()[:12]


# ---------------------------------------------------------------------------
# construction


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n: int | None = None,
    *,
    symmetrize: bool = True,
    name: str = "graph",
) -> Graph:
    """Build a CSR graph from an edge list.

    Reproduces the paper's preprocessing: optional symmetrization,
    duplicate-edge and self-loop removal, sorted adjacency.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1) if src.size else 0
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keep = src != dst  # drop self loops
    src, dst = src[keep], dst[keep]
    # dedup via linearized sort
    lin = src * np.int64(n) + dst
    lin = np.unique(lin)
    src = (lin // n).astype(np.int64)
    dst = (lin % n).astype(np.int32)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return Graph(indptr=indptr, indices=dst, n=n, directed=not symmetrize, name=name)


def read_edge_list(path: str, *, symmetrize: bool = True, comments: str = "#%") -> Graph:
    """PIGO-style ASCII edge-list reader (whitespace separated ``u v`` lines).

    Vectorized: ``np.loadtxt`` parses the whole file in one pass (blank
    lines skipped, any of the ``comments`` characters starts a comment,
    trailing columns such as edge weights ignored).  Falls back to a
    line-by-line parse only for ragged files loadtxt rejects.
    """
    name = os.path.splitext(os.path.basename(path))[0]
    try:
        arr = np.loadtxt(path, dtype=np.int64, comments=list(comments),
                         usecols=(0, 1), ndmin=2)
    except (ValueError, IndexError):
        with open(path, "rb") as f:
            text = f.read().decode("utf-8", errors="ignore")
        rows = [
            tuple(map(int, ln.split()[:2]))
            for ln in text.splitlines()
            if ln.strip() and ln.lstrip()[0] not in comments
        ]
        arr = np.asarray(rows, dtype=np.int64).reshape(-1, 2)
    return from_edges(arr[:, 0], arr[:, 1], symmetrize=symmetrize, name=name)


def save_binary(g: Graph, path: str) -> None:
    """Custom binary cache (paper §4.2): one mmap-able npz.

    Written atomically: savez always appends ``.npz`` to a name without
    it, so write to a deterministic ``<path>.tmp.npz`` and always
    ``os.replace`` onto the destination (no stale temp files, no
    missed rename).
    """
    tmp = path + ".tmp"
    np.savez(tmp, indptr=g.indptr, indices=g.indices, n=np.int64(g.n),
             directed=np.int8(g.directed))
    os.replace(tmp + ".npz", path)


def load_binary(path: str, name: str = "graph") -> Graph:
    z = np.load(path)
    return Graph(indptr=z["indptr"], indices=z["indices"], n=int(z["n"]),
                 directed=bool(z["directed"]), name=name)


def csr_prefix(indptr: np.ndarray, indices: np.ndarray,
               k: int) -> tuple[np.ndarray, np.ndarray]:
    """First-``k``-neighbors CSR: a vertex-proportional adjacency sample.

    Returns ``(prefix_indptr, prefix_indices)`` where
    ``prefix_indptr[u] = u * k`` and ``prefix_indices[u*k + r]`` is the
    ``r``-th neighbor of ``u`` for ``r < degree(u)`` (zero-filled past
    the degree — callers must keep the ``r < degree`` guard they already
    need for the global CSR).  The streaming executor substitutes this
    for the full adjacency during ``edge_free_iterations`` (e.g.
    Afforest's neighbor-sampling rounds), so those rounds cost
    ``n * k`` staged entries instead of keeping all ``m`` device-resident.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    k = int(k)
    if k <= 0 or n <= 0:
        return np.zeros(max(n + 1, 1), np.int64), np.zeros(0, np.int32)
    prefix_indptr = np.arange(n + 1, dtype=np.int64) * k
    m = int(indices.shape[0])
    pos = indptr[:-1, None] + np.arange(k, dtype=np.int64)[None, :]
    valid = np.arange(k, dtype=np.int64)[None, :] < np.diff(indptr)[:, None]
    if m:
        vals = np.asarray(indices)[np.clip(pos, 0, m - 1)]
    else:
        vals = np.zeros((n, k), np.int32)
    prefix_indices = np.where(valid, vals, 0).astype(np.int32).ravel()
    return prefix_indptr, prefix_indices


# ---------------------------------------------------------------------------
# synthetic generators (benchmark suite stand-ins for the paper's 44 graphs)


def rmat(scale: int, edge_factor: int = 16, *, a=0.57, b=0.19, c=0.19,
         seed: int = 0, name: str | None = None) -> Graph:
    """R-MAT / Kronecker generator (kron21-style skewed synthetic graph)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        src_bit = r >= ab
        # conditional column probability within chosen row half
        r2 = rng.random(m)
        dst_bit = np.where(src_bit, r2 >= (c / max(1e-12, 1.0 - ab)), r2 >= (b / max(1e-12, ab)))
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # random vertex permutation to avoid locality artifacts
    perm = rng.permutation(n)
    return from_edges(perm[src], perm[dst], n=n, name=name or f"rmat{scale}")


def erdos_renyi(n: int, avg_degree: float = 8.0, *, seed: int = 0,
                name: str | None = None) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return from_edges(src, dst, n=n, name=name or f"er{n}")


def grid_road(side: int, *, name: str | None = None) -> Graph:
    """2-D grid — a road-network (eu_osm-like) stand-in: huge diameter, degree≤4."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).astype(np.int64)
    right = np.stack([vid[:, :-1].ravel(), vid[:, 1:].ravel()], 1)
    down = np.stack([vid[:-1, :].ravel(), vid[1:, :].ravel()], 1)
    e = np.concatenate([right, down])
    return from_edges(e[:, 0], e[:, 1], n=n, name=name or f"road{side}x{side}")


def star_skew(n: int, hubs: int = 4, *, seed: int = 0, name: str | None = None) -> Graph:
    """Extreme-skew graph (twitter7-like): a few hubs connected to everyone."""
    rng = np.random.default_rng(seed)
    hub_ids = rng.choice(n, hubs, replace=False)
    src = np.repeat(hub_ids, n // hubs)
    dst = rng.integers(0, n, src.shape[0])
    extra_s = rng.integers(0, n, n)
    extra_d = rng.integers(0, n, n)
    return from_edges(np.concatenate([src, extra_s]), np.concatenate([dst, extra_d]),
                      n=n, name=name or f"star{n}")


def degree_order(g: Graph, *, ascending: bool = True) -> tuple[Graph, np.ndarray]:
    """Relabel vertices by degree (paper §5.4 enables degree ordering for TC).

    Returns the relabeled graph and the permutation ``perm`` with
    ``new_id = perm[old_id]``.
    """
    order = np.argsort(g.degrees, kind="stable")
    if not ascending:
        order = order[::-1]
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    src, dst = g.coo()
    return from_edges(perm[src], perm[dst], n=g.n, symmetrize=not g.directed,
                      name=g.name + "+deg"), perm
