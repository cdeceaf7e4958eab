"""Block storage data structures (paper §4.3.2).

The paper stores each block as a CSR/COO/CCOO subgraph.  The port keeps
the reference package's flat layout:

* **Segmented COO** — every edge appears once, sorted by (block id, src,
  dst); ``block_ptr`` delimits each block's contiguous edge segment.
* **Conformal row slices** — because the partition is conformal (one
  shared cut vector), the portion of vertex ``u``'s adjacency that falls
  in column stripe ``k`` is a *contiguous slice* of the global CSR row.
  ``row_block_ptr[u, k]`` gives its start.
* **Dense bitmap tiles** — blocks selected by the scheduler's density
  cut-off are additionally materialized as 0/1 tiles of a fixed
  ``tile_dim`` for the dense (K_D) kernels.

All arrays are numpy on the host; :meth:`BlockStore.to_device` converts
what the kernels need to torch tensors once, narrowing the int64 arrays
to int32 (and raising if a value does not fit).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from .graph import Graph
from .partition import Layout, make_layout

__all__ = ["BlockStore", "build_block_store"]

_I32 = np.iinfo(np.int32)


def _to_int32(name: str, a: np.ndarray) -> np.ndarray:
    """Narrow an integer array to int32, raising if a value does not fit."""
    if a.dtype == np.int32:
        return a
    if a.size and (int(a.max()) > _I32.max or int(a.min()) < _I32.min):
        raise OverflowError(
            f"BlockStore.{name} holds values outside int32 "
            f"[{int(a.min())}, {int(a.max())}]; the device layout is int32")
    return a.astype(np.int32)


@dataclass
class BlockStore:
    graph: Graph
    layout: Layout

    # --- segmented COO (sorted by block, then src, then dst) ---
    src: np.ndarray          # (m,) int32 global source ids
    dst: np.ndarray          # (m,) int32 global dest ids
    edge_block: np.ndarray   # (m,) int32 block id of each edge
    block_ptr: np.ndarray    # (nb+1,) int64 edge segment offsets per block id

    # --- conformal row slicing over the (degree-ordered) global CSR ---
    indptr: np.ndarray       # (n+1,) int64
    indices: np.ndarray      # (m,) int32 sorted adjacency
    row_block_ptr: np.ndarray  # (n, p+1) int64: indptr[u] + offset of stripe k

    # --- dense bitmap tiles (filled by the scheduler's dense selection) ---
    tile_dim: int = 0
    tile_block_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    tiles: np.ndarray = field(default_factory=lambda: np.zeros((0, 0, 0), np.float32))
    tile_row_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    tile_col_start: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    # device copies, one dict per device; cleared when the tiles change
    _device_cache: dict = field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def p(self) -> int:
        return self.layout.p

    @cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def block_edges(self, block_id: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.block_ptr[block_id], self.block_ptr[block_id + 1]
        return self.src[s:e], self.dst[s:e]

    def block_density(self, block_id: int) -> float:
        i, j = divmod(block_id, self.p)
        r = self.layout.cuts[i + 1] - self.layout.cuts[i]
        c = self.layout.cuts[j + 1] - self.layout.cuts[j]
        e = self.block_ptr[block_id + 1] - self.block_ptr[block_id]
        return float(e) / float(max(r * c, 1))

    def block_range(self, block_id: int) -> tuple[int, int]:
        i, j = divmod(block_id, self.p)
        return (
            int(self.layout.cuts[i + 1] - self.layout.cuts[i]),
            int(self.layout.cuts[j + 1] - self.layout.cuts[j]),
        )

    # ------------------------------------------------------------------
    def materialize_tiles(self, block_ids: np.ndarray, tile_dim: int) -> None:
        """Pack the selected blocks as dense 0/1 tiles of shape (tile_dim²).

        Blocks whose vertex ranges exceed ``tile_dim`` are the caller's
        bug — the scheduler only selects blocks that fit.
        """
        block_ids = np.asarray(block_ids, dtype=np.int32)
        nd = block_ids.shape[0]
        tiles = np.zeros((nd, tile_dim, tile_dim), dtype=np.float32)
        row_start = np.zeros(nd, dtype=np.int64)
        col_start = np.zeros(nd, dtype=np.int64)
        for t, b in enumerate(block_ids):
            i, j = divmod(int(b), self.p)
            r0, c0 = self.layout.cuts[i], self.layout.cuts[j]
            rr, cc = self.block_range(int(b))
            if rr > tile_dim or cc > tile_dim:
                raise ValueError(
                    f"block {b} range ({rr},{cc}) exceeds tile_dim {tile_dim}"
                )
            es, ed = self.block_edges(int(b))
            tiles[t, es - r0, ed - c0] = 1.0
            row_start[t], col_start[t] = r0, c0
        self.tile_dim = tile_dim
        self.tile_block_ids = block_ids
        self.tiles = tiles
        self.tile_row_start = row_start
        self.tile_col_start = col_start
        self._device_cache.clear()

    # ------------------------------------------------------------------
    def to_device(self, device) -> dict[str, torch.Tensor]:
        """Torch tensors of the store on ``device``, built once per device.

        The int64 host arrays (``indptr``, ``row_block_ptr``,
        ``degrees``, the tile starts) are narrowed to int32 on purpose;
        a value that does not fit raises :class:`OverflowError`.  On the
        CPU the tensors share memory with the numpy arrays.
        """
        device = torch.device(device)
        key = str(device)
        cached = self._device_cache.get(key)
        if cached is not None:
            return cached

        def put(name: str, a: np.ndarray) -> torch.Tensor:
            a = np.ascontiguousarray(a)
            if np.issubdtype(a.dtype, np.integer):
                a = _to_int32(name, a)
            return torch.from_numpy(a).to(device)

        out = dict(
            src=put("src", self.src),
            dst=put("dst", self.dst),
            edge_block=put("edge_block", self.edge_block),
            indptr=put("indptr", self.indptr),
            indices=put("indices", self.indices),
            degrees=put("degrees", self.degrees),
            row_block_ptr=put("row_block_ptr", self.row_block_ptr),
            cuts=put("cuts", self.layout.cuts),
        )
        if self.tile_block_ids.size:
            out.update(
                tiles=put("tiles", self.tiles),
                tile_row_start=put("tile_row_start", self.tile_row_start),
                tile_col_start=put("tile_col_start", self.tile_col_start),
            )
        self._device_cache[key] = out
        return out


def build_block_store(g: Graph, p: int, *, order: str = "row_major") -> BlockStore:
    """Partition ``g`` with the symmetric rectilinear partitioner and pack blocks."""
    n = g.n
    # the (block, src, dst) sort key below is linear in p²·n²
    if p * p * n * n >= 2**63:
        raise OverflowError(
            f"p={p}, n={n}: the (block, src, dst) sort key p²·n² overflows int64")
    layout = make_layout(g, p, order=order)
    src, dst = g.coo()
    src = src.astype(np.int64)
    dst64 = dst.astype(np.int64)
    bi = np.searchsorted(layout.cuts, src, side="right") - 1
    bj = np.searchsorted(layout.cuts, dst64, side="right") - 1
    bid = (bi * p + bj).astype(np.int64)
    # sort by (block, src, dst) — cheap radix via linearization
    key = (bid * n + src) * n + dst64
    order_idx = np.argsort(key, kind="stable")
    src_s = src[order_idx].astype(np.int32)
    dst_s = dst64[order_idx].astype(np.int32)
    bid_s = bid[order_idx].astype(np.int32)
    nb = p * p
    block_ptr = np.zeros(nb + 1, dtype=np.int64)
    block_ptr[1:] = np.bincount(bid_s, minlength=nb)
    np.cumsum(block_ptr, out=block_ptr)

    # conformal row slicing: offsets of each column stripe inside each CSR
    # row.  counts[u, k] = #neighbors of u in column stripe k; prefix over
    # k gives the slice starts.
    row_block_ptr = np.empty((n, p + 1), dtype=np.int64)
    row_block_ptr[:, 0] = g.indptr[:-1]
    if g.m:
        stripe = np.searchsorted(layout.cuts, g.indices.astype(np.int64),
                                 side="right") - 1
        counts = np.bincount(src * p + stripe, minlength=n * p).reshape(n, p)
        np.cumsum(counts, axis=1, out=counts)
        row_block_ptr[:, 1:] = g.indptr[:-1, None] + counts
    else:
        row_block_ptr[:, 1:] = g.indptr[:-1, None]

    return BlockStore(
        graph=g,
        layout=layout,
        src=src_s,
        dst=dst_s,
        edge_block=bid_s,
        block_ptr=block_ptr,
        indptr=g.indptr.astype(np.int64),
        indices=g.indices.astype(np.int32),
        row_block_ptr=row_block_ptr,
    )
