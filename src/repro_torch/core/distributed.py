"""Multi-device execution of block algorithms: one controller, D shards.

The paper runs tasks concurrently on CPU threads and GPU streams of one
node.  On a device mesh the analog is a ``blocks`` axis: the scheduler
LPT-packs tasks onto the mesh's shards, each shard processes its own
contiguous (padded) edge partition on its own device, and the global
vertex attributes are folded with the algorithm's declared combine op
(``metadata["combine"]``): ``add`` for additive attributes (PageRank
ranks, triangle counts), ``min``/``max`` for hook and label attributes
(SV, CC, BFS parents).  Attribute arrays are replicated (reads are
free); edge work is sharded and writes are reduced.

**One controller.**  The reference runs the shards under ``shard_map``:
one Python process holds every device of the mesh and XLA inserts
``psum``/``pmin``/``pmax``.  The port keeps that single-controller
model.  One process drives every shard in turn, each shard's kernels
launch on its own device's current stream, and the collective is
explicit code in plain torch ops, since no Pallas kernel did that work:

1. each shard's partial goes to shard 0's device (a peer copy between
   cards, which PyTorch orders against both devices' streams);
2. there, ``add`` leaves reduce as ``Σ_d partial_d`` in shard order
   0, 1, ..., D-1 (the reference's "psum on the delta": the executors
   hand in ``new_d - base`` and add the base back), and ``min``/``max``
   leaves reduce elementwise;
3. every other distinct device receives the folded state as its copy of
   the next read (the iteration-start state of the streaming executor,
   the next ``step`` here).

The fixed shard order makes float results reproducible run to run.  No
``torch.distributed`` process group, NCCL rank or subprocess is
involved: a multi-process group cannot place two shards on one card,
and tests that open sockets or wait on ranks hang or collide under a
parallel test runner.  Shards may share a device only when the caller
lists that device more than once (``DeviceMesh(["cpu"] * 8)``,
``DeviceMesh(["cuda:0"] * 2)``); a mesh is never placed silently.

:func:`make_device_edge_partition` turns an LPT schedule into the padded
per-shard COO (and, on request, conformal-CSR) slabs.  It is shared by
:class:`DistributedEngine` (whole graph, resident) and by the
mesh-cooperative streaming executor (:mod:`repro_torch.core.stream`),
which calls it once per wave with a wave-local assignment and
bucket-ladder padding.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .blocks import BlockStore
from .scheduler import Schedule

__all__ = ["DeviceMesh", "DistributedEngine", "combine", "make_device_edge_partition",
           "replicate"]

COMBINE_KINDS = ("add", "min", "max")


class DeviceMesh:
    """A 1-D mesh of shards, one ``torch.device`` per shard: the port's
    counterpart of a 1-D ``jax.sharding.Mesh`` with axis ``"blocks"``.

    A device listed twice holds two shards.  ``"cuda"`` without an index
    is refused (a shard's card is named, never guessed), and a CUDA
    device that does not exist raises."""

    axis_names = ("blocks",)

    def __init__(self, devices: Sequence["str | torch.device"]) -> None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a DeviceMesh needs at least one device")
        for d in devs:
            if d.type == "cuda":
                if d.index is None:
                    raise ValueError("name each shard's card: 'cuda:<index>', not 'cuda'")
                have = torch.cuda.device_count() if torch.cuda.is_available() else 0
                if d.index >= have:
                    raise RuntimeError(f"the mesh asks for {d} but {have} CUDA device(s) exist")
            elif d.type != "cpu":
                raise ValueError(f"mesh devices must be cpu or cuda; got {d}")
        self.devices = devs

    @classmethod
    def cuda(cls, n: int) -> "DeviceMesh":
        """``cuda:0 … cuda:n-1``, one shard each; raises if fewer cards exist."""
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if int(n) < 1 or int(n) > have:
            raise RuntimeError(f"DeviceMesh.cuda({n}) needs {n} CUDA devices; {have} exist")
        return cls([torch.device("cuda", i) for i in range(int(n))])

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The distinct devices, in first-shard order (shard 0's first)."""
        return tuple(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def device_scope(device: torch.device):
    """Make ``device`` the current CUDA device for a shard's launches
    (a no-op context on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def replicate(tree: Any, devices: Sequence[torch.device]) -> dict:
    """``{device: tree on device}`` for each distinct device: one copy
    per card, shared by the shards on it.  Leaves already on a device
    are not copied there."""
    def put(t, dev):
        if isinstance(t, dict):
            return {k: put(v, dev) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(put(v, dev) for v in t)
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    return {dev: put(tree, dev) for dev in dict.fromkeys(devices)}


def combine(kind: str, partials: Sequence[torch.Tensor],
            base: torch.Tensor | None = None) -> torch.Tensor:
    """Fold per-shard partials on shard 0's device, in shard order.

    ``add``: ``Σ_d partials[d]``, or ``base + Σ_d (partials[d] - base)``
    when ``base`` is given (the psum on the delta, so a replicated base
    is not counted D times).  ``min``/``max``: elementwise over the
    partials.  The result lies on ``partials[0]``'s device."""
    if kind not in COMBINE_KINDS:
        raise ValueError(f"unknown combine kind {kind!r}")
    dev = partials[0].device
    parts = [p.to(dev) for p in partials]
    if kind == "add":
        if base is not None:
            parts = [p - base for p in parts]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total if base is None else base + total
    op = torch.minimum if kind == "min" else torch.maximum
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    return out


def make_device_edge_partition(
    store: BlockStore, sched: Schedule, *,
    assignment: np.ndarray | None = None,
    num_devices: int | None = None,
    bucket: bool = False,
    stage_csr: bool = False,
    alloc: Callable[..., np.ndarray] | None = None,
) -> dict[str, Any]:
    """Partition a schedule's tasks into padded per-shard slabs.

    A shard's edge set is the union of every block of each of its
    assigned tasks, deduplicated within the shard.  Across shards a
    block may be staged twice when tasks of two shards share it:
    harmless for pattern-mode algorithms (their kernels drive work from
    ``prepare`` items), impossible for bulk/activation composition (one
    block per task).  Padding is ``src = dst = edge_block = 0`` with
    ``valid = False``.

    ``assignment`` is the per-task shard id (default: the schedule's LPT
    ``device_assignment``); ``num_devices`` the mesh size (default: the
    schedule's).  ``bucket`` pads the slab width up the power-of-two
    bucket ladder, so every wave of a plan shares a few slab shapes.
    ``alloc(shape, dtype)`` supplies the large slabs (the streaming
    executor's pooled, possibly pinned, buffers); their contents may be
    undefined, since every element is written here.  ``stage_csr`` adds
    each shard's conformal CSR row slices: ``indices`` (a padded
    ``[D, C]`` slab), ``csr_entries``/``csr_segments`` and ``csr_maps``
    (the shard-rebased ``(row_block_ptr, indptr)`` pair ``prepare``
    needs to address its shard's slice).

    Returns ``dict(src, dst, edge_block, valid, blocks, edges, segments,
    ...)``: ``[D, E]`` int32/bool slabs plus per-shard block ids and
    true edge counts.
    """
    from .membudget import bucket_size

    d = int(num_devices) if num_devices is not None else sched.num_devices
    assign = (np.asarray(assignment, dtype=np.int64) if assignment is not None
              else sched.device_assignment)
    if assign.shape[0] != sched.num_tasks:
        raise ValueError(f"assignment covers {assign.shape[0]} tasks, schedule has "
                         f"{sched.num_tasks}")
    blocks = [np.unique(sched.blocklists[assign == i]).astype(np.int64)
              if (assign == i).any() else np.zeros(0, np.int64) for i in range(d)]
    idx = []
    seg_counts = []
    for bl in blocks:
        segs = store.edge_segments(bl)
        seg_counts.append(len(segs))
        idx.append(np.concatenate([np.arange(s, e, dtype=np.int64) for s, e in segs])
                   if segs else np.zeros(0, np.int64))
    emax = max((int(x.shape[0]) for x in idx), default=1) or 1
    eb = bucket_size(emax) if bucket else emax
    alloc = alloc or np.empty
    src = alloc((d, eb), np.int32)
    dst = alloc((d, eb), np.int32)
    edge_block = alloc((d, eb), np.int32)
    valid = alloc((d, eb), np.bool_)
    for i, ix in enumerate(idx):
        k = ix.shape[0]
        src[i, :k] = store.src[ix]
        dst[i, :k] = store.dst[ix]
        edge_block[i, :k] = store.edge_block[ix]
        valid[i, :k] = True
        for a in (src, dst, edge_block, valid):
            a[i, k:] = 0
    out: dict[str, Any] = dict(src=src, dst=dst, edge_block=edge_block, valid=valid,
                               blocks=blocks, edges=[int(x.shape[0]) for x in idx],
                               segments=seg_counts)
    if stage_csr:
        slices = [store.csr_slices(bl) for bl in blocks]
        cmax = max((int(s[0].shape[0]) for s in slices), default=1) or 1
        cb = bucket_size(cmax) if bucket else cmax
        indices = alloc((d, cb), np.int32)
        for i, (sl, _, _, _) in enumerate(slices):
            indices[i, :sl.shape[0]] = sl
            indices[i, sl.shape[0]:] = 0
        out.update(indices=indices,
                   csr_entries=[int(s[0].shape[0]) for s in slices],
                   csr_segments=[len(s[3]) for s in slices],
                   csr_maps=[(s[1], s[2]) for s in slices])
    return out


class DistributedEngine:
    """Run a bulk-synchronous block algorithm over a :class:`DeviceMesh`.

    The algorithm provides ``edge_update(src, dst, valid, state) ->
    state``, the per-shard body (it sees only its shard's edges, as
    tensors on the shard's device, and the state replicated there), and
    a ``combine`` kind for each state leaf: one kind for all, or a dict
    keyed by leaf name (missing keys fold as ``add``).  ``step`` returns
    the folded state on shard 0's device.  ``mesh`` defaults to
    ``DeviceMesh.cuda(sched.num_devices)``."""

    def __init__(self, store: BlockStore, sched: Schedule, edge_update: Callable,
                 combine: "str | dict[str, str]" = "add",
                 mesh: DeviceMesh | None = None) -> None:
        if mesh is None:
            mesh = DeviceMesh.cuda(sched.num_devices)
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh; got {type(mesh).__name__}")
        if mesh.size != sched.num_devices:
            raise ValueError(f"the schedule packs {sched.num_devices} devices, the mesh "
                             f"has {mesh.size} shards")
        self.mesh = mesh
        self.combine = combine
        self.edge_update = edge_update
        part = make_device_edge_partition(store, sched)
        self.src, self.dst, self.valid = (
            [torch.from_numpy(np.ascontiguousarray(part[k][i])).to(dev)
             for i, dev in enumerate(mesh.devices)]
            for k in ("src", "dst", "valid"))

    def _kind(self, key: str) -> str:
        return self.combine if isinstance(self.combine, str) else self.combine.get(key, "add")

    def step(self, state: dict) -> dict:
        reps = replicate(state, self.mesh.devices)
        news = []
        for i, dev in enumerate(self.mesh.devices):
            with device_scope(dev):
                news.append(self.edge_update(self.src[i], self.dst[i], self.valid[i],
                                             reps[dev]))
        base = reps[self.mesh.devices[0]]
        out = {}
        for key in news[0]:
            kind = self._kind(key)
            out[key] = combine(kind, [new[key] for new in news],
                               base[key] if kind == "add" else None)
        return out
