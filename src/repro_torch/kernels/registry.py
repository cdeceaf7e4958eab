"""Kernel registry of the port: the hand-written kernels by name, their
launch counts, and the per-kernel workspace estimators.

There is no fallback chain.  A kernel runs where its tensors lie: CPU
tensors take the plain PyTorch version (:mod:`repro_torch.kernels.ref`),
CUDA tensors launch the hand-written CUDA kernel or raise.  Nothing
degrades quietly from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Callable

from . import ref
from .flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_cuda, flash_attention_cuda,
)
from .frontier_tiles import frontier_tiles, frontier_tiles_cuda
from .spmv_ell import spmv_ell, spmv_ell_cuda
from .spmv_tiles import spmv_tiles, spmv_tiles_cuda
from .tc_tiles import tc_tiles, tc_tiles_cuda

__all__ = [
    "BACKENDS", "KERNELS", "get_kernel", "launch_counts", "reset_launch_counts",
    "register_workspace", "workspace_bytes", "max_workspace_bytes",
    "registered_workspaces", "register_host_executable", "host_executable",
    "registered_host_executable",
]

#: ``None`` (dispatch by device) or one of these pins an implementation.
BACKENDS = ("cuda", "plain")

#: name → (device-dispatching wrapper, CUDA kernel alone, plain version)
KERNELS: dict[str, tuple[Callable, Callable, Callable]] = {
    "spmv_tiles": (spmv_tiles, spmv_tiles_cuda, ref.spmv_tiles_ref),
    "frontier_tiles": (frontier_tiles, frontier_tiles_cuda, ref.frontier_tiles_ref),
    "tc_tiles": (tc_tiles, tc_tiles_cuda, ref.tc_tiles_idx_ref),
    "spmv_ell": (spmv_ell, spmv_ell_cuda, ref.spmv_ell_ref),
    "flash_attention": (flash_attention, flash_attention_cuda, ref.attention_ref),
    "flash_attention_bwd": (flash_attention_bwd, flash_attention_bwd_cuda,
                            ref.attention_bwd_ref),
}


def get_kernel(name: str, backend: str | None = None) -> Callable:
    """Kernel ``name``: by default the wrapper that dispatches on the
    tensors' device; ``"cuda"`` the CUDA kernel alone (raises for a
    tensor that is not on a card); ``"plain"`` the plain version on any
    device (the oracle the kernel is held against)."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    wrapper, cuda, plain = KERNELS[name]
    return {None: wrapper, "cuda": cuda, "plain": plain}[backend]


def launch_counts() -> dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {name: fns[1].launches for name, fns in KERNELS.items()}


def reset_launch_counts() -> None:
    for _, cuda, _ in KERNELS.values():
        cuda.launches = 0


# ----------------------------------------------------------------------
# Host-executable capability: kernel names certified to run on the host
# CPU lane of the streaming executor.  The lane's unit contexts hold CPU
# tensors, so these names dispatch there to their plain versions by the
# tensors' device.  An algorithm that names an uncertified kernel in
# metadata["host_kernels"] stays device-only.
_HOST_OK: set[str] = set(ref.HOST_EXECUTABLE)


def register_host_executable(name: str) -> None:
    """Certify kernel ``name`` as host-executable (see above)."""
    _HOST_OK.add(str(name))


def host_executable(name: str) -> bool:
    """Whether ``name`` is certified to run on the host CPU lane."""
    return str(name) in _HOST_OK


def registered_host_executable() -> tuple[str, ...]:
    """Sorted names currently certified host-executable."""
    return tuple(sorted(_HOST_OK))


# ----------------------------------------------------------------------
# Per-kernel workspace estimators: the memory-budget footprint model
# (repro.core.membudget) asks the registry how much device scratch a
# kernel needs on top of its staged inputs — e.g. spmv's gathered
# xs/ys slices.  Estimators take keyword shape hints and return bytes;
# unknown kernels price as 0 so the model degrades gracefully.
#
# Every estimator also understands a ``devices`` hint (default 1): the
# mesh-cooperative streaming executor spreads one wave's work over a
# device mesh, so scratch that scales with item/tile counts is priced
# per device as ceil(count / devices) — the worst single device after
# an LPT split, which is what a per-device memory budget must bound.
_WORKSPACE: dict[str, Callable[..., int]] = {}


def _per_device(count: int, devices: int) -> int:
    """Worst-device share of ``count`` items split over ``devices``."""
    d = max(int(devices), 1)
    return -(-int(count) // d)


def register_workspace(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a workspace-bytes estimator for kernel ``name``."""

    def deco(fn: Callable[..., int]) -> Callable:
        _WORKSPACE[name] = fn
        return fn

    return deco


def registered_workspaces() -> tuple[str, ...]:
    """Names with a workspace estimator (declaration-typo guard)."""
    return tuple(_WORKSPACE)


def workspace_bytes(name, **shape_hints) -> int:
    """Estimated scratch bytes for ``name`` given shape hints (0 if none).

    ``name`` may be a sequence of kernel names, priced as the *maximum*
    over them — how a direction-optimizing plan charges for whichever
    of its push/pull dense variants is costlier, so a mid-stream switch
    never exceeds a budget the planner verified."""
    if not isinstance(name, str):
        return max((workspace_bytes(nm, **shape_hints) for nm in name),
                   default=0)
    fn = _WORKSPACE.get(name)
    return int(fn(**shape_hints)) if fn is not None else 0


def max_workspace_bytes(**shape_hints) -> int:
    """Worst case over every registered estimator — what the footprint
    model charges when an algorithm does not name its dense kernel."""
    return max(
        (int(fn(**shape_hints)) for fn in _WORKSPACE.values()), default=0
    )


# ``nd`` means "tiles staged in the batch" for every estimator below.
@register_workspace("spmv_tiles")
def _spmv_workspace(nd: int, tile_dim: int, devices: int = 1) -> int:
    # gathered xs + produced ys, one (nd, T) float32 slab each
    return 2 * _per_device(nd, devices) * tile_dim * 4


# CSR estimators: what the sparse/CSR path stages or scratches per wave.
# They take their own hints (``csr_edges``, ``items``/``depth``) and
# swallow the dense hints so max_workspace_bytes stays callable with
# (nd, tile_dim) alone.
@register_workspace("csr_slice")
def _csr_slice_workspace(csr_edges: int = 0, devices: int = 1,
                         **_hints) -> int:
    # the conformal CSR row slices staged as the wave's ctx.indices
    # (int32 per adjacency entry) — see BlockStore.csr_slices.  A mesh
    # device stages only its own tasks' row slices, hence the split.
    return _per_device(int(csr_edges) * 4, devices)


@register_workspace("csr_bucket_search")
def _csr_bucket_search_workspace(items: int = 0, depth: int = 0,
                                 devices: int = 1, **_hints) -> int:
    # TC-style membership test over staged CSR slices: gathered values
    # plus lo/hi binary-search bounds, one (items, depth) int32 each
    return 3 * _per_device(items, devices) * int(depth) * 4


@register_workspace("stage_arena")
def _stage_arena_workspace(slab_bytes: int = 0, depth: int = 2,
                           devices: int = 1, **_hints) -> int:
    # Pipelined staging (repro.core.stream._StagePipeline) keeps up to
    # ``depth`` assembled host slabs in flight plus the one crossing the
    # bus: the arena's pooled buffers are bounded by (depth + 1) × the
    # largest slab.  Host-side memory — the *device* bound stays the
    # per-slab ≤ budget invariant (at most current + prefetch resident),
    # but the footprint model prices the arena so callers can see the
    # true steady-state staging residency.
    return _per_device(int(slab_bytes) * (max(int(depth), 1) + 1), devices)


@register_workspace("frontier_tiles")
def _frontier_workspace(nd: int, tile_dim: int, devices: int = 1) -> int:
    # gathered frontier columns (bool) + candidate mins (int32)
    return _per_device(nd, devices) * tile_dim * (1 + 4)


@register_workspace("tc_tiles")
def _tc_workspace(nd: int, tile_dim: int, devices: int = 1) -> int:
    # the gathered tile operands of the masked matmul (one per staged
    # tile: each triple reads its 3 tiles, nd counts all of them)
    return _per_device(nd, devices) * tile_dim * tile_dim * 4
