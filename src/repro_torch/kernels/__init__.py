"""The hand-written CUDA tile kernels and their plain PyTorch versions.

spmv_tiles     — batched dense-tile SpMV (PageRank dense path)
frontier_tiles — bottom-up BFS frontier probe (BFS dense pull path)
tc_tiles       — dense-tile triangle count (TC dense path)
ref            — plain PyTorch versions of every kernel
registry       — kernels by name, launch counts, workspace estimators
_build         — nvcc build at first use, ctypes binding

Import a kernel from its module (``from repro_torch.kernels.spmv_tiles
import spmv_tiles``); nothing here is built or launched on import.
"""
