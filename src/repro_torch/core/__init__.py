"""Core of the port: graph, partition, block store, scheduler, engine,
the out-of-core streaming executor with its host lane and its device
mesh, and the fault-tolerant runtime."""
from .graph import (
    Graph, degree_order, erdos_renyi, from_edges, grid_road, load_binary,
    read_edge_list, rmat, save_binary, star_skew, csr_prefix,
)
from .partition import (
    Layout, choose_p, layout_from_cuts, make_layout, partition_1d,
    partition_symmetric_2d,
)
from .blocks import BlockStore, build_block_store
from .functors import BlockAlgorithm, Mode, default_estimate
from .scheduler import Schedule, build_schedule, lpt_assign
from .context import (
    Context, HostCtx, build_context, build_host_ctx, to_device, with_arrays,
    with_extras,
)
from .direction import (
    DIRECTIONS, DirectionController, direction_spec, resolve_direction,
)
from .engine import (
    Engine, Plan, RunResult, batch_states, compile_plan, resolve_device, run,
    unbatch_state,
)
from .membudget import (
    MemoryBudget, PIPELINE_DEPTH, TenantLedger, arena_model_bytes,
    batch_state_bytes, bucket_size, build_waves, repack_waves,
    task_csr_edge_counts, task_footprints, tree_array_bytes,
)
from .stream import StreamingPlan, compile_streaming_plan
from .distributed import DeviceMesh, DistributedEngine, make_device_edge_partition
from .faults import FaultPlan, InjectedFault, InjectedOOM
from .resilience import (
    HostTaskError, ResilienceStats, RetryPolicy, WorkerDeath,
)
from .knobs import env_flag, env_float, env_int, env_str

__all__ = [
    "Graph", "from_edges", "read_edge_list", "load_binary", "save_binary",
    "rmat", "erdos_renyi", "grid_road", "star_skew", "degree_order",
    "csr_prefix",
    "Layout", "partition_1d", "partition_symmetric_2d", "make_layout",
    "layout_from_cuts", "choose_p",
    "BlockStore", "build_block_store",
    "BlockAlgorithm", "Mode", "default_estimate",
    "Schedule", "build_schedule", "lpt_assign",
    "Context", "HostCtx", "build_context", "build_host_ctx", "to_device",
    "with_arrays", "with_extras",
    "DIRECTIONS", "DirectionController", "direction_spec", "resolve_direction",
    "Plan", "compile_plan", "RunResult", "resolve_device",
    "batch_states", "unbatch_state",
    "MemoryBudget", "PIPELINE_DEPTH", "arena_model_bytes",
    "task_footprints", "task_csr_edge_counts",
    "build_waves", "repack_waves", "TenantLedger", "batch_state_bytes",
    "bucket_size", "tree_array_bytes",
    "StreamingPlan", "compile_streaming_plan",
    "DeviceMesh", "DistributedEngine", "make_device_edge_partition",
    "FaultPlan", "InjectedFault", "InjectedOOM",
    "HostTaskError", "ResilienceStats", "RetryPolicy", "WorkerDeath",
    "env_flag", "env_float", "env_int", "env_str",
    "Engine", "run",
]
