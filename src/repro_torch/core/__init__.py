"""Core of the port: graph, partition, block store, scheduler, engine."""
from .graph import (
    Graph, degree_order, erdos_renyi, from_edges, grid_road, load_binary,
    read_edge_list, rmat, save_binary, star_skew,
)
from .partition import (
    Layout, layout_from_cuts, make_layout, partition_1d, partition_symmetric_2d,
)
from .blocks import BlockStore, build_block_store
from .functors import BlockAlgorithm, Mode, default_estimate
from .scheduler import Schedule, build_schedule, lpt_assign
from .context import Context, HostCtx, build_context, build_host_ctx, to_device
from .direction import (
    DIRECTIONS, DirectionController, direction_spec, resolve_direction,
)
from .engine import Plan, RunResult, compile_plan, resolve_device
from .knobs import env_flag, env_float, env_int, env_str

__all__ = [
    "Graph", "from_edges", "read_edge_list", "load_binary", "save_binary",
    "rmat", "erdos_renyi", "grid_road", "star_skew", "degree_order",
    "Layout", "partition_1d", "partition_symmetric_2d", "make_layout",
    "layout_from_cuts",
    "BlockStore", "build_block_store",
    "BlockAlgorithm", "Mode", "default_estimate",
    "Schedule", "build_schedule", "lpt_assign",
    "Context", "HostCtx", "build_context", "build_host_ctx", "to_device",
    "DIRECTIONS", "DirectionController", "direction_spec", "resolve_direction",
    "Plan", "compile_plan", "RunResult", "resolve_device",
    "env_flag", "env_float", "env_int", "env_str",
]
