"""Scheduler anatomy on the PyTorch port: how PGAbB routes tasks (paper §4.4).

Shows, for a skewed graph: the E-estimates, the weight-sorted task
order, which tasks the dense tile path claims under the cut-off, the LPT
packing across 8 virtual devices, and the resulting makespan ratio.  The
plan is built on the current CUDA device unless `--device cpu`; nothing
is executed.

    PYTHONPATH=src python examples/torch_heterogeneous_schedule.py [--device cpu]
"""
import argparse

from repro_torch.algorithms import pagerank_algorithm
from repro_torch.core import build_block_store, compile_plan, degree_order, resolve_device, rmat

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="default: the current CUDA device")
dev = resolve_device(ap.parse_args().device)

# skewed RMAT; degree ordering concentrates hub-hub edges into a dense
# corner block (exactly the structure the paper's TC work exploits)
g, _ = degree_order(rmat(12, 16, seed=3))
store = build_block_store(g, 8)
# compile_plan builds the schedule as a first-class artifact; it is
# inspectable on the plan before (or without) ever executing it
plan = compile_plan(
    pagerank_algorithm(), store, num_devices=8, mode="hybrid",
    dense_density=0.02, dense_frac=0.5, tile_dim=1024, device=dev,
)
sched = plan.schedule

print("task  weight(E)   path    device")
for t in sched.order[:16]:
    path = "tile/dense" if sched.dense_task_mask[t] else "edge/sparse"
    print(f"{t:4d}  {sched.weights[t]:9.0f}   {path:9s}  {sched.device_assignment[t]}")
print("...")
st = sched.stats
print(f"\ntasks={st['num_tasks']} dense={st['dense_tasks']} "
      f"dense_weight={st['dense_weight_frac']:.2f} "
      f"LPT makespan ratio={st['makespan_ratio']:.3f} (1.0 = perfect balance)")
