"""Per-device cost of a traced step, counted op by op at dispatch.

The counterpart of ``repro/roofline/hlo_cost.py``.  The reference walks
the compiled SPMD program's HLO text (multiplying ``while`` bodies by
their trip counts); PyTorch has no HLO, so :class:`OpCost`, a
``TorchDispatchMode``, counts the ops that one rank runs, on its local
tensors (an op on DTensors is left to DTensor, whose local ops and
collectives then pass through the mode):

* **FLOPs**: the matmul-class ops' counts from ``torch.utils.flop_counter``
  (its formula for each op it knows; every other op counts 0, as the
  reference counts dot FLOPs only);
* **bytes**: Σ (inputs + outputs) of every op that makes a new tensor
  (views, metadata ops and in-place results skipped), the counterpart of
  the reference's post-fusion buffer bytes: each eager op reads and
  writes device memory, so this is the traffic of the op-by-op program;
* **collectives**: each c10d or functional collective's kind
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``)
  and the bytes of its result, as the reference reads the result type of
  an HLO collective; ``analysis.collective_bytes`` applies the ring
  factors;
* **peak bytes**: the most bytes held at once by tensors the step made
  (a tensor's bytes are freed when its Python object is), so the
  gathered weights, activations, gradients and scratch of the step.

Under ``FakeTensorMode`` (the dry run) nothing is allocated or computed
and the counts are the same.  DTensor runs an op on fake tensors the
first time it sees its shapes, to infer the output's; that is not the
rank's work, and the mode does not count it: while counting, it wraps
the sharding propagator's tensor-meta inference (a private method of
``ShardingPropagator``, whichever name this PyTorch gives it) to mark
those spans.  The mode adds a Python call to every op,
so it is for a dry run or one counted step, not a timed one.
"""
from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCost"]

_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
#: DTensor's output-shape inference, by the names PyTorch releases give it
_INFER = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
_SKIP = {"prim.device", "aten.detach", "aten.lift_fresh", "_c10d_functional.wait_tensor",
         "aten._local_scalar_dense", "aten.set_", "aten.empty", "aten.empty_strided",
         "aten.new_empty", "aten.new_empty_strided"}


def _collective_kind(func) -> str | None:
    """The HLO name of a c10d or functional collective op, else None."""
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = func._opname
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class OpCost(TorchDispatchMode):
    """Counts what one rank's ops cost (see the module's docstring).
    ``records`` holds one dict per collective: ``op``, ``collective``
    (the kind), ``bytes`` and ``elements`` of its result.  ``flops``,
    ``bytes``, ``peak_bytes`` and ``ops`` are totals."""

    def __init__(self):
        super().__init__()
        self._inferring = 0
        self._patched = None
        self.records: list[dict] = []
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.live = 0
        self.peak_bytes = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __enter__(self):
        name = next(n for n in _INFER if hasattr(ShardingPropagator, n))
        infer = getattr(ShardingPropagator, name)

        def inferring(prop, *args, **kwargs):
            self._inferring += 1
            try:
                return infer(prop, *args, **kwargs)
            finally:
                self._inferring -= 1
        setattr(ShardingPropagator, name, inferring)
        self._patched = (name, infer)
        return super().__enter__()

    def __exit__(self, *exc):
        setattr(ShardingPropagator, *self._patched)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        if name in _SKIP or self._inferring:
            return out        # bookkeeping, or DTensor inferring an output's shape
        self.ops += 1
        kind = _collective_kind(func)
        if kind is not None:
            # c10d ops write into their first argument; functional ones return the result
            res = _tensors(args[0] if func.namespace == "c10d" else out)
            self.records.append(dict(op=name, collective=kind, bytes=_nbytes(res),
                                     elements=sum(t.numel() for t in res)))
            return out
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        made = [t for t in _tensors(out) if not any(t is i for i in ins)]
        self.bytes += _nbytes(ins) + _nbytes(made)
        for t in made:
            n = t.numel() * t.element_size()
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live)
        return out
