"""Three-term roofline on an NVIDIA H100.

Port of ``repro/roofline/analysis.py``::

    compute term    = FLOPs / peak FLOP/s
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

``HW`` holds H100 SXM data-sheet constants in place of the reference's
TPU v5e ones.  The reference reads FLOPs, bytes and collective bytes
from a compiled XLA executable (``cost_analysis()`` and the HLO text);
PyTorch has neither, so the counts come from dispatch
(:mod:`.op_cost`, as ``launch.dryrun`` traces a step) or from the
caller's shapes.  :func:`collective_bytes` is the counterpart of the
reference's ``collective_bytes_from_hlo``: the same ring factors over
the collectives that :class:`.op_cost.OpCost` records in place of the
HLO's.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["HW", "roofline_terms", "model_flops", "parse_shape_bytes", "collective_bytes"]


@dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM (data sheet; dense rates, 700 W)."""

    peak_flops: float = 989e12       # bf16 FLOP/s on the tensor cores
    hbm_bw: float = 3.35e12          # bytes/s of HBM3
    link_bw: float = 450e9           # bytes/s of NVLink, each direction


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([\d,]*)\]")


def parse_shape_bytes(shape_str: str) -> int:
    """Sum bytes over all shapes in an HLO-style result type such as
    ``(f32[8,128], bf16[4])`` (handles tuples)."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


# wire-bytes multiplier per collective kind (ring algorithms, n → large)
_FACTORS = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(records) -> dict:
    """Wire bytes of the collectives in ``records`` (dicts with the
    ``collective`` kind and the ``bytes`` of its result; others are
    skipped): ``{total, per_kind, counts}``, each kind's bytes times its
    ring factor, as the reference's ``collective_bytes_from_hlo``."""
    per_kind: dict[str, float] = {}
    count: dict[str, int] = {}
    for r in records:
        kind = r.get("collective")
        if kind is None:
            continue
        per_kind[kind] = per_kind.get(kind, 0.0) + r["bytes"] * _FACTORS[kind]
        count[kind] = count.get(kind, 0) + 1
    return dict(total=sum(per_kind.values()), per_kind=per_kind, counts=count)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D = tokens.

    For decode shapes D = global_batch (one token per sequence); train
    includes the 3× backward factor, inference kinds use 2·N·D.
    """
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def roofline_terms(cost: dict, coll: dict, *, chips: int, hw: HW = HW()) -> dict:
    """``cost``: per-device ``{"flops": ..., "bytes accessed": ...}``;
    ``coll``: per-device ``{"total": collective bytes}``."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    coll_bytes = float(coll["total"])
    t_compute = flops / hw.peak_flops
    t_memory = bytes_acc / hw.hbm_bw
    t_coll = coll_bytes / hw.link_bw
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return dict(
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_coll,
        dominant=dominant,
        hlo_flops_per_chip=flops,
        hlo_bytes_per_chip=bytes_acc,
        collective_bytes_per_chip=coll_bytes,
        chips=chips,
    )
