"""Exporters: Chrome-trace/Perfetto timelines and the unified run-report.

The port's copy of ``repro/obs/export.py``.  Its lane order, lane names,
process name and run-report schema are the reference's, so that a trace
or a report from either package reads the same.

* :func:`chrome_trace` renders the tracer's span buffer as Chrome
  trace-event JSON (the format ``ui.perfetto.dev`` and
  ``chrome://tracing`` load): one process, one track ("lane") per
  logical resource — ``main``, the ``staging`` background thread, and
  ``device/0 … device/D-1`` for the mesh (a span recorded on the
  ``"device"`` lane with a ``devices=D`` attribute is mirrored onto
  every device's track, since a mesh step occupies all of them).
  Spans become complete (``ph="X"``) events with microsecond
  timestamps; lanes are labeled via metadata events.  On a card, a
  ``device``-lane span times the host's enqueue of its work, not the
  card's execution: the tracer reads the host clock only.

* :func:`run_report` wraps a benchmark's payload in the one
  schema-versioned report format (``repro.obs.run_report`` v1): the
  benchmark's own gate fields stay at the top level, plus
  ``schema``/``schema_version``/``report`` headers and a ``metrics``
  block snapshotting the process-wide registry.

:func:`validate_chrome_trace` is the loadability check run against an
exported file: structure, non-negative durations, monotonic start
timestamps, required lanes and phase names.

Span arguments other than ``int``/``float``/``str``/``bool``/``None``
(a numpy scalar, a tensor) are left out of the export, as in the
reference.
"""
from __future__ import annotations

import json
from typing import Any

from .metrics import REGISTRY
from .tracer import SpanEvent, tracer

__all__ = [
    "chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "run_report", "RUN_REPORT_SCHEMA", "RUN_REPORT_VERSION",
]

RUN_REPORT_SCHEMA = "repro.obs.run_report"
RUN_REPORT_VERSION = 1

_PID = 1
_SCALARS = (int, float, str, bool, type(None))


def _expand_lanes(ev: SpanEvent) -> list[str]:
    """A ``"device"``-lane span with ``devices=D`` occupies every mesh
    device's track; everything else stays on its recorded lane."""
    if ev.lane == "device":
        d = int(ev.args.get("devices", 1) or 1)
        return [f"device/{i}" for i in range(max(d, 1))]
    return [ev.lane]


def _lane_tids(events: list[SpanEvent]) -> dict[str, int]:
    """Deterministic lane → tid: main, staging, device/*, then the rest
    alphabetically — stable across runs for diffable traces."""
    lanes: set[str] = set()
    for ev in events:
        lanes.update(_expand_lanes(ev))

    def rank(lane: str):
        if lane == "main":
            return (0, 0, lane)
        if lane == "staging":
            return (1, 0, lane)
        if lane.startswith("device/"):
            try:
                return (2, int(lane.split("/", 1)[1]), lane)
            except ValueError:
                return (2, 1 << 30, lane)
        return (3, 0, lane)

    return {lane: i + 1 for i, lane in enumerate(sorted(lanes, key=rank))}


def chrome_trace(events: list[SpanEvent] | None = None) -> dict:
    """Render spans (default: the active tracer's buffer) as a Chrome
    trace-event JSON object.  Raises when tracing is disabled and no
    events are passed."""
    if events is None:
        t = tracer()
        if t is None:
            raise RuntimeError(
                "tracing is disabled (set REPRO_TRACE=1 or call "
                "repro_torch.obs.enable()) and no events were passed")
        events = t.events()
    tids = _lane_tids(events)
    trace_events: list[dict] = [
        dict(ph="M", pid=_PID, tid=0, name="process_name", args=dict(name="repro")),
    ]
    for lane, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        trace_events.append(dict(ph="M", pid=_PID, tid=tid, name="thread_name",
                                 args=dict(name=lane)))
        trace_events.append(dict(ph="M", pid=_PID, tid=tid, name="thread_sort_index",
                                 args=dict(sort_index=tid)))
    spans = []
    for ev in events:
        args = {k: v for k, v in ev.args.items() if isinstance(v, _SCALARS)}
        if ev.parent is not None:
            args["parent"] = ev.parent
        for lane in _expand_lanes(ev):
            spans.append(dict(
                ph="X", pid=_PID, tid=tids[lane], name=ev.name,
                cat=ev.name.split(".", 1)[0],
                ts=ev.start_ns / 1e3, dur=ev.dur_ns / 1e3,
                args=args,
            ))
    spans.sort(key=lambda e: (e["ts"], e["tid"]))
    trace_events.extend(spans)
    return dict(traceEvents=trace_events, displayTimeUnit="ms")


def write_chrome_trace(path: str, events: list[SpanEvent] | None = None) -> dict:
    """Serialize :func:`chrome_trace` to ``path``; returns the object."""
    obj = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def validate_chrome_trace(obj: dict, *, require_lanes=(), require_phases=()) -> dict:
    """Structural validation of a Chrome-trace object (or JSON string).

    Checks: top-level shape, every span event well-formed (``ph="X"``,
    numeric non-negative ``ts``/``dur``), start timestamps monotonic
    non-decreasing in file order (the exporter writes spans sorted by
    start — a violation means a broken export or clock), and that every
    lane in ``require_lanes`` and span name in ``require_phases``
    appears.  Returns summary stats (lanes, span counts per name);
    raises ``ValueError`` on any violation.
    """
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace: missing traceEvents")
    lanes: dict[int, str] = {}
    names: dict[str, int] = {}
    prev_ts = float("-inf")
    for ev in obj["traceEvents"]:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "thread_name":
                lanes[ev["tid"]] = ev["args"]["name"]
            continue
        if ph != "X":
            raise ValueError(f"unexpected event phase {ph!r}")
        ts, dur = ev.get("ts"), ev.get("dur")
        if not (isinstance(ts, (int, float)) and ts >= 0):
            raise ValueError(f"bad ts on {ev.get('name')!r}: {ts!r}")
        if not (isinstance(dur, (int, float)) and dur >= 0):
            raise ValueError(f"bad dur on {ev.get('name')!r}: {dur!r}")
        if ts < prev_ts - 1e-9:
            raise ValueError(
                f"non-monotonic timestamps: {ev['name']} starts at {ts} "
                f"after an event at {prev_ts}")
        prev_ts = ts
        names[ev["name"]] = names.get(ev["name"], 0) + 1
    lane_names = set(lanes.values())
    for lane in require_lanes:
        if lane not in lane_names:
            raise ValueError(f"required lane {lane!r} missing (got {sorted(lane_names)})")
    for phase in require_phases:
        if phase not in names:
            raise ValueError(f"required phase {phase!r} missing (got {sorted(names)})")
    return dict(lanes=sorted(lane_names), span_counts=names, events=sum(names.values()))


def run_report(report: str, payload: dict, *, include_metrics: bool = True) -> dict:
    """Wrap a benchmark payload in the unified run-report schema.

    The payload's keys (gate fields like ``checks``/``passed``/floors)
    stay at the top level; the schema headers and the registry snapshot
    ride alongside.  Reserved header keys may not collide with payload
    keys.
    """
    header = dict(schema=RUN_REPORT_SCHEMA, schema_version=RUN_REPORT_VERSION, report=report)
    clash = set(header) & set(payload)
    if clash:
        raise ValueError(f"payload keys collide with the run-report header: {sorted(clash)}")
    out: dict[str, Any] = dict(header)
    out.update(payload)
    if include_metrics and "metrics" not in out:
        out["metrics"] = REGISTRY.snapshot()
    return out
