"""Span-based tracer behind a thread-safe ring buffer.

One process-wide :class:`Tracer` records *spans* — named, timestamped
intervals with free-form attributes — from any thread into a single
bounded ring buffer, so every thread shares one timeline.  Every span
carries a *lane*: the logical track it belongs to (``"main"``,
``"device"``, ``"direction"``, ...).

Zero-cost when disabled
-----------------------
Tracing is **off** unless the ``REPRO_TRACE`` environment variable is
set truthy at import (or :func:`enable` is called).  When off,
:func:`span` returns a shared no-op context manager and
:func:`add_span`/:func:`instant` return immediately after one ``None``
check — no allocation, no lock, no clock read — so instrumented hot
paths (the per-wave pipeline) pay a single branch.  Results are
therefore bit-identical with tracing on or off: the tracer only ever
*observes* timestamps, never touches computation.

Thread safety and bounds
------------------------
Appends take one lock around a ring-buffer slot write; the buffer holds
the most recent ``capacity`` spans (default 65536) and
:attr:`Tracer.dropped` counts overwritten ones, so a long-running
server can stay traced without unbounded memory.  Per-thread span
*stacks* (plain ``threading.local``) give each span its nesting depth
and parent name, letting the exporters and tests reconstruct the span
tree.

Optional profiler bridge
------------------------
``enable(torch_annotations=True)`` (or ``REPRO_TRACE_TORCH=1``) makes
every :func:`span` additionally enter a
``torch.profiler.record_function`` of the same name, so host spans line
up with device kernels in traces captured via ``torch.profiler.profile``.
"""
from __future__ import annotations

import os
import threading
import time

__all__ = [
    "SpanEvent", "Tracer", "span", "add_span", "instant",
    "enable", "disable", "enabled", "tracer", "tracing",
]

_FALSY = ("", "0", "false", "off", "no")


class SpanEvent:
    """One recorded span: a closed interval on a lane.

    A plain ``__slots__`` class, not a dataclass — span records are
    constructed on the per-wave hot path, and skipping dataclass
    machinery keeps the record cost in the very-low-microsecond range
    (the obs-smoke overhead gate counts on it)."""

    __slots__ = ("name", "start_ns", "dur_ns", "lane", "depth", "parent",
                 "args")

    def __init__(self, name: str, start_ns: int, dur_ns: int, lane: str,
                 depth: int, parent: str | None, args: dict) -> None:
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.lane = lane
        self.depth = depth          # nesting depth on the recording thread
        self.parent = parent        # enclosing span's name (same thread)
        self.args = args

    @property
    def end_ns(self) -> int:
        return self.start_ns + self.dur_ns

    def __repr__(self) -> str:
        return (f"SpanEvent(name={self.name!r}, start_ns={self.start_ns}, "
                f"dur_ns={self.dur_ns}, lane={self.lane!r}, "
                f"depth={self.depth}, parent={self.parent!r}, "
                f"args={self.args!r})")


def _thread_lane() -> str:
    name = threading.current_thread().name
    if name == "MainThread":
        return "main"
    return name


class Tracer:
    """Thread-safe ring buffer of :class:`SpanEvent`\\ s."""

    def __init__(self, capacity: int = 65536, *,
                 torch_annotations: bool = False) -> None:
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = int(capacity)
        self.torch_annotations = bool(torch_annotations)
        self._buf: list[SpanEvent | None] = [None] * self.capacity
        self._n = 0                # total spans ever recorded
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- recording -----------------------------------------------------
    def record(self, name: str, start_ns: int, dur_ns: int, *,
               lane: str | None = None, depth: int = 0,
               parent: str | None = None, **args) -> None:
        ev = SpanEvent(name, int(start_ns), max(int(dur_ns), 0),
                       lane if lane is not None else _thread_lane(),
                       int(depth), parent, args)
        with self._lock:
            self._buf[self._n % self.capacity] = ev
            self._n += 1

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- reading -------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Spans overwritten because the ring buffer wrapped."""
        return max(0, self._n - self.capacity)

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def events(self) -> list[SpanEvent]:
        """The retained spans, oldest first (recording order)."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                out = self._buf[:n]
            else:
                cut = n % self.capacity
                out = self._buf[cut:] + self._buf[:cut]
        return list(out)            # type: ignore[arg-type]

    def spans(self, name: str | None = None, **args) -> list[SpanEvent]:
        """Retained spans filtered by name and/or attribute equality."""
        out = []
        for ev in self.events():
            if name is not None and ev.name != name:
                continue
            if any(ev.args.get(k) != v for k, v in args.items()):
                continue
            out.append(ev)
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._n = 0


class _Span:
    """The live context manager behind :func:`span`."""

    __slots__ = ("_tracer", "_name", "_lane", "_args", "_start",
                 "_depth", "_parent", "_prof")

    def __init__(self, tracer: Tracer, name: str, lane: str | None,
                 args: dict) -> None:
        self._tracer = tracer
        self._name = name
        self._lane = lane
        self._args = args
        self._prof = None

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else None
        stack.append(self._name)
        if self._tracer.torch_annotations:
            import torch.profiler

            self._prof = torch.profiler.record_function(self._name)
            self._prof.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        if self._prof is not None:
            self._prof.__exit__(*exc)
        stack = self._tracer._stack()
        if stack and stack[-1] == self._name:
            stack.pop()
        self._tracer.record(self._name, self._start, end - self._start,
                            lane=self._lane, depth=self._depth,
                            parent=self._parent, **self._args)
        return False


class _NoopSpan:
    """Shared do-nothing context manager — the disabled-tracer path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()
_tracer: Tracer | None = None


def enabled() -> bool:
    """Is tracing on?  (Metrics are always on; only spans gate.)"""
    return _tracer is not None


def tracer() -> Tracer | None:
    """The active process-wide tracer, or None when disabled."""
    return _tracer


def enable(capacity: int = 65536, *,
           torch_annotations: bool | None = None) -> Tracer:
    """Turn tracing on (idempotent); returns the active tracer.

    ``torch_annotations=None`` reads ``REPRO_TRACE_TORCH`` from the
    environment; an existing tracer keeps recording (capacity and
    bridge settings apply only when a new tracer is created).
    """
    global _tracer
    if _tracer is None:
        if torch_annotations is None:
            torch_annotations = (
                os.environ.get("REPRO_TRACE_TORCH", "").lower()
                not in _FALSY
            )
        _tracer = Tracer(capacity, torch_annotations=torch_annotations)
    return _tracer


def disable() -> None:
    """Turn tracing off; already-recorded spans are discarded."""
    global _tracer
    _tracer = None


class tracing:
    """``with obs.tracing() as tr: ...`` — scoped enable/restore."""

    def __init__(self, capacity: int = 65536, *,
                 torch_annotations: bool | None = None) -> None:
        self._capacity = capacity
        self._torch = torch_annotations

    def __enter__(self) -> Tracer:
        global _tracer
        self._prev = _tracer
        _tracer = None
        return enable(self._capacity, torch_annotations=self._torch)

    def __exit__(self, *exc) -> bool:
        global _tracer
        _tracer = self._prev
        return False


def span(name: str, *, lane: str | None = None, **args):
    """``with obs.span("assemble", wave=k): ...`` — record one span.

    A no-op (shared singleton, no allocation) while tracing is
    disabled.  ``lane`` overrides the thread-derived track; extra
    keyword arguments become span attributes.
    """
    t = _tracer
    if t is None:
        return _NOOP
    return _Span(t, name, lane, args)


def add_span(name: str, duration_s: float, *, lane: str | None = None,
             **args) -> None:
    """Record a synthetic span of ``duration_s`` ending now — used for
    costs measured indirectly (the mesh collective's isolated-all-reduce
    estimate) that still belong on the timeline."""
    t = _tracer
    if t is None:
        return
    end = time.perf_counter_ns()
    dur = int(duration_s * 1e9)
    t.record(name, end - dur, dur, lane=lane, **args)


def instant(name: str, *, lane: str | None = None, **args) -> None:
    """Record a zero-duration marker (e.g. ``rebalance fired``)."""
    t = _tracer
    if t is None:
        return
    t.record(name, time.perf_counter_ns(), 0, lane=lane, **args)


# honor REPRO_TRACE at import so `REPRO_TRACE=1 python app.py` traces
# without code changes.  REPRO_TRACE / REPRO_TRACE_TORCH are declared in
# repro_torch.core.knobs.KNOWN but read locally: obs stays importable
# without repro_torch.core, and truthy-string semantics cannot be
# malformed
if os.environ.get("REPRO_TRACE", "").lower() not in _FALSY:
    enable()
