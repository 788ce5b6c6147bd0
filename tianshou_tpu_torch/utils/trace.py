"""The port's in-program tracer: spans at the layer boundaries of a run,
counters, graph events, and timing marks on the card inside a captured
superstep.

Spans are off by default.  With tracing off, :func:`span` returns one
shared no-op context manager after a single flag test: no allocation, no
clock read, no ``record_function``.  :func:`enable` turns them on for the
process, :func:`disable` off; :func:`clear` empties what was recorded.

- A span records its name, an optional ``tag`` (a compiled step's name and
  pattern, say), its start and end on the host (``time.perf_counter_ns()``,
  the clock of ``time.perf_counter``), its parent (the index in
  :func:`spans` of the span open around it on the same thread, -1 for
  none), the superstep it belongs to (the run's superstep count,
  :func:`set_superstep`: the identifier the spans of one superstep share)
  and ``data`` (what :meth:`_Span.set` adds: a superstep's device times).
  Spans are kept in memory, at most :data:`CAPACITY`; those beyond it are
  counted in :func:`dropped` and not kept.  They are read through
  :func:`spans` and written out only by whoever asks.
- While a ``torch.profiler`` is active, each span is also a
  ``record_function`` range of the same name (unless :func:`enable` was
  told ``ranges=False``), so that the profiler's trace
  (``RunContext(profile_dir)``'s Chrome trace) carries it beside the device
  records.  The profiler's host clock is the wall clock
  (``time.time_ns()``), not ``perf_counter_ns``: the offset between the two
  is measured at the first span opened under a profiler
  (:func:`profiler_offset_ns`), and a span's interval plus that offset is
  its interval in the profiler's records.  A span's start is read after the
  range opens and its end before it closes, so that the range holds it.
- Counters (:func:`count`, :func:`counters`) are plain integers keyed by a
  name and a tag, and always on: an increment is a dict update.
- Graph events (:func:`note`, :func:`events`) are always on too: each is a
  name, a tag and an interval, recorded where a compiled step warms up,
  captures, or replays a graph for the first time
  (:mod:`~tianshou_tpu_torch.utils.graphs`).  Those are rare and cost
  milliseconds each, so their record is free, and a reader that could not
  turn the tracer on still sees where set-up went.
- :class:`DeviceMarks` are CUDA events recorded inside a step, each
  captured as an event-record node that every replay records again; a step
  built while tracing is on gets them (:func:`device_marks`), and a step
  built while it is off holds none.  Code below the step (an algorithm's
  update, say) records intervals on them through :func:`interval`, which
  does nothing unless the step made its marks active (:func:`marking`).

Every span name of the port begins with ``tianshou.``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

__all__ = ["CAPACITY", "DeviceMarks", "Event", "Span", "clear", "count", "counters", "device_marks", "disable",
           "dropped", "enable", "enabled", "events", "interval", "marking", "note", "profiler_offset_ns",
           "set_superstep", "span", "spans"]

#: the most spans kept, and the most graph events
CAPACITY = 262_144

_on = False
_ranges = True
_spans: list["Span"] = []
_dropped = 0
_events: list["Event"] = []
_counters: dict[tuple[str, str], int] = {}
_superstep = 0
_offset_ns: int | None = None
_local = threading.local()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    tag: str | None
    start_ns: int
    end_ns: int | None  # None while open
    parent: int
    superstep: int
    data: dict[str, float] | None = None


@dataclasses.dataclass(slots=True)
class Event:
    name: str
    tag: str
    start_ns: int
    end_ns: int


class _NoSpan:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **values: float) -> None:
        pass


_NO_SPAN = _NoSpan()


def _stack() -> list[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("record", "_range")

    def __init__(self, name: str, tag: str | None):
        self.record = Span(name, tag, 0, None, -1, _superstep)
        self._range = None

    def __enter__(self) -> "_Span":
        global _dropped, _offset_ns
        if _ranges and torch.autograd.profiler._is_profiler_enabled:
            if _offset_ns is None:
                _offset_ns = _measure_offset()
            self._range = torch.autograd.profiler.record_function(self.record.name)
            self._range.__enter__()
        stack = _stack()
        rec = self.record
        rec.parent = stack[-1] if stack else -1
        if len(_spans) < CAPACITY:
            stack.append(len(_spans))
            _spans.append(rec)
        else:
            _dropped += 1
            stack.append(-1)
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.record.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False

    def set(self, **values: float) -> None:
        """Add ``values`` to the span's ``data``."""
        self.record.data = {**(self.record.data or {}), **values}


def span(name: str, tag: str | None = None) -> _Span | _NoSpan:
    """A context manager that records the span ``name`` while tracing is
    on, and the shared no-op while it is off."""
    if not _on:
        return _NO_SPAN
    return _Span(name, tag)


def enable(ranges: bool = True) -> None:
    """Turn spans and device marks on for the process; ``ranges=False``
    keeps spans out of an active profiler's records, whose device track
    would otherwise carry each as an annotation."""
    global _on, _ranges
    _on, _ranges = True, ranges


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    """Forget every span, graph event and counter, and the profiler clock's
    offset."""
    global _dropped, _offset_ns, _superstep
    _spans.clear()
    _events.clear()
    _counters.clear()
    _dropped = _superstep = 0
    _offset_ns = None


def set_superstep(n: int) -> None:
    """The superstep that spans opened from now on belong to."""
    global _superstep
    _superstep = n


def spans() -> list[Span]:
    """The spans kept, in the order they opened."""
    return list(_spans)


def dropped() -> int:
    """Spans and graph events not kept: :data:`CAPACITY` was reached."""
    return _dropped


def count(name: str, tag: str = "") -> None:
    """Add one to the counter ``(name, tag)``."""
    key = (name, tag)
    _counters[key] = _counters.get(key, 0) + 1


def counters() -> dict[tuple[str, str], int]:
    return dict(_counters)


def note(name: str, tag: str, start_ns: int | None = None, end_ns: int | None = None) -> None:
    """Record the graph event ``name`` of ``tag`` over ``[start_ns,
    end_ns]`` (now where not given), tracing on or off."""
    global _dropped
    if start_ns is None:
        start_ns = time.perf_counter_ns()
    if len(_events) < CAPACITY:
        _events.append(Event(name, tag, start_ns, start_ns if end_ns is None else end_ns))
    else:
        _dropped += 1


def events() -> list[Event]:
    return list(_events)


def _measure_offset() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, the wall clock read
    between two reads of the other."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


def profiler_offset_ns() -> int | None:
    """What to add to a span's times to put them on the profiler's host
    clock: measured when the first span opened under a profiler (``None``
    before that)."""
    return _offset_ns


class DeviceMarks:
    """Timing marks on the card inside a step: :meth:`record` records the
    CUDA event of a name on the current stream (inside a capture, an
    event-record node that each replay records again); after the host has
    synchronised with the step, :meth:`read` gives the milliseconds between
    each mark and the one recorded before it, as ``"<mark>_ms"``.

    Intervals that repeat inside a step (one a prioritized update, say)
    are recorded by :func:`interval` while the marks are active
    (:func:`marking`): the ``k``-th interval of a name since the activation
    has its own pair of events, the same pair in every pass through the
    step's Python (the warm-up and the capture), and :meth:`read` gives
    their sum as ``"<name>_ms"``."""

    def __init__(self):
        self._events: dict[str, torch.cuda.Event] = {}
        self._pairs: dict[str, list[tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
        self._counts: dict[str, int] = {}

    @staticmethod
    def _event() -> torch.cuda.Event:
        return torch.cuda.Event(enable_timing=True, external=True)

    def record(self, name: str) -> None:
        event = self._events.get(name)
        if event is None:
            event = self._events[name] = self._event()
        event.record()

    def _pair(self, name: str) -> tuple[torch.cuda.Event, torch.cuda.Event]:
        """The events of the next interval ``name`` of this pass."""
        k = self._counts.get(name, 0)
        self._counts[name] = k + 1
        pairs = self._pairs.setdefault(name, [])
        if k == len(pairs):
            pairs.append((self._event(), self._event()))
        return pairs[k]

    def read(self) -> dict[str, float]:
        names = list(self._events)
        out = {f"{b}_ms": self._events[a].elapsed_time(self._events[b]) for a, b in zip(names, names[1:])}
        for name, pairs in self._pairs.items():
            out[f"{name}_ms"] = sum(a.elapsed_time(b) for a, b in pairs[:self._counts.get(name, 0)])
        return out


class _Interval:
    __slots__ = ("pair",)

    def __init__(self, pair: tuple[torch.cuda.Event, torch.cuda.Event]):
        self.pair = pair

    def __enter__(self) -> "_Interval":
        self.pair[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        self.pair[1].record()
        return False


_active: DeviceMarks | None = None


def interval(name: str) -> _Interval | _NoSpan:
    """A context manager that records the interval ``name`` on the card
    between its entry and its exit, on the active marks
    (:func:`marking`), and the shared no-op while none are active: a step
    built while tracing is off, or without marks, records nothing."""
    if _active is None:
        return _NO_SPAN
    return _Interval(_active._pair(name))


@contextlib.contextmanager
def marking(marks: DeviceMarks | None):
    """Make ``marks`` (``None``: none) the marks that :func:`interval`
    records on, for the body, where a pass through a step's Python starts
    its intervals anew."""
    global _active
    if marks is not None:
        marks._counts.clear()
    previous, _active = _active, marks
    try:
        yield
    finally:
        _active = previous


def device_marks(device: torch.device) -> DeviceMarks | None:
    """Marks for a step on ``device`` built now: on CUDA while tracing is
    on, else ``None`` (the step then records none)."""
    return DeviceMarks() if _on and device.type == "cuda" else None

