"""What the program's own tracer (``tianshou_tpu_torch.utils.trace``)
recorded in a run, for the per-layer metrics that read it.

A reader takes the record from ``run.program_trace`` (``{"spans": [...],
"events": [...]}``) where the run holds one, and else from the tracer
itself, which lives in the run's process: spans where the tracer was on
(``benchmark/traced_run.py`` turns it on; ``benchmark/run.py`` does not),
graph events (warm-ups, captures, first replays of the compiled steps)
always.  Times are ``time.perf_counter_ns()``, the clock of the run's
``time.perf_counter()`` marks.  A checkout whose program has no tracer
gives ``None``, and each metric is then left out.

The window's supersteps are those whose ``tianshou.superstep`` span starts
inside the window and after the profiled sub-window, as
``superstep_ms.p95`` leaves the traced supersteps out.
"""

from __future__ import annotations

import statistics

__all__ = ["record", "window_supersteps", "device_ms", "host_turnaround_ms", "setup_graph_s", "captures_in_window",
           "captures_unreplayed"]


def record(run) -> dict | None:
    """``{"spans", "events"}`` of the run's program, or ``None``."""
    held = getattr(run, "program_trace", None)
    if held is not None:
        return held
    try:
        from tianshou_tpu_torch.utils import trace
    except ImportError:
        return None
    return {"spans": trace.spans(), "events": trace.events()}


def _ns(t: float) -> int:
    return round(t * 1e9)


def window_supersteps(run) -> list[dict]:
    """The window's supersteps after the profiled sub-window, in order:
    ``{"span": the superstep's span, "<child>": each child span by the last
    part of its name}``."""
    rec = record(run)
    if rec is None:
        return []
    start = run.profiled_until if run.profiled_until is not None else run.window_start
    lo, hi = _ns(start), _ns(run.window_end)
    steps = {s.superstep: {"span": s} for s in rec["spans"]
             if s.name == "tianshou.superstep" and lo <= s.start_ns <= hi and s.end_ns is not None}
    for s in rec["spans"]:
        if s.name.startswith("tianshou.superstep.") and s.superstep in steps:
            steps[s.superstep][s.name.rsplit(".", 1)[1]] = s
    return [steps[k] for k in sorted(steps)]


def device_ms(run, part: str) -> float | None:
    """The median over the window's supersteps of the device milliseconds
    of ``part`` (``rollout``, ``presample``, ``updates``): the time between
    its device mark and the one before it."""
    key = f"{part}_ms"
    values = [s["span"].data[key] for s in window_supersteps(run) if s["span"].data and key in s["span"].data]
    return statistics.median(values) if values else None


def host_turnaround_ms(run) -> float | None:
    """The mean over consecutive window supersteps of the host's time from
    one's host read's end to the next one's launch, where no epoch ends
    between them: the card has no work queued then."""
    steps = window_supersteps(run)
    if not steps:
        return None
    epoch_ends = [s.start_ns for s in record(run)["spans"] if s.name == "tianshou.epoch_end"]
    gaps = []
    for a, b in zip(steps, steps[1:]):
        if b["span"].superstep != a["span"].superstep + 1 or "host_read" not in a or "launch" not in b:
            continue
        t0, t1 = a["host_read"].end_ns, b["launch"].start_ns
        if not any(t0 <= t <= t1 for t in epoch_ends):
            gaps.append((t1 - t0) / 1e6)
    return statistics.fmean(gaps) if gaps else None


def _events(run, name: str) -> list | None:
    rec = record(run)
    if rec is None or not rec["events"]:
        return None
    return [e for e in rec["events"] if e.name == name]


def setup_graph_s(run, name: str) -> float | None:
    """Seconds of the graph events ``name`` (``graph.warm_up``,
    ``graph.capture``) that ended before the window."""
    events = _events(run, name)
    if events is None:
        return None
    end = _ns(run.window_start)
    return sum(e.end_ns - e.start_ns for e in events if e.end_ns <= end) / 1e9


def captures_in_window(run) -> int | None:
    """Graph captures that started inside the window."""
    events = _events(run, "graph.capture")
    if events is None:
        return None
    lo, hi = _ns(run.window_start), _ns(run.window_end)
    return sum(lo <= e.start_ns <= hi for e in events)


def captures_unreplayed(run) -> int | None:
    """Graphs captured by the window's end that no replay had run by then:
    per tag (a step's name and pattern), its captures less its first
    replays up to the window's end."""
    captures = _events(run, "graph.capture")
    if captures is None:
        return None
    end = _ns(run.window_end)
    left: dict[str, int] = {}
    for e in captures:
        if e.end_ns <= end:
            left[e.tag] = left.get(e.tag, 0) + 1
    for e in _events(run, "graph.first_replay"):
        if e.start_ns <= end and e.tag in left:
            left[e.tag] -= 1
    return sum(max(0, n) for n in left.values())
