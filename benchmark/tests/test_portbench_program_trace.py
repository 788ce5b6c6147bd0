"""The per-layer metrics that read the program's own tracer
(``benchmark/program_trace.py``): each reader on synthetic spans and graph
events with a known answer, nothing from a program without a tracer, and a
tiny CPU run with the tracer on, whose spans the readers find."""

import sys
import time
import types

import pytest

from benchmark.harness import load_reader
from benchmark.tests.conftest import tiny_spec
from tianshou_tpu_torch.utils import trace

MS = 1_000_000
S = 1_000_000_000
SPAN_METRICS = ("rollout_ms", "presample_ms", "updates_ms", "host_turnaround_ms")
GRAPH_METRICS = ("captures_in_window", "captures_unreplayed", "setup_warm_up_s", "setup_capture_s")


def _superstep(k: int, t: int, device: dict | None, spans: list) -> int:
    """Superstep ``k`` from ``t`` ns: 1 ms of param, 60 ms of launch, 2
    ms of host read, then 1 ms each of summarize and log; returns its end."""
    at = len(spans)
    spans.append(trace.Span("tianshou.superstep", None, t, t + 65 * MS, -1, k, device))
    for name, a, b in (("param", 0, 1), ("launch", 1, 61), ("host_read", 61, 63), ("summarize", 63, 64),
                       ("log", 64, 65)):
        spans.append(trace.Span(f"tianshou.superstep.{name}", None, t + a * MS, t + b * MS, at, k))
    return t + 65 * MS


def _run():
    """Supersteps 1-6 start at 10 s, 65 ms apart and back to back but for
    an epoch end of 10 ms after superstep 4; the window runs from 10 s to
    the start of superstep 6, the profiler's sub-window to superstep 2's
    start.  Graph events: a fill (tag ``f``) warmed up and captured in
    set-up and never replayed, the superstep (``s``) captured in set-up and
    replayed, a test chunk (``e``) captured in the window and replayed
    after it."""
    spans, t = [], 10 * S
    starts = []
    for k in range(1, 7):
        starts.append(t)
        t = _superstep(k, t, {"rollout_ms": 5.0 + k, "presample_ms": 1.0, "updates_ms": 50.0}, spans)
        if k == 4:
            spans.append(trace.Span("tianshou.epoch_end", None, t, t + 10 * MS, -1, k))
            t += 10 * MS
    events = [trace.Event("graph.warm_up", "f", 1 * S, 3 * S), trace.Event("graph.capture", "f", 3 * S, 4 * S),
              trace.Event("graph.warm_up", "s", 5 * S, 6 * S), trace.Event("graph.capture", "s", 6 * S, 7 * S),
              trace.Event("graph.first_replay", "s", 8 * S, 8 * S),
              trace.Event("graph.warm_up", "e", 10 * S + 70 * MS, 10 * S + 80 * MS),
              trace.Event("graph.capture", "e", 10 * S + 80 * MS, 10 * S + 90 * MS),
              trace.Event("graph.first_replay", "e", 20 * S, 20 * S)]
    return types.SimpleNamespace(window_start=10.0, window_end=starts[5] / 1e9, profiled_until=starts[1] / 1e9,
                                 program_trace={"spans": spans, "events": events})


def test_readers_on_synthetic_spans_and_events():
    run = _run()
    got = {name: load_reader(name)(run) for name in SPAN_METRICS + GRAPH_METRICS}
    # supersteps 2-6 (1 is in the profiler's sub-window): rollout 7-11 ms
    assert got["rollout_ms"] == 9.0 and got["presample_ms"] == 1.0 and got["updates_ms"] == 50.0
    # 3 ms from a host read's end to the next launch, except across the epoch end (4 -> 5)
    assert got["host_turnaround_ms"] == pytest.approx(3.0)
    assert got["captures_in_window"] == 1.0
    assert got["captures_unreplayed"] == 2.0  # the fill, and the chunk whose first replay came after the window
    assert got["setup_warm_up_s"] == pytest.approx(3.0) and got["setup_capture_s"] == pytest.approx(2.0)


def test_readers_give_nothing_where_nothing_was_recorded(monkeypatch):
    run = _run()
    run.program_trace = {"spans": [], "events": []}
    assert all(load_reader(name)(run) is None for name in SPAN_METRICS + GRAPH_METRICS)
    # a program without the tracer (the parent commit's)
    del run.program_trace
    import tianshou_tpu_torch.utils

    monkeypatch.delattr(tianshou_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "tianshou_tpu_torch.utils.trace", None)
    assert all(load_reader(name)(run) is None for name in SPAN_METRICS + GRAPH_METRICS)


def test_tiny_cpu_run_with_the_tracer_on():
    from benchmark.harness import execute

    trace.clear()
    trace.enable()
    try:
        run = execute(tiny_spec("nature_dqn.actors"), 2**31 + 9, 0.3, False, "cpu", time.perf_counter())
    finally:
        trace.disable()
    try:
        assert load_reader("host_turnaround_ms")(run) > 0
        # the CPU runs its steps eagerly: no device marks, no graphs
        assert all(load_reader(name)(run) is None for name in ("rollout_ms",) + GRAPH_METRICS)
        names = {s.name for s in trace.spans()}
        assert {"tianshou.run", "tianshou.setup.ring_fill", "tianshou.superstep.launch",
                "tianshou.test.chunk"} <= names
    finally:
        trace.clear()
