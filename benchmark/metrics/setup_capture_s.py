"""Seconds of set-up in the compiled steps' captures (instantiation
included), summed over those that ended before the window.  From the
program's graph events, which its tracer records on or off
(:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import setup_graph_s


def read(run):
    return setup_graph_s(run, "graph.capture")
