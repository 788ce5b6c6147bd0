"""CUDA graphs captured inside the window: a graph built again where every
graph should be replayed.  From the program's graph events, which its
tracer records on or off (:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import captures_in_window


def read(run):
    n = captures_in_window(run)
    return None if n is None else float(n)
