"""CUDA graphs captured by the window's end that no replay had run by then
(a step's name and pattern each): set-up's captures that bought nothing.
From the program's graph events, which its tracer records on or off
(:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import captures_unreplayed


def read(run):
    n = captures_unreplayed(run)
    return None if n is None else float(n)
