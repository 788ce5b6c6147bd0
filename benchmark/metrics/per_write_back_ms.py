"""The median over the window's supersteps (after the profiled sub-window)
of the priority write-backs' device milliseconds, summed over the
superstep's updates: the sum tree's leaves and ancestors rewritten and the
running extrema moved.  Only where the program's tracer was on when the
superstep was captured and the updates sample one by one
(:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import device_ms


def read(run):
    return device_ms(run, "per_write_back")
