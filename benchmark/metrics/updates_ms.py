"""The median over the window's supersteps (after the profiled sub-window)
of the k updates' device milliseconds: from the presample's device mark
to the updates' end.  Only where the program's tracer was on when the
superstep was captured (:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import device_ms


def read(run):
    return device_ms(run, "updates")
