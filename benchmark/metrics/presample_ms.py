"""The median over the window's supersteps (after the profiled sub-window)
of the presample's device milliseconds: from the rollout's device mark to
the presample's (the replay indices, the gather kernel's two launches, the
n-step chains).  Only where the program's tracer was on when the superstep
was captured, and the updates presample (:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import device_ms


def read(run):
    return device_ms(run, "presample")
