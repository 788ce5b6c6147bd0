"""The median over the window's supersteps (after the profiled sub-window)
of the prioritized draws' device milliseconds, summed over the superstep's
updates: each update's interval from its start to the end of its draw (the
sum tree's descent, the importance weights, the two gathers of frame
stacks, the n-step chains).  Only where the program's tracer was on when
the superstep was captured and the updates sample one by one
(:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import device_ms


def read(run):
    return device_ms(run, "per_sample")
