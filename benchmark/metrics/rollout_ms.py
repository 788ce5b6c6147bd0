"""The median over the window's supersteps (after the profiled sub-window)
of the rollout's device milliseconds: from the superstep's first device
mark to the rollout's, inside its CUDA graph.  Only where the program's
tracer was on when the superstep was captured
(:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import device_ms


def read(run):
    return device_ms(run, "rollout")
