"""The 95th percentile over the window's supersteps of each one's wall time:
from the end of the previous superstep's host read, or of the test phase
that followed it, to the end of its own (linear interpolation between order
statistics).  In a traced run the supersteps under the profiler are left
out."""

from benchmark.harness import percentile


def read(run):
    start = run.profiled_until if run.profiled_until is not None else run.window_start
    times = [r["dt"] * 1e3 for r in run.supersteps if r["in_window"] and r["t_end"] > start]
    return percentile(times, 95) if times else None
