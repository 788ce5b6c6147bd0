"""Model FLOPs a second over the published dense peak of the dtype the
configuration computes in, in %: the supersteps of the window that
follow the traced sub-window (whose profiler would slow them), over the
time from the trace's end to the window's.  FLOPs are counted from shapes
(:mod:`benchmark.flops`): the updates and one forward an acting step; the
test phases' forwards are not counted, their time is."""


def read(run):
    start = run.profiled_until if run.profiled_until is not None else run.window_start
    if start >= run.window_end:
        return None
    done = sum(r["in_window"] and r["t_end"] > start for r in run.supersteps)
    if not done:
        return None
    return 100.0 * done * run.flops_per_superstep / (run.window_end - start) / run.config["peak_flops"]
