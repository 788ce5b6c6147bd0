"""``mfu``'s share for a Rainbow configuration: model FLOPs a second over
the published dense peak of the dtype the configuration computes in, in
%, over the same supersteps and time as ``mfu``, with the FLOPs counted by
:mod:`benchmark.flops_rainbow` (the convolutions and the noisy streams'
matrix products)."""

from benchmark import flops_rainbow


def read(run):
    start = run.profiled_until if run.profiled_until is not None else run.window_start
    if start >= run.window_end:
        return None
    done = sum(r["in_window"] and r["t_end"] > start for r in run.supersteps)
    if not done:
        return None
    flops = flops_rainbow.superstep_flops(run.config, run.traffic)
    return 100.0 * done * flops / (run.window_end - start) / run.config["peak_flops"]
