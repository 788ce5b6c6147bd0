"""The host's CUDA launch calls (kernel and graph launches, copies, fills)
a superstep, from the profiler's runtime records of the traced
supersteps."""


def read(run):
    t = run.trace_result
    if not t or t.get("busy_s") is None:
        return None
    return t["host_calls"] / t["n"]
