"""Device operations (kernels, copies, fills) a superstep, from the
profiler's device records of the traced supersteps."""


def read(run):
    t = run.trace_result
    if not t or t.get("busy_s") is None:
        return None
    return t["device_ops"] / t["n"]
