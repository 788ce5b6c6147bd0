"""The share of the traced window in which no operation ran on the card:
1 - (union of the device records' intervals) / (the window), in %."""


def read(run):
    t = run.trace_result
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
