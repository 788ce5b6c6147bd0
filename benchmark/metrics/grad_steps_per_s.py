"""Gradient updates the window's supersteps completed, over the window's
whole time."""


def read(run):
    done = sum(r["in_window"] for r in run.supersteps)
    return done * run.traffic["updates"] / (run.window_end - run.window_start)
