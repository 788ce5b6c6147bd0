"""Env steps the window's training supersteps collected, over the window's
whole time, test phases included (test env steps are not counted)."""


def read(run):
    done = sum(r["in_window"] for r in run.supersteps)
    steps = run.traffic["num_envs"] * run.traffic["segment"]
    return done * steps / (run.window_end - run.window_start)
