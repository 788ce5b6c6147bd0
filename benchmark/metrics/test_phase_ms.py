"""The mean wall time of the window's test phases, from the epoch end's
``save_data`` to ``log_test_data``."""


def read(run):
    if not run.tests:
        return None
    return sum(b - a for a, b in run.tests) / len(run.tests) * 1e3
