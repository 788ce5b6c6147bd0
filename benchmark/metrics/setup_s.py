"""Seconds from the process's start to the window's: imports, the kernel's
build (only in a checkout's first run), the ring's fill, the captures and
the first epoch with its test phase, the correctness snapshots included."""


def read(run):
    return run.setup_s
