"""The mean host time between two of the window's supersteps (after the
profiled sub-window), from one's host read's end to the next one's
launch, with no epoch end between them: summarising, logging and the next
``train_param_fn``, with no work queued on the card.  From the program's
spans, where its tracer was on (:mod:`benchmark.program_trace`)."""

from benchmark.program_trace import host_turnaround_ms


def read(run):
    return host_turnaround_ms(run)
