"""A ``torch.profiler`` trace of a few supersteps inside the window of a
``--trace 1`` run, and what the per-layer metrics read from it.

The trace opens with a spin on the card and ``PADDING`` short ones, all left
out: the profiler drops the first device records of a window, and the
spins take the loss (the method of ``chip_smoke._device_records``).  The
traced window runs from the end of the last spin to the end of the last
device record of the traced supersteps.  The benchmark's own host spans,
opened and closed by its hooks, name the gaps in which the card was idle:
``bench.superstep`` from the benchmark's ``train_param_fn`` (called just
before the superstep's launch) to its train-data log (after the host read
and the summary), ``bench.loop`` from there to the next launch.
"""

from __future__ import annotations

import collections
import time

import torch

__all__ = ["SubWindow", "LAUNCH_CALLS", "PADDING", "summarize"]

PADDING = 64
SPIN_CYCLES = 200_000_000
# the host's launches of work onto the card: the CUDA calls that the
# profiler records
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaLaunchCooperativeKernel")


class SubWindow:
    """The trace of ``n`` supersteps, driven by the benchmark's hooks."""

    def __init__(self, n: int):
        self.n = n
        self.count = 0
        self.prof = None
        self.span = None

    def _open(self, name: str) -> None:
        self.span = torch.autograd.profiler.record_function(name)
        self.span.__enter__()

    def _close(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(PADDING):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self._open("bench.loop")

    def launch(self) -> None:
        self._close()
        self._open("bench.superstep")

    def superstep_done(self) -> None:
        self._close()
        self.count += 1
        if not self.done:
            self._open("bench.loop")

    @property
    def done(self) -> bool:
        return self.count >= self.n

    def finish(self) -> dict:
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        records = self.prof.profiler.kineto_results.events()
        out = summarize(records, self.n)
        out["stop_s"] = time.perf_counter() - t
        self.prof = None
        return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(records, n: int) -> dict:
    """The traced window of ``n`` supersteps from the profiler's raw records:
    device busy and window seconds, device operations and host launch calls
    a superstep, ``gather_rows_cast``'s launches and seconds, and the
    breakdown (the device operations that took most time, the longest idle
    gaps by the host span they fell in)."""
    cuda = torch.autograd.DeviceType.CUDA
    # the device track also carries the host spans as annotations: not work
    device = [e for e in records if e.device_type() == cuda and not e.name().startswith("bench.")]
    spins = [e for e in device if "spin_kernel" in e.name()]
    ops = [e for e in device if "spin_kernel" not in e.name()]
    w0 = max((e.end_ns() for e in spins), default=min((e.start_ns() for e in ops), default=0))
    ops = [e for e in ops if e.start_ns() >= w0]
    if not ops:
        return {"busy_s": None, "window_s": None, "n": n}
    w1 = max(e.end_ns() for e in ops)
    merged = _union([(e.start_ns(), e.end_ns()) for e in ops])
    busy_ns = sum(b - a for a, b in merged)
    host = [e for e in records if e.device_type() != cuda]
    calls = sorted((e for e in host if e.name() in LAUNCH_CALLS), key=lambda e: e.start_ns())
    calls = calls[1 + PADDING:]
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in host if e.name().startswith("bench.")]
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) // 2
            name = next((s for s0, s1, s in spans if s0 <= mid <= s1), "other")
            gaps.append((name, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    by_name: dict[str, float] = collections.defaultdict(float)
    for e in ops:
        by_name[e.name()] += (e.end_ns() - e.start_ns()) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gather = [(e.end_ns() - e.start_ns()) / 1e9 for e in ops if "gather_rows_cast" in e.name()]
    return {"n": n, "busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9, "device_ops": len(ops),
            "host_calls": len(calls), "host_call_names": dict(collections.Counter(e.name() for e in calls)),
            "gather_launches": len(gather), "gather_s": sum(gather),
            "breakdown": {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps[:10]]}}
