"""Run one cell with the program's own tracer on, and print the per-layer
metrics that read its spans beside the cell's others.

    python3 benchmark/traced_run.py --workload nature_dqn.replay --seed 7 --seconds 30 --profile 1

``benchmark/run.py`` leaves the program's tracer
(``tianshou_tpu_torch.utils.trace``) off, so its runs read only what the
tracer records off as well: counters and graph events.  Here the tracer is
on from before the program is built, so the captured superstep holds its
device marks and ``run()`` records its spans; the metrics that read them
(``rollout_ms``, ``presample_ms``, ``updates_ms``, ``host_turnaround_ms``)
are printed with every per-layer metric of the cell and its end-to-end
ones, whose difference from ``run.py``'s is the tracing's cost.

With ``--profile 1`` the run is ``run.py --trace 1``'s: the profiler's
sub-window (:mod:`benchmark.subwindow`), whose summary here leaves out the
device track's user annotations (the program's spans there are ranges, not
work) and names each idle gap by the shortest program or benchmark span
that covers its midpoint.  ``--profile 0`` runs no profiler.  The last line
of standard output is the result; ``split_ms`` holds the three device parts
of a superstep, their sum, and the sub-window's busy time a superstep.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the metrics that read the program's spans, which need the tracer on
SPAN_METRICS = ("rollout_ms", "presample_ms", "updates_ms", "host_turnaround_ms")


def idle_gaps(records, top: int = 10) -> list[list]:
    """The longest gaps between the device's work in the sub-window, each
    named by the shortest ``tianshou.*`` or ``bench.*`` host span that
    covers its midpoint (``other`` where none does)."""
    import torch

    from benchmark.subwindow import _union

    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in records if e.device_type() == cuda]
    spins = [e for e in device if "spin_kernel" in e.name()]
    w0 = max(e.end_ns() for e in spins) if spins else min(e.start_ns() for e in device)
    merged = _union([(e.start_ns(), e.end_ns()) for e in device if "spin_kernel" not in e.name()
                     and e.start_ns() >= w0])
    spans = sorted(((e.end_ns() - e.start_ns(), e.start_ns(), e.end_ns(), e.name()) for e in records
                    if e.device_type() != cuda and e.name().startswith(("tianshou.", "bench."))))
    edges = [w0] + [x for ab in merged for x in ab]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) // 2
            gaps.append([next((s for _, s0, s1, s in spans if s0 <= mid <= s1), "other"), (b - a) / 1e9])
    return sorted(gaps, key=lambda g: -g[1])[:top]


def annotations_left_out(summarize):
    """``summarize`` over the records without the device track's user
    annotations, its idle gaps named by :func:`idle_gaps`."""
    import torch

    def without(records, n):
        cuda = torch.autograd.DeviceType.CUDA
        kept = [e for e in records if not (e.device_type() == cuda and (
            e.is_user_annotation() or e.name().startswith("tianshou.")))]
        out = summarize(kept, n)
        if out.get("busy_s") is not None:
            out["breakdown"]["idle_gaps"] = idle_gaps(kept)
        return out

    return without


def setup_split(record, window_start_ns: int) -> dict:
    """Set-up's seconds by the program's spans and graph events before the
    window: init, the ring's fill (its warm-up and capture inside it),
    each compiled step's warm-up and capture, and epoch 1 (from the first
    superstep's start to the window)."""
    out = {}
    for s in record["spans"]:
        if s.name in ("tianshou.setup.init", "tianshou.setup.ring_fill"):
            out[s.name.rsplit(".", 1)[1]] = (s.end_ns - s.start_ns) / 1e9
    for e in record["events"]:
        if e.name in ("graph.warm_up", "graph.capture") and e.end_ns <= window_start_ns:
            key = f"{e.tag} {e.name.split('.')[1]}"
            out[key] = out.get(key, 0.0) + (e.end_ns - e.start_ns) / 1e9
    first = min((s.start_ns for s in record["spans"] if s.name == "tianshou.superstep"), default=None)
    if first is not None:
        out["epoch_1"] = (window_start_ns - first) / 1e9
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [q for q in sys.path if Path(q or ".").resolve() != here]
    import torch

    from benchmark import harness, program_trace, subwindow
    from tianshou_tpu_torch.utils import trace

    spec = harness.load_cell(args.workload, json.loads((ROOT / "BENCHMARK.json").read_text()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print("the cell needs CUDA", file=sys.stderr)
        return 2
    subwindow.summarize = annotations_left_out(subwindow.summarize)
    trace.enable()
    run = harness.execute(spec, args.seed, args.seconds, bool(args.profile), "cuda", T0)
    trace.disable()
    correct, checks, _ = harness.judge(run, "cuda")
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [n for n in SPAN_METRICS if n not in names]
    metrics = {}
    for name in names:
        value = harness.load_reader(name)(run)
        if value is not None:
            metrics[name] = value
    parts = [metrics.get(f"{k}_ms") for k in ("rollout", "presample", "updates")]
    split = {"sum": sum(x for x in parts if x is not None)}
    t = run.trace_result
    if t and t.get("busy_s") is not None:
        split["busy_a_superstep"] = t["busy_s"] / t["n"] * 1e3
    record = program_trace.record(run)
    out = {"correct": correct, "metrics": metrics, "split_ms": split,
           "setup_split_s": setup_split(record, round(run.window_start * 1e9)),
           "setup_parts_s": harness.setup_parts(run), "spans": len(record["spans"]), "dropped": trace.dropped(),
           "counters": {f"{k[0]} {k[1]}": v for k, v in trace.counters().items()},
           "device": harness.device_info(run.peak, True),
           "window": {"seconds": run.window_end - run.window_start,
                      "supersteps": sum(r["in_window"] for r in run.supersteps)}}
    if t:
        out["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        out["breakdown"] = t["breakdown"]
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
