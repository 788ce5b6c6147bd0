#!/usr/bin/env python3
"""Profile one of the port's on-device supersteps on one NVIDIA GPU.

    python3 tools/profile_superstep.py [--path atari] [--supersteps 2] [--out build/profile]

Builds a path of ``chip_smoke.py`` at full width (``--path``: ``atari``,
the pixel superstep; ``atari_dedup``, the same over the deduplicated
frame-stack buffer; ``cartpole``, the CartPole headline; ``minatar``,
MinAtar Breakout; ``sac_pendulum`` and ``td3_pendulum``, the continuous
updates on the on-device Pendulum; ``ppo_cartpole`` and ``trpo_pendulum``,
the on-policy supersteps; ``rainbow_per``, Rainbow on a prioritized ring;
``qrdqn_minatar``, QRDQN at MinAtar conv width), runs two warm-up supersteps, then traces
``--supersteps`` more with ``torch.profiler``.  Prints the device's busy time a superstep (the union of
its kernels' intervals) and its share of the traced wall time, the number
of kernels a superstep, the time of a few kernels named in PERF.md, and the
device time by kernel (top 25); writes the full table and a Chrome trace
under ``--out``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", default="atari", choices=["atari", "atari_dedup", "cartpole", "minatar", "sac_pendulum",
                                                             "td3_pendulum", "ppo_cartpole", "trpo_pendulum",
                                                             "rainbow_per", "qrdqn_minatar"])
    parser.add_argument("--supersteps", type=int, default=2)
    parser.add_argument("--out", default="build/profile")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_superstep: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"path {args.path}: {chip_smoke.PATHS[args.path]}", flush=True)
    _, algo, col, buffer, trainer = chip_smoke.build(args.path)
    gen, *state = chip_smoke.init_states(algo, col, buffer)
    superstep = chip_smoke.superstep_of(trainer, state, gen)
    for _ in range(2):
        superstep()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.supersteps):
            superstep()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # device busy time: the union of the kernels' intervals
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    n = args.supersteps
    print(f"{n} supersteps traced (profiler on): wall {wall * 1e3 / n:.2f} ms a superstep, device busy "
          f"{busy_us / 1e3 / n:.2f} ms a superstep (share {busy_us / 1e6 / wall:.3f}), "
          f"{len(kernels) / n:.0f} device kernels a superstep")
    for name in ("gather_rows_cast", "nhwcToNchwKernel", "f32f32_f32f32", "addcmul", "Memcpy"):
        hits = [e.time_range.elapsed_us() for e in kernels if name in e.name]
        if hits:
            print(f"  kernels matching {name!r}: {len(hits) / n:.0f} a superstep, "
                  f"{sum(hits) / 1e3 / n:.3f} ms a superstep, {sum(hits) / len(hits):.1f} us each")
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=25, max_name_column_width=70)
    print(table)
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"profile_superstep_{args.path}")
    with open(stem + ".txt", "w") as f:
        f.write(smi + "\n" + prof.key_averages().table(sort_by="device_time_total", row_limit=200))
    prof.export_chrome_trace(stem + ".json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
