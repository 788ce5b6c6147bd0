#!/usr/bin/env python3
"""Sweep the launch plans of ``gather_rows_cast``'s two pipeline routes on an
NVIDIA GPU: the ring's stages, the consumer warps of a block, the blocks an
SM (output-order pipeline) and the largest bulk copy, at each caller's shape, L2-cold (``chip_smoke.py``'s
8 index sets in turn, each with its own output), device ms a launch from
the profiler's kernel records, beside the simple route.  Every plan is
first checked bitwise against the plain version at each shape.  Run from
the repository root:

    python3 tools/gather_sweep.py [--out build/gather_sweep.json]

It prints the nvcc resource usage of the kernels, one line per plan and
shape, and the best plan of each route by the mean of its shares of the
bound.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from tianshou_tpu_torch.ops import _build  # noqa: E402
from tianshou_tpu_torch.ops import gather as g  # noqa: E402

SHAPES = ("atari", "atari_dedup", "atari_host")
PIPELINES = ("pipeline", "grouped")


def resource_usage() -> str:
    """nvcc's -Xptxas -v report for the kernel source."""
    out = os.path.join(str(_build.BUILD_DIR), "ptxas_report.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           str(_build.CSRC_DIR / "gather_rows_cast.cu")]
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=300).stderr


def finished_within(seconds: float) -> None:
    """Exit the process (which ends its kernels) if the stream's work has not
    finished in ``seconds``: a pipeline whose barriers never complete spins
    forever."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.perf_counter()
    while not ev.query():
        if time.perf_counter() - t0 > seconds:
            print(f"gather_sweep: the kernel did not finish within {seconds} s", flush=True)
            os._exit(3)
        time.sleep(0.01)


def plan_of(route, rows, feat, batch, stages, warps, per_sm, max_chunk, sms):
    chunk = g._chunk(feat, max_chunk)
    if route == "grouped":
        smem = g._grouped_smem(rows, batch, chunk, stages)
        if batch > 65_536 or smem > g.SMEM_PER_BLOCK:
            return None
        if per_sm * (smem + g.SMEM_RESERVED) > g.SMEM_PER_SM or per_sm * (warps + 1) * 32 > 2048:
            return None
        return g.LaunchPlan(route, grid=min(batch, sms * per_sm), warps=warps, chunk=chunk, stages=stages,
                            smem_bytes=smem)
    smem = g.BARRIER_BYTES + stages * chunk
    if per_sm * (smem + g.SMEM_RESERVED) > g.SMEM_PER_SM or per_sm * (warps + 1) * 32 > 2048:
        return None
    return g.LaunchPlan(route, grid=min(batch, sms * per_sm), warps=warps, chunk=chunk, stages=stages,
                        smem_bytes=smem)


def host_parts(storage: torch.Tensor, idx: torch.Tensor, calls: int = 200) -> dict[str, float]:
    """Host microseconds of each part of a wrapper call (and of the whole),
    each a host clock around ``calls`` repetitions with no synchronisation."""
    dev = storage.device.index
    (rows, feat), batch = storage.shape, idx.shape[0]
    out = torch.empty((batch, feat), dtype=torch.bfloat16, device=storage.device)
    plan = g.launch_plan(rows, feat, batch, True, g._sm_count(dev))
    parts = {
        "whole call": lambda: g.gather_rows_cast(storage, idx),
        "input checks": lambda: (storage.dim() != 2 or storage.dtype != torch.uint8 or not storage.is_contiguous()
                                 or idx.dim() != 1 or idx.dtype not in (torch.int64, torch.int32)
                                 or idx.device != storage.device),
        "torch.empty of the output": lambda: torch.empty((batch, feat), dtype=torch.bfloat16, device=storage.device),
        "three data_ptr()": lambda: (storage.data_ptr(), idx.data_ptr(), out.data_ptr()),
        "launch_plan (cached)": lambda: g.launch_plan(rows, feat, batch, True, g._sm_count(dev)),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "ctypes call and launch": lambda: g._launch(storage, idx, out, plan, dev),
    }
    times = {}
    for name, fn in parts.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/gather_sweep.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gather_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    _build.build(["gather_rows_cast"])
    print(resource_usage(), flush=True)
    dev = torch.cuda.current_device()
    sms = g._sm_count(dev)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # a first short launch of each route, under a watchdog
    storage, idx = cs._gather_storage(gen, 64, 7056), cs._random_idx(gen, 64, 300)
    for route in ("simple", *PIPELINES):
        got = g.gather_rows_cast(storage, idx, route=route)
        finished_within(20.0)
        assert torch.equal(got.view(torch.int16), g.gather_rows_cast_plain(storage, idx).view(torch.int16)), route
    print("first launches: every route finished and is bitwise equal", flush=True)

    host_storage, (host_idx,) = cs._caller_inputs("atari_host", gen, 1)
    parts = host_parts(host_storage, host_idx)
    print("host us a call at atari_host's shape: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()), flush=True)
    results = [dict(host_parts=parts)]
    del host_storage, host_idx
    for path in SHAPES:
        storage, sets = cs._caller_inputs(path, gen, cs.GATHER_SETS)
        (rows, feat), batch = storage.shape, sets[0].shape[0]
        outs = [torch.empty((batch, feat), dtype=torch.bfloat16, device="cuda") for _ in sets]
        refs = g.gather_rows_cast_plain(storage, sets[0]).view(torch.int16)
        bound = sum(cs._gather_bound(feat, batch, int(torch.unique(i).numel()))[0] for i in sets) / len(sets)

        def device_ms(plan):
            turn = [0]

            def fn():
                k = turn[0] % len(sets)
                turn[0] += 1
                g._launch(storage, sets[k], outs[k], plan, dev)

            for _ in range(3):
                fn()
            return cs._device_ms(fn, cs.GATHER_CALLS)

        plans = [(("simple", 0, 0, 0, 0), g.LaunchPlan("simple", grid=batch))]
        for route in PIPELINES:
            for stages in (3, 4):
                for warps in g.WARP_CHOICES:
                    for per_sm in (1, 2, 3, 4) if route == "pipeline" else (1, 2):
                        for max_chunk in (4096, 8192, 16384) if route == "pipeline" else (8192, 16384):
                            plan = plan_of(route, rows, feat, batch, stages, warps, per_sm, max_chunk, sms)
                            if plan is not None:
                                plans.append(((route, stages, warps, per_sm, max_chunk), plan))
        for _, plan in plans:
            g._launch(storage, sets[0], outs[0], plan, dev)
            finished_within(20.0)
            if not torch.equal(outs[0].view(torch.int16), refs):
                raise AssertionError(f"{path} {plan} differs from the plain version")
        for rep in range(2):  # two passes, the second in reverse order
            for (route, stages, warps, per_sm, max_chunk), plan in plans[::1 if rep == 0 else -1]:
                ms = device_ms(plan)
                results.append(dict(path=path, shape=[rows, feat, batch], route=route, stages=stages, warps=warps,
                                    per_sm=per_sm, max_chunk=max_chunk, chunk=plan.chunk, grid=plan.grid,
                                    smem=plan.smem_bytes, rep=rep, device_ms=ms, bound_ms=bound))
                print(f"{path} {route} stages {stages} warps {warps} per_sm {per_sm} chunk {plan.chunk} "
                      f"grid {plan.grid} smem {plan.smem_bytes}: {ms:.4f} ms, {bound / ms:.3f} of {bound:.4f}",
                      flush=True)
        # floors: a fill of the same outputs (their bytes written once); the
        # grouped route at rows of 16 bytes (its passes over the indices and
        # a round trip of the ring a row) and with every index out of range
        # (its passes alone: no row is owned, nothing is stored)
        filled = [0]

        def fill():
            outs[filled[0] % len(outs)].fill_(0)
            filled[0] += 1

        floors = {"fill": cs._device_ms(fill, cs.GATHER_CALLS)}
        narrow = cs._gather_storage(gen, rows, 16)
        small = [torch.empty((batch, 16), dtype=torch.bfloat16, device="cuda") for _ in sets]
        for warps in g.WARP_CHOICES:
            plan = plan_of("grouped", rows, 16, batch, 3, warps, 1, 16384, sms)
            if plan is not None:
                turn = [0]

                def fn():
                    k = turn[0] % len(sets)
                    turn[0] += 1
                    g._launch(narrow, sets[k], small[k], plan, dev)

                floors[f"grouped F=16, {warps} warps"] = cs._device_ms(fn, cs.GATHER_CALLS)
                outside = torch.full_like(sets[0], rows)
                floors[f"grouped passes, {warps} warps"] = cs._device_ms(
                    lambda plan=plan, outside=outside: g._launch(narrow, outside, small[0], plan, dev),
                    cs.GATHER_CALLS)
        print(f"{path} floors: " + ", ".join(f"{k} {v:.4f} ms" for k, v in floors.items()), flush=True)
        results.append(dict(path=path, floors=floors))
        del storage, sets, outs, refs, narrow, small
        torch.cuda.empty_cache()

    def key(r):
        return (r["route"], r["stages"], r["warps"], r["per_sm"], r["max_chunk"])

    totals: dict = {}
    for r in results:
        if "floors" in r or "host_parts" in r:
            continue
        totals.setdefault(key(r), {}).setdefault(r["path"], []).append(r["device_ms"] / r["bound_ms"])
    for route in ("simple", *PIPELINES):
        ranked = sorted(((sum(sum(v) / len(v) for v in by.values()) / len(by), k) for k, by in totals.items()
                         if k[0] == route))
        if ranked:
            total, k = ranked[0]
            shares = {p: len(v) / sum(v) for p, v in totals[k].items()}
            print(f"best {route} (over {len(totals[k])} shapes): stages {k[1]} warps {k[2]} per_sm {k[3]} "
                  f"max_chunk {k[4]}: "
                  "share of the bound "
                  + ", ".join(f"{p} {s:.3f}" for p, s in shares.items()), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
