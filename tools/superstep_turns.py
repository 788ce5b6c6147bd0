#!/usr/bin/env python3
"""Time supersteps of ``chip_smoke.py``'s paths in several trees of the port
in one run on one NVIDIA GPU, to tell a regression from the host's speed:
times taken in different runs move with the host by up to 3x.

Each tree is a directory that holds a ``chip_smoke.py`` and the
``tianshou_tpu_torch`` package beside it, for example a commit unpacked
with ``git archive <commit> chip_smoke.py tianshou_tpu_torch | tar -x -C
build/<name>``.  Every (tree, path) is timed in a process of its own (so
that no two trees' modules mix), through the tree's own ``chip_smoke.py``:
its kernel build where the path launches the kernel, the path at full width
(``build`` or, for an offline path, ``build_offline_path``), 2 warm-up
supersteps, then ``--n`` supersteps timed on the host clock, each up to a
device synchronisation, then one superstep under ``torch.profiler`` (device
kernels and busy ms).  For each path the trees run in turns, first in the
order given, then reversed (``--turns`` rounds), so that a drift of the
host's speed during the run weighs on every tree alike.

    python3 tools/superstep_turns.py build/parent . [--paths atari,sac_pendulum] [--n 5] [--turns 1]

Prints one line a process and, last, a JSON object with every path's and
tree's times (ms a superstep, medians), kernels a superstep and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def child(tree: str, path: str, n: int) -> dict:
    """One tree's ``path`` superstep timed in this process."""
    import torch

    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    from tianshou_tpu_torch.utils.device import fork_generator, make_generator

    if cs.KERNEL_LAUNCHES.get(path):
        cs.phase_build()
    if path in cs.OFFLINE_PATHS:
        _, algo, _, buffer, bstate, trainer = cs.build_offline_path(path, "cuda")
        gen = make_generator(0, algo.device)
        state = [algo.init(fork_generator(gen)),
                 algo.prepare_offline(buffer, bstate) if hasattr(algo, "prepare_offline") else bstate]
        fn = trainer._build_superstep()

        def step():
            state[0], state[1], metrics = fn(state[0], state[1], gen)
            return metrics
    else:
        _, algo, col, buffer, trainer = cs.build(path)
        gen, *state = cs.init_states(algo, col, buffer)
        step = cs.superstep_of(trainer, state, gen)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(v == v for v in (float(x) for x in metrics.values())):
        raise AssertionError(f"{tree} {path}: non-finite metrics {metrics}")
    kernels, busy_ms = cs._profile_counts(step)
    return {"tree": tree, "path": path, "ms": times, "kernels": kernels, "busy_ms": busy_ms,
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--paths", default="atari", help="comma-separated paths of chip_smoke.PATHS")
    ap.add_argument("--n", type=int, default=5, help="timed supersteps a process")
    ap.add_argument("--turns", type=int, default=1, help="rounds of (forward, reversed) order")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.paths, args.n)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("superstep_turns: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    summary = {}
    for path in args.paths.split(","):
        ms: dict[str, list[float]] = {t: [] for t in args.trees}
        kernels: dict[str, list[int]] = {t: [] for t in args.trees}
        busy: dict[str, list[float]] = {t: [] for t in args.trees}
        for _ in range(args.turns):
            for order in (args.trees, args.trees[::-1]):
                for tree in order:
                    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--paths", path,
                                          "--n", str(args.n), tree], capture_output=True, text=True, timeout=900)
                    if out.returncode != 0:
                        print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                        return out.returncode
                    res = json.loads(out.stdout.strip().splitlines()[-1])
                    ms[tree] += res["ms"]
                    kernels[tree].append(res["kernels"])
                    busy[tree].append(res["busy_ms"])
                    print(f"{tree}: {path} superstep ms {', '.join(f'{x:.2f}' for x in res['ms'])}; "
                          f"{res['kernels']} kernels, busy {res['busy_ms']:.2f} ms", flush=True)
        summary[path] = {t: {"median_ms": sorted(v)[len(v) // 2], "ms": v, "kernels": kernels[t], "busy_ms": busy[t]}
                         for t, v in ms.items()}
    print(json.dumps({"card": card, "supersteps": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
