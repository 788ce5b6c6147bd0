#!/usr/bin/env python3
"""Time the ``atari`` superstep of several trees of the port in one run on
one NVIDIA GPU, to tell a regression from the host's speed: times taken in
different runs move with the host by up to 2x.

Each tree is a directory that holds a ``chip_smoke.py`` and the
``tianshou_tpu_torch`` package beside it, for example a commit unpacked
with ``git archive <commit> chip_smoke.py tianshou_tpu_torch | tar -x -C
build/<name>``.  Every tree is timed in a process of its own (so that no
two trees' modules mix), through its own ``chip_smoke.py``: its kernel
build, its ``atari`` configuration (``build_slice`` in the first slice,
``build_path("atari", ...)`` after it), 2 warm-up supersteps, then
``--n`` supersteps timed on the host clock up to a synchronising read of
the last loss.  The trees run in turns, first in the order given, then
reversed (``--turns`` rounds), so that a drift of the host's speed during
the run weighs on every tree alike.

    python3 tools/atari_superstep.py build/pr1 build/head [--n 5] [--turns 2]

Prints one line a process and, last, a JSON object with every tree's times
(ms a superstep) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def child(tree: str, n: int) -> dict:
    """One tree's ``atari`` superstep timed in this process."""
    import torch

    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs

    cs.phase_build()
    built = cs.build_slice("cuda") if hasattr(cs, "build_slice") else cs.build_path("atari", "cuda")
    _, algo, col, buffer, trainer = built
    gen, ts, cstate, bstate = cs.init_states(algo, col, buffer)
    superstep = trainer._build_superstep()
    for _ in range(2):
        ts, cstate, bstate, _, metrics = superstep(ts, cstate, bstate, gen, 0.1)
    float(metrics["loss"])
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        ts, cstate, bstate, _, metrics = superstep(ts, cstate, bstate, gen, 0.1)
        loss = float(metrics["loss"])  # synchronises
        times.append((time.perf_counter() - t0) * 1e3)
    if loss != loss:
        raise AssertionError(f"{tree}: non-finite loss")
    return {"tree": tree, "ms": times, "device": torch.cuda.get_device_name(0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--n", type=int, default=5, help="timed supersteps a process")
    ap.add_argument("--turns", type=int, default=2, help="rounds of (forward, reversed) order")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.trees[0], args.n)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("atari_superstep: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    results: dict[str, list[float]] = {t: [] for t in args.trees}
    for _ in range(args.turns):
        for order in (args.trees, args.trees[::-1]):
            for tree in order:
                out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", "--n", str(args.n), tree],
                                     capture_output=True, text=True, timeout=900)
                if out.returncode != 0:
                    print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                    return out.returncode
                res = json.loads(out.stdout.strip().splitlines()[-1])
                results[tree] += res["ms"]
                print(f"{tree}: atari superstep ms {', '.join(f'{x:.2f}' for x in res['ms'])}", flush=True)
    summary = {t: {"median_ms": sorted(v)[len(v) // 2], "ms": v} for t, v in results.items()}
    print(json.dumps({"card": card, "atari_superstep": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
