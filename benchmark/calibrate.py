"""The readings that set the limits of ``correct``, on the card at a cell's
own size (not run by the benchmark's runs).

    python3 benchmark/calibrate.py --workload nature_dqn.replay --seeds 1 2 3 --out chiprun_out/calibrate.jsonl

For each seed, in one process: a whole run of the program with a window of
one superstep, then the comparison's numbers of

- ``program``: the program against the reference (the lower readings);
- ``control``: the reference in the configuration's control precision
  (``fp8`` below bfloat16, ``tf32`` below float32) put in the program's
  place;
- ``half_batch``: the reference with the second half of every update's
  batch left out, put in the program's place (a planted fault);
- ``random_acts``: the reference's ``act_gap`` with uniform random actions
  in the rollouts' place (a planted fault);
- ``altered_reward``, ``altered_action``: the ring's check with the newest
  row of env 0 altered (planted faults);

and the look behind them: ``fp32_argmax``, the program against the
reference with its double-Q argmax in float32; ``bf16`` (a bfloat16
configuration), the program against the reference computed in bfloat16
throughout, the configuration's own rounding; and ``delta_leaves``, a superstep at a time, the worst leaf
of the parameters' change against the reference, with its norms in the
program, the reference and the bfloat16 reference, its first gradient's
norm in the reference and the median leaf's.

``act_gap`` belongs to the program's rollouts, so the control and the
half batch do not read it.

A step that leaves the state unchanged reads 1 on ``delta_norm_gap`` by
its definition and needs no run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _norm(t) -> float:
    import torch

    return float(torch.linalg.vector_norm(t.double()))


def readings(spec: dict, seed: int, device: str) -> dict:
    import torch

    from benchmark import compare, harness
    from benchmark.reference import dqn as reference

    # a whole run with a window of one superstep
    run = harness.execute(spec, seed, 0.0, False, device, time.perf_counter())
    cfg, tr = run.config, run.traffic
    ref = reference.follow(cfg, tr, seed, run.snapshots, device)
    mode = reference.precision_mode(cfg)
    rounding = reference.follow(cfg, tr, seed, run.snapshots, device, mode=mode) if mode != "fp32" else None
    scale = rounding["steps"] if rounding else None
    prog = compare.program_steps(run.snapshots, ref["initial"])
    out = {"seed": seed, "program": harness.numbers(run, device, ref, rounding)}
    online = [f"online.{n}" for n in ref["initial"]]
    looks = {"fp32_argmax": reference.follow(cfg, tr, seed, run.snapshots, device, argmax="fp32")}
    if rounding:
        looks[mode] = rounding
    for key, look in looks.items():
        out[key] = compare.training_numbers(prog, look["steps"], look["act_gap"])
    out["delta_leaves"] = []
    for s, (p, r) in enumerate(zip(prog, ref["steps"])):
        gap, leaf, pn, rn, med = compare.leaf_gap(p["delta"], r["delta"], online, which=True)
        grads = {n: _norm(g) for n, g in r["grads1"].items()}
        row = {"superstep": s + 1, "leaf": leaf, "gap": gap, "program": pn, "reference": rn, "median": med,
               "grad_norm": grads.get(leaf.split(".", 1)[1], 0.0),
               "median_grad_norm": sorted(grads.values())[len(grads) // 2]}
        if rounding:
            row[mode] = _norm(scale[s]["delta"][leaf])
            row[f"gap_to_{mode}"] = compare.leaf_gaps(p["delta"], scale[s]["delta"], online)[leaf]
        out["delta_leaves"].append(row)
    for key, kwargs in (("control", {"mode": cfg["control"]}), ("half_batch", {"half_batch": True})):
        other = reference.follow(cfg, tr, seed, run.snapshots, device, **kwargs)
        out[key] = compare.training_numbers(other["steps"], ref["steps"], 0.0, scale)
        del out[key]["act_gap"]
    rand = reference.follow(cfg, tr, seed, run.snapshots, device, random_acts=True)
    out["random_acts"] = {"act_gap": rand["act_gap"]}
    # the newest row of env 0 altered as the rollout wrote it: its reward,
    # then its action
    ring = run.final_ring
    newest = int(torch.remainder(ring["cursor"][0] - 1, ring["storage"]["act"].shape[1]))
    for key, field in (("altered_reward", "rew"), ("altered_action", "act")):
        storage = dict(ring["storage"])
        leaf = storage[field].clone()
        leaf[0, newest] = (leaf[0, newest] + 1) % (2 if field == "rew" else cfg["env"]["num_actions"])
        storage[field] = leaf
        out[key] = reference.check_ring(cfg, {**ring, "storage": storage}, device, run.final_env)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [q for q in sys.path if Path(q or ".").resolve() != here]
    import torch

    from benchmark.harness import load_cell

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    spec = load_cell(args.workload, json.loads((ROOT / "BENCHMARK.json").read_text()))
    for seed in args.seeds:
        line = json.dumps({"workload": args.workload, **readings(spec, seed, "cuda")})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
