#!/usr/bin/env python3
"""Where a host segment's "host collect" time goes, on one NVIDIA GPU: the
acting step against the host envs.  Run from the repository root:

    python3 tools/acting_share.py [--paths atari_host ppo_host sac_host cpp_cartpole] [--segments 3]

For each host path of ``chip_smoke.py`` at full width it prints, in ms a
segment (mean of ``--segments``, after one untimed segment):

- ``host collect``: ``HostCollector.collect`` of one segment, whole (its
  acting step op by op before the compiled collection, a replayed CUDA
  graph since);
- ``acting, op by op``: the segment's acting steps alone, each the
  observation's copy to the card, ``act_with_extras`` and ``map_action``
  dispatched operation by operation, and the action's copy back (the
  step's synchronisation), on the segment's recorded observations;
- ``env steps``: the segment's ``venv.step`` calls alone, on the recorded
  env actions.

The last line is a JSON object of these numbers with the card's name and
power limit.  Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def measure(path: str, segments: int) -> dict:
    import chip_smoke
    from tianshou_tpu_torch.utils.device import make_generator

    _, algo, col, _, trainer = chip_smoke.build(path, **chip_smoke.PHASE_SMALL.get(path, {}))
    gen = make_generator(0, "cuda")
    ts = algo.init(gen)
    col.reset(seed=0)
    steps = trainer.segment_len
    record = {}

    def collect():
        obs, acts = [], []
        step = col.venv.step

        def spy(a):
            obs.append(col.obs)
            acts.append(a)
            return step(a)

        col.venv.step = spy
        try:
            col.collect(ts, None, steps, gen, explore=True, record_traj=True)
        finally:
            col.venv.step = step
        record["obs"], record["acts"] = obs, acts

    def acting():
        for o in record["obs"]:
            raw, _ = algo.act_with_extras(ts, torch.as_tensor(o, device="cuda"), gen, True, 0.1)
            algo.map_action(raw).cpu().numpy()

    def env_steps():
        for a in record["acts"]:
            col.obs = col.venv.step(a)[1]

    out = {"segment_steps": steps, "num_envs": col.venv.num_envs,
           "host_collect_ms": _ms(collect, segments), "acting_op_by_op_ms": _ms(acting, segments),
           "env_steps_ms": _ms(env_steps, segments)}
    out["acting_share"] = out["acting_op_by_op_ms"] / out["host_collect_ms"]
    trainer.train_collector.venv.close()
    trainer.test_collector.venv.close()
    print(f"{path}: {steps} steps x {out['num_envs']} envs: host collect {out['host_collect_ms']:.2f} ms a "
          f"segment; acting, op by op {out['acting_op_by_op_ms']:.2f} ms ({out['acting_share']:.3f} of it); env "
          f"steps {out['env_steps_ms']:.2f} ms", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("acting_share: CUDA is not available", file=sys.stderr)
        return 1
    p = argparse.ArgumentParser()
    p.add_argument("--paths", nargs="+", default=["atari_host", "ppo_host", "sac_host", "cpp_cartpole"])
    p.add_argument("--segments", type=int, default=3)
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = {path: measure(path, args.segments) for path in args.paths}
    print(json.dumps({"card": card, "torch": torch.__version__, "paths": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
