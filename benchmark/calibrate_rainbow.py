"""The readings that set the limits of a Rainbow cell's ``correct``, on the
card at the cell's own size (not run by the benchmark's runs).

    python3 benchmark/calibrate_rainbow.py --workload nature_rainbow.replay --seeds 1 2 3 \\
        --fault-seeds 1 --out chiprun_out/calibrate_rainbow.jsonl

For each seed, in one process: a whole run of the program with a window of
one superstep, then the comparison's numbers of

- ``program``: the program against the reference (the lower readings),
  with ``index_ties``, the draws that took the program's leaf within
  rounding of a boundary;
- ``priorities_fp32`` and ``priorities_bf16``: the first update's written
  priorities against those of the float32 reference and of the reference
  in the configuration's precision, row by row, every form of
  :func:`benchmark.reference.rainbow.prio_gaps` (the look behind
  ``prio_gap``), the largest over the supersteps;
- ``grads``: for each followed superstep, ``grad_cos`` of the program
  against the float32 reference (``prog``), of the reference in the
  configuration's precision against it (``rounding``) and of the program
  against that one (``prog_rounding``), with the three leaves that hold
  most of ``|g_p - g_r|^2`` and their shares (``leaves``): the look
  behind ``grad_cos`` and its ratio;
- ``control``: the reference in the configuration's control precision
  (``fp8``) put in the program's place (training numbers only);
- ``own_priorities``: the reference drawing from a tree of its own
  priorities instead of the program's (``index_faults``, ``index_ties``):
  the look behind following the program's priorities;
- with ``--fault-seeds``, for each planted fault of :data:`FAULTS`, a
  whole run of the program with the fault in place and its numbers, each
  against the traffic file's limits.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def _write_back_skipped():
    from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer

    return mock.patch.object(PrioritizedReplayBuffer, "update_priorities", lambda self, state, *args: state)


def _projection_shifted():
    import torch

    from tianshou_tpu_torch.algos.c51 import C51

    project = C51._project
    return mock.patch.object(C51, "_project", lambda self, *a: torch.roll(project(self, *a), 1, dims=1))


def _noise_not_drawn():
    from tianshou_tpu_torch.algos.c51 import C51

    return mock.patch.object(C51, "_draw_noise", lambda self, ts, generator: (None, None))


def _uniform_draws():
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer

    return mock.patch.object(PrioritizedReplayBuffer, "sample_with_weights", ReplayBuffer.sample_with_weights)


def _state_unchanged():
    from tianshou_tpu_torch.algos.c51 import C51

    return mock.patch.object(C51, "_finish_update", lambda self, ts, loss: None)


def _rows(x, rows):
    import torch

    if x is None or isinstance(x, torch.Tensor):
        return x if x is None else x[:rows]
    return type(x)({k: v[:rows] for k, v in x.items()})


def _half_batch():
    from tianshou_tpu_torch.algos.c51 import C51

    update = C51.update_sampled

    def half(self, ts, buffer, bstate, sampled, generator=None, noise=None):
        rows = sampled[0].shape[0] // 2
        return update(self, ts, buffer, bstate, tuple(_rows(x, rows) for x in sampled), generator, noise)

    return mock.patch.object(C51, "update_sampled", half)


def _prio_rows_altered():
    from tianshou_tpu_torch.algos import c51

    write_back = c51.write_back

    def altered(buffer, bstate, env_idx, pos, td_abs):
        return write_back(buffer, bstate, env_idx, pos, td_abs * _every_64th(td_abs))

    return mock.patch.object(c51, "write_back", altered)


def _every_64th(x):
    import torch

    scale = torch.ones_like(x)
    scale[::64] = 2.0
    return scale


def _reward_altered():
    import torch

    from tianshou_tpu_torch.envs.base import VectorEnv

    step = VectorEnv.step

    def altered(self, state, action, generator=None):
        new, res, carry = step(self, state, action, generator)
        first = torch.arange(res.reward.shape[0], device=res.reward.device) == 0
        return new, res._replace(reward=res.reward + first), carry

    return mock.patch.object(VectorEnv, "step", altered)


def _action_altered():
    import torch

    from tianshou_tpu_torch.algos.c51 import C51

    act = C51.act

    def shifted(self, ts, obs, generator, explore, explore_param=0.0):
        return torch.remainder(act(self, ts, obs, generator, explore, explore_param) + 1, self.action_space.n)

    return mock.patch.object(C51, "act", shifted)


#: planted faults of the program: each a patch, in force while a run is built and runs
FAULTS = {
    "write_back_skipped": _write_back_skipped,  # the sum tree keeps its priorities
    "projection_shifted": _projection_shifted,  # the target distribution one atom up
    "noise_not_drawn": _noise_not_drawn,  # the update's forwards on the mean weights
    "uniform_draws": _uniform_draws,  # the uniform ring's sampler in the tree's place
    "state_unchanged": _state_unchanged,  # no optimizer step, no target copy
    "half_batch": _half_batch,  # each update on the first half of its draw
    "prio_rows_altered": _prio_rows_altered,  # one written |td| in 64 doubled
    "reward_altered": _reward_altered,  # env 0's reward one more, as the rollout makes it
    "action_altered": _action_altered,  # every action the rollout takes one up
}


def planted(name: str) -> contextlib.AbstractContextManager:
    """The fault ``name`` of :data:`FAULTS` in force."""
    return FAULTS[name]()


def _prio_looks(looks: list[dict]) -> dict:
    """Each form of the first updates' priority gaps, the largest over the
    supersteps."""
    return {k: max(look[k] for look in looks) for k in looks[0]} if looks else {}


def _grad_looks(program: list[dict], ref: list[dict], rounding: list[dict] | None) -> list[dict]:
    """The first update's gradients of each followed superstep: ``grad_cos``
    of the program, of the rounding reference and of the program against
    that, and the leaves that hold most of ``|g_p - g_r|^2``."""
    from benchmark.compare import _cos_gap

    out = []
    for s, (p, r) in enumerate(zip(program, ref)):
        gp, gr = p["grads1"], r["grads1"]
        sq = {n: float((gp[n].double() - gr[n].double()).pow(2).sum()) for n in gr}
        whole = sum(sq.values()) or 1.0
        top = sorted(sq, key=lambda n: -sq[n])[:3]
        look = {"prog": _cos_gap(gp, gr), "leaves": {n: sq[n] / whole for n in top}}
        if rounding is not None:
            look.update(rounding=_cos_gap(rounding[s]["grads1"], gr), prog_rounding=_cos_gap(gp, rounding[s]["grads1"]))
        out.append(look)
    return out


def readings(spec: dict, seed: int, device: str, faults: bool) -> dict:
    from benchmark import compare, harness
    from benchmark.reference import rainbow as reference

    run = harness.execute(spec, seed, 0.0, False, device, time.perf_counter())
    cfg, tr = run.config, run.traffic
    ref = reference.follow(cfg, tr, seed, run.snapshots, device)
    mode = reference.precision_mode(cfg)
    rounding = reference.follow(cfg, tr, seed, run.snapshots, device, mode=mode) if mode != "fp32" else None
    out = {"seed": seed, "program": {**harness.numbers(run, device, ref, rounding), "index_ties": ref["index_ties"]}}
    for key, look in (("fp32", ref), (mode, rounding)):
        if look is not None:
            out[f"priorities_{key}"] = _prio_looks(look["prio_looks"])
    out["grads"] = _grad_looks(compare.program_steps(run.snapshots, ref["initial"]), ref["steps"],
                               rounding["steps"] if rounding else None)
    control = reference.follow(cfg, tr, seed, run.snapshots, device, mode=cfg["control"])
    out["control"] = compare.training_numbers(control["steps"], ref["steps"], 0.0,
                                              rounding["steps"] if rounding else None)
    del out["control"]["act_gap"]
    own = reference.follow(cfg, tr, seed, run.snapshots, device, own_priorities=True)
    out["own_priorities"] = {k: own[k] for k in ("index_faults", "index_ties")}
    del run
    for name in FAULTS if faults else ():
        with planted(name):
            broken = harness.execute(spec, seed, 0.0, False, device, time.perf_counter())
        correct, checks, _ = harness.judge(broken, device)
        out[name] = {"correct": correct, **{n: v for n, (v, _) in checks.items()}}
        del broken
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
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
        line = json.dumps({"workload": args.workload, **readings(spec, seed, "cuda", seed in args.fault_seeds)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
