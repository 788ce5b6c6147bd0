"""The comparison that decides ``correct``: the numbers that set the
program against the reference, each against its limit.

Training numbers, over the followed supersteps, each superstep worked out
by the reference from the state before it: the benchmark's weights and a
fresh optimizer before the first, which is the capture's eager warm-up and
owes nothing to the program's arithmetic, and the program's train state
and optimizer moments before each later one, which are the graph's
replays (a DQN superstep's many updates amplify float rounding through
Adam's normalised steps, so the reference restarts where the program
stands instead of running its own trajectory).

- ``loss_gap``: ``|L_p - L_r| / |L_r|`` of the first superstep's first
  update's loss; ``loss_gap_replay`` the largest over the replays;
- ``grad_gap``: the worst, over the online network's leaves, of ``| |g_p| -
  |g_r| | / max(|g_r|, median leaf |g_r|)``, ``g`` the first update's
  gradient as the optimizer got it, first superstep; ``grad_gap_replay``
  the largest over the replays;
- ``grad_cos``: ``1 - cos`` of the angle between ``g_p`` and ``g_r``, all
  leaves as one vector, first superstep; ``grad_cos_replay`` the largest
  over the replays;
- ``grad_cos_replay_ratio``: for a configuration that computes below
  float32, the largest over the replays of ``grad_cos`` in units of the
  configuration's own rounding: the program's ``grad_cos`` over that of
  the reference computed in the configuration's precision.  Once a
  superstep's updates have cut the loss, bfloat16's rounding of the
  Q-values is a large part of each TD error, and ``grad_cos`` swings over
  seeds by 40x with it; the program's and a lower precision's readings
  swing alike, so their ratio stays steady (PERF.md, section 6);
- ``delta_gap``: ``grad_gap``'s measure of the parameters' change over a
  superstep, over the online and the target network's leaves (the median
  taken over the online leaves), the largest over the supersteps;
  ``delta_median_gap`` the median online leaf's;
- ``delta_norm_gap``: the gap of the norms of that change, the online
  leaves together and the target leaves together;
- ``act_gap``: the share of the rollouts' actions equal to the reference's
  greedy action, less the share epsilon-greedy acting gives, in absolute
  value (:func:`benchmark.reference.dqn.follow`).

``index_faults`` (the program's replay indices against the reference's
own draw) comes from the reference's ``follow``, a number of the ring's
check (``env_faults``, ``env_gap``) from its ``check_ring``.  A cell's
traffic file names the numbers it compares and their limits; a number
passes when it is finite and at most its limit.
"""

from __future__ import annotations

import math

import torch

__all__ = ["leaf_gaps", "leaf_gap", "training_numbers", "decide"]


def leaf_gaps(prog: dict, ref: dict, median_over: list[str]) -> dict[str, float]:
    """Each leaf's gap of norms ``| |p| - |r| | / max(|r|, median |r|)``, the
    median taken over the leaves ``median_over``."""
    norms = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in ref}
    med = sorted(norms[n] for n in median_over)[len(median_over) // 2]
    out = {}
    for n, r in norms.items():
        p = float(torch.linalg.vector_norm(prog[n].double()))
        denom = max(r, med)
        out[n] = abs(p - r) / denom if denom > 0 else (0.0 if p == 0 else math.inf)
    return out


def leaf_gap(prog: dict, ref: dict, median_over: list[str], which: bool = False):
    """The worst leaf's gap of norms (:func:`leaf_gaps`); with ``which``,
    ``(gap, leaf, program norm, reference norm, median)``."""
    gaps = leaf_gaps(prog, ref, median_over)
    worst = max(gaps, key=lambda n: gaps[n])
    if not which:
        return gaps[worst]
    norms = sorted(float(torch.linalg.vector_norm(ref[n].double())) for n in median_over)
    return (gaps[worst], worst, float(torch.linalg.vector_norm(prog[worst].double())),
            float(torch.linalg.vector_norm(ref[worst].double())), norms[len(norms) // 2])


def program_steps(snapshots: list[dict], initial: dict) -> list[dict]:
    """The program's followed supersteps in the reference's form: the first
    update's ``loss1`` and ``grads1`` and the parameters' ``delta``."""
    steps = []
    for s, snap in enumerate(snapshots):
        before = snapshots[s - 1] if s else {"online": initial, "target": initial}
        delta = {f"{side}.{n}": snap[side][n] - before[side][n] for side in ("online", "target")
                 for n in snap[side]}
        steps.append({"loss1": snap["loss1"], "grads1": snap["grads1"], "delta": delta})
    return steps


def _cos_gap(prog: dict, ref: dict) -> float:
    """``1 - cos`` of the angle between the two gradients, all leaves as one
    vector."""
    a = torch.cat([prog[n].double().flatten() for n in ref])
    b = torch.cat([ref[n].double().flatten() for n in ref])
    denom = float(a.norm() * b.norm())
    return 1.0 - float(a @ b) / denom if denom > 0 else (0.0 if float(a.norm()) == float(b.norm()) else 1.0)


def _ratio(x: float, scale: float) -> float:
    return x / scale if scale > 0 else (1.0 if x == 0 else math.inf)


def _norm_gap(prog: dict, ref: dict, names: list[str]) -> float:
    """The gap of the norms of ``names`` taken together."""
    p = math.sqrt(sum(float(prog[n].double().pow(2).sum()) for n in names))
    r = math.sqrt(sum(float(ref[n].double().pow(2).sum()) for n in names))
    return abs(p - r) / r if r > 0 else (0.0 if p == 0 else math.inf)


def training_numbers(prog: list[dict], ref: list[dict], act_gap: float,
                     rounding: list[dict] | None = None) -> dict[str, float]:
    """The training numbers (module docstring) of the program's supersteps
    against the reference's; ``rounding``, the reference's supersteps in
    the configuration's compute precision, adds ``grad_cos_replay_ratio``."""
    online = list(ref[0]["grads1"])
    delta_names = [f"online.{n}" for n in online]
    target_names = [f"target.{n}" for n in online]

    def first(p, r):
        return {"loss_gap": abs(p["loss1"] - r["loss1"]) / abs(r["loss1"]),
                "grad_gap": leaf_gap(p["grads1"], r["grads1"], online),
                "grad_cos": _cos_gap(p["grads1"], r["grads1"])}

    def median(gaps):
        xs = sorted(gaps[n] for n in delta_names)
        return xs[len(xs) // 2]

    pairs = list(zip(prog, ref))
    out = first(*pairs[0])
    replays = [first(p, r) for p, r in pairs[1:]]
    for name in list(out):
        out[f"{name}_replay"] = max((x[name] for x in replays), default=0.0)
    if rounding is not None:
        out["grad_cos_replay_ratio"] = max(
            (_ratio(_cos_gap(p["grads1"], r["grads1"]), _cos_gap(c["grads1"], r["grads1"]))
             for p, r, c in zip(prog[1:], ref[1:], rounding[1:])), default=0.0)
    deltas = [leaf_gaps(p["delta"], r["delta"], delta_names) for p, r in pairs]
    out["delta_gap"] = max(max(g.values()) for g in deltas)
    out["delta_median_gap"] = max(median(g) for g in deltas)
    out["delta_norm_gap"] = max(max(_norm_gap(p["delta"], r["delta"], delta_names),
                                    _norm_gap(p["delta"], r["delta"], target_names)) for p, r in pairs)
    out["act_gap"] = act_gap
    return out


def decide(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, {name: (value, limit)})``: every limited number present,
    finite and at most its limit."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"the comparison gave no {missing}")
    checks = {name: (float(numbers[name]), float(limits[name])) for name in limits}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return correct, checks
