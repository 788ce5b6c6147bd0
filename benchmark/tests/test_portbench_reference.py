"""The reference against ``tianshou_tpu_torch`` at a tiny size on the CPU.

With the encoder computing in float32 both sides do the same arithmetic, so
the followed supersteps agree to float32 rounding: that pins the
reference's semantics (frame stacks, n-step chains, double-Q bootstrap,
Adam, the target copy) to the program's.  The ring's check passes on what
the program's rollouts wrote."""

import time

import pytest

from benchmark import compare, harness
from benchmark.reference import dqn as reference
from benchmark.tests.conftest import tiny_spec


def _followed(spec, seed):
    """A whole run with a window of one superstep."""
    return harness.execute(spec, seed, 0.0, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", ["nature_dqn.replay", "mlp_dqn.replay"])
def test_reference_follows_the_program_in_float32(cell):
    spec = tiny_spec(cell, compute_dtype="float32", target_update_freq=5)
    run = _followed(spec, 2**31 + 3)
    ref = reference.follow(run.config, run.traffic, run.seed, run.snapshots, "cpu")
    prog = compare.program_steps(run.snapshots, ref["initial"])
    numbers = compare.training_numbers(prog, ref["steps"], 0.0)
    assert max(numbers.values()) < 1e-4, numbers
    # the target copy at update 5 moved the target on both sides
    moved = [s for s in ref["steps"] if any(float(d.abs().max()) > 0 for n, d in s["delta"].items()
                                            if n.startswith("target."))]
    assert moved and len(moved) == sum(any(float(d.abs().max()) > 0 for n, d in s["delta"].items()
                                           if n.startswith("target.")) for s in prog)


@pytest.mark.parametrize("cell", ["nature_dqn.replay", "mlp_dqn.replay"])
def test_ring_check_passes_on_the_programs_ring(cell):
    run = _followed(tiny_spec(cell), 2**31 + 5)
    ring = run.final_ring
    checked = reference.check_ring(run.config, ring, "cpu", run.final_env)
    assert checked["env_faults"] == 0
    assert checked.get("env_gap", 0.0) < 1e-5
    ring["storage"]["act"][1, 3] = 1 - ring["storage"]["act"][1, 3]
    altered = reference.check_ring(run.config, ring, "cpu", run.final_env)
    assert altered["env_faults"] >= 1 or altered["env_gap"] > 1e-3


def test_indices_are_the_programs(monkeypatch):
    """The replay indices the benchmark keeps are those the program's
    presample drew, and the reference's own draw from the superstep's
    generator state gives them again."""
    from benchmark.builders import dqn_device

    drawn = []
    presample = dqn_device.DQN.presample

    def spy(self, buffer, bstate, generator, n):
        out = presample(self, buffer, bstate, generator, n)
        drawn.append((out[0].clone(), out[1].clone()))
        return out

    monkeypatch.setattr(dqn_device.DQN, "presample", spy)
    run = _followed(tiny_spec("mlp_dqn.replay"), 2**31 + 9)
    assert len(run.snapshots) == run.followed and len(drawn) > run.followed
    for (env_idx, pos), snap in zip(drawn, run.snapshots):
        assert (env_idx == snap["env_idx"]).all() and (pos == snap["pos"]).all()
    ref = reference.follow(run.config, run.traffic, run.seed, run.snapshots, "cpu")
    assert ref["index_faults"] == 0


def test_draw_indices_is_uniform_over_stored_transitions():
    """Every draw lands on a stored transition, each about equally often:
    a ring of 3 envs holding 5, 0 and 8 (full, wrapped) transitions."""
    import torch

    cap = 8
    ring = reference.Ring({"storage": {"act": torch.zeros(3, cap, dtype=torch.int64),
                                       "terminated": torch.zeros(3, cap, dtype=torch.bool),
                                       "truncated": torch.zeros(3, cap, dtype=torch.bool)},
                           "cursor": torch.tensor([5, 0, 3]), "size": torch.tensor([5, 0, 8])}, "cpu")
    g = torch.Generator().manual_seed(2**31 + 13)
    n = 130_000
    env, pos = reference.draw_indices(ring, g.get_state(), n)
    stored = {(0, p) for p in range(5)} | {(2, p) for p in range(cap)}
    counts = torch.zeros(3, cap)
    counts.index_put_((env, pos), torch.ones(n), accumulate=True)
    assert {(e, p) for e in range(3) for p in range(cap) if counts[e, p] > 0} == stored
    expected = n / len(stored)
    assert all(abs(float(counts[e, p]) - expected) < 5 * expected ** 0.5 for e, p in stored)
