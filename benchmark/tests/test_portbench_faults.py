"""Whole runs on the CPU (the look for a card skipped) with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have, and true without one.  One chip is all these cells use: no exchange
between chips to leave out.  The staged ``mlp_dqn.replay`` runs too."""

import pytest
import torch

from benchmark.tests.conftest import tiny_spec

CELLS = ["nature_dqn.replay", "mlp_dqn.replay", "nature_dqn.actors"]


def _sound(cell):
    # bfloat16 rounding at this toy size is not what the cell's limits
    # were set from: the sound run computes in float32
    return tiny_spec(cell, compute_dtype="float32")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, cpu_run):
    out = cpu_run(_sound(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and "env_steps_per_s" in out["metrics"] and "setup_s" in out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(cell, cpu_run, monkeypatch):
    from tianshou_tpu_torch.algos import dqn

    monkeypatch.setattr(dqn.DQN, "_finish_update", lambda self, ts, loss: None)
    out = cpu_run(_sound(cell))
    assert not out["correct"]
    assert any(out["checks"][n]["value"] > out["checks"][n]["limit"]
               for n in ("delta_gap", "delta_norm_gap") if n in out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, cpu_run, monkeypatch):
    from tianshou_tpu_torch.algos import dqn

    update = dqn.DQN.update_sampled

    def half(self, ts, buffer, bstate, sampled, generator=None):
        rows = sampled[0].shape[0] // 2
        cut = tuple(x if x is None else _rows(x, rows) for x in sampled)
        return update(self, ts, buffer, bstate, cut, generator)

    monkeypatch.setattr(dqn.DQN, "update_sampled", half)
    out = cpu_run(_sound(cell))
    assert not out["correct"], out["checks"]


def _rows(x, rows):
    if isinstance(x, torch.Tensor):
        return x[:rows]
    return type(x)({k: v[:rows] for k, v in x.items()})


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, cpu_run, monkeypatch):
    """The env's reward altered for one env as the rollout produces it."""
    from tianshou_tpu_torch.envs.base import VectorEnv

    step = VectorEnv.step

    def altered(self, state, action, generator=None):
        new, res, carry = step(self, state, action, generator)
        return new, res._replace(reward=res.reward + (torch.arange(res.reward.shape[0]) == 0)), carry

    monkeypatch.setattr(VectorEnv, "step", altered)
    out = cpu_run(_sound(cell))
    assert not out["correct"]
    assert out["checks"]["env_faults"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_action_altered_where_produced(cell, cpu_run, monkeypatch):
    """Every greedy action the rollout takes shifted to the next action."""
    from tianshou_tpu_torch.algos import dqn

    act = dqn.DQN.act

    def shifted(self, ts, obs, generator, explore, explore_param=0.0):
        return torch.remainder(act(self, ts, obs, generator, False) + 1, self.action_space.n)

    monkeypatch.setattr(dqn.DQN, "act", shifted)
    out = cpu_run(_sound(cell))
    assert not out["correct"]
    assert out["checks"]["act_gap"]["value"] > out["checks"]["act_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_replay_indices_altered(cell, cpu_run, monkeypatch):
    """The sampler hands the presample each drawn slot's successor."""
    from tianshou_tpu_torch.data.buffer import ReplayBuffer

    sample = ReplayBuffer.sample_indices

    def shifted(self, state, generator, batch_size):
        env_idx, pos = sample(self, state, generator, batch_size)
        return env_idx, torch.remainder(pos + 1, self.capacity)

    monkeypatch.setattr(ReplayBuffer, "sample_indices", shifted)
    out = cpu_run(_sound(cell))
    assert not out["correct"]
    assert out["checks"]["index_faults"]["value"] > 0
