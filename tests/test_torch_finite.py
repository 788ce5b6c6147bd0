"""Finite envs of the port (tianshou_tpu_torch/envs/finite.py), mirroring
tests/test_finite_env.py and held against the JAX package: one pass plays
every episode of a fixed dataset exactly once; dead envs add nothing to the
metrics; a second pass restarts the dataset; FiniteEvalCollector serves as
a trainer's test collector.  step_masked gives bitwise the JAX package's
rows and masks, and a pass the same (returns, lens)."""

from collections import Counter

import jax
import numpy as np
import torch

from tianshou_tpu.algos.base import RandomPolicy as JaxRandomPolicy
from tianshou_tpu.envs import finite as jfinite
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu_torch.algos.base import RandomPolicy
from tianshou_tpu_torch.envs.finite import FiniteEvalCollector, FiniteHostVectorEnv, collect_dataset_episodes
from tianshou_tpu_torch.envs.spaces import Box, Discrete


class _DatasetEnv:
    """Serves a shard of (sample_id, episode_len) pairs; ``reset`` returns
    ``(None, {})`` once the shard is exhausted."""

    def __init__(self, shard, spaces=(Box, Discrete)):
        self.shard = list(shard)
        self.it = None
        self.observation_space = spaces[0](low=-1.0, high=1e9, shape=(2,))
        self.action_space = spaces[1](2)
        self.consumed = Counter()

    def reset(self, seed=None, options=None):
        if self.it is None:
            self.it = iter(self.shard)
        try:
            self.sample_id, self.ep_len = next(self.it)
        except StopIteration:
            self.it = None
            return None, {}
        self.t = 0
        return np.asarray([self.sample_id, self.t], np.float32), {}

    def step(self, action):
        self.t += 1
        assert self.t <= self.ep_len
        done = self.t >= self.ep_len
        if done:
            self.consumed[self.sample_id] += 1
        return np.asarray([self.sample_id, self.t], np.float32), 1.0, done, False, {}

    def close(self):
        pass


def _make_sharded(cls=FiniteHostVectorEnv, length=25, num_envs=4, spaces=(Box, Discrete)):
    episodes = [(i, 3 * i % 5 + 1) for i in range(length)]
    envs = [_DatasetEnv(episodes[r::num_envs], spaces) for r in range(num_envs)]
    return cls([lambda e=e: e for e in envs]), envs, episodes


def _random(n=2):
    algo = RandomPolicy(Discrete(n), "cpu")
    return algo, algo.init(torch.Generator())


def test_one_pass_consumes_every_episode_exactly_once():
    venv, envs, episodes = _make_sharded()
    algo, ts = _random()
    returns, lens = collect_dataset_episodes(algo, ts, venv, torch.Generator().manual_seed(1))
    assert venv.exhausted
    consumed = Counter()
    for e in envs:
        consumed.update(e.consumed)
    assert set(consumed) == {i for i, _ in episodes}
    assert all(c == 1 for c in consumed.values()), consumed
    assert sorted(lens.tolist()) == sorted(ln for _, ln in episodes)
    np.testing.assert_array_equal(returns, lens.astype(float))


def test_dead_envs_do_not_pollute_metrics():
    episodes = [(i, 2) for i in range(9)]
    shards = [episodes[:7], episodes[7:8], episodes[8:9], []]  # the empty shard is dead at once
    venv = FiniteHostVectorEnv([lambda s=s: _DatasetEnv(s) for s in shards])
    algo, ts = _random()
    returns, lens = collect_dataset_episodes(algo, ts, venv, torch.Generator())
    assert len(returns) == 9
    np.testing.assert_array_equal(lens, np.full(9, 2))


def test_second_pass_restarts_the_dataset():
    venv, envs, _ = _make_sharded(length=8, num_envs=2)
    algo, ts = _random()
    for _ in range(2):
        collect_dataset_episodes(algo, ts, venv, torch.Generator())
        assert venv.exhausted
    consumed = Counter()
    for e in envs:
        consumed.update(e.consumed)
    assert all(c == 2 for c in consumed.values()), consumed


def test_step_masked_and_a_pass_match_jax():
    tv, _, _ = _make_sharded(length=11, num_envs=3)
    jv, _, _ = _make_sharded(jfinite.FiniteHostVectorEnv, length=11, num_envs=3, spaces=(JaxBox, JaxDiscrete))
    np.testing.assert_array_equal(tv.reset(), jv.reset())
    while not jv.exhausted:
        acts = np.zeros(3, np.int64)
        tres, tcarry, talive = tv.step_masked(acts)
        jres, jcarry, jalive = jv.step_masked(acts)
        for name in ("obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tres, name), getattr(jres, name), err_msg=name)
        np.testing.assert_array_equal(tcarry, jcarry)
        np.testing.assert_array_equal(talive, jalive)
    assert tv.exhausted
    jalgo = JaxRandomPolicy(JaxDiscrete(2))
    jret, jlens = jfinite.collect_dataset_episodes(jalgo, jalgo.init(jax.random.key(0), None), jv, jax.random.key(1))
    algo, ts = _random()
    tret, tlens = collect_dataset_episodes(algo, ts, tv, torch.Generator())
    np.testing.assert_array_equal(tret, jret)
    np.testing.assert_array_equal(tlens, jlens)


def test_finite_eval_collector_through_trainer_epochs():
    """The trainer's test phase is one exactly-once pass a epoch while DQN
    trains on the host path over a cycling variant of the dataset env."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.host import HostVectorEnv
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    venv, envs, episodes = _make_sharded(length=17, num_envs=4)

    class _Cycling(_DatasetEnv):
        def reset(self, seed=None, options=None):
            obs, info = super().reset(seed, options)
            return super().reset(seed, options) if obs is None else (obs, info)

    train_venv = HostVectorEnv([lambda i=i: _Cycling([(i, 4)] * 50) for i in range(4)])
    algo = DQN(QNet(2, (16,), 2), envs[0].action_space, lr=1e-3, gamma=0.9, n_step=1, target_update_freq=50,
               device="cpu")
    buffer = ReplayBuffer(200, 4)
    trainer = OffPolicyTrainer(
        algo, HostCollector(algo, train_venv, buffer, device="cpu"), FiniteEvalCollector(algo, venv), buffer,
        max_epoch=2, step_per_epoch=64, step_per_collect=16, update_per_step=0.25, batch_size=16,
        episode_per_test=999, warmup_steps=32, seed=0, device="cpu")
    info = trainer.run()
    assert info.epoch == 2
    for env in envs:
        for sample_id, _ in env.shard:
            assert env.consumed[sample_id] == 2, (sample_id, env.consumed)
    assert abs(info.best_reward - float(np.mean([ln for _, ln in episodes]))) < 1e-6
