"""Asynchronous host collection of the port
(tianshou_tpu_torch/collect/async_collector.py), mirroring
tests/test_async_collector.py and held against the JAX package.

- Slow envs do not hold back fast ones: with ``wait_num=1`` the fast envs
  store several times more transitions, each consistent with its env.
- With ``wait_num`` = all envs every round dispatches every env, so a run
  is deterministic: under a greedy DRQN whose weights are carried from the
  JAX package, the ring (bitwise) and the per-env LSTM carries (atol 1e-5)
  equal the JAX collector's, carries reset at each env's episode end.
- With a ready subset (``wait_num=1``) the carries of envs not dispatched
  stay as they were; the pool stops cleanly at close with steps in flight.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from tianshou_tpu.algos.drqn import DRQN as JaxDRQN  # noqa: E402
from tianshou_tpu.collect import async_collector as jasync  # noqa: E402
from tianshou_tpu.data.batch import Batch as JaxBatch  # noqa: E402
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer  # noqa: E402
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete  # noqa: E402
from tianshou_tpu.networks import common as jc  # noqa: E402
from tianshou_tpu_torch.algos.base import RandomPolicy  # noqa: E402
from tianshou_tpu_torch.algos.drqn import DRQN  # noqa: E402
from tianshou_tpu_torch.collect.async_collector import AsyncHostCollector, AsyncHostVectorEnv  # noqa: E402
from tianshou_tpu_torch.data.batch import Batch  # noqa: E402
from tianshou_tpu_torch.data.buffer import ReplayBuffer  # noqa: E402
from tianshou_tpu_torch.envs.spaces import Discrete  # noqa: E402
from tianshou_tpu_torch.networks import common as tc  # noqa: E402
from tianshou_tpu_torch.networks.convert import params_from_flax  # noqa: E402


class SleepyCorridor(gym.Env):
    """A corridor with a per-env step delay; obs[0] is the position, obs[1]
    the env's id; truncated after ``limit`` steps."""

    def __init__(self, env_id: int, delay: float, size: int = 5, limit: int = 10_000):
        self.env_id, self.delay, self.size, self.limit = env_id, delay, size, limit
        self.observation_space = gym.spaces.Box(-100, 100, shape=(2,))
        self.action_space = gym.spaces.Discrete(2)

    def reset(self, seed=None, options=None):
        self.pos = self.t = 0
        return np.array([0.0, self.env_id], np.float32), {}

    def step(self, action):
        time.sleep(self.delay)
        self.pos += int(action)
        self.t += 1
        term = self.pos >= self.size
        trunc = self.t >= self.limit and not term
        return np.array([self.pos, self.env_id], np.float32), 1.0 if term else 0.0, term, trunc, {}


def _example():
    return Batch(obs=torch.zeros(2), act=torch.zeros((), dtype=torch.int64), rew=torch.zeros(()),
                 terminated=torch.zeros((), dtype=torch.bool), truncated=torch.zeros((), dtype=torch.bool),
                 obs_next=torch.zeros(2))


def test_fast_envs_not_blocked_by_slow():
    delays = [0.0005, 0.0005, 0.0005, 0.05]  # env 3 is 100x slower
    venv = AsyncHostVectorEnv([lambda i=i, d=d: SleepyCorridor(i, d) for i, d in enumerate(delays)], wait_num=1)
    algo = RandomPolicy(Discrete(2), "cpu")
    buffer = ReplayBuffer(256, 4)
    col = AsyncHostCollector(algo, venv, buffer, device="cpu")
    col.reset(seed=0)
    bstate = buffer.init(_example(), device="cpu")
    t0 = time.time()
    bstate, stats = col.collect(algo.init(torch.Generator()), bstate, 120, torch.Generator().manual_seed(1))
    dt = time.time() - t0
    sizes = bstate.size.numpy()
    assert sizes[:3].min() > 3 * sizes[3], sizes
    assert stats.n_collected_steps >= 120
    assert dt < 4 * 0.05 * 120, dt  # a gross bound: stepping in lockstep would take 6 s
    for e in range(4):
        k = int(sizes[e])
        obs, obs_next = bstate.storage["obs"][e, :k].numpy(), bstate.storage["obs_next"][e, :k].numpy()
        act = bstate.storage["act"][e, :k].numpy()
        assert np.all(obs[:, 1] == e)
        np.testing.assert_allclose(obs_next[:, 0], obs[:, 0] + act)
    venv.close()
    assert all(f.done() for f in venv._futures.values())


def _drqn_pair(hidden=8):
    jalgo = JaxDRQN(jc.RecurrentQNet(hidden, 2), JaxDiscrete(2), gamma=0.9, target_update_freq=10)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(2, jnp.float32))
    talgo = DRQN(tc.RecurrentQNet(2, hidden, 2), Discrete(2), gamma=0.9, target_update_freq=10, device="cpu")
    tts = talgo.init(torch.Generator().manual_seed(0))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    return jalgo, jts, talgo, tts


def test_lockstep_run_matches_jax_with_recurrent_state():
    n, cap, steps = 3, 64, 45
    make = [lambda i=i: SleepyCorridor(i, 0.0, size=3, limit=4 + i) for i in range(n)]
    jalgo, jts, talgo, tts = _drqn_pair()
    jvenv, tvenv = jasync.AsyncHostVectorEnv(make, wait_num=n), AsyncHostVectorEnv(make, wait_num=n)
    jbuf, tbuf = JaxReplayBuffer(cap, n), ReplayBuffer(cap, n)
    jcol, tcol = jasync.AsyncHostCollector(jalgo, jvenv, jbuf), AsyncHostCollector(talgo, tvenv, tbuf, device="cpu")
    jcol.reset(seed=0)
    tcol.reset(seed=0)
    assert tcol._has_state
    jex = JaxBatch(obs=np.zeros(2, np.float32), act=np.zeros((), np.int64), rew=np.zeros((), np.float32),
                   terminated=np.zeros((), bool), truncated=np.zeros((), bool), obs_next=np.zeros(2, np.float32))
    jstate = jbuf.init(jex)
    tstate = tbuf.init(_example(), device="cpu")
    # greedy acting: both packages act the same from the same carries
    jstate, jstats = jcol.collect(jts, jstate, steps, jax.random.key(1), explore=False)
    tstate, tstats = tcol.collect(tts, tstate, steps, torch.Generator(), explore=False)
    assert tstats.n_collected_steps == jstats.n_collected_steps == steps
    np.testing.assert_array_equal(tstats.returns, jstats.returns)
    for k in ("obs", "act", "rew", "terminated", "truncated", "obs_next"):
        np.testing.assert_array_equal(tstate.storage[k].numpy(), np.asarray(jstate.storage[k]), err_msg=k)
    for t, j in zip(tcol._policy_state, jax.tree_util.tree_leaves(jcol._policy_state)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    assert tstats.n_collected_episodes > 0 and any(float(t.abs().sum()) > 0 for t in tcol._policy_state)
    jvenv.close()
    tvenv.close()


def test_ready_subset_keeps_other_carries():
    """Env 3 is slow: rounds dispatch the fast envs only, and env 3's carry
    changes only when it is dispatched."""
    delays = [0.0, 0.0, 0.0, 0.5]
    venv = AsyncHostVectorEnv([lambda i=i, d=d: SleepyCorridor(i, d, size=50) for i, d in enumerate(delays)],
                              wait_num=1)
    _, _, talgo, tts = _drqn_pair()
    col = AsyncHostCollector(talgo, venv, device="cpu")
    col.reset(seed=0)
    col.collect(tts, None, 4, torch.Generator(), explore=False)
    # env 3 was dispatched once, in the first round, and has not come back
    assert 3 not in col._ready
    slow = [x[3].clone() for x in col._policy_state]
    fast = [x[:3].clone() for x in col._policy_state]
    col.collect(tts, None, 12, torch.Generator(), explore=False)
    if 3 not in col._ready:  # still in flight: its carry must not have moved
        for s, x in zip(slow, col._policy_state):
            torch.testing.assert_close(x[3], s, rtol=0, atol=0)
    assert any(not torch.equal(f, x[:3]) for f, x in zip(fast, col._policy_state))
    venv.close()
    assert venv._futures == {}
