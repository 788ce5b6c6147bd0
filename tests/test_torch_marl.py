"""Multi-agent RL of the port (tianshou_tpu_torch/envs/tictactoe.py,
algos/multiagent.py, envs/pettingzoo_env.py, the collectors'
reward_metric) against the JAX package, on the CPU.

- TicTacToe under injected actions (legal, illegal, wins, draws, through
  the vector env's auto-reset): observations, masks, agent ids, per-agent
  rewards and terminations equal to the JAX env's.
- The manager's greedy act and one update of each agent through its buffer
  view, from weights carried across and the same sampled slots: actions
  equal, parameters and losses within rtol 1e-4 / atol 1e-5 (as
  tests/test_torch_dqn.py).
- reward_metric: per-agent episode returns scalarised by the metric at
  episode ends in the device Collector and in HostCollector.
- The PettingZoo adapter beside the JAX one and through HostCollector.
- The threshold copy of tests/test_marl.py: self-play DQN beats a random
  opponent (mean return > 0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.dqn import DQN as JaxDQN
from tianshou_tpu.algos.multiagent import MultiAgentPolicyManager as JaxManager
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.envs.tictactoe import TicTacToe as JaxTicTacToe
from tianshou_tpu.networks.common import QNet as JaxQNet
from tianshou_tpu_torch.algos.base import RandomPolicy
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.algos.multiagent import MultiAgentPolicyManager
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.envs.tictactoe import TicTacToe
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.convert import params_from_flax
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test, as the threshold copies run: the suite runs in
    several worker processes, and their threads would share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def test_tictactoe_matches_jax_under_injected_actions():
    n = 8
    jv, tv = JaxVectorEnv(JaxTicTacToe(), n), VectorEnv(TicTacToe(), n, device="cpu")
    jstate, jobs = jv.reset(jax.random.key(0))
    jstep = jax.jit(jv.step)
    tstate, tobs = tv.reset(torch.Generator())
    rng = np.random.default_rng(0)
    wins = draws = illegal = 0
    for _ in range(200):
        # mostly legal moves, sometimes an occupied square
        mask = np.asarray(jobs["mask"]) > 0
        legal = np.array([rng.choice(np.nonzero(m)[0]) for m in mask])
        act = np.where(rng.random(n) < 0.05, rng.integers(0, 9, n), legal)
        jstate, jres, jobs = jstep(jstate, jnp.asarray(act, jnp.int32), jax.random.key(1))
        tstate, tres, tobs = tv.step(tstate, torch.as_tensor(act), torch.Generator())
        for k in ("obs", "mask", "agent_id"):
            np.testing.assert_array_equal(tres.obs[k].numpy(), np.asarray(jres.obs[k]), err_msg=k)
            np.testing.assert_array_equal(tobs[k].numpy(), np.asarray(jobs[k]), err_msg=k)
        np.testing.assert_array_equal(tres.reward.numpy(), np.asarray(jres.reward))
        np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
        assert not tres.truncated.any()
        r = tres.reward.numpy()
        done = tres.terminated.numpy()
        wins += int((done & (np.abs(r).sum(1) > 0) & (act == legal)).sum())
        illegal += int((done & (act != legal) & (mask[np.arange(n), act] == 0)).sum())
        draws += int((done & (np.abs(r).sum(1) == 0)).sum())
    assert wins > 0 and draws > 0 and illegal > 0


def _manager_pair(hidden=(32, 32)):
    jagents = [JaxDQN(JaxQNet(hidden, 9), JaxDiscrete(9), gamma=0.95, n_step=2, target_update_freq=0)
               for _ in range(2)]
    tagents = [DQN(QNet(19, hidden, 9), Discrete(9), gamma=0.95, n_step=2, target_update_freq=0, device="cpu")
               for _ in range(2)]
    jm, tm = JaxManager(jagents), MultiAgentPolicyManager(tagents)
    jts = jm.init(jax.random.key(0), JaxBatch(obs=jnp.zeros(19), mask=jnp.ones(9), agent_id=jnp.zeros((), jnp.int32)))
    tts = tm.init(torch.Generator().manual_seed(0))
    for j, t in zip(jts, tts):
        t.online.load_state_dict(params_from_flax(jax.device_get(j.params)))
    return jm, jts, tm, tts


def test_manager_act_and_update_match_jax():
    n, cap, batch = 4, 32, 16
    jm, jts, tm, tts = _manager_pair()
    # a shared ring of self-play transitions, the same in both packages
    jv = JaxVectorEnv(JaxTicTacToe(), n)
    state, obs = jv.reset(jax.random.key(0))
    jstep = jax.jit(jv.step)
    rng = np.random.default_rng(1)
    steps = []
    for _ in range(cap):
        mask = np.asarray(obs["mask"]) > 0
        act = np.array([rng.choice(np.nonzero(m)[0]) for m in mask])
        state, res, nxt = jstep(state, jnp.asarray(act, jnp.int32), jax.random.key(1))
        steps.append(dict(obs=_np(obs), act=act, rew=np.asarray(res.reward), terminated=np.asarray(res.terminated),
                          truncated=np.asarray(res.truncated), obs_next=_np(res.obs)))
        obs = nxt
    traj = {k: (np.stack([s[k] for s in steps]) if not isinstance(steps[0][k], dict) else
                {f: np.stack([s[k][f] for s in steps]) for f in steps[0][k]}) for k in steps[0]}

    def tree(fn, t):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in t.items()}

    jtraj = jax.tree.map(jnp.asarray, JaxBatch(tree(lambda x: x, dict(traj, act=traj["act"].astype(np.int32)))))
    ttraj = Batch(tree(torch.tensor, traj))
    jbuf, tbuf = JaxReplayBuffer(cap, n), ReplayBuffer(cap, n)
    jstate = jbuf.add_trajectory(jbuf.init(jax.tree.map(lambda x: x[0, 0], jtraj)), jtraj)
    tstate = tbuf.add_trajectory(tbuf.init(tree(lambda x: x[0, 0], ttraj), device="cpu"), ttraj)
    np.testing.assert_array_equal(tstate.storage["rew"].numpy(), np.asarray(jstate.storage["rew"]))

    # greedy act on the last observations: each row from its mover's net
    tact = tm.act(tts, Batch(tree(torch.tensor, _np(obs))), torch.Generator(), explore=False)
    jact, _ = jm.act(jts, obs, jax.random.key(2), False)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))

    env_idx, pos = rng.integers(0, n, batch), rng.integers(0, cap - 2, batch)
    jbuf.sample_indices = lambda state, key, b: (jnp.asarray(env_idx, jnp.int32), jnp.asarray(pos, jnp.int32))
    tbuf.sample_indices = lambda state, g, b: (torch.as_tensor(env_idx), torch.as_tensor(pos))
    jts2, _, jmetrics = jax.jit(lambda ts, st, k: jm.update(ts, jbuf, st, k, batch))(jts, jstate, jax.random.key(3))
    tts2, _, tmetrics = tm.update(tts, tbuf, tstate, torch.Generator(), batch)
    assert set(tmetrics) == set(jmetrics) == {"agent0/loss", "agent0/td_abs_mean", "agent1/loss",
                                              "agent1/td_abs_mean"}
    for k in tmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for j, t in zip(jts2, tts2):
        ref = params_from_flax(jax.device_get(j.params))
        for k, v in t.online.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_reward_metric_in_the_device_collector():
    env = TicTacToe()
    algo = MultiAgentPolicyManager([RandomPolicy(env.action_space, "cpu")] * 2)
    ts = algo.init(torch.Generator())
    stats = {}
    for name, metric in (("first", None), ("second", lambda r: r[..., 1]), ("min", lambda r: r.min(-1).values)):
        col = Collector(algo, VectorEnv(env, 8, device="cpu"), device="cpu", reward_metric=metric)
        cstate = col.reset(torch.Generator().manual_seed(0))
        _, _, stats[name], _ = col.collect(ts, cstate, None, 30)
    assert stats["first"].n_collected_episodes > 0
    # the same games: the second agent's return is minus the first's
    np.testing.assert_array_equal(stats["second"].returns, -stats["first"].returns)
    np.testing.assert_array_equal(stats["min"].returns, -np.abs(stats["first"].returns))


def test_pettingzoo_adapter_matches_jax_and_runs_through_host_collector():
    tictactoe_v3 = pytest.importorskip("pettingzoo.classic.tictactoe_v3")
    from tianshou_tpu.envs.pettingzoo_env import PettingZooEnv as JaxPettingZooEnv
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.host import HostVectorEnv
    from tianshou_tpu_torch.envs.pettingzoo_env import PettingZooEnv

    jenv, tenv = JaxPettingZooEnv(tictactoe_v3.env()), PettingZooEnv(tictactoe_v3.env())
    assert tenv.observation_space.shape == (18,) and tenv.action_space.n == 9
    jo, _ = jenv.reset(seed=0)
    to, _ = tenv.reset(seed=0)
    rng = np.random.default_rng(0)
    for _ in range(40):
        for k in ("obs", "mask", "agent_id"):
            np.testing.assert_array_equal(to[k], jo[k], err_msg=k)
        a = int(rng.choice(np.nonzero(to["mask"])[0]))
        jo, jr, jte, jtr, _ = jenv.step(a)
        to, tr, tte, ttr, _ = tenv.step(a)
        np.testing.assert_array_equal(tr, jr)
        assert (tte, ttr) == (jte, jtr)
        if tte or ttr:
            jo, _ = jenv.reset()
            to, _ = tenv.reset()

    venv = HostVectorEnv([lambda: PettingZooEnv(tictactoe_v3.env())] * 4)
    agents = [DQN(QNet(18, (32,), 9), venv.action_space, gamma=0.95, n_step=2, target_update_freq=100,
                  device="cpu") for _ in range(2)]
    manager = MultiAgentPolicyManager(agents)
    col = HostCollector(manager, venv, ReplayBuffer(64, 4), device="cpu", reward_metric=lambda r: r[..., 1])
    col.reset(seed=0)
    assert col.obs["obs"].shape == (4, 18) and col.obs["mask"].shape == (4, 9)
    _, stats, traj = col.collect(manager.init(torch.Generator()), None, 20, torch.Generator(), explore=True,
                                 explore_param=0.5, record_traj=True)
    assert traj["rew"].shape == (20, 4, 2) and traj["obs"]["mask"].shape == (20, 4, 9)
    assert stats.n_collected_episodes > 0 and set(stats.returns.tolist()) <= {-1.0, 0.0, 1.0}
    assert col.ep_ret.shape == (4, 2)
    venv.close()


def test_selfplay_dqn_beats_random():
    """tests/test_marl.py's threshold copy at its settings and seed."""
    env = TicTacToe()

    def make_dqn():
        return DQN(QNet(19, (128, 128), 9), env.action_space, gamma=0.95, n_step=2, target_update_freq=320,
                   device="cpu")

    agents = [make_dqn(), make_dqn()]
    manager = MultiAgentPolicyManager(agents)
    buffer = ReplayBuffer(2000, 16)
    trainer = OffPolicyTrainer(
        manager, Collector(manager, VectorEnv(env, 16, device="cpu"), buffer, device="cpu"),
        Collector(manager, VectorEnv(env, 16, device="cpu"), device="cpu"), buffer,
        max_epoch=3, step_per_epoch=15000, step_per_collect=160, update_per_step=0.1, batch_size=128,
        train_param_fn=lambda e, s: 0.2, warmup_steps=2000, seed=0, device="cpu")
    trainer.run()
    rand = RandomPolicy(env.action_space, "cpu")
    eval_manager = MultiAgentPolicyManager([agents[0], rand])
    col = Collector(eval_manager, VectorEnv(env, 16, device="cpu"), device="cpu")
    stats = col.collect_episodes((trainer.train_state[0], rand.init(torch.Generator())),
                                 torch.Generator().manual_seed(6), 64, chunk_size=16)
    assert stats.returns_mean > 0.5, f"agent0 vs random mean return {stats.returns_mean}"
