"""The host path's latency modes of the port against the JAX package, on
the CPU over gymnasium envs: the fused fine host cycle (OffPolicyTrainer
with ``fused_fine_host``, trainer/offpolicy.FusedHostLoop) and
``HostCollector(act_on_host=True)``.

- The ring holds exactly what the env produced, with the policy's raw
  action; consecutive rows chain obs_next -> obs; the same seed gives the
  same ring; one packed host-to-device copy a cycle.
- ``fused_fine_host=True`` raises ValueError naming each failed condition;
  ``False`` keeps the segment path; ``None`` takes the cycle where it
  applies.
- One cycle from the same parameters, ring and sampled slots as the JAX
  package's: the same stored transition (bitwise), DQN parameters and loss
  within rtol 1e-4 / atol 1e-5 (as tests/test_torch_dqn.py), and the same
  next action.
- The threshold copy of tests/test_fused_host.py: DQN on CartPole through
  the cycle reaches 195.
- act_on_host: a greedy segment acted through the host copy of the actor
  equals the JAX package's act_on_host segment from the same parameters
  (actions and trajectory within atol 1e-5, as tests/test_torch_host.py);
  the copy is refreshed once a segment; the actions join the segment's one
  packed copy; a trainer run through it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from tianshou_tpu.algos.dqn import DQN as JaxDQN  # noqa: E402
from tianshou_tpu.collect.host_collector import HostCollector as JaxHostCollector  # noqa: E402
from tianshou_tpu.data.batch import Batch as JaxBatch  # noqa: E402
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer  # noqa: E402
from tianshou_tpu.envs import host as jhost  # noqa: E402
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete  # noqa: E402
from tianshou_tpu.networks.common import QNet as JaxQNet  # noqa: E402
from tianshou_tpu.trainer.offpolicy import OffPolicyTrainer as JaxTrainer  # noqa: E402
from tianshou_tpu_torch.algos.ddpg import DDPG  # noqa: E402
from tianshou_tpu_torch.algos.dqn import DQN  # noqa: E402
from tianshou_tpu_torch.collect.host_collector import HostCollector  # noqa: E402
from tianshou_tpu_torch.data.batch import Batch  # noqa: E402
from tianshou_tpu_torch.data.buffer import ReplayBuffer  # noqa: E402
from tianshou_tpu_torch.envs.host import HostVectorEnv  # noqa: E402
from tianshou_tpu_torch.envs.spaces import Discrete  # noqa: E402
from tianshou_tpu_torch.networks.common import QNet  # noqa: E402
from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor  # noqa: E402
from tianshou_tpu_torch.networks.convert import params_from_flax  # noqa: E402
from tianshou_tpu_torch.trainer.offpolicy import FusedHostLoop, OffPolicyTrainer  # noqa: E402
from tianshou_tpu_torch.utils.device import make_generator  # noqa: E402
from tianshou_tpu_torch.utils.transfer import TreePacker  # noqa: E402


class _RecordingVenv(HostVectorEnv):
    """Records every (actions, step result) pair."""

    def __init__(self, env_fns):
        super().__init__(env_fns)
        self.records = []

    def step(self, actions):
        res, carry = super().step(actions)
        self.records.append((np.asarray(actions).copy(), res))
        return res, carry


def _pendulum():
    return gym.make("Pendulum-v1")


def _ddpg_trainer(venv, seed=0, cycles=5, **kw):
    n = venv.num_envs
    algo = DDPG(DeterministicActor(3, (16,), 1), CriticEnsemble(3, 1, (16,), num_critics=1), venv.action_space,
                device="cpu")
    buffer = ReplayBuffer(32, n)
    kw = dict(max_epoch=1, step_per_epoch=cycles * n, step_per_collect=n, update_per_step=1.0, batch_size=4,
              episode_per_test=1, warmup_steps=0, seed=seed, device="cpu") | kw
    return OffPolicyTrainer(algo, HostCollector(algo, venv, buffer, device="cpu"),
                            HostCollector(algo, HostVectorEnv([_pendulum]), device="cpu"), buffer, **kw)


def test_ring_holds_what_the_env_produced():
    n = 2
    venv = _RecordingVenv([_pendulum] * n)
    trainer = _ddpg_trainer(venv)
    info = trainer.run()
    assert trainer.last_run_used_fused and info.env_step == 5 * n and info.gradient_step == 5 * n
    storage = {k: v.numpy() for k, v in trainer.buffer_state.storage.items()}
    assert (trainer.buffer_state.size.numpy() == 5).all()
    algo = trainer.algo
    # records[0] is the schema probe (not stored); the 5 cycles follow
    for row, (act, res) in enumerate(venv.records[1:6]):
        np.testing.assert_array_equal(storage["rew"][:, row], res.reward)
        np.testing.assert_array_equal(storage["obs_next"][:, row], res.obs)
        np.testing.assert_array_equal(storage["terminated"][:, row], res.terminated)
        np.testing.assert_array_equal(storage["truncated"][:, row], res.truncated)
        # the stored action is the raw one; the env got map_action of it
        env_act = algo.map_action(torch.from_numpy(storage["act"][:, row])).numpy()
        np.testing.assert_array_equal(env_act.reshape(-1), act.reshape(-1))
    for row in range(4):
        done = venv.records[1 + row][1].terminated | venv.records[1 + row][1].truncated
        for e in np.nonzero(~done)[0]:
            np.testing.assert_array_equal(storage["obs"][e, row + 1], storage["obs_next"][e, row])
    venv.close()


def test_same_seed_same_ring():
    def run():
        venv = HostVectorEnv([_pendulum] * 2)
        trainer = _ddpg_trainer(venv, seed=7, cycles=6)
        trainer.run()
        assert trainer.last_run_used_fused
        venv.close()
        return {k: v.numpy().copy() for k, v in trainer.buffer_state.storage.items()}

    a, b = run(), run()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_one_packed_copy_a_cycle():
    def copies(cycles):
        venv = HostVectorEnv([_pendulum] * 2)
        trainer = _ddpg_trainer(venv, cycles=cycles)
        before = TreePacker.copies
        trainer.run()
        venv.close()
        return TreePacker.copies - before

    assert copies(12) - copies(5) == 12 - 5


class _ExtrasDQN(DQN):
    def act_with_extras(self, ts, obs, generator, explore, explore_param=0.0):
        act = self.act(ts, obs, generator, explore, explore_param)
        return act, Batch(logits=torch.zeros(act.shape[0]))


class _DictObsEnv:
    """A two-step env with dict observations."""

    def __init__(self):
        self.observation_space = {"obs": gym.spaces.Box(-1, 1, (3,)), "mask": gym.spaces.Box(0, 1, (2,))}
        self.action_space = gym.spaces.Discrete(2)

    def _obs(self):
        return {"obs": np.zeros(3, np.float32), "mask": np.ones(2, np.float32)}

    def reset(self, seed=None, options=None):
        self.t = 0
        return self._obs(), {}

    def step(self, action):
        self.t += 1
        return self._obs(), 1.0, self.t >= 2, False, {}

    def close(self):
        pass


def _cartpole_trainer(fused, algo_cls=DQN, env=lambda: gym.make("CartPole-v1"), obs_dim=4, n=2, **kw):
    venv = HostVectorEnv([env] * n)
    algo = algo_cls(QNet(obs_dim, (8,), 2), Discrete(2), device="cpu")
    buffer = ReplayBuffer(16, n)
    col_kw = {"reward_metric": kw.pop("reward_metric")} if "reward_metric" in kw else {}
    kw = dict(max_epoch=1, step_per_epoch=4 * n, step_per_collect=n, update_per_step=0.5, batch_size=4,
              episode_per_test=1, train_param_fn=lambda e, s: 0.1, fused_fine_host=fused, device="cpu") | kw
    return OffPolicyTrainer(algo, HostCollector(algo, venv, buffer, device="cpu", **col_kw),
                            HostCollector(algo, HostVectorEnv([env]), device="cpu"), buffer, **kw)


@pytest.mark.parametrize("condition,kw", [
    ("step_per_collect == num_envs", dict(step_per_collect=4)),
    ("pipeline_host_updates is off", dict(pipeline_host_updates=True)),
    ("flat (non-dict) observations", dict(env=_DictObsEnv, obs_dim=3)),
    ("policy emits no per-step extras", dict(algo_cls=_ExtrasDQN)),
    ("no MARL reward_metric", dict(reward_metric=lambda r: r)),
])
def test_forced_cycle_raises_for_each_failed_condition(condition, kw):
    trainer = _cartpole_trainer(True, **kw)
    with pytest.raises(ValueError, match="failed condition") as err:
        trainer.run()
    assert condition in str(err.value)
    assert sum(c in str(err.value) for c in ("step_per_collect", "pipeline", "non-dict", "extras", "MARL")) == 1


@pytest.mark.parametrize("fused,expected", [(None, True), (False, False), (True, True)])
def test_fused_fine_host_modes(fused, expected):
    trainer = _cartpole_trainer(fused)
    info = trainer.run()
    assert trainer.last_run_used_fused is expected
    assert (info.env_step, info.gradient_step) == (8, 4) and math.isfinite(info.last_metrics["loss"])


def test_one_cycle_matches_jax():
    """The same parameters, ring and sampled slots in both packages: one
    cycle stores the same transition, takes the same update and computes
    the same next action."""
    n, cap, batch, prefill = 2, 16, 6, 5
    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    jalgo = JaxDQN(JaxQNet((16, 16), 2), JaxDiscrete(2), gamma=0.9, n_step=2, target_update_freq=0)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(4, jnp.float32))
    talgo = DQN(QNet(4, (16, 16), 2), Discrete(2), gamma=0.9, n_step=2, target_update_freq=0, device="cpu")
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.online.load_state_dict(params_from_flax(jax.device_get(jts.params)))

    rng = np.random.default_rng(0)
    traj = dict(obs=rng.normal(size=(prefill, n, 4)).astype(np.float32), act=rng.integers(0, 2, (prefill, n)),
                rew=rng.normal(size=(prefill, n)).astype(np.float32),
                terminated=rng.random((prefill, n)) < 0.2, truncated=np.zeros((prefill, n), bool),
                obs_next=rng.normal(size=(prefill, n, 4)).astype(np.float32))
    jbuf, tbuf = JaxReplayBuffer(cap, n), ReplayBuffer(cap, n)
    jtraj = JaxBatch({k: jnp.asarray(v) for k, v in dict(traj, act=traj["act"].astype(np.int32)).items()})
    jstate = jbuf.add_trajectory(jbuf.init(jax.tree.map(lambda x: x[0, 0], jtraj)), jtraj)
    tstate = tbuf.add_trajectory(tbuf.init({k: torch.as_tensor(v[0, 0]) for k, v in traj.items()}, device="cpu"),
                                 Batch({k: torch.as_tensor(v) for k, v in traj.items()}))
    # the same slots on both sides: the ring's first prefill + 1 rows
    env_idx = rng.integers(0, n, batch)
    pos = rng.integers(0, prefill + 1, batch)
    jbuf.sample_indices = lambda state, key, b: (jnp.asarray(env_idx, jnp.int32), jnp.asarray(pos, jnp.int32))
    tbuf.sample_indices = lambda state, g, b: (torch.as_tensor(env_idx), torch.as_tensor(pos))

    kw = dict(max_epoch=1, step_per_epoch=n, step_per_collect=n, update_per_step=1 / n, batch_size=batch,
              fused_fine_host=True)
    jvenv, tvenv = jhost.HostVectorEnv([make] * n), HostVectorEnv([make] * n)
    jcol = JaxHostCollector(jalgo, jvenv, jbuf, act_on_host=False)
    jtrainer = JaxTrainer(jalgo, jcol, JaxHostCollector(jalgo, jhost.HostVectorEnv([make]), act_on_host=False),
                          jbuf, **kw)
    tcol = HostCollector(talgo, tvenv, tbuf, device="cpu")
    ttrainer = OffPolicyTrainer(talgo, tcol, HostCollector(talgo, HostVectorEnv([make]), device="cpu"), tbuf,
                                device="cpu", **kw)
    jcol.reset(seed=3)
    tcol.reset(seed=3)
    engine = jtrainer._build_fused_cycle()
    engine.prime(jts, 0, 0, 0.0)  # epsilon 0: greedy
    loop = FusedHostLoop(ttrainer, tts, tstate, make_generator(0, torch.device("cpu")))
    loop.prime(0.0)
    np.testing.assert_array_equal(loop.env_act, engine.env_act_np)

    jts, jstate, jmetrics, jstats = engine.segment(jts, jstate, 1, 0.0)
    loop.cycle(0.0)
    for k in ("obs", "act", "rew", "terminated", "truncated", "obs_next"):
        np.testing.assert_array_equal(loop.bstate.storage[k].numpy(), np.asarray(jstate.storage[k]), err_msg=k)
    np.testing.assert_allclose(loop.read_metrics()["loss"], float(jmetrics["loss"]), rtol=1e-4, atol=1e-5)
    ref = params_from_flax(jax.device_get(jts.params))
    for k, v in loop.ts.online.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(loop.env_act, engine.env_act_np)
    jvenv.close()
    tvenv.close()


@pytest.mark.slow
def test_fused_dqn_cartpole_learns():
    """tests/test_fused_host.py's threshold copy at its seed: 8 envs, one
    step each a cycle, one update a cycle.  ``slow``: at seed 0 it reaches
    171.9 in its 4 epochs (about 22 s), a miss of that seed's stream; over
    seeds 0-4 the port and the JAX package each reach 195 on 4 of 5
    (ROADMAP.md section 3)."""
    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    algo = DQN(QNet(4, (128, 128, 128), 2), Discrete(2), gamma=0.9, n_step=3, target_update_freq=320, device="cpu")
    buffer = ReplayBuffer(2000, 8)
    train, test = HostVectorEnv([make] * 8), HostVectorEnv([make] * 8)
    trainer = OffPolicyTrainer(
        algo, HostCollector(algo, train, buffer, device="cpu"), HostCollector(algo, test, device="cpu"), buffer,
        max_epoch=4, step_per_epoch=10000, step_per_collect=8, update_per_step=0.125, batch_size=64,
        train_param_fn=lambda e, s: 0.1, stop_fn=lambda rew: rew >= 195, warmup_steps=1000, seed=0, device="cpu")
    info = trainer.run()
    train.close()
    test.close()
    assert trainer.last_run_used_fused
    assert info.stop_triggered, f"best={info.best_reward}"


def _sac_pair():
    from tianshou_tpu.algos.sac import SAC as JaxSAC
    from tianshou_tpu.networks import continuous as jcont
    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.networks import continuous as tcont

    jspace = jhost.space_from_gym(_pendulum().action_space)
    jalgo = JaxSAC(jcont.GaussianActor((16,), 1, conditioned_sigma=True), jcont.CriticEnsemble((16,)), jspace)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(3, jnp.float32))
    talgo = SAC(tcont.GaussianActor(3, (16,), 1, conditioned_sigma=True), tcont.CriticEnsemble(3, 1, (16,)),
                HostVectorEnv([_pendulum]).action_space, device="cpu")
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.actor.load_state_dict(params_from_flax(jax.device_get(jts.actor_params), heads=("mu", "sigma")))
    return jalgo, jts, talgo, tts


def test_act_on_host_segment_matches_jax():
    jalgo, jts, talgo, tts = _sac_pair()
    jcol = JaxHostCollector(jalgo, jhost.HostVectorEnv([_pendulum] * 3), act_on_host=True)
    tcol = HostCollector(talgo, HostVectorEnv([_pendulum] * 3), device="cpu", act_on_host=True)
    jcol.reset(seed=4)
    tcol.reset(seed=4)
    _, jstats, jtraj = jcol.collect(jts, None, 12, jax.random.key(1), explore=False, record_traj=True)
    _, tstats, ttraj = tcol.collect(tts, None, 12, torch.Generator(), explore=False, record_traj=True)
    assert isinstance(ttraj["act"], np.ndarray) and ttraj["act"].shape == (12, 3, 1)
    np.testing.assert_allclose(ttraj["act"], np.asarray(jtraj["act"]), atol=1e-5)
    for k in ("obs", "rew", "obs_next"):
        np.testing.assert_allclose(ttraj[k], np.asarray(jtraj[k]), atol=1e-5, err_msg=k)
    assert tcol._host_module is not tts.actor


def test_act_on_host_refreshes_the_copy_once_a_segment():
    algo = DQN(QNet(4, (8,), 2), Discrete(2), device="cpu")
    ts = algo.init(torch.Generator().manual_seed(0))
    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    host, plain = (HostCollector(algo, HostVectorEnv([make] * 2), ReplayBuffer(32, 2), device="cpu", act_on_host=on)
                   for on in (True, False))
    for col in (host, plain):
        col.reset(seed=1)
    _, _, a = host.collect(ts, None, 5, torch.Generator(), explore=False, record_traj=True)
    _, _, b = plain.collect(ts, None, 5, torch.Generator(), explore=False, record_traj=True)
    np.testing.assert_array_equal(a["act"], b["act"].numpy())
    # new parameters reach the copy at the next segment: a head that
    # favours action 1 everywhere
    with torch.no_grad():
        head = list(ts.online.parameters())[-1]
        head.copy_(torch.tensor([-100.0, 100.0]))
    _, _, c = host.collect(ts, None, 3, torch.Generator(), explore=False, record_traj=True)
    assert (c["act"] == 1).all()
    # the actions are numpy and cross in the segment's one packed copy
    before = TreePacker.copies
    bstate = host.buffer.init({k: v[0, 0] for k, v in host.to_device(c).items()}, device="cpu")
    bstate, _, _ = host.collect(ts, bstate, 4, torch.Generator(), explore=False)
    assert TreePacker.copies - before == 2 and bstate.storage["act"].dtype == torch.int64
    assert (bstate.storage["act"][:, :4] == 1).all()


def test_act_on_host_trainer_run():
    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    algo = DQN(QNet(4, (16,), 2), Discrete(2), n_step=3, target_update_freq=10, device="cpu")
    buf = ReplayBuffer(64, 4)
    trainer = OffPolicyTrainer(
        algo, HostCollector(algo, HostVectorEnv([make] * 4), buf, device="cpu", act_on_host=True),
        HostCollector(algo, HostVectorEnv([make] * 2), device="cpu", act_on_host=True), buf,
        max_epoch=1, step_per_epoch=40, step_per_collect=8, update_per_step=0.5, batch_size=16,
        episode_per_test=2, warmup_steps=16, train_param_fn=lambda e, s: 0.1, device="cpu")
    info = trainer.run()
    assert (info.env_step, info.gradient_step) == (16 + 5 * 8, 5 * 4)
    assert math.isfinite(info.last_metrics["loss"]) and info.best_reward >= 8
