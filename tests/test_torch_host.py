"""The host-env path of the port (tianshou_tpu_torch: envs/host,
utils/statistics, utils/transfer, collect/host_collector and the trainer's
host path) against the JAX package, on the CPU over real gymnasium envs.

- HostVectorEnv / NormObsHostVectorEnv over Pendulum-v1 and CartPole-v1,
  the same seeds and actions in both packages: observations, rewards, flags
  and auto-reset bitwise; running statistics within 1e-6.
- space_from_gym on every space kind.
- TreePacker.pack bitwise equal to the JAX package's; unpack round-trips.
- A greedy HostCollector segment with carried parameters: actions within
  atol 1e-5, the same trajectory (atol 1e-5: Pendulum steps from actions
  that differ in the last float32 bits) and the same ring after
  add_trajectory.
- The uniform random warm-up; a tiny _run_host whose counters equal the JAX
  trainer's; a one-epoch run with pipeline_host_updates=True.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from tianshou_tpu.algos.sac import SAC as JaxSAC  # noqa: E402
from tianshou_tpu.collect.host_collector import HostCollector as JaxHostCollector  # noqa: E402
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer  # noqa: E402
from tianshou_tpu.envs import host as jhost  # noqa: E402
from tianshou_tpu.networks import continuous as jcont  # noqa: E402
from tianshou_tpu.trainer.offpolicy import OffPolicyTrainer as JaxTrainer  # noqa: E402
from tianshou_tpu.utils.transfer import TreePacker as JaxTreePacker  # noqa: E402
from tianshou_tpu_torch.algos.sac import SAC  # noqa: E402
from tianshou_tpu_torch.collect.host_collector import HostCollector  # noqa: E402
from tianshou_tpu_torch.data.buffer import ReplayBuffer  # noqa: E402
from tianshou_tpu_torch.envs import host as thost  # noqa: E402
from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete  # noqa: E402
from tianshou_tpu_torch.networks import continuous as tcont  # noqa: E402
from tianshou_tpu_torch.networks.convert import params_from_flax  # noqa: E402
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer  # noqa: E402
from tianshou_tpu_torch.utils.transfer import TreePacker  # noqa: E402

HID = (16, 16)


def _pendulum():
    return gym.make("Pendulum-v1")


@pytest.mark.parametrize("env_id,norm", [("Pendulum-v1", False), ("CartPole-v1", False), ("Pendulum-v1", True)])
def test_host_vector_env_matches_jax(env_id, norm):
    make = lambda: gym.make(env_id)  # noqa: E731
    jcls, tcls = ((jhost.NormObsHostVectorEnv, thost.NormObsHostVectorEnv) if norm
                  else (jhost.HostVectorEnv, thost.HostVectorEnv))
    jv, tv = jcls([make] * 3), tcls([make] * 3)
    np.testing.assert_array_equal(tv.reset(seed=4), jv.reset(seed=4))
    rng = np.random.default_rng(0)
    ends = 0
    for _ in range(230):  # Pendulum truncates at 200, CartPole ends sooner
        if env_id.startswith("Pendulum"):
            act = rng.uniform(-2, 2, (3, 1)).astype(np.float32)
        else:
            act = rng.integers(0, 2, 3)
        (jres, jcarry), (tres, tcarry) = jv.step(act), tv.step(act)
        for name in ("obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tres, name), getattr(jres, name), err_msg=name)
        np.testing.assert_array_equal(tcarry, jcarry)
        assert tres.obs.dtype == np.float32 and tcarry.dtype == np.float32
        ends += int((tres.terminated | tres.truncated).sum())
    assert ends > 0  # an auto-reset happened
    if norm:
        np.testing.assert_allclose(tv.rms.mean, jv.rms.mean, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tv.rms.var, jv.rms.var, rtol=0, atol=1e-6)
        assert tv.rms.count == jv.rms.count == 3 * 231
        test = thost.NormObsHostVectorEnv([make], update_rms=False)
        test.set_rms(tv.get_rms())
        assert test.get_rms().count == tv.rms.count
        test.close()
    jv.close()
    tv.close()


def test_space_from_gym_matches_jax():
    spaces = [
        gym.spaces.Box(-2.0, 2.0, (3,)),
        gym.spaces.Box(np.array([-1.0, 0.0]), np.array([1.0, 5.0])),
        gym.spaces.Discrete(4),
        gym.spaces.MultiDiscrete([3, 5]),
        gym.spaces.Dict({"obs": gym.spaces.Box(0.0, 1.0, (2,)), "mask": gym.spaces.MultiDiscrete([2, 2])}),
    ]
    for sp in spaces:
        ref, got = jhost.space_from_gym(sp), thost.space_from_gym(sp)
        ref_leaves = ref if isinstance(ref, dict) else {"": ref}
        got_leaves = got if isinstance(got, dict) else {"": got}
        assert set(ref_leaves) == set(got_leaves)
        for k, r in ref_leaves.items():
            g = got_leaves[k]
            assert type(g).__name__ == type(r).__name__
            assert {f: getattr(g, f) for f in vars(g)} == {f: getattr(r, f) for f in vars(r)}
    native = Box(low=-1.0, high=1.0, shape=(2,))
    assert thost.space_from_gym(native) is native
    assert thost.space_from_gym(Discrete(3)) == Discrete(3)
    assert thost.space_from_gym(MultiDiscrete((2, 3))) == MultiDiscrete((2, 3))
    with pytest.raises(TypeError):
        thost.space_from_gym(gym.spaces.Text(4))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(5, 3, 4)),  # float64, as MuJoCo's
        "rew": rng.normal(size=(5, 3)).astype(np.float32),
        "terminated": rng.random((5, 3)) < 0.3,
        "count": rng.integers(0, 2**20, (5, 3)).astype(np.int64),
        "nested": {"a": rng.normal(size=(5, 3, 2)).astype(np.float32)},
    }


def test_tree_packer_matches_jax():
    tree = _tree(0)
    ref = JaxTreePacker(tree)
    packer = TreePacker(tree, device="cpu")
    assert packer.total == ref.total
    for seed in (0, 1):
        t = _tree(seed)
        np.testing.assert_array_equal(packer.pack(t), ref.pack(t))
        out = packer.unpack(packer.to_device(t))
        np.testing.assert_array_equal(out["obs"].numpy(), t["obs"].astype(np.float32))
        assert out["obs"].dtype == torch.float32 and out["terminated"].dtype == torch.bool
        assert out["count"].dtype == torch.int64
        for k in ("rew", "terminated", "count"):
            np.testing.assert_array_equal(out[k].numpy(), t[k])
        np.testing.assert_array_equal(out["nested"]["a"].numpy(), t["nested"]["a"])


def _sac_pair(obs_dim=3, act_dim=1):
    from tianshou_tpu.envs.spaces import Box as JaxBox

    jalgo = JaxSAC(jcont.GaussianActor(HID, act_dim, conditioned_sigma=True), jcont.CriticEnsemble(HID, 2),
                   JaxBox(low=-2.0, high=2.0, shape=(act_dim,)))
    talgo = SAC(tcont.GaussianActor(obs_dim, HID, act_dim, conditioned_sigma=True),
                tcont.CriticEnsemble(obs_dim, act_dim, HID, 2), Box(low=-2.0, high=2.0, shape=(act_dim,)),
                device="cpu")
    jts = jalgo.init(jax.random.key(0), jnp.zeros((obs_dim,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.actor.load_state_dict(params_from_flax(jax.device_get(jts.actor_params), heads=("mu", "sigma")))
    return jalgo, jts, talgo, tts


def test_greedy_host_segment_matches_jax():
    jalgo, jts, talgo, tts = _sac_pair()
    n, steps, cap = 3, 12, 8
    jbuf, tbuf = JaxReplayBuffer(cap, n), ReplayBuffer(cap, n)
    jcol = JaxHostCollector(jalgo, jhost.HostVectorEnv([_pendulum] * n), jbuf, act_on_host=False)
    tcol = HostCollector(talgo, thost.HostVectorEnv([_pendulum] * n), tbuf, device="cpu")
    jcol.reset(seed=7)
    tcol.reset(seed=7)
    _, _, jtraj = jcol.collect(jts, None, steps, jax.random.key(1), explore=False, record_traj=True)
    _, stats, ttraj = tcol.collect(tts, None, steps, torch.Generator().manual_seed(1), explore=False,
                                   record_traj=True)
    assert stats.n_collected_steps == n * steps
    np.testing.assert_allclose(ttraj["act"].numpy(), np.asarray(jtraj["act"]), rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(jtraj["act"])).max()) > 1e-3
    for k in ("obs", "rew", "terminated", "truncated", "obs_next"):
        np.testing.assert_allclose(ttraj[k], np.asarray(jtraj[k]), rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tcol.obs, jcol.obs, rtol=0, atol=1e-5)

    # the same segment into each side's ring (it wraps capacity 8)
    example = jax.tree.map(lambda x: jnp.asarray(x)[0, 0], jtraj)
    jbs = jbuf.add_trajectory(jbuf.init(example), jtraj.to_jax())
    texample = tcol.to_device(ttraj)
    tbs = tbuf.add_trajectory(tbuf.init({k: v[0, 0] for k, v in texample.items()}, device="cpu"),
                              tcol.to_device(ttraj))
    for k in jbs.storage:
        ref, got = np.asarray(jbs.storage[k]), tbs.storage[k].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tbs.cursor.numpy(), np.asarray(jbs.cursor))
    np.testing.assert_array_equal(tbs.size.numpy(), np.asarray(jbs.size))


def test_random_warmup_is_uniform_and_mapped():
    _, _, talgo, tts = _sac_pair()
    venv = thost.HostVectorEnv([_pendulum] * 4)
    buf = ReplayBuffer(128, 4)
    col = HostCollector(talgo, venv, buf, device="cpu")
    col.reset(seed=0)
    _, _, probe = col.collect(tts, None, 1, torch.Generator().manual_seed(0), record_traj=True)
    bstate = buf.init({k: torch.as_tensor(np.asarray(v[0, 0])) for k, v in probe.items()}, device="cpu")
    bstate, stats, traj = col.collect(tts, bstate, 60, torch.Generator().manual_seed(2), random=True,
                                      record_traj=True)
    acts = np.asarray(traj["act"]).reshape(-1)
    assert acts.min() < -0.8 and acts.max() > 0.8
    hist, _ = np.histogram(acts, bins=4, range=(-1, 1))
    assert (hist > len(acts) * 0.1).all(), hist
    assert (bstate.size.numpy() == 60).all()
    np.testing.assert_array_equal(bstate.storage["act"][:, :60].numpy().transpose(1, 0, 2), traj["act"])
    venv.close()


def _trainers(pipeline=False, max_epoch=2):
    """The same tiny host-path configuration in both packages: 2 Pendulum
    envs, 4-step segments (2 a env), 2 updates a segment, epochs of 10
    steps, 8 warm-up steps, 1 test episode."""
    jalgo, _, talgo, _ = _sac_pair()
    kw = dict(max_epoch=max_epoch, step_per_epoch=10, step_per_collect=4, update_per_step=0.5, batch_size=8,
              episode_per_test=1, warmup_steps=8, seed=0)
    jbuf, tbuf = JaxReplayBuffer(32, 2), ReplayBuffer(32, 2)
    jtrainer = JaxTrainer(jalgo, JaxHostCollector(jalgo, jhost.HostVectorEnv([_pendulum] * 2), jbuf),
                          JaxHostCollector(jalgo, jhost.HostVectorEnv([_pendulum])), jbuf, **kw)
    ttrainer = OffPolicyTrainer(
        talgo, HostCollector(talgo, thost.HostVectorEnv([_pendulum] * 2), tbuf, device="cpu"),
        HostCollector(talgo, thost.HostVectorEnv([_pendulum]), device="cpu"), tbuf,
        pipeline_host_updates=pipeline, device="cpu", **kw)
    return jtrainer, ttrainer


def test_run_host_counters_match_jax():
    jtrainer, ttrainer = _trainers()
    jinfo, tinfo = jtrainer.run(), ttrainer.run()
    assert (tinfo.env_step, tinfo.gradient_step, tinfo.epoch) == (jinfo.env_step, jinfo.gradient_step, jinfo.epoch)
    # 8 warm-up steps + 2 epochs x 3 segments of 4 steps
    assert tinfo.env_step == 8 + 2 * 3 * 4 and tinfo.gradient_step == 2 * 3 * 2 == ttrainer.train_state.step
    assert (ttrainer.buffer_state.size.numpy() == (8 + 24) // 2).all()
    assert math.isfinite(tinfo.best_reward) and -1700 < tinfo.best_reward <= 0
    assert set(tinfo.last_metrics) == {"critic_loss", "actor_loss", "alpha", "alpha_loss"}


def test_run_host_pipelined_completes():
    _, trainer = _trainers(pipeline=True, max_epoch=1)
    info = trainer.run()
    assert (info.env_step, info.gradient_step, info.epoch) == (8 + 3 * 4, 3 * 2, 1)
    assert all(math.isfinite(v) for v in info.last_metrics.values())
    assert math.isfinite(info.best_reward)


@pytest.mark.parametrize("pipeline", [False, True])
def test_run_host_dqn_on_discrete_envs(pipeline):
    """DQN through the host path over CartPole-v1: the discrete warm-up, the
    default acting module (``ts.online``) and its snapshot when pipelined."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.networks.common import QNet

    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    train, test = thost.HostVectorEnv([make] * 4), thost.HostVectorEnv([make] * 2)
    algo = DQN(QNet(4, (32,), 2), train.action_space, n_step=3, target_update_freq=10, device="cpu")
    buf = ReplayBuffer(64, 4)
    trainer = OffPolicyTrainer(
        algo, HostCollector(algo, train, buf, device="cpu"), HostCollector(algo, test, device="cpu"), buf,
        max_epoch=1, step_per_epoch=40, step_per_collect=8, update_per_step=0.5, batch_size=16,
        episode_per_test=2, warmup_steps=16, train_param_fn=lambda e, s: 0.1, pipeline_host_updates=pipeline,
        device="cpu")
    info = trainer.run()
    assert (info.env_step, info.gradient_step) == (16 + 5 * 8, 5 * 4)
    assert trainer.buffer_state.storage["act"].dtype == torch.int64
    assert set(np.unique(trainer.buffer_state.storage["act"].numpy())) <= {0, 1}
    assert math.isfinite(info.last_metrics["loss"]) and info.best_reward >= 8
    train.close()
    test.close()
