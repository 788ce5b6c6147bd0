"""DeepMind Atari preprocessing of the port (tianshou_tpu_torch/envs/atari.py)
against the JAX package, on the CPU over the fake-ALE double.

- Each wrapper and the whole ``wrap_deepmind`` chain, driven by the same
  seeds and actions in both packages: frames bitwise, rewards, lives,
  terminations and truncations equal.
- The numpy warp bitwise equal to cv2's grayscale + INTER_AREA resize on
  random frames and on the fake env's frames.
- The chain through HostVectorEnv and HostCollector into a deduplicated
  ring (stack_num 4, save_only_last_obs, ignore_obs_next) under a policy
  that is a function of the observation (so both packages take the same
  actions): stored frames, actions, rewards and flags bitwise equal to the
  JAX package's, and the bf16 stacks sampled at the same slots bitwise
  equal; then one DQN update on a presample of NatureCNN's input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tianshou_tpu.algos.base import RandomPolicy as JaxRandomPolicy  # noqa: E402
from tianshou_tpu.collect.host_collector import HostCollector as JaxHostCollector  # noqa: E402
from tianshou_tpu.data.batch import Batch as JaxBatch  # noqa: E402
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer  # noqa: E402
from tianshou_tpu.envs import atari as jatari  # noqa: E402
from tianshou_tpu_torch.algos.base import RandomPolicy  # noqa: E402
from tianshou_tpu_torch.algos.dqn import DQN  # noqa: E402
from tianshou_tpu_torch.collect.host_collector import HostCollector  # noqa: E402
from tianshou_tpu_torch.data.buffer import ReplayBuffer  # noqa: E402
from tianshou_tpu_torch.envs import atari as tatari  # noqa: E402
from tianshou_tpu_torch.networks.conv import ConvQNet  # noqa: E402

ACTIONS = np.random.default_rng(3).integers(0, 6, 200)


def _drive(jenv, tenv, steps: int, reset_kwargs: dict, attrs=()):
    """Step both envs with ``ACTIONS``, resetting at episode ends; every
    output equal (frames bitwise), and the named attributes too."""
    jo, _ = jenv.reset(**reset_kwargs)
    to, _ = tenv.reset(**reset_kwargs)
    np.testing.assert_array_equal(to, jo)
    ends = 0
    for a in ACTIONS[:steps]:
        jo, jr, jte, jtr, _ = jenv.step(int(a))
        to, tr, tte, ttr, _ = tenv.step(int(a))
        assert to.dtype == np.asarray(jo).dtype
        np.testing.assert_array_equal(to, jo)
        assert (tr, tte, ttr) == (jr, jte, jtr)
        for name in attrs:
            assert getattr(tenv, name) == getattr(jenv, name), name
        assert tenv.unwrapped._lives == jenv.unwrapped._lives
        if jte or jtr:
            ends += 1
            jo, _ = jenv.reset()
            to, _ = tenv.reset()
            np.testing.assert_array_equal(to, jo)
    return ends


@pytest.mark.parametrize("wrapper", ["noop", "maxskip", "episodic", "fire", "warp", "scaled", "clip", "stack"])
def test_each_wrapper_matches_jax(wrapper):
    kw = dict(lives=3, life_len=9, reward_every=3, max_steps=60, seed=5)
    base = {
        "noop": lambda m: m.NoopResetEnv(m.FakeAtariEnv(**kw), noop_max=30),
        "maxskip": lambda m: m.MaxAndSkipEnv(m.FakeAtariEnv(**kw), skip=4),
        "episodic": lambda m: m.EpisodicLifeEnv(m.FakeAtariEnv(**kw)),
        "fire": lambda m: m.FireResetEnv(m.FakeAtariEnv(**kw)),
        "warp": lambda m: m.WarpFrame(m.FakeAtariEnv(**kw)),
        "scaled": lambda m: m.ScaledFloatFrame(m.WarpFrame(m.FakeAtariEnv(**kw))),
        "clip": lambda m: m.ClipRewardEnv(m.FakeAtariEnv(**kw)),
        "stack": lambda m: m.FrameStack(m.WarpFrame(m.FakeAtariEnv(**kw)), 4),
    }[wrapper]
    jenv, tenv = base(jatari), base(tatari)
    attrs = ("was_real_done", "lives") if wrapper == "episodic" else ()
    ends = _drive(jenv, tenv, 120, {"seed": 11}, attrs)
    assert ends > 0
    assert tuple(tenv.observation_space.shape) == tuple(jenv.observation_space.shape)


@pytest.mark.parametrize("episode_life,clip", [(True, True), (False, False)])
def test_wrap_deepmind_chain_matches_jax(episode_life, clip):
    def make(m):
        return m.wrap_deepmind(m.FakeAtariEnv(lives=3, life_len=20, reward_every=5, max_steps=300, seed=2),
                               episode_life=episode_life, clip_rewards=clip, frame_stack=4)

    jenv, tenv = make(jatari), make(tatari)
    assert tenv.observation_space.shape == (4, 84, 84)
    ends = _drive(jenv, tenv, 150, {"seed": 3})
    assert ends > 0


def test_episodic_life_noop_game_over_matches_jax():
    """The lost-life no-op that itself ends the game resets for real."""
    def make(m):
        return m.EpisodicLifeEnv(m.FakeAtariEnv(lives=2, life_len=1, max_steps=10_000))

    jenv, tenv = make(jatari), make(tatari)
    _drive(jenv, tenv, 12, {}, ("was_real_done", "lives"))


def test_warp_is_bitwise_cv2():
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (210, 160, 3), dtype=np.uint8) for _ in range(50)]
    env = tatari.FakeAtariEnv()
    env.reset()
    for a in (1, 3, 3, 0, 4):
        frames.append(env.step(a)[0])
    for f in frames:
        ref = cv2.resize(cv2.cvtColor(f, cv2.COLOR_RGB2GRAY), (84, 84), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(tatari.warp_frame(f), ref)
    # other sizes take other area tables
    f = frames[0]
    for size in (42, 64, 105):
        ref = cv2.resize(cv2.cvtColor(f, cv2.COLOR_RGB2GRAY), (size, size), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(tatari.warp_frame(f, size), ref)


class _JaxObsPolicy(JaxRandomPolicy):
    """Acts ``sum(obs) % 6``: a function of the observation alone."""

    def act(self, ts, obs, key, explore, explore_param=0.0):
        return (jnp.sum(obs.astype(jnp.int32), axis=(1, 2, 3)) % 6).astype(jnp.int32), JaxBatch()


class _TorchObsPolicy(RandomPolicy):
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        return obs.to(torch.int64).sum(dim=(1, 2, 3)) % 6


def test_host_collector_into_dedup_ring_matches_jax():
    n, cap, steps = 2, 48, 40
    opts = dict(stack_num=4, save_only_last_obs=True, ignore_obs_next=True)

    def make():
        return lambda: jatari.FakeAtariEnv(lives=2, life_len=30, reward_every=4, max_steps=200)

    def tmake():
        return lambda: tatari.FakeAtariEnv(lives=2, life_len=30, reward_every=4, max_steps=200)

    jtrain, _ = jatari.make_atari_env("fake", n, 1, env_fn=make())
    ttrain, _ = tatari.make_atari_env("fake", n, 1, env_fn=tmake())
    jalgo, talgo = _JaxObsPolicy(jtrain.action_space), _TorchObsPolicy(ttrain.action_space, "cpu")
    jbuf, tbuf = JaxReplayBuffer(cap, n, **opts), ReplayBuffer(cap, n, **opts)
    jcol, tcol = JaxHostCollector(jalgo, jtrain, jbuf, act_on_host=False), HostCollector(talgo, ttrain, tbuf,
                                                                                           device="cpu")
    jcol.reset(seed=0)
    tcol.reset(seed=0)
    np.testing.assert_array_equal(tcol.obs, jcol.obs)
    assert tcol.obs.shape == (n, 4, 84, 84) and tcol.obs.dtype == np.uint8
    jts, tts = jalgo.init(jax.random.key(0), None), talgo.init(torch.Generator())
    _, _, jprobe = jcol.collect(jts, None, 1, jax.random.key(1), record_traj=True)
    _, _, tprobe = tcol.collect(tts, None, 1, torch.Generator(), record_traj=True)
    jstate = jbuf.init(jax.tree.map(lambda x: jnp.asarray(x)[0, 0], jprobe))
    tstate = tbuf.init({k: v[0, 0] for k, v in tcol.to_device(tprobe).items()}, device="cpu")
    jstate, jstats, _ = jcol.collect(jts, jstate, steps, jax.random.key(2))
    tstate, tstats, _ = tcol.collect(tts, tstate, steps, torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(tstats.returns, jstats.returns)
    assert tstats.n_collected_episodes == jstats.n_collected_episodes > 0
    assert tstate.storage["obs"].shape == (n, cap, 84, 84) and "obs_next" not in tstate.storage
    for k in ("obs", "act", "rew", "terminated", "truncated"):
        np.testing.assert_array_equal(tstate.storage[k].numpy(), np.asarray(jstate.storage[k]), err_msg=k)
    np.testing.assert_array_equal(tstate.cursor.numpy(), np.asarray(jstate.cursor))

    rng = np.random.default_rng(4)
    env_idx, pos = rng.integers(0, n, 64), rng.integers(0, steps, 64)
    got = tbuf.get(tstate, torch.from_numpy(env_idx), torch.from_numpy(pos), keys=("obs", "obs_next"),
                   dtypes={"obs": torch.bfloat16, "obs_next": torch.bfloat16})
    ref = jbuf.get(jstate, jnp.asarray(env_idx), jnp.asarray(pos), keys=("obs", "obs_next"))
    for k in ("obs", "obs_next"):
        assert got[k].shape == (64, 4, 84, 84) and got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      np.asarray(ref[k].astype(jnp.bfloat16)).view(np.int16), err_msg=k)

    # the NatureCNN DQN of examples/atari_dqn.py trains on this ring
    dqn = DQN(ConvQNet((4, 84, 84), 6, "nature"), ttrain.action_space, lr=1e-4, gamma=0.99, n_step=3,
              target_update_freq=500, device="cpu")
    dts = dqn.init(torch.Generator().manual_seed(0))
    sampled = dqn.presample(tbuf, tstate, torch.Generator().manual_seed(5), 16)
    assert sampled[3]["obs"].dtype == torch.bfloat16 and sampled[3]["obs"].shape == (16, 4, 84, 84)
    _, _, metrics = dqn.update_sampled(dts, tbuf, tstate, sampled)
    assert np.isfinite(float(metrics["loss"]))
    jtrain.close()
    ttrain.close()
