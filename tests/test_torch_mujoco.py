"""The host-env path of the port on the real MuJoCo ``HalfCheetah-v4``
(gymnasium + MuJoCo), against the JAX package, on the CPU.

- ``HostVectorEnv`` and ``NormObsHostVectorEnv`` over 3 envs, the same
  seeds and actions in both packages for 1,010 steps (HalfCheetah truncates
  at 1,000, so every env auto-resets once): observations, rewards, flags
  and the carried observations bitwise; the running statistics after the
  segment within 1e-6 (float64), their counts equal.
- One segment shaped as the card's ``sac_host`` path (``bench.py``'s host
  stage: SAC at HalfCheetah's widths, 8 envs x 8 steps): both collectors
  act with the same injected raw actions (in place of the actor), mapped to
  the env's actions by each SAC's ``map_action``, so the envs get the same
  actions (bitwise) from the same seeds; the recorded trajectory, the
  packed transfer (``TreePacker``'s flat buffer) and the ring after
  ``add_trajectory`` are bitwise equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")
pytest.importorskip("mujoco")

from tianshou_tpu.algos.sac import SAC as JaxSAC  # noqa: E402
from tianshou_tpu.collect.host_collector import HostCollector as JaxHostCollector  # noqa: E402
from tianshou_tpu.data.batch import Batch as JaxBatch  # noqa: E402
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer  # noqa: E402
from tianshou_tpu.envs import host as jhost  # noqa: E402
from tianshou_tpu.networks import continuous as jcont  # noqa: E402
from tianshou_tpu.utils.transfer import TreePacker as JaxTreePacker  # noqa: E402
from tianshou_tpu_torch.algos.sac import SAC  # noqa: E402
from tianshou_tpu_torch.collect.host_collector import HostCollector  # noqa: E402
from tianshou_tpu_torch.data.batch import Batch  # noqa: E402
from tianshou_tpu_torch.data.buffer import ReplayBuffer  # noqa: E402
from tianshou_tpu_torch.envs import host as thost  # noqa: E402
from tianshou_tpu_torch.networks import continuous as tcont  # noqa: E402

TASK, OBS, ACT = "HalfCheetah-v4", 17, 6


def _make():
    return gym.make(TASK)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("norm", [False, True])
def test_halfcheetah_vector_env_matches_jax(norm):
    jcls, tcls = ((jhost.NormObsHostVectorEnv, thost.NormObsHostVectorEnv) if norm
                  else (jhost.HostVectorEnv, thost.HostVectorEnv))
    jv, tv = jcls([_make] * 3), tcls([_make] * 3)
    try:
        assert thost.space_from_gym(tv.envs[0].observation_space).shape == (OBS,)
        np.testing.assert_array_equal(tv.reset(seed=11), jv.reset(seed=11))
        rng = np.random.default_rng(0)
        truncations = 0
        for _ in range(1010):
            act = rng.uniform(-1, 1, (3, ACT)).astype(np.float32)
            (jres, jcarry), (tres, tcarry) = jv.step(act), tv.step(act)
            for name in ("obs", "reward", "terminated", "truncated"):
                np.testing.assert_array_equal(getattr(tres, name), getattr(jres, name), err_msg=name)
            np.testing.assert_array_equal(tcarry, jcarry)
            truncations += int(tres.truncated.sum())
        assert truncations == 3  # each env auto-reset once, at step 1,000
        if norm:
            np.testing.assert_allclose(tv.rms.mean, jv.rms.mean, rtol=0, atol=1e-6)
            np.testing.assert_allclose(tv.rms.var, jv.rms.var, rtol=0, atol=1e-6)
            assert tv.rms.count == jv.rms.count == 3 * 1011
    finally:
        jv.close()
        tv.close()


def _injected(num_steps, num_envs, seed=3):
    """The raw actions both collectors act with, in the policy's [-1, 1]."""
    return np.random.default_rng(seed).uniform(-1, 1, (num_steps, num_envs, ACT)).astype(np.float32)


def test_sac_host_segment_on_halfcheetah_matches_jax():
    n, steps, cap = 8, 8, 6  # sac_host's envs and steps; the ring wraps
    from tianshou_tpu.envs.spaces import Box as JaxBox
    from tianshou_tpu_torch.envs.spaces import Box

    jalgo = JaxSAC(jcont.GaussianActor((256, 256), ACT, conditioned_sigma=True), jcont.CriticEnsemble((256, 256), 2),
                   JaxBox(low=-1.0, high=1.0, shape=(ACT,)), auto_alpha=False)
    talgo = SAC(tcont.GaussianActor(OBS, (256, 256), ACT, conditioned_sigma=True),
                tcont.CriticEnsemble(OBS, ACT, (256, 256), 2), Box(low=-1.0, high=1.0, shape=(ACT,)),
                auto_alpha=False, device="cpu")
    raw = _injected(steps, n)

    jcol = JaxHostCollector(jalgo, jhost.HostVectorEnv([_make] * n), JaxReplayBuffer(cap, n), act_on_host=False)
    tcol = HostCollector(talgo, thost.HostVectorEnv([_make] * n), ReplayBuffer(cap, n), device="cpu")
    env_acts = {"jax": [], "port": []}
    for name, col in (("jax", jcol), ("port", tcol)):
        step = col.venv.step
        col.venv.step = lambda a, step=step, seen=env_acts[name]: (seen.append(np.array(a)), step(a))[1]
    jstep, tstep = iter(raw), iter(raw)
    jcol._act_fns[True] = lambda ts, obs, key, p: (  # the JAX collector's jitted act, replaced
        jnp.asarray(a := next(jstep)), jalgo.map_action(jnp.asarray(a)), JaxBatch())
    talgo.act_with_extras = lambda ts, obs, gen, explore, p: (torch.as_tensor(next(tstep)), Batch())
    try:
        jcol.reset(seed=5)
        tcol.reset(seed=5)
        # no train state: the injected actions replace the actor
        _, _, jtraj = jcol.collect(None, None, steps, jax.random.key(1), record_traj=True)
        _, stats, ttraj = tcol.collect(None, None, steps, torch.Generator().manual_seed(1), record_traj=True)
        assert stats.n_collected_steps == n * steps
        np.testing.assert_array_equal(np.stack(env_acts["port"]), np.stack(env_acts["jax"]))
        np.testing.assert_array_equal(ttraj["act"].numpy(), np.asarray(jtraj["act"]))
        for k in ("obs", "rew", "terminated", "truncated", "obs_next"):
            np.testing.assert_array_equal(ttraj[k], np.asarray(jtraj[k]), err_msg=k)

        # the packed transfer: one flat buffer, bitwise equal to the JAX packer's
        host = {k: ttraj[k] for k in ("obs", "rew", "terminated", "truncated", "obs_next")}
        packer, flat, _ = tcol.upload(Batch(host))
        np.testing.assert_array_equal(flat.numpy(), JaxTreePacker(host).pack(host))
        assert packer.total == JaxTreePacker(host).total

        # the segment into each side's ring
        jbuf, tbuf = jcol.buffer, tcol.buffer
        example = jax.tree.map(lambda x: jnp.asarray(x)[0, 0], jtraj)
        jbs = jbuf.add_trajectory(jbuf.init(example), jtraj.to_jax())
        tdev = tcol.to_device(ttraj)
        tbs = tbuf.add_trajectory(tbuf.init({k: v[0, 0] for k, v in tdev.items()}, device="cpu"), tdev)
        assert sorted(tbs.storage) == sorted(jbs.storage)
        for k in jbs.storage:
            ref, got = np.asarray(jbs.storage[k]), tbs.storage[k].numpy()
            assert got.dtype == ref.dtype, k
            np.testing.assert_array_equal(got, ref, err_msg=k)
        np.testing.assert_array_equal(tbs.cursor.numpy(), np.asarray(jbs.cursor))
        np.testing.assert_array_equal(tbs.size.numpy(), np.asarray(jbs.size))
    finally:
        jcol.venv.close()
        tcol.venv.close()
