"""Env port (tianshou_tpu_torch/envs) against the JAX envs: SyntheticPixelEnv
frames bitwise for the same (t, seed), rewards and truncation equal, and the
VectorEnv auto-reset contract (terminal obs to the buffer, reset obs
carried)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.envs.synthetic import SyntheticPixelEnv as JaxPixelEnv
from tianshou_tpu.envs.synthetic import SyntheticPixelState as JaxPixelState
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv, SyntheticPixelState


@pytest.mark.parametrize("channel_first", [False, True])
def test_synthetic_frames_bitwise(channel_first):
    rng = np.random.default_rng(0)
    n = 6
    t = rng.integers(0, 600, n).astype(np.int32)
    seed = rng.integers(0, 1 << 20, n).astype(np.int32)
    jenv = JaxPixelEnv(36, 36, 3, num_actions=4, channel_first=channel_first)
    tenv = SyntheticPixelEnv(36, 36, 3, num_actions=4, channel_first=channel_first)
    ref = np.asarray(jax.vmap(jenv._frame)(jnp.asarray(t), jnp.asarray(seed)))
    got = tenv.frame(torch.from_numpy(t), torch.from_numpy(seed)).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_synthetic_step_matches_jax():
    rng = np.random.default_rng(1)
    n = 8
    t = rng.integers(0, 8, n).astype(np.int32)
    seed = rng.integers(0, 1 << 20, n).astype(np.int32)
    act = rng.integers(0, 4, n).astype(np.int32)
    jenv = JaxPixelEnv(36, 36, 2, num_actions=4, episode_len=5)
    tenv = SyntheticPixelEnv(36, 36, 2, num_actions=4, episode_len=5)
    jst, jres = jax.vmap(jenv.step)(JaxPixelState(jnp.asarray(t), jnp.asarray(seed)), jnp.asarray(act))
    tst, tres = tenv.step(SyntheticPixelState(torch.from_numpy(t), torch.from_numpy(seed)),
                          torch.from_numpy(act).to(torch.int64))
    np.testing.assert_array_equal(tst.t.numpy(), np.asarray(jst.t))
    np.testing.assert_array_equal(tres.obs.numpy(), np.asarray(jres.obs))
    np.testing.assert_array_equal(tres.reward.numpy(), np.asarray(jres.reward))
    np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(tres.truncated.numpy(), np.asarray(jres.truncated))
    assert tres.truncated.any() and not tres.truncated.all()


def test_vector_env_auto_reset_contract():
    env = SyntheticPixelEnv(36, 36, 2, num_actions=4, episode_len=5)
    venv = VectorEnv(env, 3, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, obs = venv.reset(g)
    np.testing.assert_array_equal(obs.numpy(), env.frame(state.t, state.seed).numpy())
    act = torch.zeros(3, dtype=torch.int64)
    for step in range(1, 8):
        prev_seed = state.seed.clone()
        state, res, carry = venv.step(state, act, g)
        if step == 5:
            assert res.truncated.all() and not res.terminated.any()
            # the transition keeps the terminal observation of the old episode ...
            np.testing.assert_array_equal(
                res.obs.numpy(), env.frame(torch.full((3,), 5, dtype=torch.int32), prev_seed).numpy()
            )
            # ... while the carried state and observation start a new one
            assert (state.t == 0).all()
            assert not torch.equal(state.seed, prev_seed)
            np.testing.assert_array_equal(carry.numpy(), env.frame(state.t, state.seed).numpy())
        else:
            assert not res.done.any()
            assert torch.equal(state.seed, prev_seed)
            np.testing.assert_array_equal(carry.numpy(), res.obs.numpy())
        assert (state.t == step % 5).all()


def test_vector_env_reset_draws_phases_from_generator():
    env = SyntheticPixelEnv(36, 36, 2, num_actions=4)
    venv = VectorEnv(env, 64, device="cpu")
    s1, _ = venv.reset(torch.Generator().manual_seed(3))
    s2, _ = venv.reset(torch.Generator().manual_seed(3))
    s3, _ = venv.reset(torch.Generator().manual_seed(4))
    assert torch.equal(s1.seed, s2.seed) and not torch.equal(s1.seed, s3.seed)
    assert s1.seed.dtype == torch.int32 and int(s1.seed.min()) >= 0 and int(s1.seed.max()) < (1 << 20)


def test_discrete_sample_draws_from_generator():
    from tianshou_tpu_torch.envs.spaces import Discrete

    space = Discrete(6)
    a = space.sample(torch.Generator().manual_seed(0), (4000,))
    b = space.sample(torch.Generator().manual_seed(0), (4000,))
    assert torch.equal(a, b) and a.shape == (4000,)
    assert torch.equal(torch.unique(a), torch.arange(6))
    assert space.shape == ()
