"""Env wrappers port (tianshou_tpu_torch/envs/wrappers.py) against the JAX
wrappers: FrameStack over SyntheticPixelEnv(36, 36, 1) gives bitwise-equal
stacks across an auto-reset, and over CartPole the same stacks (float32
dynamics at atol 1e-5) with terminations equal; the action wrappers map
actions as JAX does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.envs import wrappers as jw
from tianshou_tpu.envs.base import JaxEnv
from tianshou_tpu.envs.base import StepResult as JaxStepResult
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
from tianshou_tpu.envs.classic import CartPole as JaxCartPole
from tianshou_tpu.envs.classic import CartPoleState as JaxCartPoleState
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.envs.spaces import MultiDiscrete as JaxMultiDiscrete
from tianshou_tpu.envs.synthetic import SyntheticPixelEnv as JaxPixelEnv
from tianshou_tpu.envs.synthetic import SyntheticPixelState as JaxPixelState
from tianshou_tpu_torch.envs import wrappers as tw
from tianshou_tpu_torch.envs.base import StepResult, TorchEnv, VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole, CartPoleState
from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete
from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv, SyntheticPixelState

N, K = 3, 4
SEEDS = np.array([11, 222, 3333], np.int32)
CART0 = np.array([0.01, -0.02, 0.03, 0.04], np.float32)


# fixed resets on both sides, so that an auto-reset is injected
class _JaxPixel(JaxPixelEnv):
    def reset(self, key):
        s = JaxPixelState(jnp.zeros((), jnp.int32), jnp.asarray(5, jnp.int32))
        return s, self._frame(s.t, s.seed)


class _Pixel(SyntheticPixelEnv):
    def reset(self, generator, num_envs, device):
        s = SyntheticPixelState(torch.zeros(num_envs, dtype=torch.int32), torch.full((num_envs,), 5, dtype=torch.int32))
        return s, self.frame(s.t, s.seed)


class _JaxCart(JaxCartPole):
    def reset(self, key):
        s = JaxCartPoleState(*map(jnp.asarray, CART0), jnp.zeros((), jnp.int32))
        return s, self._obs(s)


class _Cart(CartPole):
    def reset(self, generator, num_envs, device):
        v = torch.from_numpy(CART0).repeat(num_envs, 1)
        s = CartPoleState(*v.unbind(1), torch.zeros(num_envs, dtype=torch.int32))
        return s, self._obs(s)


def _run_both(jenv, tenv, jstate0, tstate0, acts):
    jvenv, tvenv = JaxVectorEnv(jenv, N), VectorEnv(tenv, N, device="cpu")
    jstep = jax.jit(jvenv.step)
    jst, tst = jstate0, tstate0
    g = torch.Generator()
    for a in acts:
        jst, jres, jcarry = jstep(jst, jnp.asarray(a), jax.random.key(0))
        tst, tres, tcarry = tvenv.step(tst, torch.from_numpy(a).to(torch.int64), g)
        yield jres, jcarry, tres, tcarry


def test_frame_stack_pixels_bitwise_across_reset():
    jenv, tenv = jw.FrameStack(_JaxPixel(36, 36, 1, num_actions=4, episode_len=5), K), \
        tw.FrameStack(_Pixel(36, 36, 1, num_actions=4, episode_len=5), K)
    assert tenv.observation_space.shape == jenv.observation_space.shape == (K, 36, 36, 1)
    # the envs start mid-episode at different phases
    t0 = np.array([0, 2, 3], np.int32)
    js = JaxPixelState(jnp.asarray(t0), jnp.asarray(SEEDS))
    ts = SyntheticPixelState(torch.from_numpy(t0), torch.from_numpy(SEEDS))
    jframes = jnp.tile(jax.vmap(jenv.env._frame)(js.t, js.seed)[:, None], (1, K, 1, 1, 1))
    tframes = tenv.env.frame(ts.t, ts.seed)[:, None].repeat(1, K, 1, 1, 1)
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
    acts = np.random.default_rng(0).integers(0, 4, (9, N)).astype(np.int32)
    resets = 0
    for jres, jcarry, tres, tcarry in _run_both(jenv, tenv, (js, jframes), (ts, tframes), acts):
        np.testing.assert_array_equal(tres.obs.numpy(), np.asarray(jres.obs))
        np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
        np.testing.assert_array_equal(tres.truncated.numpy(), np.asarray(jres.truncated))
        done = tres.done.numpy()
        resets += int(done.sum())
        # a reset repeats the first frame; otherwise the newest frame is at -1
        for i in range(N):
            if done[i]:
                assert all(torch.equal(tcarry[i, j], tcarry[i, 0]) for j in range(K))
            else:
                assert torch.equal(tcarry[i], tres.obs[i])
    assert resets >= N


def test_frame_stack_cartpole_across_termination():
    jenv, tenv = jw.FrameStack(_JaxCart(), K), tw.FrameStack(_Cart(), K)
    js, jframes = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(0), N))
    ts, tframes = tenv.reset(None, N, "cpu")
    np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
    assert tframes.shape == (N, K, 4)
    acts = np.ones((30, N), np.int32)  # always push right: terminates
    acts[:, 1] = np.arange(30) % 2
    terminations = 0
    prev = tframes
    for jres, jcarry, tres, tcarry in _run_both(jenv, tenv, js, ts, acts):
        np.testing.assert_allclose(tres.obs.numpy(), np.asarray(jres.obs), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tcarry.numpy(), np.asarray(jcarry), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
        assert torch.equal(tres.obs[:, :-1], prev[:, 1:])  # the stack shifts by one frame
        terminations += int(tres.terminated.sum())
        prev = tcarry
    assert terminations >= 1


class _JaxEcho(JaxEnv):
    """Observes the action it was given."""

    observation_space = JaxBox(low=-1.0, high=1.0, shape=(1,))

    def __init__(self, action_space):
        self.action_space = action_space

    def reset(self, key):
        return jnp.zeros(()), jnp.zeros((1,))

    def step(self, state, action):
        obs = jnp.asarray(action, jnp.float32).reshape(-1)
        return state, JaxStepResult(obs, jnp.zeros(()), jnp.zeros((), bool), jnp.ones((), bool))


class _Echo(TorchEnv):
    observation_space = Box(low=-1.0, high=1.0, shape=(1,))

    def __init__(self, action_space):
        self.action_space = action_space

    def reset(self, generator, num_envs, device):
        return torch.zeros(num_envs), torch.zeros(num_envs, 1)

    def step(self, state, action, generator=None):
        obs = action.to(torch.float32).reshape(action.shape[0], -1)
        n = action.shape[0]
        return state, StepResult(obs, torch.zeros(n), torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("case", ["continuous-1d", "continuous-2d", "multidiscrete", "truncated"])
def test_action_wrappers_map_as_jax(case):
    rng = np.random.default_rng(1)
    if case == "continuous-1d":
        jenv = jw.ContinuousToDiscrete(_JaxEcho(JaxBox(-2.0, 2.0, (1,))), 7)
        tenv = tw.ContinuousToDiscrete(_Echo(Box(-2.0, 2.0, (1,))), 7)
        assert tenv.action_space == Discrete(7)
        acts = rng.integers(0, 7, 16).astype(np.int32)
    elif case == "continuous-2d":
        jenv = jw.ContinuousToDiscrete(_JaxEcho(JaxBox((-1.0, 0.0), (1.0, 3.0), (2,))), 5)
        tenv = tw.ContinuousToDiscrete(_Echo(Box((-1.0, 0.0), (1.0, 3.0), (2,))), 5)
        assert tenv.action_space == MultiDiscrete((5, 5))
        acts = rng.integers(0, 5, (16, 2)).astype(np.int32)
    elif case == "multidiscrete":
        jenv = jw.MultiDiscreteToDiscrete(_JaxEcho(JaxMultiDiscrete((3, 4, 2))))
        tenv = tw.MultiDiscreteToDiscrete(_Echo(MultiDiscrete((3, 4, 2))))
        assert tenv.action_space == Discrete(24)
        acts = np.arange(24, dtype=np.int32)
    else:
        jenv = jw.TruncatedAsTerminated(_JaxEcho(JaxBox(-1.0, 1.0, (1,))))
        tenv = tw.TruncatedAsTerminated(_Echo(Box(-1.0, 1.0, (1,))))
        acts = rng.uniform(-1, 1, (16, 1)).astype(np.float32)
    _, jres = jax.vmap(jenv.step)(jnp.zeros(len(acts)), jnp.asarray(acts))
    _, tres = tenv.step(torch.zeros(len(acts)), torch.from_numpy(acts))
    np.testing.assert_array_equal(tres.obs.numpy(), np.asarray(jres.obs).reshape(len(acts), -1))
    np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
    np.testing.assert_array_equal(tres.truncated.numpy(), np.asarray(jres.truncated))
