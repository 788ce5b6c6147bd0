"""Classic-control env port (tianshou_tpu_torch/envs/classic.py) against the
JAX envs: from the same injected states, the same action sequence gives the
same observations, rewards, terminations and truncations, float32 at atol
1e-6 (Acrobot's RK4 at atol 1e-5); the time limits of tests/test_envs.py
hold; VectorEnv auto-resets at a CartPole termination; NChain's slip draws
are JAX's Threefry bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.envs import classic as jax_classic
from tianshou_tpu_torch.envs import classic
from tianshou_tpu_torch.envs.base import VectorEnv

N, T = 16, 20


def _initial_states(name, rng):
    """numpy leaves of a batch of states, inside each env's reset range or
    a little beyond it."""
    t = rng.integers(0, 5, N).astype(np.int32)
    u = lambda lo, hi, n=N: rng.uniform(lo, hi, n).astype(np.float32)
    if name == "CartPole":
        return [u(-0.05, 0.05), u(-0.05, 0.05), u(-0.05, 0.05), u(-0.05, 0.05), t]
    if name == "Pendulum":
        return [u(-np.pi, np.pi), u(-1.0, 1.0), t]
    if name == "MountainCarContinuous":
        return [u(-0.6, -0.4), u(-0.01, 0.01), t]
    if name == "Acrobot":
        return [u(-0.1, 0.1), u(-0.1, 0.1), u(-0.1, 0.1), u(-0.1, 0.1), t]
    return [rng.integers(0, 5, N).astype(np.int32), t]


def _actions(name, rng):
    if name in ("Pendulum", "MountainCarContinuous"):
        hi = 2.5 if name == "Pendulum" else 1.2
        return rng.uniform(-hi, hi, (T, N, 1)).astype(np.float32)
    n = 3 if name == "Acrobot" else 2
    return rng.integers(0, n, (T, N)).astype(np.int32)


def _pair(name, leaves):
    jenv, tenv = getattr(jax_classic, name)(), getattr(classic, name)()
    jstate = type(jax.eval_shape(jenv.reset, jax.random.key(0))[0])(*map(jnp.asarray, leaves))
    return jenv, tenv, jstate, _torch_state(tenv, jstate)


def _torch_state(tenv, leaves):
    return type(tenv.reset(torch.Generator(), 1, "cpu")[0])(*(torch.from_numpy(np.array(x)) for x in leaves))


def _torch_step(tenv, tstate, act):
    act = torch.from_numpy(act)
    return tenv.step(tstate, act if act.is_floating_point() else act.to(torch.int64))


ENVS = ["CartPole", "Pendulum", "MountainCarContinuous", "Acrobot", "NChain"]


@pytest.mark.parametrize("name", ENVS)
def test_steps_match_jax(name):
    """Each step of a JAX trajectory, taken by the port from the same
    state: atol 1e-6 (1e-5 for Acrobot's RK4)."""
    rng = np.random.default_rng(0)
    leaves, acts = _initial_states(name, rng), _actions(name, rng)
    jenv, tenv, jstate, _ = _pair(name, leaves)
    jstep = jax.jit(jax.vmap(jenv.step))
    atol = 1e-5 if name == "Acrobot" else 1e-6
    for t in range(T):
        tstate, tres = _torch_step(tenv, _torch_state(tenv, jstate), acts[t])
        jstate, jres = jstep(jstate, jnp.asarray(acts[t]))
        ref = np.asarray(jres.obs)
        assert tres.obs.dtype == torch.float32 and tres.obs.shape == ref.shape
        np.testing.assert_allclose(tres.obs.numpy(), ref, rtol=0, atol=atol, err_msg=f"obs, step {t}")
        np.testing.assert_allclose(tres.reward.numpy(), np.asarray(jres.reward), rtol=0, atol=atol)
        np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
        np.testing.assert_array_equal(tres.truncated.numpy(), np.asarray(jres.truncated))
        for tl, jl in zip(tstate, jstate):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)


@pytest.mark.parametrize("name", ENVS)
def test_free_running_segment_matches_jax(name):
    """A 20-step segment run by each side on its own: the same terminations
    and truncations; observations drift by float32 ulps (XLA's and
    PyTorch's sin/cos differ in the last bit), within rtol 1e-5 / atol
    1e-5.  Prints the largest difference."""
    rng = np.random.default_rng(0)
    leaves, acts = _initial_states(name, rng), _actions(name, rng)
    jenv, tenv, jstate, tstate = _pair(name, leaves)
    jstep = jax.jit(jax.vmap(jenv.step))
    worst = 0.0
    for t in range(T):
        jstate, jres = jstep(jstate, jnp.asarray(acts[t]))
        tstate, tres = _torch_step(tenv, tstate, acts[t])
        ref = np.asarray(jres.obs)
        np.testing.assert_allclose(tres.obs.numpy(), ref, rtol=1e-5, atol=1e-5, err_msg=f"obs, step {t}")
        np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
        np.testing.assert_array_equal(tres.truncated.numpy(), np.asarray(jres.truncated))
        worst = max(worst, float(np.abs(tres.obs.numpy() - ref).max()))
    print(f"{name}: largest observation difference over a {T}-step segment {worst:.3g}")


def test_nchain_slip_bits_are_jax_threefry():
    t, s = np.meshgrid(np.arange(0, 120, dtype=np.int32), np.arange(5, dtype=np.int32))
    t, s = t.ravel(), s.ravel()
    key = jax.random.key(17)
    ref = np.asarray(jax.vmap(lambda d: jax.random.uniform(jax.random.fold_in(key, d)))(jnp.asarray(t * 1000 + s)))
    got = classic.NChain._slip_uniform(torch.from_numpy(t), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.1 < float((got < classic.NChain.SLIP).mean()) < 0.3


def test_cartpole_truncates_at_500():
    env = classic.CartPole()
    state, _ = env.reset(torch.Generator().manual_seed(0), 1, "cpu")
    zeros = torch.zeros(1)
    state = state._replace(x=zeros, x_dot=zeros, theta=zeros, theta_dot=zeros,
                           t=torch.full((1,), 499, dtype=torch.int32))
    _, res = env.step(state, torch.zeros(1, dtype=torch.int64))
    assert bool(res.truncated) and not bool(res.terminated)


def test_pendulum_truncates_at_200_and_never_terminates():
    env = classic.Pendulum()
    state, _ = env.reset(torch.Generator().manual_seed(0), 1, "cpu")
    state = state._replace(t=torch.full((1,), 199, dtype=torch.int32))
    _, res = env.step(state, torch.zeros(1, 1))
    assert bool(res.truncated) and not bool(res.terminated)
    assert float(res.reward) <= 0.0


def test_vector_env_auto_resets_at_cartpole_termination():
    env = classic.CartPole()
    venv = VectorEnv(env, 4, device="cpu")
    g = torch.Generator().manual_seed(0)
    state, obs = venv.reset(g)
    assert obs.shape == (4, 4) and float(obs.abs().max()) <= 0.05
    # env 0 sits at the cart's limit moving out; the others stay upright
    state = state._replace(x=torch.tensor([2.39, 0.0, 0.0, 0.0]), x_dot=torch.tensor([1.0, 0.0, 0.0, 0.0]),
                           t=torch.tensor([7, 7, 7, 7], dtype=torch.int32))
    state, res, carry = venv.step(state, torch.ones(4, dtype=torch.int64), g)
    assert res.terminated.tolist() == [True, False, False, False] and not res.truncated.any()
    assert float(res.obs[0, 0]) > 2.4  # the buffer keeps the terminal observation
    assert state.t.tolist() == [0, 8, 8, 8]  # env 0 starts a new episode
    assert float(carry[0].abs().max()) <= 0.05
    torch.testing.assert_close(carry[1:], res.obs[1:], rtol=0, atol=0)


def test_make_env():
    assert isinstance(classic.make_env("CartPole-v1"), classic.CartPole)
    from tianshou_tpu_torch.envs.minatar import Breakout

    assert isinstance(classic.make_env("MinAtar/Breakout"), Breakout)
    with pytest.raises(KeyError):
        classic.make_env("Pong-v5")
