"""MinAtar Breakout port (tianshou_tpu_torch/envs/minatar.py) against the JAX
game: with sticky actions off and the reset side injected, frames, rewards,
terminations and truncations are bitwise equal over 200 steps of a fixed
action sequence; the port's copies of the brick and paddle mechanics tests
of tests/test_minatar.py pass; sticky actions fire at about sticky_prob."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.envs.minatar import Breakout as JaxBreakout
from tianshou_tpu_torch.envs.minatar import Breakout, make_minatar

N, STEPS = 12, 200


def _jax_initial(env, side):
    """The JAX reset state with the ball's entry side set from ``side``."""
    st, _ = jax.vmap(env.reset)(jax.random.split(jax.random.key(0), len(side)))
    s = jnp.asarray(side)
    edge = jnp.where(s, 9, 0).astype(jnp.int32)
    return st._replace(ball_x=edge, trail_x=edge, ball_dx=jnp.where(s, -1, 1).astype(jnp.int32))


@pytest.mark.parametrize("max_steps", [1000, 60])
def test_breakout_matches_jax_bitwise(max_steps):
    rng = np.random.default_rng(0)
    side = rng.random(N) < 0.5
    # a policy-like action sequence: runs of one action
    acts = np.repeat(rng.integers(0, 3, (STEPS // 4, N)), 4, axis=0).astype(np.int32)
    jenv = JaxBreakout(sticky_prob=0.0, max_steps=max_steps)
    tenv = Breakout(sticky_prob=0.0, max_steps=max_steps)
    jst = _jax_initial(jenv, side)
    tst = tenv.initial_state(torch.from_numpy(side))
    np.testing.assert_array_equal(tenv._obs(tst).numpy(), np.asarray(jax.vmap(jenv._obs)(jst)))
    jstep = jax.jit(jax.vmap(jenv.step))
    rewards = terminations = 0
    for t in range(STEPS):
        jst, jres = jstep(jst, jnp.asarray(acts[t]))
        tst, tres = tenv.step(tst, torch.from_numpy(acts[t]).to(torch.int64))
        assert tres.obs.dtype == torch.float32 and tres.obs.shape == (N, 10, 10, 4)
        np.testing.assert_array_equal(tres.obs.numpy(), np.asarray(jres.obs), err_msg=f"step {t}")
        np.testing.assert_array_equal(tres.reward.numpy(), np.asarray(jres.reward))
        np.testing.assert_array_equal(tres.terminated.numpy(), np.asarray(jres.terminated))
        np.testing.assert_array_equal(tres.truncated.numpy(), np.asarray(jres.truncated))
        for name in tst._fields:
            np.testing.assert_array_equal(getattr(tst, name).numpy(), np.asarray(getattr(jst, name)), err_msg=name)
        rewards += int(tres.reward.sum())
        terminations += int(tres.terminated.sum())
    assert rewards > 0 and terminations > 0


def _state(**fields):
    env = Breakout(sticky_prob=0.0)
    state = env.initial_state(torch.zeros(1, dtype=torch.bool))
    return env, state._replace(**{k: torch.tensor([v], dtype=torch.int32) for k, v in fields.items()})


def test_breakout_brick_hit_scores_and_bounces():
    # the ball just below the brick wall, moving up into row 3
    env, state = _state(ball_x=5, ball_y=4, ball_dx=1, ball_dy=-1)
    assert bool(state.bricks[0, 3, 6])
    new, res = env.step(state, torch.zeros(1, dtype=torch.int64))
    assert float(res.reward) == 1.0
    assert not bool(new.bricks[0, 3, 6])
    assert int(new.ball_dy) == 1  # bounced back down


def test_breakout_terminates_when_ball_passes_paddle():
    # the ball one row above the bottom, heading down, the paddle far away
    env, state = _state(ball_x=2, ball_y=8, ball_dx=1, ball_dy=1, paddle_x=9)
    _, res = env.step(state, torch.zeros(1, dtype=torch.int64))
    assert bool(res.terminated)
    # the same, with the paddle under the ball: caught, the ball goes on
    state = state._replace(paddle_x=torch.tensor([3], dtype=torch.int32))
    new, res = env.step(state, torch.zeros(1, dtype=torch.int64))
    assert not bool(res.terminated)
    assert int(new.ball_dy) == -1


def test_sticky_actions_fire_at_sticky_prob():
    n = 20_000
    env = Breakout(sticky_prob=0.1)
    state, _ = env.reset(torch.Generator().manual_seed(0), n, "cpu")  # last_action 0
    new, _ = env.step(state, torch.full((n,), 2), torch.Generator().manual_seed(1))
    stuck = float((new.last_action == 0).float().mean())
    # binomial(20000, 0.1): standard deviation 0.0021
    assert abs(stuck - 0.1) < 0.01, stuck
    with pytest.raises(ValueError, match="generator"):
        env.step(state, torch.full((n,), 2))


def test_reset_draws_both_sides():
    state, obs = Breakout().reset(torch.Generator().manual_seed(0), 256, "cpu")
    assert obs.shape == (256, 10, 10, 4) and obs.dtype == torch.float32
    assert set(state.ball_x.tolist()) == {0, 9}
    assert torch.equal(state.ball_dx, torch.where(state.ball_x == 9, -1, 1).to(torch.int32))


def test_make_minatar():
    assert isinstance(make_minatar("MinAtar/Breakout", sticky_prob=0.0), Breakout)
    for game in ("space_invaders", "minatar/freeway", "Asterix", "seaquest"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_minatar(game)
    with pytest.raises(ValueError):
        make_minatar("minatar/pong")
