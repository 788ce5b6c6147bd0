"""MinAtar port (tianshou_tpu_torch/envs/minatar.py) against the JAX games.

- Breakout: with sticky actions off and the reset side injected, frames,
  rewards, terminations and truncations are bitwise equal over 200 steps of
  a fixed action sequence; sticky actions fire at about sticky_prob.
- SpaceInvaders, Freeway, Asterix and Seaquest: with sticky actions on and
  every draw of the JAX step (and of Freeway's reset) computed from the
  JAX state's key as the JAX game makes it and injected into the port's
  (``draws=``), frames, rewards, ``terminated``, ``truncated`` and every
  state field are bitwise equal over segments that cross spawns, deaths,
  truncations and resets (and, for Seaquest, diver banking, surfacing and
  running out of oxygen).
- The copies of tests/test_minatar.py: shapes and ranges and determinism
  for all five games, ``make_env``'s dispatch, each game's mechanics, the
  auto-reset vector env and the conv nets' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.envs import minatar as jm
from tianshou_tpu.envs.minatar import Breakout as JaxBreakout
from tianshou_tpu_torch.data.tree import tree_where
from tianshou_tpu_torch.envs import minatar as tm
from tianshou_tpu_torch.envs.minatar import Asterix, Breakout, Freeway, Seaquest, SpaceInvaders, make_minatar

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
    for game, cls in (("space_invaders", SpaceInvaders), ("minatar/freeway", Freeway), ("Asterix", Asterix),
                      ("minatar-seaquest", Seaquest), ("MinAtar/space-invaders", SpaceInvaders)):
        env = make_minatar(game, sticky_prob=0.0)
        assert isinstance(env, cls)
        state, obs = env.reset(torch.Generator().manual_seed(0), 2, "cpu")
        assert obs.shape == (2,) + env.observation_space.shape
    with pytest.raises(ValueError):
        make_minatar("minatar/pong")


# -- the four later games against JAX, draws injected --------------------------------
def _jax_draws(name):
    """``key -> draws`` of one JAX env's step: the same splits and the same
    ``jax.random`` calls the JAX step makes."""
    r = jax.random

    def space_invaders(key):
        _, k_sticky, k_col = r.split(key, 3)
        return r.uniform(k_sticky), r.gumbel(k_col, (10,))

    def cars(key):
        k1, k2, k3 = r.split(key, 3)
        return r.randint(k1, (8,), 0, 10), r.bernoulli(k2, shape=(8,)), r.randint(k3, (8,), 1, 6)

    def freeway(key):
        _, k_sticky, k_cars = r.split(key, 3)
        return (r.uniform(k_sticky),) + cars(k_cars)

    def asterix(key):
        _, k_sticky, k_lane, k_side, k_gold = r.split(key, 5)
        return r.uniform(k_sticky), r.gumbel(k_lane, (8,)), r.bernoulli(k_side), r.uniform(k_gold)

    def seaquest(key):
        _, k_sticky, k_slot, k_lane, k_side, k_kind, k_dslot, k_dlane, k_dside = r.split(key, 9)
        return (r.uniform(k_sticky), r.gumbel(k_slot, (8,)), r.randint(k_lane, (), 1, 9), r.bernoulli(k_side),
                r.uniform(k_kind), r.gumbel(k_dslot, (4,)), r.randint(k_dlane, (), 1, 9), r.bernoulli(k_dside))

    def freeway_reset(key):
        _, k_cars = r.split(key)
        return cars(k_cars)

    fns = {"space_invaders": space_invaders, "freeway": freeway, "asterix": asterix, "seaquest": seaquest,
           "freeway_reset": freeway_reset}
    return jax.jit(jax.vmap(fns[name]))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_draws(name, arrays):
    a = [_t(x) for x in arrays]
    if name == "space_invaders":
        return tm.SpaceInvadersDraws(*a)
    if name == "freeway":
        return tm.FreewayDraws(a[0], tm.FreewayCars(*a[1:]))
    if name == "asterix":
        return tm.AsterixDraws(*a)
    return tm.SeaquestDraws(*a)


# per game: envs, steps, max_steps, the action law (probabilities), and
# start-state overrides per env (the same on both sides)
SEGMENTS = {
    "space_invaders": dict(n=16, steps=400, max_steps=300, p=None, start={}),
    "freeway": dict(n=12, steps=300, max_steps=120, p=[0.15, 0.75, 0.1], start={}),
    "asterix": dict(n=16, steps=300, max_steps=150, p=None, start={}),
    # mostly submerged: fire and sideways, down more often than up
    # mostly submerged: fire and sideways, down more often than up; every
    # sub starts just under the surface and the first action is "up", so
    # that the first step banks, drops and drowns
    "seaquest": dict(n=16, steps=500, max_steps=2500, p=[0.2, 0.2, 0.04, 0.2, 0.16, 0.2], first=2,
                     start=dict(sub_y=[1] * 16, surfaced=[False] * 16, diver_count=[6, 6, 6, 6, 5, 5, 3, 0] * 2,
                                oxygen=[200] * 8 + [40] * 8)),
}


@pytest.mark.parametrize("name", list(SEGMENTS))
def test_game_matches_jax_bitwise_with_injected_draws(name):
    cfg = SEGMENTS[name]
    n, rng = cfg["n"], np.random.default_rng(7)
    jenv = jm.make_minatar(name, max_steps=cfg["max_steps"])  # sticky actions on (0.1)
    tenv = make_minatar(name, max_steps=cfg["max_steps"])
    jstep, jreset, jdraw = jax.jit(jax.vmap(jenv.step)), jax.jit(jax.vmap(jenv.reset)), _jax_draws(name)

    def reset_pair(key):
        keys = jax.random.split(key, n)
        jst, jobs = jreset(keys)
        cars = tm.FreewayCars(*(_t(x) for x in _jax_draws("freeway_reset")(keys))) if name == "freeway" else None
        tst, tobs = tenv.reset(None, n, "cpu", cars=cars) if cars is not None else tenv.reset(None, n, "cpu")
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
        return jst, tst

    jst, tst = reset_pair(jax.random.key(0))
    over = {k: np.asarray(v, np.asarray(getattr(jst, k)).dtype) for k, v in cfg["start"].items()}
    jst = jst._replace(**{k: jnp.asarray(v) for k, v in over.items()})
    tst = tst._replace(**{k: torch.from_numpy(v) for k, v in over.items()})
    num_actions = tenv.action_space.n
    totals = dict(reward=0.0, terminated=0, truncated=0)
    rules = dict(banked=0, dropped=0, out_of_air=0, drowned=0, enemy_spawns=0, divers_collected=0)
    for t in range(cfg["steps"]):
        acts = rng.choice(num_actions, size=n, p=cfg["p"]).astype(np.int32)
        if t == 0 and "first" in cfg:
            acts[:] = cfg["first"]
        draws = _port_draws(name, jdraw(jst.key))
        jst, jres = jstep(jst, jnp.asarray(acts))
        before = tst
        tst, tres = tenv.step(tst, torch.from_numpy(acts).to(torch.int64), draws=draws)
        if name == "seaquest":
            _count_seaquest_rules(rules, before, tst, tres)
        assert tres.obs.dtype == torch.float32 and tres.obs.shape == (n,) + tenv.observation_space.shape
        np.testing.assert_array_equal(tres.obs.numpy(), np.asarray(jres.obs), err_msg=f"{name} step {t}")
        for field in ("reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tres, field).numpy(), np.asarray(getattr(jres, field)),
                                          err_msg=f"{name} step {t} {field}")
        for field in tst._fields:
            np.testing.assert_array_equal(getattr(tst, field).numpy(), np.asarray(getattr(jst, field)),
                                          err_msg=f"{name} step {t} {field}")
        totals["reward"] += float(tres.reward.sum())
        totals["terminated"] += int(tres.terminated.sum())
        totals["truncated"] += int(tres.truncated.sum())
        done = np.asarray(jres.terminated | jres.truncated)
        if done.any():  # a fresh episode where one ended, on both sides
            jnew, tnew = reset_pair(jax.random.key(1000 + t))
            jst = jax.tree.map(lambda a, b: jnp.where(done.reshape((n,) + (1,) * (b.ndim - 1)), a, b), jnew, jst)
            tst = tree_where(torch.from_numpy(done.copy()), tnew, tst)
    assert totals["reward"] > 0, totals
    assert totals["terminated"] + totals["truncated"] > 0, totals
    if name == "freeway":
        assert totals["truncated"] > 0 and totals["terminated"] == 0
    else:
        assert totals["terminated"] > 0
    if name == "seaquest":  # the segment crosses every surfacing and oxygen rule
        assert all(v > 0 for v in rules.values()), rules


def _count_seaquest_rules(rules, before, after, res):
    fresh = (after.sub_y == 0) & ~before.surfaced
    rules["banked"] += int((fresh & (res.reward >= 5)).sum())
    rules["dropped"] += int((fresh & (after.diver_count == before.diver_count - 1)).sum())
    rules["out_of_air"] += int(((after.oxygen < 0) & res.terminated).sum())
    rules["drowned"] += int((fresh & (before.diver_count == 0) & res.terminated).sum())
    rules["enemy_spawns"] += int((after.en_exists & ~before.en_exists).sum())
    rules["divers_collected"] += int((after.diver_count > before.diver_count).sum())


# -- copies of tests/test_minatar.py -------------------------------------------------
ALL_GAMES = ["breakout", "space_invaders", "freeway", "asterix", "seaquest"]


@pytest.mark.parametrize("name", ALL_GAMES)
def test_reset_step_shapes_and_ranges(name):
    env = make_minatar(name, sticky_prob=0.0)
    gen = torch.Generator().manual_seed(0)
    state, obs = env.reset(gen, 1, "cpu")
    assert obs.shape == (1,) + env.observation_space.shape
    assert obs.dtype == torch.float32
    for i in range(20):
        act = env.action_space.sample(torch.Generator().manual_seed(i), (1,))
        state, res = env.step(state, act, gen)
        assert res.obs.shape == (1,) + env.observation_space.shape
        assert res.reward.shape == (1,)
        assert res.terminated.dtype == torch.bool and res.truncated.dtype == torch.bool
        lo, hi = env.observation_space.low, env.observation_space.high
        assert float(res.obs.min()) >= float(np.min(lo)) - 1e-6
        assert float(res.obs.max()) <= float(np.max(hi)) + 1e-6


@pytest.mark.parametrize("name", ALL_GAMES)
def test_determinism(name):
    env = make_minatar(name)  # sticky on: randomness must come from the generator
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    s1, o1 = env.reset(g1, 1, "cpu")
    s2, o2 = env.reset(g2, 1, "cpu")
    np.testing.assert_array_equal(o1, o2)
    for i in range(15):
        act = env.action_space.sample(torch.Generator().manual_seed(100 + i), (1,))
        s1, r1 = env.step(s1, act, g1)
        s2, r2 = env.step(s2, act, g2)
        np.testing.assert_array_equal(r1.obs, r2.obs)
        assert float(r1.reward) == float(r2.reward)


def test_make_env_dispatches_minatar():
    from tianshou_tpu_torch.envs.classic import make_env

    assert isinstance(make_env("MinAtar/Breakout"), Breakout)
    assert isinstance(make_env("minatar/space-invaders"), SpaceInvaders)
    with pytest.raises(ValueError):
        make_minatar("minatar/pong")


def _reset1(env):
    return env.reset(torch.Generator().manual_seed(0), 1, "cpu")[0]


def _i(*v):
    return torch.tensor(v, dtype=torch.int32)


def _noop():
    return torch.zeros(1, dtype=torch.int64)


def test_space_invaders_shoot_alien():
    env = SpaceInvaders(sticky_prob=0.0)
    state = _reset1(env)
    # drop a friendly bullet just below the alien block's bottom row (row 4)
    fb = state.f_bullets.clone()
    fb[0, 5, 4] = True
    state = state._replace(f_bullets=fb)
    assert bool(state.aliens[0, 4, 4])
    new, res = env.step(state, _noop(), torch.Generator())
    assert float(res.reward) == 1.0
    assert not bool(new.aliens[0, 4, 4])
    assert not bool(new.f_bullets[0, 4, 4])  # bullet consumed


def test_space_invaders_enemy_bullet_kills():
    env = SpaceInvaders(sticky_prob=0.0)
    state = _reset1(env)
    eb = state.e_bullets.clone()
    eb[0, 8, int(state.pos)] = True
    state = state._replace(e_bullets=eb)
    _, res = env.step(state, _noop(), torch.Generator())
    assert bool(res.terminated)


def test_freeway_score_resets_player():
    env = Freeway(sticky_prob=0.0)
    state = _reset1(env)
    # one step from the top, off cooldown; move all cars away from our column
    state = state._replace(player_y=_i(1), move_cooldown=_i(0), car_x=torch.zeros((1, 8), dtype=torch.int32))
    new, res = env.step(state, torch.ones(1, dtype=torch.int64), torch.Generator())  # up
    assert float(res.reward) == 1.0
    assert int(new.player_y) == 9  # reset to start
    assert not bool(res.terminated)  # freeway only truncates


def test_freeway_collision_knocks_back():
    env = Freeway(sticky_prob=0.0)
    state = _reset1(env)
    # park a stopped car on the player's cell in lane 4
    car_x = state.car_x.clone()
    car_x[0, 3] = 4  # lane index 3 -> row 4
    state = state._replace(player_y=_i(4), car_x=car_x, car_timer=torch.full((1, 8), 100, dtype=torch.int32))
    new, res = env.step(state, _noop(), torch.Generator())
    assert int(new.player_y) == 9
    assert float(res.reward) == 0.0


def test_asterix_gold_and_enemy():
    env = Asterix(sticky_prob=0.0)
    state = _reset1(env)
    # gold entity sitting where the player will stay (lane row 5 = slot 4)
    exists, ent_x, gold = state.ent_exists.clone(), state.ent_x.clone(), state.ent_gold.clone()
    exists[0, 4], ent_x[0, 4], gold[0, 4] = True, 5, True
    state = state._replace(ent_exists=exists, ent_x=ent_x, ent_gold=gold,
                           move_timer=_i(100),  # entities won't move
                           spawn_timer=_i(100))
    new, res = env.step(state, _noop(), torch.Generator())
    assert float(res.reward) == 1.0
    assert not bool(res.terminated)
    assert not bool(new.ent_exists[0, 4])  # collected
    # same but an enemy: terminal
    not_gold = state.ent_gold.clone()
    not_gold[0, 4] = False
    _, res = env.step(state._replace(ent_gold=not_gold), _noop(), torch.Generator())
    assert bool(res.terminated)
    assert float(res.reward) == 0.0


@pytest.mark.parametrize("name", ["breakout", "asterix"])
def test_vectorized_autoreset(name):
    """MinAtar envs compose with the auto-reset VectorEnv."""
    from tianshou_tpu_torch.envs.base import VectorEnv

    venv = VectorEnv(make_minatar(name), num_envs=4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = venv.reset(gen)
    for i in range(30):
        acts = torch.randint(0, 3, (4,), generator=torch.Generator().manual_seed(i))
        state, res, carry_obs = venv.step(state, acts, gen)
    assert res.obs.shape == (4, *venv.env.observation_space.shape)
    assert carry_obs.shape == res.obs.shape
    assert torch.isfinite(res.obs).all()


def test_minatar_cnn_shapes():
    from tianshou_tpu_torch.networks.conv import MinAtarCNN

    out = MinAtarCNN((10, 10, 4))(torch.zeros((8, 10, 10, 4)))
    assert out.shape == (8, 128)
    assert out.dtype == torch.float32


def test_nature_cnn_shapes_and_framestack_fold():
    from tianshou_tpu_torch.networks.conv import NatureCNN

    assert NatureCNN((84, 84, 4), hidden=64)(torch.zeros((2, 84, 84, 4))).shape == (2, 64)
    # frame-stacked [B,S,H,W,C] input folds the stack into channels
    assert NatureCNN((4, 84, 84, 1), hidden=64)(torch.zeros((2, 4, 84, 84, 1))).shape == (2, 64)


def test_conv_q_heads():
    from tianshou_tpu_torch.networks.conv import ConvDuelingQNet, ConvQNet

    x = torch.zeros((8, 10, 10, 4))
    assert ConvQNet((10, 10, 4), 3, "minatar")(x).shape == (8, 3)
    out = ConvDuelingQNet((10, 10, 4), 3)(x)
    assert out.shape == (8, 3)
    assert torch.isfinite(out).all()


# -- Seaquest dynamics ------------------------------------------------------------------
def _sq_state(env, **overrides):
    state = _reset1(env)

    def value(k, v):
        v = torch.as_tensor(np.asarray(v))
        return v.to(getattr(state, k).dtype).reshape(getattr(state, k).shape)

    return state._replace(**{k: value(k, v) for k, v in overrides.items()})


def _act(a):
    return torch.tensor([a])


def test_seaquest_shapes_and_movement():
    env = Seaquest(sticky_prob=0.0)
    state, obs = env.reset(torch.Generator().manual_seed(0), 1, "cpu")
    assert obs.shape == (1, 10, 10, 9)
    g = torch.Generator()
    # dive, then move right: facing flips to +1 and x advances
    state, _ = env.step(state, _act(4), g)  # down
    assert int(state.sub_y) == 1
    x0 = int(state.sub_x)
    state, _ = env.step(state, _act(3), g)  # right
    assert int(state.sub_x) == x0 + 1 and int(state.sub_or) == 1
    state, _ = env.step(state, _act(1), g)  # left
    assert int(state.sub_x) == x0 and int(state.sub_or) == -1


def test_seaquest_bullet_kills_fish_scores():
    env = Seaquest(sticky_prob=0.0)
    one = np.zeros(8, bool)
    one[0] = True
    st = _sq_state(
        env, sub_y=3, sub_x=2, sub_or=1, surfaced=False,
        # a fish 3 cells to the right in the same lane, not moving soon
        en_exists=one, en_x=np.where(one, 6, 0), en_y=np.full(8, 3), en_dir=np.zeros(8),  # static for the test
        en_move_timer=100, en_spawn_timer=100, dv_spawn_timer=100,
    )
    g = torch.Generator()
    st, res = env.step(st, _act(5), g)  # fire -> bullet at (3,2) moves right
    total = float(res.reward)
    for _ in range(5):
        st, res = env.step(st, _act(0), g)
        total += float(res.reward)
        if res.terminated:
            break
    assert total == 1.0  # fish at x=6 destroyed by the travelling bullet
    assert not bool(st.en_exists[0, 0])


def test_seaquest_oxygen_depletes_and_kills():
    env = Seaquest(sticky_prob=0.0)
    st = _sq_state(env, sub_y=5, surfaced=False, oxygen=2, en_spawn_timer=10_000)
    g = torch.Generator()
    st, res = env.step(st, _act(0), g)
    assert not bool(res.terminated)
    st, res = env.step(st, _act(0), g)
    st, res2 = env.step(st, _act(0), g)
    assert bool(res2.terminated)  # oxygen < 0


def test_seaquest_surface_no_divers_terminal():
    env = Seaquest(sticky_prob=0.0)
    st = _sq_state(env, sub_y=1, surfaced=False, diver_count=0)
    st, res = env.step(st, _act(2), torch.Generator())  # up to the surface with no divers
    assert bool(res.terminated)


def test_seaquest_surface_with_divers_drops_one_and_refills():
    env = Seaquest(sticky_prob=0.0)
    st = _sq_state(env, sub_y=1, surfaced=False, diver_count=3, oxygen=17)
    st, res = env.step(st, _act(2), torch.Generator())
    assert not bool(res.terminated)
    assert int(st.diver_count) == 2
    assert int(st.oxygen) == env.MAX_OXYGEN
    assert float(res.reward) == 0.0


def test_seaquest_surface_with_six_divers_banks_reward_and_ramps():
    env = Seaquest(sticky_prob=0.0)
    st = _sq_state(env, sub_y=1, surfaced=False, diver_count=6, oxygen=env.MAX_OXYGEN)
    interval0 = int(st.en_spawn_interval)
    st, res = env.step(st, _act(2), torch.Generator())
    assert float(res.reward) >= 9.0  # oxygen*10//200 with near-full oxygen
    assert int(st.diver_count) == 0
    assert int(st.en_spawn_interval) == interval0 - 1


def test_seaquest_diver_collection():
    env = Seaquest(sticky_prob=0.0)
    one = np.zeros(4, bool)
    one[0] = True
    st = _sq_state(env, sub_y=4, sub_x=5, surfaced=False, dv_exists=one, dv_x=np.where(one, 4, 0),
                   dv_y=np.full(4, 4), dv_dir=np.zeros(4), dv_move_timer=100, en_spawn_timer=100,
                   dv_spawn_timer=100)
    st, res = env.step(st, _act(1), torch.Generator())  # move left onto the diver
    assert int(st.diver_count) == 1
    assert not bool(st.dv_exists[0, 0])


def test_seaquest_enemy_contact_terminal():
    env = Seaquest(sticky_prob=0.0)
    one = np.zeros(8, bool)
    one[0] = True
    st = _sq_state(env, sub_y=4, sub_x=5, surfaced=False, en_exists=one, en_x=np.where(one, 4, 0),
                   en_y=np.full(8, 4), en_dir=np.zeros(8), en_move_timer=100)
    st, res = env.step(st, _act(1), torch.Generator())  # step into the fish
    assert bool(res.terminated)
