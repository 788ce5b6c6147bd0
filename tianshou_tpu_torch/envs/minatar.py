"""MinAtar-style pixel environments (port of ``tianshou_tpu/envs/minatar.py``:
Breakout, SpaceInvaders, Freeway, Asterix and Seaquest, the 5-game suite).

10x10 multi-channel binary grids after the MinAtar benchmark (Young & Tian,
2019, arXiv 1903.03176), written for a whole batch of games at once.
Observations are ``[num_envs, 10, 10, C]`` float32 one-hot entity planes
(Freeway's third channel holds signed car speeds).  Like MinAtar, each game
has *sticky actions*: with probability ``sticky_prob`` (default 0.1) the
previous action replaces the agent's.  Episodes also truncate at
``max_steps``.

Random draws come from the generator that ``step`` and ``reset`` are given
(the collector's stream); the JAX package splits a key kept in the env
state.  The four later games make every draw of a step at once (their
``draw`` method, the JAX step's key splits in order) and take them as a
small ``NamedTuple`` (``draws=``) in place of the generator, which is how
the parity tests inject the JAX game's own draws: a uniform for the sticky
action, scores whose largest entry among the free slots (occupied columns)
is the uniform pick (the JAX game's Gumbel draws), and the spawns'
integers and coins.  Freeway's ``reset`` draws its cars the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.envs.base import StepResult, TorchEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = [
    "Breakout", "BreakoutState", "SpaceInvaders", "SpaceInvadersState", "SpaceInvadersDraws", "Freeway",
    "FreewayState", "FreewayCars", "FreewayDraws", "Asterix", "AsterixState", "AsterixDraws", "Seaquest",
    "SeaquestState", "SeaquestDraws", "make_minatar",
]

SIZE = 10


def _grid(*planes: torch.Tensor) -> torch.Tensor:
    """Stack ``[N, 10, 10]`` channel planes into ``[N, 10, 10, C]`` float32."""
    return torch.stack(planes, dim=-1).to(torch.float32)


def _one_hot_plane(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[N, 10, 10]`` planes with the single cell ``(y, x)`` of each env set
    (row-major: axis 1 is y)."""
    ar = torch.arange(SIZE, device=x.device)
    return (ar[None, :, None] == y[:, None, None]) & (ar[None, None, :] == x[:, None, None])


class _StickyMixin:
    """Shared sticky-action + time-limit plumbing."""

    sticky_prob: float
    max_steps: int

    def _apply_sticky(
        self, generator: torch.Generator | None, action: torch.Tensor, last_action: torch.Tensor,
        u: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """The action after the sticky draw: ``u`` (a uniform in ``[0, 1)`` a
        env) if given, else a draw from ``generator``."""
        action = action.to(torch.int32)
        if self.sticky_prob <= 0.0:
            return action
        if u is None:
            if generator is None:
                raise ValueError(f"{type(self).__name__} with sticky_prob > 0 steps with a generator")
            u = torch.rand(action.shape, generator=generator, device=action.device)
        return torch.where(u < self.sticky_prob, last_action, action)

    def _draws(self, draws, generator, num_envs: int, device):
        if draws is not None:
            return draws
        if generator is None:
            raise ValueError(f"{type(self).__name__} steps with a generator (or injected draws)")
        return self.draw(generator, num_envs, device)


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _pick(free: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Per env, the free entry of ``free [N, S]`` with the largest score (the
    first one where none is free, as the JAX ``argmax`` of all ``-inf``)."""
    return torch.where(free, scores, -torch.inf).argmax(dim=-1)


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """The index of the first True along the last axis (0 where none)."""
    return x.to(torch.uint8).argmax(dim=-1)


def _shift(plane: torch.Tensor, dy, dx) -> torch.Tensor:
    """``[N, 10, 10]`` planes shifted by ``(dy, dx)`` (ints, or ``[N]``
    tensors, a shift per env), cells that leave the grid dropped."""
    if isinstance(dy, int) and isinstance(dx, int):
        out = torch.zeros_like(plane)
        src_y, dst_y = slice(max(0, -dy), SIZE - max(0, dy)), slice(max(0, dy), SIZE - max(0, -dy))
        src_x, dst_x = slice(max(0, -dx), SIZE - max(0, dx)), slice(max(0, dx), SIZE - max(0, -dx))
        out[:, dst_y, dst_x] = plane[:, src_y, src_x]
        return out
    n, dev = plane.shape[0], plane.device
    ar = torch.arange(SIZE, device=dev)
    # an int shift as a fill on the device (a host scalar copied over would wait)
    dy = dy if isinstance(dy, torch.Tensor) else torch.full((n,), dy, dtype=torch.int32, device=dev)
    dx = dx if isinstance(dx, torch.Tensor) else torch.full((n,), dx, dtype=torch.int32, device=dev)
    ys = ar[None, :, None] - dy[:, None, None]
    xs = ar[None, None, :] - dx[:, None, None]
    valid = (ys >= 0) & (ys < SIZE) & (xs >= 0) & (xs < SIZE)
    env = torch.arange(n, device=dev)[:, None, None]
    return plane[env, ys.clamp(0, SIZE - 1), xs.clamp(0, SIZE - 1)] & valid


def _lane_plane(x: torch.Tensor, on: torch.Tensor | None = None) -> torch.Tensor:
    """``[N, 10, 10]`` planes with lane ``i`` (row ``i + 1``) holding one cell
    at column ``x[:, i]`` (set where ``on``), the other rows empty."""
    n, lanes = x.shape
    ar = torch.arange(SIZE, device=x.device)
    rows = ar[None, None, :] == x[:, :, None]  # [N, lanes, 10]
    if on is not None:
        rows = rows & on[:, :, None]
    pad = torch.zeros((n, 1, SIZE), dtype=rows.dtype, device=x.device)
    return torch.cat([pad, rows, pad.expand(n, SIZE - 1 - lanes, SIZE)], dim=1)


def _slot_plane(exists: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``[N, 10, 10]``: the cells ``(y, x)`` of the slots that exist (the
    JAX ``.at[y, x].max(exists)``)."""
    ar = torch.arange(SIZE, device=x.device)
    cells = (ar[None, None, :, None] == y[:, :, None, None]) & (ar[None, None, None, :] == x[:, :, None, None])
    return (cells & exists[:, :, None, None]).any(dim=1)


def _cell(plane: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``plane[n, y[n, ...], x[n, ...]]`` per env."""
    env = torch.arange(plane.shape[0], device=plane.device).reshape((-1,) + (1,) * (y.dim() - 1))
    return plane[env, y, x]


def _set_slot(values: torch.Tensor, slot: torch.Tensor, on: torch.Tensor, new) -> torch.Tensor:
    """``values [N, S]`` with entry ``slot`` of each env set to ``new`` where
    ``on`` (the JAX ``.at[slot].set(where(on, new, values[slot]))``)."""
    mask = (torch.arange(values.shape[1], device=values.device)[None, :] == slot[:, None]) & on[:, None]
    if isinstance(new, torch.Tensor):
        return torch.where(mask, new.to(values.dtype)[:, None], values)
    return torch.where(mask, torch.full_like(values, new), values)


class BreakoutState(NamedTuple):
    paddle_x: torch.Tensor  # int32, column of the paddle (row 9)
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    ball_dx: torch.Tensor  # +-1
    ball_dy: torch.Tensor  # +-1
    trail_x: torch.Tensor  # previous ball cell (trail channel)
    trail_y: torch.Tensor
    bricks: torch.Tensor  # [N, 10, 10] bool
    last_action: torch.Tensor
    t: torch.Tensor


class Breakout(_StickyMixin, TorchEnv):
    """MinAtar Breakout: 3 rows of bricks, diagonal ball, 1-cell paddle.

    Channels: 0=paddle, 1=ball, 2=trail (ball's previous cell, conveys
    direction), 3=brick.  Actions: 0=stay, 1=left, 2=right.
    Reward +1 per brick; the episode ends when the ball passes the paddle
    row.  Clearing all bricks respawns the wall.
    """

    action_space = Discrete(3)
    observation_space = Box(low=0.0, high=1.0, shape=(SIZE, SIZE, 4))
    BRICK_ROWS = (1, 2, 3)

    def __init__(self, sticky_prob: float = 0.1, max_steps: int = 1000):
        self.sticky_prob = sticky_prob
        self.max_steps = max_steps

    def _brick_wall(self, num_envs: int, device) -> torch.Tensor:
        rows = torch.arange(SIZE, device=device)
        wall = (rows >= min(self.BRICK_ROWS)) & (rows <= max(self.BRICK_ROWS))
        return wall[None, :, None].expand(num_envs, SIZE, SIZE)

    def initial_state(self, side: torch.Tensor) -> BreakoutState:
        """The reset state for ``side [N] bool`` (True: the ball enters from
        the right, moving left)."""
        n, dev = side.shape[0], side.device
        i32 = dict(dtype=torch.int32, device=dev)
        edge = torch.where(side, SIZE - 1, 0).to(torch.int32)
        return BreakoutState(
            paddle_x=torch.full((n,), SIZE // 2, **i32),
            ball_x=edge,
            ball_y=torch.full((n,), 4, **i32),
            ball_dx=torch.where(side, -1, 1).to(torch.int32),
            ball_dy=torch.ones((n,), **i32),
            trail_x=edge.clone(),
            trail_y=torch.full((n,), 4, **i32),
            bricks=self._brick_wall(n, dev).clone(),
            last_action=torch.zeros((n,), **i32),
            t=torch.zeros((n,), **i32),
        )

    def reset(self, generator, num_envs, device):
        side = torch.rand((num_envs,), generator=generator, device=device) < 0.5
        st = self.initial_state(side)
        return st, self._obs(st)

    def _obs(self, s: BreakoutState) -> torch.Tensor:
        paddle = _one_hot_plane(s.paddle_x, torch.full_like(s.paddle_x, SIZE - 1))
        ball = _one_hot_plane(s.ball_x, s.ball_y)
        trail = _one_hot_plane(s.trail_x, s.trail_y)
        return _grid(paddle, ball, trail, s.bricks)

    def step(self, state: BreakoutState, action: torch.Tensor, generator=None):
        action = self._apply_sticky(generator, action, state.last_action)
        env = torch.arange(action.shape[0], device=action.device)

        move = (action == 2).to(torch.int32) - (action == 1).to(torch.int32)
        paddle_x = torch.clamp(state.paddle_x + move, 0, SIZE - 1)

        # ball advance with wall reflection on x and ceiling on y
        nx = state.ball_x + state.ball_dx
        dx = torch.where((nx < 0) | (nx >= SIZE), -state.ball_dx, state.ball_dx)
        nx = torch.clamp(nx, 0, SIZE - 1)
        ny = state.ball_y + state.ball_dy
        dy = torch.where(ny < 0, -state.ball_dy, state.ball_dy)
        ny = torch.clamp(ny, 0, SIZE - 1)

        # brick strike: remove brick, bounce back vertically, score.  The
        # cell is empty afterwards whether or not it held a brick (a mask,
        # not an indexed write of a Python scalar, which would copy it to
        # the card and wait for it).
        hit_brick = state.bricks[env, ny, nx]
        bricks = state.bricks & ~_one_hot_plane(nx, ny)
        reward = hit_brick.to(torch.float32)
        dy = torch.where(hit_brick, -dy, dy)
        ny = torch.where(hit_brick, state.ball_y, ny)
        nx_after = torch.where(hit_brick, state.ball_x, nx)

        # paddle interaction at the bottom row
        at_bottom = ny == SIZE - 1
        caught = at_bottom & (nx_after == paddle_x)
        dy = torch.where(caught, -1, dy).to(torch.int32)
        terminated = at_bottom & ~caught

        # respawn the wall once cleared
        cleared = ~bricks.flatten(1).any(dim=1)
        bricks = torch.where(cleared[:, None, None], self._brick_wall(len(env), env.device), bricks)

        t = state.t + 1
        truncated = (t >= self.max_steps) & ~terminated
        new = BreakoutState(
            paddle_x=paddle_x,
            ball_x=nx_after,
            ball_y=ny,
            ball_dx=dx,
            ball_dy=dy,
            trail_x=state.ball_x,
            trail_y=state.ball_y,
            bricks=bricks,
            last_action=action,
            t=t,
        )
        return new, StepResult(self._obs(new), reward, terminated, truncated)


def _i32(n: int, value: int, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.int32, device=device)


def _move(action: torch.Tensor, minus: int, plus: int) -> torch.Tensor:
    """-1 for action ``minus``, +1 for ``plus``, else 0 (int32)."""
    return (action == plus).to(torch.int32) - (action == minus).to(torch.int32)


# =====================================================================
# Space Invaders
# =====================================================================
class SpaceInvadersState(NamedTuple):
    pos: torch.Tensor  # cannon column (row 9)
    aliens: torch.Tensor  # [N, 10, 10] bool
    alien_dir: torch.Tensor  # +-1
    alien_move_timer: torch.Tensor
    alien_move_interval: torch.Tensor
    alien_shot_timer: torch.Tensor
    f_bullets: torch.Tensor  # [N, 10, 10] bool, friendly (move up)
    e_bullets: torch.Tensor  # [N, 10, 10] bool, enemy (move down)
    shot_cooldown: torch.Tensor
    ramp_index: torch.Tensor  # waves cleared (speeds up each wave)
    last_action: torch.Tensor
    t: torch.Tensor


class SpaceInvadersDraws(NamedTuple):
    sticky: torch.Tensor  # [N] uniform in [0, 1)
    column: torch.Tensor  # [N, 10] scores: the occupied column with the largest fires


class SpaceInvaders(_StickyMixin, TorchEnv):
    """MinAtar Space Invaders: 6x4 alien block, side-to-side march with
    descent at the walls, random alien fire from the lowest alien of a
    column, player cannon with fire cooldown.

    Channels: 0=cannon, 1=alien, 2=alien-moving-left, 3=alien-moving-right,
    4=friendly bullet, 5=enemy bullet.  Actions: 0=noop, 1=left, 2=right,
    3=fire.  Reward +1 per alien destroyed; terminal when an alien reaches
    the cannon row or an enemy bullet hits the cannon.
    """

    action_space = Discrete(4)
    observation_space = Box(low=0.0, high=1.0, shape=(SIZE, SIZE, 6))
    SHOT_COOLDOWN = 5
    ENEMY_SHOT_INTERVAL = 10
    INITIAL_MOVE_INTERVAL = 12

    def __init__(self, sticky_prob: float = 0.1, max_steps: int = 1000):
        self.sticky_prob = sticky_prob
        self.max_steps = max_steps

    @staticmethod
    def _alien_block(num_envs: int, device) -> torch.Tensor:
        ar = torch.arange(SIZE, device=device)
        block = ((ar >= 1) & (ar < 5))[:, None] & ((ar >= 2) & (ar < 8))[None, :]
        return block[None].expand(num_envs, SIZE, SIZE)

    def draw(self, generator: torch.Generator, num_envs: int, device) -> SpaceInvadersDraws:
        return SpaceInvadersDraws(_uniform(generator, (num_envs,), device),
                                  _uniform(generator, (num_envs, SIZE), device))

    def reset(self, generator, num_envs, device):
        dev = torch.device(device)
        z = _i32(num_envs, 0, dev)
        empty = torch.zeros((num_envs, SIZE, SIZE), dtype=torch.bool, device=dev)
        st = SpaceInvadersState(
            pos=_i32(num_envs, SIZE // 2, dev),
            aliens=self._alien_block(num_envs, dev).clone(),
            alien_dir=_i32(num_envs, -1, dev),
            alien_move_timer=_i32(num_envs, self.INITIAL_MOVE_INTERVAL, dev),
            alien_move_interval=_i32(num_envs, self.INITIAL_MOVE_INTERVAL, dev),
            alien_shot_timer=_i32(num_envs, self.ENEMY_SHOT_INTERVAL, dev),
            f_bullets=empty,
            e_bullets=empty.clone(),
            shot_cooldown=z,
            ramp_index=z.clone(),
            last_action=z.clone(),
            t=z.clone(),
        )
        return st, self._obs(st)

    def _obs(self, s: SpaceInvadersState) -> torch.Tensor:
        cannon = _one_hot_plane(s.pos, torch.full_like(s.pos, SIZE - 1))
        left = s.aliens & (s.alien_dir < 0)[:, None, None]
        right = s.aliens & (s.alien_dir > 0)[:, None, None]
        return _grid(cannon, s.aliens, left, right, s.f_bullets, s.e_bullets)

    def step(self, state: SpaceInvadersState, action: torch.Tensor, generator=None,
             draws: SpaceInvadersDraws | None = None):
        n, dev = action.shape[0], action.device
        d = self._draws(draws, generator, n, dev)
        action = self._apply_sticky(None, action, state.last_action, d.sticky)
        env = torch.arange(n, device=dev)

        pos = torch.clamp(state.pos + _move(action, 1, 2), 0, SIZE - 1)

        # player fire (row above the cannon), rate-limited
        fire = (action == 3) & (state.shot_cooldown == 0)
        f_bullets = state.f_bullets | (_one_hot_plane(pos, torch.full_like(pos, SIZE - 2)) & fire[:, None, None])
        shot_cooldown = torch.where(fire, self.SHOT_COOLDOWN, torch.clamp(state.shot_cooldown - 1, min=0))

        # bullets advance
        f_bullets = _shift(f_bullets, -1, 0)
        e_bullets = _shift(state.e_bullets, 1, 0)

        # alien march on its timer: sideways, descend + flip at walls
        move_now = state.alien_move_timer <= 0
        cols = state.aliens.any(dim=1)  # [N, 10]
        leftmost = _first_true(cols)
        rightmost = SIZE - 1 - _first_true(cols.flip(-1))
        at_wall = torch.where(state.alien_dir < 0, leftmost == 0, rightmost == SIZE - 1)
        descend = move_now & at_wall
        side = move_now & ~at_wall
        aliens = torch.where(
            side[:, None, None], _shift(state.aliens, 0, state.alien_dir),
            torch.where(descend[:, None, None], _shift(state.aliens, 1, 0), state.aliens))
        alien_dir = torch.where(descend, -state.alien_dir, state.alien_dir)
        alien_move_timer = torch.where(move_now, state.alien_move_interval, state.alien_move_timer - 1)

        # alien fire: lowest alien of a uniformly random occupied column
        shoot_now = state.alien_shot_timer <= 0
        col_occ = aliens.any(dim=1)
        shoot_col = _pick(col_occ, d.column)
        col_cells = aliens[env, :, shoot_col]  # [N, 10] rows of that column
        shoot_row = SIZE - 1 - _first_true(col_cells.flip(-1))
        can_shoot = shoot_now & col_occ.any(dim=-1) & (shoot_row < SIZE - 1)
        e_bullets = e_bullets | (_one_hot_plane(shoot_col, shoot_row + 1) & can_shoot[:, None, None])
        alien_shot_timer = torch.where(shoot_now, self.ENEMY_SHOT_INTERVAL, state.alien_shot_timer - 1)

        # friendly bullet x alien collisions
        hits = f_bullets & aliens
        reward = hits.flatten(1).sum(dim=1).to(torch.float32)
        aliens = aliens & ~hits
        f_bullets = f_bullets & ~hits

        # terminal conditions
        shot_down = e_bullets[env, SIZE - 1, pos]
        invaded = aliens[:, SIZE - 1].any(dim=-1)
        terminated = shot_down | invaded

        # wave cleared: respawn faster block
        cleared = ~aliens.flatten(1).any(dim=1)
        ramp_index = state.ramp_index + cleared.to(torch.int32)
        new_interval = torch.clamp(self.INITIAL_MOVE_INTERVAL - ramp_index, min=2)
        aliens = torch.where(cleared[:, None, None], self._alien_block(n, dev), aliens)
        alien_move_interval = torch.where(cleared, new_interval, state.alien_move_interval)

        t = state.t + 1
        truncated = (t >= self.max_steps) & ~terminated
        new = SpaceInvadersState(
            pos=pos,
            aliens=aliens,
            alien_dir=alien_dir,
            alien_move_timer=alien_move_timer,
            alien_move_interval=alien_move_interval,
            alien_shot_timer=alien_shot_timer,
            f_bullets=f_bullets,
            e_bullets=e_bullets,
            shot_cooldown=shot_cooldown,
            ramp_index=ramp_index,
            last_action=action,
            t=t,
        )
        return new, StepResult(self._obs(new), reward, terminated, truncated)


# =====================================================================
# Freeway
# =====================================================================
class FreewayState(NamedTuple):
    player_y: torch.Tensor  # row; column fixed at 4
    car_x: torch.Tensor  # [N, 8] int positions, lanes = rows 1..8
    car_dir: torch.Tensor  # [N, 8] +-1
    car_interval: torch.Tensor  # [N, 8] steps between moves (speed)
    car_timer: torch.Tensor  # [N, 8]
    move_cooldown: torch.Tensor  # player move rate limit
    last_action: torch.Tensor
    t: torch.Tensor


class FreewayCars(NamedTuple):
    x: torch.Tensor  # [N, 8] int in [0, 10)
    right: torch.Tensor  # [N, 8] bool: the car drives right (+1)
    interval: torch.Tensor  # [N, 8] int in [1, 6)


class FreewayDraws(NamedTuple):
    sticky: torch.Tensor  # [N] uniform in [0, 1)
    cars: FreewayCars  # the new traffic, taken when the player scores


class Freeway(_StickyMixin, TorchEnv):
    """MinAtar Freeway: cross 8 lanes of traffic from bottom to top.

    Channels: 0=chicken, 1=car, 2=car direction (signed, scaled by speed).
    Actions: 0=noop, 1=up, 2=down (rate-limited to every 3rd frame).
    Reward +1 on reaching the top row (position resets, car speeds
    re-randomized); collision knocks the player back to the start.
    Episodes truncate on the time limit (2500 in MinAtar).
    """

    action_space = Discrete(3)
    observation_space = Box(low=-1.0, high=1.0, shape=(SIZE, SIZE, 3))
    PLAYER_COL = 4
    MOVE_COOLDOWN = 3
    N_LANES = 8

    def __init__(self, sticky_prob: float = 0.1, max_steps: int = 2500):
        self.sticky_prob = sticky_prob
        self.max_steps = max_steps

    def draw_cars(self, generator: torch.Generator, num_envs: int, device) -> FreewayCars:
        shape = (num_envs, self.N_LANES)
        return FreewayCars(torch.randint(0, SIZE, shape, generator=generator, device=device, dtype=torch.int32),
                           _uniform(generator, shape, device) < 0.5,
                           torch.randint(1, 6, shape, generator=generator, device=device, dtype=torch.int32))

    def draw(self, generator: torch.Generator, num_envs: int, device) -> FreewayDraws:
        return FreewayDraws(_uniform(generator, (num_envs,), device), self.draw_cars(generator, num_envs, device))

    @staticmethod
    def _cars(cars: FreewayCars) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(x, direction, interval)``, int32."""
        return (cars.x.to(torch.int32), torch.where(cars.right, 1, -1).to(torch.int32),
                cars.interval.to(torch.int32))

    def reset(self, generator, num_envs, device, cars: FreewayCars | None = None):
        """``cars``: the reset's traffic in place of a draw from
        ``generator``."""
        dev = torch.device(device)
        if cars is None:
            if generator is None:
                raise ValueError("Freeway resets with a generator (or injected cars)")
            cars = self.draw_cars(generator, num_envs, dev)
        car_x, car_dir, car_interval = self._cars(cars)
        z = _i32(num_envs, 0, dev)
        st = FreewayState(
            player_y=_i32(num_envs, SIZE - 1, dev),
            car_x=car_x,
            car_dir=car_dir,
            car_interval=car_interval,
            car_timer=car_interval.clone(),
            move_cooldown=z,
            last_action=z.clone(),
            t=z.clone(),
        )
        return st, self._obs(st)

    def _obs(self, s: FreewayState) -> torch.Tensor:
        chicken = _one_hot_plane(torch.full_like(s.player_y, self.PLAYER_COL), s.player_y)
        car = _lane_plane(s.car_x)
        speed = s.car_dir / torch.clamp(s.car_interval, min=1)  # float32
        dir_plane = torch.zeros(car.shape, dtype=torch.float32, device=car.device)
        dir_plane[:, 1:self.N_LANES + 1] = torch.where(car[:, 1:self.N_LANES + 1], speed[:, :, None], 0.0)
        return torch.stack([chicken.to(torch.float32), car.to(torch.float32), dir_plane], dim=-1)

    def step(self, state: FreewayState, action: torch.Tensor, generator=None, draws: FreewayDraws | None = None):
        n, dev = action.shape[0], action.device
        d = self._draws(draws, generator, n, dev)
        action = self._apply_sticky(None, action, state.last_action, d.sticky)

        can_move = state.move_cooldown == 0
        dy = _move(action, 1, 2)
        moved = can_move & (dy != 0)
        player_y = torch.clamp(state.player_y + torch.where(moved, dy, 0), 0, SIZE - 1)
        move_cooldown = torch.where(moved, self.MOVE_COOLDOWN, torch.clamp(state.move_cooldown - 1, min=0))

        # cars advance on their per-lane timers (wrap around)
        tick = state.car_timer <= 0
        car_x = torch.where(tick, (state.car_x + state.car_dir) % SIZE, state.car_x)
        car_timer = torch.where(tick, state.car_interval, state.car_timer - 1)

        # collision: a car occupies (lane row, player col) where the player is
        lanes = torch.arange(1, self.N_LANES + 1, device=dev)
        hit = ((car_x == self.PLAYER_COL) & (lanes[None, :] == player_y[:, None])).any(dim=-1)
        player_y = torch.where(hit, SIZE - 1, player_y)

        # success: reached top
        scored = player_y == 0
        reward = scored.to(torch.float32)
        player_y = torch.where(scored, SIZE - 1, player_y).to(torch.int32)
        nx, nd, ni = self._cars(d.cars)
        s2 = scored[:, None]
        car_x = torch.where(s2, nx, car_x)
        car_dir = torch.where(s2, nd, state.car_dir)
        car_interval = torch.where(s2, ni, state.car_interval)
        car_timer = torch.where(s2, ni, car_timer)

        t = state.t + 1
        truncated = t >= self.max_steps
        new = FreewayState(
            player_y=player_y,
            car_x=car_x.to(torch.int32),
            car_dir=car_dir,
            car_interval=car_interval,
            car_timer=car_timer.to(torch.int32),
            move_cooldown=move_cooldown.to(torch.int32),
            last_action=action,
            t=t,
        )
        return new, StepResult(self._obs(new), reward, torch.zeros_like(scored), truncated)


# =====================================================================
# Asterix
# =====================================================================
class AsterixState(NamedTuple):
    player_x: torch.Tensor
    player_y: torch.Tensor
    ent_exists: torch.Tensor  # [N, 8] bool, one entity slot per row 1..8
    ent_x: torch.Tensor  # [N, 8]
    ent_dir: torch.Tensor  # [N, 8] +-1
    ent_gold: torch.Tensor  # [N, 8] bool (gold=reward, otherwise enemy)
    spawn_timer: torch.Tensor
    move_timer: torch.Tensor
    move_interval: torch.Tensor
    ramp_timer: torch.Tensor
    last_action: torch.Tensor
    t: torch.Tensor


class AsterixDraws(NamedTuple):
    sticky: torch.Tensor  # [N] uniform in [0, 1)
    lane: torch.Tensor  # [N, 8] scores: the free lane with the largest takes the spawn
    left: torch.Tensor  # [N] bool: the spawn enters from the left
    gold: torch.Tensor  # [N] uniform: gold below 0.3


class Asterix(_StickyMixin, TorchEnv):
    """MinAtar Asterix: collect gold, dodge enemies sweeping across lanes.

    Channels: 0=player, 1=enemy, 2=gold.  Actions: 0=noop, 1=left,
    2=right, 3=up, 4=down.  Entities spawn on a timer at a random lane/side
    (30% gold); entity speed ramps up over time.  Touching gold gives +1,
    touching an enemy ends the episode.
    """

    action_space = Discrete(5)
    observation_space = Box(low=0.0, high=1.0, shape=(SIZE, SIZE, 3))
    N_LANES = 8
    SPAWN_INTERVAL = 10
    INIT_MOVE_INTERVAL = 5
    RAMP_INTERVAL = 100

    def __init__(self, sticky_prob: float = 0.1, max_steps: int = 1000):
        self.sticky_prob = sticky_prob
        self.max_steps = max_steps

    def draw(self, generator: torch.Generator, num_envs: int, device) -> AsterixDraws:
        return AsterixDraws(_uniform(generator, (num_envs,), device),
                            _uniform(generator, (num_envs, self.N_LANES), device),
                            _uniform(generator, (num_envs,), device) < 0.5,
                            _uniform(generator, (num_envs,), device))

    def reset(self, generator, num_envs, device):
        dev = torch.device(device)
        lanes = (num_envs, self.N_LANES)
        st = AsterixState(
            player_x=_i32(num_envs, SIZE // 2, dev),
            player_y=_i32(num_envs, SIZE // 2, dev),
            ent_exists=torch.zeros(lanes, dtype=torch.bool, device=dev),
            ent_x=torch.zeros(lanes, dtype=torch.int32, device=dev),
            ent_dir=torch.ones(lanes, dtype=torch.int32, device=dev),
            ent_gold=torch.zeros(lanes, dtype=torch.bool, device=dev),
            spawn_timer=_i32(num_envs, self.SPAWN_INTERVAL, dev),
            move_timer=_i32(num_envs, self.INIT_MOVE_INTERVAL, dev),
            move_interval=_i32(num_envs, self.INIT_MOVE_INTERVAL, dev),
            ramp_timer=_i32(num_envs, self.RAMP_INTERVAL, dev),
            last_action=_i32(num_envs, 0, dev),
            t=_i32(num_envs, 0, dev),
        )
        return st, self._obs(st)

    def _obs(self, s: AsterixState) -> torch.Tensor:
        player = _one_hot_plane(s.player_x, s.player_y)
        enemy = _lane_plane(s.ent_x, s.ent_exists & ~s.ent_gold)
        gold = _lane_plane(s.ent_x, s.ent_exists & s.ent_gold)
        return _grid(player, enemy, gold)

    def _collide(self, player_x, player_y, s_exists, s_x, s_gold):
        lanes = torch.arange(1, self.N_LANES + 1, device=s_x.device)
        touch = s_exists & (s_x == player_x[:, None]) & (lanes[None, :] == player_y[:, None])
        reward = (touch & s_gold).any(dim=-1).to(torch.float32)
        dead = (touch & ~s_gold).any(dim=-1)
        exists = s_exists & ~touch  # collected gold disappears
        return reward, dead, exists

    def step(self, state: AsterixState, action: torch.Tensor, generator=None, draws: AsterixDraws | None = None):
        n, dev = action.shape[0], action.device
        d = self._draws(draws, generator, n, dev)
        action = self._apply_sticky(None, action, state.last_action, d.sticky)

        px = torch.clamp(state.player_x + _move(action, 1, 2), 0, SIZE - 1)
        py = torch.clamp(state.player_y + _move(action, 3, 4), 1, SIZE - 2)

        # collision before entity movement (player stepped into an entity)
        r1, dead1, exists = self._collide(px, py, state.ent_exists, state.ent_x, state.ent_gold)

        # entities advance on the shared timer; leaving the grid despawns
        tick = (state.move_timer <= 0)[:, None]
        nx = state.ent_x + torch.where(tick, state.ent_dir, 0)
        out = (nx < 0) | (nx >= SIZE)
        exists = exists & ~(out & tick)
        ent_x = torch.clamp(nx, 0, SIZE - 1)
        move_timer = torch.where(tick[:, 0], state.move_interval, state.move_timer - 1)

        # collision after movement (entity stepped into the player)
        r2, dead2, exists = self._collide(px, py, exists, ent_x, state.ent_gold)

        # spawn: pick a random empty lane, random side, 30% gold
        spawn_now = state.spawn_timer <= 0
        slot = _pick(~exists, d.lane)
        do_spawn = spawn_now & (~exists).any(dim=-1)
        from_left = d.left
        is_gold = d.gold < 0.3
        exists = _set_slot(exists, slot, do_spawn, True)
        ent_x = _set_slot(ent_x, slot, do_spawn, torch.where(from_left, 0, SIZE - 1))
        ent_dir = _set_slot(state.ent_dir, slot, do_spawn, torch.where(from_left, 1, -1))
        ent_gold = _set_slot(state.ent_gold, slot, do_spawn, is_gold)
        spawn_timer = torch.where(spawn_now, self.SPAWN_INTERVAL, state.spawn_timer - 1)

        # difficulty ramp
        ramp_now = state.ramp_timer <= 0
        move_interval = torch.clamp(state.move_interval - ramp_now.to(torch.int32), min=1)
        ramp_timer = torch.where(ramp_now, self.RAMP_INTERVAL, state.ramp_timer - 1)

        reward = r1 + r2
        terminated = dead1 | dead2
        t = state.t + 1
        truncated = (t >= self.max_steps) & ~terminated
        new = AsterixState(
            player_x=px,
            player_y=py,
            ent_exists=exists,
            ent_x=ent_x,
            ent_dir=ent_dir,
            ent_gold=ent_gold,
            spawn_timer=spawn_timer,
            move_timer=move_timer,
            move_interval=move_interval,
            ramp_timer=ramp_timer,
            last_action=action,
            t=t,
        )
        return new, StepResult(self._obs(new), reward, terminated, truncated)


# =====================================================================
# Seaquest
# =====================================================================
class SeaquestState(NamedTuple):
    sub_x: torch.Tensor
    sub_y: torch.Tensor  # 0 = surface row; 1..8 water lanes
    sub_or: torch.Tensor  # +-1 facing (bullet direction)
    f_bul_l: torch.Tensor  # [N, 10, 10] bool friendly bullets moving left
    f_bul_r: torch.Tensor
    e_bul_l: torch.Tensor  # [N, 10, 10] bool enemy bullets
    e_bul_r: torch.Tensor
    en_exists: torch.Tensor  # [N, 8] enemy slots
    en_x: torch.Tensor
    en_y: torch.Tensor  # lane rows 1..8
    en_dir: torch.Tensor
    en_sub: torch.Tensor  # [N, 8] bool: enemy submarine (shoots) vs fish
    dv_exists: torch.Tensor  # [N, 4] diver slots
    dv_x: torch.Tensor
    dv_y: torch.Tensor
    dv_dir: torch.Tensor
    oxygen: torch.Tensor
    diver_count: torch.Tensor
    surfaced: torch.Tensor  # bool: already processed this surface visit
    shot_cd: torch.Tensor
    en_move_timer: torch.Tensor
    en_shot_timer: torch.Tensor
    en_spawn_timer: torch.Tensor
    en_spawn_interval: torch.Tensor  # ramps down on 6-diver surfacing
    dv_move_timer: torch.Tensor
    dv_spawn_timer: torch.Tensor
    last_action: torch.Tensor
    t: torch.Tensor


class SeaquestDraws(NamedTuple):
    sticky: torch.Tensor  # [N] uniform in [0, 1)
    slot: torch.Tensor  # [N, 8] scores: the free enemy slot with the largest takes the spawn
    lane: torch.Tensor  # [N] int in [1, 9)
    left: torch.Tensor  # [N] bool: the enemy enters from the left
    kind: torch.Tensor  # [N] uniform: a shooting submarine below 0.2, else a fish
    diver_slot: torch.Tensor  # [N, 4] scores, as ``slot`` for the divers
    diver_lane: torch.Tensor  # [N] int in [1, 9)
    diver_left: torch.Tensor  # [N] bool


class Seaquest(_StickyMixin, TorchEnv):
    """MinAtar Seaquest: pilot a submarine through 8 water lanes, shoot
    fish and enemy subs, rescue divers, and surface before oxygen runs
    out (Young & Tian 2019, the 5th game of the MinAtar suite).

    Mechanics (slot-based fixed shapes): rows 1..8 are water lanes, row 0
    the surface, row 9 the gauge row.  Enemies (20% shooting submarines,
    else fish) and divers spawn on timers at a random free slot/lane/side
    and sweep horizontally.  Firing (cooldown 5) launches a horizontal
    bullet in the facing direction; +1 per enemy destroyed.  Touching an
    enemy or an enemy bullet is terminal.  Oxygen (200) depletes every
    submerged frame; surfacing with no divers, or running dry, is terminal;
    surfacing with 6 divers banks ``oxygen*10//200`` reward, resets the
    divers and ramps enemy spawning; with 1-5 divers it silently drops one
    diver and refills oxygen.

    Channels: 0=sub, 1=sub trail (facing), 2=friendly bullet, 3=enemy
    bullet, 4=fish, 5=enemy sub, 6=diver, 7=oxygen gauge (row 9 left),
    8=diver gauge (row 9 right).  Actions (MinAtar order): 0=noop,
    1=left, 2=up, 3=right, 4=down, 5=fire.
    """

    action_space = Discrete(6)
    observation_space = Box(low=0.0, high=1.0, shape=(SIZE, SIZE, 9))
    MAX_OXYGEN = 200
    SHOT_COOLDOWN = 5
    ENEMY_SHOT_INTERVAL = 10
    ENEMY_MOVE_INTERVAL = 5
    DIVER_MOVE_INTERVAL = 5
    INIT_SPAWN_INTERVAL = 20
    MIN_SPAWN_INTERVAL = 10
    DIVER_SPAWN_INTERVAL = 30
    MAX_DIVERS = 6
    SUB_PROB = 0.2
    N_ENEMY = 8
    N_DIVER = 4

    def __init__(self, sticky_prob: float = 0.1, max_steps: int = 2500):
        self.sticky_prob = sticky_prob
        self.max_steps = max_steps

    def draw(self, generator: torch.Generator, num_envs: int, device) -> SeaquestDraws:
        def u(*shape):
            return _uniform(generator, (num_envs,) + shape, device)

        def lane():
            return torch.randint(1, 9, (num_envs,), generator=generator, device=device, dtype=torch.int32)

        return SeaquestDraws(u(), u(self.N_ENEMY), lane(), u() < 0.5, u(), u(self.N_DIVER), lane(), u() < 0.5)

    def reset(self, generator, num_envs, device):
        dev = torch.device(device)
        ne, nd = (num_envs, self.N_ENEMY), (num_envs, self.N_DIVER)

        def plane():
            return torch.zeros((num_envs, SIZE, SIZE), dtype=torch.bool, device=dev)

        st = SeaquestState(
            sub_x=_i32(num_envs, SIZE // 2, dev),
            sub_y=_i32(num_envs, 0, dev),
            sub_or=_i32(num_envs, 1, dev),
            f_bul_l=plane(),
            f_bul_r=plane(),
            e_bul_l=plane(),
            e_bul_r=plane(),
            en_exists=torch.zeros(ne, dtype=torch.bool, device=dev),
            en_x=torch.zeros(ne, dtype=torch.int32, device=dev),
            en_y=torch.ones(ne, dtype=torch.int32, device=dev),
            en_dir=torch.ones(ne, dtype=torch.int32, device=dev),
            en_sub=torch.zeros(ne, dtype=torch.bool, device=dev),
            dv_exists=torch.zeros(nd, dtype=torch.bool, device=dev),
            dv_x=torch.zeros(nd, dtype=torch.int32, device=dev),
            dv_y=torch.ones(nd, dtype=torch.int32, device=dev),
            dv_dir=torch.ones(nd, dtype=torch.int32, device=dev),
            oxygen=_i32(num_envs, self.MAX_OXYGEN, dev),
            diver_count=_i32(num_envs, 0, dev),
            surfaced=torch.ones((num_envs,), dtype=torch.bool, device=dev),  # starting on the surface row
            shot_cd=_i32(num_envs, 0, dev),
            en_move_timer=_i32(num_envs, self.ENEMY_MOVE_INTERVAL, dev),
            en_shot_timer=_i32(num_envs, self.ENEMY_SHOT_INTERVAL, dev),
            en_spawn_timer=_i32(num_envs, self.INIT_SPAWN_INTERVAL, dev),
            en_spawn_interval=_i32(num_envs, self.INIT_SPAWN_INTERVAL, dev),
            dv_move_timer=_i32(num_envs, self.DIVER_MOVE_INTERVAL, dev),
            dv_spawn_timer=_i32(num_envs, self.DIVER_SPAWN_INTERVAL, dev),
            last_action=_i32(num_envs, 0, dev),
            t=_i32(num_envs, 0, dev),
        )
        return st, self._obs(st)

    def _obs(self, s: SeaquestState) -> torch.Tensor:
        sub = _one_hot_plane(s.sub_x, s.sub_y)
        trail = _one_hot_plane(torch.clamp(s.sub_x - s.sub_or, 0, SIZE - 1), s.sub_y)
        f_bul = s.f_bul_l | s.f_bul_r
        e_bul = s.e_bul_l | s.e_bul_r
        fish = _slot_plane(s.en_exists & ~s.en_sub, s.en_x, s.en_y)
        esub = _slot_plane(s.en_exists & s.en_sub, s.en_x, s.en_y)
        diver = _slot_plane(s.dv_exists, s.dv_x, s.dv_y)
        # gauges live on row 9: oxygen fills left-to-right, divers
        # right-to-left (the MinAtar dashboard convention)
        cols = torch.arange(SIZE, device=s.sub_x.device)
        bottom = (torch.arange(SIZE, device=cols.device) == SIZE - 1)[None, :, None]
        ox_cells = (s.oxygen * SIZE) // self.MAX_OXYGEN
        ox_plane = bottom & (cols[None, :] < ox_cells[:, None])[:, None, :]
        dv_plane = bottom & (cols[None, :] >= SIZE - s.diver_count[:, None])[:, None, :]
        return _grid(sub, trail, f_bul, e_bul, fish, esub, diver, ox_plane, dv_plane)

    def step(self, state: SeaquestState, action: torch.Tensor, generator=None, draws: SeaquestDraws | None = None):
        n, dev = action.shape[0], action.device
        d = self._draws(draws, generator, n, dev)
        action = self._apply_sticky(None, action, state.last_action, d.sticky)

        # -- submarine move + facing (row 9 is the gauge row, y <= 8)
        dx = _move(action, 1, 3)
        dy = _move(action, 2, 4)
        sub_x = torch.clamp(state.sub_x + dx, 0, SIZE - 1)
        sub_y = torch.clamp(state.sub_y + dy, 0, SIZE - 2)
        sub_or = torch.where(dx != 0, torch.sign(dx), state.sub_or)

        # -- fire (rate-limited, horizontal, facing direction)
        fire = (action == 5) & (state.shot_cd == 0)
        at_sub = _one_hot_plane(sub_x, sub_y)
        f_bul_l = state.f_bul_l | (at_sub & (fire & (sub_or < 0))[:, None, None])
        f_bul_r = state.f_bul_r | (at_sub & (fire & (sub_or > 0))[:, None, None])
        shot_cd = torch.where(fire, self.SHOT_COOLDOWN, torch.clamp(state.shot_cd - 1, min=0))

        # -- bullets advance
        f_bul_l = _shift(f_bul_l, 0, -1)
        f_bul_r = _shift(f_bul_r, 0, 1)
        e_bul_l = _shift(state.e_bul_l, 0, -1)
        e_bul_r = _shift(state.e_bul_r, 0, 1)

        # -- enemies advance on the shared timer; off-grid despawns
        tick = (state.en_move_timer <= 0)[:, None]
        nx = state.en_x + torch.where(tick, state.en_dir, 0)
        out = (nx < 0) | (nx >= SIZE)
        en_exists = state.en_exists & ~(out & tick)
        en_x = torch.clamp(nx, 0, SIZE - 1)
        en_move_timer = torch.where(tick[:, 0], self.ENEMY_MOVE_INTERVAL, state.en_move_timer - 1)

        # -- friendly bullet hits (after both moved): +1 per enemy
        f_bul = f_bul_l | f_bul_r
        hit = en_exists & _cell(f_bul, state.en_y, en_x)
        reward = hit.sum(dim=-1).to(torch.float32)
        en_exists = en_exists & ~hit
        # consume the bullet cells that struck
        strike = _slot_plane(hit, en_x, state.en_y)
        f_bul_l = f_bul_l & ~strike
        f_bul_r = f_bul_r & ~strike

        # -- enemy subs fire on the shared timer (from their post-move cell)
        shoot = state.en_shot_timer <= 0
        subs = en_exists & state.en_sub & shoot[:, None]
        e_bul_l = e_bul_l | _slot_plane(subs & (state.en_dir < 0), en_x, state.en_y)
        e_bul_r = e_bul_r | _slot_plane(subs & (state.en_dir > 0), en_x, state.en_y)
        en_shot_timer = torch.where(shoot, self.ENEMY_SHOT_INTERVAL, state.en_shot_timer - 1)

        # -- enemy spawn: random free slot / lane / side, 20% shooting sub
        spawn = (state.en_spawn_timer <= 0) & (~en_exists).any(dim=-1)
        slot = _pick(~en_exists, d.slot)
        is_sub = d.kind < self.SUB_PROB
        en_exists = _set_slot(en_exists, slot, spawn, True)
        en_x = _set_slot(en_x, slot, spawn, torch.where(d.left, 0, SIZE - 1))
        en_y = _set_slot(state.en_y, slot, spawn, d.lane)
        en_dir = _set_slot(state.en_dir, slot, spawn, torch.where(d.left, 1, -1))
        en_sub = _set_slot(state.en_sub, slot, spawn, is_sub)
        en_spawn_timer = torch.where(state.en_spawn_timer <= 0, state.en_spawn_interval, state.en_spawn_timer - 1)

        # -- divers advance / spawn / get collected
        dtick = (state.dv_move_timer <= 0)[:, None]
        dnx = state.dv_x + torch.where(dtick, state.dv_dir, 0)
        dout = (dnx < 0) | (dnx >= SIZE)
        dv_exists = state.dv_exists & ~(dout & dtick)
        dv_x = torch.clamp(dnx, 0, SIZE - 1)
        dv_move_timer = torch.where(dtick[:, 0], self.DIVER_MOVE_INTERVAL, state.dv_move_timer - 1)
        dspawn = (state.dv_spawn_timer <= 0) & (~dv_exists).any(dim=-1)
        dslot = _pick(~dv_exists, d.diver_slot)
        dv_exists = _set_slot(dv_exists, dslot, dspawn, True)
        dv_x = _set_slot(dv_x, dslot, dspawn, torch.where(d.diver_left, 0, SIZE - 1))
        dv_y = _set_slot(state.dv_y, dslot, dspawn, d.diver_lane)
        dv_dir = _set_slot(state.dv_dir, dslot, dspawn, torch.where(d.diver_left, 1, -1))
        dv_spawn_timer = torch.where(state.dv_spawn_timer <= 0, self.DIVER_SPAWN_INTERVAL, state.dv_spawn_timer - 1)
        caught = dv_exists & (dv_x == sub_x[:, None]) & (dv_y == sub_y[:, None])
        # collect only as many as the gauge has room for (slot order);
        # divers beyond capacity stay on the board uncollected
        space_left = self.MAX_DIVERS - state.diver_count
        caught_i = caught.to(torch.int32)
        order = torch.cumsum(caught_i, dim=-1) - caught_i
        collect = caught & (order < space_left[:, None])
        diver_count = state.diver_count + collect.sum(dim=-1).to(torch.int32)
        dv_exists = dv_exists & ~collect

        # -- lethal contacts
        hit_enemy = (en_exists & (en_x == sub_x[:, None]) & (en_y == sub_y[:, None])).any(dim=-1)
        hit_bullet = _cell(e_bul_l | e_bul_r, sub_y, sub_x)

        # -- oxygen / surfacing
        submerged = sub_y > 0
        oxygen = torch.where(submerged, state.oxygen - 1, state.oxygen)
        out_of_air = oxygen < 0
        fresh_surface = ~submerged & ~state.surfaced
        drowned_crew = fresh_surface & (diver_count == 0)
        banked = fresh_surface & (diver_count == self.MAX_DIVERS)
        reward = reward + torch.where(banked, (oxygen * 10 // self.MAX_OXYGEN).to(torch.float32), 0.0)
        dropped = fresh_surface & ~banked & (diver_count > 0)
        diver_count = torch.where(banked, 0, diver_count - dropped.to(torch.int32))
        en_spawn_interval = torch.where(
            banked, torch.clamp(state.en_spawn_interval - 1, min=self.MIN_SPAWN_INTERVAL), state.en_spawn_interval)
        oxygen = torch.where(fresh_surface & (diver_count >= 0) & ~drowned_crew, self.MAX_OXYGEN, oxygen)
        surfaced = ~submerged

        terminated = hit_enemy | hit_bullet | out_of_air | drowned_crew
        t = state.t + 1
        truncated = (t >= self.max_steps) & ~terminated
        new = SeaquestState(
            sub_x=sub_x,
            sub_y=sub_y,
            sub_or=sub_or,
            f_bul_l=f_bul_l,
            f_bul_r=f_bul_r,
            e_bul_l=e_bul_l,
            e_bul_r=e_bul_r,
            en_exists=en_exists,
            en_x=en_x,
            en_y=en_y,
            en_dir=en_dir,
            en_sub=en_sub,
            dv_exists=dv_exists,
            dv_x=dv_x,
            dv_y=dv_y,
            dv_dir=dv_dir,
            oxygen=oxygen,
            diver_count=diver_count,
            surfaced=surfaced,
            shot_cd=shot_cd,
            en_move_timer=en_move_timer,
            en_shot_timer=en_shot_timer,
            en_spawn_timer=en_spawn_timer,
            en_spawn_interval=en_spawn_interval,
            dv_move_timer=dv_move_timer,
            dv_spawn_timer=dv_spawn_timer,
            last_action=action,
            t=t,
        )
        return new, StepResult(self._obs(new), reward, terminated, truncated)


_REGISTRY = {
    "breakout": Breakout,
    "space_invaders": SpaceInvaders,
    "freeway": Freeway,
    "asterix": Asterix,
    "seaquest": Seaquest,
}


def make_minatar(name: str, **kwargs) -> TorchEnv:
    """A MinAtar-style env by name (``MinAtar/Breakout`` also works)."""
    key = name.lower().removeprefix("minatar/").removeprefix("minatar-").replace("-", "_")
    if key not in _REGISTRY:
        raise ValueError(f"unknown MinAtar env {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)
