"""MinAtar-style pixel environments (port of the Breakout game of
``tianshou_tpu/envs/minatar.py``).

10x10 multi-channel binary grids after the MinAtar benchmark (Young & Tian,
2019, arXiv 1903.03176), written for a whole batch of games at once.
Observations are ``[num_envs, 10, 10, C]`` float32 one-hot entity planes.
Like MinAtar, each game has *sticky actions*: with probability
``sticky_prob`` (default 0.1) the previous action replaces the agent's.
Episodes also truncate at ``max_steps``.

The sticky draw comes from the generator that :meth:`step` is given (the
collector's stream); the JAX package splits a key kept in the env state.

Ported: Breakout.  SpaceInvaders, Freeway, Asterix and Seaquest draw random
spawns on every step and wait for a later slice (see ``ROADMAP.md``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.envs.base import StepResult, TorchEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = ["Breakout", "BreakoutState", "make_minatar"]

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
        self, generator: torch.Generator | None, action: torch.Tensor, last_action: torch.Tensor
    ) -> torch.Tensor:
        action = action.to(torch.int32)
        if self.sticky_prob <= 0.0:
            return action
        if generator is None:
            raise ValueError(f"{type(self).__name__} with sticky_prob > 0 steps with a generator")
        stick = torch.rand(action.shape, generator=generator, device=action.device) < self.sticky_prob
        return torch.where(stick, last_action, action)


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


_REGISTRY = {"breakout": Breakout}
_NOT_PORTED = ("space_invaders", "freeway", "asterix", "seaquest")


def make_minatar(name: str, **kwargs) -> TorchEnv:
    """A MinAtar-style env by name (``MinAtar/Breakout`` also works)."""
    key = name.lower().removeprefix("minatar/").removeprefix("minatar-").replace("-", "_")
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"MinAtar {key!r} is not ported yet: its random spawns wait for a later slice (ROADMAP.md)"
        )
    if key not in _REGISTRY:
        raise ValueError(f"unknown MinAtar env {name!r}; have {sorted(_REGISTRY) + list(_NOT_PORTED)}")
    return _REGISTRY[key](**kwargs)
