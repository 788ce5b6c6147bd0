"""Tic-tac-toe: a batched on-device turn-based two-player env (port of
``tianshou_tpu/envs/tictactoe.py``).

Observations follow the AEC convention, a dict ``{obs: [N, 19] features
(the mover's marks, the opponent's, whose turn), mask: [N, 9] legal
actions, agent_id: [N] the player to move}``, and rewards are per-agent
vectors ``[N, 2]``: +1 / -1 to the winner / loser, and -1 to a player who
plays an occupied square, which ends the game.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.envs.base import StepResult, TorchEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = ["TicTacToe", "TTTState"]

# the 8 winning lines: rows, columns, diagonals
_LINES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7), (2, 5, 8), (0, 4, 8), (2, 4, 6))


@functools.cache
def _lines(device: torch.device) -> torch.Tensor:
    """The ``[8, 3]`` line table on ``device``, made once (a copy at each
    step would make the host wait).  Callers must not write to it."""
    return torch.tensor(_LINES, device=device)


class TTTState(NamedTuple):
    board: torch.Tensor  # [N, 9] int64: 0 empty, 1 player 0, 2 player 1
    player: torch.Tensor  # [N] int64: whose turn
    t: torch.Tensor  # [N] int64


class TicTacToe(TorchEnv):
    """Two-player alternating tic-tac-toe with action masks."""

    num_agents = 2
    observation_space = Box(low=0.0, high=1.0, shape=(19,))
    action_space = Discrete(9)

    def reset(self, generator, num_envs, device):
        zeros = torch.zeros((num_envs,), dtype=torch.int64, device=device)
        state = TTTState(board=torch.zeros((num_envs, 9), dtype=torch.int64, device=device), player=zeros, t=zeros)
        return state, self._obs(state)

    @staticmethod
    def _obs(s: TTTState) -> Batch:
        mine = (s.board == (s.player + 1)[:, None]).to(torch.float32)
        theirs = (s.board == (2 - s.player)[:, None]).to(torch.float32)
        feats = torch.cat([mine, theirs, s.player.to(torch.float32)[:, None]], dim=1)
        return Batch(obs=feats, mask=(s.board == 0).to(torch.float32), agent_id=s.player)

    def step(self, state: TTTState, action: torch.Tensor, generator=None):
        action = action.to(torch.int64)
        mark = state.player + 1
        at = state.board.gather(1, action[:, None]).squeeze(1)
        legal = at == 0
        board = state.board.scatter(1, action[:, None], torch.where(legal, mark, at)[:, None])
        won = (board[:, _lines(board.device)] == mark[:, None, None]).all(-1).any(-1)
        full = (board != 0).all(-1)
        terminated = won | full | ~legal  # an illegal move loses at once
        mover = torch.where(won, 1.0, torch.where(legal, 0.0, -1.0))
        reward = torch.where((state.player == 0)[:, None], torch.stack([mover, -mover], -1),
                             torch.stack([-mover, mover], -1))
        new = TTTState(board=board, player=1 - state.player, t=state.t + 1)
        return new, StepResult(obs=self._obs(new), reward=reward, terminated=terminated,
                               truncated=torch.zeros_like(terminated))
