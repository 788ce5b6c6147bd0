"""DQN with double-Q and n-step targets (port of ``tianshou_tpu/algos/dqn.py``).

One :meth:`DQN.update_sampled` is the JAX package's fused update: the
bootstrap at the n-step terminal states (double-Q unless
``is_double=False``), :func:`nstep_return`, a weighted MSE or Huber loss,
an Adam step, and the periodic target copy when
``step % target_update_freq == 0`` (steps counted from 1).
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is the counterpart of
``optax.adam(lr)``, and ``F.huber_loss(delta=1)`` of ``optax.huber_loss``.
The update writes ``|td|`` back to a prioritized buffer.

Observations may be dicts ``{"obs": ..., "mask": [B, A]}``: the network
reads ``obs``, illegal actions get Q = -1e9, and exploration draws
uniformly over the legal actions.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, TrainState, uniform_legal_action, write_back
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.ops.returns import nstep_return
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["DQN", "optimizer_step", "take_action"]


def optimizer_step(ts: TrainState, loss: torch.Tensor, target_update_freq: int = 0) -> None:
    """The optimizer step on ``loss``, ``step += 1``, and the target copy
    when ``target_update_freq > 0`` and ``step % target_update_freq == 0``."""
    ts.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    ts.optimizer.step()
    ts.step += 1
    if target_update_freq > 0 and ts.step % target_update_freq == 0:
        ts.target.load_state_dict(ts.online.state_dict())


def take_action(values: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """``values [B, A, ...]`` at each row's action: ``[B, ...]``."""
    return values[torch.arange(values.shape[0], device=values.device), act.to(torch.int64)]


class DQN(Algorithm):
    supports_presampled = True

    def __init__(
        self,
        network: nn.Module,
        action_space: Discrete,
        lr: float = 1e-3,
        gamma: float = 0.99,
        n_step: int = 1,
        target_update_freq: int = 0,
        is_double: bool = True,
        huber: bool = False,
        device: str | torch.device = "cuda",
    ):
        """``network`` is a template: :meth:`init` copies it onto
        ``device`` and draws its parameters."""
        self.network = network
        self.action_space = action_space
        self.lr = lr
        self.gamma = gamma
        self.n_step = n_step
        self.target_update_freq = target_update_freq
        self.is_double = is_double
        self.huber = huber
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> TrainState:
        """Fresh parameters drawn from ``generator`` (on :attr:`device`)."""
        online = copy.deepcopy(self.network).to(self.device)
        online.reset_parameters(generator)
        if self.target_update_freq > 0:
            target = copy.deepcopy(online).requires_grad_(False)
        else:
            target = online
        optimizer = torch.optim.Adam(
            online.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8
        )
        return TrainState(online=online, target=target, optimizer=optimizer)

    @property
    def obs_dtype(self) -> torch.dtype:
        return self.network.input_dtype

    @staticmethod
    def _action_mask(obs) -> torch.Tensor | None:
        if isinstance(obs, dict) and "mask" in obs:
            return obs["mask"].to(torch.bool)
        return None

    def q_values(self, net: nn.Module, obs) -> torch.Tensor:
        """``net``'s Q-values, -1e9 on illegal actions under a mask."""
        q = net(obs["obs"] if isinstance(obs, dict) and "obs" in obs else obs)
        mask = self._action_mask(obs)
        return q if mask is None else torch.where(mask, q, -1e9)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        q = self.q_values(ts.online, obs)
        greedy = q.argmax(dim=-1)
        if not explore:
            return greedy
        return self._epsilon_greedy(greedy, generator, explore_param, self._action_mask(obs))

    def _epsilon_greedy(self, greedy, generator, explore_param, mask=None) -> torch.Tensor:
        """``greedy`` with each action replaced, with probability
        ``explore_param``, by a uniform one (over the legal actions under
        ``mask``)."""
        if mask is None:
            rand = torch.randint(
                0, self.action_space.n, greedy.shape, generator=generator, device=greedy.device
            )
        else:
            rand = uniform_legal_action(mask, generator)
        take_rand = torch.rand(greedy.shape, generator=generator, device=greedy.device) < explore_param
        return torch.where(take_rand, rand, greedy)

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next, value_mask: torch.Tensor) -> torch.Tensor:
        """Masked bootstrap value at the n-step terminal states; with
        ``is_double`` the online network chooses the action."""
        q_t = self.q_values(ts.target, obs_next)
        if self.is_double:
            a_star = self.q_values(ts.online, obs_next).argmax(dim=-1, keepdim=True)
            q = q_t.gather(-1, a_star).squeeze(-1)
        else:
            q = q_t.max(dim=-1).values
        return q * value_mask

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``generator`` is unused: the DQN update draws nothing."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        # bootstrap unless terminated
        mask = 1.0 - term["terminated"].to(torch.float32)
        q_term = self._target_q(ts, term["obs_next"], mask)
        target = nstep_return(rew_chain, done_chain, q_term, self.gamma)

        q = self.q_values(ts.online, batch["obs"])
        q = q.gather(-1, batch["act"].to(torch.int64)[:, None]).squeeze(-1)
        td = q - target
        if self.huber:
            loss = (weight * F.huber_loss(q, target, reduction="none", delta=1.0)).mean()
        else:
            loss = (weight * td.pow(2)).mean()
        td_abs = td.detach().abs()
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach(), "td_abs_mean": td_abs.mean()}

    def _finish_update(self, ts: TrainState, loss: torch.Tensor) -> None:
        optimizer_step(ts, loss, self.target_update_freq)
