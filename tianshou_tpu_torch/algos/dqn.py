"""DQN with double-Q and n-step targets (port of ``tianshou_tpu/algos/dqn.py``).

One :meth:`DQN.update_sampled` is the JAX package's fused update: the
double-Q bootstrap at the n-step terminal states, :func:`nstep_return`, a
weighted MSE loss, an Adam step, and the periodic target copy when
``step % target_update_freq == 0`` (steps counted from 1).
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is the counterpart of
``optax.adam(lr)``.

Not ported yet: the Huber loss, ``is_double=False`` and action masks.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.ops.returns import nstep_return
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["DQN"]


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

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        greedy = ts.online(obs).argmax(dim=-1)
        if not explore:
            return greedy
        rand = torch.randint(
            0, self.action_space.n, greedy.shape, generator=generator, device=greedy.device
        )
        take_rand = torch.rand(greedy.shape, generator=generator, device=greedy.device) < explore_param
        return torch.where(take_rand, rand, greedy)

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: torch.Tensor, value_mask: torch.Tensor) -> torch.Tensor:
        """Masked bootstrap value at the n-step terminal states, with the
        action chosen by the online network (double DQN)."""
        q_t = ts.target(obs_next)
        a_star = ts.online(obs_next).argmax(dim=-1, keepdim=True)
        return q_t.gather(-1, a_star).squeeze(-1) * value_mask

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        # bootstrap unless terminated
        mask = 1.0 - term["terminated"].to(torch.float32)
        q_term = self._target_q(ts, term["obs_next"], mask)
        target = nstep_return(rew_chain, done_chain, q_term, self.gamma)

        q = ts.online(batch["obs"]).gather(-1, batch["act"].to(torch.int64)[:, None]).squeeze(-1)
        td = q - target
        loss = (weight * td.pow(2)).mean()
        ts.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ts.optimizer.step()
        ts.step += 1
        if self.target_update_freq > 0 and ts.step % self.target_update_freq == 0:
            ts.target.load_state_dict(ts.online.state_dict())
        return ts, bstate, {"loss": loss.detach(), "td_abs_mean": td.detach().abs().mean()}
