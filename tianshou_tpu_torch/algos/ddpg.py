"""DDPG and TD3: deterministic actor-critic with target networks (port of
``tianshou_tpu/algos/ddpg.py``).

The critic is a :class:`~tianshou_tpu_torch.networks.continuous.CriticEnsemble`
(``(obs, act) -> [K, B]``); the bootstrap takes the minimum over its K
critics, the actor loss reads critic 0 only.  One :meth:`DDPG.update_sampled`
is the JAX package's fused update:

1. the n-step target from the target actor and the target critics;
2. the critic's Adam step on the weighted squared TD error, ``step += 1``;
3. the actor's Adam step against the *updated* critic, then the Polyak
   update of both targets toward the updated actor and critic.

TD3 adds target smoothing (clipped Gaussian noise on the target action) and
runs step 3 only when ``step % update_actor_freq == 0``; ``step`` counts on
the host, so the schedule needs no device read.  Exploration adds
``explore_param * N(0, 1)`` to the action and clips it to ``[-1, 1]``.

Noise comes from the ``generator`` the trainer passes to each update, or,
for the parity tests, is injected through ``noise`` (the JAX package's own
draws).  ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)`` is the
counterpart of ``optax.adam(lr)``.  The update writes the ``|td|`` averaged
over the critics back to a prioritized buffer.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, polyak_update, write_back
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Box
from tianshou_tpu_torch.ops.dist import standard_normal
from tianshou_tpu_torch.ops.returns import nstep_return
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["ACTrainState", "DDPG", "TD3", "adam", "apply_loss"]


@dataclasses.dataclass
class ACTrainState:
    """Actor-critic state.  ``target_actor`` is ``None`` for SAC, whose
    target comes from the online actor; ``log_alpha`` (a 0-d tensor) and its
    optimizer are SAC's.  ``step`` counts updates on the host."""

    actor: nn.Module
    critic: nn.Module
    target_actor: nn.Module | None
    target_critic: nn.Module
    actor_optimizer: torch.optim.Optimizer
    critic_optimizer: torch.optim.Optimizer
    step: int = 0
    log_alpha: torch.Tensor | None = None
    alpha_optimizer: torch.optim.Optimizer | None = None


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``'s counterpart."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def apply_loss(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    """One optimizer step on ``loss``'s gradient with respect to the
    optimizer's own parameters only (an actor loss through the critic
    computes no gradient for the critic)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    optimizer.step()


def fresh_copy(template: nn.Module, device: torch.device, generator: torch.Generator) -> nn.Module:
    """``template`` copied onto ``device`` with parameters drawn from
    ``generator``."""
    module = copy.deepcopy(template).to(device)
    module.reset_parameters(generator)
    return module


def frozen_copy(module: nn.Module) -> nn.Module:
    return copy.deepcopy(module).requires_grad_(False)


class DDPG(Algorithm):
    supports_presampled = True

    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Box,
        *,
        actor_lr: float = 1e-3,
        critic_lr: float = 1e-3,
        gamma: float = 0.99,
        tau: float = 0.005,
        n_step: int = 1,
        exploration_noise: float = 0.1,
        device: str | torch.device = "cuda",
    ):
        """``actor`` and ``critic`` are templates: :meth:`init` copies them
        onto ``device`` and draws their parameters."""
        self.actor = actor
        self.critic = critic
        self.action_space = action_space
        self.actor_lr = actor_lr
        self.critic_lr = critic_lr
        self.gamma = gamma
        self.tau = tau
        self.n_step = n_step
        self.exploration_noise = exploration_noise
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> ACTrainState:
        actor = fresh_copy(self.actor, self.device, generator)
        critic = fresh_copy(self.critic, self.device, generator)
        return ACTrainState(
            actor=actor,
            critic=critic,
            target_actor=frozen_copy(actor),
            target_critic=frozen_copy(critic),
            actor_optimizer=adam(actor.parameters(), self.actor_lr),
            critic_optimizer=adam(critic.parameters(), self.critic_lr),
        )

    def act_params(self, ts: ACTrainState) -> nn.Module:
        return ts.actor

    def with_act_params(self, ts: ACTrainState, module: nn.Module) -> ACTrainState:
        return dataclasses.replace(ts, actor=module)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=None):
        """``explore_param`` is the noise scale (``None``: the algorithm's
        ``exploration_noise``)."""
        a = ts.actor(obs)
        if explore:
            sigma = self.exploration_noise if explore_param is None else explore_param
            a = torch.clamp(a + sigma * standard_normal(generator, a), -1.0, 1.0)
        return a

    def _target_action(self, ts: ACTrainState, obs_next, generator, noise):
        return ts.target_actor(obs_next)

    def _target_q(self, ts: ACTrainState, obs_next, value_mask, generator, noise) -> torch.Tensor:
        a_next = self._target_action(ts, obs_next, generator, noise)
        return torch.amin(ts.target_critic(obs_next, a_next), dim=0) * value_mask

    def _actor_loss(self, ts: ACTrainState, batch) -> torch.Tensor:
        """``-Q_0(s, pi(s))`` averaged over the batch (TD3+BC adds its
        behaviour-cloning term here)."""
        obs = batch["obs"]
        return -ts.critic(obs, ts.actor(obs))[0].mean()

    def _update_actor(self, ts: ACTrainState, batch) -> torch.Tensor:
        loss = self._actor_loss(ts, batch)
        apply_loss(ts.actor_optimizer, loss)
        polyak_update(ts.target_actor, ts.actor, self.tau)
        polyak_update(ts.target_critic, ts.critic, self.tau)
        return loss.detach()

    def _maybe_update_actor(self, ts: ACTrainState, batch) -> torch.Tensor:
        return self._update_actor(ts, batch)

    def update_sampled(
        self,
        ts: ACTrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> tuple[ACTrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``noise``: TD3's ``[B, action_dim]`` standard normal draw for the
        target smoothing, in place of one from ``generator``."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        mask = 1.0 - term["terminated"].to(torch.float32)
        with torch.no_grad():
            q_term = self._target_q(ts, term["obs_next"], mask, generator, noise)
            target = nstep_return(rew_chain, done_chain, q_term, self.gamma)
        td = ts.critic(batch["obs"], batch["act"]) - target[None, :]
        critic_loss = (weight[None, :] * td.pow(2)).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td.detach().abs().mean(dim=0))
        apply_loss(ts.critic_optimizer, critic_loss)
        ts.step += 1
        actor_loss = self._maybe_update_actor(ts, batch)
        return ts, bstate, {"critic_loss": critic_loss.detach(), "actor_loss": actor_loss}


class TD3(DDPG):
    """DDPG with twin critics, target policy smoothing and a delayed actor."""

    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Box,
        *,
        policy_noise: float = 0.2,
        noise_clip: float = 0.5,
        update_actor_freq: int = 2,
        **kwargs,
    ):
        super().__init__(actor, critic, action_space, **kwargs)
        self.policy_noise = policy_noise
        self.noise_clip = noise_clip
        self.update_actor_freq = update_actor_freq

    def _target_action(self, ts, obs_next, generator, noise):
        a = ts.target_actor(obs_next)
        eps = standard_normal(generator, a) if noise is None else noise
        smoothing = torch.clamp(self.policy_noise * eps, -self.noise_clip, self.noise_clip)
        return torch.clamp(a + smoothing, -1.0, 1.0)

    def _maybe_update_actor(self, ts: ACTrainState, batch) -> torch.Tensor:
        if ts.step % self.update_actor_freq == 0:
            return self._update_actor(ts, batch)
        return torch.zeros((), device=self.device)
