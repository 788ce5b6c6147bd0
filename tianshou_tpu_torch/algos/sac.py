"""SAC: squashed-Gaussian actor, twin critics, automatic entropy tuning
(port of ``SAC`` in ``tianshou_tpu/algos/sac.py``).

One :meth:`SAC.update_sampled` keeps the JAX package's order:

1. the target from the *current* actor's sampled next action and the
   minimum of the target critics, minus ``alpha * logp``;
2. the critic's Adam step (the ``|td|`` averaged over the critics is
   written back to a prioritized buffer);
3. the actor loss ``alpha * logp - min_k Q_k`` against the *updated* critic,
   with the alpha from before this update;
4. with ``auto_alpha``, the loss ``-log_alpha * (logp + target_entropy)`` on
   the actor loss's ``logp`` (``target_entropy`` defaults to ``-dim(A)``),
   stepped by its own Adam;
5. the Polyak update of the target critic, every update.

``log_alpha`` is a 0-d tensor on the device and is never read on the host.
Deterministic evaluation acts with ``tanh(mu)``.  The two normal draws of an
update (target, then actor) come from the trainer's ``generator``, or are
injected through ``noise`` for the parity tests.  ``DiscreteSAC`` comes
with the ensemble nets.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, polyak_update, write_back
from tianshou_tpu_torch.algos.ddpg import ACTrainState, adam, apply_loss, fresh_copy, frozen_copy
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Box
from tianshou_tpu_torch.ops.dist import standard_normal, tanh_normal_sample_and_log_prob
from tianshou_tpu_torch.ops.returns import nstep_return
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["SAC"]


class SAC(Algorithm):
    supports_presampled = True

    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Box,
        *,
        actor_lr: float = 1e-3,
        critic_lr: float = 1e-3,
        alpha: float = 0.2,
        auto_alpha: bool = True,
        alpha_lr: float = 3e-4,
        target_entropy: float | None = None,
        gamma: float = 0.99,
        tau: float = 0.005,
        n_step: int = 1,
        deterministic_eval: bool = True,
        device: str | torch.device = "cuda",
    ):
        """``actor`` (obs -> ``(mu, sigma)``) and ``critic`` (a
        ``CriticEnsemble``) are templates: :meth:`init` copies them onto
        ``device`` and draws their parameters."""
        self.actor = actor
        self.critic = critic
        self.action_space = action_space
        self.actor_lr = actor_lr
        self.critic_lr = critic_lr
        self.alpha_lr = alpha_lr
        self.fixed_alpha = alpha
        self.auto_alpha = auto_alpha
        self.target_entropy = target_entropy if target_entropy is not None else -float(action_space.shape[0])
        self.gamma = gamma
        self.tau = tau
        self.n_step = n_step
        self.deterministic_eval = deterministic_eval
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> ACTrainState:
        actor = fresh_copy(self.actor, self.device, generator)
        critic = fresh_copy(self.critic, self.device, generator)
        # a fill on the device, not a copy from the host
        log_alpha = torch.full((), math.log(self.fixed_alpha), device=self.device, requires_grad=self.auto_alpha)
        return ACTrainState(
            actor=actor,
            critic=critic,
            target_actor=None,
            target_critic=frozen_copy(critic),
            actor_optimizer=adam(actor.parameters(), self.actor_lr),
            critic_optimizer=adam(critic.parameters(), self.critic_lr),
            log_alpha=log_alpha,
            alpha_optimizer=adam([log_alpha], self.alpha_lr) if self.auto_alpha else None,
        )

    def act_params(self, ts: ACTrainState) -> nn.Module:
        return ts.actor

    def with_act_params(self, ts: ACTrainState, module: nn.Module) -> ACTrainState:
        return dataclasses.replace(ts, actor=module)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        mu, sigma = ts.actor(obs)
        if not explore and self.deterministic_eval:
            return torch.tanh(mu)
        a, _ = tanh_normal_sample_and_log_prob(mu, sigma, standard_normal(generator, mu))
        return a

    def update_sampled(
        self,
        ts: ACTrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
        noise: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> tuple[ACTrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``noise``: the ``(target, actor)`` pair of ``[B, action_dim]``
        standard normal draws, in place of two from ``generator``."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        if noise is None:
            shape = weight.shape + tuple(self.action_space.shape)
            noise = tuple(
                torch.randn(shape, generator=generator, device=weight.device) for _ in range(2))
        eps_target, eps_actor = noise
        mask = 1.0 - term["terminated"].to(torch.float32)
        alpha = ts.log_alpha.detach().exp()

        with torch.no_grad():
            obs_next = term["obs_next"]
            a_next, logp_next = tanh_normal_sample_and_log_prob(*ts.actor(obs_next), eps_target)
            q_next = torch.amin(ts.target_critic(obs_next, a_next), dim=0)
            target = nstep_return(rew_chain, done_chain, (q_next - alpha * logp_next) * mask, self.gamma)
        td = ts.critic(batch["obs"], batch["act"]) - target[None, :]
        critic_loss = (weight[None, :] * td.pow(2)).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td.detach().abs().mean(dim=0))
        apply_loss(ts.critic_optimizer, critic_loss)

        obs = batch["obs"]
        a, logp = tanh_normal_sample_and_log_prob(*ts.actor(obs), eps_actor)
        actor_loss = (alpha * logp - torch.amin(ts.critic(obs, a), dim=0)).mean()
        apply_loss(ts.actor_optimizer, actor_loss)

        if self.auto_alpha:
            alpha_loss = -(ts.log_alpha * (logp.detach() + self.target_entropy)).mean()
            apply_loss(ts.alpha_optimizer, alpha_loss)
            alpha_loss = alpha_loss.detach()
        else:
            alpha_loss = torch.zeros((), device=self.device)
        polyak_update(ts.target_critic, ts.critic, self.tau)
        ts.step += 1
        return ts, bstate, {
            "critic_loss": critic_loss.detach(),
            "actor_loss": actor_loss.detach(),
            "alpha": ts.log_alpha.detach().exp(),
            "alpha_loss": alpha_loss,
        }
