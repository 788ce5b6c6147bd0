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

REDQ (``algos/redq.py``) reuses steps 1-4 with its own reductions over the
critics.

``log_alpha`` is a 0-d tensor on the device and is never read on the host.
Deterministic evaluation acts with ``tanh(mu)``.  The two normal draws of an
update (target, then actor) come from the trainer's ``generator``, or are
injected through ``noise`` for the parity tests.  :class:`DiscreteSAC`
takes the same steps with expectations under a categorical policy in place
of the sampled actions.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, polyak_update, write_back
from tianshou_tpu_torch.algos.ddpg import ACTrainState, adam, apply_loss, fresh_copy, frozen_copy
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.ops.dist import (
    categorical_sample,
    standard_gumbel,
    standard_normal,
    tanh_normal_sample_and_log_prob,
)
from tianshou_tpu_torch.ops.returns import nstep_return
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["SAC", "DiscreteSAC"]


def _min_over_critics(q: torch.Tensor) -> torch.Tensor:
    """The minimum over the leading critic axis of ``[K, ...]`` values."""
    return torch.amin(q, dim=0)


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

    def _noise(self, generator, weight, noise):
        """The ``(target, actor)`` standard normal pair of an update:
        ``noise`` if given, else two ``[B, action_dim]`` draws from
        ``generator``."""
        if noise is not None:
            return noise
        shape = weight.shape + tuple(self.action_space.shape)
        return tuple(torch.randn(shape, generator=generator, device=weight.device) for _ in range(2))

    def _critic_step(self, ts, buffer, bstate, sampled, eps_target, alpha, reduce_next):
        """Steps 1 and 2: the target from the current actor's sampled next
        action and ``reduce_next`` over the target critics' ``[K, B]``
        values, then the critic's Adam step.  Returns ``(critic_loss,
        bstate)``."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        mask = 1.0 - term["terminated"].to(torch.float32)
        with torch.no_grad():
            obs_next = term["obs_next"]
            a_next, logp_next = tanh_normal_sample_and_log_prob(*ts.actor(obs_next), eps_target)
            q_next = reduce_next(ts.target_critic(obs_next, a_next))
            target = nstep_return(rew_chain, done_chain, (q_next - alpha * logp_next) * mask, self.gamma)
        td = ts.critic(batch["obs"], batch["act"]) - target[None, :]
        critic_loss = (weight[None, :] * td.pow(2)).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td.detach().abs().mean(dim=0))
        apply_loss(ts.critic_optimizer, critic_loss)
        return critic_loss.detach(), bstate

    def _actor_step(self, ts, obs, eps_actor, alpha, reduce_q):
        """Steps 3 and 4: the actor's loss against the updated critics'
        values reduced by ``reduce_q``, then with ``auto_alpha`` the alpha
        loss.  Returns ``(actor_loss, alpha_loss)``."""
        a, logp = tanh_normal_sample_and_log_prob(*ts.actor(obs), eps_actor)
        actor_loss = (alpha * logp - reduce_q(ts.critic(obs, a))).mean()
        apply_loss(ts.actor_optimizer, actor_loss)
        return actor_loss.detach(), self._alpha_step(ts, logp.detach() + self.target_entropy, -1.0)

    def _alpha_step(self, ts, gap: torch.Tensor, sign: float) -> torch.Tensor:
        """With ``auto_alpha``, the Adam step on ``sign * log_alpha * gap``
        (SAC: ``-log_alpha * (logp + target_entropy)``; DiscreteSAC:
        ``log_alpha * (entropy - target_entropy)``): the loss, else 0."""
        if not self.auto_alpha:
            return torch.zeros((), device=self.device)
        alpha_loss = sign * (ts.log_alpha * gap).mean()
        apply_loss(ts.alpha_optimizer, alpha_loss)
        return alpha_loss.detach()

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
        eps_target, eps_actor = self._noise(generator, sampled[2], noise)
        alpha = ts.log_alpha.detach().exp()
        critic_loss, bstate = self._critic_step(ts, buffer, bstate, sampled, eps_target, alpha, _min_over_critics)
        actor_loss, alpha_loss = self._actor_step(ts, sampled[3]["obs"], eps_actor, alpha, _min_over_critics)
        polyak_update(ts.target_critic, ts.critic, self.tau)
        ts.step += 1
        return ts, bstate, {
            "critic_loss": critic_loss,
            "actor_loss": actor_loss,
            "alpha": ts.log_alpha.detach().exp(),
            "alpha_loss": alpha_loss,
        }


class DiscreteSAC(SAC):
    """SAC over a categorical policy: the actor maps observations to
    logits, the critic is a ``QNetEnsemble`` (``obs -> [K, B, A]``), and
    the targets are expectations under the policy, so an update draws
    nothing.  ``target_entropy`` defaults to ``0.98 * log(A)``.  Greedy
    acting takes the argmax of the logits, exploring samples them."""

    def __init__(self, actor: nn.Module, critic: nn.Module, action_space: Discrete, *, alpha: float = 0.05,
                 target_entropy: float | None = None, **kwargs):
        if target_entropy is None:
            target_entropy = 0.98 * math.log(action_space.n)
        super().__init__(actor, critic, action_space, alpha=alpha, target_entropy=target_entropy, **kwargs)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        logits = ts.actor(obs)
        if not explore:
            return logits.argmax(dim=-1)
        return categorical_sample(logits, standard_gumbel(generator, logits))

    def update_sampled(
        self,
        ts: ACTrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[ACTrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``generator`` is unused: the update draws nothing."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        mask = 1.0 - term["terminated"].to(torch.float32)
        alpha = ts.log_alpha.detach().exp()
        with torch.no_grad():
            logits_next = ts.actor(term["obs_next"])
            pi_next, logpi_next = F.softmax(logits_next, dim=-1), F.log_softmax(logits_next, dim=-1)
            q_next = torch.amin(ts.target_critic(term["obs_next"]), dim=0)
            v_next = (pi_next * (q_next - alpha * logpi_next)).sum(dim=-1)
            target = nstep_return(rew_chain, done_chain, v_next * mask, self.gamma)
        act = batch["act"].to(torch.int64)
        q_all = ts.critic(batch["obs"])  # [K, B, A]
        q = q_all.gather(-1, act[None, :, None].expand(q_all.shape[0], -1, 1)).squeeze(-1)
        td = q - target[None, :]
        critic_loss = (weight[None, :] * td.pow(2)).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td.detach().abs().mean(dim=0))
        apply_loss(ts.critic_optimizer, critic_loss)

        logits = ts.actor(batch["obs"])
        pi, logpi = F.softmax(logits, dim=-1), F.log_softmax(logits, dim=-1)
        with torch.no_grad():
            q = torch.amin(ts.critic(batch["obs"]), dim=0)
        entropy = -(pi * logpi).sum(dim=-1)
        actor_loss = -((pi * q).sum(dim=-1) + alpha * entropy).mean()
        apply_loss(ts.actor_optimizer, actor_loss)
        alpha_loss = self._alpha_step(ts, entropy.detach() - self.target_entropy, 1.0)
        polyak_update(ts.target_critic, ts.critic, self.tau)
        ts.step += 1
        return ts, bstate, {
            "critic_loss": critic_loss.detach(),
            "actor_loss": actor_loss.detach(),
            "alpha": ts.log_alpha.detach().exp(),
            "alpha_loss": alpha_loss,
        }
