"""Offline RL: BC, TD3+BC, BCQ, CQL (with CQL(Lagrange) and CalQL) and the
discrete family DiscreteBCQ, DiscreteCQL and DiscreteCRR (port of
``tianshou_tpu/algos/offline.py``).

Each learns from a static buffer through the same ``update`` as the
off-policy algorithms, so the offline trainer is updates without
collection.  TD3BC changes TD3's actor loss only and keeps TD3's presampled
update; every other class here overrides ``update`` and samples its own
batch, so the trainer calls it once per update.

- BC: MSE to the data's actions (continuous) or their cross-entropy
  (discrete).
- TD3BC: TD3 with the actor loss ``-lambda * Q + MSE(pi(s), a)``, ``lambda
  = bc_alpha / mean|Q|`` (no gradient through the scale).
- BCQ: a VAE behaviour model, a perturbation actor, and a critic target
  that takes the best of ``num_sampled_action`` decoded and perturbed
  actions under ``lmbda * min + (1 - lmbda) * max`` of the twin target
  critics.  The steps run VAE, critic, actor, then the Polyak updates.
- CQL: SAC's actor and alpha steps, then a critic step whose loss adds a
  conservative penalty: a logsumexp over ``3 * num_repeat_actions`` actions
  per state (uniform random, current policy and next-state policy, each
  importance-corrected by its log-density) minus the data's Q.  With
  ``with_lagrange`` the penalty is ``sum_k alpha' * (penalty_k -
  lagrange_threshold)`` with ``alpha' = clip(exp(cql_log_alpha),
  alpha_min, alpha_max)``, and the dual takes its own Adam step (at
  ``cql_alpha_lr``) to maximise it.  With ``calibrated`` (CalQL) the
  out-of-distribution Q-values are floored at the transition's Monte-Carlo
  return, which :meth:`CQL.prepare_offline` writes into the storage once.
  The state's repeated rows are ``repeat_interleave``'s (each row ``n``
  times in a row), which the ``[K, B, n]`` reshape of the penalty reads.
- DiscreteBCQ: Q-learning whose greedy action is restricted to the actions
  an imitation net finds likely (``log pi(a|s) - max log pi > log
  unlikely_action_threshold``).
- DiscreteCQL: QRDQN plus ``min_q_weight * (logsumexp_a Q(s, a) - Q(s,
  a_data))`` on the mean quantiles.
- DiscreteCRR: critic-regularised regression, advantage-weighted imitation
  with ``exp``, ``binary`` or ``all`` weights, plus the same CQL term.

An update's draws come from the trainer's ``generator`` or are injected
through ``noise`` (the JAX package's own, for the parity tests).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, TrainState, polyak_update, write_back
from tianshou_tpu_torch.algos.ddpg import TD3, ACTrainState, adam, apply_loss, fresh_copy, frozen_copy
from tianshou_tpu_torch.algos.dqn import new_device_step, optimizer_step, take_action
from tianshou_tpu_torch.algos.qrdqn import QRDQN, quantile_huber_loss
from tianshou_tpu_torch.algos.sac import SAC, _min_over_critics
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.ops.dist import (
    categorical_log_prob,
    categorical_sample,
    standard_gumbel,
    tanh_normal_sample_and_log_prob,
)
from tianshou_tpu_torch.ops.returns import discounted_returns
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = [
    "BC",
    "TD3BC",
    "BCQ",
    "BCQTrainState",
    "CQL",
    "CQLTrainState",
    "DiscreteBCQ",
    "DiscreteCQL",
    "DiscreteCRR",
]

_TRANSITION_KEYS = ("obs", "act", "rew", "obs_next", "terminated", "truncated")


def _sample(buffer: ReplayBuffer, bstate: ReplayBufferState, generator, batch_size: int, keys=_TRANSITION_KEYS):
    env_idx, pos, _ = buffer.sample_with_weights(bstate, generator, batch_size)
    return env_idx, pos, buffer.get(bstate, env_idx, pos, keys=keys)


def _epsilon_greedy(greedy: torch.Tensor, n: int, generator, eps: float) -> torch.Tensor:
    rand = torch.randint(0, n, greedy.shape, generator=generator, device=greedy.device)
    take = torch.rand(greedy.shape, generator=generator, device=greedy.device) < eps
    return torch.where(take, rand, greedy)


class BC(Algorithm):
    """Behaviour cloning: MSE to the data's actions for a ``Box`` space,
    their cross-entropy under the actor's logits for a ``Discrete`` one."""

    def __init__(self, actor: nn.Module, action_space, *, lr: float = 1e-3, device: str | torch.device = "cuda"):
        self.actor = actor
        self.action_space = action_space
        self.discrete = isinstance(action_space, Discrete)
        self.lr = lr
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> TrainState:
        actor = fresh_copy(self.actor, self.device, generator)
        return TrainState(online=actor, target=actor, optimizer=adam(actor.parameters(), self.lr))

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        out = ts.online(obs)
        return out.argmax(dim=-1) if self.discrete else out

    def update(self, ts, buffer, bstate, generator, batch_size):
        _, _, batch = _sample(buffer, bstate, generator, batch_size, keys=("obs", "act"))
        out = ts.online(batch["obs"])
        if self.discrete:
            loss = -categorical_log_prob(batch["act"], out).mean()
        else:
            loss = ((out - batch["act"]) ** 2).mean()
        optimizer_step(ts, loss)
        return ts, bstate, {"loss": loss.detach()}


class TD3BC(TD3):
    """TD3 with a behaviour-cloning term in the actor loss."""

    def __init__(self, *args, bc_alpha: float = 2.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.bc_alpha = bc_alpha

    def _actor_loss(self, ts: ACTrainState, batch) -> torch.Tensor:
        obs = batch["obs"]
        a = ts.actor(obs)
        q = ts.critic(obs, a)[0]
        lmbda = self.bc_alpha / (q.abs().mean().detach() + 1e-8)
        return -lmbda * q.mean() + ((a - batch["act"]) ** 2).mean()


@dataclasses.dataclass
class BCQTrainState(ACTrainState):
    vae: nn.Module | None = None
    vae_optimizer: torch.optim.Optimizer | None = None


class BCQ(Algorithm):
    def __init__(
        self,
        perturbation: nn.Module,
        critic: nn.Module,
        vae: nn.Module,
        action_space: Box,
        *,
        actor_lr: float = 1e-3,
        critic_lr: float = 1e-3,
        vae_lr: float = 1e-3,
        gamma: float = 0.99,
        tau: float = 0.005,
        lmbda: float = 0.75,
        num_sampled_action: int = 10,
        device: str | torch.device = "cuda",
    ):
        """``perturbation`` ((obs, act) -> act), ``critic`` (a
        ``CriticEnsemble`` of 2) and ``vae`` are templates."""
        self.actor = perturbation
        self.critic = critic
        self.vae = vae
        self.action_space = action_space
        self.actor_lr, self.critic_lr, self.vae_lr = actor_lr, critic_lr, vae_lr
        self.gamma = gamma
        self.tau = tau
        self.lmbda = lmbda
        self.num_sampled_action = num_sampled_action
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> BCQTrainState:
        actor = fresh_copy(self.actor, self.device, generator)
        critic = fresh_copy(self.critic, self.device, generator)
        vae = fresh_copy(self.vae, self.device, generator)
        return BCQTrainState(
            actor=actor,
            critic=critic,
            target_actor=frozen_copy(actor),
            target_critic=frozen_copy(critic),
            actor_optimizer=adam(actor.parameters(), self.actor_lr),
            critic_optimizer=adam(critic.parameters(), self.critic_lr),
            vae=vae,
            vae_optimizer=adam(vae.parameters(), self.vae_lr),
        )

    def act_params(self, ts: BCQTrainState) -> nn.Module:
        return ts.actor

    def with_act_params(self, ts: BCQTrainState, module: nn.Module) -> BCQTrainState:
        return dataclasses.replace(ts, actor=module)

    def _latent(self, generator, rows: int) -> torch.Tensor:
        return torch.randn((rows, self.vae.latent_dim), generator=generator, device=self.device)

    def _candidates(self, vae, actor, obs, noise):
        """``num_sampled_action`` candidates a state, ``[B * n, ...]`` (each
        state's rows together): VAE decodes of the prior draw ``noise``,
        perturbed by ``actor``."""
        obs_rep = obs.repeat_interleave(self.num_sampled_action, dim=0)
        return obs_rep, actor(obs_rep, vae.decode(obs_rep, noise=noise))

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0, noise=None):
        """The candidate with the highest first-critic Q; ``noise [B * n,
        latent]`` in place of the prior draw."""
        n, bsz = self.num_sampled_action, obs.shape[0]
        noise = self._latent(generator, bsz * n) if noise is None else noise
        obs_rep, cand = self._candidates(ts.vae, ts.actor, obs, noise)
        best = ts.critic(obs_rep, cand)[0].reshape(bsz, n).argmax(dim=-1)
        return cand.reshape(bsz, n, -1)[torch.arange(bsz, device=obs.device), best]

    def update(self, ts: BCQTrainState, buffer, bstate, generator, batch_size, noise=None):
        """``noise``: ``(vae [B, latent], target [B * n, latent], actor [B,
        latent])`` standard normal draws, in place of three from
        ``generator``."""
        _, _, batch = _sample(buffer, bstate, generator, batch_size)
        if noise is None:
            noise = (self._latent(generator, batch_size),
                     self._latent(generator, batch_size * self.num_sampled_action),
                     self._latent(generator, batch_size))
        eps_vae, eps_target, eps_actor = noise
        obs, act = batch["obs"], batch["act"]

        # 1. the VAE's reconstruction + KL
        recon, mean, log_std = ts.vae(obs, act, eps_vae)
        kl = -0.5 * (1 + 2 * log_std - mean**2 - torch.exp(2 * log_std)).mean()
        vae_loss = ((recon - act) ** 2).mean() + 0.5 * kl
        apply_loss(ts.vae_optimizer, vae_loss)

        # 2. the critic against the best mixed target over sampled actions
        with torch.no_grad():
            obs_rep, cand = self._candidates(ts.vae, ts.target_actor, batch["obs_next"], eps_target)
            q_t = ts.target_critic(obs_rep, cand)  # [2, B * n]
            q_mix = self.lmbda * q_t.amin(dim=0) + (1 - self.lmbda) * q_t.amax(dim=0)
            q_next = q_mix.reshape(batch_size, self.num_sampled_action).amax(dim=-1)
            target = batch["rew"] + self.gamma * (1.0 - batch["terminated"].to(torch.float32)) * q_next
        critic_loss = ((ts.critic(obs, act) - target[None, :]) ** 2).mean()
        apply_loss(ts.critic_optimizer, critic_loss)

        # 3. the perturbation actor against the updated first critic
        with torch.no_grad():
            decoded = ts.vae.decode(obs, noise=eps_actor)
        actor_loss = -ts.critic(obs, ts.actor(obs, decoded))[0].mean()
        apply_loss(ts.actor_optimizer, actor_loss)
        polyak_update(ts.target_actor, ts.actor, self.tau)
        polyak_update(ts.target_critic, ts.critic, self.tau)
        ts.step += 1
        return ts, bstate, {"vae_loss": vae_loss.detach(), "critic_loss": critic_loss.detach(),
                            "actor_loss": actor_loss.detach()}


@dataclasses.dataclass
class CQLTrainState(ACTrainState):
    """SAC's state plus CQL(Lagrange)'s dual (a 0-d tensor) and its Adam."""

    cql_log_alpha: torch.Tensor | None = None
    cql_alpha_optimizer: torch.optim.Optimizer | None = None


class CQL(SAC):
    def __init__(
        self,
        *args,
        cql_weight: float = 1.0,
        temperature: float = 1.0,
        num_repeat_actions: int = 10,
        with_lagrange: bool = True,
        lagrange_threshold: float = 10.0,
        cql_alpha_lr: float = 1e-4,
        alpha_min: float = 0.0,
        alpha_max: float = 1e6,
        calibrated: bool = False,
        **kwargs,
    ):
        """SAC's arguments (``n_step`` defaults to 1), and the penalty's."""
        kwargs.setdefault("n_step", 1)
        super().__init__(*args, **kwargs)
        self.cql_weight = cql_weight
        self.temperature = temperature
        self.num_repeat_actions = num_repeat_actions
        self.with_lagrange = with_lagrange
        self.lagrange_threshold = lagrange_threshold
        self.cql_alpha_lr = cql_alpha_lr
        self.alpha_min = alpha_min
        self.alpha_max = alpha_max
        self.calibrated = calibrated

    def prepare_offline(self, buffer: ReplayBuffer, bstate: ReplayBufferState) -> ReplayBufferState:
        """With ``calibrated``: each slot's Monte-Carlo return (reward to go
        with a zero bootstrap, restarting at every episode end) as
        ``storage["calibration_return"] [num_envs, capacity]``, in a new
        state whose other leaves are shared; else ``bstate``.  The returns
        run over ``chronological``'s ``[capacity, num_envs]`` order, one
        step a time, and are scattered back to their ring slots."""
        if not self.calibrated:
            return bstate
        chron = buffer.chronological(bstate)
        rew = chron["rew"]
        rets = discounted_returns(rew, torch.zeros_like(rew), chron["terminated"],
                                  chron["terminated"] | chron["truncated"], self.gamma)
        T, N = rets.shape
        pos = torch.remainder(bstate.cursor[None, :] + torch.arange(T, device=rets.device)[:, None], T)
        env = torch.arange(N, device=rets.device)[None, :].expand_as(pos)
        cal = torch.zeros((N, T), dtype=rets.dtype, device=rets.device)
        cal[env, pos] = rets
        return dataclasses.replace(bstate, storage=Batch({**bstate.storage, "calibration_return": cal}))

    def init(self, generator: torch.Generator) -> CQLTrainState:
        base = super().init(generator)
        ts = CQLTrainState(**{f.name: getattr(base, f.name) for f in dataclasses.fields(ACTrainState)})
        if self.with_lagrange:
            ts.cql_log_alpha = torch.zeros((), device=self.device, requires_grad=True)
            ts.cql_alpha_optimizer = adam([ts.cql_log_alpha], self.cql_alpha_lr)
        return ts

    def _dual(self, log_alpha: torch.Tensor) -> torch.Tensor:
        return torch.clamp(log_alpha.exp(), self.alpha_min, self.alpha_max)

    def draw_noise(self, generator, batch_size: int) -> tuple[torch.Tensor, ...]:
        """An update's draws: normals for the actor step ``[B, A]``, the
        target ``[B, A]``, the current and the next policy's repeated
        actions ``[B * n, A]``, and the random actions, uniform in ``[-1, 1]``
        ``[B * n, A]``."""
        a, rows = self.action_space.shape[0], batch_size * self.num_repeat_actions
        normals = tuple(torch.randn((r, a), generator=generator, device=self.device)
                        for r in (batch_size, batch_size, rows, rows))
        return (*normals, torch.rand((rows, a), generator=generator, device=self.device) * 2.0 - 1.0)

    def update(self, ts: CQLTrainState, buffer, bstate, generator, batch_size, noise=None):
        """``noise``: :meth:`draw_noise`'s five tensors, in place of drawing
        them from ``generator``."""
        env_idx, pos, batch = _sample(buffer, bstate, generator, batch_size)
        eps_pi, eps_tgt, eps_cur, eps_nxt, a_rand = self.draw_noise(generator, batch_size) if noise is None else noise
        obs, act, obs_next = batch["obs"], batch["act"], batch["obs_next"]
        done = (batch["terminated"] | batch["truncated"]).to(torch.float32)
        alpha = ts.log_alpha.detach().exp()
        n_rep, act_dim = self.num_repeat_actions, self.action_space.shape[0]

        # the actor and alpha steps, against the critic before its step
        actor_loss, _ = self._actor_step(ts, obs, eps_pi, alpha, _min_over_critics)

        with torch.no_grad():
            # the one-step target from the updated actor
            a_next, logp_next = tanh_normal_sample_and_log_prob(*ts.actor(obs_next), eps_tgt)
            q_next = ts.target_critic(obs_next, a_next).amin(dim=0)
            target = batch["rew"] + self.gamma * (1.0 - done) * (q_next - alpha * logp_next)
            # the penalty's sampled actions, each state's n_rep rows together
            obs_rep = obs.repeat_interleave(n_rep, dim=0)
            a_cur, logp_cur = tanh_normal_sample_and_log_prob(*ts.actor(obs_rep), eps_cur)
            a_nxt, logp_nxt = tanh_normal_sample_and_log_prob(
                *ts.actor(obs_next.repeat_interleave(n_rep, dim=0)), eps_nxt)
            logp_rand = math.log(0.5**act_dim)
            cal_ret = None
            if self.calibrated:
                cal_ret = bstate.storage["calibration_return"][env_idx, pos].repeat_interleave(n_rep)[None, :]
            cql_alpha = self._dual(ts.cql_log_alpha) if self.with_lagrange else None

        q_data = ts.critic(obs, act)  # [2, B]
        td_loss = ((q_data - target[None, :]) ** 2).mean()
        q_ood = [ts.critic(obs_rep, a) for a in (a_rand, a_cur, a_nxt)]
        if cal_ret is not None:
            q_ood = [torch.maximum(q, cal_ret) for q in q_ood]
        q_rand, q_cur, q_nxt = (q - lp for q, lp in zip(q_ood, (logp_rand, logp_cur[None, :], logp_nxt[None, :])))
        k = q_data.shape[0]
        cat = torch.cat([q.reshape(k, batch_size, n_rep) for q in (q_rand, q_cur, q_nxt)], dim=-1)
        lse = torch.logsumexp(cat / self.temperature, dim=-1)  # [K, B]
        raw = lse.mean(dim=-1) * self.cql_weight * self.temperature - q_data.mean(dim=-1) * self.cql_weight
        if self.with_lagrange:
            penalty = (cql_alpha * (raw - self.lagrange_threshold)).sum()
        else:
            penalty = raw.mean()
        critic_loss = td_loss + penalty
        apply_loss(ts.critic_optimizer, critic_loss)

        metrics = {"critic_loss": critic_loss.detach(), "td_loss": td_loss.detach(), "cql_penalty": penalty.detach(),
                   "actor_loss": actor_loss}
        if self.with_lagrange:
            # gradient ascent on the dual: it grows while the penalties
            # exceed the threshold
            dual_loss = -0.5 * (self._dual(ts.cql_log_alpha) * (raw.detach() - self.lagrange_threshold)).sum()
            apply_loss(ts.cql_alpha_optimizer, dual_loss)
            metrics["cql_alpha"] = self._dual(ts.cql_log_alpha.detach())
        polyak_update(ts.target_critic, ts.critic, self.tau)
        ts.step += 1
        metrics["alpha"] = ts.log_alpha.detach().exp()
        return ts, bstate, metrics


class DiscreteBCQ(Algorithm):
    def __init__(
        self,
        q_network: nn.Module,
        imitation_network: nn.Module,
        action_space: Discrete,
        *,
        lr: float = 1e-3,
        gamma: float = 0.99,
        target_update_freq: int = 8000,
        unlikely_action_threshold: float = 0.3,
        imitation_logits_penalty: float = 1e-2,
        device: str | torch.device = "cuda",
    ):
        """``q_network`` and ``imitation_network`` (obs -> ``[B, A]``) are
        templates; the state's ``online`` and ``target`` are
        ``ModuleDict(q=..., imitation=...)``, stepped by one Adam."""
        self.q_network = q_network
        self.imitation_network = imitation_network
        self.action_space = action_space
        self.lr = lr
        self.gamma = gamma
        self.target_update_freq = target_update_freq
        self.log_tau = math.log(unlikely_action_threshold)
        self.reg_weight = imitation_logits_penalty
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> TrainState:
        online = nn.ModuleDict(dict(q=fresh_copy(self.q_network, self.device, generator),
                                    imitation=fresh_copy(self.imitation_network, self.device, generator)))
        return TrainState(online=online, target=frozen_copy(online), optimizer=adam(online.parameters(), self.lr),
                          device_step=new_device_step(self.device) if self.target_update_freq > 0 else None)

    def _masked_greedy(self, net: nn.ModuleDict, obs) -> torch.Tensor:
        """The greedy action among those whose imitation log-probability is
        within ``log unlikely_action_threshold`` of the most likely's."""
        logp = F.log_softmax(net["imitation"](obs), dim=-1)
        likely = (logp - logp.amax(dim=-1, keepdim=True)) > self.log_tau
        return torch.where(likely, net["q"](obs), -math.inf).argmax(dim=-1)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        a = self._masked_greedy(ts.online, obs)
        return _epsilon_greedy(a, self.action_space.n, generator, explore_param) if explore else a

    def update(self, ts: TrainState, buffer, bstate, generator, batch_size):
        _, _, batch = _sample(buffer, bstate, generator, batch_size)
        act = batch["act"].to(torch.int64)
        with torch.no_grad():
            a_next = self._masked_greedy(ts.online, batch["obs_next"])
            q_next = take_action(ts.target["q"](batch["obs_next"]), a_next)
            target = batch["rew"] + self.gamma * (1.0 - batch["terminated"].to(torch.float32)) * q_next
        q_loss = ((take_action(ts.online["q"](batch["obs"]), act) - target) ** 2).mean()
        logits = ts.online["imitation"](batch["obs"])
        i_loss = -categorical_log_prob(act, logits).mean()
        loss = q_loss + i_loss + self.reg_weight * (logits**2).mean()
        optimizer_step(ts, loss, self.target_update_freq)
        return ts, bstate, {"loss": loss.detach(), "q_loss": q_loss.detach(), "imitation_loss": i_loss.detach()}


class DiscreteCQL(QRDQN):
    """QRDQN with the discrete CQL penalty; ``a*`` of the target is the
    target net's own greedy action."""

    def __init__(self, *args, min_q_weight: float = 10.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.min_q_weight = min_q_weight

    def update(self, ts: TrainState, buffer, bstate, generator, batch_size):
        env_idx, pos, weight, batch, term, mask, returns, discount = self.presample(
            buffer, bstate, generator, batch_size)
        with torch.no_grad():
            theta_t = self.quantiles(ts.target, term["obs_next"])
            a_star = theta_t.mean(dim=-1).argmax(dim=-1)
            target = self._target(returns, discount, mask, take_action(theta_t, a_star))
        act = batch["act"].to(torch.int64)
        theta = self.quantiles(ts.online, batch["obs"])  # [B, A, K]
        theta_a = take_action(theta, act)
        per_sample, td_abs = quantile_huber_loss(theta_a, target, self.tau_hats.expand_as(theta_a))
        qr_loss = (weight * per_sample).mean()
        q_mean = theta.mean(dim=-1)
        cql = (torch.logsumexp(q_mean, dim=-1) - take_action(q_mean, act)).mean()
        loss = qr_loss + self.min_q_weight * cql
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach(), "qr_loss": qr_loss.detach(), "cql_loss": cql.detach()}


class DiscreteCRR(Algorithm):
    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Discrete,
        *,
        lr: float = 1e-3,
        gamma: float = 0.99,
        policy_improvement_mode: str = "exp",
        ratio_upper_bound: float = 20.0,
        beta: float = 1.0,
        min_q_weight: float = 10.0,
        target_update_freq: int = 500,
        device: str | torch.device = "cuda",
    ):
        """``actor`` (obs -> logits) and ``critic`` (obs -> ``[B, A]``) are
        templates; the state's ``online`` and ``target`` are
        ``ModuleDict(actor=..., critic=...)``, stepped by one Adam."""
        if policy_improvement_mode not in ("exp", "binary", "all"):
            raise ValueError(f"policy_improvement_mode must be exp, binary or all, not {policy_improvement_mode!r}")
        self.actor = actor
        self.critic = critic
        self.action_space = action_space
        self.lr = lr
        self.gamma = gamma
        self.mode = policy_improvement_mode
        self.ratio_upper_bound = ratio_upper_bound
        self.beta = beta
        self.min_q_weight = min_q_weight
        self.target_update_freq = target_update_freq
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> TrainState:
        online = nn.ModuleDict(dict(actor=fresh_copy(self.actor, self.device, generator),
                                    critic=fresh_copy(self.critic, self.device, generator)))
        return TrainState(online=online, target=frozen_copy(online), optimizer=adam(online.parameters(), self.lr),
                          device_step=new_device_step(self.device) if self.target_update_freq > 0 else None)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        logits = ts.online["actor"](obs)
        return categorical_sample(logits, standard_gumbel(generator, logits)) if explore else logits.argmax(dim=-1)

    def _weight(self, adv: torch.Tensor) -> torch.Tensor:
        if self.mode == "exp":
            return torch.clamp(torch.exp(adv / self.beta), 0.0, self.ratio_upper_bound)
        if self.mode == "binary":
            return (adv > 0).to(adv.dtype)
        return torch.ones_like(adv)

    def update(self, ts: TrainState, buffer, bstate, generator, batch_size):
        _, _, batch = _sample(buffer, bstate, generator, batch_size)
        act = batch["act"].to(torch.int64)
        with torch.no_grad():
            # E_{pi_target}[Q_target(s', .)]
            q_t = ts.target["critic"](batch["obs_next"])
            pi_t = F.softmax(ts.target["actor"](batch["obs_next"]), dim=-1)
            target = batch["rew"] + self.gamma * (1.0 - batch["terminated"].to(torch.float32)) * (pi_t * q_t).sum(-1)
        q = ts.online["critic"](batch["obs"])  # [B, A]
        q_a = take_action(q, act)
        critic_loss = ((q_a - target) ** 2).mean()
        logits = ts.online["actor"](batch["obs"])
        adv = (q_a - (F.softmax(logits, dim=-1) * q).sum(dim=-1)).detach()
        actor_loss = -(self._weight(adv) * categorical_log_prob(act, logits)).mean()
        cql = (torch.logsumexp(q, dim=-1) - q_a).mean()
        loss = actor_loss + critic_loss + self.min_q_weight * cql
        optimizer_step(ts, loss, self.target_update_freq)
        return ts, bstate, {"loss": loss.detach(), "actor_loss": actor_loss.detach(),
                            "critic_loss": critic_loss.detach()}
