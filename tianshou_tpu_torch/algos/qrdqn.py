"""QRDQN, IQN and FQF: quantile-based distributional DQN (port of
``tianshou_tpu/algos/qrdqn.py``).

All three regress the taken action's quantiles on the n-step target
quantiles with the pairwise quantile Huber loss
(:func:`quantile_huber_loss`, one ``[B, K, K']`` broadcast), write the mean
``|u|`` of each sample back as its priority, and finish with DQN's Adam step
and periodic target copy.  Their presample keeps the n-step return as its
components ``(returns, discount)`` with the bootstrap mask.

- QRDQN: fixed fractions ``(i + 0.5) / K``; double-Q picks ``a*`` with the
  online net's mean quantiles.
- IQN: fractions drawn per forward, ``torch.rand([B, K])``: one draw for the
  target net, one for the online net, and with double-Q a third for the
  online net's pick of ``a*``.  They come from the trainer's generator, or
  are injected through ``taus`` for the parity tests.
- FQF: fractions proposed by :class:`FractionProposalNetwork` from the
  detached state features, its own RMSprop step (optax's form,
  :class:`RMSprop`) on the FQF paper's fraction loss with an entropy bonus;
  ``a*`` comes from the target net at the target net's own fractions.  The
  fraction loss reads the quantile net's parameters from before the main
  step, so both losses are formed before either step is taken, and the
  quantile values that the fraction loss reads are computed without a
  gradient.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from tianshou_tpu_torch.algos.base import TrainState, write_back
from tianshou_tpu_torch.algos.dqn import DQN, take_action
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.ops.returns import nstep_return_components

__all__ = ["QRDQN", "IQN", "FQF", "FQFTrainState", "RMSprop", "quantile_huber_loss"]


def quantile_huber_loss(
    current: torch.Tensor, target: torch.Tensor, tau_hats: torch.Tensor, kappa: float = 1.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise quantile Huber loss of ``current [B, K]`` (at fractions
    ``tau_hats [B, K]``) against ``target [B, K']``: ``(per-sample loss [B],
    per-sample mean |u| [B])``, the latter the PER priority."""
    u = target[:, None, :] - current[:, :, None]  # [B, K, K']
    abs_u = u.abs()
    huber = torch.where(abs_u <= kappa, 0.5 * u**2, kappa * (abs_u - 0.5 * kappa))
    indicator = (u < 0).to(u.dtype)
    loss = (tau_hats[:, :, None] - indicator).abs() * huber / kappa
    return loss.mean(dim=2).sum(dim=1), abs_u.mean(dim=(1, 2))


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)``: ``nu = 0.9 * nu + 0.1 * g**2`` from ``nu = 0``,
    then ``p -= lr * g / sqrt(nu + 1e-8)``, the epsilon inside the root
    (``torch.optim.RMSprop`` adds it outside, with decay 0.99)."""

    DECAY, EPS = 0.9, 1e-8

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(self.DECAY).addcmul_(p.grad, p.grad, value=1.0 - self.DECAY)
                p.add_(p.grad * torch.rsqrt(nu + self.EPS), alpha=-group["lr"])


class QRDQN(DQN):
    def __init__(self, network, action_space: Discrete, *, num_quantiles: int = 200, **kwargs):
        """``network``: obs -> ``[B, A, num_quantiles]`` quantile values; the
        other arguments are DQN's."""
        super().__init__(network, action_space, **kwargs)
        self.num_quantiles = num_quantiles
        self.tau_hats = (torch.arange(num_quantiles, device=self.device) + 0.5) / num_quantiles

    def quantiles(self, net, obs) -> torch.Tensor:
        return net(obs)

    def q_values(self, net, obs) -> torch.Tensor:
        return self.quantiles(net, obs).mean(dim=-1)

    def presample(self, buffer, bstate, generator, batch_size) -> tuple:
        """``(env_idx, pos, weight, batch{obs, act}, term{obs_next,
        terminated}, mask, returns, discount)``."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = self._sample_nstep(
            buffer, bstate, generator, batch_size, self.n_step)
        mask = 1.0 - term["terminated"].to(torch.float32)
        returns, discount = nstep_return_components(rew_chain, done_chain, self.gamma)
        return env_idx, pos, weight, batch, term, mask, returns, discount

    def _target(self, returns, discount, mask, theta_star) -> torch.Tensor:
        return returns[:, None] + (discount * mask)[:, None] * theta_star

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``generator`` is unused: the QRDQN update draws nothing."""
        env_idx, pos, weight, batch, term, mask, returns, discount = sampled
        with torch.no_grad():
            theta_t = self.quantiles(ts.target, term["obs_next"])  # [B, A, K]
            if self.is_double:
                a_star = self.q_values(ts.online, term["obs_next"]).argmax(dim=-1)
            else:
                a_star = theta_t.mean(dim=-1).argmax(dim=-1)
            target = self._target(returns, discount, mask, take_action(theta_t, a_star))
        theta_a = take_action(self.quantiles(ts.online, batch["obs"]), batch["act"])
        per_sample, td_abs = quantile_huber_loss(theta_a, target, self.tau_hats.expand_as(theta_a))
        loss = (weight * per_sample).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach()}


class IQN(QRDQN):
    """Implicit quantile networks: fractions sampled per forward."""

    def __init__(
        self,
        network,
        action_space: Discrete,
        *,
        sample_size: int = 32,
        online_sample_size: int = 8,
        target_sample_size: int = 8,
        **kwargs,
    ):
        """``network``: an ``ImplicitQuantileNetwork`` (``(obs, taus) ->
        [B, K, A]``)."""
        kwargs.setdefault("num_quantiles", sample_size)
        super().__init__(network, action_space, **kwargs)
        self.sample_size = sample_size
        self.online_sample_size = online_sample_size
        self.target_sample_size = target_sample_size

    def _quantiles_at(self, net, obs, taus) -> torch.Tensor:
        """``[B, A, K]`` quantiles at ``taus [B, K]``."""
        return net(obs, taus).transpose(1, 2)

    @staticmethod
    def _draw_taus(generator, rows: int, k: int) -> torch.Tensor:
        return torch.rand((rows, k), generator=generator, device=generator.device)

    def q_values(self, net, obs, generator) -> torch.Tensor:
        """Mean quantiles at ``sample_size`` fractions drawn from
        ``generator``."""
        return self._quantiles_at(net, obs, self._draw_taus(generator, obs.shape[0], self.sample_size)).mean(dim=-1)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        greedy = self.q_values(ts.online, obs, generator).argmax(dim=-1)
        if not explore:
            return greedy
        return self._epsilon_greedy(greedy, generator, explore_param)

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
        taus: tuple | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``taus``: the ``(target, online, double-Q pick)`` fractions,
        ``[B, target_sample_size]``, ``[B, online_sample_size]`` and ``[B,
        target_sample_size]`` (the last unused without double-Q), in place
        of draws from ``generator``."""
        env_idx, pos, weight, batch, term, mask, returns, discount = sampled
        bsz = weight.shape[0]
        if taus is None:
            taus = (self._draw_taus(generator, bsz, self.target_sample_size),
                    self._draw_taus(generator, bsz, self.online_sample_size),
                    self._draw_taus(generator, bsz, self.target_sample_size) if self.is_double else None)
        tau_target, tau_online, tau_double = taus
        with torch.no_grad():
            theta_t = self._quantiles_at(ts.target, term["obs_next"], tau_target)
            if self.is_double:
                a_star = self._quantiles_at(ts.online, term["obs_next"], tau_double).mean(dim=-1).argmax(dim=-1)
            else:
                a_star = theta_t.mean(dim=-1).argmax(dim=-1)
            target = self._target(returns, discount, mask, take_action(theta_t, a_star))
        theta_a = take_action(self._quantiles_at(ts.online, batch["obs"], tau_online), batch["act"])
        per_sample, td_abs = quantile_huber_loss(theta_a, target, tau_online)
        loss = (weight * per_sample).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach()}


@dataclasses.dataclass
class FQFTrainState(TrainState):
    """:class:`TrainState` plus the fraction proposal and its optimizer."""

    fraction: nn.Module = None
    fraction_optimizer: torch.optim.Optimizer = None


class FQF(QRDQN):
    """Fully parameterized quantile function: learned fraction proposals
    with their own optimizer and an entropy bonus."""

    def __init__(
        self,
        network,
        fraction_network,
        action_space: Discrete,
        *,
        fraction_lr: float = 2.5e-9,
        ent_coef: float = 10.0,
        num_fractions: int = 32,
        **kwargs,
    ):
        """``network``: a ``FullQuantileFunction``; ``fraction_network``: a
        ``FractionProposalNetwork`` over its features."""
        kwargs.setdefault("num_quantiles", num_fractions)
        super().__init__(network, action_space, **kwargs)
        self.fraction_network = fraction_network
        self.fraction_lr = fraction_lr
        self.ent_coef = ent_coef
        self.num_fractions = num_fractions

    def init(self, generator: torch.Generator) -> FQFTrainState:
        ts = super().init(generator)
        fraction = copy.deepcopy(self.fraction_network).to(self.device)
        fraction.reset_parameters(generator)
        return FQFTrainState(online=ts.online, target=ts.target, optimizer=ts.optimizer, fraction=fraction,
                             fraction_optimizer=RMSprop(fraction.parameters(), self.fraction_lr))

    def _forward(self, net, fraction, obs):
        """``(taus [B, K+1], tau_hats [B, K], values at tau_hats [B, A, K],
        entropy [B], feat)``; the fractions come from the detached features
        and enter the quantile head detached."""
        feat = net.features(obs)
        taus, tau_hats, entropy = fraction(feat.detach())
        vals = net.quantiles(feat, tau_hats.detach()).transpose(1, 2)
        return taus, tau_hats, vals, entropy, feat

    @staticmethod
    def _expected(taus, vals) -> torch.Tensor:
        """``E[Z] = sum_k (tau_{k+1} - tau_k) * theta(tau_hat_k)``: ``[B, A]``."""
        return ((taus[:, 1:] - taus[:, :-1])[:, None, :] * vals).sum(dim=-1)

    def q_values(self, net, obs, fraction) -> torch.Tensor:
        """Expected values of ``net`` at the fractions ``fraction``
        proposes."""
        taus, _, vals, _, _ = self._forward(net, fraction, obs)
        return self._expected(taus, vals)

    def q_values_fqf(self, ts: FQFTrainState, obs) -> torch.Tensor:
        """The online net's expected values at its own proposed fractions,
        ``[B, A]``."""
        return self.q_values(ts.online, obs, ts.fraction)

    def act_params(self, ts: FQFTrainState) -> nn.Module:
        # acting reads the quantile net and the fraction proposals
        return nn.ModuleDict({"online": ts.online, "fraction": ts.fraction})

    def with_act_params(self, ts: FQFTrainState, module: nn.Module) -> FQFTrainState:
        return dataclasses.replace(ts, online=module["online"], fraction=module["fraction"])

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        greedy = self.q_values_fqf(ts, obs).argmax(dim=-1)
        if not explore:
            return greedy
        return self._epsilon_greedy(greedy, generator, explore_param)

    def update_sampled(
        self,
        ts: FQFTrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[FQFTrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``generator`` is unused: the FQF update draws nothing."""
        env_idx, pos, weight, batch, term, mask, returns, discount = sampled
        act = batch["act"]
        with torch.no_grad():
            taus_t, _, vals_t, _, _ = self._forward(ts.target, ts.fraction, term["obs_next"])
            a_star = self._expected(taus_t, vals_t).argmax(dim=-1)
            target = self._target(returns, discount, mask, take_action(vals_t, a_star))

        # the quantile loss: the fraction proposals are constants to it
        feat = ts.online.features(batch["obs"])
        taus, tau_hats, entropy = ts.fraction(feat.detach())
        theta_a = take_action(ts.online.quantiles(feat, tau_hats.detach()).transpose(1, 2), act)
        per_sample, td_abs = quantile_huber_loss(theta_a, target, tau_hats.detach())
        loss = (weight * per_sample).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)

        # the fraction loss, dW1/dtau_i = 2 F^-1(tau_i) - F^-1(tau_hat_i) -
        # F^-1(tau_hat_{i-1}) (FQF paper, eq. 7), with the quantile net's
        # parameters from before its step
        with torch.no_grad():
            feat_d = feat.detach()
            v_tau = take_action(ts.online.quantiles(feat_d, taus[:, 1:-1]).transpose(1, 2), act)
            v_hat = take_action(ts.online.quantiles(feat_d, tau_hats).transpose(1, 2), act)
            grad_w1 = 2.0 * v_tau - v_hat[:, :-1] - v_hat[:, 1:]
        fraction_loss = (grad_w1 * taus[:, 1:-1]).sum(dim=-1).mean() - self.ent_coef * entropy.mean()

        self._finish_update(ts, loss)
        ts.fraction_optimizer.zero_grad(set_to_none=True)
        fraction_loss.backward()
        ts.fraction_optimizer.step()
        return ts, bstate, {"loss": loss.detach(), "fraction_loss": fraction_loss.detach()}
