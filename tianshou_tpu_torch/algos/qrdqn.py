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
  are injected through ``taus`` for the parity tests.  Under data
  parallelism each block is drawn for the global batch and sliced to the
  rank's rows (:meth:`Algorithm.draw_rows`), so a row's fractions depend on
  its global row alone, as the JAX package's ``_rowwise_taus`` makes them;
  :meth:`IQN.priority_scores` with ``row_offset`` regenerates them.
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

from tianshou_tpu_torch.algos.base import TrainState, sync_gradients, write_back
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
    """``optax.rmsprop(lr, decay, eps)``: ``nu = decay * nu + (1 - decay) *
    g**2`` from ``nu = 0``, then ``p -= lr * g / sqrt(nu + eps)``, the
    epsilon inside the root (``torch.optim.RMSprop`` adds it outside)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

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
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]), alpha=-group["lr"])


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

    def _quantile_td(self, ts: TrainState, sampled: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """``(per-sample loss [B] with its gradient, mean |u| [B])``."""
        env_idx, pos, weight, batch, term, mask, returns, discount = sampled
        with torch.no_grad():
            theta_t = self.quantiles(ts.target, term["obs_next"])  # [B, A, K]
            if self.is_double:
                a_star = self.q_values(ts.online, term["obs_next"]).argmax(dim=-1)
            else:
                a_star = theta_t.mean(dim=-1).argmax(dim=-1)
            target = self._target(returns, discount, mask, take_action(theta_t, a_star))
        theta_a = take_action(self.quantiles(ts.online, batch["obs"]), batch["act"])
        return quantile_huber_loss(theta_a, target, self.tau_hats.expand_as(theta_a))

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``generator`` is unused: the QRDQN update draws nothing."""
        env_idx, pos, weight = sampled[:3]
        per_sample, td_abs = self._quantile_td(ts, sampled)
        loss = (weight * per_sample).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach()}

    @torch.no_grad()
    def priority_scores(self, ts: TrainState, sampled: tuple, generator: torch.Generator | None = None):
        """The quantile ``|u|`` :meth:`update_sampled` writes back (nothing
        is drawn)."""
        return self._quantile_td(ts, sampled)[1]


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

    def _update_taus(self, generator, rows: int, block: tuple[int, int] | None = None) -> tuple:
        """The update's ``(target, online, double-Q pick)`` fractions for
        ``rows`` rows, each drawn per global row (:meth:`draw_rows`)."""
        def draw(k):
            return self.draw_rows(lambda n: self._draw_taus(generator, n, k), rows, block)

        return (draw(self.target_sample_size), draw(self.online_sample_size),
                draw(self.target_sample_size) if self.is_double else None)

    def _quantile_td(self, ts: TrainState, sampled: tuple, taus: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """``(per-sample loss [B] with its gradient, mean |u| [B])`` at the
        fractions ``taus``."""
        env_idx, pos, weight, batch, term, mask, returns, discount = sampled
        tau_target, tau_online, tau_double = taus
        with torch.no_grad():
            theta_t = self._quantiles_at(ts.target, term["obs_next"], tau_target)
            if self.is_double:
                a_star = self._quantiles_at(ts.online, term["obs_next"], tau_double).mean(dim=-1).argmax(dim=-1)
            else:
                a_star = theta_t.mean(dim=-1).argmax(dim=-1)
            target = self._target(returns, discount, mask, take_action(theta_t, a_star))
        theta_a = take_action(self._quantiles_at(ts.online, batch["obs"], tau_online), batch["act"])
        return quantile_huber_loss(theta_a, target, tau_online)

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
        of draws from ``generator``, each made for the global batch and
        sliced to this rank's rows under a :attr:`row_block`."""
        env_idx, pos, weight = sampled[:3]
        if taus is None:
            taus = self._update_taus(generator, weight.shape[0])
        per_sample, td_abs = self._quantile_td(ts, sampled, taus)
        loss = (weight * per_sample).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach()}

    @torch.no_grad()
    def priority_scores(self, ts: TrainState, sampled: tuple, generator: torch.Generator | None = None,
                        row_offset: int = 0, global_rows: int | None = None, taus: tuple | None = None):
        """The quantile ``|u|`` :meth:`update_sampled` writes back: from
        ``taus``, or from fractions drawn from ``generator`` in the state the
        update drew from, for a shard whose rows sit at ``row_offset`` of a
        global batch of ``global_rows`` (default: the shard ends the batch)
        so that each row gets the fractions it had in the update."""
        if taus is None:
            rows = sampled[2].shape[0]
            block = (row_offset, global_rows if global_rows is not None else row_offset + rows)
            taus = self._update_taus(generator, rows, block)
        return self._quantile_td(ts, sampled, taus)[1]


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
        env_idx, pos, weight, batch = sampled[:4]
        act = batch["act"]
        per_sample, td_abs, feat, taus, tau_hats, entropy = self._quantile_td(ts, sampled)
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
        sync_gradients(ts.fraction_optimizer, self.process_group)
        ts.fraction_optimizer.step()
        return ts, bstate, {"loss": loss.detach(), "fraction_loss": fraction_loss.detach()}

    def _quantile_td(self, ts: FQFTrainState, sampled: tuple) -> tuple:
        """``(per-sample loss with its gradient, mean |u|, features,
        fractions, their midpoints, entropy)``: the quantile loss, to which
        the fraction proposals are constants."""
        env_idx, pos, weight, batch, term, mask, returns, discount = sampled
        with torch.no_grad():
            taus_t, _, vals_t, _, _ = self._forward(ts.target, ts.fraction, term["obs_next"])
            a_star = self._expected(taus_t, vals_t).argmax(dim=-1)
            target = self._target(returns, discount, mask, take_action(vals_t, a_star))
        feat = ts.online.features(batch["obs"])
        taus, tau_hats, entropy = ts.fraction(feat.detach())
        theta_a = take_action(ts.online.quantiles(feat, tau_hats.detach()).transpose(1, 2), batch["act"])
        per_sample, td_abs = quantile_huber_loss(theta_a, target, tau_hats.detach())
        return per_sample, td_abs, feat, taus, tau_hats, entropy

    @torch.no_grad()
    def priority_scores(self, ts: FQFTrainState, sampled: tuple, generator: torch.Generator | None = None,
                        row_offset: int = 0, global_rows: int | None = None):
        """The quantile ``|u|`` :meth:`update_sampled` writes back.  The
        fractions are proposals, functions of each row's features, so the
        recompute is exact for any split of the batch: ``row_offset`` and
        ``global_rows`` are accepted as IQN's and unused."""
        return self._quantile_td(ts, sampled)[1]
