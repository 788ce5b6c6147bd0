"""A2C: advantage actor-critic with GAE (port of ``A2C`` in
``tianshou_tpu/algos/a2c.py``).

One optimizer covers the actor and the critic (``ValueNet``: obs -> ``[B]``),
so the global-norm clip spans both.  :meth:`A2C.process_rollout` runs the
critic over the rollout's ``obs`` and ``obs_next`` and computes GAE.  With
``ret_norm`` the critic predicts returns divided by the running return
std: its values are multiplied back by that std before GAE against the raw
rewards, the advantages stay in reward scale, and the value targets are
divided by the std without subtracting the mean.
:meth:`A2C.update_rollout_stats` folds the rollout's unnormalised returns
into the running statistics with Chan's formula, after the first
processing pass.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch import nn

from tianshou_tpu_torch.algos.ddpg import fresh_copy
from tianshou_tpu_torch.algos.pg import PG, OnPolicyTrainState, _population_std
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.ops.returns import gae_advantages

__all__ = ["A2C"]


class A2C(PG):
    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Box | Discrete,
        *,
        lr: float | Callable[[int], float] = 7e-4,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        vf_coef: float = 0.5,
        ent_coef: float = 0.01,
        max_grad_norm: float | None = None,
        adv_norm: bool = False,
        ret_norm: bool = False,
        deterministic_eval: bool = True,
        optimizer: Callable[[list[nn.Parameter]], torch.optim.Optimizer] | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(
            actor, action_space, lr=lr, gamma=gamma, ent_coef=ent_coef, max_grad_norm=max_grad_norm,
            deterministic_eval=deterministic_eval, optimizer=optimizer, device=device,
        )
        self.critic = critic
        self.gae_lambda = gae_lambda
        self.vf_coef = vf_coef
        self.adv_norm = adv_norm
        self.ret_norm = ret_norm

    def _ret_stats(self) -> dict[str, torch.Tensor]:
        if not self.ret_norm:
            return {}
        return dict(
            ret_mean=torch.zeros((), device=self.device),
            ret_var=torch.ones((), device=self.device),
            ret_count=torch.full((), 1e-4, device=self.device),
        )

    def init(self, generator: torch.Generator) -> OnPolicyTrainState:
        actor = fresh_copy(self.actor, self.device, generator)
        critic = fresh_copy(self.critic, self.device, generator)
        params = [*actor.parameters(), *critic.parameters()]
        return OnPolicyTrainState(actor=actor, critic=critic, optimizer=self._optimizer(params, self.lr),
                                  **self._ret_stats())

    def values(self, critic: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        """The critic's values of ``obs`` (``critic`` is ``ts.critic``, the
        counterpart of the JAX package's critic parameters)."""
        return critic(obs)

    # -- rollout processing ------------------------------------------------
    def _ret_scale(self, ts: OnPolicyTrainState) -> torch.Tensor:
        return torch.sqrt(ts.ret_var + 1e-8)

    @torch.no_grad()
    def _gae(self, ts: OnPolicyTrainState, traj: Batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(v_pred, adv, unnormalised returns)`` over ``[T, N]``;
        ``v_pred`` is the critic's own output, for value clipping."""
        T, N = traj["rew"].shape
        v_pred = ts.critic(traj["obs"].flatten(0, 1)).view(T, N)
        v_next = ts.critic(traj["obs_next"].flatten(0, 1)).view(T, N)
        v, vn = v_pred, v_next
        if self.ret_norm:
            scale = self._ret_scale(ts)
            v, vn = v * scale, vn * scale
        done = traj["terminated"] | traj["truncated"]
        adv, ret = gae_advantages(traj["rew"], v, vn, traj["terminated"], done, self.gamma, self.gae_lambda)
        return v_pred, adv, ret

    def process_rollout(self, ts: OnPolicyTrainState, traj: Batch) -> Batch:
        v_pred, adv, ret = self._gae(ts, traj)
        if self.ret_norm:
            ret = ret / self._ret_scale(ts)
        return self._flatten(Batch(obs=traj["obs"], act=traj["act"], adv=adv, ret=ret, v_s=v_pred,
                                   logp_old=traj["policy"]["log_prob"]))

    def update_rollout_stats(self, ts: OnPolicyTrainState, traj: Batch) -> OnPolicyTrainState:
        if not self.ret_norm:
            return ts
        _, _, ret = self._gae(ts, traj)
        b_mean, b_var, b_count = ret.mean(), ret.var(correction=0), float(ret.numel())
        delta = b_mean - ts.ret_mean
        total = ts.ret_count + b_count
        new_mean = ts.ret_mean + delta * b_count / total
        m2 = ts.ret_var * ts.ret_count + b_var * b_count + delta**2 * ts.ret_count * b_count / total
        ts.ret_mean, ts.ret_var, ts.ret_count = new_mean, m2 / total, total
        return ts

    # -- learning -------------------------------------------------------------
    def _policy_loss(self, logp, ent, mb, adv):
        return -(logp * adv).mean()

    def _value_loss(self, v, mb):
        return ((mb["ret"] - v) ** 2).mean()

    def _normalized_adv(self, mb: Batch) -> torch.Tensor:
        adv = mb["adv"]
        if self.adv_norm:
            adv = (adv - adv.mean()) / (_population_std(adv) + 1e-8)
        return adv

    def learn(self, ts: OnPolicyTrainState, mb: Batch, generator: torch.Generator | None = None):
        adv = self._normalized_adv(mb)
        logp, ent = self._log_prob_entropy(ts.actor(mb["obs"]), mb["act"])
        v = ts.critic(mb["obs"])
        pl = self._policy_loss(logp, ent, mb, adv)
        vl = self._value_loss(v, mb)
        el = ent.mean()
        loss = pl + self.vf_coef * vl - self.ent_coef * el
        self._apply_gradients(ts, loss)
        ts.step += 1
        return ts, {"loss": loss.detach(), "policy_loss": pl.detach(), "value_loss": vl.detach(),
                    "entropy": el.detach()}
