"""ICM: the intrinsic curiosity module as a wrapper of an off-policy
algorithm (port of ``tianshou_tpu/algos/icm.py``).

:class:`ICMNet` encodes observations into features and holds a forward
model (features and one-hot action -> next features) and an inverse model
(features of both states -> action logits).  An :meth:`ICM.update` first
takes an Adam step of ``forward_loss_weight * forward error + (1 -
forward_loss_weight) * inverse cross-entropy`` on a batch of its own, then
runs the inner algorithm's update through a view of the buffer that adds
``reward_scale * forward error`` (under the stepped models, without a
gradient) to the rewards at sample time.  Nothing in the ring is rewritten.
The view forwards every read to the buffer and holds no storage of its own;
it supports one-step inner algorithms.  ``ICM`` overrides ``update``, so the
trainer calls it once per update.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm
from tianshou_tpu_torch.algos.ddpg import adam, apply_loss, fresh_copy
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.networks.common import MLP, _flat_dim

__all__ = ["ICM", "ICMNet", "ICMTrainState"]


class ICMNet(nn.Module):
    """Feature encoder, forward model and inverse model (discrete actions):
    ``(obs, act, obs_next) -> (forward error [B], inverse logits [B, A])``,
    the forward error ``0.5 * |phi_pred - phi(obs_next)|^2`` with no
    gradient into the target features."""

    def __init__(self, obs_shape: int | Sequence[int], hidden_sizes: Sequence[int], feature_dim: int, num_actions: int):
        super().__init__()
        self.encoder = MLP(_flat_dim(obs_shape), hidden_sizes, feature_dim)
        self.forward_head = MLP(feature_dim + num_actions, (feature_dim,), feature_dim)
        self.inverse_head = MLP(2 * feature_dim, (feature_dim,), num_actions)
        self.num_actions = num_actions

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for mlp in (self.encoder, self.forward_head, self.inverse_head):
            mlp.reset_parameters(generator)

    def forward(self, obs, act, obs_next) -> tuple[torch.Tensor, torch.Tensor]:
        phi, phi_next = self.encoder(obs), self.encoder(obs_next)
        act_oh = F.one_hot(act.to(torch.int64).reshape(-1), self.num_actions).to(phi.dtype)
        phi_pred = self.forward_head(torch.cat([phi, act_oh], dim=-1))
        logits = self.inverse_head(torch.cat([phi, phi_next], dim=-1))
        fwd_err = 0.5 * ((phi_pred - phi_next.detach()) ** 2).sum(dim=-1)
        return fwd_err, logits


@dataclasses.dataclass
class ICMTrainState:
    inner: object
    icm: nn.Module
    icm_optimizer: torch.optim.Optimizer

    @property
    def step(self) -> int:
        return self.inner.step


class _ICMBufferView(ReplayBuffer):
    """``base`` with the intrinsic reward added in :meth:`nstep_chain`.  Its
    configuration is ``base``'s; every read goes to ``base``."""

    def __init__(self, base: ReplayBuffer, icm: ICM, icm_net: nn.Module):
        super().__init__(base.capacity, base.num_envs, base.stack_num)
        self._base = base
        self._icm = icm
        self._net = icm_net

    def sample_with_weights(self, state, generator, batch_size):
        return self._base.sample_with_weights(state, generator, batch_size)

    def get(self, state, env_idx, pos, keys=None, dtypes=None):
        return self._base.get(state, env_idx, pos, keys=keys, dtypes=dtypes)

    def update_priorities(self, state, env_idx, pos, td_abs):
        return self._base.update_priorities(state, env_idx, pos, td_abs)

    def nstep_chain(self, state, env_idx, pos, n_step):
        if n_step != 1:
            raise ValueError(f"ICM's reward injection supports one-step inner algorithms, not n_step={n_step}")
        rew_chain, done_chain, term_pos = self._base.nstep_chain(state, env_idx, pos, n_step)
        tr = self._base.get(state, env_idx, pos, keys=("obs", "act", "obs_next"))
        with torch.no_grad():
            fwd_err, _ = self._net(tr["obs"], tr["act"], tr["obs_next"])
        return rew_chain + self._icm.reward_scale * fwd_err[:, None], done_chain, term_pos


class ICM(Algorithm):
    def __init__(
        self,
        inner: Algorithm,
        icm_net: ICMNet,
        *,
        lr: float = 1e-3,
        reward_scale: float = 0.01,
        forward_loss_weight: float = 0.2,
    ):
        """``icm_net`` is a template; the device is ``inner``'s."""
        self.inner = inner
        self.icm_net = icm_net
        self.action_space = inner.action_space
        self.device = inner.device
        self.lr = lr
        self.reward_scale = reward_scale
        self.forward_loss_weight = forward_loss_weight

    def init(self, generator: torch.Generator) -> ICMTrainState:
        inner_ts = self.inner.init(generator)
        icm = fresh_copy(self.icm_net, self.device, generator)
        return ICMTrainState(inner=inner_ts, icm=icm, icm_optimizer=adam(icm.parameters(), self.lr))

    def act(self, ts: ICMTrainState, obs, generator, explore, explore_param=0.0):
        return self.inner.act(ts.inner, obs, generator, explore, explore_param)

    def act_params(self, ts: ICMTrainState) -> nn.Module:
        return self.inner.act_params(ts.inner)

    def with_act_params(self, ts: ICMTrainState, module: nn.Module) -> ICMTrainState:
        return dataclasses.replace(ts, inner=self.inner.with_act_params(ts.inner, module))

    def update_pattern(self, ts: ICMTrainState, n_updates: int) -> tuple:
        return self.inner.update_pattern(ts.inner, n_updates)

    def update(self, ts: ICMTrainState, buffer: ReplayBuffer, bstate: ReplayBufferState, generator, batch_size):
        # 1. the curiosity models on a batch of their own
        env_idx, pos, _ = buffer.sample_with_weights(bstate, generator, batch_size)
        tr = buffer.get(bstate, env_idx, pos, keys=("obs", "act", "obs_next"))
        fwd_err, logits = ts.icm(tr["obs"], tr["act"], tr["obs_next"])
        inv_loss = -F.log_softmax(logits, dim=-1).gather(-1, tr["act"].to(torch.int64).reshape(-1, 1)).mean()
        fwd_loss = fwd_err.mean()
        w = self.forward_loss_weight
        loss = w * fwd_loss + (1 - w) * inv_loss
        apply_loss(ts.icm_optimizer, loss)

        # 2. the inner update on rewards with the intrinsic bonus
        view = _ICMBufferView(buffer, self, ts.icm)
        ts.inner, bstate, metrics = self.inner.update(ts.inner, view, bstate, generator, batch_size)
        return ts, bstate, {**metrics, "icm_loss": loss.detach(), "icm_forward": fwd_loss.detach(),
                            "icm_inverse": inv_loss.detach()}
