"""GAIL: PPO on a learned discriminator's reward (port of
``tianshou_tpu/algos/gail.py``).

The discriminator ``D(s, a)`` (a logit; a ``Critic``-shaped net) trains in
the on-policy trainer's ``pre_learn`` hook: ``disc_update_num`` Adam steps
a rollout, each on a minibatch of ``T * N // disc_update_num`` rollout rows
drawn with replacement and an equal batch from the static expert buffer,
minimising ``softplus(D(policy)) + softplus(-D(expert))``.  Then
:meth:`GAIL.process_rollout` replaces the env reward with
``softplus(D(s, a)) = -log sigmoid(-D)`` before PPO's GAE.  The running
return statistics (``ret_norm``) still read the env reward, as in the JAX
package.  The discriminator's accuracies stay on the device with the other
metrics.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algos.ddpg import adam, apply_loss, fresh_copy
from tianshou_tpu_torch.algos.pg import OnPolicyTrainState
from tianshou_tpu_torch.algos.ppo import PPO
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState

__all__ = ["GAIL", "GAILTrainState"]


@dataclasses.dataclass
class GAILTrainState(OnPolicyTrainState):
    disc: nn.Module | None = None
    disc_optimizer: torch.optim.Optimizer | None = None


class GAIL(PPO):
    def __init__(
        self,
        *args,
        disc_net: nn.Module,
        expert_buffer: ReplayBuffer,
        expert_buffer_state: ReplayBufferState,
        disc_lr: float = 2.5e-4,
        disc_update_num: int = 4,
        **kwargs,
    ):
        """PPO's arguments, and ``disc_net`` ((obs, act) -> logit ``[B]``, a
        template) with the expert data (on the algorithm's device)."""
        super().__init__(*args, **kwargs)
        self.disc_net = disc_net
        self.disc_lr = disc_lr
        self.disc_update_num = disc_update_num
        self.expert_buffer = expert_buffer
        self.expert_buffer_state = expert_buffer_state

    def init(self, generator: torch.Generator) -> GAILTrainState:
        base = super().init(generator)
        disc = fresh_copy(self.disc_net, self.device, generator)
        return GAILTrainState(**{f.name: getattr(base, f.name) for f in dataclasses.fields(OnPolicyTrainState)},
                              disc=disc, disc_optimizer=adam(disc.parameters(), self.disc_lr))

    @staticmethod
    def _flat(traj: Batch) -> tuple[torch.Tensor, torch.Tensor]:
        return traj["obs"].flatten(0, 1), traj["act"].flatten(0, 1)

    def pre_learn(self, ts: GAILTrainState, traj: Batch, generator: torch.Generator, draws=None):
        """The discriminator's steps on a ``[T, N]`` rollout: ``(ts,
        metrics)``.  ``draws`` is one ``(rollout rows, expert env_idx,
        expert pos)`` a step, in place of drawing them from ``generator``."""
        obs, act = self._flat(traj)
        rows = obs.shape[0]
        bsz = max(1, rows // self.disc_update_num)
        losses, acc_pi, acc_exp = [], [], []
        for i in range(self.disc_update_num):
            if draws is None:
                idx = torch.randint(0, rows, (bsz,), generator=generator, device=obs.device)
                env_idx, pos, _ = self.expert_buffer.sample_with_weights(self.expert_buffer_state, generator, bsz)
            else:
                idx, env_idx, pos = draws[i]
            exp = self.expert_buffer.get(self.expert_buffer_state, env_idx, pos, keys=("obs", "act"))
            logits_pi = ts.disc(obs[idx], act[idx])
            logits_exp = ts.disc(exp["obs"], exp["act"])
            loss = F.softplus(logits_pi).mean() + F.softplus(-logits_exp).mean()
            apply_loss(ts.disc_optimizer, loss)
            losses.append(loss.detach())
            acc_pi.append((logits_pi.detach() < 0).to(torch.float32).mean())
            acc_exp.append((logits_exp.detach() > 0).to(torch.float32).mean())
        return ts, {"disc_loss": torch.stack(losses).mean(), "acc_pi": torch.stack(acc_pi).mean(),
                    "acc_exp": torch.stack(acc_exp).mean()}

    def process_rollout(self, ts: GAILTrainState, traj: Batch) -> Batch:
        """PPO's processing of ``traj`` with the reward replaced by
        ``softplus(D(s, a))``."""
        with torch.no_grad():
            fake_rew = F.softplus(ts.disc(*self._flat(traj))).reshape(traj["rew"].shape)
        return super().process_rollout(ts, Batch({**traj, "rew": fake_rew}))
