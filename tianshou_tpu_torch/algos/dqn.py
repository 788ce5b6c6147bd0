"""DQN with double-Q and n-step targets (port of ``tianshou_tpu/algos/dqn.py``).

One :meth:`DQN.update_sampled` is the JAX package's fused update: the
bootstrap at the n-step terminal states (double-Q unless
``is_double=False``), :func:`nstep_return`, a weighted MSE or Huber loss,
an optimizer step, and the periodic target copy when
``step % target_update_freq == 0`` (steps counted from 1), decided on the
device as the JAX package's ``jnp.where`` decides it: every update computes
``target <- where(sync, online, target)`` from the device step count
(:func:`sync_target`).  The optimizer is ``optimizer(params)``, a factory
the caller may pass (as an optax transform is passed to the JAX package's
``DQN``), by default :func:`~tianshou_tpu_torch.algos.ddpg.adam`,
``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, the counterpart of
``optax.adam(lr)``, which a captured superstep makes capturable; a
factory's optimizer that a captured superstep steps must be capturable as
built, else the capture raises ``ValueError``
(:func:`~tianshou_tpu_torch.utils.graphs.check_capturable`).
``F.huber_loss(delta=1)`` is that of
``optax.huber_loss``.  The update writes ``|td|`` back to a prioritized
buffer, and :meth:`DQN.priority_scores` recomputes it.

Observations may be dicts ``{"obs": ..., "mask": [B, A]}``: the network
reads ``obs``, illegal actions get Q = -1e9, and exploration draws
uniformly over the legal actions.
"""

from __future__ import annotations

import copy
import itertools
from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, TrainState, sync_gradients, uniform_legal_action, write_back
from tianshou_tpu_torch.algos.ddpg import adam
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.ops.returns import nstep_return
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["DQN", "new_device_step", "optimizer_step", "sync_target", "take_action"]


def new_device_step(device: str | torch.device) -> torch.Tensor:
    """A zero update count on the device (:attr:`TrainState.device_step`)."""
    return torch.zeros((), dtype=torch.int64, device=device)


def _module_tensors(module: nn.Module):
    return itertools.chain(module.parameters(), module.buffers())


@torch.no_grad()
def sync_target(ts: TrainState, target_update_freq: int) -> None:
    """``device_step += 1``, then ``target <- online`` where ``device_step %
    target_update_freq == 0``, decided on the device: one ``torch.where``
    per tensor, then one multi-tensor copy, bitwise the copy of the online
    tensors on a sync and the target's own elsewhere."""
    if ts.device_step is None:
        raise ValueError("a periodic target copy counts updates in TrainState.device_step; build the state with "
                         "the algorithm's init()")
    ts.device_step.add_(1)
    sync = torch.remainder(ts.device_step, target_update_freq) == 0
    targets = list(_module_tensors(ts.target))
    picked = [torch.where(sync, o, t) for o, t in zip(_module_tensors(ts.online), targets)]
    torch._foreach_copy_(targets, picked)


def optimizer_step(ts: TrainState, loss: torch.Tensor, target_update_freq: int = 0, group=None) -> None:
    """The optimizer step on ``loss``, ``step += 1``, and with
    ``target_update_freq > 0`` the target copy where ``step %
    target_update_freq == 0`` (:func:`sync_target`, on the device).  With
    a process ``group`` the gradients are averaged over it first
    (:func:`sync_gradients`)."""
    ts.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    sync_gradients(ts.optimizer, group)
    ts.optimizer.step()
    ts.step += 1
    if target_update_freq > 0:
        sync_target(ts, target_update_freq)


def take_action(values: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """``values [B, A, ...]`` at each row's action: ``[B, ...]``."""
    return values[torch.arange(values.shape[0], device=values.device), act.to(torch.int64)]


class DQN(Algorithm):
    supports_presampled = True

    def __init__(
        self,
        network: nn.Module,
        action_space: Discrete,
        optimizer: Callable[[list[nn.Parameter]], torch.optim.Optimizer] | None = None,
        lr: float = 1e-3,
        gamma: float = 0.99,
        n_step: int = 1,
        target_update_freq: int = 0,
        is_double: bool = True,
        huber: bool = False,
        device: str | torch.device = "cuda",
    ):
        """``network`` is a template: :meth:`init` copies it onto
        ``device`` and draws its parameters.  ``optimizer`` maps the online
        parameters to their optimizer (default: Adam at ``lr``)."""
        self.network = network
        self.action_space = action_space
        self.make_optimizer = optimizer
        self.lr = lr
        self.gamma = gamma
        self.n_step = n_step
        self.target_update_freq = target_update_freq
        self.is_double = is_double
        self.huber = huber
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> TrainState:
        """Fresh parameters drawn from ``generator`` (on :attr:`device`)."""
        online = copy.deepcopy(self.network).to(self.device)
        online.reset_parameters(generator)
        if self.target_update_freq > 0:
            target = copy.deepcopy(online).requires_grad_(False)
        else:
            target = online
        if self.make_optimizer is not None:
            optimizer = self.make_optimizer(list(online.parameters()))
        else:
            optimizer = adam(online.parameters(), self.lr)
        return TrainState(online=online, target=target, optimizer=optimizer,
                          device_step=new_device_step(self.device) if self.target_update_freq > 0 else None)

    @property
    def obs_dtype(self) -> torch.dtype:
        return self.network.input_dtype

    @staticmethod
    def _action_mask(obs) -> torch.Tensor | None:
        if isinstance(obs, dict) and "mask" in obs:
            return obs["mask"].to(torch.bool)
        return None

    def q_values(self, net: nn.Module, obs) -> torch.Tensor:
        """``net``'s Q-values, -1e9 on illegal actions under a mask."""
        q = net(obs["obs"] if isinstance(obs, dict) and "obs" in obs else obs)
        mask = self._action_mask(obs)
        return q if mask is None else torch.where(mask, q, -1e9)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        q = self.q_values(ts.online, obs)
        greedy = q.argmax(dim=-1)
        if not explore:
            return greedy
        return self._epsilon_greedy(greedy, generator, explore_param, self._action_mask(obs))

    def _epsilon_greedy(self, greedy, generator, explore_param, mask=None) -> torch.Tensor:
        """``greedy`` with each action replaced, with probability
        ``explore_param``, by a uniform one (over the legal actions under
        ``mask``)."""
        if mask is None:
            rand = torch.randint(
                0, self.action_space.n, greedy.shape, generator=generator, device=greedy.device
            )
        else:
            rand = uniform_legal_action(mask, generator)
        take_rand = torch.rand(greedy.shape, generator=generator, device=greedy.device) < explore_param
        return torch.where(take_rand, rand, greedy)

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next, value_mask: torch.Tensor) -> torch.Tensor:
        """Masked bootstrap value at the n-step terminal states; with
        ``is_double`` the online network chooses the action."""
        q_t = self.q_values(ts.target, obs_next)
        if self.is_double:
            a_star = self.q_values(ts.online, obs_next).argmax(dim=-1, keepdim=True)
            q = q_t.gather(-1, a_star).squeeze(-1)
        else:
            q = q_t.max(dim=-1).values
        return q * value_mask

    def _q_and_target(self, ts: TrainState, sampled: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """The taken actions' Q-values (with their gradient) and the n-step
        targets."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        # bootstrap unless terminated
        mask = 1.0 - term["terminated"].to(torch.float32)
        q_term = self._target_q(ts, term["obs_next"], mask)
        target = nstep_return(rew_chain, done_chain, q_term, self.gamma)
        q = self.q_values(ts.online, batch["obs"])
        return q.gather(-1, batch["act"].to(torch.int64)[:, None]).squeeze(-1), target

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``generator`` is unused: the DQN update draws nothing."""
        env_idx, pos, weight = sampled[:3]
        q, target = self._q_and_target(ts, sampled)
        td = q - target
        if self.huber:
            loss = (weight * F.huber_loss(q, target, reduction="none", delta=1.0)).mean()
        else:
            loss = (weight * td.pow(2)).mean()
        td_abs = td.detach().abs()
        bstate = write_back(buffer, bstate, env_idx, pos, td_abs)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach(), "td_abs_mean": td_abs.mean()}

    @torch.no_grad()
    def priority_scores(self, ts: TrainState, sampled: tuple, generator: torch.Generator | None = None):
        """``|td|`` under ``ts``, what :meth:`update_sampled` writes back
        (``generator`` is unused: nothing is drawn)."""
        q, target = self._q_and_target(ts, sampled)
        return (q - target).abs()

    def _finish_update(self, ts: TrainState, loss: torch.Tensor) -> None:
        optimizer_step(ts, loss, self.target_update_freq, self.process_group)
