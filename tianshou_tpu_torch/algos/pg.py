"""REINFORCE with Monte-Carlo returns (port of ``PG`` in
``tianshou_tpu/algos/pg.py``), and the state and optimizer step that every
on-policy algorithm of the port shares.

The distribution follows the action space: categorical over the actor's
logits for ``Discrete``, a diagonal Gaussian over its ``(mu, sigma)`` for
``Box``.  Sampling is a deterministic function of drawn noise
(:meth:`PG._noise` draws Gumbel or normal noise from the generator), so the
parity tests can feed the JAX package's own draws.  Acting records the
sample's ``log_prob`` as the step's policy extras.

The optimizer step is optax's ``chain(clip_by_global_norm(max_grad_norm),
adam(lr))``: the gradients are scaled by ``max_norm / max(norm, max_norm)``
(optax's form, not ``torch.nn.utils.clip_grad_norm_``'s ``max_norm / (norm +
1e-6)``), then ``torch.optim.Adam`` steps.  ``lr`` may be a schedule, the
learning rate of update ``k`` counted from 0 (:func:`linear_schedule` is
``optax.linear_schedule``), as ``optax.adam(schedule)`` counts: the count
is ``OnPolicyTrainState.lr_count``, a 0-d tensor on the device, and each
parameter group's learning rate a 0-d float32 tensor there, written in
place from the count at every update, so that a CUDA graph of the learning
advances it (on CUDA the optimizer is made capturable when it is built: a
non-capturable Adam reads a tensor learning rate on the host).
``optimizer`` builds another optimizer over the parameters in place of
Adam; a schedule sets its learning rate too.  :class:`ScheduledAdam` is
``optax.adam(schedule)`` counted by its own steps, for an optimizer that
steps more than once an update (a critic's).  Every statistic over a minibatch (the return
normalisation here, the advantage normalisation of A2C and PPO) uses the
population standard deviation, as numpy's ``std``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence

import torch
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm
from tianshou_tpu_torch.algos.ddpg import adam, fresh_copy
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.ops.dist import (
    categorical_entropy,
    categorical_log_prob,
    categorical_sample,
    normal_entropy,
    normal_log_prob,
    normal_sample,
    standard_gumbel,
    standard_normal,
)
from tianshou_tpu_torch.ops.returns import discounted_returns
from tianshou_tpu_torch.utils.device import resolve_device
from tianshou_tpu_torch.utils.graphs import init_optimizer_state, prepare_optimizer

__all__ = ["OnPolicyTrainState", "PG", "ScheduledAdam", "clip_by_global_norm_", "linear_schedule"]


@dataclasses.dataclass
class OnPolicyTrainState:
    """On-policy state.  ``critic`` is ``None`` for PG; ``ret_mean``,
    ``ret_var`` and ``ret_count`` (0-d tensors) are the running statistics
    of the unnormalised returns, kept with ``ret_norm`` by the algorithms
    with a critic.  ``step`` counts updates on the host; ``lr_count`` (a
    0-d int64 tensor, with a learning-rate schedule) counts them on the
    device, for the schedule."""

    actor: nn.Module
    critic: nn.Module | None
    optimizer: torch.optim.Optimizer
    step: int = 0
    ret_mean: torch.Tensor | None = None
    ret_var: torch.Tensor | None = None
    ret_count: torch.Tensor | None = None
    lr_count: torch.Tensor | None = None

    @torch.no_grad()
    def load(self, state: dict) -> None:
        """Take the parameters and return statistics of
        :func:`~tianshou_tpu_torch.networks.convert.onpolicy_state_from_flax`'s
        result; the optimizer's moments are left as they are."""
        self.actor.load_state_dict(state["actor"])
        if self.critic is not None:
            self.critic.load_state_dict(state["critic"])
        for name in ("ret_mean", "ret_var", "ret_count"):
            if getattr(self, name) is not None:
                getattr(self, name).copy_(state[name])


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``max_norm / max(global_norm, max_norm)``
    (``optax.clip_by_global_norm``), without a host read."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    torch._foreach_mul_(list(grads), max_norm / torch.clamp(norm, min=max_norm))


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """``optax.linear_schedule``: ``init_value`` at update 0, linearly to
    ``end_value`` at ``transition_steps``, constant after.  The count is an
    ``int`` (a float result) or a tensor (a tensor on its device, in
    float32 as optax computes it, with ``clamp``, so that no value is read
    on the host)."""

    def schedule(count):
        if isinstance(count, torch.Tensor):
            frac = 1 - torch.clamp(count, 0, transition_steps) / transition_steps
        else:
            frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _tensor_lr(optimizer: torch.optim.Optimizer, device: torch.device) -> torch.optim.Optimizer:
    """``optimizer`` with each group's learning rate a 0-d float32 tensor
    on ``device``, which a schedule writes in place; on CUDA made ready for
    a CUDA graph now (:func:`~tianshou_tpu_torch.utils.graphs.prepare_optimizer`:
    the port's Adam becomes capturable, since a non-capturable one reads a
    tensor learning rate on the host)."""
    for group in optimizer.param_groups:
        group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float32, device=device)
    if device.type == "cuda":
        prepare_optimizer(optimizer)
    return optimizer


class ScheduledAdam(torch.optim.Adam):
    """``optax.adam(schedule)``: Adam whose learning rate at its own step
    ``k`` (counted from 0) is ``schedule(k)``, evaluated from the step
    count that Adam keeps beside each parameter (on the device on CUDA,
    where it is built capturable) into its tensor learning rate by a step
    pre-hook, which a copy registers again."""

    def __init__(self, params, schedule: Callable):
        params = list(params)
        device = params[0].device
        super().__init__(params, lr=float(schedule(0)), betas=(0.9, 0.999), eps=1e-8,
                         capturable=device.type == "cuda")
        self.schedule = schedule
        _tensor_lr(self, device)
        init_optimizer_state(self)
        self.register_step_pre_hook(ScheduledAdam._set_lr)

    def __getstate__(self) -> dict:
        return {**super().__getstate__(), "schedule": self.schedule}

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        self.register_step_pre_hook(ScheduledAdam._set_lr)

    @staticmethod
    @torch.no_grad()
    def _set_lr(optimizer: ScheduledAdam, args, kwargs) -> None:
        for group in optimizer.param_groups:
            group["lr"].copy_(optimizer.schedule(optimizer.state[group["params"][0]]["step"]))


def _population_std(x: torch.Tensor) -> torch.Tensor:
    return x.std(correction=0)


class PG(Algorithm):
    def __init__(
        self,
        actor: nn.Module,
        action_space: Box | Discrete,
        *,
        lr: float | Callable[[int], float] = 1e-3,
        gamma: float = 0.99,
        ret_norm: bool = False,
        ent_coef: float = 0.0,
        max_grad_norm: float | None = None,
        deterministic_eval: bool = True,
        optimizer: Callable[[list[nn.Parameter]], torch.optim.Optimizer] | None = None,
        device: str | torch.device = "cuda",
    ):
        """``actor`` (obs -> logits, or ``(mu, sigma)``) is a template:
        :meth:`init` copies it onto ``device`` and draws its parameters."""
        self.actor = actor
        self.action_space = action_space
        self.discrete = isinstance(action_space, Discrete)
        self.lr = lr
        self.make_optimizer = optimizer
        self.max_grad_norm = max_grad_norm
        self.gamma = gamma
        self.ret_norm = ret_norm
        self.ent_coef = ent_coef
        self.deterministic_eval = deterministic_eval
        self.device = resolve_device(device)

    # -- the distribution ------------------------------------------------
    def _noise(self, generator: torch.Generator, dist) -> torch.Tensor:
        """The draw a sample is made from: Gumbel noise over the logits, or a
        standard normal shaped like ``mu``."""
        if self.discrete:
            return standard_gumbel(generator, dist)
        return standard_normal(generator, dist[0])

    def _sample_logp(self, dist, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.discrete:
            a = categorical_sample(dist, noise)
            return a, categorical_log_prob(a, dist)
        mu, sigma = dist
        a = normal_sample(mu, sigma, noise)
        return a, normal_log_prob(a, mu, sigma)

    def _mode(self, dist) -> torch.Tensor:
        return torch.argmax(dist, dim=-1) if self.discrete else dist[0]

    def _log_prob_entropy(self, dist, act: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.discrete:
            return categorical_log_prob(act, dist), categorical_entropy(dist)
        mu, sigma = dist
        return normal_log_prob(act, mu, sigma), normal_entropy(sigma)

    # -- state -------------------------------------------------------------
    def _optimizer(self, params: list[nn.Parameter], lr: float | Callable[[int], float]) -> torch.optim.Optimizer:
        optimizer = self.make_optimizer(params) if self.make_optimizer is not None else adam(
            params, lr(0) if callable(lr) else lr)
        return _tensor_lr(optimizer, self.device) if callable(lr) else optimizer

    def _schedule_state(self) -> dict[str, torch.Tensor]:
        """The state's device update count, with a learning-rate schedule."""
        return dict(lr_count=torch.zeros((), dtype=torch.int64, device=self.device)) if callable(self.lr) else {}

    def init(self, generator: torch.Generator) -> OnPolicyTrainState:
        actor = fresh_copy(self.actor, self.device, generator)
        optimizer = self._optimizer(list(actor.parameters()), self.lr)
        return OnPolicyTrainState(actor=actor, critic=None, optimizer=optimizer, **self._schedule_state())

    def act_params(self, ts: OnPolicyTrainState) -> nn.Module:
        return ts.actor

    def with_act_params(self, ts: OnPolicyTrainState, module: nn.Module) -> OnPolicyTrainState:
        return dataclasses.replace(ts, actor=module)

    # -- acting --------------------------------------------------------------
    @torch.no_grad()
    def act_with_extras(self, ts, obs, generator, explore, explore_param=0.0):
        dist = ts.actor(obs)
        if not explore and self.deterministic_eval:
            return self._mode(dist), Batch()
        a, logp = self._sample_logp(dist, self._noise(generator, dist))
        return a, Batch(log_prob=logp)

    def act(self, ts, obs, generator, explore, explore_param=0.0):
        return self.act_with_extras(ts, obs, generator, explore, explore_param)[0]

    # -- learning --------------------------------------------------------------
    def _apply_gradients(self, ts: OnPolicyTrainState, loss: torch.Tensor) -> None:
        """One optimizer step on ``loss``: the gradient with respect to the
        optimizer's parameters, clipped by the global norm, with the
        schedule's learning rate for update ``ts.lr_count``, counted on the
        device."""
        params = [p for group in ts.optimizer.param_groups for p in group["params"]]
        grads = list(torch.autograd.grad(loss, params))
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.max_grad_norm)
        for p, g in zip(params, grads):
            p.grad = g
        if callable(self.lr):
            with torch.no_grad():
                lr = self.lr(ts.lr_count)
                for group in ts.optimizer.param_groups:
                    group["lr"].copy_(lr)
                ts.lr_count.add_(1)
        ts.optimizer.step()

    @staticmethod
    def _flatten(batch: Batch) -> Batch:
        return tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), batch)

    @torch.no_grad()
    def process_rollout(self, ts: OnPolicyTrainState, traj: Batch) -> Batch:
        """Discounted returns with a zero bootstrap (no critic), flattened
        to ``[T * N, ...]``."""
        rew = traj["rew"]
        done = traj["terminated"] | traj["truncated"]
        ret = discounted_returns(rew, torch.zeros_like(rew), traj["terminated"], done, self.gamma)
        return self._flatten(Batch(obs=traj["obs"], act=traj["act"], ret=ret, logp_old=traj["policy"]["log_prob"]))

    def learn(self, ts: OnPolicyTrainState, mb: Batch, generator: torch.Generator | None = None):
        ret = mb["ret"]
        if self.ret_norm:
            ret = (ret - ret.mean()) / (_population_std(ret) + 1e-8)
        logp, ent = self._log_prob_entropy(ts.actor(mb["obs"]), mb["act"])
        pg_loss = -(logp * ret).mean()
        entropy = ent.mean()
        loss = pg_loss - self.ent_coef * entropy
        self._apply_gradients(ts, loss)
        ts.step += 1
        return ts, {"loss": loss.detach(), "pg_loss": pg_loss.detach(), "entropy": entropy.detach()}
