"""Algorithm base (port of ``tianshou_tpu/algos/base.py``).

The JAX package keeps an algorithm's arrays in an immutable ``TrainState``
pytree; here :class:`TrainState` holds the online and target modules, their
optimizer and the host-side update count, and updates change them in place.
An :class:`Algorithm` stays a configuration object whose methods take the
state explicitly, so the collector and trainer read like the JAX package's.

The JAX package's ``act`` returns ``(action, extras)``; here :meth:`Algorithm.act`
returns the action alone and :meth:`Algorithm.act_with_extras` both, the
per-step policy outputs to store beside the transition (PPO's ``log_prob``).
Its default wraps ``act`` with an empty ``Batch``.  A recurrent policy
(DRQN) carries a per-env state through the rollout:
:meth:`Algorithm.init_policy_state` builds it (``()`` for a feedforward
policy, which the collector then threads at no cost) and
:meth:`Algorithm.act_with_state` acts from it and returns the next one.
:meth:`Algorithm.compute_action` acts greedily on one observation and
returns the env's action on the host.  On-policy algorithms
implement :meth:`Algorithm.process_rollout`, :meth:`Algorithm.update_rollout_stats`
and :meth:`Algorithm.learn`.
:class:`RandomPolicy` acts uniformly at random, for warm-up collection.
:func:`polyak_update` is the soft target update.

Data parallelism (``trainer/distributed.py``) reaches an update through
two attributes the distributed trainers set and clear: ``process_group``,
over which every optimizer step averages its gradients
(:func:`sync_gradients`, one ``all_reduce`` a step), and ``row_block``,
``(offset, global_rows)``, this rank's rows of the global batch: a draw
made per batch row (SAC's and TD3's action noise, IQN's fractions) is drawn
for the whole global batch from the generator every rank holds in lockstep,
and each rank takes its own rows (:meth:`Algorithm.draw_rows`), so that two
ranks compute what one process computes on the concatenated batch.  On a
``dp x ep`` mesh both come from the rank's ``dp`` group (the ranks that
hold the same critics, ``parallel/mesh.py``).  Alone, both are ``None``
and cost nothing.  :meth:`Algorithm.priority_scores`
recomputes the PER priority an update writes back.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.her import HERReplayBuffer
from tianshou_tpu_torch.data.tree import tree_leaves, tree_map
from tianshou_tpu_torch.envs.spaces import Box, Discrete, Space
from tianshou_tpu_torch.utils import trace
from tianshou_tpu_torch.utils.device import make_generator, resolve_device

__all__ = ["TrainState", "Algorithm", "RandomPolicy", "polyak_update", "sync_gradients", "uniform_legal_action",
           "write_back"]


@torch.no_grad()
def polyak_update(target: nn.Module, online: nn.Module, tau: float) -> None:
    """``target <- (1 - tau) * target + tau * online`` in place, as one
    ``torch._foreach_lerp_`` over all of ``target``'s parameters."""
    torch._foreach_lerp_(list(target.parameters()), list(online.parameters()), tau)


def sync_gradients(optimizer: torch.optim.Optimizer, group) -> None:
    """Average the gradients of ``optimizer``'s parameters over the process
    ``group`` (``None``: nothing to do): the gradients of a dtype flattened
    into one bucket, one ``all_reduce`` (sum) of it, divided by the group's
    size and copied back.  Every rank then steps from the same gradients;
    the losses are means over rows, so the average of the ranks' gradients
    is the gradient over the global batch."""
    if group is None:
        return
    grads = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for grad in grads:
        by_dtype.setdefault(grad.dtype, []).append(grad)
    size = dist.get_world_size(group)
    for same in by_dtype.values():
        flat = torch.cat([grad.reshape(-1) for grad in same])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        torch._foreach_copy_(same, [part.view_as(grad) for part, grad in zip(flat.split([g.numel() for g in same]),
                                                                               same)])


def uniform_legal_action(mask: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One action per row of ``mask [B, A]``, uniform over its True entries:
    the argmax of iid uniforms over the legal actions (the JAX package uses
    Gumbel noise, which is uniform for the same reason)."""
    u = torch.rand(mask.shape, generator=generator, device=mask.device)
    return torch.where(mask, u, -1.0).argmax(dim=-1)


def write_back(
    buffer: ReplayBuffer | None,
    bstate: ReplayBufferState,
    env_idx: torch.Tensor,
    pos: torch.Tensor,
    td_abs: torch.Tensor,
) -> ReplayBufferState:
    """An update's per-sample priorities written back to ``buffer`` (a
    no-op for uniform replay).  ``buffer`` is ``None`` for an update run
    on a batch that comes from no buffer.  The write-back is the device
    interval ``per_write_back`` (:func:`~tianshou_tpu_torch.utils.trace.interval`)."""
    if buffer is None:
        return bstate
    with trace.interval("per_write_back"):
        return buffer.update_priorities(bstate, env_idx, pos, td_abs.detach())


@dataclasses.dataclass
class TrainState:
    """Learnable state.  ``target`` is ``online`` itself for algorithms that
    keep no separate target network.  ``step`` counts updates on the host;
    ``device_step`` (a 0-d int64 tensor, for a periodic target copy) counts
    them on the device in lockstep, so that the copy is decided on the
    device, as in the JAX package, and a captured superstep needs one graph
    whatever the step."""

    online: nn.Module
    target: nn.Module
    optimizer: torch.optim.Optimizer | None
    step: int = 0
    device_step: torch.Tensor | None = None


class Algorithm:
    """Static algorithm configuration; subclasses implement :meth:`init`,
    :meth:`act` and :meth:`update_sampled`."""

    action_space: Space
    device: torch.device
    n_step: int = 1
    #: the update factors into :meth:`presample` + :meth:`update_sampled`,
    #: so the trainer gathers all of a superstep's samples in one call
    supports_presampled = False
    #: the process group every optimizer step averages its gradients over
    #: (set by the distributed trainers; ``None``: no synchronisation)
    process_group = None
    #: ``(offset, global_rows)`` of this rank's rows in the global batch, for
    #: per-row draws (set by the distributed off-policy trainer; ``None``:
    #: the local batch is the whole batch)
    row_block: tuple[int, int] | None = None

    def init(self, generator: torch.Generator) -> TrainState:
        raise NotImplementedError

    @property
    def obs_dtype(self) -> torch.dtype | None:
        """The dtype the network wants observations in (``None``: as
        stored); the presample gathers them straight into it."""
        return None

    def act(
        self,
        ts: TrainState,
        obs: torch.Tensor,
        generator: torch.Generator,
        explore: bool,
        explore_param: float = 0.0,
    ) -> torch.Tensor:
        """Batched action selection."""
        raise NotImplementedError

    def act_with_extras(
        self,
        ts: TrainState,
        obs: torch.Tensor,
        generator: torch.Generator,
        explore: bool,
        explore_param: float = 0.0,
    ) -> tuple[torch.Tensor, Batch]:
        """``(action, extras)``: the action and the per-step policy outputs
        stored with the transition under ``policy`` (empty by default)."""
        return self.act(ts, obs, generator, explore, explore_param), Batch()

    def compute_action(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None) -> Any:
        """The env's action for one observation (no batch dimension, numpy
        or tensor leaves): the greedy :meth:`act` on a batch of one, mapped
        to the action space and copied to the host, an ``int`` for a
        ``Discrete`` space, else a numpy array."""
        generator = generator if generator is not None else make_generator(0, self.device)
        obs_b = tree_map(lambda x: torch.as_tensor(x, device=self.device)[None], obs)
        out = self.map_action(self.act(ts, obs_b, generator, explore=False))[0].cpu().numpy()
        return int(out) if isinstance(self.action_space, Discrete) else np.asarray(out)

    def init_policy_state(self, num_envs: int) -> Any:
        """The per-env recurrent state the collector carries through a
        rollout and resets at episode ends; ``()`` for a feedforward
        policy."""
        return ()

    def act_with_state(
        self,
        ts: TrainState,
        obs: torch.Tensor,
        policy_state: Any,
        generator: torch.Generator,
        explore: bool,
        explore_param: float = 0.0,
    ) -> tuple[torch.Tensor, Batch, Any]:
        """``(action, extras, next policy state)``; by default
        :meth:`act_with_extras`, the state passed through unchanged."""
        act, extras = self.act_with_extras(ts, obs, generator, explore, explore_param)
        return act, extras, policy_state

    def update_pattern(self, ts: Any, n_updates: int) -> tuple:
        """The outcomes of the host-keyed branches of the next ``n_updates``
        updates from ``ts`` (TD3's and REDQ's delayed actor step, decided
        from the host update count): a captured superstep keeps one graph
        per pattern.  ``()``: no such branch."""
        return ()

    def act_params(self, ts: TrainState) -> nn.Module:
        """The module :meth:`act` reads (the host path snapshots it to act
        with the parameters from before the updates in flight)."""
        return ts.online

    def with_act_params(self, ts: TrainState, module: nn.Module) -> TrainState:
        """A shallow copy of ``ts`` that acts through ``module``; the other
        fields are shared, which is sound because :meth:`act` reads nothing
        else."""
        return dataclasses.replace(ts, online=module)

    def map_action(self, act: torch.Tensor) -> torch.Tensor:
        """The env's action for the policy's: continuous policies act in
        ``[-1, 1]``, rescaled here to the ``Box`` bounds; discrete actions
        pass through."""
        space = self.action_space
        if not isinstance(space, Box):
            return act
        lo, hi = space.low_arr(act.device), space.high_arr(act.device)
        return lo + (torch.clamp(act, -1.0, 1.0) + 1.0) * 0.5 * (hi - lo)

    # -- shared off-policy sampling ----------------------------------------
    def _sample_nstep(
        self,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        generator: torch.Generator,
        batch_size: int,
        n_step: int,
    ) -> tuple:
        """Sample and gather the n-step structure of an off-policy update:
        ``(env_idx, pos, weight, batch{obs, act}, rew_chain [B, n],
        done_chain [B, n], term{obs_next, terminated})``.

        A :class:`HERReplayBuffer` is sampled through its ``sample_her``
        (hindsight goals and rewards; one-step targets only), so that the
        algorithms stay unaware of goals; its ``batch`` holds every key of
        the rewritten transitions."""
        dt = self.obs_dtype
        if isinstance(buffer, HERReplayBuffer):
            if n_step != 1:
                raise ValueError(f"HER supports 1-step targets, not n_step={n_step}")
            env_idx, pos, weight, b = buffer.sample_her(bstate, generator, batch_size)
            if dt is not None:
                b["obs"], b["obs_next"] = b["obs"].to(dt), b["obs_next"].to(dt)
            done_chain = (b["terminated"] | b["truncated"]).to(torch.int32)[:, None]
            term = Batch(obs_next=b["obs_next"], terminated=b["terminated"])
            return env_idx, pos, weight, b, b["rew"][:, None], done_chain, term
        env_idx, pos, weight = buffer.sample_with_weights(bstate, generator, batch_size)
        batch = buffer.get(bstate, env_idx, pos, keys=("obs", "act"), dtypes={"obs": dt})
        rew_chain, done_chain, term_pos = buffer.nstep_chain(bstate, env_idx, pos, n_step)
        term = buffer.get(
            bstate, env_idx, term_pos, keys=("obs_next", "terminated"),
            dtypes={"obs_next": dt},
        )
        return env_idx, pos, weight, batch, rew_chain, done_chain, term

    def presample(
        self,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        generator: torch.Generator,
        batch_size: int,
    ) -> tuple:
        """The gather stage of an update: ``[batch_size, ...]`` leaves that
        :meth:`update_sampled` consumes."""
        return self._sample_nstep(buffer, bstate, generator, batch_size, self.n_step)

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """One gradient step from a :meth:`presample` tuple; metrics stay on
        the device.  An update that samples (SAC's actions, TD3's target
        smoothing) draws from ``generator``, the counterpart of the key the
        JAX package splits off for each update."""
        raise NotImplementedError

    def draw_rows(self, draw, rows: int, block: tuple[int, int] | None = None) -> torch.Tensor:
        """A per-row draw for ``rows`` local rows: ``draw(n)`` returns ``[n,
        ...]``.  Under a row block ``(offset, global_rows)`` (``block``, else
        :attr:`row_block`) the draw is made for all ``global_rows`` rows and
        rows ``[offset, offset + rows)`` are taken, so that each row's values
        depend on its place in the global batch, not on how the batch is
        split over ranks (the counterpart of the JAX package's ``fold_in``
        of each global row)."""
        offset, total = block or self.row_block or (0, rows)
        if (offset, total) == (0, rows):
            return draw(rows)
        return draw(total)[offset:offset + rows]

    def priority_scores(self, ts: TrainState, sampled: tuple, generator: torch.Generator | None = None):
        """The per-sample priority :meth:`update_sampled` writes back for a
        :meth:`presample` tuple, under ``ts`` (the parameters before the
        update).  ``generator`` in the state the update drew from makes the
        recompute exact for updates that draw (SAC's next actions, TD3's
        smoothing, REDQ's subset, noisy nets).  An algorithm without one
        raises, and the distributed trainer refuses it under prioritized
        replay."""
        raise NotImplementedError(f"{type(self).__name__} does not implement priority_scores()")

    def update(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        generator: torch.Generator,
        batch_size: int,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """One gradient step that samples its own batch: :meth:`presample`
        of ``batch_size`` transitions, then :meth:`update_sampled`, both
        drawing from ``generator``.  The trainer calls this once per update
        when sampling depends on the updates before it (prioritized
        replay) or when a subclass overrides it.  The draw is the device
        interval ``per_sample`` (:func:`~tianshou_tpu_torch.utils.trace.interval`)."""
        if not self.supports_presampled:
            raise NotImplementedError(f"{type(self).__name__} has no presample + update_sampled update")
        with trace.interval("per_sample"):
            sampled = self.presample(buffer, bstate, generator, batch_size)
        return self.update_sampled(ts, buffer, bstate, sampled, generator)

    # -- on-policy learning ----------------------------------------------
    def process_rollout(self, ts, traj: Batch) -> Batch:
        """Targets over a time-major ``[T, N, ...]`` rollout (advantages,
        returns, old log-probs), flattened to ``[T * N, ...]`` for minibatch
        learning."""
        raise NotImplementedError

    def update_rollout_stats(self, ts, traj: Batch):
        """Once-per-rollout state update (the running return statistics of
        return normalisation), called right after the first
        :meth:`process_rollout` of a rollout.  Default: none."""
        return ts

    def learn(self, ts, minibatch: Batch, generator: torch.Generator | None = None):
        """One gradient step on a minibatch of :meth:`process_rollout`'s
        output: ``(ts, metrics)``, the metrics on the device."""
        raise NotImplementedError


class RandomPolicy(Algorithm):
    """Uniform random actions, for warm-up collection before learning:
    uniform over the legal actions under a dict observation's ``mask``,
    uniform in ``[-1, 1]`` (the policy's scale) for a ``Box``, else
    ``action_space.sample``."""

    def __init__(self, action_space: Space, device: str | torch.device = "cuda"):
        self.action_space = action_space
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> TrainState:
        empty = nn.Module()
        return TrainState(online=empty, target=empty, optimizer=None)

    def act(self, ts, obs, generator, explore, explore_param=0.0):
        bsz = tree_leaves(obs)[0].shape[0]
        space = self.action_space
        if isinstance(obs, dict) and "mask" in obs:
            return uniform_legal_action(obs["mask"].to(torch.bool), generator)
        if isinstance(space, Box):
            u = torch.rand((bsz,) + space.shape, generator=generator, device=generator.device)
            return u * 2.0 - 1.0
        return space.sample(generator, (bsz,))
