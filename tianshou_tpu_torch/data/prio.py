"""Prioritized replay buffer on the device (port of
``tianshou_tpu/data/prio.py``).

Priorities live in one sum tree (:mod:`tianshou_tpu_torch.ops.segtree`) over
the flattened ``[num_envs * capacity]`` slot space.  New transitions enter
at ``max_prio ** alpha``; a TD write-back stores ``(|td| + 1e-6) ** alpha``
and moves the running extrema of the raw priorities.  Sampling is
proportional, with importance weights that keep the JAX package's (and the
reference's) semantics, quirks included:

- ``weight_norm=True``: ``p ** -beta / max_batch(p ** -beta)``, ``p`` the
  alpha-exponentiated leaf;
- ``weight_norm=False``: ``(p / min_prio) ** -beta``, where ``min_prio`` is
  the running minimum of the *raw* priorities, a lower bound that is never
  recomputed over the live leaves.

``max_prio``, ``min_prio`` and ``beta`` are 0-d tensors on the device, and
nothing here reads a value back to the host.  The tree is updated in place,
as the ring's storage is.  ``add_masked`` (and so ``merge``) writes no
priority, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.ops.segtree import segtree_draw, segtree_init, segtree_update

__all__ = ["PrioritizedReplayBuffer", "PrioritizedReplayBufferState"]


@dataclasses.dataclass
class PrioritizedReplayBufferState(ReplayBufferState):
    tree: torch.Tensor = None  # [2 * pow2(num_envs * capacity)] sum tree
    max_prio: torch.Tensor = None  # 0-d, running max of the raw priorities
    min_prio: torch.Tensor = None  # 0-d, running min of the raw priorities
    beta: torch.Tensor = None  # 0-d, the importance-sampling exponent


class PrioritizedReplayBuffer(ReplayBuffer):
    """The uniform ring plus sum-tree priorities over flat slot ids
    ``env * capacity + pos``.

    The memory options are the ring's (:class:`ReplayBuffer`): with
    ``save_only_last_obs`` and ``ignore_obs_next`` a slot holds one frame
    and the sampled slots' stacks and next stacks are rebuilt along the
    ``prev`` and ``next`` chains, as in the uniform ring.  The tree's draws
    do not apply ``sample_avail``, as the reference's prioritized buffer
    does not."""

    def __init__(
        self,
        capacity: int,
        num_envs: int = 1,
        stack_num: int = 1,
        alpha: float = 0.6,
        beta: float = 0.4,
        weight_norm: bool = True,
        save_only_last_obs: bool = False,
        ignore_obs_next: bool = False,
        sample_avail: bool = False,
    ):
        super().__init__(capacity, num_envs, stack_num, save_only_last_obs, ignore_obs_next, sample_avail)
        self.alpha = alpha
        self.init_beta = beta
        self.weight_norm = weight_norm

    def init(self, example_transition: Batch, device: str | torch.device = "cuda") -> PrioritizedReplayBufferState:
        base = super().init(example_transition, device)
        dev = base.cursor.device
        return PrioritizedReplayBufferState(
            storage=base.storage,
            cursor=base.cursor,
            size=base.size,
            tree=segtree_init(self.num_envs * self.capacity, dev),
            max_prio=torch.ones((), device=dev),
            min_prio=torch.ones((), device=dev),
            beta=torch.full((), self.init_beta, device=dev),
        )

    def add(self, state: PrioritizedReplayBufferState, transition: Batch) -> PrioritizedReplayBufferState:
        """New transitions enter at the running maximum priority."""
        segtree_update(state.tree, state.cursor, state.max_prio ** self.alpha, row_stride=self.capacity)
        return super().add(state, transition)

    def sample_with_weights(
        self, state: PrioritizedReplayBufferState, generator: torch.Generator, batch_size: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Proportional ``(env_idx, pos, weight)`` from ``batch_size``
        uniform draws of ``generator``."""
        u = torch.rand((batch_size,), generator=generator, device=state.tree.device)
        return self.sample_at(state, u)

    def sample_at(
        self, state: PrioritizedReplayBufferState, u: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`sample_with_weights` as a deterministic function of the
        uniform draws ``u`` in ``[0, 1)``."""
        env_idx, pos, p = segtree_draw(state.tree, u, self.num_envs * self.capacity, self.capacity)
        if self.weight_norm:
            # (p / p_min) ** -beta / max(...): the p_min factor cancels
            w = torch.clamp(p, min=1e-12) ** (-state.beta)
            w = w / w.max()
        else:
            w = (torch.clamp(p, min=1e-12) / state.min_prio) ** (-state.beta)
        return env_idx, pos, w

    def update_priorities(
        self,
        state: PrioritizedReplayBufferState,
        env_idx: torch.Tensor,
        pos: torch.Tensor,
        td_abs: torch.Tensor,
    ) -> PrioritizedReplayBufferState:
        """Write ``(|td_abs| + 1e-6) ** alpha`` at the sampled slots and move
        the running extrema of the raw priorities."""
        prio = td_abs.detach().abs() + 1e-6
        segtree_update(state.tree, pos, prio ** self.alpha, rows=env_idx, row_stride=self.capacity)
        return dataclasses.replace(
            state,
            max_prio=torch.maximum(state.max_prio, prio.max()),
            min_prio=torch.minimum(state.min_prio, prio.min()),
        )

    def set_beta(self, state: PrioritizedReplayBufferState, beta: float | torch.Tensor) -> PrioritizedReplayBufferState:
        """The importance-sampling exponent set to ``beta`` (annealing); a
        Python float becomes a fill on the device, not a copy."""
        if isinstance(beta, torch.Tensor):
            beta = beta.to(device=state.beta.device, dtype=torch.float32)
        else:
            beta = torch.full((), float(beta), device=state.beta.device)
        return dataclasses.replace(state, beta=beta)
