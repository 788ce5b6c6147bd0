"""REDQ: randomized ensemble double Q-learning (port of
``tianshou_tpu/algos/redq.py``).

SAC's update (:class:`~tianshou_tpu_torch.algos.sac.SAC`) over an N-critic
``CriticEnsemble`` (one batched product per layer):

1. the target takes the minimum (``target_mode="mean"``: the mean) over a
   random M-subset of the N target critics;
2. the critic's Adam step on all N critics, ``step += 1``;
3. only when ``step % actor_delay == 0``: the actor's step against the mean
   of the N updated critics, then the alpha step (``auto_alpha``), as in
   the JAX package's ``lax.cond``; ``step`` counts on the host, as TD3's
   delay does;
4. the Polyak update of the target critics, every update.

The subset is the first M of a random permutation of the N critics, drawn
on the device as the argsort of N uniforms (no host sync), or injected
through ``subset`` (an ``[M]`` index tensor) for the parity tests, as the
two normal draws are through ``noise``.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.algos.base import polyak_update
from tianshou_tpu_torch.algos.ddpg import ACTrainState
from tianshou_tpu_torch.algos.sac import SAC
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState

__all__ = ["REDQ"]


class REDQ(SAC):
    def __init__(
        self,
        *args,
        ensemble_size: int = 10,
        subset_size: int = 2,
        actor_delay: int = 20,
        target_mode: str = "min",
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if not 0 < subset_size <= ensemble_size:
            raise ValueError(f"subset_size must be in [1, {ensemble_size}], got {subset_size}")
        if target_mode not in ("min", "mean"):
            raise ValueError(f"target_mode must be 'min' or 'mean', got {target_mode!r}")
        self.ensemble_size = ensemble_size
        self.subset_size = subset_size
        self.actor_delay = actor_delay
        self.target_mode = target_mode

    def draw_subset(self, generator: torch.Generator) -> torch.Tensor:
        """``[subset_size]`` distinct critic indices, uniform, on the
        generator's device."""
        u = torch.rand((self.ensemble_size,), generator=generator, device=generator.device)
        return u.argsort()[: self.subset_size]

    def update_sampled(
        self,
        ts: ACTrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
        noise: tuple[torch.Tensor, torch.Tensor] | None = None,
        subset: torch.Tensor | None = None,
    ) -> tuple[ACTrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``noise``: the ``(target, actor)`` normal pair; ``subset``: the
        target's critic indices; each in place of draws from
        ``generator``."""
        eps_target, eps_actor = self._noise(generator, sampled[2], noise)
        if subset is None:
            subset = self.draw_subset(generator)
        alpha = ts.log_alpha.detach().exp()

        def reduce_subset(q):
            q = q.index_select(0, subset)
            return torch.amin(q, dim=0) if self.target_mode == "min" else q.mean(dim=0)

        critic_loss, bstate = self._critic_step(ts, buffer, bstate, sampled, eps_target, alpha, reduce_subset)
        ts.step += 1
        if ts.step % self.actor_delay == 0:
            self._actor_step(ts, sampled[3]["obs"], eps_actor, alpha, lambda q: q.mean(dim=0))
        polyak_update(ts.target_critic, ts.critic, self.tau)
        return ts, bstate, {"critic_loss": critic_loss, "alpha": ts.log_alpha.detach().exp()}
