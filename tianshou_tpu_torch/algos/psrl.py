"""PSRL: posterior sampling for tabular reinforcement learning (port of
``tianshou_tpu/algos/psrl.py``).

The state holds a Dirichlet posterior over transitions (pseudo-counts
``[S, A, S]`` starting at ``prior_count``) and the reward sums and counts
``[S, A]`` (the reward model is their mean).  A :meth:`PSRL.learn` adds a
minibatch's transitions to the counts, samples one transition model from
the posterior with the state's own generator
(``torch._sample_dirichlet``: ``torch.distributions.Dirichlet.sample``
takes no generator), runs ``vi_iters`` steps of value iteration on it on
the device, and acts greedily on the result.  It trains through the
on-policy trainer (its ``process_rollout`` only flattens the rollout) and
has no parameters and no optimizer.
"""

from __future__ import annotations

import dataclasses

import torch

from tianshou_tpu_torch.algos.base import Algorithm
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.utils.device import fork_generator, resolve_device

__all__ = ["PSRL", "PSRLTrainState"]


@dataclasses.dataclass
class PSRLTrainState:
    trans_counts: torch.Tensor  # [S, A, S] Dirichlet pseudo-counts
    rew_sum: torch.Tensor  # [S, A]
    rew_count: torch.Tensor  # [S, A]
    policy_table: torch.Tensor  # [S] greedy action of each state
    value_table: torch.Tensor  # [S]
    generator: torch.Generator  # the posterior's draws
    step: int = 0


class PSRL(Algorithm):
    def __init__(
        self,
        num_states: int,
        action_space: Discrete,
        *,
        gamma: float = 0.95,
        prior_count: float = 1.0,
        vi_iters: int = 100,
        eps_explore: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        self.num_states = num_states
        self.action_space = action_space
        self.num_actions = action_space.n
        self.gamma = gamma
        self.prior_count = prior_count
        self.vi_iters = vi_iters
        self.eps_explore = eps_explore
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> PSRLTrainState:
        """The prior; the posterior's generator is forked from
        ``generator``."""
        S, A, dev = self.num_states, self.num_actions, self.device
        return PSRLTrainState(
            trans_counts=torch.full((S, A, S), float(self.prior_count), device=dev),
            rew_sum=torch.zeros((S, A), device=dev),
            rew_count=torch.zeros((S, A), device=dev),
            policy_table=torch.zeros((S,), dtype=torch.int64, device=dev),
            value_table=torch.zeros((S,), device=dev),
            generator=fork_generator(generator),
        )

    @torch.no_grad()
    def act(self, ts: PSRLTrainState, obs, generator, explore, explore_param=0.0):
        a = ts.policy_table[obs.reshape(-1).to(torch.int64)]
        if explore and self.eps_explore > 0:
            rand = torch.randint(0, self.num_actions, a.shape, generator=generator, device=a.device)
            take = torch.rand(a.shape, generator=generator, device=a.device) < self.eps_explore
            a = torch.where(take, rand, a)
        return a

    def _resample_and_plan(self, ts: PSRLTrainState, transitions: torch.Tensor | None = None) -> PSRLTrainState:
        """Sample a transition model (``transitions [S, A, S]`` in place of
        the draw) and value-iterate on it."""
        P = torch._sample_dirichlet(ts.trans_counts, generator=ts.generator) if transitions is None else transitions
        R = ts.rew_sum / torch.clamp(ts.rew_count, min=1.0)
        v = torch.zeros((self.num_states,), device=R.device)
        for _ in range(self.vi_iters):
            v = (R + self.gamma * torch.einsum("sat,t->sa", P, v)).amax(dim=-1)
        q = R + self.gamma * torch.einsum("sat,t->sa", P, v)
        ts.policy_table = q.argmax(dim=-1)
        ts.value_table = v
        ts.step += 1
        return ts

    def process_rollout(self, ts: PSRLTrainState, traj: Batch) -> Batch:
        out = Batch(obs=traj["obs"], act=traj["act"], rew=traj["rew"], obs_next=traj["obs_next"])
        return tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), out)

    @torch.no_grad()
    def learn(self, ts: PSRLTrainState, mb: Batch, generator: torch.Generator | None = None,
              transitions: torch.Tensor | None = None):
        """The minibatch into the posterior, then a sampled model's plan;
        ``transitions`` in place of the Dirichlet draw."""
        s = mb["obs"].reshape(-1).to(torch.int64)
        a = mb["act"].reshape(-1).to(torch.int64)
        s_next = mb["obs_next"].reshape(-1).to(torch.int64)
        ones = torch.ones(s.shape, device=s.device)
        ts.trans_counts.index_put_((s, a, s_next), ones, accumulate=True)
        ts.rew_sum.index_put_((s, a), mb["rew"].reshape(-1).to(torch.float32), accumulate=True)
        ts.rew_count.index_put_((s, a), ones, accumulate=True)
        ts = self._resample_and_plan(ts, transitions)
        return ts, {"value_mean": ts.value_table.mean()}
