"""C51 (categorical DQN) and Rainbow (port of ``tianshou_tpu/algos/c51.py``).

The network returns ``[B, A, num_atoms]`` probabilities over a fixed support
of ``num_atoms`` atoms in ``[v_min, v_max]``.  One :meth:`C51.update_sampled`
is the JAX package's fused update:

1. the n-step target distribution: the target net's distribution at the
   n-step terminal state for the action the online net picks (double-Q) or
   the target net picks, shifted by the n-step return components and
   projected back onto the support (:meth:`C51._project`, a scatter-add
   over the atoms, float atomics on the card);
2. the weighted cross-entropy of the online distribution of the taken
   action against it, written back as the priority of each sample;
3. the Adam step and the periodic target copy (DQN's).

Rainbow is C51 on a ``C51Net(noisy=True)``: every forward of an update
draws its factorised noise, one set for the target net and one shared by
the two online forwards (on the terminal states and on the sampled ones),
and exploration comes from the weight noise alone, with no epsilon.
Acting without exploration uses the mean weights.  The noise comes from
the trainer's generator, or is injected through ``noise`` for the parity
tests.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.algos.base import TrainState, write_back
from tianshou_tpu_torch.algos.dqn import DQN, take_action
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.networks.discrete import draw_noise
from tianshou_tpu_torch.ops.returns import nstep_return_components

__all__ = ["C51", "Rainbow"]


class C51(DQN):
    def __init__(
        self,
        network,
        action_space: Discrete,
        *,
        num_atoms: int = 51,
        v_min: float = -10.0,
        v_max: float = 10.0,
        noisy_net: bool = False,
        **kwargs,
    ):
        """``network``: obs -> ``[B, A, num_atoms]`` probabilities (a
        ``C51Net``, with ``noisy=True`` when ``noisy_net``); the other
        arguments are DQN's."""
        super().__init__(network, action_space, **kwargs)
        if v_max <= v_min:
            raise ValueError(f"v_max {v_max} must exceed v_min {v_min}")
        self.num_atoms = num_atoms
        self.v_min = v_min
        self.v_max = v_max
        self.noisy_net = noisy_net
        self.support = torch.linspace(v_min, v_max, num_atoms, device=self.device)
        self.delta_z = (v_max - v_min) / (num_atoms - 1)

    def probs(self, net, obs, noise=None) -> torch.Tensor:
        """``net``'s distribution; a noisy net takes ``noise`` (``None``: its
        mean weights)."""
        return net(obs, noise) if self.noisy_net else net(obs)

    def q_from_probs(self, probs: torch.Tensor) -> torch.Tensor:
        return (probs * self.support).sum(dim=-1)

    def q_values(self, net, obs) -> torch.Tensor:
        """Expected values under the mean weights."""
        return self.q_from_probs(self.probs(net, obs))

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        """Epsilon-greedy over expected values; a noisy net explores through
        freshly drawn weight noise instead."""
        noise = draw_noise(ts.online, generator) if explore and self.noisy_net else None
        greedy = self.q_from_probs(self.probs(ts.online, obs, noise)).argmax(dim=-1)
        if not explore or self.noisy_net:
            return greedy
        return self._epsilon_greedy(greedy, generator, explore_param)

    def _project(self, target_probs, returns, discount, mask) -> torch.Tensor:
        """The categorical projection of ``Tz_j = returns + discount * mask *
        z_j`` back onto the support (Bellemare et al. 2017, algorithm 1):
        ``[B, num_atoms]``."""
        tz = returns[:, None] + discount[:, None] * mask[:, None] * self.support
        b = (torch.clamp(tz, self.v_min, self.v_max) - self.v_min) / self.delta_z
        low = torch.floor(b)
        # an integral b puts all its mass on ``low``
        frac_h = b - low
        frac_l = 1.0 - frac_h
        high = torch.clamp(torch.ceil(b), max=self.num_atoms - 1)
        m = torch.zeros_like(target_probs)
        m.scatter_add_(1, low.to(torch.int64), target_probs * frac_l)
        m.scatter_add_(1, high.to(torch.int64), target_probs * frac_h)
        return m

    def _cross_entropy(self, ts: TrainState, sampled: tuple, noise) -> torch.Tensor:
        """The per-sample cross-entropy of the taken action's distribution
        (with its gradient) against the projected n-step target; ``noise``
        the ``(target, online)`` pair (``(None, None)``: mean weights)."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        n_target, n_online = noise
        mask = 1.0 - term["terminated"].to(torch.float32)
        returns, discount = nstep_return_components(rew_chain, done_chain, self.gamma)
        with torch.no_grad():
            p_target = self.probs(ts.target, term["obs_next"], n_target)
            if self.is_double:
                a_star = self.q_from_probs(self.probs(ts.online, term["obs_next"], n_online)).argmax(dim=-1)
            else:
                a_star = self.q_from_probs(p_target).argmax(dim=-1)
            p_star = take_action(p_target, a_star)
            m = self._project(p_star, returns, discount, mask)
        p_a = take_action(self.probs(ts.online, batch["obs"], n_online), batch["act"])
        return -(m * torch.log(torch.clamp(p_a, min=1e-8))).sum(dim=-1)

    def _draw_noise(self, ts: TrainState, generator) -> tuple:
        """A noisy net's ``(target, online)`` noise: two draws from
        ``generator``, the target net's first (no noise for a plain net)."""
        if not self.noisy_net:
            return None, None
        return draw_noise(ts.target, generator), draw_noise(ts.online, generator)

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
        noise: tuple | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``noise``: a noisy net's ``(target, online)`` pair of
        :func:`draw_noise` lists, in place of two draws from ``generator``."""
        env_idx, pos, weight = sampled[:3]
        ce = self._cross_entropy(ts, sampled, noise if noise is not None else self._draw_noise(ts, generator))
        loss = (weight * ce).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, ce)
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach()}

    @torch.no_grad()
    def priority_scores(self, ts: TrainState, sampled: tuple, generator: torch.Generator | None = None,
                        noise: tuple | None = None):
        """The per-sample cross-entropy :meth:`update_sampled` writes back.
        A noisy net takes ``noise``, or draws it from ``generator`` as the
        update does (the same state gives the same noise); with neither it
        uses the mean weights, as the JAX package does without a key."""
        if noise is None:
            noise = self._draw_noise(ts, generator) if generator is not None else (None, None)
        return self._cross_entropy(ts, sampled, noise)


class Rainbow(C51):
    """C51 on a noisy network (``C51Net(noisy=True)``), with prioritized
    replay and n-step returns from the buffer and the configuration."""

    def __init__(self, network, action_space: Discrete, **kwargs):
        kwargs.setdefault("noisy_net", True)
        super().__init__(network, action_space, **kwargs)
