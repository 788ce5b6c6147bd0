"""PPO: the clipped surrogate with optional dual clip and value clip (port
of ``PPO`` in ``tianshou_tpu/algos/ppo.py``).

``logp_old`` is the ``log_prob`` recorded while acting; advantages are
normalised per minibatch by default (``adv_norm=True``); with
``recompute_advantage`` the on-policy trainer processes the rollout again
before every repeat.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.algos.a2c import A2C

__all__ = ["PPO"]


class PPO(A2C):
    def __init__(
        self,
        *args,
        eps_clip: float = 0.2,
        dual_clip: float | None = None,
        value_clip: bool = False,
        adv_norm: bool = True,
        recompute_advantage: bool = False,
        **kwargs,
    ):
        if dual_clip is not None and dual_clip <= 1.0:
            raise ValueError(f"dual_clip must be above 1, got {dual_clip}")
        super().__init__(*args, adv_norm=adv_norm, **kwargs)
        self.eps_clip = eps_clip
        self.dual_clip = dual_clip
        self.value_clip = value_clip
        self.recompute_advantage = recompute_advantage

    def _policy_loss(self, logp, ent, mb, adv):
        ratio = torch.exp(logp - mb["logp_old"])
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - self.eps_clip, 1.0 + self.eps_clip) * adv
        clipped = torch.minimum(surr1, surr2)
        if self.dual_clip is not None:
            clipped = torch.where(adv < 0, torch.maximum(clipped, self.dual_clip * adv), clipped)
        return -clipped.mean()

    def _value_loss(self, v, mb):
        if self.value_clip:
            v_clip = mb["v_s"] + torch.clamp(v - mb["v_s"], -self.eps_clip, self.eps_clip)
            return torch.maximum((mb["ret"] - v) ** 2, (mb["ret"] - v_clip) ** 2).mean()
        return ((mb["ret"] - v) ** 2).mean()
