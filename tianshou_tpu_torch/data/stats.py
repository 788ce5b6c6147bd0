"""End-of-run summary (port of ``InfoStats`` in ``tianshou_tpu/data/stats.py``)."""

from __future__ import annotations

import dataclasses

__all__ = ["InfoStats"]


@dataclasses.dataclass
class InfoStats:
    gradient_step: int
    env_step: int
    epoch: int
    best_reward: float
    best_reward_std: float
    duration: float
    train_time: float = 0.0
    stop_triggered: bool = False
    last_metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def env_steps_per_sec(self) -> float:
        return self.env_step / self.duration if self.duration > 0 else 0.0
