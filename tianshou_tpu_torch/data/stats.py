"""Statistics dataclasses (port of ``tianshou_tpu/data/stats.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tianshou_tpu_torch.utils.repr import DataclassPPrintMixin

__all__ = ["SequenceSummaryStats", "TimingStats", "InfoStats"]


@dataclasses.dataclass
class SequenceSummaryStats(DataclassPPrintMixin):
    """Mean, std, max and min of a sequence."""

    mean: float
    std: float
    max: float
    min: float

    @classmethod
    def from_sequence(cls, seq) -> SequenceSummaryStats:
        """From numbers, a numpy array or a tensor (which is copied to the
        host: call it outside a superstep)."""
        if isinstance(seq, torch.Tensor):
            seq = seq.detach().cpu().double().numpy()
        arr = np.asarray(seq, np.float64)
        if arr.size == 0:
            return cls(0.0, 0.0, 0.0, 0.0)
        return cls(float(arr.mean()), float(arr.std()), float(arr.max()), float(arr.min()))


@dataclasses.dataclass
class TimingStats(DataclassPPrintMixin):
    """Wall-clock breakdown of a run."""

    total_time: float = 0.0
    train_time: float = 0.0
    train_time_collect: float = 0.0
    train_time_update: float = 0.0
    test_time: float = 0.0
    update_speed: float = 0.0


@dataclasses.dataclass
class InfoStats(DataclassPPrintMixin):
    """End-of-run summary."""

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
