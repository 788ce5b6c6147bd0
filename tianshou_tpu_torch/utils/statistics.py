"""Host-side running statistics (the port's copies of ``MovAvg`` and
``RunningMeanStd`` from ``tianshou_tpu/utils/statistics.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["MovAvg", "RunningMeanStd"]


class MovAvg:
    """Moving average over the last ``size`` scalars, inf/nan-filtered."""

    def __init__(self, size: int = 100):
        self.size = size
        self.cache: list[float] = []

    def add(self, value) -> float:
        arr = np.asarray(value, np.float64).reshape(-1)
        self.cache.extend(float(v) for v in arr if np.isfinite(v))
        if self.size > 0 and len(self.cache) > self.size:
            self.cache = self.cache[-self.size:]
        return self.get()

    def get(self) -> float:
        return float(np.mean(self.cache)) if self.cache else 0.0


class RunningMeanStd:
    """Running mean and variance over batches, merged with Chan et al.'s
    parallel formula, in float64 on the host."""

    def __init__(self, mean=0.0, std=1.0, clip_max: float | None = 10.0, epsilon: float = 1e-8):
        self.mean = np.asarray(mean, np.float64)
        self.var = np.asarray(std, np.float64) ** 2
        self.count = 0.0
        self.clip_max = clip_max
        self.eps = epsilon

    def update(self, data: np.ndarray) -> None:
        data = np.asarray(data, np.float64)
        batch_mean = data.mean(axis=0)
        batch_var = data.var(axis=0)
        batch_count = data.shape[0]
        delta = batch_mean - self.mean
        total = self.count + batch_count
        new_mean = self.mean + delta * batch_count / total
        m2 = self.var * self.count + batch_var * batch_count + delta**2 * self.count * batch_count / total
        self.mean, self.var, self.count = new_mean, m2 / total, total

    def norm(self, data):
        out = (np.asarray(data) - self.mean) / np.sqrt(self.var + self.eps)
        if self.clip_max is not None:
            out = np.clip(out, -self.clip_max, self.clip_max)
        return out
