"""Host-side running statistics (the port's copy of ``MovAvg`` from
``tianshou_tpu/utils/statistics.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["MovAvg"]


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
