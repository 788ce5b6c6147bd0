"""Running statistics (port of ``tianshou_tpu/utils/statistics.py``).

``MovAvg`` and ``RunningMeanStd`` live on the host (float64 numpy).
``RunningMeanStdState`` with ``rms_init``/``rms_update``/``rms_normalize``
is the device-side counterpart, carried in an env's state
(:class:`~tianshou_tpu_torch.envs.norm.NormObsVectorEnv`): its count starts
at 1e-4, and a batch's variance is the population variance.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["MovAvg", "RunningMeanStd", "RunningMeanStdState", "rms_init", "rms_update", "rms_normalize"]


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

    def mean(self) -> float:
        return self.get()

    def std(self) -> float:
        return float(np.std(self.cache)) if self.cache else 0.0


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


class RunningMeanStdState(NamedTuple):
    """Running statistics as device tensors: ``mean`` and ``var`` of the
    statistic's shape, a 0-d float32 ``count``."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def rms_init(shape: tuple[int, ...], device: str | torch.device) -> RunningMeanStdState:
    """Zero mean, unit variance, count 1e-4, filled on ``device``."""
    return RunningMeanStdState(
        mean=torch.zeros(shape, device=device),
        var=torch.ones(shape, device=device),
        count=torch.full((), 1e-4, device=device),
    )


def rms_update(state: RunningMeanStdState, batch: torch.Tensor) -> RunningMeanStdState:
    """Merge a ``[B, ...]`` batch with Chan et al.'s parallel formula."""
    batch_mean = batch.mean(dim=0)
    batch_var = batch.var(dim=0, correction=0)
    batch_count = batch.shape[0]
    delta = batch_mean - state.mean
    total = state.count + batch_count
    new_mean = state.mean + delta * batch_count / total
    m2 = state.var * state.count + batch_var * batch_count + delta**2 * state.count * batch_count / total
    return RunningMeanStdState(new_mean, m2 / total, total)


def rms_normalize(
    state: RunningMeanStdState, x: torch.Tensor, clip: float | None = 10.0, eps: float = 1e-8
) -> torch.Tensor:
    out = (x - state.mean) / torch.sqrt(state.var + eps)
    if clip is not None:
        out = torch.clamp(out, -clip, clip)
    return out
