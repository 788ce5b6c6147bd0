"""Robust multi-seed result aggregation, rliable-style (port of
``tianshou_tpu/evaluation/aggregate.py``; numpy only).

Interquartile mean, percentile-bootstrap confidence intervals and
performance profiles over per-seed scores (Agarwal et al., "Deep RL at the
Edge of the Statistical Precipice", NeurIPS 2021).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["iqm", "bootstrap_ci", "performance_profile", "AggregatedResult"]


def iqm(scores: np.ndarray) -> float:
    """Interquartile mean over the flattened scores."""
    x = np.sort(np.asarray(scores, np.float64).reshape(-1))
    n = x.size
    lo, hi = int(np.floor(n * 0.25)), int(np.ceil(n * 0.75))
    return float(x[lo:hi].mean()) if hi > lo else float(x.mean())


def bootstrap_ci(
    scores: np.ndarray,
    statistic=iqm,
    n_boot: int = 2000,
    confidence: float = 0.95,
    seed: int = 0,
) -> tuple[float, float]:
    """Percentile bootstrap confidence interval of ``statistic`` over runs
    (axis 0)."""
    scores = np.asarray(scores, np.float64)
    if scores.ndim == 1:
        scores = scores[:, None]
    rng = np.random.default_rng(seed)
    n = scores.shape[0]
    stats = np.empty(n_boot)
    for b in range(n_boot):
        idx = rng.integers(0, n, size=n)
        stats[b] = statistic(scores[idx])
    alpha = (1.0 - confidence) / 2.0
    return float(np.quantile(stats, alpha)), float(np.quantile(stats, 1 - alpha))


def performance_profile(scores: np.ndarray, taus: np.ndarray) -> np.ndarray:
    """The fraction of runs scoring above each tau."""
    scores = np.asarray(scores, np.float64).reshape(-1)
    return np.asarray([(scores > t).mean() for t in np.asarray(taus)])


@dataclasses.dataclass
class AggregatedResult:
    """Summary of a seeded collection of runs."""

    scores: np.ndarray  # [num_runs]
    iqm: float
    ci_low: float
    ci_high: float
    mean: float
    median: float

    @classmethod
    def from_scores(cls, scores, confidence: float = 0.95) -> AggregatedResult:
        arr = np.asarray(scores, np.float64).reshape(-1)
        lo, hi = bootstrap_ci(arr, confidence=confidence)
        return cls(scores=arr, iqm=iqm(arr), ci_low=lo, ci_high=hi, mean=float(arr.mean()),
                   median=float(np.median(arr)))

    @classmethod
    def from_launch(cls, launch_result) -> AggregatedResult:
        return cls.from_scores([r.info.best_reward for r in launch_result.successes])
