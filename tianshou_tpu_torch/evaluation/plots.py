"""rliable-style figures: IQM sample-efficiency curves with bootstrap
confidence bands, and performance profiles (port of
``tianshou_tpu/evaluation/plots.py``).

The statistics come from :mod:`tianshou_tpu_torch.evaluation.aggregate`
(numpy).  matplotlib and tensorboard are optional: each is imported inside
the function that needs it, and a figure without matplotlib raises an
``ImportError`` that says so.
"""

from __future__ import annotations

import os

import numpy as np

from tianshou_tpu_torch.evaluation.aggregate import bootstrap_ci, iqm, performance_profile

__all__ = ["load_test_return_series", "align_series", "plot_iqm_curves", "plot_performance_profiles"]


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:
        raise ImportError(
            "the figures need matplotlib; the numbers of tianshou_tpu_torch.evaluation.aggregate work without it"
        ) from e


def load_test_return_series(log_dir: str) -> list[tuple[int, float]]:
    """The ``test/returns_mean`` series of one experiment's tensorboard log
    directory."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    series: list[tuple[int, float]] = []
    for name in sorted(os.listdir(log_dir)):
        if not name.startswith("events"):
            continue
        acc = EventAccumulator(os.path.join(log_dir, name), size_guidance={"scalars": 0})
        acc.Reload()
        if "test/returns_mean" in acc.Tags()["scalars"]:
            series.extend((int(e.step), float(e.value)) for e in acc.Scalars("test/returns_mean"))
    series.sort()
    return series


def align_series(per_seed: list[list[tuple[int, float]]], num_points: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """Ragged per-seed ``(step, value)`` series interpolated onto a common
    env-step grid: ``(steps [T], scores [n_seeds, T])``."""
    assert per_seed and all(per_seed), "need at least one non-empty series"
    lo = max(s[0][0] for s in per_seed)
    hi = min(s[-1][0] for s in per_seed)
    grid = np.linspace(lo, hi, num_points)
    rows = []
    for s in per_seed:
        xs = np.asarray([p[0] for p in s], np.float64)
        ys = np.asarray([p[1] for p in s], np.float64)
        rows.append(np.interp(grid, xs, ys))
    return grid, np.stack(rows)


def plot_iqm_curves(
    results: dict[str, tuple[np.ndarray, np.ndarray]],
    out_path: str,
    *,
    title: str = "",
    xlabel: str = "env step",
    ylabel: str = "IQM test return",
    n_boot: int = 500,
) -> str:
    """Per-algorithm IQM of the test return over env steps with bootstrap
    bands.  ``results`` maps a label to ``(steps [T], scores [n_seeds, T])``
    (:func:`align_series`'s output).  Saves a PNG, returns its path."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for label, (steps, scores) in results.items():
        mid = np.asarray([iqm(scores[:, t]) for t in range(scores.shape[1])])
        band = np.asarray([bootstrap_ci(scores[:, t], n_boot=n_boot) for t in range(scores.shape[1])])
        ax.plot(steps, mid, label=label)
        ax.fill_between(steps, band[:, 0], band[:, 1], alpha=0.25)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_performance_profiles(
    final_scores: dict[str, np.ndarray],
    out_path: str,
    *,
    num_taus: int = 101,
    title: str = "",
) -> str:
    """P(score > tau) per algorithm over a common tau range.
    ``final_scores`` maps a label to its per-seed final scores."""
    plt = _plt()
    allv = np.concatenate([np.asarray(v).reshape(-1) for v in final_scores.values()])
    taus = np.linspace(allv.min(), allv.max(), num_taus)
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, scores in final_scores.items():
        ax.plot(taus, performance_profile(scores, taus), label=label)
    ax.set_xlabel("test return (tau)")
    ax.set_ylabel("fraction of runs > tau")
    ax.set_ylim(-0.02, 1.02)
    if title:
        ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
