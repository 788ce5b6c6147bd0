"""Evaluation layer: launchers, rliable-style aggregation and figures (port
of ``tianshou_tpu/evaluation``)."""

from tianshou_tpu_torch.evaluation.aggregate import AggregatedResult, bootstrap_ci, iqm, performance_profile
from tianshou_tpu_torch.evaluation.launcher import (
    ExpLauncher,
    JoblibExpLauncher,
    LaunchResult,
    SequentialExpLauncher,
)
from tianshou_tpu_torch.evaluation.plots import (
    align_series,
    load_test_return_series,
    plot_iqm_curves,
    plot_performance_profiles,
)

__all__ = [
    "AggregatedResult", "ExpLauncher", "JoblibExpLauncher", "LaunchResult", "SequentialExpLauncher",
    "align_series", "bootstrap_ci", "iqm", "load_test_return_series",
    "performance_profile", "plot_iqm_curves", "plot_performance_profiles",
]
