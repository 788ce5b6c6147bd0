"""Launchers of experiment collections, tolerant of failing runs (port of
``tianshou_tpu/evaluation/launcher.py``).  ``joblib`` is imported only by
:class:`JoblibExpLauncher`'s ``launch``."""

from __future__ import annotations

import dataclasses
import traceback
from collections.abc import Sequence
from typing import Any

__all__ = ["LaunchResult", "ExpLauncher", "SequentialExpLauncher", "JoblibExpLauncher"]


@dataclasses.dataclass
class LaunchResult:
    successes: list[Any]
    failures: list[tuple[int, str]]


class ExpLauncher:
    def _safe_execute(self, idx: int, experiment) -> tuple[Any | None, str | None]:
        """One run; a failure is returned as its traceback."""
        try:
            return experiment.run(name=f"seed_{experiment.config.seed}"), None
        except Exception:
            return None, traceback.format_exc()

    def launch(self, experiments: Sequence[Any]) -> LaunchResult:
        raise NotImplementedError


class SequentialExpLauncher(ExpLauncher):
    def launch(self, experiments: Sequence[Any]) -> LaunchResult:
        successes, failures = [], []
        for i, exp in enumerate(experiments):
            result, err = self._safe_execute(i, exp)
            if err is None:
                successes.append(result)
            else:
                failures.append((i, err))
        return LaunchResult(successes, failures)


class JoblibExpLauncher(ExpLauncher):
    """Runs in worker processes through joblib.  Each worker starts its own
    PyTorch; on one card prefer ``n_jobs=1``, or experiments on the CPU."""

    def __init__(self, n_jobs: int = 1, backend: str = "loky"):
        self.n_jobs = n_jobs
        self.backend = backend

    def launch(self, experiments: Sequence[Any]) -> LaunchResult:
        from joblib import Parallel, delayed

        out = Parallel(n_jobs=self.n_jobs, backend=self.backend)(
            delayed(self._safe_execute)(i, e) for i, e in enumerate(experiments)
        )
        successes = [r for r, err in out if err is None]
        failures = [(i, err) for i, (r, err) in enumerate(out) if err is not None]
        return LaunchResult(successes, failures)
