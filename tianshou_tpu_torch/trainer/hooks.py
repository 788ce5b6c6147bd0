"""Trainer-side observability hooks (port of ``tianshou_tpu/trainer/hooks.py``):
moving-average metric smoothing and an optional progress bar.  Device
tracing (the JAX package's ``profile_dir``) is for a later slice."""

from __future__ import annotations

import contextlib

from tianshou_tpu_torch.utils.statistics import MovAvg

__all__ = ["MetricSmoother", "RunContext"]


class MetricSmoother:
    """Per-key moving-average smoothing of scalar train metrics."""

    def __init__(self, window: int = 100):
        self.window = window
        self._avgs: dict[str, MovAvg] = {}

    def __call__(self, metrics: dict) -> dict:
        if self.window <= 1:
            return dict(metrics)
        out = {}
        for k, v in metrics.items():
            avg = self._avgs.get(k)
            if avg is None:
                avg = self._avgs[k] = MovAvg(self.window)
            out[k] = avg.add(v)
        return out


class RunContext(contextlib.AbstractContextManager):
    """One training run's host-side instrumentation: a tqdm bar over total
    env steps when ``show_progress`` is set, else nothing."""

    def __init__(self, total_steps: int, show_progress: bool = False, desc: str = "train"):
        self.total_steps = total_steps
        self.show_progress = show_progress
        self.desc = desc
        self._bar = None

    def __enter__(self) -> "RunContext":
        if self.show_progress:
            # tqdm ships with the ``logging`` extra; a minimal install runs
            # without the bar
            try:
                from tqdm import tqdm
            except ImportError:
                tqdm = None
            if tqdm is not None:
                self._bar = tqdm(total=self.total_steps, desc=self.desc,
                                 unit="step", dynamic_ncols=True)
        return self

    def step(self, n: int, postfix: dict | None = None) -> None:
        if self._bar is not None:
            if postfix:
                self._bar.set_postfix(postfix, refresh=False)
            self._bar.update(n)

    def __exit__(self, *exc) -> None:
        if self._bar is not None:
            self._bar.close()
            self._bar = None
        return None
