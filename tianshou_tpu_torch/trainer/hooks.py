"""Trainer-side observability hooks (port of ``tianshou_tpu/trainer/hooks.py``):
moving-average metric smoothing, an optional progress bar and an optional
device trace of a run.

The JAX package traces with ``jax.profiler``; here ``profile_dir`` runs the
whole ``run()`` under ``torch.profiler.profile`` (host activity, and the
card's kernels when CUDA is present) and writes a Chrome trace into
``profile_dir`` on exit.  It is off by default: the profiler roughly
doubles a superstep's wall time.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from tianshou_tpu_torch.utils.statistics import MovAvg

__all__ = ["MetricSmoother", "RunContext", "log_train", "save_epoch", "log_test"]


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
    """One training run's instrumentation: a tqdm bar over total env steps
    when ``show_progress`` is set, and a ``torch.profiler`` trace of the run
    written to ``profile_dir/<desc>_<pid>_<ns>.pt.trace.json`` (its path in
    :attr:`trace_path` after the run) when ``profile_dir`` is set."""

    def __init__(self, total_steps: int, show_progress: bool = False, profile_dir: str | None = None,
                 desc: str = "train"):
        self.total_steps = total_steps
        self.show_progress = show_progress
        self.profile_dir = profile_dir
        self.desc = desc
        self.trace_path: str | None = None
        self._bar = None
        self._profiler = None

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
        if self.profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.__enter__()
        return self

    def step(self, n: int, postfix: dict | None = None) -> None:
        if self._bar is not None:
            if postfix:
                self._bar.set_postfix(postfix, refresh=False)
            self._bar.update(n)

    def __exit__(self, *exc) -> None:
        if self._profiler is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the run's last kernels end inside the trace
            self._profiler.__exit__(*exc)
            os.makedirs(self.profile_dir, exist_ok=True)
            self.trace_path = os.path.join(self.profile_dir,
                                           f"{self.desc}_{os.getpid()}_{time.time_ns()}.pt.trace.json")
            self._profiler.export_chrome_trace(self.trace_path)
            self._profiler = None
        if self._bar is not None:
            self._bar.close()
            self._bar = None
        return None


def log_train(logger, env_step: int, stats, metrics: dict) -> None:
    """A superstep's train scope: the env step, the mean return of the
    episodes it finished (only when it finished some: a constant 0.0
    between episode ends would make the curve unreadable) and the host
    metrics."""
    if logger is not None:
        returns = {"returns_mean": stats.returns_mean} if stats.returns.size else {}
        logger.log_train_data({"env_step": env_step, **returns, **metrics}, env_step)


def save_epoch(logger, save_checkpoint_fn, epoch: int, env_step: int, gradient_step: int) -> None:
    """An epoch's end: the counters through the logger, which calls
    ``save_checkpoint_fn``, or ``save_checkpoint_fn`` alone without one."""
    if logger is not None:
        logger.save_data(epoch, env_step, gradient_step, save_checkpoint_fn)
    elif save_checkpoint_fn is not None:
        save_checkpoint_fn(epoch, env_step, gradient_step)


def log_test(logger, reward: float, reward_std: float, step: int) -> None:
    if logger is not None:
        logger.log_test_data({"returns_mean": reward, "returns_std": reward_std}, step)
