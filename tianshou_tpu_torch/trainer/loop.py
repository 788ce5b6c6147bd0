"""The epoch loop of every trainer of the port: epochs of steps, the
in-training test, each epoch's end, early stopping, the logs and the
run's :class:`~tianshou_tpu_torch.data.stats.InfoStats`.

A trainer sets up its states and its compiled steps and hands
:func:`run_epochs` a :class:`Step`: one segment, superstep or offline
epoch a call, which returns what it did (:class:`Stepped`).  The loop owns
the counters (epoch, env step, gradient step, ``train_time``, from what
``resume_from_log`` restored), the metric smoothing, the
:class:`~tianshou_tpu_torch.trainer.hooks.RunContext` and the best reward.
An epoch ends in this order: the epoch's save, the test phase, the best
reward and ``save_best_fn``, the test's log, the stop check.  What differs
between trainers is what they pass: their step, which also says when its
metrics count and what its train time spans; a hook, or ``None`` where
they do without it; their logger (the offline trainer's logs its epochs in
the update scope); and ``save_epochs=False`` where they save no epoch.

With the tracer on (:mod:`~tianshou_tpu_torch.utils.trace`, off by
default) each step is the span ``tianshou.superstep`` with its superstep
id, the step's own spans and ``tianshou.superstep.log`` its children, and
each epoch's end the spans ``tianshou.epoch_end`` and
``tianshou.test_phase``.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.collect.collector import Collector, CollectStats
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.trainer.hooks import MetricSmoother, RunContext
from tianshou_tpu_torch.utils import trace


class Stepped(NamedTuple):
    """What one step did: the segment's stats (``None`` where it collected
    nothing or left them on the card), the host metrics it read (``None``
    where it read none), its env and gradient steps, its train time in
    seconds, the device marks' milliseconds for its ``tianshou.superstep``
    span (``None`` without), and the host metrics that count only with the
    step's train log (``None`` without): smoothed after the in-training
    test, so that a step that stops the run there leaves them out."""

    stats: CollectStats | None
    metrics: dict[str, float] | None
    env_steps: int
    grad_steps: int
    seconds: float
    marks: dict[str, float] | None = None
    logged_metrics: dict[str, float] | None = None


class Step:
    """What a trainer hands :func:`run_epochs`: ``step(epoch, env_step)``
    runs one step and returns :class:`Stepped`; ``ts``, ``cstate`` and
    ``bstate`` are the states after the last call (``None`` where the step
    keeps none); :meth:`finish` reads the metrics still on the card when
    the run ends."""

    ts = cstate = bstate = None

    def __call__(self, epoch: int, env_step: int) -> Stepped:
        raise NotImplementedError

    def finish(self) -> dict[str, float] | None:
        return None


def read_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Device metrics on the host, in one device-to-host copy."""
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist())) if metrics else {}


class SuperstepStep(Step):
    """A compiled superstep as a step, as the off-policy and offline
    trainers take it: ``param(epoch, env_step)`` (the explore parameter,
    0.0 without), ``launches`` calls of ``superstep(ts, cstate, bstate,
    generator, explore_param) -> (ts, cstate, bstate, outputs, metrics)``,
    the one host read of the last call's metrics, the device ``marks`` read
    where the tracer is on, and ``Collector.summarize`` of the outputs over
    ``summarize`` env steps (``None``: not summarized), as the spans
    ``tianshou.superstep.param``, ``.launch``, ``.host_read`` and
    ``.summarize``.  Its train time runs from the first launch to the end
    of the host read; its metrics count with its train log."""

    def __init__(self, superstep, ts, cstate, bstate, generator, *, env_steps: int, grad_steps: int,
                 param: Callable[[int, int], float] | None = None, marks: trace.DeviceMarks | None = None,
                 summarize: int | None = None, launches: int = 1):
        self.superstep, self.generator = superstep, generator
        self.ts, self.cstate, self.bstate = ts, cstate, bstate
        self.env_steps, self.grad_steps = env_steps, grad_steps
        self.param, self.marks, self.summarize, self.launches = param, marks, summarize, launches

    def __call__(self, epoch: int, env_step: int) -> Stepped:
        explore_param = 0.0
        if self.param is not None:
            with trace.span("tianshou.superstep.param"):
                explore_param = float(self.param(epoch, env_step))
        t0 = time.time()
        metrics: dict = {}
        for _ in range(self.launches):
            with trace.span("tianshou.superstep.launch"):
                self.ts, self.cstate, self.bstate, outputs, metrics = self.superstep(
                    self.ts, self.cstate, self.bstate, self.generator, explore_param)
        with trace.span("tianshou.superstep.host_read"):
            host_metrics = read_metrics(metrics)  # the one host read of the step
        seconds = time.time() - t0
        marks = self.marks.read() if self.marks is not None and trace.enabled() else None
        stats = None
        if self.summarize is not None:
            with trace.span("tianshou.superstep.summarize"):
                stats = Collector.summarize(outputs, self.summarize)
        return Stepped(stats, None, self.env_steps, self.grad_steps, seconds, marks, host_metrics)


class OnPolicySuperstep(SuperstepStep):
    """A compiled superstep as the on-policy trainers take it, as the JAX
    package's on-policy trainer does: its train time runs on to the end of
    the summary, and its metrics count as soon as they are read, before the
    in-training test."""

    def __call__(self, epoch: int, env_step: int) -> Stepped:
        t0 = time.time()
        done = super().__call__(epoch, env_step)
        return done._replace(metrics=done.logged_metrics, logged_metrics=None, seconds=time.time() - t0)


def log_train(logger, step: int, stats: CollectStats | None, metrics: dict) -> None:
    """A step's train scope at env step ``step``: the env step, the mean
    return of the episodes it finished (only when it finished some: a
    constant 0.0 between episode ends would make the curve unreadable) and
    the host metrics."""
    if logger is not None:
        returns = {"returns_mean": stats.returns_mean} if stats is not None and stats.returns.size else {}
        logger.log_train_data({"env_step": step, **returns, **metrics}, step)


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


def run_epochs(
    step: Step,
    test: Callable[[Any], tuple[float, float]],
    *,
    max_epoch: int,
    step_per_epoch: int,
    t_start: float,
    desc: str,
    logger: Any | None = None,
    save_epochs: bool = True,
    save_checkpoint_fn: Callable[[int, int, int], Any] | None = None,
    save_best_fn: Callable[[Any], None] | None = None,
    stop_fn: Callable[[float], bool] | None = None,
    test_in_train: bool = False,
    resume_from_log: bool = False,
    env_step: int = 0,
    smooth_window: int = 1,
    show_progress: bool = False,
    profile_dir: str | None = None,
) -> tuple[InfoStats, str | None]:
    """Train in epochs of ``step_per_epoch`` env steps of ``step``, from
    ``env_step`` (the warm-up's) plus the counters ``logger.restore_data``
    gives with ``resume_from_log``.  ``test(ts) -> (mean, std)`` is the test
    phase over ``step.ts``.  Each step and each test is logged at its env
    step through ``logger`` (``None``: not logged); each finished epoch is
    saved through it and ``save_checkpoint_fn`` where ``save_epochs``.
    Returns the run's ``InfoStats`` and its ``RunContext.trace_path``."""
    epoch = start_epoch = grad_step = 0
    if resume_from_log and logger is not None:
        start_epoch, restored_step, grad_step = logger.restore_data()
        env_step += restored_step
    smooth = MetricSmoother(smooth_window)
    best_reward, best_reward_std = -np.inf, 0.0
    last_metrics: dict = {}
    train_time = 0.0
    stop_triggered = False
    n_step = 0
    with RunContext((max_epoch - start_epoch) * step_per_epoch, show_progress, profile_dir, desc=desc) as rc:
        for epoch in range(start_epoch + 1, max_epoch + 1):
            steps_this_epoch = 0
            while steps_this_epoch < step_per_epoch:
                n_step += 1
                trace.set_superstep(n_step)
                with trace.span("tianshou.superstep") as span:
                    done = step(epoch, env_step)
                    train_time += done.seconds
                    if done.marks is not None:
                        span.set(**done.marks)
                    env_step += done.env_steps
                    steps_this_epoch += done.env_steps
                    grad_step += done.grad_steps
                    if done.metrics is not None:
                        last_metrics = smooth(done.metrics)
                    # in-training test: when training returns already clear
                    # the bar, confirm with a real test phase and stop early
                    stats = done.stats
                    if test_in_train and stop_fn is not None and stats.returns.size and stop_fn(stats.returns_mean):
                        rew, rew_std = test(step.ts)
                        if stop_fn(rew):
                            best_reward, best_reward_std = max(best_reward, rew), rew_std
                            stop_triggered = True
                            break
                    with trace.span("tianshou.superstep.log"):
                        if done.logged_metrics is not None:
                            last_metrics = smooth(done.logged_metrics)
                        rc.step(done.env_steps, last_metrics)
                        log_train(logger, env_step, stats, last_metrics)
            if stop_triggered:
                break
            with trace.span("tianshou.epoch_end"):
                if save_epochs:
                    save_epoch(logger, save_checkpoint_fn, epoch, env_step, grad_step)
            with trace.span("tianshou.test_phase"):
                rew, rew_std = test(step.ts)
            if rew > best_reward:
                best_reward, best_reward_std = rew, rew_std
                if save_best_fn is not None:
                    save_best_fn(step.ts)
            log_test(logger, rew, rew_std, env_step)
            if stop_fn is not None and stop_fn(rew):
                stop_triggered = True
                break
    final = step.finish()
    if final is not None:
        last_metrics = smooth(final)
    info = InfoStats(gradient_step=grad_step, env_step=env_step, epoch=epoch, best_reward=float(best_reward),
                     best_reward_std=float(best_reward_std), duration=time.time() - t_start, train_time=train_time,
                     stop_triggered=stop_triggered, last_metrics=last_metrics)
    return info, rc.trace_path
