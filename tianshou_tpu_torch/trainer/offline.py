"""Offline trainer: gradient steps from a static buffer, no collection (port
of ``tianshou_tpu/trainer/offline.py``).

An epoch is ``update_per_epoch`` updates in supersteps of
``updates_per_superstep`` (the off-policy trainer's
:func:`~tianshou_tpu_torch.trainer.offpolicy.build_update_scan`: one
presample feeds the updates of an algorithm that factors its update, any
other samples its own batch each update), then a test phase through the
test collector, the device :class:`~tianshou_tpu_torch.collect.collector.Collector`
or a :class:`~tianshou_tpu_torch.collect.host_collector.HostCollector`.
The algorithm's ``prepare_offline`` (CalQL's calibration returns) runs
once, eagerly, before the first update.  :meth:`OfflineTrainer._build_superstep`
is the eager superstep and :meth:`OfflineTrainer._compile_superstep` its
compiled form, which ``run`` launches: on CUDA a
:class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` that replays CUDA
graphs of it (one a pattern of TD3BC's delayed actor, the pattern's first
superstep its capture's warm-up) over the train state and the dataset's
buffer state as static state, the dataset never copied; on the CPU the
eager superstep itself.  The test phase between epochs runs eagerly and
draws from the same generator.  The metrics stay on the device and are read
once an epoch.  ``env_step`` is ``gradient_step * batch_size``, the
reference's accounting.  A ``logger`` gets each epoch's last metrics in its
update scope and the test results, both at the gradient step, as in the
JAX package, which has no checkpoint hooks here either.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import Any

import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.trainer.loop import SuperstepStep, run_epochs
from tianshou_tpu_torch.trainer.offpolicy import build_update_scan
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device
from tianshou_tpu_torch.utils.graphs import compile_step

__all__ = ["OfflineTrainer"]


class _UpdateLog:
    """The logger as the offline epoch loop writes to it: each epoch's
    metrics in the update scope, and every log at the gradient step (the
    loop's env step, updates times the batch, over the batch size)."""

    def __init__(self, logger, batch_size: int):
        self.logger, self.batch_size = logger, batch_size

    def log_train_data(self, data: dict, step: int) -> None:
        metrics = {k: v for k, v in data.items() if k != "env_step"}
        self.logger.log_update_data(metrics, step // self.batch_size)

    def log_test_data(self, data: dict, step: int) -> None:
        self.logger.log_test_data(data, step // self.batch_size)


class OfflineTrainer:
    def __init__(
        self,
        algo: Algorithm,
        buffer: ReplayBuffer,
        buffer_state: ReplayBufferState,
        test_collector,
        *,
        max_epoch: int,
        update_per_epoch: int,
        batch_size: int = 256,
        episode_per_test: int = 10,
        updates_per_superstep: int = 100,
        stop_fn: Callable[[float], bool] | None = None,
        logger: Any | None = None,
        seed: int = 0,
        save_best_fn: Callable[[TrainState], None] | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        for what, dev in (("algorithm", algo.device), ("test collector", test_collector.device),
                          ("buffer state", buffer_state.cursor.device)):
            # a tensor's device names its index ("cuda:0"), a resolved
            # "cuda" does not
            if dev.type != self.device.type or None not in (dev.index, self.device.index) and dev != self.device:
                raise ValueError(f"trainer on {self.device} but {what} on {dev}")
        self.algo = algo
        self.buffer = buffer
        self.buffer_state = buffer_state
        self.test_collector = test_collector
        self.max_epoch = max_epoch
        self.update_per_epoch = update_per_epoch
        self.batch_size = batch_size
        self.episode_per_test = episode_per_test
        self.updates_per_superstep = min(updates_per_superstep, update_per_epoch)
        self.stop_fn = stop_fn
        self.logger = logger
        self.seed = seed
        self.save_best_fn = save_best_fn
        # the superstep the last run() launched (_compile_superstep)
        self.compiled_superstep = None

    def _build_superstep(self):
        """``superstep(ts, bstate, generator) -> (ts, bstate, mean metrics)``."""
        return build_update_scan(self.algo, self.buffer, self.batch_size, self.updates_per_superstep)

    def _compile_superstep(self, ts, bstate):
        """The superstep ``run`` launches (the JAX package's compiled
        superstep), called ``(ts, cstate, bstate, generator, explore_param)
        -> (ts, cstate, bstate, None, metrics)`` with ``cstate = ()`` (an
        offline superstep collects nothing; ``explore_param`` is unused):
        on CUDA a :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep`
        over :meth:`_build_superstep` with ``ts`` and ``bstate`` as its
        static state and a graph per pattern of the algorithm's host-keyed
        branches (:meth:`Algorithm.update_pattern`), each captured after
        the pattern's first call runs eagerly as its warm-up; each call
        takes and returns that state, whose tensors the next call
        overwrites.  A trainer on the CPU gets the eager superstep in the
        same form."""
        superstep = self._build_superstep()

        def step(ts, cstate, bstate, generator, explore_param):
            ts, bstate, metrics = superstep(ts, bstate, generator)
            return ts, cstate, bstate, None, metrics

        k = self.updates_per_superstep
        return compile_step(step, self.device, ts, (), bstate, key=lambda: self.algo.update_pattern(ts, k),
                            name="offline.superstep")

    def run(self) -> InfoStats:
        """Training in epochs (:func:`~tianshou_tpu_torch.trainer.loop.run_epochs`)
        of one step each: the epoch's supersteps and their one metric read,
        logged at the gradient step in the update scope."""
        t_start = time.time()
        gen = make_generator(self.seed, self.device)
        ts = self.algo.init(fork_generator(gen))
        bstate = self.buffer_state
        prepare = getattr(self.algo, "prepare_offline", None)
        if prepare is not None:
            bstate = prepare(self.buffer, bstate)
        superstep = self.compiled_superstep = self._compile_superstep(ts, bstate)
        k = self.updates_per_superstep
        launches = -(-self.update_per_epoch // max(k, 1))  # supersteps until the epoch's updates are done
        epoch_steps = launches * k * self.batch_size  # the reference's env steps: updates x batch
        step = SuperstepStep(superstep, ts, (), bstate, gen, env_steps=epoch_steps, grad_steps=launches * k,
                             launches=launches)

        def test(ts) -> tuple[float, float]:
            stats = self.test_collector.collect_episodes(ts, gen, self.episode_per_test, explore=False)
            return stats.returns_mean, stats.returns_std

        logger = _UpdateLog(self.logger, self.batch_size) if self.logger is not None else None
        info, _ = run_epochs(step, test, max_epoch=self.max_epoch, step_per_epoch=epoch_steps, t_start=t_start,
                             desc="offline", logger=logger, save_epochs=False, save_best_fn=self.save_best_fn,
                             stop_fn=self.stop_fn)
        self.train_state = step.ts
        return info
