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
once, before the first update.  The metrics stay on the device and are read
once an epoch.  ``env_step`` is ``gradient_step * batch_size``, the
reference's accounting.  A ``logger`` gets each epoch's last metrics in its
update scope and the test results, both at the gradient step, as in the
JAX package, which has no checkpoint hooks here either.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.trainer.hooks import log_test
from tianshou_tpu_torch.trainer.offpolicy import build_update_scan
from tianshou_tpu_torch.trainer.onpolicy import _read
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device

__all__ = ["OfflineTrainer"]


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

    def _build_superstep(self):
        """``superstep(ts, bstate, generator) -> (ts, bstate, mean metrics)``."""
        return build_update_scan(self.algo, self.buffer, self.batch_size, self.updates_per_superstep)

    def run(self) -> InfoStats:
        t_start = time.time()
        gen = make_generator(self.seed, self.device)
        ts = self.algo.init(fork_generator(gen))
        bstate = self.buffer_state
        prepare = getattr(self.algo, "prepare_offline", None)
        if prepare is not None:
            bstate = prepare(self.buffer, bstate)
        superstep = self._build_superstep()

        grad_step = epoch = 0
        best_reward, best_reward_std = -np.inf, 0.0
        last_metrics: dict = {}
        train_time = 0.0
        stop_triggered = False
        for epoch in range(1, self.max_epoch + 1):
            t0 = time.time()
            done_updates = 0
            metrics: dict = {}
            while done_updates < self.update_per_epoch:
                ts, bstate, metrics = superstep(ts, bstate, gen)
                done_updates += self.updates_per_superstep
                grad_step += self.updates_per_superstep
            last_metrics = _read(metrics)  # the one metric read of the epoch
            train_time += time.time() - t0
            if self.logger is not None:
                self.logger.log_update_data(last_metrics, grad_step)
            test = self.test_collector.collect_episodes(ts, gen, self.episode_per_test, explore=False)
            rew, rew_std = test.returns_mean, test.returns_std
            if rew > best_reward:
                best_reward, best_reward_std = rew, rew_std
                if self.save_best_fn is not None:
                    self.save_best_fn(ts)
            log_test(self.logger, rew, rew_std, grad_step)
            if self.stop_fn is not None and self.stop_fn(rew):
                stop_triggered = True
                break

        self.train_state = ts
        return InfoStats(
            gradient_step=grad_step,
            env_step=grad_step * self.batch_size,
            epoch=epoch,
            best_reward=float(best_reward),
            best_reward_std=float(best_reward_std),
            duration=time.time() - t_start,
            train_time=train_time,
            stop_triggered=stop_triggered,
            last_metrics=last_metrics,
        )
