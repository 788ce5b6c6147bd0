"""Off-policy trainer: (collect -> k gradient steps) supersteps (port of the
pure-env path of ``tianshou_tpu/trainer/offpolicy.py``).

A superstep is a rollout segment into the ring buffer, then ONE presample of
``k * batch`` indices, transitions and n-step chains, then k updates on
slices of it (exact for uniform replay, whose sampling does not depend on
the updates in between).  The superstep runs eagerly and keeps its metrics
on the device; :meth:`OffPolicyTrainer.run` reads them once per superstep.
Epochs, test episodes and early stopping stay on the host, as in the JAX
package.

Not ported yet: the host-env path, the fused fine cycle, PER and the
per-update sampling branch, loggers, checkpoint hooks and device tracing.
"""

from __future__ import annotations

import time
from collections.abc import Callable

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.collect.collector import Collector, rollout_segment
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.trainer.hooks import MetricSmoother, RunContext
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device

__all__ = ["OffPolicyTrainer", "build_update_scan"]


def build_update_scan(algo: Algorithm, buffer: ReplayBuffer, batch_size: int, n_updates: int):
    """Build ``(ts, bstate, generator) -> (ts, bstate, mean_metrics)``: one
    presample of ``n_updates * batch_size`` transitions, then ``n_updates``
    updates on consecutive ``batch_size`` slices of it."""
    if not algo.supports_presampled:
        raise NotImplementedError(
            f"{type(algo).__name__} has no presampled update; per-update sampling is not ported yet"
        )

    def updates(ts: TrainState, bstate: ReplayBufferState, generator: torch.Generator):
        sampled = algo.presample(buffer, bstate, generator, n_updates * batch_size)
        views = tree_map(lambda x: x.reshape((n_updates, batch_size) + x.shape[1:]), sampled)
        history: dict[str, list[torch.Tensor]] = {}
        for i in range(n_updates):
            ts, bstate, metrics = algo.update_sampled(ts, buffer, bstate, tree_map(lambda x: x[i], views))
            for k, v in metrics.items():
                history.setdefault(k, []).append(v)
        return ts, bstate, {k: torch.stack(v).mean() for k, v in history.items()}

    return updates


class OffPolicyTrainer:
    def __init__(
        self,
        algo: Algorithm,
        train_collector: Collector,
        test_collector: Collector,
        buffer: ReplayBuffer,
        *,
        max_epoch: int,
        step_per_epoch: int,
        step_per_collect: int,
        update_per_step: float = 1.0,
        batch_size: int = 64,
        episode_per_test: int = 10,
        train_param_fn: Callable[[int, int], float] | None = None,
        test_param: float = 0.0,
        stop_fn: Callable[[float], bool] | None = None,
        warmup_steps: int = 0,
        warmup_random: bool = True,
        seed: int = 0,
        save_best_fn: Callable[[TrainState], None] | None = None,
        test_in_train: bool = False,
        show_progress: bool = False,
        smooth_window: int = 1,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        for what, dev in (("algorithm", algo.device), ("train collector", train_collector.device),
                          ("test collector", test_collector.device)):
            if dev != self.device:
                raise ValueError(f"trainer on {self.device} but {what} on {dev}")
        self.algo = algo
        self.train_collector = train_collector
        self.test_collector = test_collector
        self.buffer = buffer
        self.max_epoch = max_epoch
        self.step_per_epoch = step_per_epoch
        self.step_per_collect = step_per_collect
        self.update_per_step = update_per_step
        self.batch_size = batch_size
        self.episode_per_test = episode_per_test
        self.train_param_fn = train_param_fn or (lambda epoch, step: 0.0)
        self.test_param = test_param
        self.stop_fn = stop_fn
        self.warmup_steps = warmup_steps
        self.warmup_random = warmup_random
        self.seed = seed
        self.save_best_fn = save_best_fn
        self.test_in_train = test_in_train
        self.show_progress = show_progress
        self.smooth_window = smooth_window

        num_envs = train_collector.venv.num_envs
        # steps per env per collect segment (the reference counts total env steps)
        self.segment_len = max(1, step_per_collect // num_envs)
        self.steps_per_segment = self.segment_len * num_envs
        self.updates_per_segment = max(1, round(update_per_step * self.steps_per_segment))

    def _build_superstep(self):
        """``superstep(ts, cstate, bstate, generator, explore_param) -> (ts,
        cstate, bstate, outputs, metrics)``."""
        seg = rollout_segment(
            self.algo, self.train_collector.venv, self.buffer, self.segment_len, explore=True
        )
        updates_fn = build_update_scan(
            self.algo, self.buffer, self.batch_size, self.updates_per_segment
        )

        def superstep(ts, cstate, bstate, generator, explore_param):
            cstate, bstate, outputs = seg(ts, cstate, bstate, explore_param)
            ts, bstate, metrics = updates_fn(ts, bstate, generator)
            return ts, cstate, bstate, outputs, metrics

        return superstep

    def run(self) -> InfoStats:
        t_start = time.time()
        smooth = MetricSmoother(self.smooth_window)
        gen = make_generator(self.seed, self.device)
        g_init, g_reset = fork_generator(gen), fork_generator(gen)

        cstate = self.train_collector.reset(g_reset)
        ts = self.algo.init(g_init)
        bstate = self.buffer.init(
            self.train_collector.example_transition(ts, cstate), device=self.device
        )

        env_step = 0
        grad_step = 0
        best_reward = -np.inf
        best_reward_std = 0.0
        last_metrics: dict = {}
        train_time = 0.0

        # warm-up collection (reference start_timesteps)
        if self.warmup_steps > 0:
            warm_len = max(1, self.warmup_steps // self.train_collector.venv.num_envs)
            cstate, bstate, stats = self.train_collector.collect(
                ts, cstate, bstate, warm_len, explore=True, random=self.warmup_random,
            )
            env_step += stats.n_collected_steps

        superstep = self._build_superstep()
        stop_triggered = False
        epoch = 0
        with RunContext(self.max_epoch * self.step_per_epoch, self.show_progress, desc="offpolicy") as rc:
            for epoch in range(1, self.max_epoch + 1):
                steps_this_epoch = 0
                while steps_this_epoch < self.step_per_epoch:
                    explore_param = float(self.train_param_fn(epoch, env_step))
                    t0 = time.time()
                    ts, cstate, bstate, outputs, metrics = superstep(
                        ts, cstate, bstate, gen, explore_param
                    )
                    # the one host read of the superstep
                    host_metrics = {k: float(v) for k, v in metrics.items()}
                    train_time += time.time() - t0
                    env_step += self.steps_per_segment
                    steps_this_epoch += self.steps_per_segment
                    grad_step += self.updates_per_segment
                    stats = Collector.summarize(outputs, self.steps_per_segment)
                    # in-training test: when training returns already clear
                    # the bar, confirm with a real test phase and stop early
                    if (
                        self.test_in_train
                        and self.stop_fn is not None
                        and stats.returns.size
                        and self.stop_fn(stats.returns_mean)
                    ):
                        tt = self.test_collector.collect_episodes(
                            ts, gen, self.episode_per_test,
                            explore=False, explore_param=self.test_param,
                        )
                        if self.stop_fn(tt.returns_mean):
                            best_reward = max(best_reward, tt.returns_mean)
                            best_reward_std = tt.returns_std
                            stop_triggered = True
                            break
                    last_metrics = smooth(host_metrics)
                    rc.step(self.steps_per_segment, last_metrics)

                if stop_triggered:
                    break
                test_stats = self.test_collector.collect_episodes(
                    ts, gen, self.episode_per_test,
                    explore=False, explore_param=self.test_param,
                )
                rew, rew_std = test_stats.returns_mean, test_stats.returns_std
                if rew > best_reward:
                    best_reward, best_reward_std = rew, rew_std
                    if self.save_best_fn is not None:
                        self.save_best_fn(ts)
                if self.stop_fn is not None and self.stop_fn(rew):
                    stop_triggered = True
                    break

        self.train_state = ts
        self.collect_state = cstate
        self.buffer_state = bstate
        return InfoStats(
            gradient_step=grad_step,
            env_step=env_step,
            epoch=epoch,
            best_reward=float(best_reward),
            best_reward_std=float(best_reward_std),
            duration=time.time() - t_start,
            train_time=train_time,
            stop_triggered=stop_triggered,
            last_metrics=last_metrics,
        )
