"""On-policy trainer: (rollout -> process -> repeat x minibatch learning)
supersteps (port of ``tianshou_tpu/trainer/onpolicy.py``).

A superstep records a rollout of ``[T, N]`` transitions with the policy's
``log_prob`` (``rollout_segment(record_traj=True)``; no replay buffer), runs
the algorithm's optional ``pre_learn`` hook, :meth:`process_rollout` and
:meth:`update_rollout_stats`, then ``repeat_per_collect`` passes, each over
``M // batch_size`` minibatches of a fresh permutation of the ``M = T * N``
samples (``randperm(M)[:nmb * bs].view(nmb, bs)``).  With
``recompute_advantage`` the rollout is processed again before every pass.
The superstep runs eagerly and keeps its metrics on the device;
:meth:`OnPolicyTrainer.run` reads them once a superstep.  Epochs, test
episodes and early stopping stay on the host, as in the JAX package.

With a :class:`~tianshou_tpu_torch.collect.host_collector.HostCollector`
``run`` takes the host-env path: a segment collected from host envs, its
numpy leaves sent to the card in ONE packed copy, then the same learning.

``logger``, ``save_checkpoint_fn``, ``resume_from_log`` and ``profile_dir``
work as in :class:`~tianshou_tpu_torch.trainer.offpolicy.OffPolicyTrainer`.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.collect.collector import Collector, rollout_segment
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.trainer.hooks import MetricSmoother, RunContext, log_test, log_train, save_epoch
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device

__all__ = ["OnPolicyTrainer", "build_rollout_learn"]

#: ``(generator, M) -> [M]`` indices: the sample order of one pass
Permutation = Callable[[torch.Generator, int], torch.Tensor]


def _randperm(generator: torch.Generator, m: int) -> torch.Tensor:
    return torch.randperm(m, generator=generator, device=generator.device)


def _mean_metrics(history: dict[str, list[torch.Tensor]]) -> dict[str, torch.Tensor]:
    return {k: torch.stack(v).mean() for k, v in history.items()}


def build_rollout_learn(
    algo: Algorithm, num_samples: int, batch_size: int, repeat: int, permutation: Permutation | None = None
):
    """Build ``(ts, traj, generator) -> (ts, metrics)``: the learning part of
    a superstep over a ``[T, N]`` rollout of ``num_samples = T * N``
    transitions.  ``permutation`` (default ``randperm``) gives each pass's
    sample order; metrics are averaged over a pass's minibatches, then over
    the passes, and stay on the device."""
    bs = min(batch_size, num_samples)
    nmb = max(1, num_samples // bs)
    recompute = getattr(algo, "recompute_advantage", False)
    permutation = permutation or _randperm

    def learn(ts, traj: Batch, generator: torch.Generator):
        pre_metrics = {}
        if hasattr(algo, "pre_learn"):
            ts, pre_metrics = algo.pre_learn(ts, traj, generator)
        processed0 = algo.process_rollout(ts, traj)
        # the running return statistics take this rollout after its first
        # processing pass
        ts = algo.update_rollout_stats(ts, traj)
        passes: dict[str, list[torch.Tensor]] = {}
        for _ in range(repeat):
            processed = algo.process_rollout(ts, traj) if recompute else processed0
            idx = permutation(generator, num_samples)[: nmb * bs].view(nmb, bs)
            minibatches = tree_map(lambda x: x[idx], processed)  # one gather a leaf per pass
            history: dict[str, list[torch.Tensor]] = {}
            for i in range(nmb):
                ts, metrics = algo.learn(ts, tree_map(lambda x: x[i], minibatches), generator)
                for k, v in metrics.items():
                    history.setdefault(k, []).append(v)
            for k, v in _mean_metrics(history).items():
                passes.setdefault(k, []).append(v)
        return ts, {**_mean_metrics(passes), **pre_metrics}

    return learn


def _read(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """The metrics on the host, in one device-to-host copy."""
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist())) if metrics else {}


class OnPolicyTrainer:
    def __init__(
        self,
        algo: Algorithm,
        train_collector,
        test_collector,
        *,
        max_epoch: int,
        step_per_epoch: int,
        step_per_collect: int,
        repeat_per_collect: int = 1,
        batch_size: int = 64,
        episode_per_test: int = 10,
        stop_fn: Callable[[float], bool] | None = None,
        logger: Any | None = None,
        seed: int = 0,
        save_best_fn: Callable[[TrainState], None] | None = None,
        save_checkpoint_fn: Callable[[int, int, int], Any] | None = None,
        resume_from_log: bool = False,
        test_in_train: bool = False,
        show_progress: bool = False,
        profile_dir: str | None = None,
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
        self.max_epoch = max_epoch
        self.step_per_epoch = step_per_epoch
        self.repeat_per_collect = repeat_per_collect
        self.batch_size = batch_size
        self.episode_per_test = episode_per_test
        self.stop_fn = stop_fn
        self.logger = logger
        self.seed = seed
        self.save_best_fn = save_best_fn
        self.save_checkpoint_fn = save_checkpoint_fn
        self.resume_from_log = resume_from_log
        self.test_in_train = test_in_train
        self.show_progress = show_progress
        self.profile_dir = profile_dir
        self.trace_path: str | None = None
        self.smooth_window = smooth_window

        num_envs = train_collector.venv.num_envs
        self.segment_len = max(1, step_per_collect // num_envs)
        self.steps_per_segment = self.segment_len * num_envs
        bs = min(batch_size, self.steps_per_segment)
        self.updates_per_segment = repeat_per_collect * max(1, self.steps_per_segment // bs)

    def _build_learn(self, permutation: Permutation | None = None):
        return build_rollout_learn(self.algo, self.steps_per_segment, self.batch_size, self.repeat_per_collect,
                                   permutation)

    def _build_superstep(self, permutation: Permutation | None = None):
        """``superstep(ts, cstate, generator) -> (ts, cstate, outputs,
        metrics)``."""
        seg = rollout_segment(self.algo, self.train_collector.venv, None, self.segment_len, explore=True,
                              record_traj=True, reward_metric=self.train_collector.reward_metric)
        learn = self._build_learn(permutation)

        def superstep(ts, cstate, generator):
            cstate, _, outputs = seg(ts, cstate, None, 0.0)
            ts, metrics = learn(ts, outputs["traj"], generator)
            return ts, cstate, outputs, metrics

        return superstep

    def _host_setup(self):
        """The host path's start: ``(ts, generator, collect generator)``
        with the envs reset from the seed."""
        gen = make_generator(self.seed, self.device)
        g_init, g_collect = fork_generator(gen), fork_generator(gen)
        self.train_collector.reset(seed=self.seed)
        return self.algo.init(g_init), gen, g_collect

    def _test(self, ts, generator) -> tuple[float, float]:
        stats = self.test_collector.collect_episodes(ts, generator, self.episode_per_test, explore=False)
        return stats.returns_mean, stats.returns_std

    def run(self) -> InfoStats:
        t_start = time.time()
        smooth = MetricSmoother(self.smooth_window)
        host = getattr(self.train_collector, "is_host_collector", False)
        if host:
            ts, gen, g_collect = self._host_setup()
            learn = self._build_learn()
        else:
            gen = make_generator(self.seed, self.device)
            g_init, g_reset = fork_generator(gen), fork_generator(gen)
            cstate = self.train_collector.reset(g_reset)
            ts = self.algo.init(g_init)
            superstep = self._build_superstep()

        env_step = grad_step = epoch = start_epoch = 0
        if self.resume_from_log and self.logger is not None:
            start_epoch, env_step, grad_step = self.logger.restore_data()
        best_reward, best_reward_std = -np.inf, 0.0
        last_metrics: dict = {}
        train_time = 0.0
        stop_triggered = False
        with RunContext((self.max_epoch - start_epoch) * self.step_per_epoch, self.show_progress, self.profile_dir,
                        desc="onpolicy") as rc:
            for epoch in range(start_epoch + 1, self.max_epoch + 1):
                steps_this_epoch = 0
                while steps_this_epoch < self.step_per_epoch:
                    t0 = time.time()
                    if host:
                        col = self.train_collector
                        _, stats, traj = col.collect(ts, None, self.segment_len, g_collect, explore=True,
                                                     record_traj=True)
                        ts, metrics = learn(ts, col.to_device(traj), gen)  # one packed copy
                    else:
                        ts, cstate, outputs, metrics = superstep(ts, cstate, gen)
                        stats = Collector.summarize(outputs, self.steps_per_segment)
                    host_metrics = _read(metrics)  # the one metric read of the superstep
                    train_time += time.time() - t0
                    env_step += self.steps_per_segment
                    steps_this_epoch += self.steps_per_segment
                    grad_step += self.updates_per_segment
                    last_metrics = smooth(host_metrics)
                    rc.step(self.steps_per_segment, last_metrics)
                    # in-training test: when training returns already clear
                    # the bar, confirm with a real test phase and stop early
                    if (
                        self.test_in_train
                        and self.stop_fn is not None
                        and stats.returns.size
                        and self.stop_fn(stats.returns_mean)
                    ):
                        rew, rew_std = self._test(ts, gen)
                        if self.stop_fn(rew):
                            best_reward = max(best_reward, rew)
                            best_reward_std = rew_std
                            stop_triggered = True
                            break
                    log_train(self.logger, env_step, stats, last_metrics)
                if stop_triggered:
                    break
                save_epoch(self.logger, self.save_checkpoint_fn, epoch, env_step, grad_step)
                rew, rew_std = self._test(ts, gen)
                if rew > best_reward:
                    best_reward, best_reward_std = rew, rew_std
                    if self.save_best_fn is not None:
                        self.save_best_fn(ts)
                log_test(self.logger, rew, rew_std, env_step)
                if self.stop_fn is not None and self.stop_fn(rew):
                    stop_triggered = True
                    break

        self.trace_path = rc.trace_path
        self.train_state = ts
        if not host:
            self.collect_state = cstate
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
