"""On-policy trainer: (rollout -> process -> repeat x minibatch learning)
supersteps (port of ``tianshou_tpu/trainer/onpolicy.py``).

A superstep records a rollout of ``[T, N]`` transitions with the policy's
``log_prob`` (``rollout_segment(record_traj=True)``; no replay buffer), runs
the algorithm's optional ``pre_learn`` hook, :meth:`process_rollout` and
:meth:`update_rollout_stats`, then ``repeat_per_collect`` passes, each over
``M // batch_size`` minibatches of a fresh permutation of the ``M = T * N``
samples (``randperm(M)[:nmb * bs].view(nmb, bs)``).  With
``recompute_advantage`` the rollout is processed again before every pass.
The superstep keeps its metrics on the device; :meth:`OnPolicyTrainer.run`
reads them once a superstep.  :meth:`OnPolicyTrainer._build_superstep` is
the eager superstep and :meth:`OnPolicyTrainer._compile_superstep` its
compiled form, which ``run`` launches: on CUDA a
:class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` that replays a CUDA
graph of it (the first superstep its capture's warm-up) over the train and
collect states ``run`` started from; on the CPU the eager superstep.
Epochs, test episodes and early stopping stay on the host, as in the JAX
package: ``run`` hands its step to the epoch loop,
:func:`~tianshou_tpu_torch.trainer.loop.run_epochs`.

With a :class:`~tianshou_tpu_torch.collect.host_collector.HostCollector`
``run`` takes the host-env path: a segment collected from host envs, its
numpy leaves sent to the card in ONE packed copy, then the same learning
(:meth:`OnPolicyTrainer._build_learn`), compiled as the superstep is
(:meth:`OnPolicyTrainer._compile_learn`): the segment lands in a static
staging tree (the first segment's upload), into which every later segment
is written in place, its one packed copy included.

``logger``, ``save_checkpoint_fn``, ``resume_from_log`` and ``profile_dir``
work as in :class:`~tianshou_tpu_torch.trainer.offpolicy.OffPolicyTrainer`.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from typing import Any

import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.collect.collector import rollout_segment
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.trainer.loop import OnPolicySuperstep, Step, Stepped, read_metrics, run_epochs
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device
from tianshou_tpu_torch.utils.graphs import compile_step

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


class _HostLearnStep(Step):
    """The host path's step: a segment collected from host envs, its numpy
    leaves sent in one packed copy into the static staging tree (the first
    segment's upload), the compiled learning over it and the one metric
    read."""

    def __init__(self, trainer: OnPolicyTrainer):
        self.trainer = trainer
        self.ts, self.generator, self.g_collect = trainer._host_setup()
        self.learn = self.staging = None  # compiled over the first segment's upload

    def __call__(self, epoch: int, env_step: int) -> Stepped:
        t, col = self.trainer, self.trainer.train_collector
        t0 = time.time()
        _, stats, traj = col.collect(self.ts, None, t.segment_len, self.g_collect, explore=True, record_traj=True)
        self.staging = col.upload(traj, self.staging)  # one packed copy
        if self.learn is None:
            self.learn = t.compiled_learn = t._compile_learn(self.ts, self.staging)
            self.staging = getattr(self.learn, "cstate", self.staging)
        self.ts, self.staging, _, _, metrics = self.learn(self.ts, self.staging, None, self.generator, 0.0)
        metrics = read_metrics(metrics)
        return Stepped(stats, metrics, t.steps_per_segment, t.updates_per_segment, time.time() - t0)


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
        # what the last run() launched: the compiled superstep (device
        # path) or the compiled learning (host path)
        self.compiled_superstep = None
        self.compiled_learn = None

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

    def _compile_superstep(self, ts, cstate):
        """The superstep ``run`` launches on the device path (the JAX
        package's compiled superstep), called ``(ts, cstate, bstate,
        generator, explore_param) -> (ts, cstate, bstate, outputs,
        metrics)`` with ``bstate = None`` (no replay buffer;
        ``explore_param`` is unused): on CUDA a
        :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` over
        :meth:`_build_superstep` with ``ts`` and ``cstate`` as its static
        state, captured after its first call runs eagerly as the warm-up;
        each call takes and returns that state, whose tensors, ``outputs``
        and ``metrics`` the next call overwrites.  A trainer on the CPU gets
        the eager superstep in the same form."""
        superstep = self._build_superstep()

        def step(ts, cstate, bstate, generator, explore_param):
            ts, cstate, outputs, metrics = superstep(ts, cstate, generator)
            return ts, cstate, bstate, outputs, metrics

        return compile_step(step, self.device, ts, cstate, None, name="onpolicy.superstep")

    def _compile_learn(self, ts, staging):
        """The host path's learning as ``run`` launches it (the JAX
        package's jitted learn), called ``(ts, staging, bstate, generator,
        explore_param) -> (ts, staging, bstate, None, metrics)`` with
        ``bstate = None``: ``staging`` is a segment's
        :meth:`~tianshou_tpu_torch.collect.host_collector.HostCollector.upload`,
        into which ``upload(traj, staging)`` writes each later segment.  On
        CUDA a :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` over
        :meth:`_build_learn` with ``ts`` and ``staging`` as its static
        state; on the CPU the eager learning in the same form."""
        learn, col = self._build_learn(), self.train_collector

        def step(ts, staging, bstate, generator, explore_param):
            ts, metrics = learn(ts, col.unpack(staging), generator)
            return ts, staging, bstate, None, metrics

        return compile_step(step, self.device, ts, staging, None, name="onpolicy.learn")

    def _host_setup(self):
        """The host path's start: ``(ts, generator, collect generator)``
        with the envs reset from the seed."""
        gen = make_generator(self.seed, self.device)
        g_init, g_collect = fork_generator(gen), fork_generator(gen)
        self.train_collector.reset(seed=self.seed)
        return self.algo.init(g_init), gen, g_collect

    def run(self) -> InfoStats:
        """Training in epochs (:func:`~tianshou_tpu_torch.trainer.loop.run_epochs`)
        of the compiled superstep, or over host envs of host segments and
        the compiled learning."""
        t_start = time.time()
        if getattr(self.train_collector, "is_host_collector", False):
            step = _HostLearnStep(self)
        else:
            gen = make_generator(self.seed, self.device)
            g_init, g_reset = fork_generator(gen), fork_generator(gen)
            cstate = self.train_collector.reset(g_reset)
            ts = self.algo.init(g_init)
            superstep = self.compiled_superstep = self._compile_superstep(ts, cstate)
            step = OnPolicySuperstep(superstep, ts, cstate, None, gen, env_steps=self.steps_per_segment,
                                     grad_steps=self.updates_per_segment, summarize=self.steps_per_segment)

        def test(ts) -> tuple[float, float]:
            stats = self.test_collector.collect_episodes(ts, step.generator, self.episode_per_test, explore=False)
            return stats.returns_mean, stats.returns_std

        info, self.trace_path = run_epochs(
            step, test, max_epoch=self.max_epoch, step_per_epoch=self.step_per_epoch, t_start=t_start,
            desc="onpolicy", logger=self.logger, save_checkpoint_fn=self.save_checkpoint_fn,
            save_best_fn=self.save_best_fn, stop_fn=self.stop_fn, test_in_train=self.test_in_train,
            resume_from_log=self.resume_from_log, smooth_window=self.smooth_window,
            show_progress=self.show_progress, profile_dir=self.profile_dir)
        self.train_state, self.collect_state = step.ts, step.cstate
        return info
