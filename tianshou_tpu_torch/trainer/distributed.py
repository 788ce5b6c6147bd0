"""Multi-process trainers (port of ``tianshou_tpu/trainer/distributed.py``):
the standard off-policy and on-policy pipelines over the ranks of a
``torch.distributed`` process group, one device a rank.

Both keep the JAX trainers' invariants:

- every rank steps its OWN shard of envs (the caller sizes the collectors
  at ``total / ranks``, cf. :func:`process_env_slice`); ``batch_size`` and
  ``step_per_collect`` are GLOBAL quantities;
- the generators follow the JAX package's key splits: initialisation,
  learning and testing draw from one generator seeded alike on every rank
  and advanced in lockstep, so the ranks start from the same parameters and
  draw the same parameter noise (Rainbow's, REDQ's subset); env resets,
  exploration and replay sampling draw from streams seeded from ``(seed,
  rank)`` (:func:`rank_seed`), so the ranks gather disjoint experience;
- the test phase evaluates on every rank and averages the mean and std of
  the returns over the ranks (one ``all_reduce``), so every rank takes the
  same stop decision.

:class:`DistributedOffPolicyTrainer`: each rank collects into its own
buffer and, for each gradient step, presamples ``batch_size // ranks``
rows from it (n-step chains, PER weights, frame stacks through
``gather_rows_cast``, exactly as one process does) and runs
``update_sampled`` on them against its real buffer.  Each optimizer step
averages its gradients over the group (one ``all_reduce`` a step, no
``DistributedDataParallel``: an update steps several modules with several
backward passes), and per-row draws are made for the global batch, each
rank taking its rows (``Algorithm.row_block``).  The off-policy losses are
means over rows, so this equals one process's update on the concatenated
batch.  A prioritized buffer takes the priorities the rank's own update
writes for its rows, under the parameters before the step: what the JAX
trainer recomputes through ``priority_scores``, which an algorithm must
still implement (a ``TypeError`` otherwise, as in the JAX package).  The
metrics are averaged over a segment's updates and over the ranks (one
``all_reduce``) on the device, inside the segment, and read once a
segment.

On a two-axis mesh (``parallel.mesh.make_mesh2``, ``("dp", "ep")``) the
``axis_name`` axis (``"dp"``) sets the rows, the gradient average and the
metrics, and the other axis (``"ep"``) shards every
``EnsembleMLP`` of the train state after its initialisation: each ``ep``
rank holds ``K / ep`` critics (``networks/common.py``).  The ``ep`` peers
of a ``dp`` coordinate seed their env and replay streams from that
coordinate, so they collect the same transitions, take the same rows and
draw in lockstep (REDQ's subset included); their replicated parameters
stay equal, and their losses, computed from the gathered ensemble, are
equal too.  The JAX package gets this layout by placing a train state
with ``shard_ensemble_axis`` and running the plain superstep on it.

:class:`DistributedOnPolicyTrainer`: each rank records its segment
(``rollout_segment(record_traj=True)``, as
:class:`~tianshou_tpu_torch.trainer.onpolicy.OnPolicyTrainer` does), the
global env-major trajectory is assembled on every rank
(:func:`gather_env_axis`) and every rank runs the one-process learn
(:func:`build_rollout_learn`) on it from the lockstep generator.  Its
reductions (the return statistics, the advantage normalisation of a
minibatch from a global permutation, the gradient clipping, NPG's and
TRPO's Fisher products) are then global and exact; the learn compute is
replicated where XLA would shard it.

Both trainers compile their segment as the JAX package jits its global
step (``_compile_superstep``): ``run()`` launches, on CUDA, a
:class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` that replays a CUDA
graph of the eager segment (``_build_superstep``), its collectives (the
gradient buckets, the ensembles' gathers and their backward all-reduce,
the metrics, the trajectory's assembly) nodes of the graph; a segment's
first call of each branch pattern runs eagerly as its capture's warm-up.
A segment over a gloo group (the ``dp`` group or the ensemble group) stays
eager, on the card too: gloo's collectives run on the host, which a stream
capture cannot record (:func:`~tianshou_tpu_torch.utils.graphs.capturable_groups`).
On the CPU the eager segment runs.  The warm-up collection and the test
phase run the collector's compiled segments; the test phase's average over
the ranks stays on the host.
"""

from __future__ import annotations

import inspect
import time
from collections.abc import Callable
from typing import Any

import torch

from tianshou_tpu_torch.algos.base import Algorithm
from tianshou_tpu_torch.collect.collector import Collector, rollout_segment
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.parallel.distributed import (
    average_metrics,
    data_parallel,
    gather_env_axis,
    group_of,
    mean_over_ranks,
    process_count,
    process_index,
    rank_seed,
)
from tianshou_tpu_torch.parallel.mesh import shard_ensemble_modules
from tianshou_tpu_torch.trainer.loop import OnPolicySuperstep, SuperstepStep, run_epochs
from tianshou_tpu_torch.trainer.onpolicy import build_rollout_learn
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device
from tianshou_tpu_torch.utils.graphs import compile_step

__all__ = ["DistributedOffPolicyTrainer", "DistributedOnPolicyTrainer"]


def _check_devices(device: torch.device, **parts) -> None:
    for what, dev in parts.items():
        if dev != device:
            raise ValueError(f"trainer on {device} but {what.replace('_', ' ')} on {dev}")


def _run(trainer, step: SuperstepStep, g_test, test_param: float, pid: int, env_step: int,
         t_start: float) -> InfoStats:
    """The epoch loop of a distributed trainer: the lockstep test phase
    (every rank's mean and std of the returns, averaged over the ranks),
    the logs on rank 0 alone, no epoch save and no ``save_best_fn``."""

    def test(ts) -> tuple[float, float]:
        stats = trainer.test_collector.collect_episodes(ts, g_test, trainer.episode_per_test, explore=False,
                                                        explore_param=test_param)
        return mean_over_ranks([stats.returns_mean, stats.returns_std], trainer.group, trainer.device)

    info, _ = run_epochs(step, test, max_epoch=trainer.max_epoch, step_per_epoch=trainer.step_per_epoch,
                         t_start=t_start, desc="distributed", logger=trainer.logger if pid == 0 else None,
                         save_epochs=False, stop_fn=trainer.stop_fn, env_step=env_step)
    trainer.train_state, trainer.collect_state = step.ts, step.cstate
    return info


class DistributedOffPolicyTrainer:
    """Off-policy training over the ranks of a process group (see the
    module docstring).  ``train_collector``, ``test_collector`` and
    ``buffer`` are this rank's; ``batch_size`` and ``step_per_collect`` are
    global.  ``mesh`` (a ``DeviceMesh``) names the group, else the default
    group is used; without a process group it trains as one process.  On a
    two-axis mesh, the axis that is not ``axis_name`` shards the
    ensembles."""

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
        logger: Any | None = None,
        seed: int = 0,
        mesh=None,
        axis_name: str = "dp",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        _check_devices(self.device, algorithm=algo.device, train_collector=train_collector.device,
                       test_collector=test_collector.device)
        if not getattr(algo, "supports_presampled", False):
            raise ValueError("DistributedOffPolicyTrainer needs the presample/update_sampled split "
                             "(algo.supports_presampled)")
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
        if train_param_fn is None:
            default_param = float(getattr(algo, "exploration_noise", 0.0))
            train_param_fn = lambda epoch, step: default_param  # noqa: E731
        self.train_param_fn = train_param_fn
        self.test_param = test_param
        self.stop_fn = stop_fn
        self.warmup_steps = warmup_steps
        self.warmup_random = warmup_random
        self.logger = logger
        self.seed = seed
        self.mesh = mesh
        self.axis_name = axis_name
        names = tuple(mesh.mesh_dim_names) if mesh is not None else (axis_name,)
        self.ensemble_group = group_of(mesh, names[1 - names.index(axis_name)]) if len(names) == 2 else None

        self.group = group_of(mesh, axis_name)
        n_proc = process_count(self.group)
        self.global_envs = train_collector.venv.num_envs * n_proc
        self.segment_len = max(1, step_per_collect // self.global_envs)
        self.steps_per_segment = self.segment_len * self.global_envs
        self.updates_per_segment = max(1, round(update_per_step * self.steps_per_segment))
        self.batch_local = max(1, batch_size // n_proc)
        # what the last run() launched: the compiled segment
        self.compiled_superstep = None

    def _check_priorities(self) -> None:
        """Prioritized replay needs ``priority_scores``: an algorithm that
        does not implement it is refused up front, as in the JAX package."""
        if not isinstance(self.buffer, PrioritizedReplayBuffer):
            return
        if inspect.unwrap(type(self.algo).priority_scores) is inspect.unwrap(Algorithm.priority_scores):
            raise TypeError(
                f"{type(self.algo).__name__} does not implement priority_scores(), which distributed PER "
                "requires for process-local priority write-back; use a uniform ReplayBuffer or implement "
                "priority_scores on the algorithm (see algos/base.py).")

    def _build_superstep(self):
        """``superstep(ts, cstate, bstate, generators, explore_param) -> (ts,
        cstate, bstate, outputs, metrics)``: this rank's rollout segment into
        its buffer, then the segment's updates, each on ``batch_size //
        ranks`` rows presampled from the rank's buffer with the sampling
        generator and updated with the lockstep one (``generators = (learn,
        sample)``).  ``metrics`` are the means over the updates and the
        ranks, on the device, the same on every rank."""
        algo, buffer = self.algo, self.buffer
        seg = rollout_segment(algo, self.train_collector.venv, buffer, self.segment_len, explore=True,
                              reward_metric=self.train_collector.reward_metric)
        n_updates, rows, group = self.updates_per_segment, self.batch_local, self.group

        def superstep(ts, cstate, bstate, generators, explore_param):
            g_learn, g_sample = generators
            cstate, bstate, outputs = seg(ts, cstate, bstate, explore_param)
            history: dict[str, list[torch.Tensor]] = {}
            with data_parallel(algo, group, rows):
                for _ in range(n_updates):
                    sampled = algo.presample(buffer, bstate, g_sample, rows)
                    ts, bstate, metrics = algo.update_sampled(ts, buffer, bstate, sampled, g_learn)
                    for k, v in metrics.items():
                        history.setdefault(k, []).append(v)
            metrics = average_metrics({k: torch.stack(v).mean() for k, v in history.items()}, group)
            return ts, cstate, bstate, outputs, metrics

        return superstep

    def _compile_superstep(self, ts, cstate, bstate):
        """The segment ``run`` launches (the JAX package's jitted global
        update with the rank's rollout and presamples): on CUDA, over NCCL or
        without a process group, a
        :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` over
        :meth:`_build_superstep` with ``ts``, ``cstate`` and ``bstate`` as
        its static state and a graph per pattern of the algorithm's
        host-keyed branches (:meth:`Algorithm.update_pattern`: TD3's and
        REDQ's delayed actor), each pattern's first call run eagerly as the
        warm-up; its calls take ``generators = (learn, sample)``, the same
        tuple each call.  Over a gloo group, and on the CPU, the eager
        segment (module docstring)."""
        k = self.updates_per_segment
        return compile_step(self._build_superstep(), self.device, ts, cstate, bstate,
                            key=lambda: self.algo.update_pattern(ts, k), groups=(self.group, self.ensemble_group),
                            name="distributed.offpolicy_segment")

    def init_states(self):
        """``(ts, cstate, bstate, (learn, sample) generators, test
        generator)`` at the start of a run: the parameters from the lockstep
        generator, the envs reset and the replay sampled from this rank's
        own streams (its ``dp`` coordinate's); the ensembles sharded over
        the ensemble axis."""
        gen = make_generator(self.seed, self.device)
        g_init, g_test = fork_generator(gen), fork_generator(gen)
        local = make_generator(rank_seed(self.seed, process_index(self.group)), self.device)
        g_reset, g_sample = fork_generator(local), fork_generator(local)
        cstate = self.train_collector.reset(g_reset)
        ts = self.algo.init(g_init)
        if self.ensemble_group is not None:
            shard_ensemble_modules(ts, self.ensemble_group)
        bstate = self.buffer.init(self.train_collector.example_transition(ts, cstate), device=self.device)
        return ts, cstate, bstate, (gen, g_sample), g_test

    def run(self) -> InfoStats:
        t_start = time.time()
        self._check_priorities()
        pid = process_index()
        ts, cstate, bstate, generators, g_test = self.init_states()
        env_step = 0
        if self.warmup_steps > 0:
            warm_len = max(1, self.warmup_steps // self.global_envs)
            cstate, bstate, stats, _ = self.train_collector.collect(ts, cstate, bstate, warm_len, explore=True,
                                                                    random=self.warmup_random)
            env_step = stats.n_collected_steps * process_count(self.group)
        superstep = self.compiled_superstep = self._compile_superstep(ts, cstate, bstate)
        # the segment's episodes are summarized where they are logged
        step = SuperstepStep(superstep, ts, cstate, bstate, generators, env_steps=self.steps_per_segment,
                             grad_steps=self.updates_per_segment, param=self.train_param_fn,
                             summarize=self.steps_per_segment if pid == 0 else None)
        info = _run(self, step, g_test, self.test_param, pid, env_step, t_start)
        self.buffer_state = step.bstate
        return info


class DistributedOnPolicyTrainer:
    """On-policy training over the ranks of a process group (see the module
    docstring): each rank records its own env shard, the global trajectory
    is assembled on every rank and learned from, replicated.  The
    collectors are this rank's; ``step_per_collect`` and ``batch_size`` are
    global."""

    def __init__(
        self,
        algo: Algorithm,
        train_collector: Collector,
        test_collector: Collector,
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
        mesh=None,
        axis_name: str = "dp",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        _check_devices(self.device, algorithm=algo.device, train_collector=train_collector.device,
                       test_collector=test_collector.device)
        self.algo = algo
        self.train_collector = train_collector
        self.test_collector = test_collector
        self.max_epoch = max_epoch
        self.step_per_epoch = step_per_epoch
        self.step_per_collect = step_per_collect
        self.repeat_per_collect = repeat_per_collect
        self.batch_size = batch_size
        self.episode_per_test = episode_per_test
        self.stop_fn = stop_fn
        self.logger = logger
        self.seed = seed
        self.mesh = mesh
        self.axis_name = axis_name

        self.group = group_of(mesh, axis_name)
        self.global_envs = train_collector.venv.num_envs * process_count(self.group)
        self.segment_len = max(1, step_per_collect // self.global_envs)
        self.steps_per_segment = self.segment_len * self.global_envs
        bs = min(batch_size, self.steps_per_segment)
        self.updates_per_segment = repeat_per_collect * max(1, self.steps_per_segment // bs)
        # what the last run() launched: the compiled segment
        self.compiled_superstep = None

    def _build_global_learn(self):
        """``(ts, traj, generator) -> (ts, metrics)``: the one-process learn
        over the global ``[T, N_global]`` trajectory."""
        return build_rollout_learn(self.algo, self.steps_per_segment, self.batch_size, self.repeat_per_collect)

    def _build_superstep(self):
        """``superstep(ts, cstate, generator) -> (ts, cstate, outputs,
        metrics)``: this rank's recorded segment (``outputs``, for
        :meth:`Collector.summarize`), the global trajectory assembled, the
        learn; ``metrics`` on the device, the same on every rank."""
        col, group = self.train_collector, self.group
        seg = rollout_segment(self.algo, col.venv, None, self.segment_len, explore=True, record_traj=True,
                              reward_metric=col.reward_metric)
        learn = self._build_global_learn()

        def superstep(ts, cstate, generator):
            cstate, _, outputs = seg(ts, cstate, None, 0.0)
            ts, metrics = learn(ts, gather_env_axis(outputs["traj"], group), generator)
            return ts, cstate, outputs, metrics

        return superstep

    def _compile_superstep(self, ts, cstate):
        """The segment ``run`` launches (the JAX package's jitted global
        learn with the rank's recorded rollout), called ``(ts, cstate,
        bstate, generator, explore_param) -> (ts, cstate, bstate, outputs,
        metrics)`` with ``bstate = None`` (``explore_param`` is unused): on
        CUDA, over NCCL or without a process group, a
        :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` over
        :meth:`_build_superstep` with ``ts`` and ``cstate`` as its static
        state, captured after its first call runs eagerly as the warm-up
        (the trajectory's global buffer then comes from the graph's pool,
        its ``all_reduce`` a node); over a gloo group, and on the CPU, the
        eager segment in the same form."""
        superstep = self._build_superstep()

        def step(ts, cstate, bstate, generator, explore_param):
            ts, cstate, outputs, metrics = superstep(ts, cstate, generator)
            return ts, cstate, bstate, outputs, metrics

        return compile_step(step, self.device, ts, cstate, None, groups=(self.group,),
                            name="distributed.onpolicy_segment")

    def run(self) -> InfoStats:
        t_start = time.time()
        pid = process_index(self.group)
        gen = make_generator(self.seed, self.device)
        g_init, g_test = fork_generator(gen), fork_generator(gen)
        local = make_generator(rank_seed(self.seed, pid), self.device)
        cstate = self.train_collector.reset(fork_generator(local))
        ts = self.algo.init(g_init)
        superstep = self.compiled_superstep = self._compile_superstep(ts, cstate)
        step = OnPolicySuperstep(superstep, ts, cstate, None, gen, env_steps=self.steps_per_segment,
                                 grad_steps=self.updates_per_segment,
                                 summarize=self.train_collector.venv.num_envs * self.segment_len)
        return _run(self, step, g_test, 0.0, pid, 0, t_start)
