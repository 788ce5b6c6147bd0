"""Off-policy trainer: (collect -> k gradient steps) supersteps (port of
``tianshou_tpu/trainer/offpolicy.py``).

A superstep is a rollout segment into the ring buffer, then ONE presample of
``k * batch`` indices, transitions and n-step chains, then k updates on
slices of it (exact for uniform replay, whose sampling does not depend on
the updates in between); with prioritized replay, or an algorithm that
overrides ``update``, each of the k updates samples its own batch.  The
superstep keeps its metrics on the device; :meth:`OffPolicyTrainer.run`
reads them once per superstep.  :meth:`OffPolicyTrainer._build_superstep`
is the eager superstep (the JAX package's ``_superstep_raw``), and
:meth:`OffPolicyTrainer._compile_superstep` its compiled form, which
``run`` launches: on CUDA a :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep`
that replays CUDA graphs captured from it, one launch a superstep (one
graph per pattern of TD3's or REDQ's delayed actor steps, the first
superstep of each pattern run eagerly as its capture's warm-up), over the
state ``run`` started from as the graphs' static state; on the CPU the
eager superstep itself.
Epochs, test episodes and early stopping stay on the host, as in the JAX
package: ``run`` hands its step to the epoch loop,
:func:`~tianshou_tpu_torch.trainer.loop.run_epochs`.

With a :class:`~tianshou_tpu_torch.collect.host_collector.HostCollector`
``run`` takes the host-env path (:class:`HostLoop`): a
segment collected from host envs, then one host step (:class:`HostStep`):
ONE packed host-to-device copy of the segment, ``add_trajectory`` and the k
updates.  Its device part runs compiled as the superstep does
(:meth:`OffPolicyTrainer._compile_host_step`): the segment lands in a
static staging tree (the first segment's upload), into which every later
segment is written in place, its one packed copy included, and on CUDA a
CUDA graph of the device part reads it.  ``pipeline_host_updates`` (default
off) acts with the actor from before the updates in flight, on a side CUDA
stream, from a snapshot of it.

When each segment is ONE step of every env, the host path runs the fused
fine cycle (:class:`FusedHostLoop`, ``fused_fine_host``): per cycle the
envs step with the pending action, the transition crosses in one packed
copy, and on the card the transition joins the ring, the k updates run and
the NEXT action is computed with the updated parameters; fetching that
action is the cycle's one host synchronisation.  The exploration value is
the one for the step at which the action executes.  ``fused_fine_host``
``None`` (default) takes the cycle where it applies, ``True`` demands it
(``ValueError`` naming each failed condition), ``False`` keeps the segment
path.

Every path takes a ``logger`` (train data each superstep, from the
metrics ``run`` already read; the counters at each epoch's end, with
``save_checkpoint_fn``; test results), ``resume_from_log`` (the counters
restored from the logger, epochs continued) and ``profile_dir`` (a device
trace of the run, :class:`~tianshou_tpu_torch.trainer.hooks.RunContext`,
which carries the program's spans where the tracer is on).
None of them adds a launch or a host synchronisation to a superstep.

The port's tracer (:mod:`~tianshou_tpu_torch.utils.trace`) is off by
default, and off it adds nothing to a superstep but a flag test a span
and, in a replay, a counter's increment.
On, ``run`` records ``tianshou.run``, the on-device path's set-up spans
(:meth:`OffPolicyTrainer._device_setup`) and the epoch loop's spans of each
step and each epoch's end; the superstep's step
(:class:`~tianshou_tpu_torch.trainer.loop.SuperstepStep`) adds its
children.  A superstep compiled while the tracer is on holds four
event-record nodes, its device marks (three where the updates sample one
by one, which add four an update: the intervals of each draw and each
priority write-back), and the step reads their elapsed times after the
superstep's one host read: no launch and no synchronisation more.
"""

from __future__ import annotations

import copy
import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.collect.collector import Collector, CollectStats, rollout_segment
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.data.stats import InfoStats
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.trainer.loop import Step, Stepped, SuperstepStep, read_metrics, run_epochs
from tianshou_tpu_torch.utils import trace
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device
from tianshou_tpu_torch.utils.graphs import compile_step
from tianshou_tpu_torch.utils.transfer import TreePacker

__all__ = ["FusedHostLoop", "HostStep", "OffPolicyTrainer", "build_update_scan"]


def build_update_scan(algo: Algorithm, buffer: ReplayBuffer, batch_size: int, n_updates: int,
                      marks: trace.DeviceMarks | None = None):
    """Build ``(ts, bstate, generator) -> (ts, bstate, mean_metrics)``: the
    ``n_updates`` updates of a superstep, each drawing its own noise from
    ``generator`` (the JAX package splits a key per update).

    When the algorithm factors its update into ``presample`` +
    ``update_sampled``, does not override ``update``, and sampling does not
    depend on the updates in between (uniform replay), ONE presample of
    ``n_updates * batch_size`` transitions feeds the updates on consecutive
    ``batch_size`` slices of it.  Otherwise (a
    :class:`PrioritizedReplayBuffer`, whose priorities change with every
    update, or an overridden ``update``) each update samples its own batch
    through ``algo.update``.  ``marks`` (:func:`trace.device_marks`)
    records ``presample`` after the presample and ``updates`` after the
    updates; in the per-update branch they are active
    (:func:`trace.marking`), and each update's draw and priority
    write-back record the intervals ``per_sample`` and ``per_write_back``
    (``Algorithm.update``, ``algos.base.write_back``)."""
    presampled = (
        algo.supports_presampled
        # a subclass that overrides update() while inheriting
        # supports_presampled must not be bypassed for its update_sampled
        and type(algo).update is Algorithm.update
        and not isinstance(buffer, PrioritizedReplayBuffer)
    )

    def updates(ts: TrainState, bstate: ReplayBufferState, generator: torch.Generator):
        if presampled:
            sampled = algo.presample(buffer, bstate, generator, n_updates * batch_size)
            views = tree_map(lambda x: x.reshape((n_updates, batch_size) + x.shape[1:]), sampled)
            if marks is not None:
                marks.record("presample")
        history: dict[str, list[torch.Tensor]] = {}
        with trace.marking(None if presampled else marks):
            for i in range(n_updates):
                if presampled:
                    ts, bstate, metrics = algo.update_sampled(
                        ts, buffer, bstate, tree_map(lambda x: x[i], views), generator)
                else:
                    ts, bstate, metrics = algo.update(ts, buffer, bstate, generator, batch_size)
                for k, v in metrics.items():
                    history.setdefault(k, []).append(v)
        means = {k: torch.stack(v).mean() for k, v in history.items()}
        if marks is not None:
            marks.record("updates")
        return ts, bstate, means

    return updates


class HostStep:
    """One segment of the host path on the card.  :meth:`upload` is the
    host part: the segment's numpy leaves packed and sent in ONE copy.
    :meth:`device` is the device part: unpack, ``add_trajectory`` and the k
    updates, all queued without a host synchronisation."""

    def __init__(self, collector, buffer: ReplayBuffer, updates_fn):
        self.collector = collector
        self.buffer = buffer
        self.updates_fn = updates_fn

    def upload(self, traj: Batch, staging: tuple | None = None) -> tuple:
        """The segment's numpy leaves packed and copied to the card
        (:meth:`HostCollector.upload`, into ``staging`` where given), for
        :meth:`device`."""
        return self.collector.upload(traj, staging)

    def device(self, ts, bstate, uploaded: tuple, generator):
        bstate = self.buffer.add_trajectory(bstate, self.collector.unpack(uploaded))
        return self.updates_fn(ts, bstate, generator)


class _SegmentReads(Step):
    """The host paths' metric reads, which wait on the card: the previous
    segment's every ``max(1, 4096 // steps_per_segment)`` segments, and the
    last segment's when the run ends (:meth:`finish`)."""

    metrics: dict[str, torch.Tensor] | None = None
    _count = 0

    def _due(self) -> dict[str, float] | None:
        due = self.metrics is not None and self._count % max(1, 4096 // self.trainer.steps_per_segment) == 0
        self._count += 1
        return self.read_metrics() if due else None

    def read_metrics(self) -> dict[str, float]:
        """The last segment's mean metrics, in one device-to-host copy."""
        return read_metrics(self.metrics)

    def finish(self) -> dict[str, float] | None:
        return self.read_metrics() if self.metrics is not None else None


class HostLoop(_SegmentReads):
    """The host path's carried state and its work a segment: :meth:`collect`
    on the host envs, then :meth:`update` (one :class:`HostStep`); a call is
    both, with the previous segment's metrics read between them where due.

    With ``pipeline_host_updates`` the envs are stepped with a snapshot of
    the actor taken before the updates in flight, and on CUDA the acting
    runs on a side stream, so that it need not queue behind those updates.
    """

    def __init__(self, trainer: OffPolicyTrainer, ts, bstate, generator, collect_generator):
        self.trainer = trainer
        self.ts, self.bstate = ts, bstate
        self.generator = generator
        self.collect_generator = collect_generator
        self.host_step = trainer._build_host_step()
        # the compiled device part and its staging, from the first segment
        self.compiled = self.staging = None
        self.pipelined = trainer.pipeline_host_updates
        dev = trainer.device
        self.side = torch.cuda.Stream(dev) if self.pipelined and dev.type == "cuda" else None
        self.snapshot = copy.deepcopy(trainer.algo.act_params(ts)).requires_grad_(False) if self.pipelined else None
        if self.side is not None:
            self.side.wait_stream(torch.cuda.current_stream(dev))  # the initial parameters are written
        self.ts_act = ts

    def collect(self, explore_param: float):
        """One segment from the host envs: ``(stats, trajectory)``."""
        t = self.trainer
        _, stats, traj = t.train_collector.collect(
            self.ts_act, None, t.segment_len, self.collect_generator, explore=True,
            explore_param=explore_param, record_traj=True, stream=self.side)
        return stats, traj

    def update(self, traj) -> None:
        """The segment into the buffer and the k updates (queued, not
        waited for)."""
        algo = self.trainer.algo
        if self.pipelined:
            with torch.no_grad():
                torch._foreach_copy_(list(self.snapshot.parameters()), list(algo.act_params(self.ts).parameters()))
            if self.side is not None:
                self.side.wait_stream(torch.cuda.current_stream(self.trainer.device))
        self.staging = self.host_step.upload(traj, self.staging)
        if self.compiled is None:
            t = self.trainer
            self.compiled = t.compiled_host_step = t._compile_host_step(self.host_step, self.ts, self.bstate,
                                                                       self.staging)
            self.staging = getattr(self.compiled, "cstate", self.staging)
        self.ts, self.staging, self.bstate, _, self.metrics = self.compiled(
            self.ts, self.staging, self.bstate, self.generator, 0.0)
        self.ts_act = algo.with_act_params(self.ts, self.snapshot) if self.pipelined else self.ts

    def __call__(self, epoch: int, env_step: int) -> Stepped:
        t = self.trainer
        explore_param = float(t.train_param_fn(epoch, env_step))
        t0 = time.time()
        stats, traj = self.collect(explore_param)
        # the previous segment's metrics, read after this segment's
        # collection so that it does not wait on them
        metrics = self._due()
        self.update(traj)
        return Stepped(stats, metrics, t.steps_per_segment, t.updates_per_segment, time.time() - t0)


class FusedHostLoop(_SegmentReads):
    """The fused fine host cycle, for segments of one step per env: the
    reference's collect-one-step / update order with one host
    synchronisation a cycle.

    :meth:`step_envs` steps the envs with the pending action (host);
    :meth:`upload` sends the transition and the next observation in ONE
    packed copy into a static staging buffer; :meth:`device` adds the
    transition to the ring, runs the k updates and acts on the next
    observation with the updated parameters, all queued without a host
    synchronisation; :meth:`cycle` does the three and fetches the env
    action, the cycle's one synchronisation.  The updates and the acting
    draw from one stream, in order, so a seed fixes the run.

    The device part is compiled as the JAX package jits its ``cycle``
    (:meth:`OffPolicyTrainer._compile_fused_cycle`): on CUDA a CUDA graph
    per pattern of the algorithm's host-keyed branches, over the train and
    buffer states and the static staging ``(flat, raw_act, env_act)``: the
    packed transition, and the pending raw action, which the graph reads
    into the transition and then overwrites with the next action, and the
    next env action.  :meth:`prime` (the JAX ``act_only``) is the host
    collector's acting step (:class:`~tianshou_tpu_torch.collect.host_collector.ActingStep`)."""

    def __init__(self, trainer: OffPolicyTrainer, ts, bstate, generator):
        self.trainer = trainer
        self.ts, self.bstate = ts, bstate
        self.generator = generator
        self.updates_fn = build_update_scan(trainer.algo, trainer.buffer, trainer.batch_size,
                                            trainer.updates_per_segment)
        self.env_act: np.ndarray | None = None  # the pending action, fetched
        self.staging: tuple | None = None  # (flat, raw_act, env_act), static on the card
        self.compiled = None
        self._packer: TreePacker | None = None
        self._raw_act: torch.Tensor | None = None  # the first pending action (prime)

    def prime(self, explore_param: float) -> None:
        """The first action, from the current observations."""
        col = self.trainer.train_collector
        acting = col.acting(self.ts, self.generator, True, explore_param)
        self.env_act = acting(col.obs)
        self._raw_act = acting.io.act.clone()

    def step_envs(self) -> tuple[CollectStats, dict]:
        """One step of every env with the pending action: ``(stats, the
        transition's host leaves and the next observation as "carry")``."""
        col = self.trainer.train_collector
        res, carry = col.venv.step(self.env_act)
        returns, lens = col._track(res)
        host = {"obs": col.obs, "rew": res.reward, "terminated": res.terminated, "truncated": res.truncated,
                "obs_next": res.obs, "carry": carry}
        col.obs = carry
        stats = CollectStats(n_collected_steps=col.venv.num_envs, n_collected_episodes=len(returns),
                             returns=np.asarray(returns), lens=np.asarray(lens, np.int64))
        return stats, host

    def upload(self, host: dict) -> torch.Tensor:
        """``host`` packed and sent to the card in one copy, into the static
        staging buffer (made by the first cycle's copy); returns it."""
        if self._packer is None:
            self._packer = TreePacker(host, self.trainer.device)
            flat = self._packer.to_device(host)
            self.staging = (flat, self._raw_act, torch.empty_like(
                self.trainer.algo.map_action(self._raw_act)))
            return flat
        self._packer.to_device(host, out=self.staging[0])
        return self.staging[0]

    def device_fn(self, ts, staging, bstate, generator, explore_param):
        """The eager device part over ``staging`` (the compiled cycle's
        step, and its reference): ``(ts, staging, bstate, None,
        metrics)``."""
        flat, raw_act, env_act = staging
        t, algo = self.trainer, self.trainer.algo
        h = self._packer.unpack(flat)
        transition = Batch(obs=h["obs"], act=raw_act, rew=h["rew"], terminated=h["terminated"],
                           truncated=h["truncated"], obs_next=h["obs_next"])
        bstate = t.buffer.add(bstate, transition)
        ts, bstate, metrics = self.updates_fn(ts, bstate, generator)
        act = algo.act(ts, h["carry"], generator, True, explore_param)
        raw_act.copy_(act)  # the graph read the pending action into the ring first, in stream order
        env_act.copy_(algo.map_action(act))
        return ts, staging, bstate, None, metrics

    def device(self, flat: torch.Tensor, explore_param: float) -> None:
        """The transition into the ring, the k updates, and the next action
        from the updated parameters, queued on the card (a replay on CUDA);
        ``flat`` is the staging buffer :meth:`upload` wrote."""
        if flat is not self.staging[0]:
            raise ValueError("the fused cycle reads the static staging buffer that upload() writes")
        if self.compiled is None:
            self.compiled = self.trainer.compiled_fused_cycle = self.trainer._compile_fused_cycle(self)
            self.staging = getattr(self.compiled, "cstate", self.staging)
        self.ts, self.staging, self.bstate, _, self.metrics = self.compiled(
            self.ts, self.staging, self.bstate, self.generator, explore_param)

    @property
    def env_act_device(self) -> torch.Tensor:
        """The next env action on the card, written by :meth:`device`."""
        return self.staging[2]

    def cycle(self, explore_param: float) -> CollectStats:
        """One cycle; ``explore_param`` is the schedule's value for the step
        at which the next action executes."""
        stats, host = self.step_envs()
        self.device(self.upload(host), explore_param)
        self.env_act = self.env_act_device.cpu().numpy()  # the cycle's one synchronisation
        return stats

    def __call__(self, epoch: int, env_step: int) -> Stepped:
        t = self.trainer
        explore_param = float(t.train_param_fn(epoch, env_step))
        t0 = time.time()
        if self.env_act is None:
            self.prime(explore_param)
        metrics = self._due()
        # the action computed in this cycle executes at the next step: its
        # schedule value is that step's
        stats = self.cycle(float(t.train_param_fn(epoch, env_step + t.steps_per_segment)))
        return Stepped(stats, metrics, t.steps_per_segment, t.updates_per_segment, time.time() - t0)


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
        logger: Any | None = None,
        seed: int = 0,
        save_best_fn: Callable[[TrainState], None] | None = None,
        save_checkpoint_fn: Callable[[int, int, int], Any] | None = None,
        resume_from_log: bool = False,
        test_in_train: bool = False,
        show_progress: bool = False,
        profile_dir: str | None = None,
        smooth_window: int = 1,
        pipeline_host_updates: bool = False,
        fused_fine_host: bool | None = None,
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
        # the default explore parameter is the algorithm's own exploration
        # noise (DDPG/TD3's sigma; 0.0 for the others), as in the JAX
        # package: a bare 0.0 would silently turn off Gaussian exploration
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
        self.save_best_fn = save_best_fn
        self.save_checkpoint_fn = save_checkpoint_fn
        self.resume_from_log = resume_from_log
        self.test_in_train = test_in_train
        self.show_progress = show_progress
        self.profile_dir = profile_dir
        self.trace_path: str | None = None
        self.smooth_window = smooth_window
        # host path: collect segment s+1 with the actor from before segment
        # s's updates.  Off by default (the reference's sequential order):
        # the staleness destabilised TD3's delayed actor in the JAX
        # package's HalfCheetah runs, while SAC and DDPG tolerate it
        self.pipeline_host_updates = pipeline_host_updates
        # host path: the fused fine cycle (None: where it applies)
        self.fused_fine_host = fused_fine_host
        self.last_run_used_fused = False
        # what the last run() launched: the superstep (on-device path,
        # _compile_superstep), the host step's device part (host path,
        # _compile_host_step) or the fused fine cycle's
        # (_compile_fused_cycle)
        self.compiled_superstep = None
        # the device marks of the superstep built last (_build_superstep)
        self.superstep_marks: trace.DeviceMarks | None = None
        self.compiled_host_step = None
        self.compiled_fused_cycle = None

        num_envs = train_collector.venv.num_envs
        # steps per env per collect segment (the reference counts total env steps)
        self.segment_len = max(1, step_per_collect // num_envs)
        self.steps_per_segment = self.segment_len * num_envs
        self.updates_per_segment = max(1, round(update_per_step * self.steps_per_segment))

    def _build_superstep(self):
        """``superstep(ts, cstate, bstate, generator, explore_param) -> (ts,
        cstate, bstate, outputs, metrics)``.  Built while tracing is on, on
        CUDA, it records the device marks ``start``, ``rollout``,
        ``presample`` (where the updates presample) and ``updates``, kept in
        :attr:`superstep_marks` (:mod:`~tianshou_tpu_torch.utils.trace`);
        built while it is off, none."""
        seg = rollout_segment(
            self.algo, self.train_collector.venv, self.buffer, self.segment_len, explore=True,
            reward_metric=self.train_collector.reward_metric,
        )
        marks = self.superstep_marks = trace.device_marks(self.device)
        updates_fn = build_update_scan(
            self.algo, self.buffer, self.batch_size, self.updates_per_segment, marks
        )

        def superstep(ts, cstate, bstate, generator, explore_param):
            if marks is not None:
                marks.record("start")
            cstate, bstate, outputs = seg(ts, cstate, bstate, explore_param)
            if marks is not None:
                marks.record("rollout")
            ts, bstate, metrics = updates_fn(ts, bstate, generator)
            return ts, cstate, bstate, outputs, metrics

        return superstep

    def _compile_superstep(self, ts, cstate, bstate):
        """The superstep ``run`` launches (the plain branch of the JAX
        package's ``_compile_superstep``): on CUDA a
        :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` over
        :meth:`_build_superstep`, with ``ts``, ``cstate`` and ``bstate`` as
        its static state and a graph per pattern of the algorithm's
        host-keyed branches (:meth:`Algorithm.update_pattern`), captured at
        the pattern's first call, which runs eagerly as the warm-up; each
        call takes and returns that state, whose tensors the next call
        overwrites.  A trainer on the CPU, which the caller asked for, gets
        the eager superstep: CUDA graphs exist only on CUDA."""
        k = self.updates_per_segment
        return compile_step(self._build_superstep(), self.device, ts, cstate, bstate,
                            key=lambda: self.algo.update_pattern(ts, k), name="offpolicy.superstep")

    def _build_host_step(self) -> HostStep:
        updates_fn = build_update_scan(self.algo, self.buffer, self.batch_size, self.updates_per_segment)
        return HostStep(self.train_collector, self.buffer, updates_fn)

    def _compile_host_step(self, host_step: HostStep, ts, bstate, staging):
        """The host step's device part as the host path launches it (the
        JAX package's jitted host step), called ``(ts, staging, bstate,
        generator, explore_param) -> (ts, staging, bstate, None, metrics)``
        (``explore_param`` is unused): ``staging`` is a segment's
        :meth:`HostStep.upload`, into which ``upload(traj, staging)`` writes
        each later segment.  On CUDA a
        :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` over
        :meth:`HostStep.device` with ``ts``, ``staging`` and ``bstate`` as
        its static state and a graph per pattern of the algorithm's
        host-keyed branches; on the CPU the eager device part in the same
        form."""

        def step(ts, staging, bstate, generator, explore_param):
            ts, bstate, metrics = host_step.device(ts, bstate, staging, generator)
            return ts, staging, bstate, None, metrics

        k = self.updates_per_segment
        return compile_step(step, self.device, ts, staging, bstate, key=lambda: self.algo.update_pattern(ts, k),
                            name="offpolicy.host_step")

    def _compile_fused_cycle(self, loop: FusedHostLoop):
        """The fused fine cycle's device part as the host path launches it
        (the JAX package's jitted ``cycle``), called ``(ts, staging, bstate,
        generator, explore_param)``: on CUDA a
        :class:`~tianshou_tpu_torch.utils.graphs.CapturedStep` over
        :meth:`FusedHostLoop.device_fn` with ``loop``'s train state, staging
        and buffer state as its static state and a graph per pattern of the
        algorithm's host-keyed branches; on the CPU the eager device part."""
        k, ts = self.updates_per_segment, loop.ts
        return compile_step(loop.device_fn, self.device, ts, loop.staging, loop.bstate,
                            key=lambda: self.algo.update_pattern(ts, k), name="offpolicy.fused_cycle")

    def _fused_fine_applicable(self, probe: Batch) -> bool:
        """Whether the fused fine cycle applies: one step per env a segment,
        strictly sequential collection, flat observations, no per-step
        policy extras (``probe`` is a recorded step) and no MARL
        ``reward_metric``.  With ``fused_fine_host=True`` a failed condition
        raises ``ValueError`` naming each one."""
        if self.fused_fine_host is False:
            return False
        col = self.train_collector
        conditions = {
            "step_per_collect == num_envs (one step per env per cycle)": self.segment_len == 1,
            "pipeline_host_updates is off": not self.pipeline_host_updates,
            "flat (non-dict) observations": not isinstance(col.obs, dict),
            "policy emits no per-step extras": "policy" not in probe,
            "no MARL reward_metric": col.reward_metric is None,
        }
        failed = [name for name, ok in conditions.items() if not ok]
        if failed and self.fused_fine_host is True:
            raise ValueError(
                f"fused_fine_host=True but the fused fine cycle is not applicable; failed condition(s): "
                f"{'; '.join(failed)}")
        return not failed

    def _host_setup(self) -> tuple[HostLoop | FusedHostLoop, int]:
        """The host path's start: reset the envs, draw the parameters, take
        the buffer schema from one probe step (which advances the envs and
        is not stored) and run the warm-up.  Returns the loop (the fused
        fine cycle's where it applies) and the warm-up's env steps."""
        gen = make_generator(self.seed, self.device)
        g_init, g_collect = fork_generator(gen), fork_generator(gen)
        col = self.train_collector
        col.reset(seed=self.seed)
        ts = self.algo.init(g_init)
        _, _, probe = col.collect(ts, None, 1, g_collect, explore=True, explore_param=1.0, record_traj=True)
        bstate = self.buffer.init(tree_map(lambda x: x[0, 0], col.to_device(probe)), device=self.device)
        self.last_run_used_fused = self._fused_fine_applicable(probe)
        env_step = 0
        if self.warmup_steps > 0:
            warm_len = max(1, self.warmup_steps // col.venv.num_envs)
            bstate, stats, _ = col.collect(ts, bstate, warm_len, g_collect, explore=True, random=self.warmup_random)
            env_step += stats.n_collected_steps
        if self.last_run_used_fused:
            return FusedHostLoop(self, ts, bstate, gen), env_step
        return HostLoop(self, ts, bstate, gen, g_collect), env_step

    def _device_setup(self) -> tuple[SuperstepStep, int]:
        """The on-device path's start: the envs reset, the parameters drawn,
        the ring filled by the warm-up (the spans ``tianshou.setup.init`` and
        ``tianshou.setup.ring_fill``) and the superstep compiled.  Returns
        the step and the warm-up's env steps.  Where the superstep has
        device marks, each ``tianshou.superstep`` span holds its device
        milliseconds (``rollout_ms``, ``presample_ms``, ``updates_ms``;
        ``per_sample_ms`` and ``per_write_back_ms`` where the updates sample
        one by one)."""
        gen = make_generator(self.seed, self.device)
        g_init, g_reset = fork_generator(gen), fork_generator(gen)
        with trace.span("tianshou.setup.init"):
            cstate = self.train_collector.reset(g_reset)
            ts = self.algo.init(g_init)
            bstate = self.buffer.init(self.train_collector.example_transition(ts, cstate), device=self.device)
        env_step = 0
        # warm-up collection (reference start_timesteps)
        if self.warmup_steps > 0:
            warm_len = max(1, self.warmup_steps // self.train_collector.venv.num_envs)
            with trace.span("tianshou.setup.ring_fill"):
                cstate, bstate, stats, _ = self.train_collector.collect(
                    ts, cstate, bstate, warm_len, explore=True, random=self.warmup_random)
            env_step += stats.n_collected_steps
        superstep = self.compiled_superstep = self._compile_superstep(ts, cstate, bstate)
        return SuperstepStep(superstep, ts, cstate, bstate, gen, env_steps=self.steps_per_segment,
                             grad_steps=self.updates_per_segment, param=self.train_param_fn,
                             marks=self.superstep_marks, summarize=self.steps_per_segment), env_step

    def run(self) -> InfoStats:
        """Training in epochs (:func:`~tianshou_tpu_torch.trainer.loop.run_epochs`)
        of the compiled superstep, or over host envs of :class:`HostLoop`'s
        segments or :class:`FusedHostLoop`'s cycles; the whole run is the
        tracer's span ``tianshou.run``."""
        with trace.span("tianshou.run"):
            t_start = time.time()
            host = getattr(self.train_collector, "is_host_collector", False)
            step, env_step = self._host_setup() if host else self._device_setup()

            def test(ts) -> tuple[float, float]:
                stats = self.test_collector.collect_episodes(ts, step.generator, self.episode_per_test,
                                                             explore=False, explore_param=self.test_param)
                return stats.returns_mean, stats.returns_std

            info, self.trace_path = run_epochs(
                step, test, max_epoch=self.max_epoch, step_per_epoch=self.step_per_epoch, t_start=t_start,
                desc="offpolicy", logger=self.logger, save_checkpoint_fn=self.save_checkpoint_fn,
                save_best_fn=self.save_best_fn, stop_fn=self.stop_fn, test_in_train=self.test_in_train,
                resume_from_log=self.resume_from_log, env_step=env_step, smooth_window=self.smooth_window,
                show_progress=self.show_progress, profile_dir=self.profile_dir)
            self.train_state, self.collect_state, self.buffer_state = step.ts, step.cstate, step.bstate
            return info
