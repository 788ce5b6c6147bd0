"""Off-policy trainer: (collect -> k gradient steps) supersteps (port of
``tianshou_tpu/trainer/offpolicy.py``).

A superstep is a rollout segment into the ring buffer, then ONE presample of
``k * batch`` indices, transitions and n-step chains, then k updates on
slices of it (exact for uniform replay, whose sampling does not depend on
the updates in between); with prioritized replay, or an algorithm that
overrides ``update``, each of the k updates samples its own batch.  The
superstep runs eagerly and keeps its metrics on the device;
:meth:`OffPolicyTrainer.run` reads them once per superstep.
Epochs, test episodes and early stopping stay on the host, as in the JAX
package.

With a :class:`~tianshou_tpu_torch.collect.host_collector.HostCollector`
``run`` takes the host-env path (:meth:`OffPolicyTrainer._run_host`): a
segment collected from host envs, then one host step (:class:`HostStep`):
ONE packed host-to-device copy of the segment, ``add_trajectory`` and the k
updates.  ``pipeline_host_updates`` (default off) acts with the actor from
before the updates in flight, on a side CUDA stream, from a snapshot of it.

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

Both loops take a ``logger`` (train data each superstep, from the metrics
``run`` already read; the counters at each epoch's end, with
``save_checkpoint_fn``; test results), ``resume_from_log`` (the counters
restored from the logger, epochs continued) and ``profile_dir`` (a device
trace of the run, :class:`~tianshou_tpu_torch.trainer.hooks.RunContext`).
None of them adds a launch or a host synchronisation to a superstep.
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
from tianshou_tpu_torch.trainer.hooks import MetricSmoother, RunContext, log_test, log_train, save_epoch
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device

__all__ = ["FusedHostLoop", "HostStep", "OffPolicyTrainer", "build_update_scan"]


def build_update_scan(algo: Algorithm, buffer: ReplayBuffer, batch_size: int, n_updates: int):
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
    through ``algo.update``."""
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
        history: dict[str, list[torch.Tensor]] = {}
        for i in range(n_updates):
            if presampled:
                ts, bstate, metrics = algo.update_sampled(
                    ts, buffer, bstate, tree_map(lambda x: x[i], views), generator)
            else:
                ts, bstate, metrics = algo.update(ts, buffer, bstate, generator, batch_size)
            for k, v in metrics.items():
                history.setdefault(k, []).append(v)
        return ts, bstate, {k: torch.stack(v).mean() for k, v in history.items()}

    return updates


def _read_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Device metrics on the host, in one device-to-host copy."""
    return dict(zip(metrics.keys(), torch.stack(list(metrics.values())).tolist()))


class HostStep:
    """One segment of the host path on the card.  :meth:`upload` is the
    host part: the segment's numpy leaves packed and sent in ONE copy.
    :meth:`device` is the device part: unpack, ``add_trajectory`` and the k
    updates, all queued without a host synchronisation."""

    def __init__(self, collector, buffer: ReplayBuffer, updates_fn):
        self.collector = collector
        self.buffer = buffer
        self.updates_fn = updates_fn

    def upload(self, traj: Batch) -> tuple:
        """The segment's numpy leaves packed and copied to the card
        (:meth:`HostCollector.upload`), for :meth:`device`."""
        return self.collector.upload(traj)

    def device(self, ts, bstate, uploaded: tuple, generator):
        bstate = self.buffer.add_trajectory(bstate, self.collector.unpack(uploaded))
        return self.updates_fn(ts, bstate, generator)

    def __call__(self, ts, bstate, traj: Batch, generator):
        return self.device(ts, bstate, self.upload(traj), generator)


class HostLoop:
    """The host path's carried state and its work a segment: :meth:`collect`
    on the host envs, then :meth:`update` (one :class:`HostStep`).

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
        self.metrics: dict[str, torch.Tensor] | None = None
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
        self.ts, self.bstate, self.metrics = self.host_step(self.ts, self.bstate, traj, self.generator)
        self.ts_act = algo.with_act_params(self.ts, self.snapshot) if self.pipelined else self.ts

    def read_metrics(self) -> dict[str, float]:
        """The last segment's mean metrics, in one device-to-host copy."""
        return _read_metrics(self.metrics)


class FusedHostLoop:
    """The fused fine host cycle, for segments of one step per env: the
    reference's collect-one-step / update order with one host
    synchronisation a cycle.

    :meth:`step_envs` steps the envs with the pending action (host);
    :meth:`upload` sends the transition and the next observation in ONE
    packed copy; :meth:`device` adds the transition to the ring, runs the k
    updates and acts on the next observation with the updated parameters,
    all queued without a host synchronisation; :meth:`cycle` does the three
    and fetches the env action, the cycle's one synchronisation.  The
    updates and the acting draw from one stream, in order, so a seed fixes
    the run."""

    def __init__(self, trainer: OffPolicyTrainer, ts, bstate, generator):
        self.trainer = trainer
        self.ts, self.bstate = ts, bstate
        self.generator = generator
        self.updates_fn = build_update_scan(trainer.algo, trainer.buffer, trainer.batch_size,
                                            trainer.updates_per_segment)
        self.metrics: dict[str, torch.Tensor] | None = None
        self.raw_act: torch.Tensor | None = None  # the pending action, on the device
        self.env_act_device: torch.Tensor | None = None
        self.env_act: np.ndarray | None = None  # the pending action, fetched
        self._packer = None

    def prime(self, explore_param: float) -> None:
        """The first action, from the current observations."""
        col, algo = self.trainer.train_collector, self.trainer.algo
        self.raw_act = algo.act(self.ts, col._device_obs(col.obs), self.generator, True, explore_param)
        self.env_act = algo.map_action(self.raw_act).cpu().numpy()

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
        """``host`` packed and sent to the card in one copy."""
        self._packer = self.trainer.train_collector._packer(host)
        return self._packer.to_device(host)

    def device(self, flat: torch.Tensor, explore_param: float) -> None:
        """The transition into the ring, the k updates, and the next action
        from the updated parameters, queued on the card."""
        algo = self.trainer.algo
        h = self._packer.unpack(flat)
        transition = Batch(obs=h["obs"], act=self.raw_act, rew=h["rew"], terminated=h["terminated"],
                           truncated=h["truncated"], obs_next=h["obs_next"])
        self.bstate = self.trainer.buffer.add(self.bstate, transition)
        self.ts, self.bstate, self.metrics = self.updates_fn(self.ts, self.bstate, self.generator)
        self.raw_act = algo.act(self.ts, h["carry"], self.generator, True, explore_param)
        self.env_act_device = algo.map_action(self.raw_act)

    def cycle(self, explore_param: float) -> CollectStats:
        """One cycle; ``explore_param`` is the schedule's value for the step
        at which the next action executes."""
        stats, host = self.step_envs()
        self.device(self.upload(host), explore_param)
        self.env_act = self.env_act_device.cpu().numpy()  # the cycle's one synchronisation
        return stats

    def read_metrics(self) -> dict[str, float]:
        """The last cycle's mean metrics, in one device-to-host copy."""
        return _read_metrics(self.metrics)


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

        num_envs = train_collector.venv.num_envs
        # steps per env per collect segment (the reference counts total env steps)
        self.segment_len = max(1, step_per_collect // num_envs)
        self.steps_per_segment = self.segment_len * num_envs
        self.updates_per_segment = max(1, round(update_per_step * self.steps_per_segment))

    def _build_superstep(self):
        """``superstep(ts, cstate, bstate, generator, explore_param) -> (ts,
        cstate, bstate, outputs, metrics)``."""
        seg = rollout_segment(
            self.algo, self.train_collector.venv, self.buffer, self.segment_len, explore=True,
            reward_metric=self.train_collector.reward_metric,
        )
        updates_fn = build_update_scan(
            self.algo, self.buffer, self.batch_size, self.updates_per_segment
        )

        def superstep(ts, cstate, bstate, generator, explore_param):
            cstate, bstate, outputs = seg(ts, cstate, bstate, explore_param)
            ts, bstate, metrics = updates_fn(ts, bstate, generator)
            return ts, cstate, bstate, outputs, metrics

        return superstep

    def _build_host_step(self) -> HostStep:
        updates_fn = build_update_scan(self.algo, self.buffer, self.batch_size, self.updates_per_segment)
        return HostStep(self.train_collector, self.buffer, updates_fn)

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

    def _run_host(self) -> InfoStats:
        """Training over host envs: per segment, the host steps the envs
        (acting on the card), then one host step sends the segment and runs
        the updates.  Metrics are read every ~4096 env steps and once at the
        end."""
        t_start = time.time()
        smooth = MetricSmoother(self.smooth_window)
        loop, env_step = self._host_setup()
        grad_step = start_epoch = 0
        if self.resume_from_log and self.logger is not None:
            start_epoch, restored_step, grad_step = self.logger.restore_data()
            env_step += restored_step
        best_reward, best_reward_std = -np.inf, 0.0
        last_metrics: dict = {}
        metrics_interval = max(1, 4096 // self.steps_per_segment)
        seg_count = 0
        stop_triggered = False
        epoch = 0
        with RunContext((self.max_epoch - start_epoch) * self.step_per_epoch, self.show_progress, self.profile_dir,
                        desc="offpolicy") as rc:
            for epoch in range(start_epoch + 1, self.max_epoch + 1):
                steps_this_epoch = 0
                while steps_this_epoch < self.step_per_epoch:
                    explore_param = float(self.train_param_fn(epoch, env_step))
                    if self.last_run_used_fused:
                        if loop.env_act is None:
                            loop.prime(explore_param)
                        if loop.metrics is not None and seg_count % metrics_interval == 0:
                            last_metrics = smooth(loop.read_metrics())
                        seg_count += 1
                        # the action computed in this cycle executes at the
                        # next step: its schedule value is that step's
                        stats = loop.cycle(float(self.train_param_fn(epoch, env_step + self.steps_per_segment)))
                    else:
                        stats, traj = loop.collect(explore_param)
                        # the previous segment's metrics, read after this
                        # segment's collection so that it does not wait on them
                        if loop.metrics is not None and seg_count % metrics_interval == 0:
                            last_metrics = smooth(loop.read_metrics())
                        seg_count += 1
                        loop.update(traj)
                    env_step += self.steps_per_segment
                    steps_this_epoch += self.steps_per_segment
                    grad_step += self.updates_per_segment
                    rc.step(self.steps_per_segment, last_metrics)
                    if (
                        self.test_in_train
                        and self.stop_fn is not None
                        and stats.returns.size
                        and self.stop_fn(stats.returns_mean)
                    ):
                        tt = self.test_collector.collect_episodes(
                            loop.ts, loop.generator, self.episode_per_test, explore=False,
                            explore_param=self.test_param)
                        if self.stop_fn(tt.returns_mean):
                            best_reward = max(best_reward, tt.returns_mean)
                            best_reward_std = tt.returns_std
                            stop_triggered = True
                            break
                    log_train(self.logger, env_step, stats, last_metrics)
                if stop_triggered:
                    break
                save_epoch(self.logger, self.save_checkpoint_fn, epoch, env_step, grad_step)
                test_stats = self.test_collector.collect_episodes(
                    loop.ts, loop.generator, self.episode_per_test, explore=False, explore_param=self.test_param)
                rew, rew_std = test_stats.returns_mean, test_stats.returns_std
                if rew > best_reward:
                    best_reward, best_reward_std = rew, rew_std
                    if self.save_best_fn is not None:
                        self.save_best_fn(loop.ts)
                log_test(self.logger, rew, rew_std, env_step)
                if self.stop_fn is not None and self.stop_fn(rew):
                    stop_triggered = True
                    break
        self.trace_path = rc.trace_path
        if loop.metrics is not None:
            last_metrics = smooth(loop.read_metrics())

        self.train_state = loop.ts
        self.buffer_state = loop.bstate
        return InfoStats(
            gradient_step=grad_step,
            env_step=env_step,
            epoch=epoch,
            best_reward=float(best_reward),
            best_reward_std=float(best_reward_std),
            duration=time.time() - t_start,
            stop_triggered=stop_triggered,
            last_metrics=last_metrics,
        )

    def run(self) -> InfoStats:
        if getattr(self.train_collector, "is_host_collector", False):
            return self._run_host()
        t_start = time.time()
        smooth = MetricSmoother(self.smooth_window)
        gen = make_generator(self.seed, self.device)
        g_init, g_reset = fork_generator(gen), fork_generator(gen)

        cstate = self.train_collector.reset(g_reset)
        ts = self.algo.init(g_init)
        bstate = self.buffer.init(
            self.train_collector.example_transition(ts, cstate), device=self.device
        )

        env_step = grad_step = start_epoch = 0
        if self.resume_from_log and self.logger is not None:
            start_epoch, env_step, grad_step = self.logger.restore_data()
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
        with RunContext((self.max_epoch - start_epoch) * self.step_per_epoch, self.show_progress, self.profile_dir,
                        desc="offpolicy") as rc:
            for epoch in range(start_epoch + 1, self.max_epoch + 1):
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
                    log_train(self.logger, env_step, stats, last_metrics)

                if stop_triggered:
                    break
                save_epoch(self.logger, self.save_checkpoint_fn, epoch, env_step, grad_step)
                test_stats = self.test_collector.collect_episodes(
                    ts, gen, self.episode_per_test,
                    explore=False, explore_param=self.test_param,
                )
                rew, rew_std = test_stats.returns_mean, test_stats.returns_std
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
