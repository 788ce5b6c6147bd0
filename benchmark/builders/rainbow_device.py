"""Rainbow (C51 with noisy dueling streams over the Nature CNN, on
prioritized replay) on ``OffPolicyTrainer``'s on-device path, built from a
configuration and a traffic mix through the port's public classes.

The updates sample one by one (a prioritized ring), so a superstep holds
``updates`` draws.  :class:`RecordingRainbow` keeps what
:mod:`benchmark.builders.dqn_device`'s ``RecordingDQN`` keeps, with a
pass's draws gathered into one ``env_idx`` and one ``pos`` in the updates'
order, and the state of the generator the rollout acted from before each
followed superstep (the first act's of the first superstep, then read
before each launch).  :class:`RecordingPrioritizedBuffer` keeps each
update's written ``|td|`` (the cross-entropy) in the pass, and its
:meth:`~RecordingPrioritizedBuffer.current` view carries, besides the
ring, the sum tree, ``max_prio``, ``min_prio`` and ``beta``, the pass's
written ``|td|`` (``written_td``, ``[updates, batch]``) and the acting
generator's state (``act_rng``), which the reference
(:mod:`benchmark.reference.rainbow`) reads from the snapshot.  A capture's
tensors are the graph's own, which every replay writes: held, they read
each replay's values.  The network draws no weights of its own: it loads
the benchmark's (:func:`benchmark.reference.rainbow.make_weights`).

A traced run (``--trace 1``) turns the program's tracer on before the
program is built, so that the captured superstep holds its device marks
and the superstep spans carry ``per_sample_ms`` and ``per_write_back_ms``,
with its spans kept out of the profiler's records (``ranges=False``): the
benchmark's sub-window (:mod:`benchmark.subwindow`) counts every record on
the device track but its own ``bench.*`` annotations as device work.
"""

from __future__ import annotations

import torch

from benchmark.builders.dqn_device import _capturing, _env
from benchmark.reference.rainbow import make_weights
from tianshou_tpu_torch.algos.c51 import Rainbow
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBufferState
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.networks.discrete import ConvC51Net
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer
from tianshou_tpu_torch.utils import trace

__all__ = ["RecordingRainbow", "RecordingPrioritizedBuffer", "build", "eps_schedule"]


class BenchConvC51Net(ConvC51Net):
    """A :class:`ConvC51Net` whose ``reset_parameters`` loads the
    benchmark's weights (``bench = (config, seed)``)."""

    bench: tuple | None = None

    def reset_parameters(self, generator=None):
        if self.bench is None:
            return super().reset_parameters(generator)
        named = dict(self.named_parameters())
        weights = make_weights(*self.bench, next(self.parameters()).device)
        if set(named) != set(weights):
            raise ValueError(f"the network's parameters {sorted(named)} are not the benchmark's {sorted(weights)}")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(weights[name])


class RecordingRainbow(Rainbow):
    train_state = None
    sample_generator: torch.Generator | None = None
    first_sample_state: torch.Tensor | None = None
    act_generator: torch.Generator | None = None
    #: the superstep about to run (set by the benchmark's train_param_fn)
    current_superstep = 0
    #: whether passes are recorded (the benchmark stops it after the
    #: supersteps it follows)
    recording = True

    def init(self, generator):
        ts = self.train_state = super().init(generator)
        self.passes: list[dict] = []
        self.act_states: list[torch.Tensor] = []
        names = {p: n for n, p in ts.online.named_parameters()}

        def first_step_grads(optimizer, args, kwargs):
            rec = self.passes[-1] if self.passes and self.recording else None
            if rec is not None and rec["grads"] is None:
                rec["grads"] = {names[p]: p.grad for g in optimizer.param_groups for p in g["params"]}

        ts.optimizer.register_step_pre_hook(first_step_grads)
        return ts

    def act(self, ts, obs, generator, explore, explore_param=0.0):
        if explore and self.act_generator is None:
            # the first acting step of the first superstep's warm-up
            self.act_generator = generator
            self.act_states.append(generator.get_state())
        return super().act(ts, obs, generator, explore, explore_param)

    def before_launch(self) -> None:
        """The acting generator's state before a later followed superstep."""
        if self.recording and self.act_generator is not None:
            self.act_states.append(self.act_generator.get_state())

    def presample(self, buffer, bstate, generator, batch_size):
        if self.sample_generator is None:
            self.sample_generator = generator
            self.first_sample_state = generator.get_state()
        sampled = super().presample(buffer, bstate, generator, batch_size)
        if self.recording:
            key = (self.current_superstep, _capturing())
            if not self.passes or self.passes[-1]["key"] != key:
                self.passes.append({"key": key, "superstep": key[0], "capturing": key[1], "losses": [],
                                    "grads": None, "draws": [], "written": []})
            self.passes[-1]["draws"].append((sampled[0], sampled[1]))
        return sampled

    def update_sampled(self, ts, buffer, bstate, sampled, generator=None, noise=None):
        ts, bstate, metrics = super().update_sampled(ts, buffer, bstate, sampled, generator, noise)
        if self.recording:
            self.passes[-1]["losses"].append(metrics["loss"])
        return ts, bstate, metrics

    def superstep_pass(self, s: int) -> dict:
        """The pass whose tensors hold superstep ``s``'s values (its own
        eager pass, else the latest capture), its draws concatenated."""
        eager = [r for r in self.passes if r["superstep"] == s and not r["capturing"]]
        rec = eager[-1] if eager else [r for r in self.passes if r["capturing"]][-1]
        return {**rec, "env_idx": torch.cat([e for e, _ in rec["draws"]]),
                "pos": torch.cat([p for _, p in rec["draws"]])}


class RecordingPrioritizedBuffer(PrioritizedReplayBuffer):
    """Keeps the state that ``init`` returns, which a CUDA graph's static
    state keeps and writes in place, and on the CPU, where supersteps run
    eagerly and return new states, the last one that ``add`` or a
    write-back returned; records each write-back's ``|td|`` in the
    recorder's (:class:`RecordingRainbow`) current pass."""

    state = None
    latest = None
    recorder: RecordingRainbow | None = None

    def init(self, example_transition, device="cuda"):
        self.state = self.latest = super().init(example_transition, device)
        return self.state

    def add(self, state, transition):
        self.latest = super().add(state, transition)
        return self.latest

    def update_priorities(self, state, env_idx, pos, td_abs):
        if self.recorder is not None and self.recorder.recording:
            self.recorder.passes[-1]["written"].append(td_abs)
        self.latest = super().update_priorities(state, env_idx, pos, td_abs)
        return self.latest

    def current(self) -> ReplayBufferState:
        """The buffer state between two supersteps, as a ring whose storage
        also holds the tree, its scalars, the last followed superstep's
        written ``|td|`` and the acting generator's state before it."""
        state = self.state if self.state.cursor.is_cuda else self.latest
        algo = self.recorder
        rec = algo.superstep_pass(algo.current_superstep)
        written = torch.stack(rec["written"]) if rec["written"] else state.tree.new_zeros((0, 0))
        extra = {"tree": state.tree, "max_prio": state.max_prio.reshape(1), "min_prio": state.min_prio.reshape(1),
                 "beta": state.beta.reshape(1), "written_td": written,
                 "act_rng": algo.act_states[algo.current_superstep - 1]}
        return ReplayBufferState(storage={**state.storage, **extra}, cursor=state.cursor, size=state.size)


def _network(config: dict, obs_shape, num_actions: int, seed: int) -> BenchConvC51Net:
    head = config["network"]["head"]
    net = BenchConvC51Net(obs_shape, num_actions, num_atoms=head["num_atoms"], hidden=head["hidden"],
                          noisy_std=head["noisy_std"],
                          encoder_kwargs={"compute_dtype": getattr(torch, config["compute_dtype"])})
    net.bench = (config, seed)
    return net


def eps_schedule(config: dict):
    """No epsilon: the noisy net explores through its weight noise."""

    def eps(env_step: int) -> float:
        return 0.0

    return eps


def build(config: dict, traffic: dict, seed: int, device: str, logger, train_param_fn, stop_fn):
    """``(trainer, algo, buffer)`` of one cell: ``train_param_fn(epoch,
    env_step)`` and ``stop_fn`` are the benchmark's; ``logger.run`` is the
    benchmark's run, whose ``traced`` turns the program's tracer on."""
    if logger.run.traced:
        trace.enable(ranges=False)
    env = _env(config)
    num_envs, segment = traffic["num_envs"], traffic["segment"]
    steps = num_envs * segment
    head = config["network"]["head"]
    algo = RecordingRainbow(
        _network(config, env.observation_space.shape, env.action_space.n, seed), env.action_space,
        num_atoms=head["num_atoms"], v_min=head["v_min"], v_max=head["v_max"], lr=config["lr"],
        gamma=config["gamma"], n_step=config["n_step"], target_update_freq=config["target_update_freq"],
        is_double=config["is_double"], device=device)
    buffer = RecordingPrioritizedBuffer(
        traffic["capacity"], num_envs, stack_num=config["frames_stack"], alpha=config["alpha"],
        beta=config["beta"], weight_norm=config["weight_norm"], save_only_last_obs=config["save_only_last_obs"],
        ignore_obs_next=config["ignore_obs_next"])
    buffer.recorder = algo

    def param_fn(epoch: int, env_step: int) -> float:
        algo.before_launch()
        return train_param_fn(epoch, env_step)

    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, num_envs, device=device), buffer, device=device),
        Collector(algo, VectorEnv(env, traffic["test_envs"], device=device), device=device),
        buffer,
        max_epoch=1_000_000,
        step_per_epoch=traffic["step_per_epoch"],
        step_per_collect=steps,
        update_per_step=traffic["updates"] / steps,
        batch_size=traffic["batch"],
        episode_per_test=traffic["episodes"],
        train_param_fn=param_fn,
        test_param=config["eps_test"],
        stop_fn=stop_fn,
        warmup_steps=traffic["warmup_steps"],
        logger=logger,
        seed=seed,
        device=device,
    )
    return trainer, algo, buffer
