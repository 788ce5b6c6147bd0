"""DQN on ``OffPolicyTrainer``'s on-device path, built from a configuration
and a traffic mix through the port's public classes.

The benchmark reaches the program's state only through the arguments it
passes: :class:`RecordingDQN` keeps the train state that ``init`` returns
and, at the first ``presample``, the generator the superstep samples from
and that generator's state; for every pass through the superstep's Python
(the CUDA graph's eager warm-up and its capture, or every eager superstep on
the CPU) it keeps the replay indices that the presample returns, each
update's loss tensor and the gradients the optimizer's first step gets (an
optimizer step pre-hook).  A capture's
tensors are the graph's own, which every replay writes: held, they read
each replay's values.  :class:`RecordingBuffer` keeps the buffer state
that ``init`` returns.  All of it is recorded on the host: a replay runs
none of it.  The network draws no weights of its own: it loads the
benchmark's (:mod:`benchmark.weights`).
"""

from __future__ import annotations

import torch

from benchmark.weights import make_weights
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.conv import ConvQNet
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

__all__ = ["RecordingDQN", "RecordingBuffer", "build"]


class _BenchWeights:
    """A network whose ``reset_parameters`` loads the benchmark's weights
    (``bench = (config, seed)``) instead of drawing its own."""

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


class BenchConvQNet(_BenchWeights, ConvQNet):
    pass


class BenchQNet(_BenchWeights, QNet):
    pass


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class RecordingDQN(DQN):
    train_state = None
    sample_generator: torch.Generator | None = None
    first_sample_state: torch.Tensor | None = None
    #: the superstep about to run (set by the benchmark's train_param_fn)
    current_superstep = 0
    #: whether passes are recorded (the benchmark stops it after the
    #: supersteps it follows)
    recording = True

    def init(self, generator):
        ts = self.train_state = super().init(generator)
        self.passes: list[dict] = []
        names = {p: n for n, p in ts.online.named_parameters()}

        def first_step_grads(optimizer, args, kwargs):
            rec = self.passes[-1] if self.passes and self.recording else None
            if rec is not None and rec["grads"] is None:
                rec["grads"] = {names[p]: p.grad for g in optimizer.param_groups for p in g["params"]}

        ts.optimizer.register_step_pre_hook(first_step_grads)
        return ts

    def presample(self, buffer, bstate, generator, batch_size):
        if self.sample_generator is None:
            self.sample_generator = generator
            self.first_sample_state = generator.get_state()
        sampled = super().presample(buffer, bstate, generator, batch_size)
        if self.recording:
            self.passes.append({"superstep": self.current_superstep, "capturing": _capturing(), "losses": [],
                                "grads": None, "env_idx": sampled[0], "pos": sampled[1]})
        return sampled

    def update_sampled(self, ts, buffer, bstate, sampled, generator=None):
        ts, bstate, metrics = super().update_sampled(ts, buffer, bstate, sampled, generator)
        if self.recording:
            self.passes[-1]["losses"].append(metrics["loss"])
        return ts, bstate, metrics

    def superstep_pass(self, s: int) -> dict:
        """The pass whose tensors hold superstep ``s``'s values: its own
        eager pass, else the latest capture (whose graph it replayed)."""
        eager = [r for r in self.passes if r["superstep"] == s and not r["capturing"]]
        if eager:
            return eager[-1]
        return [r for r in self.passes if r["capturing"]][-1]


class RecordingBuffer(ReplayBuffer):
    """Keeps the state that ``init`` returns, which a CUDA graph's static
    state keeps and writes in place, and on the CPU, where supersteps run
    eagerly and return new states, the last one that ``add`` returned."""

    state = None
    latest = None

    def init(self, example_transition, device="cuda"):
        self.state = super().init(example_transition, device)
        return self.state

    def add(self, state, transition):
        self.latest = super().add(state, transition)
        return self.latest

    def current(self):
        """The buffer state between two supersteps."""
        return self.state if self.state.cursor.is_cuda else self.latest


def _env(config: dict):
    e = config["env"]
    if e["kind"] == "synthetic_pixel":
        return SyntheticPixelEnv(e["height"], e["width"], e["channels"], num_actions=e["num_actions"],
                                 episode_len=e["episode_len"], channel_first=e["channel_first"])
    if e["kind"] == "cartpole":
        return CartPole()
    raise ValueError(f"no env kind {e['kind']!r}")


def _network(config: dict, obs_shape, num_actions: int, seed: int):
    n = config["network"]
    dtype = getattr(torch, config["compute_dtype"])
    if n["kind"] == "nature_cnn":
        net = BenchConvQNet(obs_shape, num_actions, "nature", encoder_kwargs={"compute_dtype": dtype})
    elif n["kind"] == "mlp":
        net = BenchQNet(obs_shape, tuple(n["hidden_sizes"]), num_actions,
                        compute_dtype=None if dtype == torch.float32 else dtype)
    else:
        raise ValueError(f"no network kind {n['kind']!r}")
    net.bench = (config, seed)
    return net


def eps_schedule(config: dict):
    """The train exploration: linear from ``eps_train`` to
    ``eps_train_final`` over ``eps_decay_steps`` env steps."""
    start, final, steps = config["eps_train"], config["eps_train_final"], config["eps_decay_steps"]

    def eps(env_step: int) -> float:
        return start + min(1.0, env_step / steps) * (final - start)

    return eps


def build(config: dict, traffic: dict, seed: int, device: str, logger, train_param_fn, stop_fn):
    """``(trainer, algo, buffer)`` of one cell: ``train_param_fn(epoch,
    env_step)`` and ``stop_fn`` are the benchmark's."""
    env = _env(config)
    num_envs, segment = traffic["num_envs"], traffic["segment"]
    steps = num_envs * segment
    algo = RecordingDQN(
        _network(config, env.observation_space.shape, env.action_space.n, seed), env.action_space,
        lr=config["lr"], gamma=config["gamma"], n_step=config["n_step"],
        target_update_freq=config["target_update_freq"], is_double=config["is_double"], huber=config["huber"],
        device=device)
    stacked = config.get("save_only_last_obs", False)
    buffer = RecordingBuffer(traffic["capacity"], num_envs, stack_num=config.get("frames_stack", 1) if stacked else 1,
                             save_only_last_obs=stacked, ignore_obs_next=config.get("ignore_obs_next", False))
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
        train_param_fn=train_param_fn,
        test_param=config["eps_test"],
        stop_fn=stop_fn,
        warmup_steps=traffic["warmup_steps"],
        logger=logger,
        seed=seed,
        device=device,
    )
    return trainer, algo, buffer
