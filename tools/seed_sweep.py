#!/usr/bin/env python3
"""A learning-threshold configuration over several seeds, in both
packages, on the CPU.

``--config per_dqn`` (the default) is the JAX package's PER test
(tests/test_prio.py ``test_per_dqn_smoke``): ``QNet((64, 64))``, gamma 0.9,
3-step returns, a target copy every 100 updates, a
``PrioritizedReplayBuffer(1000, 8 envs, alpha 0.6, beta 0.4)``, 8 envs, 3
epochs of 5,000 steps, 80 steps a collect, 10 updates of batch 64 a
collect, epsilon 0.1, 500 warm-up steps, stopping at a test reward of 150.
``--config fqf`` is tests/test_distributional_e2e.py ``test_fqf_cartpole``:
FQF over a ``FullQuantileFunction((128, 128))`` with 32 fractions, lr
3e-3, fraction lr 2.5e-9, gamma 0.95, 3-step returns, a target copy every
320 updates, a uniform ring of 2,000 x 10 envs, 8 epochs of 8,000 steps,
100 steps and 10 updates of batch 64 a collect, epsilon 0.1, 1,000 warm-up
steps, stopping at 180.
``--config quickstart`` is README.md's Quick start through each package's
high-level builder: ``DQNExperimentBuilder`` on CartPole with
``SamplingConfig(num_epochs=10, step_per_epoch=10000, step_per_collect=100,
update_per_step=0.1)`` and ``DQNParams()`` (MLP (128, 128), gamma 0.99,
3-step returns, a target copy every 320 updates, epsilon 0.1, 16 envs, a
ring of 20,000, batch 64), stopping at 195.
``--config fused_dqn`` is tests/test_fused_host.py
``test_fused_cycle_dqn_cartpole_learns``: the host path's fused fine cycle
over 8 gymnasium CartPole-v1 envs, one step each a cycle, ``QNet((128,
128, 128))``, gamma 0.9, 3-step returns, a target copy every 320 updates,
a ring of 2,000 x 8 envs, 4 epochs of 10,000 steps, one update of batch 64
a cycle, epsilon 0.1, 1,000 warm-up steps, stopping at 195.

Each (package, seed) runs in a process of its own, ``--workers`` at a
time, and prints its best test reward; the last line is a JSON object with
every result.  The two packages' random streams (Threefry and Philox)
share nothing, so a seed names a different run in each: compare how many
seeds reach the threshold, not seed by seed.

    python3 tools/seed_sweep.py [--config per_dqn|fqf|quickstart|fused_dqn] [--seeds 0 1 2 3 4] [--workers 4]

This script is a comparison between the two packages and imports each in
its own process; the port itself imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# config: threshold, envs, and the trainer's schedule
CONFIGS = {
    "per_dqn": (150.0, 8, dict(max_epoch=3, step_per_epoch=5000, step_per_collect=80, update_per_step=0.125,
                               batch_size=64, warmup_steps=500)),
    "fqf": (180.0, 10, dict(max_epoch=8, step_per_epoch=8000, step_per_collect=100, update_per_step=0.1,
                            batch_size=64, warmup_steps=1000)),
    "quickstart": (195.0, 16, dict(num_epochs=10, step_per_epoch=10000, step_per_collect=100, update_per_step=0.1)),
    "fused_dqn": (195.0, 8, dict(max_epoch=4, step_per_epoch=10000, step_per_collect=8, update_per_step=0.125,
                                 batch_size=64, warmup_steps=1000)),
}


def _quickstart(highlevel, env_factory, seed: int, **config) -> float:
    """README.md's Quick start through a package's builder (its modules
    ``config`` and ``experiment``)."""
    sampling_config, experiment = highlevel
    threshold, _, sampling = CONFIGS["quickstart"]
    exp = (experiment.DQNExperimentBuilder(env_factory, config=experiment.ExperimentConfig(logger="none", **config),
                                           sampling=sampling_config.SamplingConfig(**sampling))
           .with_seed(seed).with_stop_fn(lambda rew: rew >= threshold).build())
    return float(exp.run().info.best_reward)


def _run_jax(config: str, seed: int) -> float:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tianshou_tpu.algos.dqn import DQN
    from tianshou_tpu.algos.qrdqn import FQF
    from tianshou_tpu.collect.collector import Collector
    from tianshou_tpu.data.buffer import ReplayBuffer
    from tianshou_tpu.data.prio import PrioritizedReplayBuffer
    from tianshou_tpu.envs.base import VectorEnv
    from tianshou_tpu.envs.classic import CartPole
    from tianshou_tpu.networks.common import QNet
    from tianshou_tpu.networks.discrete import FractionProposalNetwork, FullQuantileFunction
    from tianshou_tpu.trainer.offpolicy import OffPolicyTrainer

    if config == "quickstart":
        from tianshou_tpu.highlevel import config as hl_config
        from tianshou_tpu.highlevel import experiment as hl_experiment
        from tianshou_tpu.highlevel.env import JaxEnvFactory

        return _quickstart((hl_config, hl_experiment), JaxEnvFactory("CartPole-v1"), seed)
    threshold, n, schedule = CONFIGS[config]
    if config == "fused_dqn":
        import gymnasium as gym

        from tianshou_tpu.collect.host_collector import HostCollector
        from tianshou_tpu.envs.host import HostVectorEnv

        algo = DQN(network=QNet((128, 128, 128), 2), action_space=CartPole.action_space, gamma=0.9, n_step=3,
                   target_update_freq=320)
        buffer = ReplayBuffer(capacity=2000, num_envs=n)
        venvs = [HostVectorEnv([lambda: gym.make("CartPole-v1")] * n) for _ in range(2)]
        trainer = OffPolicyTrainer(algo, HostCollector(algo, venvs[0], buffer), HostCollector(algo, venvs[1]),
                                   buffer, train_param_fn=lambda e, s: 0.1, stop_fn=lambda rew: rew >= threshold,
                                   seed=seed, **schedule)
        info = trainer.run()
        if not trainer.last_run_used_fused:
            raise RuntimeError("the fused fine cycle did not apply")
        return float(info.best_reward)
    env = CartPole()
    if config == "per_dqn":
        algo = DQN(network=QNet((64, 64), 2), action_space=env.action_space, gamma=0.9, n_step=3,
                   target_update_freq=100)
        buffer = PrioritizedReplayBuffer(capacity=1000, num_envs=n, alpha=0.6, beta=0.4)
    else:
        algo = FQF(FullQuantileFunction((128, 128), 2), FractionProposalNetwork(num_fractions=32), env.action_space,
                   num_fractions=32, fraction_lr=2.5e-9, lr=3e-3, gamma=0.95, n_step=3, target_update_freq=320)
        buffer = ReplayBuffer(capacity=2000, num_envs=n)
    trainer = OffPolicyTrainer(algo, Collector(algo, VectorEnv(env, n), buffer), Collector(algo, VectorEnv(env, n)),
                               buffer, train_param_fn=lambda e, s: 0.1, stop_fn=lambda rew: rew >= threshold,
                               seed=seed, **schedule)
    return float(trainer.run().best_reward)


def _run_torch(config: str, seed: int) -> float:
    import torch

    torch.set_num_threads(1)
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.algos.qrdqn import FQF
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.discrete import FractionProposalNetwork, FullQuantileFunction
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    if config == "quickstart":
        from tianshou_tpu_torch.highlevel import config as hl_config
        from tianshou_tpu_torch.highlevel import experiment as hl_experiment
        from tianshou_tpu_torch.highlevel.env import TorchEnvFactory

        return _quickstart((hl_config, hl_experiment), TorchEnvFactory("CartPole-v1"), seed, device="cpu")
    threshold, n, schedule = CONFIGS[config]
    if config == "fused_dqn":
        import gymnasium as gym

        from tianshou_tpu_torch.collect.host_collector import HostCollector
        from tianshou_tpu_torch.envs.host import HostVectorEnv

        algo = DQN(QNet(4, (128, 128, 128), 2), CartPole.action_space, gamma=0.9, n_step=3, target_update_freq=320,
                   device="cpu")
        buffer = ReplayBuffer(capacity=2000, num_envs=n)
        venvs = [HostVectorEnv([lambda: gym.make("CartPole-v1")] * n) for _ in range(2)]
        trainer = OffPolicyTrainer(
            algo, HostCollector(algo, venvs[0], buffer, device="cpu"), HostCollector(algo, venvs[1], device="cpu"),
            buffer, train_param_fn=lambda e, s: 0.1, stop_fn=lambda rew: rew >= threshold, seed=seed, device="cpu",
            **schedule)
        info = trainer.run()
        if not trainer.last_run_used_fused:
            raise RuntimeError("the fused fine cycle did not apply")
        return float(info.best_reward)
    env = CartPole()
    if config == "per_dqn":
        algo = DQN(QNet(4, (64, 64), 2), env.action_space, gamma=0.9, n_step=3, target_update_freq=100, device="cpu")
        buffer = PrioritizedReplayBuffer(capacity=1000, num_envs=n, alpha=0.6, beta=0.4)
    else:
        algo = FQF(FullQuantileFunction(4, (128, 128), 2), FractionProposalNetwork(128, 32), env.action_space,
                   num_fractions=32, fraction_lr=2.5e-9, lr=3e-3, gamma=0.95, n_step=3, target_update_freq=320,
                   device="cpu")
        buffer = ReplayBuffer(capacity=2000, num_envs=n)
    trainer = OffPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, n, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, n, device="cpu"), device="cpu"), buffer, train_param_fn=lambda e, s: 0.1,
        stop_fn=lambda rew: rew >= threshold, seed=seed, device="cpu", **schedule)
    return float(trainer.run().best_reward)


def _one(job: tuple[str, str, int]) -> tuple[str, int, float, float]:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    config, package, seed = job
    t0 = time.perf_counter()
    best = (_run_jax if package == "jax" else _run_torch)(config, seed)
    return package, seed, best, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="per_dqn")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args()
    threshold = CONFIGS[args.config][0]
    jobs = [(args.config, package, seed) for seed in args.seeds for package in ("jax", "torch")]
    results: dict[str, dict[int, float]] = {"jax": {}, "torch": {}}
    with mp.get_context("spawn").Pool(args.workers, maxtasksperchild=1) as pool:
        for package, seed, best, secs in pool.imap_unordered(_one, jobs):
            results[package][seed] = best
            print(f"{package} seed {seed}: best test reward {best:.2f} ({secs:.0f} s)", flush=True)
    summary = {p: {"best": dict(sorted(r.items())), "reached": sum(v >= threshold for v in r.values())}
               for p, r in results.items()}
    print(json.dumps({"config": args.config, "threshold": threshold, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
