"""CQL from a dataset file in D4RL's qlearning schema (port of
``examples/offline_d4rl_cql.py``; the reference's
``examples/offline/d4rl_cql.py``): load an HDF5 or ``.npz`` file
(``observations, actions, rewards, terminals, next_observations``
[, ``timeouts``]), optionally standardise the observations over the
dataset, train CQL(Lagrange) offline, and test on the task's env.

D4RL's own datasets are not needed: ``python -m
tianshou_tpu_torch.examples.make_d4rl_demo out.npz`` writes a small
Pendulum dataset for a complete run.  The test env is the port's own env
of that name when there is one (on the device), else a gymnasium env on
the host.  An ``.npz`` dataset with an env of the port needs neither
``h5py`` nor gymnasium.

    python -m tianshou_tpu_torch.examples.offline_d4rl_cql out.npz --task Pendulum-v1 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("dataset", help="D4RL qlearning-schema .h5/.npz file")
    p.add_argument("--task", default="Pendulum-v1", help="gymnasium id or the port's env name for evaluation")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-epoch", type=int, default=20)
    p.add_argument("--update-per-epoch", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    p.add_argument("--actor-lr", type=float, default=1e-4)
    p.add_argument("--critic-lr", type=float, default=3e-4)
    p.add_argument("--cql-weight", type=float, default=1.0)
    p.add_argument("--no-lagrange", action="store_true")
    p.add_argument("--calibrated", action="store_true", help="CalQL")
    p.add_argument("--normalize-obs", action="store_true")
    p.add_argument("--test-envs", type=int, default=4)
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``: the gymnasium test envs, if the task
    took them.  ``logger`` replaces the ``TensorboardLogger`` under
    ``--logdir``."""
    from tianshou_tpu_torch.algos.offline import CQL
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.persistence import buffer_from_d4rl, normalize_obs_in_buffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import make_env
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor
    from tianshou_tpu_torch.trainer.offline import OfflineTrainer

    buffer, bstate = buffer_from_d4rl(args.dataset, device=args.device)
    if args.normalize_obs:
        bstate, mean, std = normalize_obs_in_buffer(bstate)

    # the test env: the port's env of that name first, a gymnasium env after
    try:
        env = make_env(args.task)
    except (KeyError, ValueError):
        import gymnasium as gym

        from tianshou_tpu_torch.envs.host import HostVectorEnv, space_from_gym

        env = None
        venv = HostVectorEnv([lambda: gym.make(args.task) for _ in range(args.test_envs)])
        obs_space, act_space = venv.observation_space, space_from_gym(venv.action_space)
    else:
        obs_space, act_space = env.observation_space, env.action_space

    obs_dim, act_dim, hidden = obs_space.shape[0], act_space.shape[0], tuple(args.hidden)
    try:
        algo = CQL(
            GaussianActor(obs_dim, hidden, act_dim, conditioned_sigma=True),
            CriticEnsemble(obs_dim, act_dim, hidden, num_critics=2),
            act_space,
            actor_lr=args.actor_lr,
            critic_lr=args.critic_lr,
            cql_weight=args.cql_weight,
            with_lagrange=not args.no_lagrange,
            calibrated=args.calibrated,
            device=args.device,
        )
    except BaseException:
        if env is None:
            venv.close()
        raise
    if env is None:
        test_collector, venvs = HostCollector(algo, venv, device=args.device), [venv]
    else:
        test_collector = Collector(algo, VectorEnv(env, args.test_envs, device=args.device), device=args.device)
        venvs = []
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir or f"log/cql_d4rl_{args.task}_{args.seed}_{int(time.time())}")
    trainer = OfflineTrainer(
        algo, buffer, bstate, test_collector,
        max_epoch=args.max_epoch,
        update_per_epoch=args.update_per_epoch,
        batch_size=args.batch_size,
        episode_per_test=args.test_envs,
        logger=logger,
        seed=args.seed,
        device=args.device,
    )
    return trainer, venvs


def main(argv=None, logger=None):
    args = parser().parse_args(argv)
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    print(
        f"CQL/{args.task} from {os.path.basename(args.dataset)}: "
        f"best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"grad_steps={info.gradient_step} wall={dt:.0f}s"
    )
    return info


if __name__ == "__main__":
    main()
