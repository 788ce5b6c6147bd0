"""REINFORCE on MuJoCo through the host-env bridge (port of
``examples/mujoco_reinforce.py``; the reference's
``examples/mujoco/mujoco_reinforce.py``).

Reference hyperparameters: hidden 64x64, lr 1e-3 decaying linearly to 0
over the updates, gamma 0.99, 10 envs, 2048 steps a collect, one pass and
one whole-rollout minibatch an update, observation and return
normalisation, sigma initialised at -0.5.  The reference squashes sampled
actions with tanh; the package's PG clips them, the reference's other
documented choice.  Needs gymnasium and MuJoCo.

    python -m tianshou_tpu_torch.examples.mujoco_reinforce --task HalfCheetah-v4 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="HalfCheetah-v4")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=10)
    p.add_argument("--test-envs", type=int, default=10)  # reference test_num=10 (mujoco_sac.py:43)
    p.add_argument("--max-epoch", type=int, default=100)
    p.add_argument("--step-per-epoch", type=int, default=30000)
    p.add_argument("--step-per-collect", type=int, default=2048)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--no-lr-decay", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``; ``logger`` replaces the
    ``TensorboardLogger`` under ``--logdir``."""
    import gymnasium as gym

    from tianshou_tpu_torch.algos.pg import PG, linear_schedule
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.host import NormObsHostVectorEnv, space_from_gym
    from tianshou_tpu_torch.networks.continuous import GaussianActor
    from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer

    def make():
        return gym.make(args.task)

    probe = make()
    obs_dim, act_space = probe.observation_space.shape[0], space_from_gym(probe.action_space)
    probe.close()

    total_updates = args.max_epoch * -(-args.step_per_epoch // args.step_per_collect)
    lr = args.lr if args.no_lr_decay else linear_schedule(args.lr, 0.0, total_updates)
    algo = PG(
        GaussianActor(obs_dim, (64, 64), act_space.shape[0], sigma_init=-0.5),
        act_space,
        lr=lr,
        gamma=0.99,
        ret_norm=True,
        device=args.device,
    )
    train_venv = NormObsHostVectorEnv([make for _ in range(args.num_envs)])
    test_venv = NormObsHostVectorEnv([make for _ in range(args.test_envs)], update_rms=False)
    test_venv.set_rms(train_venv.get_rms())
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir or f"log/reinforce_{args.task}_{args.seed}_{int(time.time())}")
    trainer = OnPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect,
        repeat_per_collect=1,
        batch_size=10**9,  # the whole rollout an update (the reference's batch_size=None)
        episode_per_test=args.test_envs,
        seed=args.seed,
        logger=logger,
        device=args.device,
    )
    return trainer, [train_venv, test_venv]


def main(argv=None, logger=None):
    args = parser().parse_args(argv)
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    print(
        f"REINFORCE/{args.task}: best={info.best_reward:.1f}"
        f"±{info.best_reward_std:.1f} env_steps={info.env_step} "
        f"wall={dt:.0f}s steps/s={info.env_step/dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()
