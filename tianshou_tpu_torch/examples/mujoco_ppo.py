"""PPO on MuJoCo through the host-env bridge with observation
normalisation (port of ``examples/mujoco_ppo.py``; the reference's
``examples/mujoco/mujoco_ppo.py``).

Reference hyperparameters: hidden 64x64, lr 3e-4 decaying linearly to 0,
gamma 0.99, GAE 0.95, 8 envs, 2048 steps a collect, 10 passes, batch 64,
observation and return normalisation, no advantage normalisation,
advantages recomputed each pass, sigma initialised at -0.5.  Needs
gymnasium and MuJoCo.

    python -m tianshou_tpu_torch.examples.mujoco_ppo --task HalfCheetah-v4 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="HalfCheetah-v4")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--test-envs", type=int, default=10)  # reference test_num=10 (mujoco_sac.py:43)
    p.add_argument("--max-epoch", type=int, default=100)
    p.add_argument("--step-per-epoch", type=int, default=10000)
    p.add_argument("--step-per-collect", type=int, default=2048)
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--no-lr-decay", action="store_true")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``; ``logger`` replaces the
    ``TensorboardLogger`` under ``log/``."""
    import gymnasium as gym

    from tianshou_tpu_torch.algos.pg import linear_schedule
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.host import NormObsHostVectorEnv, space_from_gym
    from tianshou_tpu_torch.networks.continuous import GaussianActor, ValueNet
    from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer

    def make():
        return gym.make(args.task)

    probe = make()
    obs_dim, act_space = probe.observation_space.shape[0], space_from_gym(probe.action_space)
    probe.close()

    # the reference's decay: linear to zero over every optimizer step
    # (LambdaLR over the minibatch updates, mujoco_ppo.py:118-126)
    total_minibatches = (
        args.max_epoch
        * -(-args.step_per_epoch // args.step_per_collect)
        * args.repeat
        * -(-args.step_per_collect // args.batch_size)
    )
    lr = args.lr if args.no_lr_decay else linear_schedule(args.lr, 0.0, total_minibatches)
    algo = PPO(
        GaussianActor(obs_dim, (64, 64), act_space.shape[0], sigma_init=-0.5),
        ValueNet(obs_dim, (64, 64)),
        act_space,
        lr=lr,
        gamma=0.99,
        gae_lambda=0.95,
        eps_clip=0.2,
        vf_coef=0.25,
        ent_coef=0.0,
        max_grad_norm=0.5,
        adv_norm=False,
        ret_norm=True,
        recompute_advantage=True,
        device=args.device,
    )
    train_venv = NormObsHostVectorEnv([make for _ in range(args.num_envs)])
    test_venv = NormObsHostVectorEnv([make for _ in range(args.test_envs)], update_rms=False)
    test_venv.set_rms(train_venv.get_rms())  # shared live statistics
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(f"log/ppo_{args.task}_{args.seed}_{int(time.time())}")
    trainer = OnPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect,
        repeat_per_collect=args.repeat,
        batch_size=args.batch_size,
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
        f"PPO/{args.task}: best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step/dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()
