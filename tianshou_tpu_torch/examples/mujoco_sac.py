"""SAC on MuJoCo through the host-env bridge (port of
``examples/mujoco_sac.py``; the reference's ``examples/mujoco/mujoco_sac.py``).

Reference hyperparameters: hidden 256x256, actor and critic lr 1e-3, alpha
0.2 (``--auto-alpha``: tuned at lr 3e-4), tau 5e-3, batch 256, a
1,000,000-transition ring, 10,000 random start steps, 1 update an env step.
``--step-per-collect 1`` (one step a env) takes the fused fine cycle, the
reference's one update after each env step.  Needs gymnasium and MuJoCo.

    python -m tianshou_tpu_torch.examples.mujoco_sac --task HalfCheetah-v4 [--device cpu]
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
    p.add_argument("--max-epoch", type=int, default=200)
    p.add_argument("--step-per-epoch", type=int, default=5000)
    p.add_argument("--step-per-collect", type=int, default=8)
    p.add_argument("--update-per-step", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--buffer-size", type=int, default=1000000)
    p.add_argument("--start-timesteps", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    # reference defaults: fixed alpha 0.2 (mujoco_sac.py:31-32: automatic
    # alpha is opt-in there too, and the published runs use the defaults)
    p.add_argument("--alpha", type=float, default=0.2)
    p.add_argument("--auto-alpha", action="store_true")
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``; ``logger`` replaces the
    ``TensorboardLogger`` under ``--logdir``."""
    import gymnasium as gym

    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.host import HostVectorEnv, space_from_gym
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    def make():
        return gym.make(args.task)

    probe = make()
    obs_dim, act_space = probe.observation_space.shape[0], space_from_gym(probe.action_space)
    act_dim = act_space.shape[0]
    probe.close()

    algo = SAC(
        GaussianActor(obs_dim, (256, 256), act_dim, conditioned_sigma=True),
        CriticEnsemble(obs_dim, act_dim, (256, 256), num_critics=2),
        act_space,
        actor_lr=1e-3,
        critic_lr=1e-3,
        alpha=args.alpha,
        alpha_lr=3e-4,
        auto_alpha=args.auto_alpha,
        tau=0.005,
        gamma=0.99,
        device=args.device,
    )
    buffer = ReplayBuffer(args.buffer_size // args.num_envs, args.num_envs)
    train_venv = HostVectorEnv([make for _ in range(args.num_envs)])
    test_venv = HostVectorEnv([make for _ in range(args.test_envs)])
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir or f"log/sac_{args.task}_{args.seed}_{int(time.time())}")
    trainer = OffPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, buffer, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        buffer,
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect * args.num_envs,
        update_per_step=args.update_per_step,
        batch_size=args.batch_size,
        episode_per_test=args.test_envs,
        warmup_steps=args.start_timesteps,
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
        f"SAC/{args.task}: best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step/dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()
