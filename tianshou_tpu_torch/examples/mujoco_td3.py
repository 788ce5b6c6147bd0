"""TD3 or DDPG on MuJoCo through the host-env bridge (port of
``examples/mujoco_td3.py``; the reference's ``examples/mujoco/mujoco_td3.py``
and ``mujoco_ddpg.py``).

Reference hyperparameters, TD3: hidden 256x256, actor and critic lr 3e-4,
exploration noise 0.1, policy noise 0.2, noise clip 0.5, actor delay 2,
tau 5e-3, batch 256, a 1,000,000-transition ring, 25,000 random start
steps, 1 update an env step.  DDPG: the same with lr 1e-3 and no smoothing
or delay.  Needs gymnasium and MuJoCo.

    python -m tianshou_tpu_torch.examples.mujoco_td3 --algo td3|ddpg [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="td3", choices=("td3", "ddpg"))
    p.add_argument("--task", default="HalfCheetah-v4")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--test-envs", type=int, default=10)  # reference test_num=10 (mujoco_sac.py:43)
    p.add_argument("--max-epoch", type=int, default=100)
    p.add_argument("--step-per-epoch", type=int, default=10000)
    p.add_argument("--step-per-collect", type=int, default=8)
    p.add_argument("--update-per-step", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--buffer-size", type=int, default=1000000)
    p.add_argument("--start-timesteps", type=int, default=25000)
    p.add_argument("--exploration-noise", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pipeline", action="store_true",
                   help="overlap env stepping with device updates (one segment of acting-parameter "
                        "staleness, which destabilises TD3)")
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``; ``logger`` replaces the
    ``TensorboardLogger`` under ``--logdir``."""
    import gymnasium as gym

    from tianshou_tpu_torch.algos.ddpg import DDPG, TD3
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.host import HostVectorEnv, space_from_gym
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    def make():
        return gym.make(args.task)

    probe = make()
    obs_dim, act_space = probe.observation_space.shape[0], space_from_gym(probe.action_space)
    act_dim = act_space.shape[0]
    probe.close()

    common = dict(gamma=0.99, tau=0.005, exploration_noise=args.exploration_noise, device=args.device)
    actor = DeterministicActor(obs_dim, (256, 256), act_dim)
    if args.algo == "td3":
        algo = TD3(actor, CriticEnsemble(obs_dim, act_dim, (256, 256), num_critics=2), act_space,
                   actor_lr=3e-4, critic_lr=3e-4, policy_noise=0.2, noise_clip=0.5, update_actor_freq=2, **common)
    else:
        algo = DDPG(actor, CriticEnsemble(obs_dim, act_dim, (256, 256), num_critics=1), act_space,
                    actor_lr=1e-3, critic_lr=1e-3, **common)
    buffer = ReplayBuffer(args.buffer_size // args.num_envs, args.num_envs)
    train_venv = HostVectorEnv([make for _ in range(args.num_envs)])
    test_venv = HostVectorEnv([make for _ in range(args.test_envs)])
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir or f"log/{args.algo}_{args.task}_{args.seed}_{int(time.time())}")
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
        pipeline_host_updates=args.pipeline,
        device=args.device,
    )
    return trainer, [train_venv, test_venv]


def main(argv=None, logger=None):
    args = parser().parse_args(argv)
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    print(
        f"{args.algo.upper()}/{args.task}: "
        f"best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step/dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()
