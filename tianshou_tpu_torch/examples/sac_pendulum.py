"""SAC, TD3 or DDPG on the port's Pendulum-v1, on the device (port of
``examples/sac_pendulum.py``; the reference's
``test/continuous/test_sac_with_il.py``).  A test return of -250 stops
training.

    python -m tianshou_tpu_torch.examples.sac_pendulum --algo sac|td3|ddpg [--device cpu]
"""

from __future__ import annotations

import argparse

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--algo", default="sac", choices=["sac", "td3", "ddpg"])
    p.add_argument("--num-envs", type=int, default=10)
    p.add_argument("--max-epoch", type=int, default=8)
    p.add_argument("--step-per-epoch", type=int, default=6000)
    p.add_argument("--step-per-collect", type=int, default=10)
    p.add_argument("--update-per-step", type=float, default=0.125)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``: the envs run on the device, none to
    close."""
    from tianshou_tpu_torch.algos.ddpg import DDPG, TD3
    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import Pendulum
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor, GaussianActor
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    env = Pendulum()
    obs_dim, act_dim = env.observation_space.shape[0], env.action_space.shape[0]
    common = dict(actor_lr=1e-3, critic_lr=1e-3, device=args.device)
    if args.algo == "sac":
        algo = SAC(GaussianActor(obs_dim, (128, 128), act_dim, conditioned_sigma=True),
                   CriticEnsemble(obs_dim, act_dim, (128, 128), num_critics=2), env.action_space,
                   auto_alpha=True, **common)
    elif args.algo == "td3":
        algo = TD3(DeterministicActor(obs_dim, (128, 128), act_dim),
                   CriticEnsemble(obs_dim, act_dim, (128, 128), num_critics=2), env.action_space,
                   exploration_noise=0.1, **common)
    else:
        algo = DDPG(DeterministicActor(obs_dim, (128, 128), act_dim),
                    CriticEnsemble(obs_dim, act_dim, (128, 128), num_critics=1), env.action_space,
                    exploration_noise=0.1, **common)
    buffer = ReplayBuffer(20000 // args.num_envs, args.num_envs)
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, args.num_envs, device=args.device), buffer, device=args.device),
        Collector(algo, VectorEnv(env, args.num_envs, device=args.device), device=args.device),
        buffer,
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect * args.num_envs,
        update_per_step=args.update_per_step,
        batch_size=args.batch_size,
        episode_per_test=10,
        stop_fn=lambda rew: rew >= -250,
        warmup_steps=1000,
        seed=args.seed,
        logger=logger,
        device=args.device,
    )
    return trainer, []


def main(argv=None, logger=None):
    args = parser().parse_args(argv)
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    print(
        f"{args.algo}: best_reward={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"epochs={info.epoch} env_steps={info.env_step} wall={dt:.1f}s "
        f"stop={info.stop_triggered}"
    )
    return info


if __name__ == "__main__":
    main()
