"""PPO, A2C or PG on the port's classic-control envs, on the device (port
of ``examples/ppo_classic.py``; the reference's
``test/continuous/test_ppo.py`` and ``test/discrete/test_{pg,a2c,ppo}.py``).
Training stops at a test return of 195 on a discrete task, -250 on a
continuous one.

    python -m tianshou_tpu_torch.examples.ppo_classic --algo ppo|a2c|pg --env CartPole-v1|Pendulum-v1 [--device cpu]
"""

from __future__ import annotations

import argparse

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--algo", default="ppo", choices=["ppo", "a2c", "pg"])
    p.add_argument("--env", default="Pendulum-v1")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--max-epoch", type=int, default=15)
    p.add_argument("--step-per-epoch", type=int, default=30000)
    p.add_argument("--step-per-collect", type=int, default=2048)
    p.add_argument("--repeat", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``: the envs run on the device, none to
    close."""
    from tianshou_tpu_torch.algos.a2c import A2C
    from tianshou_tpu_torch.algos.pg import PG
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import make_env
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.continuous import GaussianActor, ValueNet
    from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer

    env = make_env(args.env)
    obs_shape = env.observation_space.shape
    if isinstance(env.action_space, Discrete):
        actor = QNet(obs_shape, (64, 64), env.action_space.n)  # logits head
        threshold = 195.0
        gamma, gae_lambda = 0.99, 0.95
    else:
        actor = GaussianActor(obs_shape, (64, 64), env.action_space.shape[0])
        threshold = -250.0
        gamma, gae_lambda = 0.95, 0.95
    critic = ValueNet(obs_shape, (64, 64))

    if args.algo == "ppo":
        algo = PPO(actor, critic, env.action_space, lr=args.lr, gamma=gamma, gae_lambda=gae_lambda, eps_clip=0.2,
                   vf_coef=0.5, ent_coef=0.0, max_grad_norm=0.5, adv_norm=True, value_clip=False,
                   device=args.device)
    elif args.algo == "a2c":
        algo = A2C(actor, critic, env.action_space, lr=args.lr, gamma=gamma, gae_lambda=gae_lambda, vf_coef=0.5,
                   ent_coef=0.01, max_grad_norm=0.5, device=args.device)
    else:
        algo = PG(actor, env.action_space, lr=args.lr, gamma=gamma, ret_norm=True, device=args.device)

    trainer = OnPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, args.num_envs, device=args.device), device=args.device),
        Collector(algo, VectorEnv(env, args.num_envs, device=args.device), device=args.device),
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect,
        repeat_per_collect=args.repeat,
        batch_size=args.batch_size,
        episode_per_test=10,
        stop_fn=lambda rew: rew >= threshold,
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
        f"{args.algo}/{args.env}: best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"epochs={info.epoch} env_steps={info.env_step} wall={dt:.1f}s "
        f"stop={info.stop_triggered}"
    )
    return info


if __name__ == "__main__":
    main()
