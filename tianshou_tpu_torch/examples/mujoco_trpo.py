"""TRPO or NPG on MuJoCo through the host-env bridge (port of
``examples/mujoco_trpo.py``; the reference's ``examples/mujoco/mujoco_trpo.py``
and ``mujoco_npg.py``).

Reference hyperparameters, shared by both: hidden 64x64, critic lr 1e-3
decaying linearly to 0 over every critic step, gamma 0.99, GAE 0.95, 16
train envs, 1024 steps a collect, one pass and one full-batch
natural-gradient update a collect, advantage and return normalisation, 20
critic steps an update; TRPO adds KL limit 0.01, backtracking 0.8 and 10
backtracks, NPG a 0.1 actor step.  Needs gymnasium and MuJoCo.

    python -m tianshou_tpu_torch.examples.mujoco_trpo --algo trpo|npg [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


def scheduled_adam(params, schedule):
    """``optax.adam(schedule)``: Adam whose learning rate at its step ``k``
    (counted from 0) is ``schedule(k)``, the count and the rate kept on the
    parameters' device, so that a CUDA graph of the learning advances them
    (:class:`~tianshou_tpu_torch.algos.pg.ScheduledAdam`)."""
    from tianshou_tpu_torch.algos.pg import ScheduledAdam

    return ScheduledAdam(params, schedule)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--algo", default="trpo", choices=("trpo", "npg"))
    p.add_argument("--task", default="HalfCheetah-v4")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--test-envs", type=int, default=10)  # reference test_num=10
    p.add_argument("--max-epoch", type=int, default=100)
    p.add_argument("--step-per-epoch", type=int, default=10000)
    p.add_argument("--step-per-collect", type=int, default=1024)
    p.add_argument("--critic-lr", type=float, default=1e-3)
    p.add_argument("--optim-critic-iters", type=int, default=20)
    p.add_argument("--actor-step-size", type=float, default=0.1)
    p.add_argument("--max-kl", type=float, default=0.01)
    p.add_argument("--backtrack-coeff", type=float, default=0.8)
    p.add_argument("--max-backtracks", type=int, default=10)
    p.add_argument("--no-lr-decay", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``; ``logger`` replaces the
    ``TensorboardLogger`` under ``--logdir``."""
    import gymnasium as gym

    from tianshou_tpu_torch.algos.npg import NPG, TRPO
    from tianshou_tpu_torch.algos.pg import linear_schedule
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.host import NormObsHostVectorEnv, space_from_gym
    from tianshou_tpu_torch.networks.continuous import GaussianActor, ValueNet
    from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer

    def make():
        return gym.make(args.task)

    probe = make()
    obs_dim, act_space = probe.observation_space.shape[0], space_from_gym(probe.action_space)
    probe.close()

    common = dict(critic_lr=args.critic_lr, gamma=0.99, gae_lambda=0.95, optim_critic_iters=args.optim_critic_iters,
                  adv_norm=True, ret_norm=True, device=args.device)
    actor = GaussianActor(obs_dim, (64, 64), act_space.shape[0], sigma_init=-0.5)
    critic = ValueNet(obs_dim, (64, 64))
    if args.algo == "trpo":
        algo = TRPO(actor, critic, act_space, max_kl=args.max_kl, backtrack_coeff=args.backtrack_coeff,
                    max_backtracks=args.max_backtracks, **common)
    else:
        algo = NPG(actor, critic, act_space, trust_region_size=args.actor_step_size, **common)
    if not args.no_lr_decay:
        # the critic's lr decays linearly to zero over every critic step
        # (the reference's LambdaLR over update rounds, mujoco_trpo.py)
        rounds = args.max_epoch * -(-args.step_per_epoch // args.step_per_collect)
        schedule = linear_schedule(args.critic_lr, 0.0, rounds * args.optim_critic_iters)
        algo.make_optimizer = lambda params: scheduled_adam(params, schedule)

    train_venv = NormObsHostVectorEnv([make for _ in range(args.num_envs)])
    test_venv = NormObsHostVectorEnv([make for _ in range(args.test_envs)], update_rms=False)
    test_venv.set_rms(train_venv.get_rms())
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir or f"log/{args.algo}_{args.task}_{args.seed}_{int(time.time())}")
    trainer = OnPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect,
        repeat_per_collect=1,
        batch_size=1 << 30,  # the whole collect in one natural-gradient update
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
        f"{args.algo.upper()}/{args.task}: "
        f"best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step/dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()
