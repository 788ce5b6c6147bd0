"""SAC on Box2D's BipedalWalker, or its hardcore version, through the
host-env bridge (port of ``examples/box2d_sac.py``; the reference's
``examples/box2d/bipedal_hardcore_sac.py``).

Reference hyperparameters: hidden 128x128, actor lr 3e-4, critic lr 1e-3,
alpha from 0.1 tuned at lr 3e-4, n-step 4, batch 128, a
1,000,000-transition ring, 10 train envs, one step a env a collect (the
fused fine cycle), 0.1 updates an env step, 10 test episodes.
``--hardcore`` also applies the reference's wrapper (action repeat 3,
reward x5, the terminal -100 penalty removed) to the train envs only: the
test envs keep the real rewards, so the curve compares with the env's
300-point bar.  Needs gymnasium and Box2D.

    python -m tianshou_tpu_torch.examples.box2d_sac [--hardcore] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


class _HardcoreWrapper:
    """The reference script's action-repeat and reward-shaping wrapper
    (bipedal_hardcore_sac.py:55-84), on gymnasium's 5-tuple step."""

    def __init__(self, env, action_repeat=3, reward_scale=5, rm_done=True):
        self.env = env
        self.action_repeat = action_repeat
        self.reward_scale = reward_scale
        self.rm_done = rm_done
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action):
        rew_sum = 0.0
        for _ in range(self.action_repeat):
            obs, rew, term, trunc, info = self.env.step(action)
            if not (term or trunc) or not self.rm_done:
                rew_sum += float(rew)
            if term or trunc:
                break
        return obs, self.reward_scale * rew_sum, term, trunc, info

    def close(self):
        self.env.close()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--hardcore", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=10)
    p.add_argument("--test-envs", type=int, default=10)
    p.add_argument("--max-epoch", type=int, default=100)
    p.add_argument("--step-per-epoch", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--buffer-size", type=int, default=1000000)
    p.add_argument("--start-timesteps", type=int, default=10000)
    p.add_argument("--update-per-step", type=float, default=0.1)
    p.add_argument("--stop-reward", type=float, default=300.0)
    p.add_argument("--no-stop", action="store_true")
    p.add_argument("--seed", type=int, default=0)
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

    task = "BipedalWalkerHardcore-v3" if args.hardcore else "BipedalWalker-v3"
    if args.hardcore:

        def make_train():
            return _HardcoreWrapper(gym.make(task))

        def make_test():
            return _HardcoreWrapper(gym.make(task), reward_scale=1, rm_done=False)

    else:

        def make_train():
            return gym.make(task)

        make_test = make_train
    probe = gym.make(task)
    obs_dim, act_space = probe.observation_space.shape[0], space_from_gym(probe.action_space)
    act_dim = act_space.shape[0]
    probe.close()

    algo = SAC(
        GaussianActor(obs_dim, (128, 128), act_dim, conditioned_sigma=True),
        CriticEnsemble(obs_dim, act_dim, (128, 128), num_critics=2),
        act_space,
        actor_lr=3e-4,
        critic_lr=1e-3,
        alpha=0.1,
        alpha_lr=3e-4,
        auto_alpha=True,
        tau=0.005,
        gamma=0.99,
        n_step=4,
        device=args.device,
    )
    buffer = ReplayBuffer(args.buffer_size // args.num_envs, args.num_envs)
    train_venv = HostVectorEnv([make_train for _ in range(args.num_envs)])
    test_venv = HostVectorEnv([make_test for _ in range(args.test_envs)])
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir or f"log/sac_{task}_{args.seed}_{int(time.time())}")
    trainer = OffPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, buffer, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        buffer,
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.num_envs,  # one step a env: the fused fine cycle
        update_per_step=args.update_per_step,
        batch_size=args.batch_size,
        episode_per_test=args.test_envs,
        warmup_steps=args.start_timesteps,
        stop_fn=None if args.no_stop else (lambda rew: rew >= args.stop_reward),
        seed=args.seed,
        logger=logger,
        device=args.device,
    )
    return trainer, [train_venv, test_venv]


def main(argv=None, logger=None):
    args = parser().parse_args(argv)
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    task = "BipedalWalkerHardcore-v3" if args.hardcore else "BipedalWalker-v3"
    print(
        f"SAC/{task}: best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step/dt:.0f} "
        f"stop={info.stop_triggered}"
    )
    return info


if __name__ == "__main__":
    main()
