"""DQN on Atari through the DeepMind preprocessing chain (port of
``examples/atari_dqn.py``).

Reference hyperparameters: NatureCNN in bf16, lr 1e-4, gamma 0.99, n-step
3, target update 500, a ring of 100,000 frames with frame deduplication
(``stack_num=4, save_only_last_obs, ignore_obs_next``: one 84x84 uint8 frame
stored a transition), epsilon 1.0 -> 0.05 over the first 1,000,000 frames,
batch 32, 10 train envs, 0.1 updates an env step.  Every presample's frame
stacks go through ``gather_rows_cast`` (two launches a segment, ``obs`` and
``obs_next``).

``--fake-ale`` runs the same program on ``FakeAtariEnv``, a deterministic
stand-in for ALE that needs no ROMs; with ``ale_py`` and the ROMs installed
the script trains the real games unchanged.

    python -m tianshou_tpu_torch.examples.atari_dqn --fake-ale [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="ALE/Pong-v5")
    p.add_argument("--fake-ale", action="store_true", help="use the deterministic fake-ALE double (no ROMs)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eps-test", type=float, default=0.005)
    p.add_argument("--eps-train", type=float, default=1.0)
    p.add_argument("--eps-train-final", type=float, default=0.05)
    p.add_argument("--eps-decay-steps", type=int, default=1_000_000)
    p.add_argument("--buffer-size", type=int, default=100_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--n-step", type=int, default=3)
    p.add_argument("--target-update-freq", type=int, default=500)
    p.add_argument("--max-epoch", type=int, default=100)
    p.add_argument("--step-per-epoch", type=int, default=100_000)
    p.add_argument("--step-per-collect", type=int, default=10)
    p.add_argument("--update-per-step", type=float, default=0.1)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--training-num", type=int, default=10)
    p.add_argument("--test-num", type=int, default=10)
    p.add_argument("--frames-stack", type=int, default=4)
    p.add_argument("--warmup-steps", type=int, default=5000)
    p.add_argument("--stop-reward", type=float, default=None)
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``; ``logger`` replaces the
    ``TensorboardLogger`` under ``--logdir``."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.atari import FakeAtariEnv, make_atari_env
    from tianshou_tpu_torch.envs.host import space_from_gym
    from tianshou_tpu_torch.networks.conv import ConvQNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    env_fn = (lambda: FakeAtariEnv(seed=args.seed)) if args.fake_ale else None
    train_venv, test_venv = make_atari_env(
        args.task, args.training_num, args.test_num, frame_stack=args.frames_stack, env_fn=env_fn)
    act_space = space_from_gym(train_venv.action_space)
    obs_shape = train_venv.observation_space.shape
    try:
        algo = DQN(
            ConvQNet(obs_shape, act_space.n, "nature"),
            act_space,
            lr=args.lr,
            gamma=args.gamma,
            n_step=args.n_step,
            target_update_freq=args.target_update_freq,
            device=args.device,
        )
    except BaseException:  # e.g. no CUDA at the default device: close the envs built above
        train_venv.close()
        test_venv.close()
        raise
    buffer = ReplayBuffer(
        args.buffer_size // args.training_num,
        args.training_num,
        stack_num=args.frames_stack,
        save_only_last_obs=True,
        ignore_obs_next=True,
    )

    def eps_schedule(epoch, env_step):
        frac = min(1.0, env_step / args.eps_decay_steps)
        return args.eps_train + frac * (args.eps_train_final - args.eps_train)

    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(
            args.logdir or f"log/atari_dqn_{args.task.replace('/', '-')}_{args.seed}_{int(time.time())}")
    trainer = OffPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, buffer, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        buffer,
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect * args.training_num,
        update_per_step=args.update_per_step,
        batch_size=args.batch_size,
        episode_per_test=args.test_num,
        train_param_fn=eps_schedule,
        test_param=args.eps_test,
        stop_fn=(lambda rew: rew >= args.stop_reward) if args.stop_reward is not None else None,
        warmup_steps=args.warmup_steps,
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
        f"DQN/{args.task}: best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step / dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()
