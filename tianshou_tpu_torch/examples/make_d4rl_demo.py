"""Write a small dataset in D4RL's qlearning schema for the offline example
(port of ``tests/make_d4rl_demo.py``).

``python -m tianshou_tpu_torch.examples.make_d4rl_demo out.h5 [--steps 4000]``
rolls a random policy through the port's Pendulum and stores the
transitions under D4RL's keys (``observations, actions, rewards,
terminals, next_observations, timeouts``): enough to run
``offline_d4rl_cql`` end to end without d4rl itself.  An ``.npz`` name
writes numpy's format and needs no ``h5py``.
"""

from __future__ import annotations

import argparse

import numpy as np


def generate(steps: int = 4000, seed: int = 0, device: str = "cuda") -> dict[str, np.ndarray]:
    """The dataset's arrays: ``steps // 8`` steps of 8 random Pendulum envs,
    each env's steps contiguous, each env's last step ending its episode."""
    from tianshou_tpu_torch.algos.base import RandomPolicy
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import Pendulum
    from tianshou_tpu_torch.utils.device import make_generator, resolve_device

    device = resolve_device(device)
    env = Pendulum()
    n_envs = 8
    algo = RandomPolicy(env.action_space, device=device)
    col = Collector(algo, VectorEnv(env, n_envs, device=device), device=device)
    cstate = col.reset(make_generator(seed, device))
    ts = algo.init(make_generator(seed + 1, device))
    _, _, _, traj = col.collect(ts, cstate, None, max(1, steps // n_envs), explore=True, record_traj=True)
    # [T, N, ...] -> [N, T, ...] -> flat: each env's episodes stay
    # contiguous (a plain [T, N] reshape would interleave the envs and
    # break the terminals-delimit-episodes rule that n-step returns and
    # CalQL rely on)
    flat = {
        k: traj[k].cpu().numpy().swapaxes(0, 1).reshape((-1,) + tuple(traj[k].shape[2:]))
        for k in ("obs", "act", "rew", "terminated", "truncated", "obs_next")
    }
    # env boundaries are episode boundaries too: the last transition of
    # each env's block ends its (maybe unfinished) episode
    n_steps = traj["rew"].shape[0]
    block_ends = np.arange(1, n_envs + 1) * n_steps - 1
    flat["truncated"] = flat["truncated"].copy()
    flat["truncated"][block_ends] |= ~flat["terminated"][block_ends]
    return {
        "observations": flat["obs"].astype(np.float32),
        "actions": flat["act"].astype(np.float32),
        "rewards": flat["rew"].astype(np.float32),
        "terminals": flat["terminated"].astype(bool),
        "timeouts": flat["truncated"].astype(bool),
        "next_observations": flat["obs_next"].astype(np.float32),
    }


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    data = generate(args.steps, args.seed, args.device)
    if args.out.endswith(".npz"):
        np.savez(args.out, **data)
    else:
        import h5py

        with h5py.File(args.out, "w") as f:
            for k, v in data.items():
                f.create_dataset(k, data=v)
    print(f"wrote {args.out}: {len(data['observations'])} transitions")


if __name__ == "__main__":
    main()
