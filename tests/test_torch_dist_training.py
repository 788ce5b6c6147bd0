"""Training across processes with the port (tianshou_tpu_torch), the copies
of ``tests/test_distributed.py``'s runs: two gloo ranks on the CPU, each a
subprocess (``run_ranks`` of ``test_torch_parallel``), or one process
without a process group.

- Two-process training through ``make_distributed_update`` (the JAX
  worker's ``tests/_dist_worker.py`` at its widths: 8 CartPole envs, 4 a
  rank, DQN QNet (32, 32), 20 rounds of a recorded 8-step segment and one
  update): both ranks read identical losses and end with identical
  parameters, and the loss falls.
- ``DistributedOffPolicyTrainer`` on two ranks at
  ``tests/_dist_trainer_worker.py``'s configuration (DQN n = 3, 8 envs a
  rank, batch 64 global) reaches 170 with the ranks in lockstep, and
  ``DistributedOnPolicyTrainer`` at ``tests/_dist_onpolicy_worker.py``'s
  (PPO, 8 envs a rank) reaches 195.
- Both trainers learn CartPole in one process (DQN >= 170, PPO >= 195).
"""

from __future__ import annotations

import torch

from test_torch_parallel import rank_main, run_ranks


def _digest(modules) -> float:
    return float(sum(p.detach().abs().double().sum() for m in modules for p in m.parameters()))


def _case_update_loop(ctx):
    """``tests/_dist_worker.py``: this rank's env shard, a recorded segment a
    round, its transitions through ``make_distributed_update``."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.parallel.distributed import make_distributed_update, process_env_slice
    from tianshou_tpu_torch.networks.common import QNet

    start, local_envs = process_env_slice(8)
    env = CartPole()
    algo = DQN(QNet(4, (32, 32), 2), env.action_space, gamma=0.9, n_step=1, target_update_freq=50, device="cpu")
    col = Collector(algo, VectorEnv(env, local_envs, device="cpu"), device="cpu")
    ts = algo.init(torch.Generator().manual_seed(0))  # the same seed everywhere: the same parameters
    cstate = col.reset(torch.Generator().manual_seed(1000 + start))  # each shard its own envs
    update = make_distributed_update(algo)
    learn_gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(20):
        cstate, _, _, traj = col.collect(ts, cstate, None, 8, explore=True, explore_param=0.3, record_traj=True)
        local = {k: traj[k].reshape((-1,) + traj[k].shape[2:])
                 for k in ("obs", "act", "rew", "terminated", "truncated", "obs_next")}
        ts, metrics = update(ts, local, learn_gen)
        losses.append(float(metrics["loss"]))
    return {"losses": losses, "digest": _digest([ts.online])}


def _trainer(kind, local_envs=8, **kw):
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet

    env = CartPole()
    if kind == "off":
        from tianshou_tpu_torch.algos.dqn import DQN
        from tianshou_tpu_torch.data.buffer import ReplayBuffer
        from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

        algo = DQN(QNet(4, (64, 64), 2), env.action_space, lr=1e-3, gamma=0.9, n_step=3, target_update_freq=320,
                   device="cpu")
        buffer = ReplayBuffer(1000, local_envs)
        return DistributedOffPolicyTrainer(
            algo, Collector(algo, VectorEnv(env, local_envs, device="cpu"), buffer, device="cpu"),
            Collector(algo, VectorEnv(env, local_envs, device="cpu"), device="cpu"), buffer,
            step_per_epoch=4000, update_per_step=0.1, batch_size=64, episode_per_test=5,
            train_param_fn=lambda epoch, step: 0.1, test_param=0.0, stop_fn=lambda rew: rew >= 170,
            warmup_steps=1000, seed=0, device="cpu", **kw)
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.networks.continuous import ValueNet
    from tianshou_tpu_torch.trainer.distributed import DistributedOnPolicyTrainer

    algo = PPO(QNet(4, (64, 64), 2), ValueNet(4, (64, 64)), env.action_space, lr=3e-4, gamma=0.99, gae_lambda=0.95,
               max_grad_norm=0.5, ent_coef=0.0, device="cpu")
    return DistributedOnPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, local_envs, device="cpu"), device="cpu"),
        Collector(algo, VectorEnv(env, local_envs, device="cpu"), device="cpu"), max_epoch=8, step_per_epoch=30000,
        step_per_collect=2048, repeat_per_collect=10, batch_size=256, episode_per_test=10,
        stop_fn=lambda rew: rew >= 195, seed=0, device="cpu", **kw)


def _case_trainer(ctx):
    kind = ctx.inputs
    kw = dict(max_epoch=5, step_per_collect=160) if kind == "off" else {}
    trainer = _trainer(kind, **kw)
    info = trainer.run()
    ts = trainer.train_state
    modules = [ts.online] if kind == "off" else [ts.actor, ts.critic]
    return {"result": (int(info.stop_triggered), round(info.best_reward, 2), info.env_step, _digest(modules)),
            "metrics": info.last_metrics}


CASES = {"update_loop": _case_update_loop, "trainer": _case_trainer}


def test_two_process_distributed_training():
    ranks = run_ranks(__file__, "update_loop")
    # the gradient all-reduce keeps the parameters in lockstep: identical
    # losses and parameters on both ranks
    assert ranks[0] == ranks[1], ranks
    losses = ranks[0]["losses"]
    assert losses[-1] < losses[0], losses


def test_two_process_distributed_trainer_reaches_threshold():
    ranks = run_ranks(__file__, "trainer", inputs="off")
    assert ranks[0]["result"] == ranks[1]["result"], ranks  # stop decision, env steps, parameters
    assert ranks[0]["metrics"] == ranks[1]["metrics"]  # averaged over the ranks when read
    stopped, best, _, _ = ranks[0]["result"]
    assert stopped == 1 and best >= 170, ranks[0]


def test_two_process_distributed_onpolicy_trainer_reaches_threshold():
    ranks = run_ranks(__file__, "trainer", inputs="on")
    assert ranks[0]["result"] == ranks[1]["result"], ranks
    stopped, best, _, _ = ranks[0]["result"]
    assert stopped == 1 and best >= 195, ranks[0]


def test_distributed_onpolicy_trainer_single_process_learns_cartpole():
    torch.set_num_threads(1)
    info = _trainer("on", local_envs=16).run()
    assert info.stop_triggered, f"best={info.best_reward}"


def test_distributed_trainer_single_process_learns_cartpole():
    torch.set_num_threads(1)
    info = _trainer("off", max_epoch=4, step_per_collect=80).run()
    assert info.stop_triggered and info.best_reward >= 170, info.best_reward


if __name__ == "__main__":
    rank_main(CASES)
