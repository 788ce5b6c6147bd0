"""Data parallelism of the port's off-policy superstep on two gloo ranks
on the CPU, the copies of ``tests/test_multichip.py``'s three data-parallel
tests (two ranks in place of 8 virtual devices; each rank a subprocess,
``run_ranks`` of ``test_torch_parallel``).

- The distributed superstep (``DistributedOffPolicyTrainer``) of DQN n = 3
  on 16 CartPole envs, 8 a rank, equals one process's superstep
  (``OffPolicyTrainer``) over the 16 envs from the same parameters, env
  states and sampled slots: the same episode ends, the same loss, the same
  parameters (rtol 1e-4 / atol 1e-6).
- SAC's distributed superstep on Pendulum, 4 envs a rank: finite losses
  (averaged over the ranks), the two ranks' parameters bitwise equal.
- Sharded training improves: DQN on CartPole, 4 envs a rank, 150
  distributed supersteps reach a test mean >= 120.

The two ensemble-axis tests (``test_dryrun_multichip_two_axis_mesh``,
``test_ensemble_sharded_update_matches_replicated``) are copied in
``tests/test_torch_ensemble_axis.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from test_torch_parallel import rank_main, run_ranks

N_ENVS, SEG, UPDATES, BATCH, CAP = 16, 4, 16, 16, 64


def _cartpole_dqn(num_envs, capacity=CAP, hidden=(32, 32), **kw):
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet

    env = CartPole()
    algo = DQN(QNet(4, hidden, 2), env.action_space, device="cpu", **kw)
    buffer = ReplayBuffer(capacity, num_envs)
    return (algo, Collector(algo, VectorEnv(env, num_envs, device="cpu"), buffer, device="cpu"),
            Collector(algo, VectorEnv(env, 8, device="cpu"), device="cpu"), buffer)


def _start_states(rows: slice):
    """CartPole states of ``rows`` of the 16 envs, fixed by a seed."""
    from tianshou_tpu_torch.envs.classic import CartPoleState

    rng = np.random.default_rng(3)
    start = torch.from_numpy(rng.uniform(-0.05, 0.05, (4, N_ENVS)).astype(np.float32))[:, rows]
    return CartPoleState(*start, torch.zeros(start.shape[1], dtype=torch.int32))


def _slots():
    """Sampled ``(env_idx, pos)`` of every update, ``[UPDATES, BATCH]``, as
    the one process draws them (global env ids)."""
    rng = np.random.default_rng(4)
    env_idx = rng.integers(0, N_ENVS, (UPDATES, BATCH))
    # rows [0, 8) of an update come from rank 0's envs, [8, 16) from rank 1's
    env_idx[:, BATCH // 2:] = env_idx[:, BATCH // 2:] % 8 + 8
    env_idx[:, :BATCH // 2] %= 8
    pos = rng.integers(0, SEG, (UPDATES, BATCH))
    return torch.from_numpy(env_idx), torch.from_numpy(pos)


def _dqn_kw():
    return dict(lr=1e-3, gamma=0.9, n_step=3, target_update_freq=10)


def _superstep_states(trainer, rows):
    from tianshou_tpu_torch.envs.classic import CartPole

    ts, cstate, bstate, generators, _ = trainer.init_states()
    cstate.env_state = _start_states(rows)
    cstate.obs = CartPole()._obs(cstate.env_state)
    return ts, cstate, bstate, generators


def _case_dqn_superstep(ctx):
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

    local = N_ENVS // ctx.world
    algo, col, test, buffer = _cartpole_dqn(local, **_dqn_kw())
    trainer = DistributedOffPolicyTrainer(algo, col, test, buffer, max_epoch=1, step_per_epoch=1,
                                          step_per_collect=N_ENVS * SEG, update_per_step=UPDATES / (N_ENVS * SEG),
                                          batch_size=BATCH, device="cpu")
    ts, cstate, bstate, generators = _superstep_states(trainer, slice(ctx.rank * local, (ctx.rank + 1) * local))
    ts.online.load_state_dict(ctx.inputs)
    ts.target.load_state_dict(ctx.inputs)
    env_idx, pos = _slots()
    b = BATCH // ctx.world
    calls = iter(range(UPDATES))

    def sample_with_weights(state, generator, batch_size):
        u = next(calls)
        rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
        return env_idx[u, rows] - ctx.rank * local, pos[u, rows], torch.ones(b)

    buffer.sample_with_weights = sample_with_weights
    ts, _, _, outputs, metrics = trainer._build_superstep()(ts, cstate, bstate, generators, 0.0)
    return {"done": outputs["done"], "loss": float(metrics["loss"]), "online": ts.online.state_dict()}


def _case_sac_superstep(ctx):
    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import Pendulum
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor
    from tianshou_tpu_torch.parallel.distributed import average_metrics
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

    env = Pendulum()
    algo = SAC(GaussianActor(3, (32, 32), 1, conditioned_sigma=True), CriticEnsemble(3, 1, (32, 32), 2),
               env.action_space, device="cpu")
    buffer = ReplayBuffer(CAP, 4)
    trainer = DistributedOffPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, 4, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 4, device="cpu"), device="cpu"), buffer, max_epoch=1, step_per_epoch=1,
        step_per_collect=32, update_per_step=0.25, batch_size=8, device="cpu")
    ts, cstate, bstate, generators, _ = trainer.init_states()
    ts, _, _, _, metrics = trainer._build_superstep()(ts, cstate, bstate, generators, 0.0)
    return {"metrics": {k: float(v) for k, v in average_metrics(metrics, trainer.group).items()},
            "params": {f"{m}.{k}": v for m in ("actor", "critic", "target_critic")
                       for k, v in getattr(ts, m).state_dict().items()},
            "log_alpha": ts.log_alpha.detach()}


def _case_training(ctx):
    from tianshou_tpu_torch.parallel.distributed import mean_over_ranks
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

    local = 8 // ctx.world
    algo, col, test, buffer = _cartpole_dqn(local, capacity=500, hidden=(64, 64), gamma=0.9, n_step=3,
                                            target_update_freq=100)
    trainer = DistributedOffPolicyTrainer(algo, col, test, buffer, max_epoch=1, step_per_epoch=1, step_per_collect=80,
                                          update_per_step=0.125, batch_size=64, seed=0, device="cpu")
    ts, cstate, bstate, generators, g_test = trainer.init_states()
    cstate, bstate, _, _ = col.collect(ts, cstate, bstate, 500 // 8, random=True)
    superstep = trainer._build_superstep()
    for _ in range(150):
        ts, cstate, bstate, _, _ = superstep(ts, cstate, bstate, generators, 0.1)
    stats = test.collect_episodes(ts, g_test, 10)
    mean, _ = mean_over_ranks([stats.returns_mean, 0.0], trainer.group, torch.device("cpu"))
    return {"mean": mean, "online": ts.online.state_dict()}


CASES = {"dqn_superstep": _case_dqn_superstep, "sac_superstep": _case_sac_superstep, "training": _case_training}


def test_dqn_superstep_sharded_matches_unsharded():
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer
    from tianshou_tpu_torch.utils.device import make_generator

    algo, col, test, buffer = _cartpole_dqn(N_ENVS, **_dqn_kw())
    trainer = OffPolicyTrainer(algo, col, test, buffer, max_epoch=1, step_per_epoch=1, step_per_collect=N_ENVS * SEG,
                               update_per_step=UPDATES / (N_ENVS * SEG), batch_size=BATCH, device="cpu")
    assert (trainer.segment_len, trainer.updates_per_segment) == (SEG, UPDATES)
    gen = make_generator(0, torch.device("cpu"))
    cstate = col.reset(gen)
    cstate.env_state = _start_states(slice(None))
    cstate.obs = CartPole()._obs(cstate.env_state)
    ts = algo.init(make_generator(1, torch.device("cpu")))
    bstate = buffer.init(col.example_transition(ts, cstate), device="cpu")
    env_idx, pos = _slots()
    buffer.sample_with_weights = lambda state, g, n: (env_idx.reshape(-1), pos.reshape(-1), torch.ones(n))
    start = {k: v.clone() for k, v in ts.online.state_dict().items()}
    ts, _, _, outputs, metrics = trainer._build_superstep()(ts, cstate, bstate, gen, 0.0)

    ranks = run_ranks(__file__, "dqn_superstep", inputs=start)
    # a rank's loss is its rows' mean: their average is the whole batch's
    np.testing.assert_allclose(np.mean([r["loss"] for r in ranks]), float(metrics["loss"]), rtol=1e-4, atol=1e-5)
    done = torch.cat([r["done"] for r in ranks], dim=1)
    assert torch.equal(done, outputs["done"])
    assert ts.step == UPDATES  # the target copy fired at update 10
    for r in ranks:
        for k, v in ts.online.state_dict().items():
            np.testing.assert_allclose(r["online"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    assert any(not torch.equal(v, start[k]) for k, v in ts.online.state_dict().items())


def test_sac_superstep_runs_sharded():
    ranks = run_ranks(__file__, "sac_superstep")
    assert all(np.isfinite(v) for v in ranks[0]["metrics"].values())
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    assert torch.equal(ranks[0]["log_alpha"], ranks[1]["log_alpha"])


def test_sharded_training_improves():
    ranks = run_ranks(__file__, "training")
    assert ranks[0]["mean"] == ranks[1]["mean"]
    assert all(torch.equal(v, ranks[1]["online"][k]) for k, v in ranks[0]["online"].items())
    assert ranks[0]["mean"] >= 120, f"mean={ranks[0]['mean']}"


if __name__ == "__main__":
    rank_main(CASES)
