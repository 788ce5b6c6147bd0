"""The compiled distributed trainers (DistributedOffPolicyTrainer and
DistributedOnPolicyTrainer ``_compile_superstep``, the staged
``make_distributed_update``) and what they asked of ``utils/graphs.py``, on
the CPU over two gloo ranks, against the eager steps and the JAX package.

CUDA graphs exist only on a card; the static-state protocol that a graph
replays (``utils/graphs.StaticStep``) runs here eagerly.  Every two-rank
case runs in one launch of two gloo ranks (``run_ranks`` of
``test_torch_parallel``) in a module fixture, each rank a subprocess of this
file that imports no JAX; the parent computes the JAX side first and hands
it the inputs.

- The off-policy segment under ``StaticStep`` over three segments equals
  the eager ``_build_superstep`` bitwise for DQN (n 3) on a uniform ring and
  on a ``PrioritizedReplayBuffer``: every carried tensor, the three
  generators' states (learn, sample, collect), ``outputs`` and the metrics
  (averaged over the ranks inside the segment); the two ranks' parameters
  are bitwise equal.  The collectives that an eager segment dispatches
  (``utils.graphs._Collectives``, what a capture counts) are one gradient
  all-reduce an update and one of the metrics.
- The on-policy segment built on ``rollout_segment`` (PPO) equals the one
  built on ``Collector.collect(record_traj=True)`` bitwise (trajectory,
  parameters, generators) over two segments, and so does its ``StaticStep``
  form.
- The ``StaticStep`` form of the on-policy learn over the assembled
  trajectory (PPO, ``tests/test_torch_dist_update.py``'s inputs, JAX's
  permutations injected) equals the eager learn bitwise and matches the
  JAX ``DistributedOnPolicyTrainer._build_global_learn`` within rtol 1e-4.
- The staged ``make_distributed_update`` (its ``compile_step`` a
  ``StaticStep``) equals its eager update bitwise on both ranks, matches
  the JAX ``make_distributed_update`` within rtol 1e-4 / atol 1e-5, and
  compiles again for another train state or another batch shape, not for a
  call like the last.
- ``capturable_groups`` refuses a gloo group and accepts NCCL and ``None``
  (a stub group here), ``CapturedStep`` refuses a gloo group, and it
  registers every generator of a tuple.
- On a card only (skipped here): a warm-up and two replays against three
  eager segments of a small ``dist_atari``-like DQN on a world-1 NCCL
  group, bitwise, the collectives counted at the capture equal to the eager
  segment's.
"""

from __future__ import annotations

import copy
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_parallel import rank_main, run_ranks

N_ENVS, SEG, BATCH, HID = 4, 4, 8, (16, 16)  # envs a rank, steps a segment, global batch


# -- helpers the ranks share (no JAX) ---------------------------------------------------------
def _copy_gen(g: torch.Generator) -> torch.Generator:
    c = torch.Generator(device=g.device)
    c.set_state(g.get_state())
    return c


def _clone(state: tuple, gens: list) -> tuple:
    """``state`` deep-copied, each generator of ``gens`` (and those the
    state holds) replaced by a copy: ``(state, generator copies)``."""
    memo = {id(g): _copy_gen(g) for g in gens}
    return copy.deepcopy(state, memo), [memo[id(g)] for g in gens]


def _leaves(state, gens, outputs=None, metrics=None) -> list:
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.graphs import named_tensors

    out = named_tensors(state) + [(f"gen{i}", g.get_state()) for i, g in enumerate(gens)]
    out += [(f"outputs[{i}]", t) for i, t in enumerate(tree_leaves(outputs))] if outputs is not None else []
    return out + [(f"metrics[{k!r}]", v) for k, v in (metrics or {}).items()]


def _differing(a: list, b: list) -> list[str]:
    """The names of the leaves whose bits differ (NaNs compared as bits)."""
    assert [n for n, _ in a] == [n for n, _ in b]

    def bits(t):
        t = t.detach().reshape(-1).contiguous()
        return t.view(torch.uint8) if t.numel() else t

    return [n for (n, x), (_, y) in zip(a, b)
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(bits(x), bits(y))]


def _off_trainer(per: bool):
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

    env = CartPole()
    algo = DQN(QNet(4, HID, 2), env.action_space, lr=1e-3, gamma=0.9, n_step=3, target_update_freq=4, device="cpu")
    buffer = PrioritizedReplayBuffer(16, N_ENVS) if per else ReplayBuffer(16, N_ENVS)
    col = Collector(algo, VectorEnv(env, N_ENVS, device="cpu"), buffer, device="cpu")
    steps = dist.get_world_size() * N_ENVS * SEG
    return DistributedOffPolicyTrainer(algo, col, col, buffer, max_epoch=1, step_per_epoch=steps,
                                       step_per_collect=steps, update_per_step=3 / steps, batch_size=BATCH,
                                       device="cpu")


def _off_segments(per: bool) -> dict:
    """Three eager segments against three of the ``StaticStep`` form from
    the same initial state; the collectives of the first eager segment."""
    from tianshou_tpu_torch.utils.graphs import StaticStep, _Collectives

    trainer = _off_trainer(per)
    ts, cstate, bstate, gens, _ = trainer.init_states()
    all_gens = [*gens, cstate.rng]
    (e_ts, e_cstate, e_bstate), e_all = _clone((ts, cstate, bstate), all_gens)
    e_gens = tuple(e_all[:2])
    eager = trainer._build_superstep()
    static = StaticStep(trainer._build_superstep(), ts, cstate, bstate)
    differ, calls = [], None
    for segment in range(3):
        counting = _Collectives()
        with counting:
            e_ts, e_cstate, e_bstate, e_out, e_m = eager(e_ts, e_cstate, e_bstate, e_gens, 0.1)
        calls = calls or counting.calls
        out = static(ts, static.cstate, bstate, gens, 0.1)
        assert out[0] is ts and out[1] is static.cstate and out[2] is bstate
        differ += _differing(_leaves((out[0], out[1], out[2]), [*gens, out[1].rng], out[3], out[4]),
                             _leaves((e_ts, e_cstate, e_bstate), [*e_gens, e_cstate.rng], e_out, e_m))
    return {"differ": differ, "collectives": calls, "updates": trainer.updates_per_segment,
            "grad_bytes": sum(p.numel() * p.element_size() for p in ts.online.parameters()),
            "online": {k: v.clone() for k, v in ts.online.state_dict().items()}, "loss": float(e_m["loss"]),
            "metrics": len(e_m), "step": ts.step}


def _on_trainer():
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.continuous import ValueNet
    from tianshou_tpu_torch.trainer.distributed import DistributedOnPolicyTrainer

    env = CartPole()
    algo = PPO(QNet(4, HID, 2), ValueNet(4, HID), env.action_space, lr=3e-3, max_grad_norm=0.5, adv_norm=True,
               gamma=0.9, gae_lambda=0.8, device="cpu")
    col = Collector(algo, VectorEnv(env, N_ENVS, device="cpu"), device="cpu")
    steps = dist.get_world_size() * N_ENVS * SEG
    return DistributedOnPolicyTrainer(algo, col, col, max_epoch=1, step_per_epoch=steps, step_per_collect=steps,
                                      repeat_per_collect=2, batch_size=steps // 2, device="cpu")


def _on_segments() -> dict:
    """The on-policy segment as it was built on ``Collector.collect`` (the
    reference), on ``rollout_segment`` (``_build_superstep``) and in its
    ``StaticStep`` form, two segments each from the same state."""
    from tianshou_tpu_torch.parallel.distributed import gather_env_axis, rank_seed
    from tianshou_tpu_torch.utils.device import fork_generator, make_generator
    from tianshou_tpu_torch.utils.graphs import StaticStep

    trainer = _on_trainer()
    col, group = trainer.train_collector, trainer.group
    gen = make_generator(0, "cpu")
    ts = trainer.algo.init(fork_generator(gen))
    cstate = col.reset(fork_generator(make_generator(rank_seed(0, dist.get_rank()), "cpu")))
    learn = trainer._build_global_learn()
    (r_ts, r_cstate), (r_gen, r_rng) = _clone((ts, cstate), [gen, cstate.rng])
    (n_ts, n_cstate), (n_gen, n_rng) = _clone((ts, cstate), [gen, cstate.rng])
    new = trainer._build_superstep()
    static = StaticStep(trainer._compile_superstep(ts, cstate), ts, cstate, None)
    differ = []
    for _ in range(2):
        r_cstate, _, _, traj = col.collect(r_ts, r_cstate, None, trainer.segment_len, explore=True, record_traj=True)
        r_ts, r_m = learn(r_ts, gather_env_axis(traj, group), r_gen)
        n_ts, n_cstate, n_out, n_m = new(n_ts, n_cstate, n_gen)
        _, s_cstate, _, s_out, s_m = static(ts, static.cstate, None, gen, 0.0)
        ref = _leaves((r_ts, r_cstate), [r_gen, r_cstate.rng], traj, r_m)
        differ += _differing(_leaves((n_ts, n_cstate), [n_gen, n_cstate.rng], n_out["traj"], n_m), ref)
        differ += _differing(_leaves((ts, s_cstate), [gen, s_cstate.rng], s_out["traj"], s_m), ref)
    return {"differ": differ, "actor": {k: v.clone() for k, v in ts.actor.state_dict().items()}}


def _on_learn(ctx) -> dict:
    """``tests/test_torch_dist_update.py``'s PPO case: this rank's columns of
    the trajectory through the ``StaticStep`` form of the assembled learn,
    and through the eager learn, JAX's permutations injected into both."""
    import test_torch_dist_update as du
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.parallel.distributed import gather_env_axis
    from tianshou_tpu_torch.trainer.onpolicy import build_rollout_learn
    from tianshou_tpu_torch.utils.graphs import StaticStep

    inp = ctx.inputs["on_learn"]
    name, kind, kw, batch, repeat = du.ON_CASES["ppo"]
    n = du.ON_N // ctx.world
    cols = slice(ctx.rank * n, (ctx.rank + 1) * n)
    runs = []
    for staged in (False, True):
        algo = du._port_on(name, kind, kw)
        ts = algo.init(torch.Generator().manual_seed(0))
        ts.load(inp["state"])
        arrays = {k: du._t(v[:, cols]) for k, v in inp["traj"].items()}
        logp = arrays.pop("log_prob")
        local = Batch(**arrays, policy=Batch(log_prob=logp))
        perms = iter(du._t(p).long() for p in inp["perms"])
        learn = build_rollout_learn(algo, du.ON_T * du.ON_N, batch, repeat, permutation=lambda g, m: next(perms))

        def step(ts, traj, bstate, generator, explore_param):
            ts, metrics = learn(ts, gather_env_axis(traj, dist.group.WORLD), generator)
            return ts, traj, bstate, None, metrics

        gen = torch.Generator()
        if staged:
            static = StaticStep(step, ts, local, None)
            ts, _, _, _, metrics = static(ts, static.cstate, None, gen, 0.0)
        else:
            ts, _, _, _, metrics = step(ts, local, None, gen, 0.0)
        runs.append({"actor": ts.actor.state_dict(), "critic": ts.critic.state_dict(), "step": ts.step,
                     "metrics": {k: float(v) for k, v in metrics.items()}})
    eager, staged = runs
    equal = all(torch.equal(v, staged[p][k]) for p in ("actor", "critic") for k, v in eager[p].items())
    return {**staged, "bitwise_equal_eager": equal and eager["metrics"] == staged["metrics"]}


def _one_step_update(ctx) -> dict:
    """``make_distributed_update`` with its ``compile_step`` a ``StaticStep``
    (what a graph replays) against ``update.eager`` on this rank's rows of
    the two JAX batches; then the compiles that another train state and
    another batch shape make."""
    import test_torch_dist_update as du
    from tianshou_tpu_torch.parallel import distributed as pd
    from tianshou_tpu_torch.utils.graphs import StaticStep

    made = []

    def compile_static(fn, device, ts, cstate, bstate, key=tuple, prepare_optimizers=True, groups=(), name="step"):
        made.append(StaticStep(fn, ts, cstate, bstate))
        return made[-1]

    pd.compile_step = compile_static
    inp = ctx.inputs["update"]
    b = du.B // ctx.world
    rows = slice(ctx.rank * b, (ctx.rank + 1) * b)
    local = [{k: du._t(v[rows]) for k, v in tr.items()} for tr in inp["transitions"]]
    states = []
    for _ in range(2):
        algo = du._port_off("dqn1")
        ts = algo.init(torch.Generator().manual_seed(0))
        du._load(ts, inp["state"])
        states.append((algo, ts))
    (algo, ts), (e_algo, e_ts) = states
    update, eager = pd.make_distributed_update(algo), pd.make_distributed_update(e_algo)
    gen, e_gen = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    losses, differ = [], []
    for tr in local:
        out_ts, metrics = update(ts, tr, gen)
        e_ts, e_metrics = eager.eager(e_ts, tr, e_gen)
        assert out_ts is ts and update.compiled is made[0]
        losses.append(float(metrics["loss"]))
        differ += _differing(_leaves(ts, [gen], None, metrics), _leaves(e_ts, [e_gen], None, e_metrics))
    compiles = [len(made)]
    update(ts, {k: v[: b // 2] for k, v in local[0].items()}, gen)  # another shape
    compiles.append(len(made))
    other = algo.init(torch.Generator().manual_seed(3))  # another train state
    update(other, local[0], gen)
    compiles.append(len(made))
    update(other, local[1], gen)  # as the last call: the same step
    compiles.append(len(made))
    return {"state": du._state(e_ts), "losses": losses, "differ": differ, "compiles": compiles}


def _case_all(ctx):
    """Every two-rank case of this file, in one launch."""
    torch.manual_seed(0)
    return {"off_uniform": _off_segments(per=False), "off_per": _off_segments(per=True), "on": _on_segments(),
            "on_learn": _on_learn(ctx), "update": _one_step_update(ctx)}


CASES = {"all": _case_all}


# -- the JAX side and the launch ---------------------------------------------------------------
def _jax_on_learn() -> tuple[dict, tuple]:
    """The inputs of the PPO learn case and the JAX global learn's result
    (``tests/test_torch_dist_update.py``'s construction)."""
    import jax

    import test_torch_dist_update as du
    import test_torch_onpolicy as onp
    from tianshou_tpu.parallel.distributed import host_shard_pytree
    from tianshou_tpu.parallel.mesh import make_mesh
    from tianshou_tpu.trainer.distributed import DistributedOnPolicyTrainer as JaxTrainer
    from tianshou_tpu_torch.networks.convert import onpolicy_state_from_flax

    name, kind, kw, batch, repeat = du.ON_CASES["ppo"]
    jalgo, jts, talgo, tts, heads = onp._algo_pair(name, kind, **kw)
    start = onpolicy_state_from_flax(jax.device_get(jts), actor_heads=heads)
    traj = onp._trajectory(kind, T=du.ON_T, N=du.ON_N, seed=3)
    m = du.ON_T * du.ON_N
    key = jax.random.key(5)
    perms = [np.asarray(jax.random.permutation(jax.random.split(k)[0], m)) for k in jax.random.split(key, repeat)]
    learn = JaxTrainer._build_global_learn(
        types.SimpleNamespace(algo=jalgo, batch_size=batch, repeat_per_collect=repeat), m)
    jtraj, _ = onp._traj_pair({k: np.moveaxis(v, 0, 1) for k, v in traj.items()})
    jts, jm = learn(jts, host_shard_pytree(jtraj, make_mesh(8)), key)
    return dict(state=start, traj=traj, perms=perms), (jts, jm, tts, heads, repeat * (m // batch))


def _jax_update() -> tuple[dict, tuple]:
    """Two one-step batches through the JAX ``make_distributed_update``."""
    import jax
    import jax.numpy as jnp

    import test_torch_dist_update as du
    from tianshou_tpu.parallel.distributed import host_shard_pytree, make_distributed_update
    from tianshou_tpu.parallel.mesh import make_mesh

    jalgo, _ = du._jax_off("dqn1")
    jts = jalgo.init(jax.random.key(0), jnp.zeros((du.OBS_D,), jnp.float32))
    start = du._jax_state_as_port("dqn1", jts, None)
    update = make_distributed_update(jalgo, make_mesh(8))
    transitions, losses = [], []
    for seed in (1, 2):
        a = du._batch_np("dqn1", seed)
        tr = dict(obs=a["obs"], act=a["act"], rew=a["rew_chain"][:, 0], terminated=a["terminated"],
                  truncated=a["done_chain"][:, 0].astype(bool) & ~a["terminated"], obs_next=a["obs_next"])
        transitions.append(tr)
        jts, jm = update(jts, host_shard_pytree(tr, make_mesh(8)), jax.random.key(seed))
        losses.append(float(jm["loss"]))
    return dict(state=start, transitions=transitions), (du._jax_state_as_port("dqn1", jts, None), losses)


@pytest.fixture(scope="module")
def ranks():
    on_inputs, on_ref = _jax_on_learn()
    up_inputs, up_ref = _jax_update()
    results = run_ranks(__file__, "all", inputs={"on_learn": on_inputs, "update": up_inputs})
    return results, {"on_learn": on_ref, "update": up_ref}


# -- the tests ------------------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["off_uniform", "off_per"])
def test_offpolicy_segment_static_form_is_the_eager_segment(ranks, case):
    results, _ = ranks
    for r in results:
        got = r[case]
        assert not got["differ"], got["differ"]
        assert got["step"] == 3 * got["updates"]
    a, b = (r[case] for r in results)
    assert all(torch.equal(v, b["online"][k]) for k, v in a["online"].items())
    assert a["loss"] == b["loss"]  # averaged over the ranks inside the segment


def test_offpolicy_segment_collectives_are_counted(ranks):
    """One gradient all-reduce an update (one float32 bucket) and one of
    the metrics (float32 each): what a capture counts as the graph's
    nodes."""
    results, _ = ranks
    for r in results:
        got = r["off_uniform"]
        names = [n for n, _ in got["collectives"]]
        assert names == ["allreduce_"] * (got["updates"] + 1)
        assert [n for _, n in got["collectives"]] == [got["grad_bytes"]] * got["updates"] + [4 * got["metrics"]]


def test_onpolicy_segment_on_rollout_segment_is_the_collect_based_one(ranks):
    results, _ = ranks
    for r in results:
        assert not r["on"]["differ"], r["on"]["differ"]
    a, b = (r["on"]["actor"] for r in results)
    assert all(torch.equal(v, b[k]) for k, v in a.items())


def test_static_onpolicy_learn_matches_jax_global_learn(ranks):
    import test_torch_onpolicy as onp

    results, refs = ranks
    jts, jm, tts, heads, updates = refs["on_learn"]
    for r in results:
        got = r["on_learn"]
        assert got["bitwise_equal_eager"]
        tts.load(got)
        onp._assert_state_close(jts, tts, heads)
        assert got["step"] == int(jts.step) == updates
        for k in jm:
            np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    for part in ("actor", "critic"):
        assert all(torch.equal(v, results[1]["on_learn"][part][k]) for k, v in results[0]["on_learn"][part].items())


def test_staged_distributed_update_is_eager_and_matches_jax(ranks):
    import test_torch_dist_update as du

    results, refs = ranks
    jax_state, jax_losses = refs["update"]
    for r in results:
        got = r["update"]
        assert not got["differ"], got["differ"]
        # two calls like the first, then another shape, another train state
        # and a call like the last
        assert got["compiles"] == [1, 2, 3, 3]
        du._assert_state(got["state"], jax_state, 1e-4, 1e-5, "staged make_distributed_update")
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4, atol=1e-5)
    du._assert_ranks_equal([r["update"] for r in results])


def test_capturable_groups_follow_the_backend(monkeypatch):
    from tianshou_tpu_torch.utils import graphs

    gloo, nccl = object(), object()
    monkeypatch.setattr(dist, "get_backend", lambda g: {id(gloo): "gloo", id(nccl): "nccl"}[id(g)])
    assert graphs.capturable_groups() and graphs.capturable_groups(None, nccl)
    assert not graphs.capturable_groups(nccl, gloo) and not graphs.capturable_groups(gloo, None)
    ts = torch.zeros(2)
    with pytest.raises(ValueError, match="gloo"):
        graphs.CapturedStep(lambda *a: a, ts, None, None, groups=(nccl, gloo))
    # on a CPU state compile_step runs the step itself, whatever the group
    step = lambda *a: a  # noqa: E731
    assert graphs.compile_step(step, torch.device("cpu"), ts, None, None, groups=(gloo,)) is step


def test_captured_step_registers_every_generator_of_a_tuple():
    from tianshou_tpu_torch.utils.graphs import CapturedStep

    learn, sample, rng = (torch.Generator() for _ in range(3))
    step = CapturedStep.__new__(CapturedStep)  # its generators alone: a capture needs a card
    step.cstate = types.SimpleNamespace(rng=rng)
    step.generator = (learn, sample)
    assert step._generators() == [learn, sample, rng]
    step.generator = (learn, rng)
    assert step._generators() == [learn, rng]
    step.generator = learn
    assert step._generators() == [learn, rng]


# -- on a card only ----------------------------------------------------------------------------------
@pytest.mark.cuda
def test_replays_equal_eager_distributed_segments_on_nccl():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs and NCCL need a CUDA device (chip_smoke.py's distributed phase runs this check on "
                    "the card)")
    import sys
    from pathlib import Path

    from test_torch_parallel import free_port
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer
    from tianshou_tpu_torch.utils.graphs import (CapturedStep, _Collectives, mark_capturable, optimizers,
                                                 prepare_optimizer)

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        # atari's env, net and ring schema, cut to 8 envs x 4 steps, 3 updates of 16 rows
        _, algo, col, buffer, plain = chip_smoke.build_path("atari", "cuda", num_envs=8, segment=4, batch=16,
                                                            updates=3, capacity=16)
        trainer = DistributedOffPolicyTrainer(algo, col, plain.test_collector, buffer, max_epoch=1, step_per_epoch=32,
                                              step_per_collect=32, update_per_step=3 / 32, batch_size=16,
                                              device="cuda")
        ts, cstate, bstate, gens, _ = trainer.init_states()
        (e_ts, e_cstate, e_bstate), e_all = _clone((ts, cstate, bstate), [*gens, cstate.rng])
        e_gens = tuple(e_all[:2])
        for opt in optimizers(e_ts):  # as the capture prepares the graph's (a copy loses the mark)
            prepare_optimizer(mark_capturable(opt))
        eager = trainer._build_superstep()
        compiled = trainer._compile_superstep(ts, cstate, bstate)
        assert isinstance(compiled, CapturedStep)
        eager_calls = []
        for _ in range(3):  # the warm-up and capture, then two replays
            out = compiled(ts, compiled.cstate, bstate, gens, 0.1)
            with _Collectives() as counting:
                e_ts, e_cstate, e_bstate, e_out, e_m = eager(e_ts, e_cstate, e_bstate, e_gens, 0.1)
            eager_calls = eager_calls or counting.calls
            assert not _differing(_leaves(out[:3], [*gens, out[1].rng], out[3], out[4]),
                                  _leaves((e_ts, e_cstate, e_bstate), [*e_gens, e_cstate.rng], e_out, e_m))
        (graph,) = compiled.graphs.values()
        assert graph.replays == 2 and graph.collectives == eager_calls
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(CASES)
