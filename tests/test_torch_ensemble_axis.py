"""The ensemble axis of the port (``make_mesh2``, ``shard_ensemble_axis``,
``EnsembleMLP.shard_`` and the ``dp x ep`` distributed trainer) on gloo
ranks on the CPU, against one process and against the JAX package.

Each multi-rank case runs this file as subprocesses (``run_ranks`` of
``test_torch_parallel``); a module fixture runs each launch once and the
tests read its results.

- The copies of ``tests/test_multichip.py``'s two ensemble tests:
  ``test_dryrun_multichip_two_axis_mesh`` (DQN on a 1-D mesh, SAC on a
  ``dp 1 x ep 2`` mesh with its critics sharded, PPO's distributed learn)
  and ``test_ensemble_sharded_update_matches_replicated``: one sharded SAC
  update equals the one-process update (``critic_loss`` at rtol 1e-5, the
  gathered parameters at rtol 2e-5 / atol 1e-6), at ``dp 1 x ep 2`` and at
  ``dp 2 x ep 2``.
- REDQ (4 critics, subset 2, the actor stepped every update) and
  DiscreteSAC: two sharded updates equal two one-process updates, each
  rank holding K / ep critics.
- The two autograd operators against an unsharded ensemble: outputs,
  input gradient and member gradients; ``torch.distributed.nn``'s
  ``all_gather`` would give ``ep`` times the member gradients, and summing
  a replicated layer's gradients over ``ep`` would count a loss term
  outside the ensemble ``ep`` times.  At ``ep = 1`` the sharded path
  equals the plain one bitwise.
- One sharded SAC update against the JAX package's replicated update from
  the same parameters and the JAX update's own normals.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_main, run_ranks

OBS, A, HID, B, N_STEP = 3, 1, (16, 16), 16, 2
OBS_D, NA = 4, 2
GAUSS_HEADS = ("mu", "sigma")
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 2e-5, 1e-6


# -- shared helpers -------------------------------------------------------------
def _arrays(seed: int, discrete: bool = False) -> dict:
    """A global sampled batch of ``B`` rows, made from a seed."""
    rng = np.random.default_rng(seed)
    obs_dim = OBS_D if discrete else OBS
    act = rng.integers(0, NA, B) if discrete else rng.uniform(-1, 1, (B, A)).astype(np.float32)
    return dict(
        weight=rng.uniform(0.5, 1.5, B).astype(np.float32),
        obs=(rng.normal(size=(B, obs_dim)) * 2).astype(np.float32),
        act=act,
        rew_chain=rng.normal(size=(B, N_STEP)).astype(np.float32),
        done_chain=(rng.random((B, N_STEP)) < 0.2).astype(np.int32),
        obs_next=(rng.normal(size=(B, obs_dim)) * 2).astype(np.float32),
        terminated=rng.random(B) < 0.3,
    )


def _sampled(arrays: dict, rows: slice = slice(None)) -> tuple:
    """The presample tuple of ``rows`` of a global batch."""
    from tianshou_tpu_torch.data.batch import Batch

    c = {k: torch.as_tensor(v[rows]) for k, v in arrays.items()}
    n = c["weight"].shape[0]
    zeros = torch.zeros(n, dtype=torch.int64)
    return (zeros, zeros, c["weight"], Batch(obs=c["obs"], act=c["act"]), c["rew_chain"], c["done_chain"],
            Batch(obs_next=c["obs_next"], terminated=c["terminated"]))


def _algo(kind: str):
    from tianshou_tpu_torch.algos.redq import REDQ
    from tianshou_tpu_torch.algos.sac import SAC, DiscreteSAC
    from tianshou_tpu_torch.envs.spaces import Box, Discrete
    from tianshou_tpu_torch.networks.common import QNet, QNetEnsemble
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

    common = dict(actor_lr=1e-3, critic_lr=1e-3, gamma=0.9, tau=0.05, n_step=N_STEP, alpha_lr=3e-2, device="cpu")
    box = Box(low=-1.0, high=1.0, shape=(A,))
    if kind == "sac":
        return SAC(GaussianActor(OBS, HID, A, conditioned_sigma=True), CriticEnsemble(OBS, A, HID, 2), box,
                   **common)
    if kind == "redq":
        return REDQ(GaussianActor(OBS, HID, A, conditioned_sigma=True), CriticEnsemble(OBS, A, HID, 4), box,
                    ensemble_size=4, subset_size=2, actor_delay=1, **common)
    return DiscreteSAC(QNet(OBS_D, HID, NA), QNetEnsemble(OBS_D, HID, NA, 2), Discrete(NA), **common)


def _state(ts) -> dict:
    """The parameters of a train state with every ensemble gathered."""
    from tianshou_tpu_torch.networks.common import full_state_dict

    def copied(sd):
        return {k: v.clone() for k, v in sd.items()}

    return {"actor": copied(ts.actor.state_dict()), "critic": copied(full_state_dict(ts.critic)),
            "target": copied(full_state_dict(ts.target_critic)), "log_alpha": ts.log_alpha.detach().clone()}


def _run_updates(kind: str, steps: int, dp_group=None, ep_group=None, inject=None, jax_params=None):
    """``steps`` updates of ``kind`` from the seed-0 parameters (or
    ``jax_params``): one process with no groups, else this rank's rows of
    the global batch under ``dp_group`` with the ensembles sharded over
    ``ep_group``.  ``inject``: per step, the global ``(target, actor)``
    normal pair in place of draws.  Returns ``(initial state, final state,
    metrics per step, the critic's local members)``."""
    from tianshou_tpu_torch.networks.common import load_full_state_dict
    from tianshou_tpu_torch.parallel.distributed import average_metrics, data_parallel, process_count, process_index
    from tianshou_tpu_torch.parallel.mesh import shard_ensemble_modules
    from tianshou_tpu_torch.utils.device import make_generator

    algo = _algo(kind)
    ts = algo.init(make_generator(0, "cpu"))
    if ep_group is not None:
        shard_ensemble_modules(ts, ep_group)
    if jax_params is not None:
        load_full_state_dict(ts.actor, jax_params["actor"])
        load_full_state_dict(ts.critic, jax_params["critic"])
        load_full_state_dict(ts.target_critic, jax_params["target"])
        with torch.no_grad():
            ts.log_alpha.copy_(jax_params["log_alpha"])
    initial = _state(ts)
    rows_n = B // process_count(dp_group) if dp_group is not None else B
    start = process_index(dp_group) * rows_n if dp_group is not None else 0
    rows = slice(start, start + rows_n)
    gen = make_generator(11, "cpu")
    metrics = []
    for step in range(steps):
        sampled = _sampled(_arrays(step + 1, discrete=kind == "dsac"), rows)
        kw = {}
        if inject is not None:
            kw["noise"] = tuple(torch.as_tensor(n[rows]) for n in inject[step])
        with data_parallel(algo, dp_group, rows_n):
            ts, _, m = algo.update_sampled(ts, None, None, sampled, gen, **kw)
        metrics.append({k: float(v) for k, v in average_metrics(m, dp_group).items()})
    return initial, _state(ts), metrics, ts.critic.weights[0].shape[0]


# -- the ranks' cases -----------------------------------------------------------------
def _case_updates(ctx):
    """Sharded updates on a ``dp x ep`` mesh (``ctx.inputs["ep"]``): SAC
    (from the JAX parameters with the JAX normals when given, else from the
    seed), REDQ and, at ``dp 1``, DiscreteSAC."""
    import torch.distributed as dist

    from tianshou_tpu_torch.parallel.mesh import make_mesh2

    ep = ctx.inputs["ep"]
    mesh = make_mesh2(ctx.world, second_size=ep, device="cpu")
    dp_group, ep_group = mesh.get_group("dp"), mesh.get_group("ep")
    out = {"coords": (dist.get_rank(dp_group), dist.get_rank(ep_group)), "dims": mesh.mesh_dim_names,
           "shape": tuple(mesh.shape)}
    kinds = ("sac", "redq", "dsac") if ctx.world == ep else ("sac", "redq")
    for kind in kinds:
        out[kind] = _run_updates(kind, 1 if kind == "sac" else 2, dp_group, ep_group)
    jax_case = ctx.inputs.get("jax")
    if jax_case is not None:
        out["sac_jax"] = _run_updates("sac", 1, dp_group, ep_group, inject=[jax_case["noise"]],
                                      jax_params=jax_case["params"])
    if ctx.world == ep:
        out["operators"] = _operators(ep_group)
        out["placement"] = _placement(mesh)
        out["checkpoint"] = _checkpoint(ep_group)
    return out


def _placement(mesh) -> dict:
    """``shard_ensemble_axis`` of an ensemble leaf, an odd leaf and a
    scalar on the mesh."""
    from tianshou_tpu_torch.parallel.mesh import shard_ensemble_axis

    tree = {"w": torch.arange(24.0).reshape(4, 2, 3), "odd": torch.arange(4.0 * 5).reshape(5, 4),
            "step": torch.tensor(3)}
    placed = shard_ensemble_axis(tree, mesh, 4)
    return {k: ([type(p).__name__ for p in v.placements], v.to_local(), v.full_tensor()) for k, v in placed.items()}


def _checkpoint(ep_group) -> dict:
    """A one-process REDQ state checkpointed, restored into a train state
    whose ensembles are sharded; and that sharded state's own round trip."""
    import tempfile

    from tianshou_tpu_torch.parallel.mesh import shard_ensemble_modules
    from tianshou_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from tianshou_tpu_torch.utils.device import make_generator

    algo = _algo("redq")
    full = algo.init(make_generator(4, "cpu"))
    template = algo.init(make_generator(5, "cpu"))
    shard_ensemble_modules(template, ep_group)
    with tempfile.TemporaryDirectory() as tmp:
        restored = restore_checkpoint(save_checkpoint(tmp, {"critic": full.critic}), {"critic": template.critic})
        again = restore_checkpoint(save_checkpoint(tmp, {"critic": restored["critic"]}, step=1),
                                   {"critic": template.critic})
    members = restored["critic"].members()
    return {"full": {k: v.clone() for k, v in full.critic.state_dict().items()}, "members": (members.start,
            members.stop), "restored": {k: v.clone() for k, v in restored["critic"].state_dict().items()},
            "again": {k: v.clone() for k, v in again["critic"].state_dict().items()}}


def _operators(ep_group) -> dict:
    """The autograd pair against an unsharded ensemble of 4 members on the
    same input and loss; the gradients ``torch.distributed.nn``'s
    all_gather would give; and the sharded path at ``ep = 1`` (a group of
    this rank alone) against the plain one, bitwise."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn

    from tianshou_tpu_torch.networks.common import EnsembleMLP

    def ensemble(group=None):
        net = EnsembleMLP(4, 5, (8,), 3)
        net.reset_parameters(torch.Generator().manual_seed(3))
        return net.shard_(group) if group is not None else net

    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 6, 3)).astype(np.float32))

    def run(net, gather=None):
        x = x0.clone().requires_grad_(True)
        out = net(x) if gather is None else gather(net, x)
        (out * w).sum().backward()
        return out.detach(), x.grad, [p.grad.clone() for p in net.parameters()]

    plain, sharded = ensemble(), ensemble(ep_group)
    members = sharded.members()

    def library_gather(net, x):  # the members' forward, then torch.distributed.nn's all_gather
        net.shard, shard = None, net.shard
        try:
            local = net(x)
        finally:
            net.shard = shard
        return torch.cat(dnn.all_gather(local, group=ep_group))

    groups = [dist.new_group([r]) for r in range(dist.get_world_size())]
    alone = ensemble(groups[dist.get_rank()])
    return {"plain": run(plain), "sharded": run(sharded), "library": run(ensemble(ep_group), library_gather),
            "alone": run(alone), "members": (members.start, members.stop),
            "init_equal": all(torch.equal(p[members], q) for p, q in zip(plain.parameters(), sharded.parameters())),
            "replicated": _replicated_gradients(ensemble, ep_group, x0, w)}


def _replicated_gradients(ensemble, ep_group, x0, w) -> dict:
    """A replicated layer (an actor's) feeding the ensemble, under a loss
    with a term that does not pass through the ensemble (an entropy term's
    stand-in): its gradient unsharded, sharded with the input operator, and
    sharded without it, each rank's local gradient then summed over the
    ranks (what summing replicated gradients over ``ep`` would give)."""
    import torch.distributed as dist

    from tianshou_tpu_torch.networks.common import _FromEnsembleShards

    def grads(net, through_input_op=True):
        trunk = torch.nn.Linear(5, 5)
        with torch.no_grad():
            trunk.weight.copy_(torch.eye(5) + 0.1)
            trunk.bias.fill_(0.05)
        h = trunk(x0)
        if net.shard is None or through_input_op:
            out = net(h)
        else:  # the members' forward and the gather, no input operator
            net.shard, shard = None, net.shard
            try:
                out = _FromEnsembleShards.apply(net(h), shard)
            finally:
                net.shard = shard
        ((out * w).sum() + (h ** 2).sum()).backward()
        return trunk.weight.grad.clone()

    summed = grads(ensemble(ep_group), through_input_op=False)
    dist.all_reduce(summed, group=ep_group)
    trunk_only = torch.nn.Linear(5, 5)
    with torch.no_grad():
        trunk_only.weight.copy_(torch.eye(5) + 0.1)
        trunk_only.bias.fill_(0.05)
    (trunk_only(x0) ** 2).sum().backward()
    return {"plain": grads(ensemble()), "sharded": grads(ensemble(ep_group)), "summed_over_ep": summed,
            "non_ensemble_term": trunk_only.weight.grad.clone()}


def _case_dryrun(ctx):
    """The dryrun copy on two ranks: DQN's distributed superstep on a 1-D
    mesh, SAC's on a ``dp 1 x ep 2`` mesh with its critics sharded, and one
    distributed PPO segment and learn."""
    import torch.distributed as dist

    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole, Pendulum
    from tianshou_tpu_torch.networks.common import QNet, full_state_dict
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor, ValueNet
    from tianshou_tpu_torch.parallel.mesh import make_mesh, make_mesh2
    from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer, DistributedOnPolicyTrainer
    from tianshou_tpu_torch.utils.device import make_generator

    out = {}
    n_envs = 4  # a rank's
    # phase 1: data parallelism on a 1-D mesh
    env = CartPole()
    dqn = DQN(QNet(4, (32, 32), 2), env.action_space, n_step=3, target_update_freq=10, device="cpu")
    buf = ReplayBuffer(64, n_envs)
    col = Collector(dqn, VectorEnv(env, n_envs, device="cpu"), buf, device="cpu")
    mesh = make_mesh(ctx.world, device="cpu")
    trainer = DistributedOffPolicyTrainer(dqn, col, col, buf, max_epoch=1, step_per_epoch=1,
                                          step_per_collect=ctx.world * n_envs * 4, update_per_step=0.25,
                                          batch_size=16, mesh=mesh, device="cpu")
    ts, cstate, bstate, gens, _ = trainer.init_states()
    _, _, _, _, m = trainer._build_superstep()(ts, cstate, bstate, gens, 0.1)
    out["dqn_loss"] = float(m["loss"])
    # phase 2: dp x ep, SAC's critic ensemble sharded over "ep"
    mesh2 = make_mesh2(ctx.world, second_size=2, device="cpu")
    env2 = Pendulum()
    sac = SAC(GaussianActor(3, (16, 16), 1, conditioned_sigma=True), CriticEnsemble(3, 1, (16, 16), 2),
              env2.action_space, device="cpu")
    buf2 = ReplayBuffer(32, n_envs)
    col2 = Collector(sac, VectorEnv(env2, n_envs, device="cpu"), buf2, device="cpu")
    trainer2 = DistributedOffPolicyTrainer(sac, col2, col2, buf2, max_epoch=1, step_per_epoch=1,
                                           step_per_collect=n_envs * 4, update_per_step=0.25, batch_size=8,
                                           mesh=mesh2, device="cpu")
    ts2, cstate2, bstate2, gens2, _ = trainer2.init_states()
    ts2, _, bstate2, _, m2 = trainer2._build_superstep()(ts2, cstate2, bstate2, gens2, 0.0)
    out["ensemble_ranks"] = dist.get_process_group_ranks(trainer2.ensemble_group)
    out["ep_ranks"] = dist.get_process_group_ranks(mesh2.get_group("ep"))
    out["sac_loss"] = float(m2["critic_loss"])
    out["critic_local"] = [tuple(p.shape) for p in ts2.critic.parameters()]
    out["critic_full"] = {k: v for k, v in full_state_dict(ts2.critic).items()}
    out["actor"] = {k: v.clone() for k, v in ts2.actor.state_dict().items()}
    out["buffer_obs"] = bstate2.storage["obs"].clone()
    # phase 3: the on-policy family over the mesh's data axis
    ppo = PPO(QNet(4, (32, 32), 2), ValueNet(4, (32, 32)), env.action_space, lr=3e-4, gamma=0.99, gae_lambda=0.95,
              device="cpu")
    col3 = Collector(ppo, VectorEnv(env, n_envs, device="cpu"), device="cpu")
    trainer3 = DistributedOnPolicyTrainer(ppo, col3, col3, max_epoch=1, step_per_epoch=1,
                                          step_per_collect=ctx.world * n_envs * 4, repeat_per_collect=2,
                                          batch_size=ctx.world * n_envs * 2, mesh=mesh, device="cpu")
    gen = make_generator(6, "cpu")
    cstate3 = col3.reset(make_generator(7 + ctx.rank, "cpu"))
    ts3 = ppo.init(make_generator(8, "cpu"))
    _, _, _, m3 = trainer3._build_superstep()(ts3, cstate3, gen)
    out["ppo_loss"] = float(next(iter(m3.values())))
    return out


CASES = {"updates": _case_updates, "dryrun": _case_dryrun}


# -- fixtures: each launch once ---------------------------------------------------------
def _jax_sac_case():
    """The JAX package's SAC at the test widths: its initial parameters in
    the port's layout, one replicated update's metrics and parameters, and
    the two normal draws that update takes."""
    import jax
    import jax.numpy as jnp

    from tianshou_tpu.algos.sac import SAC as JaxSAC
    from tianshou_tpu.data.batch import Batch as JaxBatch
    from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
    from tianshou_tpu.envs.spaces import Box as JaxBox
    from tianshou_tpu.networks import continuous as jcont
    from tianshou_tpu_torch.networks.convert import params_from_flax

    jalgo = JaxSAC(jcont.GaussianActor(HID, A, conditioned_sigma=True), jcont.CriticEnsemble(HID, 2),
                   JaxBox(low=-1.0, high=1.0, shape=(A,)), actor_lr=1e-3, critic_lr=1e-3, gamma=0.9, tau=0.05,
                   n_step=N_STEP, alpha_lr=3e-2)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))

    def params(ts):
        return {"actor": params_from_flax(jax.device_get(ts.actor_params), heads=GAUSS_HEADS),
                "critic": params_from_flax(jax.device_get(ts.critic_params)),
                "target": params_from_flax(jax.device_get(ts.target_critic_params)),
                "log_alpha": torch.as_tensor(np.array(ts.log_alpha))}

    arr = _arrays(1)
    c = {k: jnp.asarray(v) for k, v in arr.items()}
    zeros = jnp.zeros(B, jnp.int32)
    sampled = (zeros, zeros, c["weight"], JaxBatch(obs=c["obs"], act=c["act"]), c["rew_chain"], c["done_chain"],
               JaxBatch(obs_next=c["obs_next"], terminated=c["terminated"]))
    key = jax.random.key(101)
    k_tgt, k_pi = jax.random.split(key)
    noise = tuple(np.asarray(jax.random.normal(k, (B, A))) for k in (k_tgt, k_pi))
    initial = params(jts)
    jts, _, jm = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, JaxReplayBuffer(8, 2), None, s, k))(
        jts, sampled, key)
    return {"params": initial, "noise": noise, "metrics": {k: float(v) for k, v in jm.items()},
            "final": params(jts)}


@pytest.fixture(scope="module")
def jax_sac():
    return _jax_sac_case()


@pytest.fixture(scope="module")
def dp1_ep2(jax_sac):
    return run_ranks(__file__, "updates", world=2,
                     inputs={"ep": 2, "jax": {"params": jax_sac["params"], "noise": jax_sac["noise"]}})


@pytest.fixture(scope="module")
def dp2_ep2():
    return run_ranks(__file__, "updates", world=4, inputs={"ep": 2})


@pytest.fixture(scope="module")
def one_process():
    return {kind: _run_updates(kind, 1 if kind == "sac" else 2) for kind in ("sac", "redq", "dsac")}


def _close_state(got: dict, ref: dict, what: str) -> None:
    for part in ("actor", "critic", "target"):
        assert set(got[part]) == set(ref[part]), (what, part)
        for k, v in ref[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{what} {part}.{k}")
    np.testing.assert_allclose(got["log_alpha"].numpy(), ref["log_alpha"].numpy(), rtol=PARAM_RTOL,
                               atol=PARAM_ATOL, err_msg=f"{what} log_alpha")


def _check_sharded_updates(ranks, ref, kind, ep):
    k_full = ref[kind][1]["critic"]["weights.0"].shape[0]
    for r, res in enumerate(ranks):
        initial, final, metrics, local_k = res[kind]
        assert local_k == k_full // ep, (kind, r, local_k)  # each rank holds K / ep critics
        for part in ("actor", "critic", "target"):  # a sharded model starts equal to the unsharded one
            for k, v in ref[kind][0][part].items():
                assert torch.equal(initial[part][k], v), (kind, r, part, k)
        for got, want in zip(metrics, ref[kind][2]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=f"{kind} rank {r} {k}")
        _close_state(final, ref[kind][1], f"{kind} rank {r}")


# -- tests ----------------------------------------------------------------------------------
def test_dryrun_multichip_two_axis_mesh():
    ranks = run_ranks(__file__, "dryrun", world=2)
    a, b = ranks
    for res in ranks:
        for k in ("dqn_loss", "sac_loss", "ppo_loss"):
            assert np.isfinite(res[k]), (k, res[k])
        assert res["ensemble_ranks"] == res["ep_ranks"] == [0, 1], (res["ensemble_ranks"], res["ep_ranks"])
        # the updated critics still live sharded over "ep": one of the two a rank
        assert all(shape[0] == 1 for shape in res["critic_local"]), res["critic_local"]
    # the ep peers hold the same replay, the same replicated actor, the same
    # gathered critics and read the same loss
    assert torch.equal(a["buffer_obs"], b["buffer_obs"])
    assert a["sac_loss"] == b["sac_loss"]
    for k in a["actor"]:
        assert torch.equal(a["actor"][k], b["actor"][k]), k
    for k in a["critic_full"]:
        assert torch.equal(a["critic_full"][k], b["critic_full"][k]), k
        assert a["critic_full"][k].shape[0] == 2


@pytest.mark.parametrize("layout", ["dp1_ep2", "dp2_ep2"])
def test_ensemble_sharded_update_matches_replicated(layout, one_process, request):
    ranks = request.getfixturevalue(layout)
    ep = 2
    assert ranks[0]["dims"] == ("dp", "ep") and ranks[0]["shape"] == (len(ranks) // ep, ep)
    assert [r["coords"] for r in ranks] == [(i // ep, i % ep) for i in range(len(ranks))]
    _check_sharded_updates(ranks, one_process, "sac", ep)


@pytest.mark.parametrize("layout", ["dp1_ep2", "dp2_ep2"])
def test_redq_sharded_updates_match_one_process(layout, one_process, request):
    _check_sharded_updates(request.getfixturevalue(layout), one_process, "redq", 2)


def test_discrete_sac_sharded_updates_match_one_process(dp1_ep2, one_process):
    _check_sharded_updates(dp1_ep2, one_process, "dsac", 2)


def test_sharded_sac_update_matches_jax(dp1_ep2, jax_sac):
    for r, res in enumerate(dp1_ep2):
        _, final, (metrics,), _ = res["sac_jax"]
        assert set(metrics) == set(jax_sac["metrics"])
        for k, v in jax_sac["metrics"].items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-4, atol=1e-5, err_msg=f"rank {r} {k}")
        ref = jax_sac["final"]
        for part in ("actor", "critic", "target"):
            for k, v in ref[part].items():
                np.testing.assert_allclose(final[part][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=f"rank {r} {part}.{k}")


def test_autograd_operators_match_an_unsharded_ensemble(dp1_ep2):
    for r, res in enumerate(dp1_ep2):
        ops = res["operators"]
        assert ops["init_equal"]
        lo, hi = ops["members"]
        assert (lo, hi) == (2 * r, 2 * r + 2)
        p_out, p_dx, p_grads = ops["plain"]
        s_out, s_dx, s_grads = ops["sharded"]
        torch.testing.assert_close(s_out, p_out, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(s_dx, p_dx, rtol=1e-5, atol=1e-6)
        for g, ref in zip(s_grads, p_grads):
            torch.testing.assert_close(g, ref[lo:hi], rtol=1e-5, atol=1e-6)
        # torch.distributed.nn's all_gather sums the gradient over the ranks
        # in its backward: ep (2) times the members' gradients
        _, _, l_grads = ops["library"]
        for g, ref in zip(l_grads, p_grads):
            torch.testing.assert_close(g, 2 * ref[lo:hi], rtol=1e-5, atol=1e-6)
        # a replicated layer before the ensemble gets the unsharded gradient
        # through the input operator; summing its local gradients over ep
        # instead counts the term outside the ensemble ep (2) times
        rep = ops["replicated"]
        torch.testing.assert_close(rep["sharded"], rep["plain"], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(rep["summed_over_ep"], rep["plain"] + rep["non_ensemble_term"], rtol=1e-5,
                                   atol=1e-5)
        assert not torch.allclose(rep["summed_over_ep"], rep["plain"], rtol=1e-3, atol=1e-3)
        # at ep = 1 the sharded path is the plain one, bitwise
        a_out, a_dx, a_grads = ops["alone"]
        assert torch.equal(a_out, p_out) and torch.equal(a_dx, p_dx)
        assert all(torch.equal(g, ref) for g, ref in zip(a_grads, p_grads))


def test_shard_ensemble_axis_places_as_jax_does(dp1_ep2):
    for r, res in enumerate(dp1_ep2):
        place = res["placement"]
        # [K=4, ...] sharded over "ep" (replicated over "dp"), the rest replicated
        assert place["w"][0] == ["Replicate", "Shard"]
        assert torch.equal(place["w"][1], torch.arange(24.0).reshape(4, 2, 3)[2 * r:2 * r + 2])
        assert torch.equal(place["w"][2], torch.arange(24.0).reshape(4, 2, 3))
        for k in ("odd", "step"):
            assert place[k][0] == ["Replicate", "Replicate"]
            assert torch.equal(place[k][1], place[k][2])


def test_checkpoint_restores_a_full_ensemble_into_a_sharded_one(dp1_ep2):
    for r, res in enumerate(dp1_ep2):
        ck = res["checkpoint"]
        lo, hi = ck["members"]
        assert (lo, hi) == (2 * r, 2 * r + 2)
        for k, v in ck["full"].items():
            assert torch.equal(ck["restored"][k], v[lo:hi]), k
            assert torch.equal(ck["again"][k], v[lo:hi]), k


if __name__ == "__main__":
    rank_main(CASES)
