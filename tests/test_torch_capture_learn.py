"""The compiled learn steps (OfflineTrainer._compile_superstep,
OnPolicyTrainer._compile_superstep and _compile_learn,
OffPolicyTrainer._compile_host_step) and what they asked of the
algorithms, on the CPU:

- the learning-rate schedule on the device: ``linear_schedule`` on a
  tensor count against ``optax.linear_schedule`` over ``2 x T + 3`` counts
  (bitwise in float32); PPO with a scheduled rate, update by update and
  over a rollout learn fed the JAX permutations, against the JAX PPO's
  ``optax.adam(schedule)`` (the rate bitwise, states within the parity
  tests' limits, rtol 1e-4 / atol 1e-5); ``mujoco_trpo.scheduled_adam``'s
  rate at every critic step against optax's schedule (bitwise) and its
  parameters against ``optax.adam(schedule)`` (atol 5e-7, the wiring
  test's limit);
- the static-state protocol (``StaticStep``) over the offline superstep (a
  small CQL(Lagrange) and a small DiscreteCQL) and the on-policy superstep
  (a small PPO with ret_norm, recompute_advantage and a schedule, and a
  small TRPO): the same objects returned, every tensor bitwise equal to the
  eager step's from the same generator state, the dataset's storage
  unmoved; a step that rebinds a train-state tensor raises;
- the host paths' static staging: two different segments written in turn
  into one staging tree, each with exactly one packed host-to-device copy,
  the on-policy learning and the off-policy host step on it bitwise equal
  to the eager ``learn(ts, col.to_device(traj), gen)`` and
  ``HostStep.device``;
- on a card only (skipped here): a warm-up and two replays against three
  eager steps of a small ``ppo_cartpole`` and a small CQL, bitwise.
"""

import copy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tianshou_tpu_torch.algos.pg import ScheduledAdam, linear_schedule
from tianshou_tpu_torch.algos.ppo import PPO
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.tree import tree_leaves
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole, Pendulum
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.trainer.offline import OfflineTrainer
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer, build_rollout_learn
from tianshou_tpu_torch.utils.device import fork_generator, make_generator
from tianshou_tpu_torch.utils.graphs import CapturedStep, StaticStep, named_tensors, optimizers, prepare_optimizer
from tianshou_tpu_torch.utils.transfer import TreePacker

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

from test_torch_examples_flags import _one_torch_thread  # noqa: E402, F401
from test_torch_onpolicy import (_algo_pair, _assert_state_close, _close, _minibatch, _t, _traj_pair,  # noqa: E402
                                 _trajectory)

HID = (16, 16)


def _f32(x) -> np.float32:
    return np.float32(np.asarray(x))


def _clone_gen(g: torch.Generator) -> torch.Generator:
    c = torch.Generator(device=g.device)
    c.set_state(g.get_state())
    return c


def _leaves(state, gens, metrics=None) -> list:
    """Named tensors of a carried state, the generators' states and a
    step's metrics, for a bitwise comparison."""
    leaves = named_tensors(state) + [(f"gen{i}", g.get_state()) for i, g in enumerate(gens)]
    return leaves + [(f"metrics[{k!r}]", v) for k, v in (metrics or {}).items()]


def _assert_bitwise(a: list, b: list) -> None:
    assert not chip_smoke._differing(a, b)


# -- the learning-rate schedule on the device -------------------------------------
@pytest.mark.parametrize("init,end,steps", [(3e-4, 0.0, 7), (1e-3, 2e-4, 10)])
def test_linear_schedule_on_a_tensor_count_is_optax(init, end, steps):
    ours, ref = linear_schedule(init, end, steps), optax.linear_schedule(init, end, steps)
    for k in range(2 * steps + 3):
        want = _f32(ref(jnp.asarray(k, jnp.int32)))
        for count in (torch.tensor(k), torch.tensor(float(k))):  # a device step count, an Adam step count
            got = ours(count)
            assert got.dtype == torch.float32 and got.shape == ()
            assert _f32(got) == want, k
        assert ours(k) == pytest.approx(float(want), rel=1e-6)  # the host form


def test_ppo_schedule_per_update_matches_optax():
    """Six PPO updates from the same parameters and minibatches with a
    schedule of 4 transition steps: the rate the port's Adam steps with is
    optax's for that update, bitwise, and the states stay within the parity
    limits."""
    kw = dict(lr=linear_schedule(3e-3, 0.0, 4), max_grad_norm=0.5, adv_norm=False, vf_coef=0.25)
    jalgo, jts, talgo, tts, heads = _algo_pair(
        "ppo", "continuous", jax_kwargs=dict(lr=3e-3, optimizer=optax.adam(optax.linear_schedule(3e-3, 0.0, 4))),
        **kw)
    ref = optax.linear_schedule(3e-3, 0.0, 4)
    lr = tts.optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and int(tts.lr_count) == 0
    learn = jax.jit(jalgo.learn)
    for step in range(6):
        jmb, tmb = _minibatch("ppo", "continuous", jalgo, jts, seed=20 + step)
        jts, jm = learn(jts, jmb, jax.random.key(step))
        tts, tm = talgo.learn(tts, tmb)
        assert tts.optimizer.param_groups[0]["lr"] is lr  # written in place
        assert _f32(lr) == _f32(ref(step)), step
        assert int(tts.lr_count) == tts.step == step + 1
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=f"update {step} {k}")
        _assert_state_close(jts, tts, heads)
    assert float(lr) == 0.0


def test_ppo_schedule_over_a_rollout_learn_matches_jax():
    """The host path's learning (``build_rollout_learn``) over a [12, 3]
    rollout, 2 passes of 3 minibatches fed the JAX permutations, with
    ret_norm and recompute_advantage, against the JAX trainer's jitted learn
    with ``optax.adam(schedule)``."""
    from tianshou_tpu.trainer.onpolicy import OnPolicyTrainer as JaxOnPolicyTrainer

    kw = dict(lr=linear_schedule(3e-3, 1e-3, 4), max_grad_norm=0.5, ret_norm=True, recompute_advantage=True,
              gamma=0.9, gae_lambda=0.9)
    jalgo, jts, talgo, tts, heads = _algo_pair(
        "ppo", "continuous", jax_kwargs=dict(lr=3e-3, optimizer=optax.adam(optax.linear_schedule(3e-3, 1e-3, 4))),
        **kw)
    col = types.SimpleNamespace(venv=types.SimpleNamespace(num_envs=3))
    jtrainer = JaxOnPolicyTrainer(jalgo, col, col, max_epoch=1, step_per_epoch=36, step_per_collect=36,
                                  repeat_per_collect=2, batch_size=12)
    jlearn = jtrainer._build_learn_fn()
    for seed in (1, 2):  # the second learn continues the schedule from 6
        jtraj, ttraj = _traj_pair(_trajectory("continuous", T=12, N=3, seed=seed))
        key = jax.random.key(seed)
        perms = iter([_t(jax.random.permutation(jax.random.split(k)[0], 36)).long()
                      for k in jax.random.split(key, 2)])
        jts, jm = jlearn(jts, jtraj, key)
        learn = build_rollout_learn(talgo, 36, 12, 2, permutation=lambda g, m: next(perms))
        tts, tm = learn(tts, ttraj, torch.Generator())
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=k)
        assert int(tts.lr_count) == tts.step == int(jts.step) == 6 * seed
        _assert_state_close(jts, tts, heads)
    assert _f32(tts.optimizer.param_groups[0]["lr"]) == _f32(optax.linear_schedule(3e-3, 1e-3, 4)(11))


def test_mujoco_trpo_scheduled_adam_steps_on_optax_schedule():
    from tianshou_tpu_torch.examples.mujoco_trpo import scheduled_adam

    schedule, ref = linear_schedule(1e-2, 0.0, 6), optax.linear_schedule(1e-2, 0.0, 6)
    rng = np.random.default_rng(0)
    p0 = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    grads = [(rng.normal(size=8) * 1e-1).astype(np.float32) for _ in range(9)]
    w = torch.nn.Parameter(torch.tensor(p0))
    opt = scheduled_adam([w], schedule)
    assert isinstance(opt, ScheduledAdam)
    tx = optax.adam(ref)
    p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    rates = []
    opt.register_step_post_hook(lambda o, args, kwargs: rates.append(_f32(o.param_groups[0]["lr"])))
    for k, g in enumerate(grads):
        if k == 4:  # a copy (a checkpoint's, a snapshot's) keeps the schedule and the count
            opt = copy.deepcopy(opt)
            w = opt.param_groups[0]["params"][0]
            opt.register_step_post_hook(lambda o, args, kwargs: rates.append(_f32(o.param_groups[0]["lr"])))
        updates, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, updates)
        w.grad = torch.tensor(g)
        opt.step()
    assert rates == [_f32(ref(k)) for k in range(len(grads))]
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), rtol=0, atol=5e-7)


# -- the static-state protocol over the offline and on-policy supersteps --------------
def _small_cql(device="cpu"):
    from tianshou_tpu_torch.algos.offline import CQL
    from tianshou_tpu_torch.data.persistence import buffer_from_d4rl

    rng = np.random.default_rng(0)
    n = 300
    data = dict(observations=rng.normal(size=(n, 3)).astype(np.float32),
                actions=rng.uniform(-1, 1, (n, 1)).astype(np.float32), rewards=rng.normal(size=n),
                terminals=np.arange(n) % 97 == 96, timeouts=np.arange(n) % 50 == 49,
                next_observations=rng.normal(size=(n, 3)).astype(np.float32))
    buffer, bstate = buffer_from_d4rl(data, device=device)
    env = Pendulum()
    algo = CQL(tcont.GaussianActor(3, HID, 1, conditioned_sigma=True), tcont.CriticEnsemble(3, 1, HID),
               env.action_space, num_repeat_actions=3, with_lagrange=True, lagrange_threshold=5.0, device=device)
    return env, algo, buffer, bstate


def _small_discrete_cql():
    from tianshou_tpu_torch.algos.offline import DiscreteCQL
    from tianshou_tpu_torch.networks.discrete import QRDQNNet

    env = CartPole()
    buffer, bstate = chip_smoke.cartpole_offline_ring("cpu", 4, 60)
    algo = DiscreteCQL(QRDQNNet(4, HID, 2, num_quantiles=8), env.action_space, num_quantiles=8, min_q_weight=10.0,
                       gamma=0.95, n_step=3, target_update_freq=3, device="cpu")
    return env, algo, buffer, copy.deepcopy(bstate)


def _offline_trainer(kind):
    env, algo, buffer, bstate = _small_cql() if kind == "cql" else _small_discrete_cql()
    test = Collector(algo, VectorEnv(env, 2, device="cpu"), device="cpu")
    trainer = OfflineTrainer(algo, buffer, bstate, test, max_epoch=1, update_per_epoch=8, batch_size=8,
                             updates_per_superstep=4, episode_per_test=2, device="cpu")
    return algo, buffer, bstate, trainer


@pytest.mark.parametrize("kind", ["cql", "discrete_cql"])
def test_static_offline_superstep_is_the_eager_one(kind):
    algo, buffer, bstate, trainer = _offline_trainer(kind)
    gen = make_generator(0, "cpu")
    ts = algo.init(fork_generator(gen))
    p_ts, p_bstate = copy.deepcopy((ts, bstate))
    p_gen = _clone_gen(gen)
    eager = trainer._build_superstep()
    step = trainer._compile_superstep(ts, bstate)
    assert not isinstance(step, CapturedStep)  # a CPU trainer runs the eager superstep
    static = StaticStep(step, ts, (), bstate)
    dataset = [t.untyped_storage().data_ptr() for t in tree_leaves(bstate.storage)]
    for _ in range(2):
        out = static(ts, (), bstate, gen, 0.0)
        assert out[0] is ts and out[1] == () and out[2] is bstate and out[3] is None
        p_ts, p_bstate, p_metrics = eager(p_ts, p_bstate, p_gen)
        _assert_bitwise(_leaves((ts, bstate), [gen], out[4]), _leaves((p_ts, p_bstate), [p_gen], p_metrics))
    assert [t.untyped_storage().data_ptr() for t in tree_leaves(bstate.storage)] == dataset
    assert static.copy_back_bytes == 0  # the superstep returns the dataset's state as it is
    assert ts.step == 8


def _onpolicy_trainer(name):
    env = CartPole() if name == "ppo" else Pendulum()
    obs_dim = 4 if name == "ppo" else 3
    critic = tcont.ValueNet(obs_dim, HID)
    if name == "ppo":
        algo = PPO(QNet(4, HID, 2), critic, env.action_space, lr=linear_schedule(3e-3, 0.0, 5), ret_norm=True,
                   recompute_advantage=True, max_grad_norm=0.5, device="cpu")
    else:
        from tianshou_tpu_torch.algos.npg import TRPO

        algo = TRPO(tcont.GaussianActor(3, HID, 1), critic, env.action_space, optim_critic_iters=2, device="cpu")
    train = Collector(algo, VectorEnv(env, 3, device="cpu"), device="cpu")
    test = Collector(algo, VectorEnv(env, 2, device="cpu"), device="cpu")
    return algo, OnPolicyTrainer(algo, train, test, max_epoch=1, step_per_epoch=24, step_per_collect=24,
                                 repeat_per_collect=2, batch_size=8 if name == "ppo" else 24, episode_per_test=2,
                                 device="cpu")


@pytest.mark.parametrize("name", ["ppo", "trpo"])
def test_static_onpolicy_superstep_is_the_eager_one(name):
    algo, trainer = _onpolicy_trainer(name)
    gen = make_generator(0, "cpu")
    g_init, g_reset = fork_generator(gen), fork_generator(gen)
    cstate = trainer.train_collector.reset(g_reset)
    ts = algo.init(g_init)
    p_gen, p_rng = _clone_gen(gen), _clone_gen(cstate.rng)
    p_ts, p_cstate = copy.deepcopy((ts, cstate), {id(cstate.rng): p_rng})
    eager = trainer._build_superstep()
    step = trainer._compile_superstep(ts, cstate)
    assert not isinstance(step, CapturedStep)
    static = StaticStep(step, ts, cstate, None)
    for _ in range(2):
        out = static(ts, cstate, None, gen, 0.0)
        assert out[0] is ts and out[1] is cstate and out[2] is None
        p_ts, p_cstate, p_out, p_metrics = eager(p_ts, p_cstate, p_gen)
        _assert_bitwise(_leaves((ts, cstate), [gen, cstate.rng], out[4]) + named_tensors(out[3], "outputs"),
                        _leaves((p_ts, p_cstate), [p_gen, p_rng], p_metrics) + named_tensors(p_out, "outputs"))
        assert 0 < static.copy_back_bytes
    assert ts.step == 2 * trainer.updates_per_segment
    if name == "ppo":
        assert int(ts.lr_count) == ts.step


def test_a_step_that_rebinds_a_train_state_tensor_raises():
    algo, trainer = _onpolicy_trainer("ppo")
    gen = make_generator(0, "cpu")
    cstate = trainer.train_collector.reset(fork_generator(gen))
    ts = algo.init(fork_generator(gen))
    step = trainer._compile_superstep(ts, cstate)

    def rebinding(ts, cstate, bstate, generator, explore_param):
        out = step(ts, cstate, bstate, generator, explore_param)
        ts.ret_mean = ts.ret_mean + 1.0  # a new tensor, which a graph would never write
        return out

    with pytest.raises(RuntimeError, match="ret_mean"):
        StaticStep(rebinding, ts, cstate, None)(ts, cstate, None, gen, 0.0)


# -- the host paths' static staging ------------------------------------------------------
def _ppo_host_trainer():
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs.host import NormObsHostVectorEnv

    env = chip_smoke.HalfCheetahStandIn()
    algo = PPO(tcont.GaussianActor(env.OBS_DIM, HID, env.ACT_DIM, sigma_init=-0.5), tcont.ValueNet(env.OBS_DIM, HID),
               env.action_space, lr=linear_schedule(3e-4, 0.0, 7), vf_coef=0.25, max_grad_norm=0.5, adv_norm=False,
               ret_norm=True, recompute_advantage=True, device="cpu")
    train = HostCollector(algo, NormObsHostVectorEnv([chip_smoke.HalfCheetahStandIn] * 2), device="cpu")
    test = HostCollector(algo, NormObsHostVectorEnv([chip_smoke.HalfCheetahStandIn] * 2, update_rms=False),
                         device="cpu")
    return algo, OnPolicyTrainer(algo, train, test, max_epoch=1, step_per_epoch=24, step_per_collect=12,
                                 repeat_per_collect=2, batch_size=4, episode_per_test=1, device="cpu")


def test_host_learn_on_the_staging_is_the_eager_learn():
    algo, trainer = _ppo_host_trainer()
    col = trainer.train_collector
    ts, gen, g_collect = trainer._host_setup()
    trajs = [col.collect(ts, None, trainer.segment_len, g_collect, explore=True, record_traj=True)[2]
             for _ in range(2)]
    assert not np.array_equal(trajs[0]["obs"], trajs[1]["obs"])
    p_ts, p_gen = copy.deepcopy(ts), _clone_gen(gen)
    eager = trainer._build_learn()
    staging = step = None
    for traj in trajs:
        copies = TreePacker.copies
        staging = col.upload(traj, staging)
        assert TreePacker.copies == copies + 1  # one packed copy a segment, into the staging
        if step is None:
            flat = staging[1]
            step = StaticStep(trainer._compile_learn(ts, staging), ts, staging, None)
        assert staging is step.cstate and staging[1] is flat
        out = step(ts, staging, None, gen, 0.0)
        assert out[0] is ts and out[1] is staging
        p_ts, p_metrics = eager(p_ts, col.to_device(traj), p_gen)
        _assert_bitwise(_leaves(ts, [gen], out[4]), _leaves(p_ts, [p_gen], p_metrics))
    assert int(ts.lr_count) == ts.step == 2 * trainer.updates_per_segment
    with pytest.raises(ValueError, match="schema"):  # another shape of segment does not fit the staging
        col.upload(col.collect(ts, None, 1, g_collect, explore=True, record_traj=True)[2], staging)


def test_offpolicy_host_step_on_the_staging_is_the_eager_device_part():
    small = dict(segment=2, batch=8, updates=2, capacity=64, warmup=32)
    _, algo, col, buffer, trainer = chip_smoke.build_path("sac_host", "cpu", **small)
    loop, _ = trainer._host_setup()
    trajs = [loop.collect(0.0)[1] for _ in range(2)]
    host_step, ts, bstate, gen = loop.host_step, loop.ts, loop.bstate, loop.generator
    p_ts, p_bstate = copy.deepcopy((ts, bstate))
    p_gen = _clone_gen(gen)
    staging = host_step.upload(trajs[0])
    step = StaticStep(trainer._compile_host_step(host_step, ts, bstate, staging), ts, staging, bstate)
    ring = [t.untyped_storage().data_ptr() for t in tree_leaves(bstate.storage)]
    for i, traj in enumerate(trajs):
        if i:
            copies = TreePacker.copies
            assert host_step.upload(traj, staging) is staging
            assert TreePacker.copies == copies + 1
        out = step(ts, staging, bstate, gen, 0.0)
        assert out[0] is ts and out[1] is staging and out[2] is bstate
        p_ts, p_bstate, p_metrics = host_step.device(p_ts, p_bstate, host_step.upload(traj), p_gen)
        _assert_bitwise(_leaves((ts, bstate), [gen], out[4]), _leaves((p_ts, p_bstate), [p_gen], p_metrics))
    assert [t.untyped_storage().data_ptr() for t in tree_leaves(bstate.storage)] == ring
    assert 0 < step.copy_back_bytes  # the cursors
    for t in (trainer.train_collector, trainer.test_collector):
        t.venv.close()


# -- on a card only -------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("path", ["ppo_cartpole", "cql"])
def test_replays_equal_the_eager_learn_steps_bitwise(path):
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a CUDA device (chip_smoke.py's learn-graph phase runs this check on the card)")
    if path == "ppo_cartpole":
        _, algo, col, _, trainer = chip_smoke.build_onpolicy_path(path, "cuda")
        gen = make_generator(0, "cuda")
        cstate = col.reset(fork_generator(gen))
        ts = algo.init(fork_generator(gen))
        state = [ts, cstate, None]
        eager = trainer._build_superstep()
        gens = lambda s, g: [g, s[1].rng]  # noqa: E731
    else:
        env, algo, buffer, bstate = _small_cql("cuda")
        test = Collector(algo, VectorEnv(env, 2, device="cuda"), device="cuda")
        trainer = OfflineTrainer(algo, buffer, bstate, test, max_epoch=1, update_per_epoch=4, batch_size=8,
                                 updates_per_superstep=4, device="cuda")
        gen = make_generator(0, "cuda")
        state = [algo.init(fork_generator(gen)), (), bstate]
        superstep = trainer._build_superstep()

        def eager(ts, bstate, g):
            ts, bstate, metrics = superstep(ts, bstate, g)
            return ts, bstate, None, metrics

        gens = lambda s, g: [g]  # noqa: E731
    memo = {id(g): _clone_gen(g) for g in gens(state, gen)}
    e_state, e_gen = copy.deepcopy(state, memo), memo[id(gen)]
    for opt in optimizers(e_state[0]):  # as the capture prepares the graph's
        prepare_optimizer(opt)
    compiled = (trainer._compile_superstep(*state[:2]) if path == "ppo_cartpole"
                else trainer._compile_superstep(state[0], state[2]))
    assert isinstance(compiled, CapturedStep)
    for _ in range(3):  # the warm-up, then two replays
        g_out = compiled(*state, gen, 0.0)
        state = list(g_out[:3])
        carried = 1 if path == "ppo_cartpole" else 2
        e_out = eager(e_state[0], e_state[carried], e_gen)
        e_state[0], e_state[carried] = e_out[0], e_out[1]
        _assert_bitwise(_leaves(tuple(state), gens(state, gen), g_out[4]),
                        _leaves(tuple(e_state), gens(e_state, e_gen), e_out[3]))
    assert sum(g.replays for g in compiled.graphs.values()) == 2
