"""The compiled collection (the host collectors' ``ActingStep``, the fused
fine cycle, the device ``Collector``'s segments and test chunks) under the
static-state protocol, on the CPU:

- ``compile_step`` is made the protocol's eager form
  (``utils.graphs.StaticStep``: the states of the first call are the step's
  static state, new leaves copied back), which a CUDA graph replays on the
  card;
- the acting step over two segments, each row written into the static
  ``[T, N]`` segment at the device-side cursor, bitwise equal to the eager
  ``torch.stack`` path (act, map, stack, step by step) for PPO (with its
  ``log_prob``), SAC, DQN and the dict-observation MARL manager; two
  returned trajectories share no storage;
- a greedy ``HostCollector`` segment and ``collect_episodes`` against the
  JAX ``HostCollector`` on the same gymnasium envs and seed, weights carried
  by ``networks/convert.py``;
- the async collector's carry, advanced for the masked rows by the acting
  step, against ``index_copy`` and the JAX ``.at[idx].set`` for DRQN;
- three fused fine cycles on a static staging buffer (one packed copy a
  cycle, the buffer never moved) against the eager cycle;
- ``Collector.collect_episodes`` with its static collect state and its
  re-seeded generator against the eager test phase over two phases, its
  greedy CartPole returns against the JAX collector's; ``Collector.collect``
  returning a trajectory of the caller's own;
- a call over another train state captures again instead of replaying;
- on a card only (skipped here): an acting step's warm-up and replays
  against eager acting, bitwise.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

gym = pytest.importorskip("gymnasium")

from tianshou_tpu.algos.dqn import DQN as JaxDQN  # noqa: E402
from tianshou_tpu.collect.collector import Collector as JaxCollector  # noqa: E402
from tianshou_tpu.collect.host_collector import HostCollector as JaxHostCollector  # noqa: E402
from tianshou_tpu.envs import host as jhost  # noqa: E402
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv  # noqa: E402
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete  # noqa: E402
from tianshou_tpu.networks.common import QNet as JaxQNet  # noqa: E402
from tianshou_tpu_torch.algos.dqn import DQN  # noqa: E402
from tianshou_tpu_torch.algos.drqn import DRQN  # noqa: E402
from tianshou_tpu_torch.algos.multiagent import MultiAgentPolicyManager  # noqa: E402
from tianshou_tpu_torch.algos.ppo import PPO  # noqa: E402
from tianshou_tpu_torch.algos.sac import SAC  # noqa: E402
from tianshou_tpu_torch.collect import collector as collector_module  # noqa: E402
from tianshou_tpu_torch.collect import host_collector as host_collector_module  # noqa: E402
from tianshou_tpu_torch.collect.collector import Collector, rollout_segment  # noqa: E402
from tianshou_tpu_torch.collect.host_collector import ActingStep, HostCollector  # noqa: E402
from tianshou_tpu_torch.data.batch import Batch  # noqa: E402
from tianshou_tpu_torch.data.buffer import ReplayBuffer  # noqa: E402
from tianshou_tpu_torch.data.tree import tree_leaves, tree_map  # noqa: E402
from tianshou_tpu_torch.envs.base import VectorEnv  # noqa: E402
from tianshou_tpu_torch.envs.host import HostVectorEnv  # noqa: E402
from tianshou_tpu_torch.envs.spaces import Discrete  # noqa: E402
from tianshou_tpu_torch.networks import continuous as tcont  # noqa: E402
from tianshou_tpu_torch.networks.common import QNet, RecurrentQNet  # noqa: E402
from tianshou_tpu_torch.networks.convert import params_from_flax  # noqa: E402
from tianshou_tpu_torch.trainer import offpolicy as offpolicy_module  # noqa: E402
from tianshou_tpu_torch.trainer.offpolicy import FusedHostLoop, OffPolicyTrainer  # noqa: E402
from tianshou_tpu_torch.utils.device import fork_generator, make_generator  # noqa: E402
from tianshou_tpu_torch.utils.graphs import StaticStep, named_tensors, own_storage  # noqa: E402
from tianshou_tpu_torch.utils.transfer import TreePacker  # noqa: E402

from test_torch_examples_flags import _one_torch_thread  # noqa: E402, F401
from test_torch_finite import _make_sharded  # noqa: E402
from test_torch_onpolicy import _Cart, _JaxCart  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def static_steps(monkeypatch):
    """``compile_step`` as the static-state protocol on the CPU: every
    compiled step a ``StaticStep`` (what a CUDA graph replays, run
    eagerly)."""
    made = []

    def compile_static(fn, device, ts, cstate, bstate, key=tuple, prepare_optimizers=True, name="step"):
        made.append(StaticStep(fn, ts, cstate, bstate))
        return made[-1]

    for module in (host_collector_module, collector_module, offpolicy_module):
        monkeypatch.setattr(module, "compile_step", compile_static)
    return made


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _copy_gen(g: torch.Generator) -> torch.Generator:
    c = torch.Generator()
    c.set_state(g.get_state())
    return c


def _pendulum():
    return gym.make("Pendulum-v1")


def _cartpole():
    return gym.make("CartPole-v1")


def _tictactoe():
    from pettingzoo.classic import tictactoe_v3

    from tianshou_tpu_torch.envs.pettingzoo_env import PettingZooEnv

    return PettingZooEnv(tictactoe_v3.env())


def _acting_case(name: str):
    """``(algo, ts, env factory, explore_param)`` of a small acting policy."""
    if name == "ppo":
        space = HostVectorEnv([_pendulum]).action_space
        algo = PPO(tcont.GaussianActor(3, (16,), 1), tcont.ValueNet(3, (16,)), space, device="cpu")
        return algo, algo.init(_gen(0)), _pendulum, 0.0
    if name == "sac":
        space = HostVectorEnv([_pendulum]).action_space
        algo = SAC(tcont.GaussianActor(3, (16,), 1, conditioned_sigma=True), tcont.CriticEnsemble(3, 1, (16,)),
                   space, device="cpu")
        return algo, algo.init(_gen(0)), _pendulum, 0.0
    if name == "dqn":
        algo = DQN(QNet(4, (16,), 2), Discrete(2), device="cpu")
        return algo, algo.init(_gen(0)), _cartpole, 0.3
    agents = [DQN(QNet(18, (16,), 9), Discrete(9), device="cpu") for _ in range(2)]
    algo = MultiAgentPolicyManager(agents)
    return algo, algo.init(_gen(0)), _tictactoe, 0.5


def _stack_segment(algo, ts, venv, obs, steps, gen, explore_param):
    """The eager ``torch.stack`` path of a host segment: act, map and step,
    one env step at a time, the raw actions and extras stacked at the end."""
    host, acts, extras = [], [], []
    for _ in range(steps):
        dev_obs = Batch({k: torch.as_tensor(v) for k, v in obs.items()}) if isinstance(obs, dict) \
            else torch.as_tensor(obs)
        raw, ex = algo.act_with_extras(ts, dev_obs, gen, True, explore_param)
        res, carry = venv.step(algo.map_action(raw).cpu().numpy())
        host.append(Batch(obs=obs, rew=res.reward, terminated=res.terminated, truncated=res.truncated,
                          obs_next=res.obs))
        acts.append(raw)
        if ex:
            extras.append(ex)
        obs = carry
    traj = tree_map(lambda *xs: np.stack(xs), *host)
    traj["act"] = torch.stack(acts)
    if extras:
        traj["policy"] = tree_map(lambda *xs: torch.stack(xs), *extras)
    return traj, obs


def _named(tree, prefix="traj"):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], f"{prefix}.{k}")]
    return [(prefix, torch.as_tensor(np.asarray(tree)) if not isinstance(tree, torch.Tensor) else tree)]


def _assert_bitwise(a: list, b: list) -> None:
    assert [n for n, _ in a] == [n for n, _ in b]
    for (n, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, n
        assert torch.equal(x, y), n


@pytest.mark.parametrize("name", ["ppo", "sac", "dqn", "marl"])
def test_acting_step_segments_match_the_stack_path(static_steps, name):
    algo, ts, make, explore_param = _acting_case(name)
    n, steps = 3, 5
    col = HostCollector(algo, HostVectorEnv([make] * n), device="cpu")
    ref_venv = HostVectorEnv([make] * n)
    col.reset(seed=4)
    ref_obs = ref_venv.reset(4)
    gen = _gen(1)
    ref_gen = _copy_gen(gen)
    trajs = []
    for _ in range(2):
        _, _, traj = col.collect(ts, None, steps, gen, explore=True, explore_param=explore_param, record_traj=True)
        ref, ref_obs = _stack_segment(algo, ts, ref_venv, ref_obs, steps, ref_gen, explore_param)
        _assert_bitwise(_named(ref), _named(traj))
        _assert_bitwise(_named(ref_obs, "obs"), _named(col.obs, "obs"))
        assert torch.equal(gen.get_state(), ref_gen.get_state())
        trajs.append(traj)
    # one static step, its segment written at the cursor: T rows a segment
    acting = col._acting_steps[CPU]
    (compiled, io, *_), = acting._steps.values()
    assert isinstance(compiled, StaticStep) and int(io.cursor) == steps
    assert io.segment["act"].shape[:2] == (steps, n)
    assert ("policy" in trajs[0]) == (name == "ppo")
    col.venv.close()
    ref_venv.close()


def test_returned_trajectories_do_not_alias(static_steps):
    algo, ts, make, _ = _acting_case("ppo")
    col = HostCollector(algo, HostVectorEnv([make] * 2), device="cpu")
    col.reset(seed=0)
    first = col.collect(ts, None, 4, _gen(0), record_traj=True)[2]
    kept = {k: v.clone() for k, v in (("act", first["act"]), ("log_prob", first["policy"]["log_prob"]))}
    second = col.collect(ts, None, 4, _gen(1), record_traj=True)[2]
    segment = col._acting_steps[CPU].io.segment
    for k, got in (("act", first["act"]), ("log_prob", first["policy"]["log_prob"])):
        assert torch.equal(got, kept[k]), k
    for t in (first["act"], first["policy"]["log_prob"]):
        storages = {x.untyped_storage().data_ptr() for x in tree_leaves(segment)}
        storages |= {second["act"].untyped_storage().data_ptr(),
                     second["policy"]["log_prob"].untyped_storage().data_ptr()}
        assert t.untyped_storage().data_ptr() not in storages
    col.venv.close()


def _dqn_pair(hidden=(16,)):
    jalgo = JaxDQN(JaxQNet(hidden, 2), JaxDiscrete(2), gamma=0.9, target_update_freq=0)
    jts = jalgo.init(jax.random.key(0), jnp.zeros(4, jnp.float32))
    talgo = DQN(QNet(4, hidden, 2), Discrete(2), gamma=0.9, target_update_freq=0, device="cpu")
    tts = talgo.init(_gen(0))
    tts.online.load_state_dict(params_from_flax(jax.device_get(jts.params)))
    return jalgo, jts, talgo, tts


def test_greedy_host_segment_and_episodes_match_jax(static_steps):
    jalgo, jts, talgo, tts = _dqn_pair()
    n, steps = 3, 30
    jcol = JaxHostCollector(jalgo, jhost.HostVectorEnv([_cartpole] * n), act_on_host=False)
    tcol = HostCollector(talgo, HostVectorEnv([_cartpole] * n), device="cpu")
    jcol.reset(seed=7)
    tcol.reset(seed=7)
    _, jstats, jtraj = jcol.collect(jts, None, steps, jax.random.key(1), explore=False, record_traj=True)
    _, tstats, ttraj = tcol.collect(tts, None, steps, _gen(1), explore=False, record_traj=True)
    np.testing.assert_array_equal(ttraj["act"].numpy(), np.asarray(jtraj["act"]))
    for k in ("obs", "rew", "terminated", "truncated", "obs_next"):
        np.testing.assert_array_equal(ttraj[k], np.asarray(jtraj[k]), err_msg=k)
    np.testing.assert_array_equal(tstats.returns, jstats.returns)
    # the test phase: both collectors' envs reset from one seed (the two
    # packages draw the reset seed from different streams)
    for col, cls in ((jcol, JaxHostCollector), (tcol, HostCollector)):
        col.reset = lambda seed=0, col=col, cls=cls: cls.reset(col, 11)
    jep = jcol.collect_episodes(jts, jax.random.key(2), 5)
    tep = tcol.collect_episodes(tts, _gen(2), 5)
    assert tep.n_collected_episodes == jep.n_collected_episodes == 5
    np.testing.assert_array_equal(tep.returns, jep.returns)
    np.testing.assert_array_equal(tep.lens, jep.lens)
    jcol.venv.close()
    tcol.venv.close()


def test_async_masked_carry_matches_index_copy_and_jax(static_steps):
    """DRQN's carry advanced by the acting step for the rows of a mask
    (``torch.where(mask, new, old)``) against ``old.index_copy(0, idx,
    new[idx])`` (the eager collector's update) and the JAX collector's
    ``old.at[idx].set(new[idx])``, round by round, bitwise."""
    algo = DRQN(RecurrentQNet(3, 8, 2), Discrete(2), device="cpu")
    ts = algo.init(_gen(0))
    rng = np.random.default_rng(0)
    n = 5
    carry = own_storage(algo.init_policy_state(n))
    ref = [t.clone() for t in carry]
    jref = [jnp.asarray(t.numpy()) for t in carry]
    gen = _gen(3)
    acting = ActingStep(algo, CPU).begin(ts, np.zeros((n, 3), np.float32), gen, False, policy_state=carry)
    for _ in range(6):
        obs = rng.normal(size=(n, 3)).astype(np.float32)
        mask = rng.random(n) < 0.5
        mask[rng.integers(n)] = True
        env_act = acting(obs, mask)
        q, new = ts.online(torch.from_numpy(obs), tuple(ref))
        idx = torch.from_numpy(np.nonzero(mask)[0])
        ref = [old.index_copy(0, idx, nw[idx]) for old, nw in zip(ref, new)]
        jidx = jnp.asarray(np.nonzero(mask)[0])
        jref = [old.at[jidx].set(jnp.asarray(nw.detach().numpy())[jidx]) for old, nw in zip(jref, new)]
        np.testing.assert_array_equal(env_act, q.argmax(-1).numpy())
        for got, want, jwant in zip(carry, ref, jref):
            assert torch.equal(got, want)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))
    assert any(float(t.abs().sum()) > 0 for t in carry)


def _fused_trainer():
    algo = SAC(tcont.GaussianActor(3, (16,), 1, conditioned_sigma=True), tcont.CriticEnsemble(3, 1, (16,)),
               HostVectorEnv([_pendulum]).action_space, device="cpu")
    buffer = ReplayBuffer(32, 2)
    col = HostCollector(algo, HostVectorEnv([_pendulum] * 2), buffer, device="cpu")
    trainer = OffPolicyTrainer(algo, col, HostCollector(algo, HostVectorEnv([_pendulum]), device="cpu"), buffer,
                               max_epoch=1, step_per_epoch=2, step_per_collect=2, update_per_step=1.0,
                               batch_size=4, warmup_steps=8, fused_fine_host=True, device="cpu")
    return trainer


def test_fused_cycle_static_step_matches_eager(static_steps):
    trainer = _fused_trainer()
    loop, _ = trainer._host_setup()
    assert isinstance(loop, FusedHostLoop)
    loop.prime(0.1)
    # the eager cycle: a copy of the state, its own staging, the plain step
    memo = {id(loop.generator): _copy_gen(loop.generator)}
    e_ts, e_bstate = copy.deepcopy((loop.ts, loop.bstate), memo)
    e_gen, e_act = memo[id(loop.generator)], loop._raw_act.clone()
    packer, flat_ptr = None, None
    for i in range(3):
        _, host = loop.step_envs()
        copies = TreePacker.copies
        loop.device(loop.upload(host), 0.1)
        assert TreePacker.copies == copies + 1
        if packer is None:
            packer = TreePacker(host, CPU)
            e_staging = (packer.to_device(host), e_act, torch.empty_like(loop.staging[2]))
            flat_ptr = loop.staging[0].data_ptr()
        else:
            packer.to_device(host, out=e_staging[0])
        assert loop.staging[0].data_ptr() == flat_ptr
        e_ts, e_staging, e_bstate, _, e_metrics = loop.device_fn(e_ts, e_staging, e_bstate, e_gen, 0.1)
        loop.env_act = loop.env_act_device.cpu().numpy()
        _assert_bitwise(named_tensors((e_ts, e_staging[1:], e_bstate)) + [("gen", e_gen.get_state())],
                        named_tensors((loop.ts, loop.staging[1:], loop.bstate)) + [("gen", loop.generator.get_state())])
        assert {k: float(v) for k, v in e_metrics.items()} == {k: float(v) for k, v in loop.metrics.items()}
    assert isinstance(loop.compiled, StaticStep) and loop.compiled.cstate is loop.staging
    trainer.train_collector.venv.close()
    trainer.test_collector.venv.close()


def _eager_test_phase(col, ts, gen, n_episode, chunk=128):
    """The test phase before the static collect state: a fresh reset and
    a forked stream each phase, eager chunks."""
    n = col.venv.num_envs
    quota = np.full(n, n_episode // n, np.int64)
    quota[: n_episode % n] += 1
    cstate = col.reset(gen)
    seg = rollout_segment(col.algo, col.venv, None, chunk, False)
    rets, lens, counts = [[] for _ in range(n)], [[] for _ in range(n)], np.zeros(n, np.int64)
    while not np.all(counts >= quota):
        cstate, _, out = seg(ts, cstate, None, 0.0)
        for t, i in zip(*np.nonzero(out["done"].numpy())):
            if counts[i] < quota[i]:
                rets[i].append(float(out["ep_ret"][t, i]))
                lens[i].append(int(out["ep_len"][t, i]))
            counts[i] += 1
    return np.asarray([r for x in rets for r in x]), np.asarray([v for x in lens for v in x], np.int64), cstate


def test_collect_episodes_static_state_matches_eager(static_steps):
    from tianshou_tpu_torch.envs.classic import CartPole

    algo = DQN(QNet(4, (16,), 2), Discrete(2), device="cpu")
    col = Collector(algo, VectorEnv(CartPole(), 3, device="cpu"), device="cpu")
    gen = _gen(5)
    ts = algo.init(fork_generator(gen))
    ref_gen = _copy_gen(gen)
    for phase in range(2):
        stats = col.collect_episodes(ts, gen, 5, chunk_size=16)
        rets, lens, ref_state = _eager_test_phase(col, ts, ref_gen, 5, chunk=16)
        np.testing.assert_array_equal(stats.returns, rets)
        np.testing.assert_array_equal(stats.lens, lens)
        assert torch.equal(gen.get_state(), ref_gen.get_state())
        static = col._episode_state
        assert torch.equal(static.rng.get_state(), ref_state.rng.get_state())
        _assert_bitwise(named_tensors((ref_state.obs, ref_state.ep_len)), named_tensors((static.obs, static.ep_len)))
        if phase == 0:
            first = col._compiled["episodes"]
    # the second phase reset the static state in place and replayed the same step
    assert col._compiled["episodes"] is first and first.cstate is col._episode_state


def test_collect_episodes_greedy_cartpole_matches_jax(static_steps):
    jalgo, jts, talgo, tts = _dqn_pair()
    jcol = JaxCollector(jalgo, JaxVectorEnv(_JaxCart(), 3))
    tcol = Collector(talgo, VectorEnv(_Cart(), 3, device="cpu"), device="cpu")
    for _ in range(2):
        jstats = jcol.collect_episodes(jts, jax.random.key(0), 4, chunk_size=32)
        tstats = tcol.collect_episodes(tts, _gen(0), 4, chunk_size=32)
        assert tstats.n_collected_episodes == jstats.n_collected_episodes == 4
        np.testing.assert_array_equal(tstats.returns, np.asarray(jstats.returns))
        np.testing.assert_array_equal(tstats.lens, np.asarray(jstats.lens))
    assert len(set(tstats.lens.tolist())) >= 1 and tcol._compiled["episodes"].ts is tts


def test_collect_returns_the_callers_own_trajectory(static_steps):
    from tianshou_tpu_torch.envs.classic import CartPole

    algo = DQN(QNet(4, (16,), 2), Discrete(2), device="cpu")
    col = Collector(algo, VectorEnv(CartPole(), 2, device="cpu"), device="cpu")
    gen = _gen(0)
    cstate = col.reset(fork_generator(gen))
    ts = algo.init(fork_generator(gen))
    ref_cstate = copy.deepcopy(cstate, {id(cstate.rng): _copy_gen(cstate.rng)})
    seg = rollout_segment(algo, col.venv, None, 6, True, record_traj=True)
    trajs = []
    for _ in range(2):
        cstate, _, _, traj = col.collect(ts, cstate, None, 6, explore=True, explore_param=0.5, record_traj=True)
        ref_cstate, _, out = seg(ts, ref_cstate, None, 0.5)
        _assert_bitwise(_named(out["traj"]), _named(traj))
        trajs.append(traj)
    step = col._compiled["collect"]
    assert step.cstate is cstate and isinstance(step, StaticStep)
    assert not {t.untyped_storage().data_ptr() for t in tree_leaves(trajs[0])} & {
        t.untyped_storage().data_ptr() for t in tree_leaves(trajs[1])}


def test_another_train_state_captures_again(static_steps):
    # the host acting step: another acting module drops the compiled steps
    algo, ts, make, _ = _acting_case("sac")
    col = HostCollector(algo, HostVectorEnv([make] * 2), device="cpu")
    col.reset(seed=0)
    gen = _gen(0)
    for _ in range(2):
        col.collect(ts, None, 3, gen, record_traj=True)
    assert len(static_steps) == 1  # the same module, generator and length: the step of the first call
    other = algo.init(_gen(9))
    col.collect(other, None, 3, gen, record_traj=True)
    assert len(static_steps) == 2 and static_steps[1].ts is algo.act_params(other)
    assert len(col._acting_steps[CPU]._steps) == 1  # the first module's steps were dropped
    # the pipelined loop's fresh shallow copy over one snapshot module replays
    snapshot = copy.deepcopy(algo.act_params(other))
    for _ in range(2):
        col.collect(algo.with_act_params(other, snapshot), None, 3, gen)
    assert len(static_steps) == 3
    col.venv.close()

    # the device collector's test chunk
    from tianshou_tpu_torch.envs.classic import CartPole

    dqn = DQN(QNet(4, (16,), 2), Discrete(2), device="cpu")
    dcol = Collector(dqn, VectorEnv(CartPole(), 2, device="cpu"), device="cpu")
    ts1, ts2 = dqn.init(_gen(1)), dqn.init(_gen(2))
    dcol.collect_episodes(ts1, _gen(3), 2)
    first = dcol._compiled["episodes"]
    dcol.collect_episodes(ts1, _gen(3), 2)
    assert dcol._compiled["episodes"] is first
    dcol.collect_episodes(ts2, _gen(3), 2)
    assert dcol._compiled["episodes"] is not first and dcol._compiled["episodes"].ts is ts2


def test_finite_eval_collector_keeps_its_acting_step(static_steps):
    """Each pass of the dataset acts through the collector's one compiled
    acting step, and gives what acting step by step gives."""
    from tianshou_tpu_torch.envs.finite import FiniteEvalCollector

    algo = DQN(QNet(2, (8,), 2), Discrete(2), device="cpu")
    ts = algo.init(_gen(0))
    venv, _, _ = _make_sharded()
    col = FiniteEvalCollector(algo, venv)
    ref_venv, _, _ = _make_sharded()
    gen = _gen(1)  # a trainer's, the same every test phase
    for _ in range(2):
        stats = col.collect_episodes(ts, gen)
        obs, ret, rets = ref_venv.reset(), np.zeros(4), []
        while not ref_venv.exhausted:
            act = algo.act(ts, torch.as_tensor(obs), _gen(1), False)
            res, obs, alive = ref_venv.step_masked(act.numpy())
            ret[alive] += res.reward[alive]
            for i in np.nonzero((res.terminated | res.truncated) & alive)[0]:
                rets.append(ret[i])
                ret[i] = 0
        np.testing.assert_array_equal(stats.returns, rets)
    assert len(static_steps) == 1 and len(col.acting._steps) == 1


# -- on a card only -------------------------------------------------------------------------
@pytest.mark.cuda
def test_acting_replays_equal_eager_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a CUDA device (chip_smoke.py's collect-graph phase runs this check on the card)")
    algo = SAC(tcont.GaussianActor(3, (16,), 1, conditioned_sigma=True), tcont.CriticEnsemble(3, 1, (16,)),
               HostVectorEnv([_pendulum]).action_space, device="cuda")
    ts = algo.init(make_generator(0, "cuda"))
    obs = [np.random.default_rng(i).normal(size=(4, 3)) for i in range(5)]
    out = {}
    for name in ("eager", "graph"):
        gen = make_generator(1, "cuda")
        with monkeypatch.context() as m:
            if name == "eager":  # the step itself, run op by op
                m.setattr(host_collector_module, "compile_step", lambda fn, *args, **kwargs: fn)
            acting = ActingStep(algo, torch.device("cuda")).begin(ts, obs[0], gen, True, 0.0, num_steps=len(obs))
        acts = [acting(o) for o in obs]
        out[name] = (acts, acting.segment()[0].cpu(), gen.get_state())
    for a, b in zip(out["eager"][0], out["graph"][0]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(out["eager"][1], out["graph"][1]) and torch.equal(out["eager"][2], out["graph"][2])
