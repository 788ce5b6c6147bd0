"""The compiled superstep (tianshou_tpu_torch/utils/graphs.py,
OffPolicyTrainer._compile_superstep) and what it asked of the algorithms,
on the CPU:

- DQN's target copy decided on the device (``sync_target``) against the
  JAX DQN's ``jnp.where`` over ``2 x freq + 3`` updates from the same
  parameters and batches, the parity tests' limits (rtol 1e-4 / atol
  1e-5), and bitwise: the target is the online network's copy on a sync
  step and its own elsewhere;
- TD3's and REDQ's host-keyed branch patterns (``update_pattern``) against
  the JAX updates' ``lax.cond`` over windows of two updates that cross
  pattern boundaries;
- the static-state protocol (``StaticStep``) with the eager superstep over
  two supersteps of several paths at a small size: every carried tensor
  keeps its storage, the ring is never copied, and the results equal the
  plain eager superstep's bitwise; the ``explore_param`` tensor's value
  changes the acting without a rebuild;
- the optimizer checks: ``check_capturable`` on the groups; the port's
  Adam made capturable by ``prepare_optimizer`` (its step counts moved,
  in float64 for float64 parameters) and only the port's; the state that
  ``init_optimizer_state`` creates stepping as a lazily created one does;
- on a card only (skipped here): the warm-up call and two replays against
  three eager supersteps of ``cartpole`` at a small size, bitwise.
"""

import copy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tianshou_tpu_torch.utils.graphs import (CapturedStep, StaticStep, check_capturable, init_optimizer_state,
                                             mark_capturable, named_tensors, optimizers, prepare_optimizer)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

from test_torch_continuous import _algo_pair, _assert_state_close, _jax_noise  # noqa: E402
from test_torch_continuous import _sampled_pair as _cont_sampled  # noqa: E402
from test_torch_dqn import assert_params_close, make_mlp_pair, mlp_sampled_pair  # noqa: E402
from test_torch_examples_flags import _one_torch_thread  # noqa: E402, F401


# -- DQN's target copy on the device -------------------------------------------
@pytest.mark.parametrize("freq", [3, 4])
def test_device_target_sync_matches_jax(freq):
    from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer

    jalgo, jts, talgo, tts = make_mlp_pair()
    jalgo.target_update_freq = talgo.target_update_freq = freq
    assert tts.device_step is not None and int(tts.device_step) == 0
    jbuf = JaxReplayBuffer(8, 2)
    update = jax.jit(lambda ts, s: jalgo.update_sampled(ts, jbuf, None, s, jax.random.key(0)))
    syncs = 0
    for step in range(1, 2 * freq + 4):
        js, ts_ = mlp_sampled_pair(30 + step, masked=False)
        target_before = {k: v.clone() for k, v in tts.target.state_dict().items()}
        jts, _, _ = update(jts, js)
        tts, _, _ = talgo.update_sampled(tts, None, None, ts_)
        assert tts.step == int(tts.device_step) == int(jts.step) == step
        assert_params_close(tts.online, jts.params)
        assert_params_close(tts.target, jts.target_params)
        online, target = tts.online.state_dict(), tts.target.state_dict()
        want = online if step % freq == 0 else target_before
        assert all(torch.equal(target[k], want[k]) for k in target), step
        syncs += step % freq == 0
    assert syncs == (2 * freq + 3) // freq >= 2


# -- TD3's and REDQ's host-keyed branch patterns --------------------------------
def test_td3_update_pattern_matches_jax_cond():
    """Three windows of two updates at update_actor_freq 3: the patterns
    (F, F), (T, F), (F, T), each the JAX update's ``lax.cond`` outcomes
    (whether its actor moved), and every state within the parity limits."""
    from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer

    jalgo, jts, talgo, tts = _algo_pair("td3", update_actor_freq=3)
    jbuf = JaxReplayBuffer(8, 2)
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, jbuf, None, s, k))
    patterns = []
    for window in range(3):
        pattern = talgo.update_pattern(tts, 2)
        patterns.append(pattern)
        for i in range(2):
            js, ts_ = _cont_sampled(40 + 2 * window + i)
            key = jax.random.key(200 + 2 * window + i)
            actor_before = jax.device_get(jts.actor_params)
            jts, _, _ = update(jts, js, key)
            moved = any(not np.array_equal(a, b) for a, b in zip(
                jax.tree.leaves(actor_before), jax.tree.leaves(jax.device_get(jts.actor_params))))
            assert moved == pattern[i], (window, i)
            tts, _, _ = talgo.update_sampled(tts, None, None, ts_, noise=_jax_noise("td3", key))
            _assert_state_close("td3", jts, tts)
    assert patterns == [(False, False), (True, False), (False, True)]


def test_redq_update_pattern_matches_jax_cond(monkeypatch):
    """Three windows of two updates at actor_delay 3, against the JAX
    REDQ: its actor step (its second normal draw) happens exactly where the
    pattern says, with the same parameters."""
    import tianshou_tpu.networks.continuous as jcont
    from tianshou_tpu.algos.redq import REDQ as JaxREDQ
    from tianshou_tpu.envs.spaces import Box as JaxBox
    from test_torch_ensembles import (GAUSS_HEADS, HID, OBS, _ac_pairs, _assert_modules, _load_ac, _recording,
                                      _RecordingBuffer, _sampled_pair, _t)
    from tianshou_tpu_torch.algos.redq import REDQ
    from tianshou_tpu_torch.envs.spaces import Box
    from tianshou_tpu_torch.networks import continuous as tcont

    n, m = 4, 2
    common = dict(actor_lr=1e-3, critic_lr=1e-3, alpha_lr=3e-2, gamma=0.9, tau=0.05, n_step=2,
                  ensemble_size=n, subset_size=m, actor_delay=3, auto_alpha=True)
    jalgo = JaxREDQ(jcont.GaussianActor(HID, 2, conditioned_sigma=True), jcont.CriticEnsemble(HID, n),
                    JaxBox(low=-1.0, high=1.0, shape=(2,)), **common)
    talgo = REDQ(tcont.GaussianActor(OBS, HID, 2, conditioned_sigma=True), tcont.CriticEnsemble(OBS, 2, HID, n),
                 Box(low=-1.0, high=1.0, shape=(2,)), device="cpu", **common)
    jts = jalgo.init(jax.random.key(0), jax.numpy.zeros((OBS,), jax.numpy.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    _load_ac(jts, tts, GAUSS_HEADS)
    normals, perms = [], []
    monkeypatch.setattr(jax.random, "normal", _recording(jax.random.normal, normals))
    monkeypatch.setattr(jax.random, "permutation", _recording(jax.random.permutation, perms))
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, _RecordingBuffer, None, s, k))
    patterns = []
    for window in range(3):
        pattern = talgo.update_pattern(tts, 2)
        patterns.append(pattern)
        for i in range(2):
            js, ts_ = _sampled_pair(50 + 2 * window + i, "box")
            del normals[:], perms[:]
            jts, _, _ = update(jts, js, jax.random.key(300 + 2 * window + i))
            jax.effects_barrier()
            assert (len(normals) == 2) == pattern[i], (window, i)
            eps_actor = _t(normals[1]) if pattern[i] else torch.zeros(16, 2)
            tts, _, _ = talgo.update_sampled(tts, _RecordingBuffer, None, ts_, noise=(_t(normals[0]), eps_actor),
                                             subset=_t(perms[0][:m]))
            assert tts.step == int(jts.step)
            _assert_modules(_ac_pairs(jts, tts, GAUSS_HEADS), f"redq window {window} update {i}")
    assert patterns == [(False, False), (True, False), (False, True)]


# -- the static-state protocol on the CPU ---------------------------------------
SMALL = {
    "cartpole": dict(num_envs=4, segment=5, batch=8, updates=2, capacity=64),
    "rainbow_per": dict(num_envs=4, segment=5, batch=8, updates=2, capacity=64, warmup=40),
    "drqn_cartpole": dict(num_envs=4, segment=5, batch=8, updates=2, capacity=64, warmup=40, hidden=16),
    "marl_tictactoe": dict(num_envs=4, segment=5, batch=8, updates=2, capacity=64, warmup=40, hidden=(16,)),
    "td3_pendulum": dict(num_envs=4, segment=5, batch=8, updates=2, capacity=64, warmup=40, hidden=(32, 32)),
}


def _small_path(path):
    _, algo, col, buffer, trainer = chip_smoke.build_path(path, "cpu", **SMALL[path])
    gen, ts, cstate, bstate = chip_smoke.init_states(algo, col, buffer)
    return algo, trainer, [ts, cstate, bstate, gen]


def _clone(state):
    return chip_smoke._clone_run_state(*state[:3], state[3])


@pytest.mark.parametrize("path", list(SMALL))
def test_static_state_protocol_keeps_every_carried_tensor(path):
    algo, trainer, state = _small_path(path)
    plain = _clone(state)
    eager = trainer._build_superstep()
    compiled = trainer._compile_superstep(*state[:3])
    assert not isinstance(compiled, CapturedStep)  # a CPU trainer runs the eager superstep
    with pytest.raises(ValueError, match="CUDA"):
        CapturedStep(eager, *state[:3])
    static = StaticStep(eager, *state[:3])
    for opt in optimizers(state[0]):  # as a capture does: the state exists before the first step
        init_optimizer_state(opt)
    carried = [(n, t.untyped_storage().data_ptr()) for n, t in named_tensors(tuple(state[:3]))]
    ring_bytes = sum(t.numel() * t.element_size() for _, t in named_tensors(state[2].storage))
    for _ in range(2):
        out = static(*state[:3], state[3], 0.1)
        assert out[0] is state[0] and out[1] is state[1] and out[2] is state[2]
        plain[0], plain[1], plain[2], p_out, p_met = eager(*plain[:3], plain[3], 0.1)
        assert not chip_smoke._differing(chip_smoke._run_leaves(state, out[3], out[4]),
                                         chip_smoke._run_leaves(plain, p_out, p_met))
        assert 0 < static.copy_back_bytes < ring_bytes
    assert [(n, t.untyped_storage().data_ptr()) for n, t in named_tensors(tuple(state[:3]))] == carried


def test_explore_tensor_changes_the_acting_without_a_rebuild():
    algo, trainer, state = _small_path("cartpole")
    other = _clone(state)
    explore = torch.zeros(())
    steps = [StaticStep(trainer._build_superstep(), *s[:3]) for s in (state, other)]
    for s, step in zip((state, other), steps):
        step(*s[:3], s[3], explore)
    assert not chip_smoke._differing(chip_smoke._run_leaves(state), chip_smoke._run_leaves(other))
    steps[0](*state[:3], state[3], explore)
    explore.fill_(1.0)
    steps[1](*other[:3], other[3], explore)
    acts = [s[2].storage["act"][:, 5:10] for s in (state, other)]
    assert not torch.equal(*acts)
    obs = state[1].obs
    greedy = state[0].online(obs).argmax(-1)
    g = torch.Generator().manual_seed(0)
    explore.fill_(0.0)
    assert torch.equal(algo.act(state[0], obs, g, True, explore), greedy)


def test_collector_reset_gives_the_return_carry_the_reward_shape():
    _, _, state = _small_path("marl_tictactoe")
    assert state[1].ep_ret.shape == (4, 2)
    _, _, state = _small_path("cartpole")
    assert state[1].ep_ret.shape == (4,)


# -- the optimizer checks --------------------------------------------------------
def test_check_capturable_names_what_to_pass():
    from tianshou_tpu_torch.algos.ddpg import adam
    from tianshou_tpu_torch.algos.qrdqn import RMSprop

    params = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="capturable=True"):
        check_capturable(torch.optim.Adam(params, lr=1e-3))
    with pytest.raises(ValueError, match=r"group\(s\) \[1\]"):
        check_capturable(torch.optim.Adam([{"params": params, "capturable": True},
                                           {"params": [torch.nn.Parameter(torch.zeros(2))]}], lr=1e-3))
    check_capturable(torch.optim.Adam(params, lr=1e-3, capturable=True))
    check_capturable(RMSprop(params, 1e-3))
    assert not adam(params, 1e-3).param_groups[0]["capturable"]  # until a capture prepares it


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prepare_optimizer_makes_only_the_ports_adam_capturable(dtype):
    from tianshou_tpu_torch.algos.ddpg import adam

    w = torch.nn.Parameter(torch.ones(3, dtype=dtype))
    opt = adam([w], 1e-2)
    w.grad = torch.full_like(w, 0.5)
    opt.step()  # an eager step first: its count is a host float32 tensor
    assert opt.state[w]["step"].dtype == torch.float32
    prepare_optimizer(opt)
    assert opt.param_groups[0]["capturable"]
    assert opt.state[w]["step"].dtype == dtype and float(opt.state[w]["step"]) == 1.0
    fresh = adam([torch.nn.Parameter(torch.ones(2, dtype=dtype))], 1e-2)
    prepare_optimizer(fresh)  # no step yet: the state is created, the count on the parameter's device
    assert all(st["step"].dtype == dtype and not st["exp_avg"].any() for st in fresh.state.values())
    with pytest.raises(ValueError, match="capturable=True"):
        prepare_optimizer(torch.optim.Adam([w], lr=1e-2))  # a caller's optimizer is used as built
    with pytest.raises(TypeError, match="SGD"):
        mark_capturable(torch.optim.SGD([w], lr=0.1))


def test_the_capture_mark_survives_a_copy():
    """A copy of the port's Adam made before any capture (a cloned or
    restored train state) is still made capturable by the capture."""
    import pickle

    from tianshou_tpu_torch.algos.ddpg import adam

    opt = adam([torch.nn.Parameter(torch.ones(3))], 1e-2)
    for copied in (copy.deepcopy(opt), pickle.loads(pickle.dumps(opt))):
        assert not copied.param_groups[0]["capturable"]
        prepare_optimizer(copied)
        assert copied.param_groups[0]["capturable"]


@pytest.mark.parametrize("kind", ["adam", "adamw-amsgrad", "rmsprop"])
def test_created_optimizer_state_steps_as_a_lazy_one(kind):
    from tianshou_tpu_torch.algos.qrdqn import RMSprop

    make = {"adam": lambda p: torch.optim.Adam(p, lr=1e-2),
            "adamw-amsgrad": lambda p: torch.optim.AdamW(p, lr=1e-2, amsgrad=True),
            "rmsprop": lambda p: RMSprop(p, 1e-2)}[kind]
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)) for _ in range(3)]
    results = []
    for early in (False, True):
        w = torch.nn.Parameter(w0.clone())
        opt = make([w])
        if early:
            init_optimizer_state(opt)
            assert opt.state[w] and all(not t.any() for t in opt.state[w].values())
        for g in grads:
            w.grad = g.clone()
            opt.step()
        results.append((w.detach().clone(), copy.deepcopy(opt.state_dict()["state"])))
    assert torch.equal(results[0][0], results[1][0])


def test_init_optimizer_state_refuses_what_it_cannot_create():
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(3))], lr=0.1, momentum=0.9)
    with pytest.raises(ValueError, match="SGD"):
        init_optimizer_state(opt)


# -- on a card only ----------------------------------------------------------------
@pytest.mark.cuda
def test_replays_equal_the_eager_superstep_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs need a CUDA device (chip_smoke.py's graph phase runs this check on the card)")
    _, algo, col, buffer, trainer = chip_smoke.build_path("cartpole", "cuda", **SMALL["cartpole"])
    gen, ts, cstate, bstate = chip_smoke.init_states(algo, col, buffer)
    eager_state, graph_state = [ts, cstate, bstate, gen], chip_smoke._clone_run_state(ts, cstate, bstate, gen)
    eager, compiled = trainer._build_superstep(), trainer._compile_superstep(*graph_state[:3])
    assert isinstance(compiled, CapturedStep)
    for opt in optimizers(eager_state[0]):  # as the capture prepares the graph's
        prepare_optimizer(opt)
    explore = torch.full((), 0.1, device="cuda")
    for _ in range(3):  # the warm-up, then two replays
        eager_state[0], eager_state[1], eager_state[2], e_out, e_met = eager(*eager_state[:3], eager_state[3],
                                                                              explore)
        graph_state[0], graph_state[1], graph_state[2], g_out, g_met = compiled(*graph_state[:3], graph_state[3],
                                                                                explore)
        assert not chip_smoke._differing(chip_smoke._run_leaves(eager_state, e_out, e_met),
                                         chip_smoke._run_leaves(graph_state, g_out, g_met))
    assert sum(g.replays for g in compiled.graphs.values()) == 2
