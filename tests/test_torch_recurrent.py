"""Recurrent policies in the port (tianshou_tpu_torch: networks/common
RecurrentQNet, algos/drqn DRQN, the recurrent hooks of algos/base and
``CollectState.policy_state``) against the JAX package, on the CPU in
float32 at a small size.

- RecurrentQNet forwards at L = 1 (a 2-D observation) and L = 4, with a
  carry passed in and the carry returned, in Flax's ``(c, h)`` order, atol
  1e-5; the JAX package's ``test_recurrent_qnet_carry``
  (tests/test_networks.py) on the port's net.
- Two DRQN updates from the same parameters and the same ring: the
  ``(env_idx, pos, weight)`` that the JAX update draws are recorded (an
  ordered ``jax.debug.callback``) and injected; loss, priorities and every
  parameter within rtol 1e-4 / atol 1e-5; the trainer takes DRQN's own
  ``update`` (the per-update branch).
- A greedy recurrent CartPole segment through the Collector against the JAX
  collector, with the env phases injected (fixed resets): the same actions
  at every step, the carries within atol 1e-5, and each env's carry
  reset to zeros at its episode's end.
- The base hooks: a feedforward policy's state is ``()`` and threading it
  launches nothing and changes no result; ``compute_action`` against the
  JAX package's, for a discrete and a continuous policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.dqn import DQN as JaxDQN
from tianshou_tpu.algos.drqn import DRQN as JaxDRQN
from tianshou_tpu.algos.sac import SAC as JaxSAC
from tianshou_tpu.collect.collector import Collector as JaxCollector
from tianshou_tpu.collect.collector import rollout_segment as jax_rollout_segment
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
from tianshou_tpu.envs.classic import CartPole as JaxCartPole
from tianshou_tpu.envs.classic import CartPoleState as JaxCartPoleState
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.networks import common as jc
from tianshou_tpu.networks import continuous as jcont
from tianshou_tpu_torch.algos.base import Algorithm
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.algos.drqn import DRQN
from tianshou_tpu_torch.algos.sac import SAC
from tianshou_tpu_torch.collect.collector import Collector, rollout_segment
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole, CartPoleState
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.networks import common as tc
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks.convert import params_from_flax
from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

OBS, HIDDEN, A = 4, 16, 2
N_ENVS, CAP, B, STACK = 3, 16, 12, 4


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _carry_pair(batch, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(batch, HIDDEN)).astype(np.float32) * 0.5 for _ in range(2))


# -- RecurrentQNet ------------------------------------------------------------
@pytest.mark.parametrize("length", [1, 4])
def test_recurrent_qnet_matches_flax(length):
    rng = np.random.default_rng(length)
    obs = (rng.normal(size=(5, length, OBS)) * 2).astype(np.float32)
    if length == 1:
        obs = obs[:, 0]  # a 2-D observation is a history of one step
    carry = _carry_pair(5, length + 10)
    jnet, tnet = jc.RecurrentQNet(HIDDEN, A), tc.RecurrentQNet(OBS, HIDDEN, A)
    params = jnet.init(jax.random.key(0), jnp.asarray(obs), tuple(map(jnp.asarray, carry)))
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    jq, (jc_, jh) = jnet.apply(params, jnp.asarray(obs), tuple(map(jnp.asarray, carry)))
    with torch.no_grad():
        tq, (tc_, th) = tnet(torch.from_numpy(obs), tuple(map(torch.from_numpy, carry)))
    _close(tq, jq, msg="q")
    _close(tc_, jc_, msg="c")
    _close(th, jh, msg="h")


def test_recurrent_qnet_carry():
    """tests/test_networks.py ``test_recurrent_qnet_carry``."""
    net = tc.RecurrentQNet(4, hidden_size=8, num_actions=2)
    obs = torch.ones(5, 4)
    carry = net.init_carry(5)
    with torch.no_grad():
        q1, carry1 = net(obs, carry)
        assert q1.shape == (5, 2)
        assert carry1[0].shape == (5, 8)
        # state matters: same obs with evolved carry gives different output
        q2, _ = net(obs, carry1)
    assert not np.allclose(q1.numpy(), q2.numpy())


# -- DRQN updates ---------------------------------------------------------------
def _ring_steps(seed, steps=22):
    """Transitions of ``N_ENVS`` envs, with episode ends, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        out.append(dict(obs=(rng.normal(size=(N_ENVS, OBS)) * 2).astype(np.float32),
                        act=rng.integers(0, A, N_ENVS).astype(np.int32), rew=rng.normal(size=N_ENVS).astype(np.float32),
                        terminated=rng.random(N_ENVS) < 0.15, truncated=rng.random(N_ENVS) < 0.05,
                        obs_next=(rng.normal(size=(N_ENVS, OBS)) * 2).astype(np.float32)))
    return out


def _filled(steps):
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS)
    jbs = jbuf.init(JaxBatch({k: jnp.asarray(v[0]) for k, v in steps[0].items()}))
    tbs = tbuf.init(Batch({k: _t(v[0]).to(torch.int64) if k == "act" else _t(v[0]) for k, v in steps[0].items()}),
                    device="cpu")
    for tr in steps:  # the ring wraps
        jbs = jbuf.add(jbs, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
        tbs = tbuf.add(tbs, Batch({k: _t(v).to(torch.int64) if k == "act" else _t(v) for k, v in tr.items()}))
    return jbuf, jbs, tbuf, tbs


def _drqn_pair(**kw):
    jalgo = JaxDRQN(jc.RecurrentQNet(HIDDEN, A), JaxDiscrete(A), stack_num=STACK, **kw)
    talgo = DRQN(tc.RecurrentQNet(OBS, HIDDEN, A), Discrete(A), stack_num=STACK, device="cpu", **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    return jalgo, jts, talgo, tts


@pytest.mark.parametrize("is_double", [True, False])
def test_drqn_two_updates_match_jax(is_double):
    jalgo, jts, talgo, tts = _drqn_pair(lr=1e-3, gamma=0.9, target_update_freq=2, is_double=is_double)
    jbuf, jbs, tbuf, tbs = _filled(_ring_steps(0))
    draws = []
    sample = jbuf.sample_with_weights

    def recorded(state, key, batch_size):
        out = sample(state, key, batch_size)
        jax.debug.callback(lambda *v: draws.append([np.asarray(x) for x in v]), *out, ordered=True)
        return out

    jbuf.sample_with_weights = recorded
    # both buffers hand the written-back |td| back as the new buffer state
    jbuf.update_priorities = lambda state, env_idx, pos, td_abs: td_abs
    tbuf.update_priorities = lambda state, env_idx, pos, td_abs: td_abs
    update = jax.jit(lambda ts, bs, k: jalgo.update(ts, jbuf, bs, k, B))
    for step in (1, 2):
        jts, jtd, jm = update(jts, jbs, jax.random.key(step))
        jax.effects_barrier()
        env_idx, pos, weight = (_t(x) for x in draws[-1])
        assert len(draws) == step and len(set(zip(env_idx.tolist(), pos.tolist()))) > B // 2
        tbuf.sample_with_weights = lambda st, g, b, d=(env_idx.long(), pos.long(), weight): d
        tts, ttd, tm = talgo.update(tts, tbuf, tbs, None, B)
        assert set(tm) == set(jm) == {"loss"}
        _close(tm["loss"], jm["loss"], rtol=1e-4, atol=1e-5, msg=f"step {step} loss")
        _close(ttd, jtd, rtol=1e-4, atol=1e-5, msg=f"step {step} priorities")
        for mod, flax_params in ((tts.online, jts.params), (tts.target, jts.target_params)):
            ref = params_from_flax(jax.device_get(flax_params))
            for name, val in mod.state_dict().items():
                _close(val, ref[name], rtol=1e-4, atol=1e-5, msg=f"step {step} {name}")
        assert tts.step == int(jts.step) == step


def test_drqn_takes_the_per_update_branch():
    """DRQN overrides ``update``: the trainer's update loop calls it once
    per update, never the presample path."""
    _, _, talgo, tts = _drqn_pair(lr=1e-3, target_update_freq=4)
    _, _, tbuf, tbs = _filled(_ring_steps(1))
    calls = []
    talgo.presample = lambda *a, **k: pytest.fail("DRQN must not be presampled")
    update = talgo.update
    talgo.update = lambda *a, **k: calls.append(1) or update(*a, **k)
    tts, _, metrics = build_update_scan(talgo, tbuf, B, 3)(tts, tbs, torch.Generator().manual_seed(0))
    assert len(calls) == 3 and tts.step == 3 and torch.isfinite(metrics["loss"])


# -- the recurrent collector segment ---------------------------------------------
CART0 = np.array([0.03, -0.02, 0.04, 0.01], np.float32)


class _JaxCart(JaxCartPole):
    def reset(self, key):
        s = JaxCartPoleState(*map(jnp.asarray, CART0), jnp.zeros((), jnp.int32))
        return s, self._obs(s)


class _Cart(CartPole):
    def reset(self, generator, num_envs, device):
        v = torch.from_numpy(CART0).to(device).repeat(num_envs, 1)
        s = CartPoleState(*v.unbind(1), torch.zeros(num_envs, dtype=torch.int32, device=device))
        return s, self._obs(s)


def test_recurrent_segment_matches_jax_and_resets_carries():
    steps = 30
    jalgo, jts, talgo, tts = _drqn_pair(gamma=0.9, target_update_freq=0)
    jenv, tenv = _JaxCart(), _Cart()
    jvenv, tvenv = JaxVectorEnv(jenv, N_ENVS), VectorEnv(tenv, N_ENVS, device="cpu")
    jcol, tcol = JaxCollector(jalgo, jvenv), Collector(talgo, tvenv, device="cpu")
    jcs, tcs = jcol.reset(jax.random.key(0)), tcol.reset(torch.Generator().manual_seed(0))
    start = np.random.default_rng(5).uniform(-0.05, 0.05, (4, N_ENVS)).astype(np.float32)
    t0 = np.array([0, 3, 6], np.int32)
    jstart = JaxCartPoleState(*map(jnp.asarray, start), jnp.asarray(t0))
    tstart = CartPoleState(*map(torch.from_numpy, start), torch.from_numpy(t0))
    jcs = jcs.replace(env_state=jstart, obs=jax.vmap(jenv._obs)(jstart))
    tcs.env_state, tcs.obs = tstart, tenv._obs(tstart)
    # a non-zero carry to start from, so that a reset shows
    carry = _carry_pair(N_ENVS, 3)
    jcs = jcs.replace(policy_state=tuple(map(jnp.asarray, carry)))
    tcs.policy_state = tuple(map(torch.from_numpy, carry))

    jstep = jax.jit(jax_rollout_segment(jalgo, jvenv, None, 1, explore=False, record_traj=True))
    tstep = rollout_segment(talgo, tvenv, None, 1, explore=False, record_traj=True)
    resets = 0
    for t in range(steps):
        jcs, _, jout = jstep(jts, jcs, None, 0.0)
        tcs, _, tout = tstep(tts, tcs, None, 0.0)
        np.testing.assert_array_equal(tout["traj"]["act"].numpy(), np.asarray(jout["traj"]["act"]), err_msg=f"t={t}")
        np.testing.assert_array_equal(tout["done"].numpy(), np.asarray(jout["done"]))
        for name, got, ref in zip("ch", tcs.policy_state, jcs.policy_state):
            _close(got, ref, rtol=0, atol=1e-5, msg=f"t={t} {name}")
        done = tout["done"][0]
        for part in tcs.policy_state:
            assert bool((part[done] == 0).all()) and bool((part[~done] != 0).any(dim=-1).all())
        resets += int(done.sum())
    assert resets >= 2  # the carries crossed episode ends

    # the same steps as one segment of the port's collector
    tcs2 = tcol.reset(torch.Generator().manual_seed(0))
    tcs2.env_state, tcs2.obs, tcs2.policy_state = tstart, tenv._obs(tstart), tuple(map(torch.from_numpy, carry))
    tcs2, _, tout2 = rollout_segment(talgo, tvenv, None, steps, explore=False, record_traj=True)(tts, tcs2, None, 0.0)
    for got, ref in zip(tcs2.policy_state, tcs.policy_state):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


# -- the base hooks ----------------------------------------------------------------
def test_feedforward_policy_state_is_empty_and_costs_nothing():
    algo = DQN(tc.QNet(OBS, (8,), A), Discrete(A), device="cpu")
    assert algo.init_policy_state(5) == ()
    ts = algo.init(torch.Generator().manual_seed(0))
    obs = torch.randn(5, OBS)
    act, extras, state = algo.act_with_state(ts, obs, (), torch.Generator().manual_seed(1), explore=False)
    assert state == () and not extras
    torch.testing.assert_close(act, algo.act(ts, obs, torch.Generator(), explore=False))
    assert Algorithm.act_with_state is type(algo).act_with_state
    col = Collector(algo, VectorEnv(_Cart(), 2, device="cpu"), device="cpu")
    assert col.reset(torch.Generator().manual_seed(0)).policy_state == ()


@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_compute_action_matches_jax(kind):
    obs = np.array([0.1, -0.3, 0.05, 0.2], np.float32)
    if kind == "discrete":
        jalgo = JaxDQN(jc.QNet((16,), 3), JaxDiscrete(3))
        talgo = DQN(tc.QNet(OBS, (16,), 3), Discrete(3), device="cpu")
        jts = jalgo.init(jax.random.key(0), jnp.asarray(obs))
        tts = talgo.init(torch.Generator().manual_seed(0))
        tts.online.load_state_dict(params_from_flax(jax.device_get(jts.params)))
    else:
        jalgo = JaxSAC(jcont.GaussianActor((16,), 2, conditioned_sigma=True), jcont.CriticEnsemble((16,), 2),
                       JaxBox(low=-2.0, high=2.0, shape=(2,)))
        talgo = SAC(tcont.GaussianActor(OBS, (16,), 2, conditioned_sigma=True), tcont.CriticEnsemble(OBS, 2, (16,)),
                    Box(low=-2.0, high=2.0, shape=(2,)), device="cpu")
        jts = jalgo.init(jax.random.key(0), jnp.asarray(obs))
        tts = talgo.init(torch.Generator().manual_seed(0))
        tts.actor.load_state_dict(params_from_flax(jax.device_get(jts.actor_params), heads=("mu", "sigma")))
    ref = jalgo.compute_action(jts, obs)
    got = talgo.compute_action(tts, obs)
    if kind == "discrete":
        assert isinstance(got, int) and got == ref
    else:
        assert isinstance(got, np.ndarray) and got.shape == (2,)
        _close(got, ref, msg="continuous action")
