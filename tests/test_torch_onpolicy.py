"""The on-policy slice of the port (tianshou_tpu_torch: ops/returns GAE,
utils/statistics rms_*, envs/norm, networks ValueNet, algos pg/a2c/ppo/npg,
the collectors' recorded trajectories and trainer/onpolicy) against the JAX
package, on the CPU in float32 at a small size (hidden (32, 32)).

- gae_advantages and discounted_returns on [T, N] with termination and
  truncation: atol 1e-6 against the JAX functions, and against
  tests/test_returns.py's pure-Python py_gae.
- rms_init/update/normalize within 1e-6; a NormObsVectorEnv segment.
- ValueNet's forward with carried parameters: atol 1e-5.
- process_rollout and update_rollout_stats of PG, A2C and PPO, with and
  without ret_norm: rtol 1e-5 / atol 1e-5.
- learn from the same parameters and minibatch for PG (discrete and
  continuous, and an optimizer override), A2C, PPO (dual clip, value
  clip, grad clipping, a linear learning-rate schedule), NPG and TRPO:
  metrics and parameters within
  rtol 1e-4 / atol 1e-5; TRPO's ``accepted`` equal.  NPG and TRPO on
  unshrunk observations: the float32 steps of both packages within a limit
  set from readings of the port's float64 step.
- A recorded on-device segment (CartPole with auto-resets; Pendulum behind
  NormObsVectorEnv) with the JAX package's own noise injected: equal
  actions, log_prob and trajectory.
- HostCollector(record_traj=True) over gymnasium's CartPole-v1 and
  Pendulum-v1 with injected noise; tensor leaves nested at any depth stay
  on their device through the packed copy.
- One whole on-device superstep fed the JAX permutations and noise.
- OnPolicyTrainer.run() on both paths; every new entry point raises
  without CUDA.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_returns import py_gae
from tianshou_tpu.algos.a2c import A2C as JaxA2C
from tianshou_tpu.algos.npg import NPG as JaxNPG
from tianshou_tpu.algos.npg import TRPO as JaxTRPO
from tianshou_tpu.algos.pg import PG as JaxPG
from tianshou_tpu.algos.ppo import PPO as JaxPPO
from tianshou_tpu.collect.collector import Collector as JaxCollector
from tianshou_tpu.collect.collector import rollout_segment as jax_rollout_segment
from tianshou_tpu.collect.host_collector import HostCollector as JaxHostCollector
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
from tianshou_tpu.envs.classic import CartPole as JaxCartPole
from tianshou_tpu.envs.classic import CartPoleState as JaxCartPoleState
from tianshou_tpu.envs.classic import Pendulum as JaxPendulum
from tianshou_tpu.envs.classic import PendulumState as JaxPendulumState
from tianshou_tpu.envs import host as jhost
from tianshou_tpu.envs.norm import NormObsVectorEnv as JaxNormObsVectorEnv
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.networks import continuous as jcont
from tianshou_tpu.networks.common import QNet as JaxQNet
from tianshou_tpu.ops.returns import discounted_returns as jax_discounted_returns
from tianshou_tpu.ops.returns import gae_advantages as jax_gae_advantages
from tianshou_tpu.trainer.onpolicy import OnPolicyTrainer as JaxOnPolicyTrainer
from tianshou_tpu.utils import statistics as jstats
from tianshou_tpu_torch.algos.a2c import A2C
from tianshou_tpu_torch.algos.npg import NPG, TRPO
from tianshou_tpu_torch.algos.pg import PG, linear_schedule
from tianshou_tpu_torch.algos.ppo import PPO
from tianshou_tpu_torch.collect.collector import Collector, rollout_segment
from tianshou_tpu_torch.collect.host_collector import HostCollector
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs import host as thost
from tianshou_tpu_torch.envs.classic import CartPole, CartPoleState, Pendulum, PendulumState
from tianshou_tpu_torch.envs.norm import NormObsVectorEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.convert import onpolicy_state_from_flax, params_from_flax
from tianshou_tpu_torch.ops.returns import discounted_returns, gae_advantages
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer
from tianshou_tpu_torch.utils import statistics as tstats
from tianshou_tpu_torch.utils.transfer import TreePacker

HID = (32, 32)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


# -- ops/returns ------------------------------------------------------------
def _rollout_flags(rng, T, N):
    terminated = rng.random((T, N)) < 0.1
    truncated = (rng.random((T, N)) < 0.08) & ~terminated
    return terminated, truncated


@pytest.mark.parametrize("T,N,gamma,lam", [(57, 1, 0.99, 0.95), (31, 4, 0.9, 0.8), (40, 3, 0.99, 1.0)])
def test_gae_and_discounted_returns_match_jax_and_oracle(T, N, gamma, lam):
    rng = np.random.default_rng(T)
    rew, val, val_next = (rng.normal(size=(T, N)).astype(np.float32) for _ in range(3))
    terminated, truncated = _rollout_flags(rng, T, N)
    done = terminated | truncated
    assert terminated.any() and truncated.any()
    jadv, jret = jax_gae_advantages(*map(jnp.asarray, (rew, val, val_next, terminated, done)), gamma, lam)
    adv, ret = gae_advantages(*map(_t, (rew, val, val_next, terminated, done)), gamma, lam)
    assert adv.shape == ret.shape == (T, N) and adv.dtype == torch.float32
    _close(adv, jadv, rtol=0, atol=1e-6)
    _close(ret, jret, rtol=0, atol=1e-6)
    for i in range(N):
        expected = py_gae(rew[:, i], val[:, i], val_next[:, i], terminated[:, i], done[:, i], gamma, lam)
        _close(adv[:, i], expected, rtol=1e-5, atol=1e-5)
    jmc = jax_discounted_returns(*map(jnp.asarray, (rew, val_next, terminated, done)), gamma)
    mc = discounted_returns(*map(_t, (rew, val_next, terminated, done)), gamma)
    _close(mc, jmc, rtol=0, atol=1e-6)


def test_discounted_returns_is_gae_lambda_one():
    """The telescoping identity of tests/test_returns.py: with next values
    that chain within an episode, GAE(lambda=1) + V is the MC return."""
    rng = np.random.default_rng(2)
    T = 40
    rew, val = rng.normal(size=(2, T, 1)).astype(np.float32)
    terminated = rng.random((T, 1)) < 0.15
    done = terminated.copy()
    done[-1] = True
    val_next = np.empty_like(val)
    val_next[:-1], val_next[-1] = val[1:], 0.0
    val_next[done] = rng.normal(size=int(done.sum()))
    _, ret = gae_advantages(*map(_t, (rew, val, val_next, terminated, done)), 0.99, 1.0)
    mc = discounted_returns(*map(_t, (rew, val_next, terminated, done)), 0.99)
    _close(ret, mc, rtol=1e-4, atol=1e-4)


def test_truncation_bootstraps_termination_does_not():
    rew, val = torch.ones(4, 1), torch.zeros(4, 1)
    val_next = torch.tensor([[0.0], [5.0], [0.0], [7.0]])
    truncated = torch.tensor([[False], [True], [False], [True]])
    _, ret = gae_advantages(rew, val, val_next, torch.zeros_like(truncated), truncated, 1.0, 1.0)
    _close(ret[:, 0], [7.0, 6.0, 9.0, 8.0], rtol=0, atol=0)
    _, ret = gae_advantages(rew, val, val_next, truncated, truncated, 1.0, 1.0)
    _close(ret[:, 0], [2.0, 1.0, 2.0, 1.0], rtol=0, atol=0)


# -- utils/statistics, envs/norm ----------------------------------------------
def test_rms_functions_match_jax():
    rng = np.random.default_rng(0)
    jst, tst = jstats.rms_init((3, 2)), tstats.rms_init((3, 2), "cpu")
    assert float(tst.count) == pytest.approx(1e-4) and tst.count.dtype == torch.float32
    for b in (1, 7, 64):
        batch = (rng.normal(size=(b, 3, 2)) * 3 + 1).astype(np.float32)
        jst, tst = jstats.rms_update(jst, jnp.asarray(batch)), tstats.rms_update(tst, _t(batch))
        for name in ("mean", "var", "count"):
            _close(getattr(tst, name), getattr(jst, name), rtol=1e-6, atol=1e-6, msg=name)
    x = (rng.normal(size=(50, 3, 2)) * 20).astype(np.float32)
    _close(tstats.rms_normalize(tst, _t(x)), jstats.rms_normalize(jst, jnp.asarray(x)), rtol=1e-6, atol=1e-6)
    _close(tstats.rms_normalize(tst, _t(x), clip=None), jstats.rms_normalize(jst, jnp.asarray(x), clip=None),
           rtol=1e-6, atol=1e-6)
    assert float(tstats.rms_normalize(tst, _t(x)).abs().max()) == 10.0


# fixed resets on both sides: the two packages draw from different streams
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


PEND0 = np.array([[0.3, -2.0, 2.9], [0.5, -0.4, 0.9]], np.float32)  # theta, theta_dot of 3 envs


class _JaxFixedVec(JaxVectorEnv):
    def reset(self, key):
        s = JaxPendulumState(jnp.asarray(PEND0[0]), jnp.asarray(PEND0[1]), jnp.zeros(3, jnp.int32))
        return s, jax.vmap(JaxPendulum._obs)(s)


class _FixedVec(VectorEnv):
    def reset(self, generator):
        s = PendulumState(_t(PEND0[0]).to(self.device), _t(PEND0[1]).to(self.device),
                          torch.zeros(3, dtype=torch.int32, device=self.device))
        return s, Pendulum._obs(s)


class _JaxNormPendulum(JaxNormObsVectorEnv, _JaxFixedVec):
    """NormObsVectorEnv over Pendulum whose 3 envs start from PEND0."""


class _NormPendulum(NormObsVectorEnv, _FixedVec):
    pass


def test_norm_obs_vector_env_segment_matches_jax():
    jv, tv = _JaxNormPendulum(JaxPendulum(), 3), _NormPendulum(Pendulum(), 3, device="cpu")
    (jstate, jobs), (tstate, tobs) = jv.reset(jax.random.key(0)), tv.reset(torch.Generator())
    _close(tobs, jobs, rtol=0, atol=1e-5)
    rng = np.random.default_rng(1)
    jstep = jax.jit(jv.step)
    for _ in range(25):
        act = rng.uniform(-2, 2, (3, 1)).astype(np.float32)
        jstate, jres, jcarry = jstep(jstate, jnp.asarray(act), jax.random.key(1))
        tstate, tres, tcarry = tv.step(tstate, _t(act), torch.Generator())
        _close(tres.obs, jres.obs, rtol=1e-5, atol=1e-5)
        _close(tcarry, jcarry, rtol=1e-5, atol=1e-5)
        _close(tres.reward, jres.reward, rtol=1e-5, atol=1e-5)
    jrms, trms = JaxNormObsVectorEnv.get_rms(jstate), NormObsVectorEnv.get_rms(tstate)
    for name in ("mean", "var", "count"):
        _close(getattr(trms, name), getattr(jrms, name), rtol=1e-5, atol=1e-5, msg=name)
    assert float(trms.count) == pytest.approx(3 * 26 + 1e-4)
    # a frozen test env normalises with the statistics handed over
    frozen = _NormPendulum(Pendulum(), 3, update_rms=False, device="cpu")
    fstate, fobs = frozen.reset(torch.Generator())
    fstate = NormObsVectorEnv.with_rms(fstate, trms)
    _, raw = frozen.env.step(fstate[0], torch.zeros(3, 1))
    fstate, fres, _ = frozen.step(fstate, torch.zeros(3, 1), torch.Generator())
    assert NormObsVectorEnv.get_rms(fstate) is trms
    torch.testing.assert_close(fres.obs, tstats.rms_normalize(trms, raw.obs))


# -- networks -------------------------------------------------------------------
def test_value_net_matches_flax():
    rng = np.random.default_rng(4)
    obs = (rng.normal(size=(9, 5)) * 2).astype(np.float32)
    jnet, tnet = jcont.ValueNet(HID), tcont.ValueNet(5, HID)
    params = jnet.init(jax.random.key(5), jnp.asarray(obs))
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    ref = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got = tnet(_t(obs))
    assert got.shape == (9,) and np.abs(np.asarray(ref)).max() > 1e-3
    _close(got, ref, rtol=0, atol=1e-5)


# -- algorithms ----------------------------------------------------------------
OBS_D, A_D = 4, 2  # discrete: CartPole's shapes
OBS_C, A_C = 5, 2  # continuous


def _nets(kind):
    """``(jax actor, port actor, jax critic, port critic, jax space, port
    space, actor heads)`` for a discrete or continuous algorithm."""
    if kind == "discrete":
        return (JaxQNet(HID, A_D), QNet(OBS_D, HID, A_D), jcont.ValueNet(HID), tcont.ValueNet(OBS_D, HID),
                JaxDiscrete(A_D), Discrete(A_D), None)
    return (jcont.GaussianActor(HID, A_C, sigma_init=-0.3), tcont.GaussianActor(OBS_C, HID, A_C, sigma_init=-0.3),
            jcont.ValueNet(HID), tcont.ValueNet(OBS_C, HID), JaxBox(low=-1.0, high=1.0, shape=(A_C,)),
            Box(low=-1.0, high=1.0, shape=(A_C,)), ("mu",))


def _algo_pair(name, kind, jax_kwargs=None, **kw):
    ja, ta, jc, tc, jspace, tspace, heads = _nets(kind)
    jkw = {**kw, **(jax_kwargs or {})}
    if name == "pg":
        jalgo, talgo = JaxPG(ja, jspace, **jkw), PG(ta, tspace, device="cpu", **kw)
    else:
        jcls, tcls = {"a2c": (JaxA2C, A2C), "ppo": (JaxPPO, PPO), "npg": (JaxNPG, NPG), "trpo": (JaxTRPO, TRPO)}[name]
        jalgo, talgo = jcls(ja, jc, jspace, **jkw), tcls(ta, tc, tspace, device="cpu", **kw)
    obs_dim = OBS_D if kind == "discrete" else OBS_C
    jts = jalgo.init(jax.random.key(0), jnp.zeros((obs_dim,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.load(onpolicy_state_from_flax(jax.device_get(jts), actor_heads=heads))
    return jalgo, jts, talgo, tts, heads


def _assert_state_close(jts, tts, heads, rtol=1e-4, atol=1e-5):
    ref = onpolicy_state_from_flax(jax.device_get(jts), actor_heads=heads)
    for part in ("actor", "critic"):
        if part not in ref:
            assert tts.critic is None
            continue
        got = getattr(tts, part).state_dict()
        assert set(got) == set(ref[part])
        for name, value in ref[part].items():
            _close(got[name], value, rtol=rtol, atol=atol, msg=f"{part}.{name}")
    for name in ("ret_mean", "ret_var", "ret_count"):
        if name in ref:
            _close(getattr(tts, name), ref[name], rtol=rtol, atol=atol, msg=name)
        else:
            assert getattr(tts, name) is None


def _trajectory(kind, T=12, N=3, seed=0):
    """A ``[T, N]`` rollout with terminations and truncations, as numpy."""
    rng = np.random.default_rng(seed)
    obs_dim = OBS_D if kind == "discrete" else OBS_C
    terminated, truncated = _rollout_flags(rng, T, N)
    act = (rng.integers(0, A_D, (T, N)).astype(np.int32) if kind == "discrete"
           else rng.uniform(-1.5, 1.5, (T, N, A_C)).astype(np.float32))
    return dict(
        obs=(rng.normal(size=(T, N, obs_dim)) * 2).astype(np.float32),
        act=act,
        rew=(rng.normal(size=(T, N)) * 3 + 1).astype(np.float32),
        terminated=terminated,
        truncated=truncated,
        obs_next=(rng.normal(size=(T, N, obs_dim)) * 2).astype(np.float32),
        log_prob=rng.normal(size=(T, N)).astype(np.float32) - 1.0,
    )


def _traj_pair(arrays):
    def side(asarray, batch):
        c = {k: asarray(v) for k, v in arrays.items()}
        logp = c.pop("log_prob")
        return batch(**c, policy=batch(log_prob=logp))

    return side(jnp.asarray, JaxBatch), side(_t, Batch)


@pytest.mark.parametrize("name,ret_norm", [("pg", False), ("a2c", False), ("a2c", True), ("ppo", True)])
def test_process_rollout_and_rollout_stats_match_jax(name, ret_norm):
    kind = "continuous" if name == "ppo" else "discrete"
    kw = dict(gamma=0.9) if name == "pg" else dict(gamma=0.9, gae_lambda=0.8, ret_norm=ret_norm)
    jalgo, jts, talgo, tts, heads = _algo_pair(name, kind, **kw)
    # a second rollout is processed with the statistics the first one left
    for seed in (1, 2):
        jtraj, ttraj = _traj_pair(_trajectory(kind, seed=seed))
        jout, tout = jalgo.process_rollout(jts, jtraj), talgo.process_rollout(tts, ttraj)
        assert set(tout) == set(jout)
        for k in jout:
            assert tout[k].shape == jout[k].shape, k
            _close(tout[k], jout[k], rtol=1e-5, atol=1e-5, msg=k)
        jts, tts = jalgo.update_rollout_stats(jts, jtraj), talgo.update_rollout_stats(tts, ttraj)
        _assert_state_close(jts, tts, heads, rtol=1e-5, atol=1e-5)
    if ret_norm:
        assert float(tts.ret_count) == pytest.approx(2 * 36 + 1e-4) and abs(float(tts.ret_var) - 1.0) > 0.1


def _minibatch(name, kind, jalgo, jts, seed, B=16, shrink=True):
    """A minibatch of process_rollout's keys; ``logp_old`` is the actor's
    own log-prob plus noise, so that PPO's clip and TRPO's ratio act.

    NPG and TRPO take observations 4x smaller (unless not ``shrink``), a
    better-conditioned Fisher matrix: 10 conjugate-gradient iterations
    amplify float32 rounding by its condition number, and at the scale of
    the others both packages' float32 steps sit up to 5e-3 from a float64
    solve of the same system (see ``test_natural_gradient_at_full_scale``),
    beyond the comparison's tolerance."""
    rng = np.random.default_rng(seed)
    arrays = _trajectory(kind, T=B, N=1, seed=seed)
    flat = {k: v.reshape((B,) + v.shape[2:]) for k, v in arrays.items()}
    if name in ("npg", "trpo") and shrink:
        flat["obs"] = flat["obs"] / 4
    dist = jalgo.actor.apply(jts.params["actor"], jnp.asarray(flat["obs"]))
    logp, _ = jalgo._log_prob_entropy(dist, jnp.asarray(flat["act"]))
    mb = dict(obs=flat["obs"], act=flat["act"], ret=(rng.normal(size=B) * 2).astype(np.float32),
              logp_old=(np.asarray(logp) + rng.normal(size=B) * 0.3).astype(np.float32))
    if name != "pg":
        mb["adv"] = (rng.normal(size=B) * 2 + 0.3).astype(np.float32)
        mb["v_s"] = (mb["ret"] + rng.normal(size=B) * 0.5).astype(np.float32)
    return JaxBatch(**{k: jnp.asarray(v) for k, v in mb.items()}), Batch(**{k: _t(v) for k, v in mb.items()})


LEARN_CASES = {
    "pg-discrete": ("pg", "discrete", dict(lr=3e-3, ret_norm=True, ent_coef=0.01, max_grad_norm=0.5)),
    "pg-continuous": ("pg", "continuous", dict(lr=3e-3, ent_coef=0.01)),
    "pg-sgd-override": ("pg", "continuous", dict(optimizer=lambda params: torch.optim.SGD(params, lr=0.05),
                                                 max_grad_norm=0.5)),
    "a2c": ("a2c", "discrete", dict(lr=3e-3, vf_coef=0.5, ent_coef=0.01, max_grad_norm=0.5, adv_norm=True)),
    "ppo-clips": ("ppo", "continuous", dict(lr=3e-3, eps_clip=0.2, dual_clip=3.0, value_clip=True,
                                            max_grad_norm=0.1, ent_coef=0.01)),
    "ppo-discrete": ("ppo", "discrete", dict(lr=3e-3, max_grad_norm=0.5)),
    "ppo-lr-decay": ("ppo", "continuous", dict(lr=linear_schedule(3e-3, 0.0, 4), max_grad_norm=0.5, adv_norm=False,
                                               vf_coef=0.25)),
    "npg": ("npg", "continuous", dict(critic_lr=3e-3, trust_region_size=0.3)),
    "npg-discrete": ("npg", "discrete", dict(critic_lr=3e-3)),
    "trpo": ("trpo", "continuous", dict(critic_lr=3e-3, max_kl=0.01)),
    "trpo-discrete": ("trpo", "discrete", dict(critic_lr=3e-3, max_kl=0.005)),
    "trpo-rejects": ("trpo", "continuous", dict(critic_lr=3e-3, max_kl=0.0)),
}


@pytest.mark.parametrize("case", list(LEARN_CASES))
def test_learn_matches_jax(case):
    name, kind, kw = LEARN_CASES[case]
    jax_kwargs = None
    if case == "ppo-lr-decay":
        jax_kwargs = dict(lr=3e-3, optimizer=optax.adam(optax.linear_schedule(3e-3, 0.0, 4)))
    elif case == "pg-sgd-override":
        jax_kwargs = dict(optimizer=optax.sgd(0.05))
    jalgo, jts, talgo, tts, heads = _algo_pair(name, kind, jax_kwargs=jax_kwargs, **kw)
    learn = jax.jit(jalgo.learn)
    actor_before = {k: v.clone() for k, v in tts.actor.state_dict().items()}
    # one natural-gradient learn: its 10 conjugate-gradient iterations
    # amplify float32 rounding by the Fisher matrix's condition number, so a
    # second learn from slightly different parameters drifts past 1e-5
    steps = 1 if name in ("npg", "trpo") else 3
    for step in range(1, steps + 1):
        jmb, tmb = _minibatch(name, kind, jalgo, jts, seed=10 + step)
        jts, jm = learn(jts, jmb, jax.random.key(step))
        tts, tm = talgo.learn(tts, tmb)
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=f"{case} step {step} {k}")
        assert tts.step == int(jts.step) == step
        _assert_state_close(jts, tts, heads)
        if name == "trpo":
            assert float(tm["accepted"]) == float(jm["accepted"])
    moved = any(not torch.equal(v, tts.actor.state_dict()[k]) for k, v in actor_before.items())
    assert moved == (case != "trpo-rejects")
    if case == "trpo":
        assert float(tm["accepted"]) == 1.0


# How far a float32 natural-gradient step at the unscaled inputs may sit
# from the port's float64 step, relative to its length.  Readings (CPU, the
# minibatch of seed 11): the port's float32 step 4.1e-5 (NPG) and 1.7e-5
# (TRPO) continuous, 4.1e-3 and 4.8e-3 discrete; the JAX package's 4.6e-4,
# 9.0e-4, 4.1e-3 and 4.8e-3.  Each limit is about 5x its kind's largest.
NATURAL_STEP_LIMIT = {"continuous": 5e-3, "discrete": 2.5e-2}


def _float64_twin(name, kind, kw):
    """The port's ``name`` with its nets computing in float64."""
    f64 = torch.float64
    if kind == "discrete":
        actor, critic = QNet(OBS_D, HID, A_D, compute_dtype=f64), tcont.ValueNet(OBS_D, HID, compute_dtype=f64)
        space = Discrete(A_D)
    else:
        actor = tcont.GaussianActor(OBS_C, HID, A_C, sigma_init=-0.3, compute_dtype=f64)
        critic, space = tcont.ValueNet(OBS_C, HID, compute_dtype=f64), Box(low=-1.0, high=1.0, shape=(A_C,))
    return {"npg": NPG, "trpo": TRPO}[name](actor.double(), critic.double(), space, device="cpu", **kw)


@pytest.mark.parametrize("case", ["npg", "npg-discrete", "trpo", "trpo-discrete"])
def test_natural_gradient_at_full_scale(case):
    """One NPG/TRPO learn on observations at the other learn tests' scale,
    not shrunk: the JAX package's float32 step and the port's float32 step
    each within ``NATURAL_STEP_LIMIT`` of the port's float64 step (which
    reaches the Fisher matrix by a double backward, the JAX package by
    forward-over-reverse), TRPO accepting on all three."""
    name, kind, kw = LEARN_CASES[case]
    jalgo, jts, talgo, tts, heads = _algo_pair(name, kind, **kw)
    talgo64 = _float64_twin(name, kind, kw)
    tts64 = talgo64.init(torch.Generator().manual_seed(0))
    tts64.actor.load_state_dict(tts.actor.state_dict())
    tts64.critic.load_state_dict(tts.critic.state_dict())
    before = {k: v.double().clone() for k, v in tts.actor.state_dict().items()}
    jmb, tmb = _minibatch(name, kind, jalgo, jts, seed=11, shrink=False)
    jts, jm = jax.jit(jalgo.learn)(jts, jmb, jax.random.key(1))
    tts, tm = talgo.learn(tts, tmb)
    tts64, m64 = talgo64.learn(tts64, Batch(**{k: v.double() if v.is_floating_point() else v for k, v in tmb.items()}))
    jax_actor = onpolicy_state_from_flax(jax.device_get(jts), actor_heads=heads)["actor"]

    def step(state):
        return torch.cat([(torch.as_tensor(np.asarray(state[k])).double() - before[k]).ravel() for k in before])

    ref = step(tts64.actor.state_dict())
    assert float(ref.norm()) > 1e-2
    for who, state in (("jax float32", jax_actor), ("port float32", tts.actor.state_dict())):
        rel = float((step(state) - ref).norm() / ref.norm())
        assert rel < NATURAL_STEP_LIMIT[kind], f"{case}: {who} step {rel:.3e} from the float64 step"
    if name == "trpo":
        assert float(jm["accepted"]) == float(tm["accepted"]) == float(m64["accepted"]) == 1.0


def test_grad_clip_is_optax_form():
    from tianshou_tpu_torch.algos.pg import clip_by_global_norm_

    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (4,), (2, 2))]
    clip = optax.clip_by_global_norm(1.0)
    for scale in (0.01, 10.0):  # under and over the limit
        ref, _ = clip.update([jnp.asarray(x * scale) for x in leaves], clip.init(None))
        grads = [_t(x * scale) for x in leaves]
        clip_by_global_norm_(grads, 1.0)
        for g, r in zip(grads, ref):
            _close(g, r, rtol=1e-6, atol=1e-7)


# -- recorded segments ------------------------------------------------------------
def _inject_noise(talgo, draws):
    """Make the port's sampler take ``draws`` in order."""
    it = iter(draws)
    talgo._noise = lambda generator, dist: next(it)


def _jax_collect_noise(rng_key, steps, shape, discrete):
    """The draws the JAX collector's acts take: per step the carried key
    splits into (act, env, next)."""
    draws = []
    for _ in range(steps):
        k_act, _, rng_key = jax.random.split(rng_key, 3)
        draw = jax.random.gumbel(k_act, shape) if discrete else jax.random.normal(k_act, shape)
        draws.append(_t(draw))
    return draws


def _segment_case(case):
    """``(jax venv, port venv, algo name/kind, start states or None)``."""
    if case == "cartpole":
        rng = np.random.default_rng(5)
        start = rng.uniform(-0.04, 0.04, (4, 3)).astype(np.float32)
        t0 = np.array([0, 3, 6], np.int32)
        starts = (JaxCartPoleState(*map(jnp.asarray, start), jnp.asarray(t0)),
                  CartPoleState(*map(_t, start), _t(t0)))
        return JaxVectorEnv(_JaxCart(), 3), VectorEnv(_Cart(), 3, device="cpu"), "discrete", starts
    return _JaxNormPendulum(JaxPendulum(), 3), _NormPendulum(Pendulum(), 3, device="cpu"), "continuous", None


def _onpolicy_setup(case, **kw):
    jvenv, tvenv, kind, starts = _segment_case(case)
    if kind == "continuous":
        ja, ta = jcont.GaussianActor(HID, 1, sigma_init=-0.3), tcont.GaussianActor(3, HID, 1, sigma_init=-0.3)
        obs_dim, heads = 3, ("mu",)
    else:
        ja, ta = JaxQNet(HID, 2), QNet(4, HID, 2)
        obs_dim, heads = 4, None
    jalgo = JaxPPO(ja, jcont.ValueNet(HID), jvenv.action_space, **kw)
    talgo = PPO(ta, tcont.ValueNet(obs_dim, HID), tvenv.action_space, device="cpu", **kw)
    jcol, tcol = JaxCollector(jalgo, jvenv), Collector(talgo, tvenv, device="cpu")
    jcs, tcs = jcol.reset(jax.random.key(3)), tcol.reset(torch.Generator().manual_seed(0))
    if starts is not None:
        jcs = jcs.replace(env_state=starts[0], obs=jax.vmap(JaxCartPole._obs)(starts[0]))
        tcs.env_state, tcs.obs = starts[1], CartPole._obs(starts[1])
    _close(tcs.obs, jcs.obs, rtol=0, atol=1e-6)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((obs_dim,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.load(onpolicy_state_from_flax(jax.device_get(jts), actor_heads=heads))
    return jalgo, jcol, jcs, jts, talgo, tcol, tcs, tts, kind, heads


def _assert_traj_close(ttraj, jtraj, atol):
    assert set(ttraj) == set(jtraj) and set(ttraj["policy"]) == {"log_prob"}
    np.testing.assert_allclose(ttraj["act"].numpy(), np.asarray(jtraj["act"]), rtol=0, atol=atol)
    for k in ("obs", "rew", "obs_next"):
        np.testing.assert_allclose(ttraj[k].numpy(), np.asarray(jtraj[k]), rtol=1e-5, atol=atol, err_msg=k)
    for k in ("terminated", "truncated"):
        np.testing.assert_array_equal(ttraj[k].numpy(), np.asarray(jtraj[k]), err_msg=k)
    np.testing.assert_allclose(ttraj["policy"]["log_prob"].numpy(), np.asarray(jtraj["policy"]["log_prob"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["cartpole", "pendulum-normobs"])
def test_recorded_segment_matches_jax(case):
    jalgo, jcol, jcs, jts, talgo, tcol, tcs, tts, kind, _ = _onpolicy_setup(case)
    steps = 24
    act_dim = 2 if kind == "discrete" else 1
    _inject_noise(talgo, _jax_collect_noise(jcs.rng, steps, (3, act_dim), kind == "discrete"))
    jseg = jax.jit(jax_rollout_segment(jalgo, jcol.venv, None, steps, explore=True, record_traj=True))
    jcs, _, jout = jseg(jts, jcs, None, 0.0)
    tcs, _, tout = rollout_segment(talgo, tcol.venv, None, steps, explore=True, record_traj=True)(tts, tcs, None, 0.0)
    jtraj, ttraj = jout["traj"], tout["traj"]
    assert ttraj["obs"].shape == (steps, 3, 3 if kind == "continuous" else 4)
    _assert_traj_close(ttraj, jtraj, atol=1e-5)
    for k in ("done", "ep_len"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    if kind == "discrete":
        assert int(np.asarray(jout["done"]).sum()) > 0  # the segment crosses an auto-reset
        assert len(np.unique(np.asarray(jtraj["act"]))) == 2
    else:
        jrms, trms = jcs.env_state[1], tcs.env_state[1]
        for name in ("mean", "var", "count"):
            _close(getattr(trms, name), getattr(jrms, name), rtol=1e-5, atol=1e-5, msg=name)


def test_whole_superstep_matches_jax():
    """One on-device superstep (rollout, processing with recompute and
    ret_norm, 2 passes x 3 minibatches) from the same parameters, noise
    and permutations."""
    kw = dict(lr=3e-3, gamma=0.9, gae_lambda=0.9, max_grad_norm=0.5, ret_norm=True, recompute_advantage=True)
    jalgo, jcol, jcs, jts, talgo, tcol, tcs, tts, kind, heads = _onpolicy_setup("cartpole", **kw)
    trainer_kw = dict(max_epoch=1, step_per_epoch=24, step_per_collect=24, repeat_per_collect=2, batch_size=8)
    jtrainer = JaxOnPolicyTrainer(jalgo, jcol, jcol, **trainer_kw)
    ttrainer = OnPolicyTrainer(talgo, tcol, tcol, device="cpu", **trainer_kw)
    assert ttrainer.updates_per_segment == 6 and ttrainer.segment_len == 8
    key = jax.random.key(9)
    perms = []
    for k in jax.random.split(key, 2):
        k_perm, _ = jax.random.split(k)
        perms.append(_t(jax.random.permutation(k_perm, 24)).long())
    perm_it = iter(perms)
    _inject_noise(talgo, _jax_collect_noise(jcs.rng, 8, (3, 2), True))
    jts, jcs, jout, jm = jtrainer._build_superstep()(jts, jcs, key)
    superstep = ttrainer._build_superstep(permutation=lambda g, m: next(perm_it))
    tts, tcs, tout, tm = superstep(tts, tcs, torch.Generator())
    _assert_traj_close(tout["traj"], jout["traj"], atol=1e-5)
    assert set(tm) == set(jm)
    for k in jm:
        _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=k)
    assert tts.step == int(jts.step) == 6
    _assert_state_close(jts, tts, heads)


# -- the host path -------------------------------------------------------------
@pytest.fixture
def gym():
    return pytest.importorskip("gymnasium")


def _host_pair(gym, env_id, n=3):
    make = lambda: gym.make(env_id)  # noqa: E731
    jv, tv = jhost.HostVectorEnv([make] * n), thost.HostVectorEnv([make] * n)
    if env_id.startswith("CartPole"):
        ja, ta, obs_dim, heads = JaxQNet(HID, 2), QNet(4, HID, 2), 4, None
    else:
        ja, ta = jcont.GaussianActor(HID, 1, sigma_init=-0.3), tcont.GaussianActor(3, HID, 1, sigma_init=-0.3)
        obs_dim, heads = 3, ("mu",)
    jalgo = JaxPPO(ja, jcont.ValueNet(HID), jv.action_space)
    talgo = PPO(ta, tcont.ValueNet(obs_dim, HID), tv.action_space, device="cpu")
    jts = jalgo.init(jax.random.key(0), jnp.zeros((obs_dim,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.load(onpolicy_state_from_flax(jax.device_get(jts), actor_heads=heads))
    return jalgo, jts, JaxHostCollector(jalgo, jv, act_on_host=False), talgo, tts, HostCollector(talgo, tv, device="cpu")


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_host_collector_records_trajectories_like_jax(gym, env_id):
    jalgo, jts, jcol, talgo, tts, tcol = _host_pair(gym, env_id)
    steps, discrete = 30, env_id.startswith("CartPole")
    key = jax.random.key(4)
    draws, k = [], key
    for _ in range(steps):
        k, k_act = jax.random.split(k)
        shape = (3, 2 if discrete else 1)
        draws.append(_t(jax.random.gumbel(k_act, shape) if discrete else jax.random.normal(k_act, shape)))
    _inject_noise(talgo, draws)
    jcol.reset(seed=11)
    tcol.reset(seed=11)
    _, jstats_, jtraj = jcol.collect(jts, None, steps, key, explore=True, record_traj=True)
    _, tstats_, ttraj = tcol.collect(tts, None, steps, torch.Generator(), explore=True, record_traj=True)
    assert isinstance(ttraj["policy"]["log_prob"], torch.Tensor) and isinstance(ttraj["obs"], np.ndarray)
    dev = tcol.to_device(ttraj)
    _assert_traj_close(dev, jtraj, atol=1e-5)
    assert dev["policy"]["log_prob"] is ttraj["policy"]["log_prob"]
    assert tstats_.n_collected_episodes == jstats_.n_collected_episodes
    if discrete:
        assert tstats_.n_collected_episodes > 0
    jcol.venv.close()
    tcol.venv.close()


def test_host_transfer_keeps_nested_tensor_leaves(gym):
    """Tensor leaves at any depth stay out of the packed copy and are handed
    back as they are; every numpy leaf crosses in one copy."""
    tcol = HostCollector(PG(QNet(4, HID, 2), Discrete(2), device="cpu"),
                         thost.HostVectorEnv([lambda: gym.make("CartPole-v1")]), device="cpu")
    rng = np.random.default_rng(0)
    deep = torch.arange(6.0).view(3, 2)
    traj = Batch(
        obs=rng.normal(size=(3, 2, 4)),
        rew=rng.normal(size=(3, 2)).astype(np.float32),
        act=torch.ones(3, 2, dtype=torch.int64),
        policy=Batch(log_prob=torch.zeros(3, 2), inner=Batch(deep=deep, host=np.ones((3, 2), np.int32))),
    )
    copies = TreePacker.copies
    packer, _, dev_part = tcol.upload(traj)
    assert TreePacker.copies == copies + 1
    assert set(packer.example) == {"obs", "rew", "policy"} and set(packer.example["policy"]) == {"inner"}
    assert set(dev_part) == {"act", "policy"} and set(dev_part["policy"]["inner"]) == {"deep"}
    out = tcol.to_device(traj)
    assert out["policy"]["inner"]["deep"] is deep and out["act"] is traj["act"]
    assert out["policy"]["log_prob"] is traj["policy"]["log_prob"]
    np.testing.assert_array_equal(out["policy"]["inner"]["host"].numpy(), np.ones((3, 2), np.int32))
    np.testing.assert_array_equal(out["obs"].numpy(), traj["obs"].astype(np.float32))
    tcol.venv.close()


def test_run_host_counters_match_jax(gym):
    make = lambda: gym.make("Pendulum-v1")  # noqa: E731
    jalgo, _, _, talgo, _, _ = _host_pair(gym, "Pendulum-v1")
    kw = dict(max_epoch=2, step_per_epoch=40, step_per_collect=16, repeat_per_collect=2, batch_size=8,
              episode_per_test=1, seed=0)
    jtrainer = JaxOnPolicyTrainer(jalgo, JaxHostCollector(jalgo, jhost.HostVectorEnv([make] * 2)),
                                  JaxHostCollector(jalgo, jhost.HostVectorEnv([make])), **kw)
    ttrainer = OnPolicyTrainer(talgo, HostCollector(talgo, thost.HostVectorEnv([make] * 2), device="cpu"),
                               HostCollector(talgo, thost.HostVectorEnv([make]), device="cpu"), device="cpu", **kw)
    jinfo, tinfo = jtrainer.run(), ttrainer.run()
    assert (tinfo.env_step, tinfo.gradient_step, tinfo.epoch) == (jinfo.env_step, jinfo.gradient_step, jinfo.epoch)
    # 2 epochs x 3 segments of 16 steps, 2 passes x 2 minibatches each
    assert tinfo.env_step == 2 * 3 * 16 and tinfo.gradient_step == 2 * 3 * 4 == ttrainer.train_state.step
    assert math.isfinite(tinfo.best_reward) and -1700 < tinfo.best_reward <= 0
    assert set(tinfo.last_metrics) == {"loss", "policy_loss", "value_loss", "entropy"}


# -- the on-device trainer ---------------------------------------------------------
def _tiny_trainer(algo_name="ppo", **kw):
    env = CartPole()
    actor, critic = QNet(4, HID, 2), tcont.ValueNet(4, HID)
    if algo_name == "pg":
        algo = PG(actor, env.action_space, device="cpu")
    elif algo_name == "trpo":
        algo = TRPO(actor, critic, env.action_space, device="cpu")
    else:
        algo = PPO(actor, critic, env.action_space, recompute_advantage=True, ret_norm=True, device="cpu")
    train = Collector(algo, VectorEnv(env, 4, device="cpu"), device="cpu")
    test = Collector(algo, VectorEnv(env, 2, device="cpu"), device="cpu")
    return OnPolicyTrainer(algo, train, test, max_epoch=2, step_per_epoch=60, step_per_collect=32,
                           repeat_per_collect=2, batch_size=12, episode_per_test=2, device="cpu", **kw)


@pytest.mark.parametrize("algo_name", ["pg", "ppo", "trpo"])
def test_trainer_run_completes(algo_name):
    trainer = _tiny_trainer(algo_name)
    assert (trainer.segment_len, trainer.steps_per_segment, trainer.updates_per_segment) == (8, 32, 2 * 2)
    info = trainer.run()
    # 60 steps an epoch take 2 supersteps of 32 env steps
    assert (info.epoch, info.env_step, info.gradient_step) == (2, 2 * 2 * 32, 2 * 2 * 4)
    assert trainer.train_state.step == info.gradient_step
    assert all(math.isfinite(v) for v in info.last_metrics.values()) and info.best_reward >= 8


@pytest.mark.parametrize("test_in_train", [False, True])
def test_trainer_stops_on_stop_fn(test_in_train):
    saved = []
    trainer = _tiny_trainer(stop_fn=lambda reward: True, test_in_train=test_in_train,
                            save_best_fn=lambda ts: saved.append(ts.step))
    info = trainer.run()
    assert info.stop_triggered and info.epoch == 1
    if test_in_train:
        # the first episodes end in the second superstep (8 steps an env
        # each), which tests and stops before the epoch's own test phase
        assert info.env_step == 2 * 32 and saved == []
    else:
        assert info.env_step == 2 * 32 and saved == [2 * 4]


def _entry_points():
    env = CartPole()
    actor, critic = QNet(4, HID, 2), tcont.ValueNet(4, HID)
    algo = PPO(actor, critic, env.action_space, device="cpu")
    col = Collector(algo, VectorEnv(env, 2, device="cpu"), device="cpu")
    return {
        "NormObsVectorEnv": lambda: NormObsVectorEnv(env, 2),
        "PG": lambda: PG(actor, env.action_space),
        "A2C": lambda: A2C(actor, critic, env.action_space),
        "PPO": lambda: PPO(actor, critic, env.action_space),
        "NPG": lambda: NPG(actor, critic, env.action_space),
        "TRPO": lambda: TRPO(actor, critic, env.action_space),
        "OnPolicyTrainer": lambda: OnPolicyTrainer(algo, col, col, max_epoch=1, step_per_epoch=1,
                                                   step_per_collect=1),
    }


@pytest.mark.parametrize("entry", ["NormObsVectorEnv", "PG", "A2C", "PPO", "NPG", "TRPO", "OnPolicyTrainer"])
def test_default_device_without_cuda_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _entry_points()[entry]()
