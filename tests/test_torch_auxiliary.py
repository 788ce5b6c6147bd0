"""HER, ICM, GAIL, PSRL and the offline trainer of the port against the JAX
package, on the CPU in float32 at a small size.

- HER: ``sample_her`` on a [2, 16] goal ring with episode ends, the JAX
  sampler's slots and uniforms recorded (ordered ``jax.debug.callback``)
  and injected: the same rewritten batch (exact indices, values within
  atol 1e-6); and one DDPG update from a HER presample, parameters within
  rtol 1e-4 / atol 1e-5.
- ICM: two updates of ICM around DQN from the same parameters and the JAX
  update's own two samples an update: metrics and every parameter (the ICM
  net, the inner online and target nets) within rtol 1e-4 / atol 1e-5.
- GAIL: ``pre_learn`` (2 discriminator steps, the rollout rows and expert
  slots of each step recorded from the JAX scan and injected) and
  ``process_rollout`` with the rewritten reward: within rtol 1e-4 / atol
  1e-5.
- PSRL: one ``learn`` with the JAX update's Dirichlet draw injected: the
  posterior counts exact, the value table within rtol 1e-5, the same
  policy table; a distribution test of ``torch._sample_dirichlet`` with a
  generator (moments within 4 standard errors); acting from the table.
- OfflineTrainer: the JAX trainer's accounting (``env_step = gradient_step
  * batch_size``, epochs, early stop), ``prepare_offline`` called once,
  test phases through the device collector and through a
  ``HostCollector``.
"""

import dataclasses

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.ddpg import DDPG as JaxDDPG
from tianshou_tpu.algos.dqn import DQN as JaxDQN
from tianshou_tpu.algos.gail import GAIL as JaxGAIL
from tianshou_tpu.algos.icm import ICM as JaxICM
from tianshou_tpu.algos.icm import ICMNet as JaxICMNet
from tianshou_tpu.algos.offline import BC as JaxBC
from tianshou_tpu.algos.psrl import PSRL as JaxPSRL
from tianshou_tpu.collect.collector import Collector as JaxCollector
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.data.her import HERReplayBuffer as JaxHER
from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
from tianshou_tpu.envs.classic import CartPole as JaxCartPole
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.networks import common as jc
from tianshou_tpu.networks import continuous as jcont
from tianshou_tpu.trainer.offline import OfflineTrainer as JaxOfflineTrainer
from tianshou_tpu_torch.algos.ddpg import DDPG
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.algos.gail import GAIL
from tianshou_tpu_torch.algos.icm import ICM, ICMNet
from tianshou_tpu_torch.algos.offline import BC, CQL
from tianshou_tpu_torch.algos.psrl import PSRL
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.collect.host_collector import HostCollector
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.her import HERReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.envs.host import HostVectorEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.networks import common as tc
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks.convert import onpolicy_state_from_flax, params_from_flax
from tianshou_tpu_torch.trainer.offline import OfflineTrainer

HID, B, CAP, N_ENVS = (16, 16), 16, 16, 2
RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _recording(fn, log):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(lambda *v: log.append([np.asarray(x) for x in v]), *jax.tree.leaves(out), ordered=True)
        return out

    return wrapped


def _assert_module(module, flax_params, msg, heads=None):
    ref = params_from_flax(jax.device_get(flax_params), heads=heads)
    got = module.state_dict()
    assert set(got) == set(ref), msg
    for name in ref:
        _close(got[name], ref[name], msg=f"{msg} {name}")


def _fill(jbuf, tbuf, steps):
    jbs = jbuf.init(JaxBatch({k: jnp.asarray(v[0]) for k, v in steps[0].items()}))
    tbs = tbuf.init(Batch({k: _t(v[0]) for k, v in steps[0].items()}), device="cpu")
    for tr in steps:
        jbs = jbuf.add(jbs, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
        tbs = tbuf.add(tbs, Batch({k: _t(v) for k, v in tr.items()}))
    return jbs, tbs


# -- HER ----------------------------------------------------------------------------
TOL = 0.5


def _jax_reward(achieved, desired):
    return jnp.where(jnp.abs(achieved[:, 0] - desired[:, 0]) <= TOL, 0.0, -1.0)


def _torch_reward(achieved, desired):
    return torch.where((achieved[:, 0] - desired[:, 0]).abs() <= TOL, 0.0, -1.0)


def _goal_steps(n=40, seed=2):
    """Goal-style transitions ``[pos, achieved, desired]``, episodes of a
    few steps ended by ``terminated`` or ``truncated``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pos = rng.uniform(0, 8, N_ENVS).astype(np.float32)
        nxt = np.clip(pos + rng.uniform(-1, 1, N_ENVS), 0, 8).astype(np.float32)
        goal = rng.uniform(1, 8, N_ENVS).astype(np.float32)
        out.append(dict(obs=np.stack([pos, pos, goal], 1), act=rng.uniform(-1, 1, (N_ENVS, 1)).astype(np.float32),
                        rew=-np.ones(N_ENVS, np.float32) * rng.integers(0, 2, N_ENVS),
                        terminated=rng.random(N_ENVS) < 0.1, truncated=rng.random(N_ENVS) < 0.15,
                        obs_next=np.stack([nxt, nxt, goal], 1)))
    return out


def _her_pair(horizon=6):
    kw = dict(achieved_slice=(1, 2), desired_slice=(2, 3), horizon=horizon, future_k=4.0)
    jbuf = JaxHER(CAP, N_ENVS, compute_reward_fn=_jax_reward, **kw)
    tbuf = HERReplayBuffer(CAP, N_ENVS, compute_reward_fn=_torch_reward, **kw)
    jbs, tbs = _fill(jbuf, tbuf, _goal_steps())
    return jbuf, jbs, tbuf, tbs


def test_sample_her_matches_jax():
    jbuf, jbs, tbuf, tbs = _her_pair()
    slots, uniforms = [], []
    jbuf.sample_indices = _recording(jbuf.sample_indices, slots)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _recording(jax.random.uniform, uniforms))
        env_idx, pos, weight, ref = jax.jit(lambda bs, k: jbuf.sample_her(bs, k, B))(jbs, jax.random.key(3))
    jax.effects_barrier()
    (j_env, j_pos), ((u_future,), (u_rewrite,)) = slots[0], uniforms
    draws = (_t(j_env).long(), _t(j_pos).long(), _t(u_future), _t(u_rewrite))
    t_env, t_pos, t_weight, got = tbuf.sample_her(tbs, None, B, draws=draws)
    np.testing.assert_array_equal(t_env.numpy(), np.asarray(env_idx))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(pos))
    _close(t_weight, weight)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], rtol=0, atol=1e-6, msg=k)
    # some rows were relabelled, some kept their goal
    rewritten = u_rewrite < tbuf.future_p
    assert 0 < rewritten.sum() < B
    kept = ~rewritten
    _close(got["rew"][_t(kept)], tbs.storage["rew"][t_env, t_pos][_t(kept)], msg="kept rows' rewards")


def test_sample_her_offsets_stay_in_the_episode():
    """The future goal comes from the same episode, at most ``horizon - 1``
    steps ahead: every relabelled goal is the achieved goal of a slot on
    the saturating next chain."""
    _, _, tbuf, tbs = _her_pair(horizon=4)
    g = torch.Generator().manual_seed(0)
    env_idx, pos = tbuf.sample_indices(tbs, g, 256)
    u = torch.rand(256, generator=g)
    _, _, _, out = tbuf.sample_her(tbs, None, 256, draws=(env_idx, pos, u, torch.zeros(256)))
    reachable = []
    cur = pos
    for _ in range(4):
        reachable.append(tbs.storage["obs_next"][env_idx, cur][:, 1])
        cur = tbuf.next_pos(tbs, env_idx, cur)
    hit = (torch.stack(reachable, 1) == out["obs"][:, 2:3]).any(dim=1)
    assert bool(hit.all())


def test_ddpg_update_from_her_presample_matches_jax():
    jbuf, jbs, tbuf, tbs = _her_pair()
    kw = dict(actor_lr=1e-2, critic_lr=1e-2, gamma=0.9, tau=0.05)
    jalgo = JaxDDPG(jcont.DeterministicActor(HID, 1), jcont.CriticEnsemble(HID, 1), JaxBox(-1.0, 1.0, (1,)), **kw)
    talgo = DDPG(tcont.DeterministicActor(3, HID, 1), tcont.CriticEnsemble(3, 1, HID, 1), Box(-1.0, 1.0, (1,)),
                 device="cpu", **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((3,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    for attr in ("actor", "critic", "target_actor", "target_critic"):
        getattr(tts, attr).load_state_dict(params_from_flax(jax.device_get(getattr(jts, f"{attr}_params"))))
    slots, uniforms = [], []
    jbuf.sample_indices = _recording(jbuf.sample_indices, slots)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _recording(jax.random.uniform, uniforms))
        jts, _, jm = jax.jit(lambda ts, bs, k: jalgo.update(ts, jbuf, bs, k, B))(jts, jbs, jax.random.key(4))
    jax.effects_barrier()
    (j_env, j_pos), ((u_future,), (u_rewrite,)) = slots[0], uniforms
    draws = (_t(j_env).long(), _t(j_pos).long(), _t(u_future), _t(u_rewrite))
    tbuf.sample_her = lambda st, g, b: HERReplayBuffer.sample_her(tbuf, st, g, b, draws=draws)
    sampled = talgo.presample(tbuf, tbs, None, B)
    assert set(sampled[3]) == {"obs", "act", "rew", "obs_next", "terminated", "truncated"}
    tts, _, tm = talgo.update_sampled(tts, tbuf, tbs, sampled)
    for k in jm:
        _close(tm[k], jm[k], msg=k)
    for attr in ("actor", "critic", "target_actor", "target_critic"):
        _assert_module(getattr(tts, attr), getattr(jts, f"{attr}_params"), attr)


def test_her_needs_one_step_targets():
    _, _, tbuf, tbs = _her_pair()
    talgo = DDPG(tcont.DeterministicActor(3, HID, 1), tcont.CriticEnsemble(3, 1, HID, 1), Box(-1.0, 1.0, (1,)),
                 n_step=3, device="cpu")
    with pytest.raises(ValueError, match="1-step"):
        talgo.presample(tbuf, tbs, torch.Generator().manual_seed(0), B)


# -- ICM ----------------------------------------------------------------------------
def _discrete_steps(obs_dim=4, n_act=3, n=40, seed=5):
    rng = np.random.default_rng(seed)
    return [dict(obs=rng.normal(size=(N_ENVS, obs_dim)).astype(np.float32),
                 act=rng.integers(0, n_act, N_ENVS).astype(np.int32), rew=rng.normal(size=N_ENVS).astype(np.float32),
                 terminated=rng.random(N_ENVS) < 0.1, truncated=rng.random(N_ENVS) < 0.05,
                 obs_next=rng.normal(size=(N_ENVS, obs_dim)).astype(np.float32)) for _ in range(n)]


def test_icm_two_updates_match_jax():
    dqn_kw = dict(lr=1e-2, gamma=0.9, n_step=1, target_update_freq=2)
    icm_kw = dict(lr=1e-2, reward_scale=0.5, forward_loss_weight=0.2)
    jalgo = JaxICM(JaxDQN(jc.QNet(HID, 3), JaxDiscrete(3), **dqn_kw), JaxICMNet((16,), 8, 3), **icm_kw)
    talgo = ICM(DQN(tc.QNet(4, HID, 3), Discrete(3), device="cpu", **dqn_kw), ICMNet(4, (16,), 8, 3), **icm_kw)
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS)
    jbs, tbs = _fill(jbuf, tbuf, _discrete_steps())
    jts = jalgo.init(jax.random.key(0), jnp.zeros((4,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.icm.load_state_dict(params_from_flax(jax.device_get(jts.icm_params)))
    for mod in (tts.inner.online, tts.inner.target):
        mod.load_state_dict(params_from_flax(jax.device_get(jts.inner.params)))
    draws = []
    jbuf.sample_with_weights = _recording(jbuf.sample_with_weights, draws)
    update = jax.jit(lambda ts, bs, k: jalgo.update(ts, jbuf, bs, k, B))
    for step in (1, 2):
        del draws[:]
        jts, _, jm = update(jts, jbs, jax.random.key(step))
        jax.effects_barrier()
        assert len(draws) == 2  # the curiosity batch, then the inner update's
        queue = [(_t(e).long(), _t(p).long(), _t(w)) for e, p, w in draws]
        tbuf.sample_with_weights = lambda st, g, b: queue.pop(0)
        tts, _, tm = talgo.update(tts, tbuf, tbs, None, B)
        assert set(tm) == set(jm) and {"icm_loss", "icm_forward", "icm_inverse", "loss"} <= set(tm)
        for k in jm:
            _close(tm[k], jm[k], msg=f"step {step} {k}")
        _assert_module(tts.icm, jts.icm_params, f"step {step} icm")
        _assert_module(tts.inner.online, jts.inner.params, f"step {step} online")
        _assert_module(tts.inner.target, jts.inner.target_params, f"step {step} target")
        assert tts.step == int(jts.step) == step


def test_icm_view_holds_no_ring_and_needs_one_step():
    from tianshou_tpu_torch.algos.icm import _ICMBufferView

    tbuf = ReplayBuffer(CAP, N_ENVS)
    _, tbs = _fill(JaxReplayBuffer(CAP, N_ENVS), tbuf, _discrete_steps())
    algo = ICM(DQN(tc.QNet(4, HID, 3), Discrete(3), device="cpu"), ICMNet(4, (16,), 8, 3))
    ts = algo.init(torch.Generator().manual_seed(0))
    view = _ICMBufferView(tbuf, algo, ts.icm)
    assert not any(isinstance(v, torch.Tensor) for v in vars(view).values())
    env_idx, pos = torch.tensor([0, 1]), torch.tensor([3, 4])
    rew, _, _ = view.nstep_chain(tbs, env_idx, pos, 1)
    base, _, _ = tbuf.nstep_chain(tbs, env_idx, pos, 1)
    assert bool((rew > base).all())  # a positive bonus on every row
    with pytest.raises(ValueError, match="one-step"):
        view.nstep_chain(tbs, env_idx, pos, 3)


# -- GAIL ---------------------------------------------------------------------------
def test_gail_pre_learn_and_reward_rewrite_match_jax():
    T, N = 8, 4
    rng = np.random.default_rng(11)
    steps = [dict(obs=rng.normal(size=(N_ENVS, 3)).astype(np.float32),
                  act=rng.uniform(-1, 1, (N_ENVS, 1)).astype(np.float32), rew=rng.normal(size=N_ENVS).astype(np.float32),
                  terminated=np.zeros(N_ENVS, bool), truncated=rng.random(N_ENVS) < 0.1,
                  obs_next=rng.normal(size=(N_ENVS, 3)).astype(np.float32)) for _ in range(20)]
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS)
    jbs, tbs = _fill(jbuf, tbuf, steps)
    kw = dict(disc_lr=1e-2, disc_update_num=2, lr=1e-3, gamma=0.95, gae_lambda=0.95, max_grad_norm=0.5, ent_coef=0.0)
    jalgo = JaxGAIL(jcont.GaussianActor(HID, 1), jcont.ValueNet(HID), JaxBox(-1.0, 1.0, (1,)),
                    disc_net=jcont.Critic(HID), expert_buffer=jbuf, expert_buffer_state=jbs, **kw)
    talgo = GAIL(tcont.GaussianActor(3, HID, 1), tcont.ValueNet(3, HID), Box(-1.0, 1.0, (1,)),
                 disc_net=tcont.Critic(3, 1, HID), expert_buffer=tbuf, expert_buffer_state=tbs, device="cpu", **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((3,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.load(onpolicy_state_from_flax(jax.device_get(jts), actor_heads=("mu",)))
    tts.disc.load_state_dict(params_from_flax(jax.device_get(jts.disc_params)))
    traj = dict(obs=rng.normal(size=(T, N, 3)).astype(np.float32), act=rng.normal(size=(T, N, 1)).astype(np.float32),
                rew=rng.normal(size=(T, N)).astype(np.float32), terminated=rng.random((T, N)) < 0.05,
                truncated=rng.random((T, N)) < 0.05, obs_next=rng.normal(size=(T, N, 3)).astype(np.float32))
    logp = (rng.normal(size=(T, N)) - 1).astype(np.float32)
    jtraj = JaxBatch({**{k: jnp.asarray(v) for k, v in traj.items()}, "policy": JaxBatch(log_prob=jnp.asarray(logp))})
    ttraj = Batch({**{k: _t(v) for k, v in traj.items()}, "policy": Batch(log_prob=_t(logp))})

    rows, slots = [], []
    jbuf.sample_with_weights = _recording(jbuf.sample_with_weights, slots)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", _recording(jax.random.randint, rows))
        jts, jm = jax.jit(lambda ts, k: jalgo.pre_learn(ts, jtraj, k))(jts, jax.random.key(7))
    jax.effects_barrier()
    # a step draws its rollout rows, then the expert sample (whose own
    # randint is recorded too)
    assert len(rows) == 4 and len(slots) == 2
    draws = [(_t(r[0]).long(), _t(s[0]).long(), _t(s[1]).long()) for r, s in zip(rows[0::2], slots)]
    tts, tm = talgo.pre_learn(tts, ttraj, None, draws=draws)
    assert set(tm) == set(jm) == {"disc_loss", "acc_pi", "acc_exp"}
    for k in jm:
        _close(tm[k], jm[k], msg=k)
        assert isinstance(tm[k], torch.Tensor)
    _assert_module(tts.disc, jts.disc_params, "disc")

    ref = jalgo.process_rollout(jts, jtraj)
    got = talgo.process_rollout(tts, ttraj)
    assert set(got) <= set(ref)
    for k in got:
        _close(got[k], ref[k], msg=f"processed {k}")
    # the reward that GAE read is the discriminator's, not the env's
    with torch.no_grad():
        fake = torch.nn.functional.softplus(tts.disc(ttraj["obs"].flatten(0, 1), ttraj["act"].flatten(0, 1)))
    plain = super(GAIL, talgo).process_rollout(tts, Batch({**ttraj, "rew": fake.reshape(T, N)}))
    _close(got["adv"], plain["adv"], rtol=0, atol=0)


# -- PSRL ---------------------------------------------------------------------------
S, A = 5, 2


def test_psrl_learn_matches_jax():
    rng = np.random.default_rng(3)
    M = 40
    mb = dict(obs=rng.integers(0, S, (M, 1)).astype(np.int32), act=rng.integers(0, A, M).astype(np.int32),
              rew=rng.normal(size=M).astype(np.float32), obs_next=rng.integers(0, S, (M, 1)).astype(np.int32))
    jalgo, talgo = JaxPSRL(S, JaxDiscrete(A), gamma=0.9, vi_iters=50), PSRL(S, Discrete(A), gamma=0.9, vi_iters=50,
                                                                           device="cpu")
    jts = jalgo.init(jax.random.key(0), None)
    tts = talgo.init(torch.Generator().manual_seed(0))
    draws = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "dirichlet", _recording(jax.random.dirichlet, draws))
        jts, jm = jax.jit(lambda ts: jalgo.learn(ts, JaxBatch({k: jnp.asarray(v) for k, v in mb.items()}), None))(jts)
    jax.effects_barrier()
    ((P,),) = draws
    tts, tm = talgo.learn(tts, Batch({k: _t(v) for k, v in mb.items()}), transitions=_t(P))
    for name in ("trans_counts", "rew_count"):
        np.testing.assert_array_equal(getattr(tts, name).numpy(), np.asarray(getattr(jts, name)), err_msg=name)
    _close(tts.rew_sum, jts.rew_sum, rtol=1e-5, atol=1e-6, msg="rew_sum")
    _close(tts.value_table, jts.value_table, rtol=1e-5, atol=1e-5, msg="value_table")
    np.testing.assert_array_equal(tts.policy_table.numpy(), np.asarray(jts.policy_table))
    _close(tm["value_mean"], jm["value_mean"], rtol=1e-5)
    assert tts.step == int(jts.step) == 1
    # acting reads the planned table
    obs = torch.arange(S)[:, None]
    np.testing.assert_array_equal(talgo.act(tts, obs, None, explore=False).numpy(), np.asarray(jts.policy_table))


def test_psrl_dirichlet_draw_has_the_posterior_moments():
    """``torch._sample_dirichlet`` with the state's generator: rows on the
    simplex, means ``a_i / a_0`` and variances ``a_i (a_0 - a_i) / (a_0^2
    (a_0 + 1))`` within 4 standard errors over 20,000 draws; the same
    generator seed repeats the draw."""
    conc = torch.tensor([[0.5, 1.0, 3.0], [4.0, 4.0, 0.2]])
    n = 20_000
    draws = torch._sample_dirichlet(conc.expand(n, 2, 3).contiguous(), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(draws.sum(-1), torch.ones(n, 2))
    a0 = conc.sum(-1, keepdim=True)
    mean, var = conc / a0, conc * (a0 - conc) / (a0**2 * (a0 + 1))
    se_mean = torch.sqrt(var / n)
    assert bool(((draws.mean(0) - mean).abs() < 4 * se_mean).all())
    fourth = ((draws - mean) ** 4).mean(0)
    se_var = torch.sqrt((fourth - var**2) / n)
    assert bool(((draws.var(0) - var).abs() < 4 * se_var).all())
    again = torch._sample_dirichlet(conc.expand(n, 2, 3).contiguous(), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, draws)


def test_psrl_state_has_no_parameters_and_explores():
    talgo = PSRL(S, Discrete(A), eps_explore=0.5, device="cpu")
    tts = talgo.init(torch.Generator().manual_seed(0))
    assert not any(isinstance(v, torch.nn.Module) for v in vars(tts).values())
    a = talgo.act(tts, torch.zeros(4000, 1, dtype=torch.int32), torch.Generator().manual_seed(1), explore=True)
    assert 0.2 < float(a.float().mean()) < 0.3  # half random over 2 actions, the table's 0 otherwise


# -- the offline trainer ----------------------------------------------------------
def _cartpole_ring():
    steps = [dict(obs=np.random.default_rng(i).normal(size=(N_ENVS, 4)).astype(np.float32) * 0.05,
                  act=np.asarray([i % 2, (i + 1) % 2], np.int32), rew=np.ones(N_ENVS, np.float32),
                  terminated=np.zeros(N_ENVS, bool), truncated=np.zeros(N_ENVS, bool),
                  obs_next=np.random.default_rng(i + 100).normal(size=(N_ENVS, 4)).astype(np.float32) * 0.05)
             for i in range(20)]
    return _fill(JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS), steps)


@pytest.mark.parametrize("stop", [False, True])
def test_offline_trainer_accounting_matches_jax(stop):
    jbs, tbs = _cartpole_ring()
    kw = dict(max_epoch=3, update_per_epoch=30, batch_size=8, episode_per_test=2, updates_per_superstep=10,
              stop_fn=(lambda r: True) if stop else None)
    jalgo = JaxBC(jc.QNet(HID, 2), JaxDiscrete(2))
    jinfo = JaxOfflineTrainer(jalgo, JaxReplayBuffer(CAP, N_ENVS), jbs, JaxCollector(jalgo, JaxVectorEnv(
        JaxCartPole(), 2)), **kw).run()
    talgo = BC(tc.QNet(4, HID, 2), Discrete(2), device="cpu")
    calls = []
    talgo.prepare_offline = lambda buffer, bstate: calls.append(1) or bstate
    trainer = OfflineTrainer(talgo, ReplayBuffer(CAP, N_ENVS), tbs, Collector(talgo, VectorEnv(
        CartPole(), 2, device="cpu"), device="cpu"), device="cpu", **kw)
    update = talgo.update
    updates = []
    talgo.update = lambda *a, **k: updates.append(1) or update(*a, **k)
    info = trainer.run()
    for name in ("gradient_step", "env_step", "epoch", "stop_triggered"):
        assert getattr(info, name) == getattr(jinfo, name), name
    assert info.env_step == info.gradient_step * 8 == (30 if stop else 90) * 8
    assert calls == [1] and len(updates) == info.gradient_step
    assert set(info.last_metrics) == set(jinfo.last_metrics) == {"loss"}
    assert np.isfinite(info.best_reward) and info.train_time > 0


def test_offline_trainer_tests_through_a_host_collector():
    """CQL, with its ``prepare_offline`` (CalQL), tested through a
    ``HostCollector`` over gymnasium's Pendulum."""
    rng = np.random.default_rng(0)
    data = {"observations": rng.normal(size=(64, 3)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (64, 1)).astype(np.float32), "rewards": rng.normal(size=64),
            "terminals": np.zeros(64, bool), "timeouts": np.arange(64) % 16 == 15,
            "next_observations": rng.normal(size=(64, 3)).astype(np.float32)}
    from tianshou_tpu_torch.data.persistence import buffer_from_d4rl

    buf, bs = buffer_from_d4rl(data, device="cpu")
    algo = CQL(tcont.GaussianActor(3, HID, 1, conditioned_sigma=True), tcont.CriticEnsemble(3, 1, HID),
               Box(-2.0, 2.0, (1,)), num_repeat_actions=2, calibrated=True, device="cpu")
    test = HostCollector(algo, HostVectorEnv([lambda: gym.make("Pendulum-v1")] * 2), device="cpu")
    trainer = OfflineTrainer(algo, buf, bs, test, max_epoch=2, update_per_epoch=4, batch_size=8,
                             updates_per_superstep=2, episode_per_test=2, device="cpu")
    info = trainer.run()
    test.venv.close()
    assert (info.gradient_step, info.env_step, info.epoch) == (8, 64, 2)
    assert -2000 < info.best_reward < 0  # two Pendulum episodes of 200 steps
    assert {"critic_loss", "cql_penalty", "cql_alpha", "alpha"} <= set(info.last_metrics)
    assert "calibration_return" not in bs.storage  # prepared into a new state


def test_offline_trainer_rejects_a_state_on_another_device():
    _, tbs = _cartpole_ring()
    algo = BC(tc.QNet(4, HID, 2), Discrete(2), device="cpu")
    col = Collector(algo, VectorEnv(CartPole(), 2, device="cpu"), device="cpu")
    moved = dataclasses.replace(tbs, cursor=tbs.cursor.to("meta"))
    with pytest.raises(ValueError, match="buffer state"):
        OfflineTrainer(algo, ReplayBuffer(CAP, N_ENVS), moved, col, max_epoch=1, update_per_epoch=1, device="cpu")
