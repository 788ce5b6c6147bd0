"""Every algorithm's ``priority_scores`` in the port against the JAX
package, and the contracts the distributed trainer builds on, on the CPU
in float32 at the small sizes of the families' own test files.

- For DQN, C51, Rainbow, QRDQN, IQN, FQF, DDPG, TD3, SAC, DiscreteSAC and
  REDQ: weights carried over by ``networks/convert.py``, the same sampled
  batch made with numpy, the JAX call's own draws (Rainbow's noise, IQN's
  fractions, TD3's and SAC's normals, REDQ's normals and subset) recorded
  or recomputed from its key and injected: rtol 1e-5 / atol 1e-6.
- The shard contract (``tests/test_distributed.py``'s
  ``test_iqn_fqf_priority_scores_shard_exact``): IQN and FQF on a
  prioritized CartPole ring, two shards at their ``row_offset`` recompute
  bitwise the priorities the full-batch update wrote into the tree, from
  the update generator's state; and its
  ``test_priority_scores_exact_for_sampling_targets`` for SAC.
- The base class raises; both packages' distributed trainers refuse an
  algorithm without ``priority_scores`` under prioritized replay
  (``TypeError``); PER write-back through the port's distributed trainer,
  one process; the distributional family's scores
  (``test_distributed_per_priority_scores_distributional``).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu_torch.algos.base import Algorithm
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole, Pendulum
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.convert import params_from_flax
from tianshou_tpu_torch.trainer.distributed import DistributedOffPolicyTrainer

import test_torch_continuous as cont
import test_torch_distributional as distr
import test_torch_ensembles as ens


def _close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=1e-6, err_msg=msg)


def _dqn_pair():
    from tianshou_tpu.algos.dqn import DQN as JaxDQN
    from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
    from tianshou_tpu.networks.common import QNet as JaxQNet
    from tianshou_tpu_torch.envs.spaces import Discrete

    kw = dict(gamma=0.9, n_step=distr.N_STEP, target_update_freq=2)
    jalgo = JaxDQN(JaxQNet(distr.HID, distr.A), JaxDiscrete(distr.A), **kw)
    talgo = DQN(QNet(distr.OBS, distr.HID, distr.A), Discrete(distr.A), device="cpu", **kw)
    return jalgo, talgo, None


def _discrete_pair(kind):
    """``(jax algo, jax state, port algo, port state, sampled pair)`` of the
    DQN family, the target net a step behind the online net so that the
    two differ."""
    jalgo, talgo, heads = _dqn_pair() if kind == "dqn" else distr._make(kind)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((distr.OBS,), jnp.float32))
    jts = jts.replace(target_params=jalgo.init(jax.random.key(5), jnp.zeros((distr.OBS,), jnp.float32)).params)
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.online.load_state_dict(params_from_flax(jax.device_get(jts.params), heads=heads))
    tts.target.load_state_dict(params_from_flax(jax.device_get(jts.target_params), heads=heads))
    if kind == "fqf":
        tts.fraction.load_state_dict(params_from_flax(jax.device_get(jts.fraction_params), heads=("head",)))
    sampled = distr._quantile_sampled(3) if kind in ("qrdqn", "iqn", "fqf") else distr._dqn_sampled(3)
    return jalgo, jts, talgo, tts, sampled


def _redq_pair():
    from tianshou_tpu.algos.redq import REDQ as JaxREDQ
    from tianshou_tpu.envs.spaces import Box as JaxBox
    from tianshou_tpu.networks import continuous as jcont
    from tianshou_tpu_torch.algos.redq import REDQ
    from tianshou_tpu_torch.envs.spaces import Box
    from tianshou_tpu_torch.networks import continuous as tcont

    common = dict(gamma=0.9, tau=0.05, n_step=ens.N_STEP, ensemble_size=5, subset_size=2, auto_alpha=True)
    jalgo = JaxREDQ(jcont.GaussianActor(ens.HID, 2, conditioned_sigma=True), jcont.CriticEnsemble(ens.HID, 5),
                    JaxBox(low=-1.0, high=1.0, shape=(2,)), **common)
    talgo = REDQ(tcont.GaussianActor(ens.OBS, ens.HID, 2, conditioned_sigma=True),
                 tcont.CriticEnsemble(ens.OBS, 2, ens.HID, 5), Box(low=-1.0, high=1.0, shape=(2,)), device="cpu",
                 **common)
    return jalgo, talgo, ens.GAUSS_HEADS, ens._sampled_pair(3, "box")


def _discrete_sac_pair():
    from tianshou_tpu.algos.sac import DiscreteSAC as JaxDiscreteSAC
    from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
    from tianshou_tpu.networks import common as jc
    from tianshou_tpu_torch.algos.sac import DiscreteSAC
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks import common as tc

    common = dict(gamma=0.9, tau=0.05, n_step=ens.N_STEP)
    jalgo = JaxDiscreteSAC(jc.QNet(ens.HID, 4), jc.QNetEnsemble(ens.HID, 4, num_critics=2), JaxDiscrete(4), **common)
    talgo = DiscreteSAC(tc.QNet(ens.OBS, ens.HID, 4), tc.QNetEnsemble(ens.OBS, ens.HID, 4, 2), Discrete(4),
                        device="cpu", **common)
    return jalgo, talgo, None, ens._sampled_pair(3, "discrete")


def _actor_critic_pair(kind):
    """``(jax algo, jax state, port algo, port state, sampled pair)`` of the
    actor-critic families, the target critic moved off the online one."""
    if kind in ("ddpg", "td3", "sac"):
        jalgo, jts, talgo, tts = cont._algo_pair(kind)
        heads, sampled = cont._actor_heads(kind), cont._sampled_pair(3)
    else:
        jalgo, talgo, heads, sampled = _redq_pair() if kind == "redq" else _discrete_sac_pair()
        obs = ens.OBS
        jts = jalgo.init(jax.random.key(0), jnp.zeros((obs,), jnp.float32))
        tts = talgo.init(torch.Generator().manual_seed(0))
    obs_dim = cont.OBS if kind in ("ddpg", "td3", "sac") else ens.OBS
    other = jalgo.init(jax.random.key(7), jnp.zeros((obs_dim,), jnp.float32))
    jts = jts.replace(target_critic_params=other.critic_params)
    if tts.log_alpha is not None:
        jts = jts.replace(log_alpha=jnp.asarray(np.log(0.3), jnp.float32))
    if kind in ("ddpg", "td3", "sac"):
        cont._carry(kind, jts, tts)
    else:
        ens._load_ac(jts, tts, heads)
    return jalgo, jts, talgo, tts, sampled


KINDS = ["dqn", "c51", "rainbow", "qrdqn", "iqn", "fqf", "ddpg", "td3", "sac", "discrete_sac", "redq"]


@pytest.mark.parametrize("kind", KINDS)
def test_priority_scores_match_jax(kind, monkeypatch):
    key = jax.random.key(42)
    if kind in ("dqn", "c51", "rainbow", "qrdqn", "iqn", "fqf"):
        jalgo, jts, talgo, tts, (js, ts_) = _discrete_pair(kind)
    else:
        jalgo, jts, talgo, tts, (js, ts_) = _actor_critic_pair(kind)
    extra = {}
    if kind == "rainbow":
        rec = distr._RecordNormals(monkeypatch)
        jscores = jalgo.priority_scores(jts, js, key)
        jax.effects_barrier()
        assert len(rec.draws) == 24
        extra = dict(noise=(rec.pairs(0, 4), rec.pairs(8, 4)))
    elif kind == "iqn":
        taus = []
        jalgo._rowwise_taus = distr._recording(jalgo._rowwise_taus, taus)
        jscores = jalgo.priority_scores(jts, js, key)
        jax.effects_barrier()
        tau_t, tau_dbl, tau_onl = map(distr._t, taus)  # the JAX call's order
        extra = dict(taus=(tau_t, tau_onl, tau_dbl))
    elif kind == "redq":
        normals, perms = [], []
        monkeypatch.setattr(jax.random, "normal", distr._recording(jax.random.normal, normals))
        monkeypatch.setattr(jax.random, "permutation", distr._recording(jax.random.permutation, perms))
        jscores = jalgo.priority_scores(jts, js, key)
        jax.effects_barrier()
        assert len(normals) == 1 and len(perms) == 1
        extra = dict(noise=(distr._t(normals[0]), torch.zeros(ens.B, 2)), subset=distr._t(perms[0][:2]))
    else:
        jscores = jalgo.priority_scores(jts, js, key)
        if kind in ("td3", "sac"):
            extra = dict(noise=cont._jax_noise(kind, key))
    tscores = talgo.priority_scores(tts, ts_, **extra)
    assert tscores.shape == jscores.shape and bool((tscores >= 0).all())
    _close(tscores, jscores, msg=kind)
    assert float(tscores.std()) > 0


def _per_ring(algo, env, num_envs=2, capacity=64, steps=20, alpha=0.6):
    buf = PrioritizedReplayBuffer(capacity, num_envs, alpha=alpha)
    col = Collector(algo, VectorEnv(env, num_envs, device="cpu"), buf, device="cpu")
    cstate = col.reset(torch.Generator().manual_seed(0))
    ts = algo.init(torch.Generator().manual_seed(1))
    bst = buf.init(col.example_transition(ts, cstate), device="cpu")
    _, bst, _, _ = col.collect(ts, cstate, bst, steps)
    return buf, bst, ts


def _written_equals(buf, bst, sampled, update_gen_state, recompute, algo, ts):
    """Run the full-batch update from ``update_gen_state``; compare the tree
    it writes with the one ``recompute(ts_pre, generator factory)`` gives,
    at the slots drawn once, bitwise.  Returns the slots compared."""
    ts_pre = copy.deepcopy(ts)
    before = dataclasses.replace(bst, tree=bst.tree.clone())
    g = torch.Generator()
    g.set_state(update_gen_state)
    _, written, _ = algo.update_sampled(ts, buf, bst, sampled, g)

    def fresh():
        gen = torch.Generator()
        gen.set_state(update_gen_state)
        return gen

    expected = buf.update_priorities(before, sampled[0], sampled[1], recompute(ts_pre, fresh))
    flat = (sampled[0] * buf.capacity + sampled[1]).tolist()
    unique = [f for f in flat if flat.count(f) == 1]
    pow2 = written.tree.shape[0] // 2
    idx = torch.tensor(unique) + pow2
    assert torch.equal(written.tree[idx], expected.tree[idx])
    return len(unique)


@pytest.mark.parametrize("kind", ["iqn", "fqf"])
def test_iqn_fqf_priority_scores_shard_exact(kind):
    from tianshou_tpu_torch.algos.qrdqn import FQF, IQN
    from tianshou_tpu_torch.networks.discrete import (
        FractionProposalNetwork,
        FullQuantileFunction,
        ImplicitQuantileNetwork,
    )

    env = CartPole()
    if kind == "iqn":
        algo = IQN(ImplicitQuantileNetwork(4, (32,), 2), env.action_space, n_step=2, device="cpu")
    else:
        algo = FQF(FullQuantileFunction(4, (32,), 2), FractionProposalNetwork(32, 8), env.action_space,
                   num_fractions=8, n_step=2, device="cpu")
    buf, bst, ts = _per_ring(algo, env)
    big = 16
    sampled = algo.presample(buf, bst, torch.Generator().manual_seed(9), big)
    half = big // 2

    def shards(ts_pre, fresh):
        return torch.cat([algo.priority_scores(ts_pre, tree_map(lambda x: x[p * half:(p + 1) * half], sampled),
                                               fresh(), row_offset=p * half, global_rows=big) for p in range(2)])

    state = torch.Generator().manual_seed(10).get_state()
    assert _written_equals(buf, bst, sampled, state, shards, algo, ts) >= 8


def test_priority_scores_exact_for_sampling_targets():
    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor

    env = Pendulum()
    sac = SAC(GaussianActor(3, (16, 16), 1, conditioned_sigma=True), CriticEnsemble(3, 1, (16, 16), 2),
              env.action_space, device="cpu")
    buf, bst, ts = _per_ring(sac, env, alpha=0.7)
    sampled = sac.presample(buf, bst, torch.Generator().manual_seed(9), 16)
    state = torch.Generator().manual_seed(10).get_state()
    n = _written_equals(buf, bst, sampled, state, lambda ts_pre, fresh: sac.priority_scores(ts_pre, sampled, fresh()),
                        sac, ts)
    assert n >= 8


class _NoScores(DQN):
    priority_scores = Algorithm.priority_scores


def test_priority_scores_base_raises_and_trainers_refuse_per_without_it():
    from tianshou_tpu.algos.base import Algorithm as JaxAlgorithm
    from tianshou_tpu.algos.dqn import DQN as JaxDQN
    from tianshou_tpu.collect.collector import Collector as JaxCollector
    from tianshou_tpu.data.prio import PrioritizedReplayBuffer as JaxPER
    from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
    from tianshou_tpu.envs.classic import CartPole as JaxCartPole
    from tianshou_tpu.networks.common import QNet as JaxQNet
    from tianshou_tpu.trainer.distributed import DistributedOffPolicyTrainer as JaxTrainer

    env = CartPole()
    algo = _NoScores(QNet(4, (8,), 2), env.action_space, device="cpu")
    with pytest.raises(NotImplementedError, match="priority_scores"):
        algo.priority_scores(None, None)
    buf = PrioritizedReplayBuffer(16, 2)
    trainer = DistributedOffPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, 2, device="cpu"), buf, device="cpu"),
        Collector(algo, VectorEnv(env, 2, device="cpu"), device="cpu"), buf, max_epoch=1, step_per_epoch=4,
        step_per_collect=4, batch_size=4, device="cpu")
    with pytest.raises(TypeError, match="does not implement priority_scores"):
        trainer.run()

    class JaxNoScores(JaxDQN):
        priority_scores = JaxAlgorithm.priority_scores

    jenv = JaxCartPole()
    jalgo = JaxNoScores(JaxQNet((8,), 2), jenv.action_space)
    jbuf = JaxPER(capacity=16, num_envs=2)
    jtrainer = JaxTrainer(jalgo, JaxCollector(jalgo, JaxVectorEnv(jenv, 2), jbuf), JaxCollector(jalgo, JaxVectorEnv(
        jenv, 2)), jbuf, max_epoch=1, step_per_epoch=4, step_per_collect=4, batch_size=4)
    with pytest.raises(TypeError, match="does not implement priority_scores"):
        jtrainer.run()


def test_distributed_trainer_per_writeback_single_process():
    torch.set_num_threads(1)
    env = CartPole()
    algo = DQN(QNet(4, (32, 32), 2), env.action_space, lr=1e-3, gamma=0.9, n_step=3, target_update_freq=100,
               device="cpu")
    buffer = PrioritizedReplayBuffer(200, 4, alpha=0.6, beta=0.4)
    trainer = DistributedOffPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, 4, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 4, device="cpu"), device="cpu"), buffer, max_epoch=1, step_per_epoch=64,
        step_per_collect=16, update_per_step=0.25, batch_size=16, episode_per_test=2, warmup_steps=64, seed=0,
        device="cpu")
    info = trainer.run()
    assert info.gradient_step >= 4
    tree = trainer.buffer_state.tree
    pow2 = tree.shape[0] // 2
    leaves = tree[pow2:pow2 + 200 * 4]
    filled = leaves[leaves > 0]
    assert filled.numel() > 0 and float(filled.std()) > 1e-6


def test_distributed_per_priority_scores_distributional():
    from tianshou_tpu_torch.algos.c51 import C51
    from tianshou_tpu_torch.algos.qrdqn import IQN, QRDQN
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.networks.discrete import C51Net, ImplicitQuantileNetwork, QRDQNNet

    env = CartPole()

    def filled(algo):
        buf = ReplayBuffer(64, 4)
        col = Collector(algo, VectorEnv(env, 4, device="cpu"), buf, device="cpu")
        cstate = col.reset(torch.Generator().manual_seed(0))
        ts = algo.init(torch.Generator().manual_seed(1))
        bst = buf.init(col.example_transition(ts, cstate), device="cpu")
        _, bst, _, _ = col.collect(ts, cstate, bst, 16)
        return buf, bst, ts

    c51 = C51(C51Net(4, (32,), 2, num_atoms=17), env.action_space, num_atoms=17, n_step=2, device="cpu")
    buf, bst, ts = filled(c51)
    sampled = c51.presample(buf, bst, torch.Generator().manual_seed(2), 8)
    scores = c51.priority_scores(ts, sampled)
    assert scores.shape == (8,) and bool((scores >= 0).all())
    # the cross-entropy the update writes back, not a Q-space |TD|
    _, written, _ = c51.update_sampled(copy.deepcopy(ts), distr._PriorityEcho, None, sampled, torch.Generator())
    assert torch.equal(written, scores)

    qr = QRDQN(QRDQNNet(4, (32,), 2, 8), env.action_space, num_quantiles=8, n_step=2, device="cpu")
    buf, bst, ts = filled(qr)
    scores = qr.priority_scores(ts, qr.presample(buf, bst, torch.Generator().manual_seed(3), 8))
    assert scores.shape == (8,) and bool((scores >= 0).all())

    iqn = IQN(ImplicitQuantileNetwork(4, (32,), 2), env.action_space, n_step=2, device="cpu")
    buf, bst, ts = filled(iqn)
    scores = iqn.priority_scores(ts, iqn.presample(buf, bst, torch.Generator().manual_seed(4), 8),
                                 torch.Generator().manual_seed(5))
    assert scores.shape == (8,) and bool((scores >= 0).all())
