"""The ensemble and branching nets of the port and the algorithms that use
them (tianshou_tpu_torch: networks/common QNetEnsemble, EnsembleMLP,
BranchingQNet; algos/redq REDQ, algos/sac DiscreteSAC, algos/bdq BDQ)
against the JAX package, on the CPU in float32 at a small size (obs 3,
hidden (32, 32), batch 16).

- Forwards with weights carried by params_from_flax, atol 1e-5.
- The JAX package's own behaviour tests of these nets
  (tests/test_networks.py ``test_ensembles_have_independent_members`` and
  ``test_branching_qnet_shape``), on the port's nets.
- Two updates each of REDQ (5 critics, subset 2, actor delay 2, so the
  actor steps in the second update only), DiscreteSAC and BDQ from the
  same parameters and batches: REDQ's normals and subset permutation are
  recorded from the JAX update (an ordered ``jax.debug.callback``) and
  injected.  Metrics, every parameter (actor, critics, targets, log_alpha)
  and the priorities each update writes back within rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.bdq import BDQ as JaxBDQ
from tianshou_tpu.algos.redq import REDQ as JaxREDQ
from tianshou_tpu.algos.sac import DiscreteSAC as JaxDiscreteSAC
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.envs.spaces import MultiDiscrete as JaxMultiDiscrete
from tianshou_tpu.networks import common as jc
from tianshou_tpu.networks import continuous as jcont
from tianshou_tpu_torch.algos.bdq import BDQ
from tianshou_tpu_torch.algos.redq import REDQ
from tianshou_tpu_torch.algos.sac import DiscreteSAC
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete
from tianshou_tpu_torch.networks import common as tc
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks.convert import params_from_flax

OBS, HID, B, N_STEP = 3, (32, 32), 16, 2
GAUSS_HEADS = ("mu", "sigma")


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _recording(fn, log):
    """``fn`` that also appends each of its outputs, as numpy, to ``log``,
    in call order, inside ``jax.jit`` too (an ordered callback)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(lambda v: log.append(np.asarray(v)), out, ordered=True)
        return out

    return wrapped


def _obs(n=9, seed=4):
    return (np.random.default_rng(seed).normal(size=(n, OBS)) * 2).astype(np.float32)


# -- networks -------------------------------------------------------------------
NETS = {
    "QNetEnsemble": (lambda: jc.QNetEnsemble(HID, 4, num_critics=3), lambda: tc.QNetEnsemble(OBS, HID, 4, 3)),
    "EnsembleMLP": (lambda: jc.EnsembleMLP(5, (16,), 2), lambda: tc.EnsembleMLP(5, OBS, (16,), 2)),
    "BranchingQNet": (lambda: jc.BranchingQNet(HID, 3, 5, value_hidden=(16,), action_hidden=(8,)),
                      lambda: tc.BranchingQNet(OBS, HID, 3, 5, value_hidden=(16,), action_hidden=(8,))),
}


@pytest.mark.parametrize("name", list(NETS))
def test_forwards_match_flax(name):
    jnet, tnet = (make() for make in NETS[name])
    obs = _obs()
    params = jnet.init(jax.random.key(0), jnp.asarray(obs))
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    ref = np.asarray(jnet.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(obs)).numpy()
    assert got.shape == ref.shape
    _close(got, ref, msg=name)


def test_ensembles_have_independent_members():
    """tests/test_networks.py ``test_ensembles_have_independent_members``."""
    obs, act = torch.ones(5, 4), torch.ones(5, 2)
    for net, args in [
        (tc.QNetEnsemble(4, (16,), 3, num_critics=4), (obs,)),
        (tc.EnsembleMLP(4, 4, (16,), 2), (obs,)),
        (tcont.CriticEnsemble(4, 2, (16,), num_critics=4), (obs, act)),
    ]:
        with torch.no_grad():
            out = net(*args).numpy()
        members = [out[i] for i in range(4)]
        for a, b in zip(members, members[1:]):
            assert not np.allclose(a, b), type(net).__name__


def test_branching_qnet_shape():
    """tests/test_networks.py ``test_branching_qnet_shape``."""
    net = tc.BranchingQNet(4, (16,), num_branches=3, actions_per_branch=5)
    assert net(torch.ones(5, 4)).shape == (5, 3, 5)


def test_critic_ensemble_keeps_its_layout():
    """CriticEnsemble is an EnsembleMLP over (obs, act): the same
    ``weights.i`` / ``biases.i`` names and ``[K, in, out]`` shapes."""
    net = tcont.CriticEnsemble(OBS, 2, HID, num_critics=10)
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert shapes == {"weights.0": (10, 5, 32), "weights.1": (10, 32, 32), "weights.2": (10, 32, 1),
                      "biases.0": (10, 32), "biases.1": (10, 32), "biases.2": (10, 1)}
    assert net.ensemble_size == 10


# -- algorithms -----------------------------------------------------------------
class _RecordingBuffer:
    """A stand-in buffer whose ``update_priorities`` returns the written
    ``|td|`` as the new buffer state, so that both updates hand it back."""

    @staticmethod
    def update_priorities(state, env_idx, pos, td_abs):
        return td_abs


def _sampled_pair(seed, act_kind):
    rng = np.random.default_rng(seed)
    if act_kind == "box":
        act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    elif act_kind == "discrete":
        act = rng.integers(0, 4, B)
    else:
        act = rng.integers(0, 4, (B, 2))
    arrays = dict(
        env_idx=rng.integers(0, 2, B), pos=rng.integers(0, 8, B), weight=rng.uniform(0.5, 1.5, B).astype(np.float32),
        obs=(rng.normal(size=(B, OBS)) * 2).astype(np.float32), act=act,
        rew_chain=rng.normal(size=(B, N_STEP)).astype(np.float32),
        done_chain=(rng.random((B, N_STEP)) < 0.2).astype(np.int32),
        obs_next=(rng.normal(size=(B, OBS)) * 2).astype(np.float32), terminated=rng.random(B) < 0.3,
    )

    def side(asarray, batch):
        c = {k: asarray(v) for k, v in arrays.items()}
        return (c["env_idx"], c["pos"], c["weight"], batch(obs=c["obs"], act=c["act"]), c["rew_chain"],
                c["done_chain"], batch(obs_next=c["obs_next"], terminated=c["terminated"]))

    return side(jnp.asarray, JaxBatch), side(_t, Batch)


def _assert_modules(pairs, msg):
    """``(port module, flax params, heads)`` pairs, every parameter."""
    for module, flax_params, heads in pairs:
        ref = params_from_flax(jax.device_get(flax_params), heads=heads)
        got = module.state_dict()
        assert set(got) == set(ref), msg
        for name in ref:
            _close(got[name], ref[name], rtol=1e-4, atol=1e-5, msg=f"{msg} {name}")


def _ac_pairs(jts, tts, actor_heads):
    return [(tts.actor, jts.actor_params, actor_heads), (tts.critic, jts.critic_params, None),
            (tts.target_critic, jts.target_critic_params, None)]


def _load_ac(jts, tts, actor_heads):
    tts.actor.load_state_dict(params_from_flax(jax.device_get(jts.actor_params), heads=actor_heads))
    tts.critic.load_state_dict(params_from_flax(jax.device_get(jts.critic_params)))
    tts.target_critic.load_state_dict(params_from_flax(jax.device_get(jts.target_critic_params)))
    with torch.no_grad():
        tts.log_alpha.copy_(_t(jts.log_alpha))


def test_redq_two_updates_match_jax(monkeypatch):
    n, m = 5, 2
    common = dict(actor_lr=1e-3, critic_lr=1e-3, alpha_lr=3e-2, gamma=0.9, tau=0.05, n_step=N_STEP,
                  ensemble_size=n, subset_size=m, actor_delay=2, auto_alpha=True)
    jalgo = JaxREDQ(jcont.GaussianActor(HID, 2, conditioned_sigma=True), jcont.CriticEnsemble(HID, n),
                    JaxBox(low=-1.0, high=1.0, shape=(2,)), **common)
    talgo = REDQ(tcont.GaussianActor(OBS, HID, 2, conditioned_sigma=True), tcont.CriticEnsemble(OBS, 2, HID, n),
                 Box(low=-1.0, high=1.0, shape=(2,)), device="cpu", **common)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    _load_ac(jts, tts, GAUSS_HEADS)
    normals, perms = [], []
    monkeypatch.setattr(jax.random, "normal", _recording(jax.random.normal, normals))
    monkeypatch.setattr(jax.random, "permutation", _recording(jax.random.permutation, perms))
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, _RecordingBuffer, None, s, k))
    subsets = []
    for step in (1, 2):
        js, ts_ = _sampled_pair(step, "box")
        del normals[:], perms[:]
        jts, jtd, jm = update(jts, js, jax.random.key(100 + step))
        jax.effects_barrier()
        # the target's normal always; the actor's only when it steps
        assert len(normals) == (2 if step == 2 else 1) and len(perms) == 1
        subset = _t(perms[0][:m])
        subsets.append(tuple(subset.tolist()))
        eps_actor = _t(normals[1]) if step == 2 else torch.zeros(B, 2)
        tts, ttd, tm = talgo.update_sampled(tts, _RecordingBuffer, None, ts_, noise=(_t(normals[0]), eps_actor),
                                            subset=subset)
        assert set(tm) == set(jm) == {"critic_loss", "alpha"}
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=f"redq step {step} {k}")
        _close(ttd, jtd, rtol=1e-4, atol=1e-5, msg=f"redq step {step} priorities")
        assert tts.step == int(jts.step) == step
        _assert_modules(_ac_pairs(jts, tts, GAUSS_HEADS), f"redq step {step}")
        _close(tts.log_alpha.detach(), jts.log_alpha, rtol=1e-4, atol=1e-5, msg="log_alpha")
    assert abs(float(tts.log_alpha.detach()) - np.log(0.2)) > 1e-3  # the alpha step ran at step 2
    assert len(set(subsets[0])) == m


def test_redq_draws_its_subset_on_the_device_and_delays_the_actor():
    talgo = REDQ(tcont.GaussianActor(OBS, HID, 2, conditioned_sigma=True), tcont.CriticEnsemble(OBS, 2, HID, 10),
                 Box(low=-1.0, high=1.0, shape=(2,)), ensemble_size=10, subset_size=3, actor_delay=3, device="cpu")
    g = torch.Generator().manual_seed(0)
    draws = [talgo.draw_subset(g) for _ in range(2000)]
    assert all(len(set(d.tolist())) == 3 for d in draws)
    counts = np.bincount(torch.cat(draws).numpy(), minlength=10)
    assert counts.min() > 0.8 * 600 and counts.max() < 1.2 * 600  # uniform over the 10 critics
    tts = talgo.init(torch.Generator().manual_seed(0))
    actor0 = {k: v.clone() for k, v in tts.actor.state_dict().items()}
    moved = []
    for step in range(1, 4):
        _, ts_ = _sampled_pair(step, "box")
        tts, _, _ = talgo.update_sampled(tts, None, None, ts_, generator=g)
        moved.append(any(not torch.equal(v, actor0[k]) for k, v in tts.actor.state_dict().items()))
    assert moved == [False, False, True]


def test_discrete_sac_two_updates_match_jax():
    common = dict(actor_lr=1e-3, critic_lr=1e-3, alpha_lr=3e-2, gamma=0.9, tau=0.05, n_step=N_STEP)
    jalgo = JaxDiscreteSAC(jc.QNet(HID, 4), jc.QNetEnsemble(HID, 4, num_critics=2), JaxDiscrete(4), **common)
    talgo = DiscreteSAC(tc.QNet(OBS, HID, 4), tc.QNetEnsemble(OBS, HID, 4, 2), Discrete(4), device="cpu", **common)
    assert talgo.target_entropy == pytest.approx(jalgo.target_entropy, rel=1e-6)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    _load_ac(jts, tts, None)
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, _RecordingBuffer, None, s, k))
    for step in (1, 2):
        js, ts_ = _sampled_pair(step, "discrete")
        jts, jtd, jm = update(jts, js, jax.random.key(step))
        tts, ttd, tm = talgo.update_sampled(tts, _RecordingBuffer, None, ts_)
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=f"discrete sac step {step} {k}")
        _close(ttd, jtd, rtol=1e-4, atol=1e-5, msg=f"discrete sac step {step} priorities")
        _assert_modules(_ac_pairs(jts, tts, None), f"discrete sac step {step}")
        _close(tts.log_alpha.detach(), jts.log_alpha, rtol=1e-4, atol=1e-5, msg="log_alpha")
    assert abs(float(tts.log_alpha.detach()) - np.log(0.05)) > 1e-3


def test_discrete_sac_acts_greedily_and_samples_legal_actions():
    talgo = DiscreteSAC(tc.QNet(OBS, HID, 4), tc.QNetEnsemble(OBS, HID, 4, 2), Discrete(4), device="cpu")
    tts = talgo.init(torch.Generator().manual_seed(0))
    obs = torch.from_numpy(_obs(256))
    g = torch.Generator().manual_seed(1)
    greedy = talgo.act(tts, obs, g, explore=False)
    torch.testing.assert_close(greedy, tts.actor(obs).argmax(-1))
    sampled = talgo.act(tts, obs, g, explore=True)
    assert sampled.shape == (256,) and bool(((sampled >= 0) & (sampled < 4)).all())
    assert not torch.equal(sampled, greedy)


def test_bdq_two_updates_match_jax():
    kw = dict(lr=1e-3, gamma=0.9, n_step=N_STEP, target_update_freq=2)
    net_kw = dict(value_hidden=(16,), action_hidden=(16,))
    jalgo = JaxBDQ(jc.BranchingQNet(HID, 2, 4, **net_kw), JaxMultiDiscrete((4, 4)), **kw)
    talgo = BDQ(tc.BranchingQNet(OBS, HID, 2, 4, **net_kw), MultiDiscrete((4, 4)), device="cpu", **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, _RecordingBuffer, None, s, k))
    for step in (1, 2):
        js, ts_ = _sampled_pair(step, "multi")
        jts, jtd, jm = update(jts, js, jax.random.key(step))
        tts, ttd, tm = talgo.update_sampled(tts, _RecordingBuffer, None, ts_)
        assert set(tm) == set(jm) == {"loss"}
        _close(tm["loss"], jm["loss"], rtol=1e-4, atol=1e-5, msg=f"bdq step {step} loss")
        _close(ttd, jtd, rtol=1e-4, atol=1e-5, msg=f"bdq step {step} priorities")
        _assert_modules([(tts.online, jts.params, None), (tts.target, jts.target_params, None)], f"bdq step {step}")
    # the target copy fired at the second update
    for k, v in tts.target.state_dict().items():
        torch.testing.assert_close(v, tts.online.state_dict()[k])


def test_bdq_acts_per_branch():
    talgo = BDQ(tc.BranchingQNet(OBS, HID, 2, 4), MultiDiscrete((4, 4)), device="cpu")
    tts = talgo.init(torch.Generator().manual_seed(0))
    obs = torch.from_numpy(_obs(512))
    g = torch.Generator().manual_seed(1)
    greedy = talgo.act(tts, obs, g, explore=False)
    torch.testing.assert_close(greedy, tts.online(obs).argmax(-1))
    explored = talgo.act(tts, obs, g, explore=True, explore_param=0.5)
    assert explored.shape == (512, 2) and bool(((explored >= 0) & (explored < 4)).all())
    changed = (explored != greedy).any(dim=-1).float().mean().item()
    assert 0.25 < changed < 0.5  # half the rows re-drawn, 3/4 of those differ somewhere or more
