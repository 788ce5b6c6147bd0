"""The continuous-control slice of the port (tianshou_tpu_torch: ops/dist,
networks/continuous, algos/ddpg, algos/sac) against the JAX package, on the
CPU in float32 at a small size (obs 5, actions 2, hidden (32, 32), batch 16).

- ops/dist: every function from the same inputs and the same noise (the
  JAX package's own normal and Gumbel draws), rtol/atol 1e-5 (1e-6 for the
  tanh correction, whose ``softplus`` threshold changes nothing above float32
  rounding); categorical samples equal.
- the four nets with weights carried by params_from_flax: atol 1e-5,
  CriticEnsemble at K = 2 and K = 10.
- 3 updates each of DDPG, TD3 and SAC (fixed and automatic alpha) from the
  same parameters, batch and injected noise: losses and every parameter
  (online, targets, log_alpha) within rtol 1e-4 / atol 1e-5 (Adam rounds
  differently in optax and PyTorch).
- TD3's delayed actor: the actor and both targets stay unchanged on odd
  steps; the trainer's default explore parameter is the algorithm's
  exploration noise in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.ddpg import DDPG as JaxDDPG
from tianshou_tpu.algos.ddpg import TD3 as JaxTD3
from tianshou_tpu.algos.sac import SAC as JaxSAC
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.networks import continuous as jcont
from tianshou_tpu.ops import dist as jdist
from tianshou_tpu_torch.algos.ddpg import DDPG, TD3
from tianshou_tpu_torch.algos.sac import SAC
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.envs.spaces import Box
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks.convert import params_from_flax
from tianshou_tpu_torch.ops import dist as tdist

OBS, A, HID, B, N_STEP = 5, 2, (32, 32), 16, 2
GAUSS_HEADS = ("mu", "sigma")


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


# -- ops/dist ---------------------------------------------------------------
def test_normal_functions_match_jax():
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(64, 3)).astype(np.float32)
    sigma = np.exp(rng.normal(size=(64, 3))).astype(np.float32)
    key = jax.random.key(7)
    eps = np.asarray(jax.random.normal(key, mu.shape))
    x = np.asarray(jdist.normal_sample(key, jnp.asarray(mu), jnp.asarray(sigma)))
    _close(tdist.normal_sample(_t(mu), _t(sigma), _t(eps)), x)
    _close(tdist.normal_log_prob(_t(x), _t(mu), _t(sigma)), jdist.normal_log_prob(x, mu, sigma))
    _close(tdist.normal_entropy(_t(sigma)), jdist.normal_entropy(sigma))
    a, logp = jdist.tanh_normal_sample_and_log_prob(key, jnp.asarray(mu), jnp.asarray(sigma))
    ta, tlogp = tdist.tanh_normal_sample_and_log_prob(_t(mu), _t(sigma), _t(eps))
    _close(ta, a)
    _close(tlogp, logp)
    mu_q = rng.normal(size=(64, 3)).astype(np.float32)
    sigma_q = np.exp(rng.normal(size=(64, 3))).astype(np.float32)
    _close(tdist.kl_normal(_t(mu), _t(sigma), _t(mu_q), _t(sigma_q)), jdist.kl_normal(mu, sigma, mu_q, sigma_q))


def test_tanh_correction_matches_jax_across_the_softplus_threshold():
    # -2u crosses F.softplus's threshold of 20 at u = -10
    u = np.concatenate([np.linspace(-30, 30, 241), [-10.0001, -9.9999, 0.0]]).astype(np.float32)[:, None]
    _close(tdist.tanh_log_prob_correction(_t(u)), jdist.tanh_log_prob_correction(jnp.asarray(u)), rtol=1e-6, atol=1e-6)


def test_categorical_functions_match_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(500, 6)) * 2).astype(np.float32)
    key = jax.random.key(3)
    gumbel = np.asarray(jax.random.gumbel(key, logits.shape))
    ref = np.asarray(jdist.categorical_sample(key, jnp.asarray(logits)))
    got = tdist.categorical_sample(_t(logits), _t(gumbel))
    np.testing.assert_array_equal(got.numpy(), ref)
    act = rng.integers(0, 6, 500).astype(np.int32)
    _close(tdist.categorical_log_prob(_t(act), _t(logits)), jdist.categorical_log_prob(jnp.asarray(act), logits))
    _close(tdist.categorical_entropy(_t(logits)), jdist.categorical_entropy(logits))
    other = rng.normal(size=(500, 6)).astype(np.float32)
    _close(tdist.kl_categorical(_t(logits), _t(other)), jdist.kl_categorical(logits, other))


def test_draws_have_the_right_law():
    g = torch.Generator().manual_seed(0)
    like = torch.zeros(200_000)
    n = tdist.standard_normal(g, like)
    assert abs(float(n.mean())) < 0.01 and abs(float(n.std()) - 1.0) < 0.01
    gum = tdist.standard_gumbel(g, like)
    assert abs(float(gum.mean()) - 0.5772) < 0.01 and abs(float(gum.var()) - np.pi**2 / 6) < 0.03


# -- networks ---------------------------------------------------------------
def _net_pair(name, k=2):
    nets = {
        "DeterministicActor": (jcont.DeterministicActor(HID, A), tcont.DeterministicActor(OBS, HID, A), None),
        "GaussianActor-conditioned": (jcont.GaussianActor(HID, A, conditioned_sigma=True),
                                      tcont.GaussianActor(OBS, HID, A, conditioned_sigma=True), GAUSS_HEADS),
        "GaussianActor-param": (jcont.GaussianActor(HID, A, sigma_init=-0.5),
                                tcont.GaussianActor(OBS, HID, A, sigma_init=-0.5), GAUSS_HEADS[:1]),
        "Critic": (jcont.Critic(HID), tcont.Critic(OBS, A, HID), None),
        "CriticEnsemble": (jcont.CriticEnsemble(HID, k), tcont.CriticEnsemble(OBS, A, HID, k), None),
    }
    return nets[name]


@pytest.mark.parametrize("name,k", [
    ("DeterministicActor", 0), ("GaussianActor-conditioned", 0), ("GaussianActor-param", 0), ("Critic", 0),
    ("CriticEnsemble", 2), ("CriticEnsemble", 10),
])
def test_forwards_match_flax(name, k):
    jnet, tnet, heads = _net_pair(name, k)
    rng = np.random.default_rng(4)
    obs = (rng.normal(size=(9, OBS)) * 2).astype(np.float32)
    act = rng.uniform(-1, 1, (9, A)).astype(np.float32)
    args = (obs,) if "Actor" in name else (obs, act)
    params = jnet.init(jax.random.key(5), *map(jnp.asarray, args))
    tnet.load_state_dict(params_from_flax(jax.device_get(params), heads=heads))
    ref = jnet.apply(params, *map(jnp.asarray, args))
    with torch.no_grad():
        got = tnet(*map(_t, args))
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert g.shape == r.shape and g.dtype == torch.float32
        assert np.abs(np.asarray(r)).max() > 1e-4
        _close(g, r, rtol=0, atol=1e-5, msg=name)
    if name == "CriticEnsemble":
        assert got.shape == (k, 9)


def test_critic_ensemble_is_one_batched_module_with_independent_inits():
    net = tcont.CriticEnsemble(OBS, A, (64, 64), num_critics=3)
    net.reset_parameters(torch.Generator().manual_seed(0))
    assert [tuple(w.shape) for w in net.weights] == [(3, OBS + A, 64), (3, 64, 64), (3, 64, 1)]
    assert not any(isinstance(m, torch.nn.Linear) for m in net.modules())
    w = net.weights[1].detach().double()
    for k in range(3):
        torch.testing.assert_close(w[k].T @ w[k], 2.0 * torch.eye(64, dtype=torch.float64), rtol=0, atol=1e-5)
    assert not torch.equal(w[0], w[1])


def test_gaussian_actor_clips_log_sigma():
    net = tcont.GaussianActor(OBS, HID, A, conditioned_sigma=True)
    with torch.no_grad():
        net.sigma.bias.fill_(50.0)
        _, sigma = net(torch.zeros(3, OBS))
    torch.testing.assert_close(sigma, torch.full((3, A), float(np.exp(2.0))))


# -- algorithms ---------------------------------------------------------------
def _algo_pair(kind, **kw):
    jbox, tbox = JaxBox(low=-1.0, high=1.0, shape=(A,)), Box(low=-1.0, high=1.0, shape=(A,))
    common = dict(actor_lr=1e-3, critic_lr=1e-3, gamma=0.9, tau=0.05, n_step=N_STEP)
    if kind == "ddpg":
        jalgo = JaxDDPG(jcont.DeterministicActor(HID, A), jcont.CriticEnsemble(HID, 1), jbox, **common, **kw)
        talgo = DDPG(tcont.DeterministicActor(OBS, HID, A), tcont.CriticEnsemble(OBS, A, HID, 1), tbox,
                     device="cpu", **common, **kw)
    elif kind == "td3":
        jalgo = JaxTD3(jcont.DeterministicActor(HID, A), jcont.CriticEnsemble(HID, 2), jbox, **common, **kw)
        talgo = TD3(tcont.DeterministicActor(OBS, HID, A), tcont.CriticEnsemble(OBS, A, HID, 2), tbox,
                    device="cpu", **common, **kw)
    else:
        common["alpha_lr"] = 3e-2  # large enough that log_alpha visibly moves in 3 steps
        jalgo = JaxSAC(jcont.GaussianActor(HID, A, conditioned_sigma=True), jcont.CriticEnsemble(HID, 2), jbox,
                       **common, **kw)
        talgo = SAC(tcont.GaussianActor(OBS, HID, A, conditioned_sigma=True), tcont.CriticEnsemble(OBS, A, HID, 2),
                    tbox, device="cpu", **common, **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    _carry(kind, jts, tts)
    return jalgo, jts, talgo, tts


def _actor_heads(kind):
    return GAUSS_HEADS if kind.startswith("sac") else None


def _carry(kind, jts, tts):
    """Load the JAX state's parameters into the port's state."""
    heads = _actor_heads(kind)
    tts.actor.load_state_dict(params_from_flax(jax.device_get(jts.actor_params), heads=heads))
    tts.critic.load_state_dict(params_from_flax(jax.device_get(jts.critic_params)))
    tts.target_critic.load_state_dict(params_from_flax(jax.device_get(jts.target_critic_params)))
    if tts.target_actor is not None:
        tts.target_actor.load_state_dict(params_from_flax(jax.device_get(jts.target_actor_params)))
    if tts.log_alpha is not None:
        with torch.no_grad():
            tts.log_alpha.copy_(_t(jts.log_alpha))


def _assert_state_close(kind, jts, tts):
    heads = _actor_heads(kind)
    pairs = [(tts.actor, jts.actor_params, heads), (tts.critic, jts.critic_params, None),
             (tts.target_critic, jts.target_critic_params, None)]
    if tts.target_actor is not None:
        pairs.append((tts.target_actor, jts.target_actor_params, heads))
    for module, flax_params, h in pairs:
        ref = params_from_flax(jax.device_get(flax_params), heads=h)
        got = module.state_dict()
        assert set(got) == set(ref)
        for name in ref:
            _close(got[name], ref[name], rtol=1e-4, atol=1e-5, msg=name)
    if tts.log_alpha is not None:
        _close(tts.log_alpha.detach(), jts.log_alpha, rtol=1e-4, atol=1e-5, msg="log_alpha")


def _sampled_pair(seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        env_idx=rng.integers(0, 2, B).astype(np.int32),
        pos=rng.integers(0, 8, B).astype(np.int32),
        weight=rng.uniform(0.5, 1.5, B).astype(np.float32),
        obs=(rng.normal(size=(B, OBS)) * 2).astype(np.float32),
        act=rng.uniform(-1, 1, (B, A)).astype(np.float32),
        rew_chain=rng.normal(size=(B, N_STEP)).astype(np.float32),
        done_chain=(rng.random((B, N_STEP)) < 0.2).astype(np.int32),
        obs_next=(rng.normal(size=(B, OBS)) * 2).astype(np.float32),
        terminated=rng.random(B) < 0.3,
    )

    def side(asarray, batch):
        c = {k: asarray(v) for k, v in arrays.items()}
        return (c["env_idx"], c["pos"], c["weight"], batch(obs=c["obs"], act=c["act"]), c["rew_chain"],
                c["done_chain"], batch(obs_next=c["obs_next"], terminated=c["terminated"]))

    return side(jnp.asarray, JaxBatch), side(_t, Batch)


def _jax_noise(kind, key):
    """The normal draws the JAX update takes from ``key``."""
    if kind == "td3":
        return _t(jax.random.normal(key, (B, A)))
    if kind.startswith("sac"):
        k_tgt, k_pi = jax.random.split(key)
        return _t(jax.random.normal(k_tgt, (B, A))), _t(jax.random.normal(k_pi, (B, A)))
    return None


ALGOS = {"ddpg": {}, "td3": {}, "sac-fixed-alpha": dict(auto_alpha=False), "sac-auto-alpha": dict(auto_alpha=True)}


@pytest.mark.parametrize("kind", list(ALGOS))
def test_three_updates_match_jax(kind):
    jalgo, jts, talgo, tts = _algo_pair(kind.split("-")[0], **ALGOS[kind])
    jbuf = JaxReplayBuffer(8, 2)  # uniform replay: update_priorities is a no-op
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, jbuf, None, s, k))
    for step in range(1, 4):
        js, ts_ = _sampled_pair(step)
        key = jax.random.key(100 + step)
        jts, _, jm = update(jts, js, key)
        tts, _, tm = talgo.update_sampled(tts, None, None, ts_, noise=_jax_noise(kind, key))
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=f"{kind} step {step} {k}")
        assert tts.step == int(jts.step) == step
        _assert_state_close(kind, jts, tts)
    if kind == "sac-auto-alpha":
        assert abs(float(tts.log_alpha.detach()) - np.log(0.2)) > 1e-3
    if kind != "ddpg":
        assert abs(float(tm["actor_loss"])) > 0 or kind == "td3"


def test_td3_delays_the_actor_and_targets():
    _, _, talgo, tts = _algo_pair("td3", update_actor_freq=2)

    def snapshot():
        return [{k: v.clone() for k, v in m.state_dict().items()}
                for m in (tts.actor, tts.target_actor, tts.target_critic)]

    before = snapshot()
    for step in range(1, 5):
        _, ts_ = _sampled_pair(20 + step)
        tts, _, m = talgo.update_sampled(tts, None, None, ts_, generator=torch.Generator().manual_seed(step))
        after = snapshot()
        same = [all(torch.equal(a[k], b[k]) for k in a) for a, b in zip(before, after)]
        if step % 2:
            assert same == [True, True, True] and float(m["actor_loss"]) == 0.0, step
        else:
            assert same == [False, False, False], step
        before = after


def test_sac_act_is_tanh_of_mu_when_greedy_and_bounded_when_sampling():
    _, _, talgo, tts = _algo_pair("sac", auto_alpha=True)
    obs = _t((np.random.default_rng(0).normal(size=(200, OBS)) * 3).astype(np.float32))
    with torch.no_grad():
        mu, _ = tts.actor(obs)
    g = torch.Generator().manual_seed(0)
    torch.testing.assert_close(talgo.act(tts, obs, g, explore=False), torch.tanh(mu))
    a = talgo.act(tts, obs, g, explore=True)
    assert a.shape == (200, A) and float(a.abs().max()) <= 1.0 and not torch.equal(a, torch.tanh(mu))


def test_ddpg_exploration_noise_and_clip():
    _, _, talgo, tts = _algo_pair("ddpg", exploration_noise=0.3)
    obs = torch.zeros(20_000, OBS)
    g = torch.Generator().manual_seed(0)
    greedy = talgo.act(tts, obs, g, explore=False)
    noisy = talgo.act(tts, obs, g, explore=True)  # explore_param None: the algorithm's 0.3
    diff = (noisy - greedy)[(noisy.abs() < 1.0)]
    assert abs(float(diff.std()) - 0.3) < 0.01
    assert float(talgo.act(tts, obs, g, explore=True, explore_param=5.0).abs().max()) == 1.0


def test_trainer_default_explore_param_is_the_exploration_noise():
    from tianshou_tpu.collect.collector import Collector as JaxCollector
    from tianshou_tpu.envs.base import VectorEnv as JaxVectorEnv
    from tianshou_tpu.envs.classic import Pendulum as JaxPendulum
    from tianshou_tpu.trainer.offpolicy import OffPolicyTrainer as JaxTrainer
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import Pendulum
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    jalgo = JaxTD3(jcont.DeterministicActor(HID, 1), jcont.CriticEnsemble(HID, 2), JaxPendulum().action_space,
                   exploration_noise=0.37)
    talgo = TD3(tcont.DeterministicActor(3, HID, 1), tcont.CriticEnsemble(3, 1, HID, 2), Pendulum().action_space,
                exploration_noise=0.37, device="cpu")
    jcol = JaxCollector(jalgo, JaxVectorEnv(JaxPendulum(), 2))
    tcol = Collector(talgo, VectorEnv(Pendulum(), 2, device="cpu"), device="cpu")
    kw = dict(max_epoch=1, step_per_epoch=10, step_per_collect=2)
    jtrainer = JaxTrainer(jalgo, jcol, jcol, JaxReplayBuffer(8, 2), **kw)
    ttrainer = OffPolicyTrainer(talgo, tcol, tcol, ReplayBuffer(8, 2), device="cpu", **kw)
    assert ttrainer.train_param_fn(1, 0) == jtrainer.train_param_fn(1, 0) == pytest.approx(0.37)
    assert ttrainer.train_param_fn(3, 5000) == 0.37
