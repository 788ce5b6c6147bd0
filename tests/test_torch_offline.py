"""The offline algorithms of the port (tianshou_tpu_torch/algos/offline.py)
and BCQ's nets against the JAX package, on the CPU in float32 at a small
size (obs 3 or 4, hidden (32, 32), batch 16, a [2, 16] ring that wraps and
holds episode ends).

- ``Perturbation`` and ``VAE`` forwards, weights carried by
  ``params_from_flax``, both VAE draws injected: atol 1e-5.
- Two updates each of BC (continuous and discrete), TD3BC, BCQ, CQL (plain,
  CQL(Lagrange) and CalQL), DiscreteBCQ, DiscreteCQL and DiscreteCRR (each
  policy-improvement mode), from the same parameters and ring: the JAX
  update's sampled slots and its own normal and uniform draws are recorded
  with an ordered ``jax.debug.callback`` and injected.  Metrics and every
  parameter (online, target, VAE, alphas) within rtol 1e-4 / atol 1e-5.
- CalQL's calibration returns against the JAX package's, and against
  reward-to-go computed here, within rtol 1e-5.
- The Lagrange dual's direction (tests/test_offline_e2e.py:264-306): it
  rises while the penalty exceeds the threshold and falls otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos import offline as jo
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs.spaces import Box as JaxBox
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.networks import common as jc
from tianshou_tpu.networks import continuous as jcont
from tianshou_tpu.networks import discrete as jd
from tianshou_tpu_torch.algos import offline as to
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.spaces import Box, Discrete
from tianshou_tpu_torch.networks import common as tc
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks import discrete as td
from tianshou_tpu_torch.networks.convert import params_from_flax

HID, B, CAP, N_ENVS = (32, 32), 16, 16, 2
GAUSS_HEADS = ("mu", "sigma")
RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, ref, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def _recording(fn, log):
    """``fn`` that also appends each of its outputs to ``log``, in call
    order, inside ``jax.jit`` too (an ordered callback)."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(lambda v: log.append(np.asarray(v)), out, ordered=True)
        return out

    return wrapped


def _steps(obs_dim, act, n=40, seed=3):
    """``n`` steps of ``N_ENVS`` transitions; ``act`` is "box" (2 dims in
    [-1, 1]) or an action count."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = (rng.uniform(-1, 1, (N_ENVS, 2)).astype(np.float32) if act == "box"
             else rng.integers(0, act, N_ENVS).astype(np.int32))
        out.append(dict(obs=rng.normal(size=(N_ENVS, obs_dim)).astype(np.float32), act=a,
                        rew=rng.normal(size=N_ENVS).astype(np.float32), terminated=rng.random(N_ENVS) < 0.1,
                        truncated=rng.random(N_ENVS) < 0.05,
                        obs_next=rng.normal(size=(N_ENVS, obs_dim)).astype(np.float32)))
    return out


def _rings(steps):
    """The same ring in both packages; the JAX buffer records the
    ``(env_idx, pos, weight)`` each sample draws."""
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS)
    jbs = jbuf.init(JaxBatch({k: jnp.asarray(v[0]) for k, v in steps[0].items()}))
    tbs = tbuf.init(Batch({k: _t(v[0]) for k, v in steps[0].items()}), device="cpu")
    for tr in steps:
        jbs = jbuf.add(jbs, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
        tbs = tbuf.add(tbs, Batch({k: _t(v) for k, v in tr.items()}))
    draws = []
    sample = jbuf.sample_with_weights

    def recorded(state, key, batch_size):
        out = sample(state, key, batch_size)
        jax.debug.callback(lambda *v: draws.append([np.asarray(x) for x in v]), *out, ordered=True)
        return out

    jbuf.sample_with_weights = recorded
    return jbuf, jbs, tbuf, tbs, draws


def _replay(tbuf, draws):
    """The port's buffer draws the JAX update's recorded samples, in
    order."""
    queue = [tuple(_t(x).long() if i < 2 else _t(x) for i, x in enumerate(d)) for d in draws]
    tbuf.sample_with_weights = lambda st, g, b: queue.pop(0)
    return queue


def _load(module, flax_params, heads=None):
    module.load_state_dict(params_from_flax(jax.device_get(flax_params), heads=heads))


def _assert_module(module, flax_params, msg, heads=None):
    ref = params_from_flax(jax.device_get(flax_params), heads=heads)
    got = module.state_dict()
    assert set(got) == set(ref), msg
    for name in ref:
        _close(got[name], ref[name], msg=f"{msg} {name}")


def _assert_metrics(tm, jm, msg):
    assert set(tm) == set(jm), (sorted(tm), sorted(jm))
    for k in jm:
        _close(tm[k], jm[k], msg=f"{msg} {k}")


# -- nets -----------------------------------------------------------------------
def test_perturbation_and_vae_forwards_match_flax():
    rng = np.random.default_rng(0)
    obs, act = rng.normal(size=(9, 3)).astype(np.float32), rng.uniform(-1, 1, (9, 2)).astype(np.float32)
    eps = rng.normal(size=(9, 4)).astype(np.float32) * 2  # wide enough that the prior clip bites
    jp, tp = jcont.Perturbation(HID, 2, max_action=1.0, phi=0.5), tcont.Perturbation(3, HID, 2, phi=0.5)
    params = jp.init(jax.random.key(0), jnp.asarray(obs), jnp.asarray(act))
    _load(tp, params)
    with torch.no_grad():
        _close(tp(_t(obs), _t(act)), jp.apply(params, jnp.asarray(obs), jnp.asarray(act)))

    jv, tv = jcont.VAE(HID, action_dim=2, latent_dim=4, max_action=1.0), tcont.VAE(3, HID, 2, 4)
    params = jv.init(jax.random.key(1), jnp.asarray(obs), jnp.asarray(act), jax.random.key(2))
    _load(tv, params)
    assert set(tv.state_dict()) == {f"{m}.layers.{i}.{p}" for m, n in (("encoder", 2), ("decoder", 3))
                                    for i in range(n) for p in ("weight", "bias")} | {
        f"{h}.{p}" for h in ("mean_head", "log_std_head") for p in ("weight", "bias")}
    normals = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _recording(jax.random.normal, normals))
        ref = jv.apply(params, jnp.asarray(obs), jnp.asarray(act), jax.random.key(3))
        ref_prior = jv.apply(params, jnp.asarray(obs), key=jax.random.key(4), method="decode")
    jax.effects_barrier()
    with torch.no_grad():
        got = tv(_t(obs), _t(act), _t(normals[0]))
        got_prior = tv.decode(_t(obs), noise=_t(normals[1]))
        got_z = tv.decode(_t(obs), _t(eps))
    for g, r, name in zip(got, ref, ("recon", "mean", "log_std")):
        _close(g, r, msg=name)
    _close(got_prior, ref_prior, msg="prior decode")
    _close(got_z, jv.apply(params, jnp.asarray(obs), jnp.asarray(eps), method="decode"), msg="decode(z)")
    # the prior draw is clipped to [-0.5, 0.5]
    with torch.no_grad():
        torch.testing.assert_close(tv.decode(_t(obs), noise=_t(eps)),
                                   tv.decode(_t(obs), torch.clamp(_t(eps), -0.5, 0.5)))


def test_vae_clips_log_std():
    tv = tcont.VAE(3, HID, 2, 4)
    with torch.no_grad():
        tv.log_std_head.bias.fill_(40.0)
        _, _, log_std = tv(torch.zeros(5, 3), torch.zeros(5, 2), torch.zeros(5, 4))
        assert float(log_std.max()) == 15.0
        tv.log_std_head.bias.fill_(-40.0)
        assert float(tv(torch.zeros(5, 3), torch.zeros(5, 2), torch.zeros(5, 4))[2].min()) == -4.0


# -- two updates of each algorithm ------------------------------------------------
def _two_updates(jalgo, jts, talgo, tts, steps, compare, draws_of=None, patch=None):
    """Two updates from the same state: the JAX update's sampled slots and
    (with ``patch``: ``{name: log}`` of ``jax.random`` functions) its
    draws recorded; ``draws_of(logs)`` maps them to the port update's
    keyword arguments; ``compare(jts, tts, step)`` checks the parameters."""
    jbuf, jbs, tbuf, tbs, draws = _rings(steps)
    patch = patch or {}
    with pytest.MonkeyPatch.context() as mp:
        for name, log in patch.items():
            mp.setattr(jax.random, name, _recording(getattr(jax.random, name), log))
        update = jax.jit(lambda ts, bs, k: jalgo.update(ts, jbuf, bs, k, B))
        for step in (1, 2):
            del draws[:]
            for log in patch.values():
                del log[:]
            jts, jbs_out, jm = update(jts, jbs, jax.random.key(10 + step))
            jax.effects_barrier()
            _replay(tbuf, draws)
            kwargs = draws_of(patch) if draws_of else {}
            tts, _, tm = talgo.update(tts, tbuf, tbs, None, B, **kwargs)
            _assert_metrics(tm, jm, f"step {step}")
            compare(jts, tts, step)
            assert tts.step == int(jts.step) == step
    return jts, tts


@pytest.mark.parametrize("discrete", [False, True])
def test_bc_two_updates_match_jax(discrete):
    if discrete:
        jalgo, talgo = jo.BC(jc.QNet(HID, 3), JaxDiscrete(3), lr=1e-2), to.BC(tc.QNet(4, HID, 3), Discrete(3), lr=1e-2,
                                                                              device="cpu")
        steps = _steps(4, 3)
    else:
        jalgo = jo.BC(jcont.DeterministicActor(HID, 2), JaxBox(-1.0, 1.0, (2,)), lr=1e-2)
        talgo = to.BC(tcont.DeterministicActor(3, HID, 2), Box(-1.0, 1.0, (2,)), lr=1e-2, device="cpu")
        steps = _steps(3, "box")
    jts = jalgo.init(jax.random.key(0), jnp.asarray(steps[0]["obs"][0]))
    tts = talgo.init(torch.Generator().manual_seed(0))
    _load(tts.online, jts.params)
    _two_updates(jalgo, jts, talgo, tts, steps, lambda j, t, s: _assert_module(t.online, j.params, f"bc {s}"))


def _load_ac(jts, tts, actor_heads=None, target_actor=True):
    _load(tts.actor, jts.actor_params, actor_heads)
    _load(tts.critic, jts.critic_params)
    _load(tts.target_critic, jts.target_critic_params)
    if target_actor:
        _load(tts.target_actor, jts.target_actor_params, actor_heads)


def _compare_ac(name, actor_heads=None, target_actor=True):
    def compare(jts, tts, step):
        parts = [("actor", jts.actor_params, actor_heads), ("critic", jts.critic_params, None),
                 ("target_critic", jts.target_critic_params, None)]
        if target_actor:
            parts.append(("target_actor", jts.target_actor_params, actor_heads))
        for attr, params, heads in parts:
            _assert_module(getattr(tts, attr), params, f"{name} step {step} {attr}", heads)
    return compare


def test_td3bc_two_updates_match_jax():
    kw = dict(actor_lr=1e-2, critic_lr=1e-2, gamma=0.9, tau=0.05, update_actor_freq=1, bc_alpha=2.5)
    jalgo = jo.TD3BC(jcont.DeterministicActor(HID, 2), jcont.CriticEnsemble(HID, 2), JaxBox(-1.0, 1.0, (2,)), **kw)
    talgo = to.TD3BC(tcont.DeterministicActor(3, HID, 2), tcont.CriticEnsemble(3, 2, HID, 2), Box(-1.0, 1.0, (2,)),
                     device="cpu", **kw)
    steps = _steps(3, "box")
    jts = jalgo.init(jax.random.key(0), jnp.asarray(steps[0]["obs"][0]))
    tts = talgo.init(torch.Generator().manual_seed(0))
    _load_ac(jts, tts)
    assert type(talgo).update is to.Algorithm.update  # TD3's presampled update, the actor loss changed only

    class _Port:
        """``update`` through TD3's presample and ``update_sampled`` with
        the recorded smoothing noise."""

        def update(self, ts, buffer, bstate, generator, batch_size, noise):
            sampled = talgo.presample(buffer, bstate, generator, batch_size)
            return talgo.update_sampled(ts, buffer, bstate, sampled, noise=noise)

    _two_updates(jalgo, jts, _Port(), tts, steps, _compare_ac("td3bc"),
                 draws_of=lambda logs: dict(noise=_t(logs["normal"][0])), patch={"normal": []})


def test_bcq_two_updates_match_jax():
    kw = dict(actor_lr=1e-2, critic_lr=1e-2, vae_lr=1e-2, gamma=0.9, tau=0.05, lmbda=0.75, num_sampled_action=5)
    jalgo = jo.BCQ(jcont.Perturbation(HID, 2, phi=0.5), jcont.CriticEnsemble(HID, 2),
                   jcont.VAE(HID, action_dim=2, latent_dim=4), JaxBox(-1.0, 1.0, (2,)), **kw)
    talgo = to.BCQ(tcont.Perturbation(3, HID, 2, phi=0.5), tcont.CriticEnsemble(3, 2, HID, 2), tcont.VAE(3, HID, 2, 4),
                   Box(-1.0, 1.0, (2,)), device="cpu", **kw)
    steps = _steps(3, "box")
    jts = jalgo.init(jax.random.key(0), jnp.asarray(steps[0]["obs"][0]))
    tts = talgo.init(torch.Generator().manual_seed(0))
    _load_ac(jts, tts)
    _load(tts.vae, jts.vae_params)
    ac = _compare_ac("bcq")

    def compare(jts, tts, step):
        ac(jts, tts, step)
        _assert_module(tts.vae, jts.vae_params, f"bcq step {step} vae")

    def draws_of(logs):
        # the VAE's latent, the target's prior draw, the actor's prior draw
        assert [x.shape for x in logs["normal"]] == [(B, 4), (B * 5, 4), (B, 4)]
        return dict(noise=tuple(_t(x) for x in logs["normal"]))

    jts, tts = _two_updates(jalgo, jts, talgo, tts, steps, compare, draws_of, patch={"normal": []})
    # acting: the best of the candidates under the first critic
    obs = np.random.default_rng(5).normal(size=(6, 3)).astype(np.float32)
    normals = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", _recording(jax.random.normal, normals))
        ref, _ = jalgo.act(jts, jnp.asarray(obs), jax.random.key(0), explore=False)
    jax.effects_barrier()
    _close(talgo.act(tts, _t(obs), None, explore=False, noise=_t(normals[0])), ref, msg="bcq act")


def _cql_pair(**kw):
    common = dict(actor_lr=1e-2, critic_lr=1e-2, alpha_lr=3e-2, gamma=0.9, tau=0.05, num_repeat_actions=4,
                  cql_alpha_lr=3e-2, **kw)
    jalgo = jo.CQL(jcont.GaussianActor(HID, 2, conditioned_sigma=True), jcont.CriticEnsemble(HID, 2),
                   JaxBox(-1.0, 1.0, (2,)), **common)
    talgo = to.CQL(tcont.GaussianActor(3, HID, 2, conditioned_sigma=True), tcont.CriticEnsemble(3, 2, HID, 2),
                   Box(-1.0, 1.0, (2,)), device="cpu", **common)
    return jalgo, talgo


@pytest.mark.parametrize("variant", ["plain", "lagrange", "calql"])
def test_cql_two_updates_match_jax(variant):
    kw = {"plain": dict(with_lagrange=False), "lagrange": dict(with_lagrange=True, lagrange_threshold=0.5),
          "calql": dict(with_lagrange=True, lagrange_threshold=0.5, calibrated=True)}[variant]
    jalgo, talgo = _cql_pair(**kw)
    steps = _steps(3, "box")
    jts = jalgo.init(jax.random.key(0), jnp.asarray(steps[0]["obs"][0]))
    tts = talgo.init(torch.Generator().manual_seed(0))
    assert (tts.cql_log_alpha is not None) == (jts.cql_log_alpha is not None) == (variant != "plain")
    _load_ac(jts, tts, GAUSS_HEADS, target_actor=False)
    with torch.no_grad():
        tts.log_alpha.copy_(_t(jts.log_alpha))
    ac = _compare_ac(f"cql {variant}", GAUSS_HEADS, target_actor=False)

    def compare(jts, tts, step):
        ac(jts, tts, step)
        _close(tts.log_alpha.detach(), jts.log_alpha, msg="log_alpha")
        if variant != "plain":
            _close(tts.cql_log_alpha.detach(), jts.cql_log_alpha, msg="cql_log_alpha")

    def draws_of(logs):
        n = 4
        assert [x.shape for x in logs["normal"]] == [(B, 2), (B, 2), (B * n, 2), (B * n, 2)]
        (a_rand,) = [x for x in logs["uniform"] if x.shape == (B * n, 2)]
        return dict(noise=(*(_t(x) for x in logs["normal"]), _t(a_rand)))

    jbuf, jbs, tbuf, tbs, draws = _rings(steps)
    jprep, tprep = jalgo.prepare_offline(jbuf, jbs), talgo.prepare_offline(tbuf, tbs)
    if variant == "calql":
        _close(tprep.storage["calibration_return"], jprep.storage["calibration_return"], rtol=1e-5,
               msg="calibration returns")
    else:
        assert tprep is tbs
    logs = {"normal": [], "uniform": []}
    with pytest.MonkeyPatch.context() as mp:
        for name, log in logs.items():
            mp.setattr(jax.random, name, _recording(getattr(jax.random, name), log))
        update = jax.jit(lambda ts, k: jalgo.update(ts, jbuf, jprep, k, B))
        for step in (1, 2):
            del draws[:], logs["normal"][:], logs["uniform"][:]
            jts, _, jm = update(jts, jax.random.key(10 + step))
            jax.effects_barrier()
            _replay(tbuf, draws)
            tts, _, tm = talgo.update(tts, tbuf, tprep, None, B, **draws_of(logs))
            _assert_metrics(tm, jm, f"cql {variant} step {step}")
            compare(jts, tts, step)
            assert tts.step == int(jts.step) == step


def test_calql_calibration_returns_are_reward_to_go():
    """tests/test_offline_e2e.py:309-355 on the port: per ring slot, the
    discounted reward to go within its episode."""
    _, talgo = _cql_pair(calibrated=True)
    steps = _steps(3, "box", n=40)
    _, _, tbuf, tbs, _ = _rings(steps)
    cal = talgo.prepare_offline(tbuf, tbs).storage["calibration_return"].numpy()
    rew = tbs.storage["rew"].numpy()
    done = (tbs.storage["terminated"] | tbs.storage["truncated"]).numpy()
    for n in range(N_ENVS):
        start = int(tbs.cursor[n] - tbs.size[n]) % CAP
        ret = 0.0
        for p in reversed([(start + t) % CAP for t in range(int(tbs.size[n]))]):
            ret = rew[n, p] + 0.9 * (0.0 if done[n, p] else ret)
            np.testing.assert_allclose(cal[n, p], ret, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("threshold, rises", [(-1e6, True), (1e6, False)])
def test_cql_lagrange_dual_direction(threshold, rises):
    """The dual rises while the penalty exceeds the threshold (pushing the
    critic down harder) and falls while it is below."""
    _, talgo = _cql_pair(with_lagrange=True, lagrange_threshold=threshold)
    _, _, tbuf, tbs, _ = _rings(_steps(3, "box"))
    tts = talgo.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    la0 = float(tts.cql_log_alpha.detach())
    for _ in range(5):
        tts, _, metrics = talgo.update(tts, tbuf, tbs, g, B)
    assert (float(tts.cql_log_alpha.detach()) > la0) == rises and "cql_alpha" in metrics
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def _discrete_two_updates(jalgo, talgo, steps, parts, heads=None):
    """Two updates of a discrete offline algorithm whose parameters are a
    dict of nets (``parts`` names them; ``None``: one net)."""
    jts = jalgo.init(jax.random.key(0), jnp.asarray(steps[0]["obs"][0]))
    tts = talgo.init(torch.Generator().manual_seed(0))
    for mod, params in ((tts.online, jts.params), (tts.target, jts.target_params)):
        if parts is None:
            _load(mod, params)
        else:
            for p in parts:
                _load(mod[p], params[p])

    def compare(jts, tts, step):
        for mod, params, what in ((tts.online, jts.params, "online"), (tts.target, jts.target_params, "target")):
            for p in parts or (None,):
                _assert_module(mod if p is None else mod[p], params if p is None else params[p],
                               f"step {step} {what} {p}")

    return _two_updates(jalgo, jts, talgo, tts, steps, compare)


def test_discrete_bcq_two_updates_match_jax():
    kw = dict(lr=1e-2, gamma=0.9, target_update_freq=2, unlikely_action_threshold=0.3, imitation_logits_penalty=1e-2)
    jalgo = jo.DiscreteBCQ(jc.QNet(HID, 3), jc.QNet(HID, 3), JaxDiscrete(3), **kw)
    talgo = to.DiscreteBCQ(tc.QNet(4, HID, 3), tc.QNet(4, HID, 3), Discrete(3), device="cpu", **kw)
    jts, tts = _discrete_two_updates(jalgo, talgo, _steps(4, 3), ("q", "imitation"))
    # the target copy fired at the second update
    for k, v in tts.target.state_dict().items():
        torch.testing.assert_close(v, tts.online.state_dict()[k])
    obs = np.random.default_rng(9).normal(size=(64, 4)).astype(np.float32) * 3
    ref, _ = jalgo.act(jts, jnp.asarray(obs), jax.random.key(0), explore=False)
    np.testing.assert_array_equal(talgo.act(tts, _t(obs), None, explore=False).numpy(), np.asarray(ref))


def test_discrete_cql_two_updates_match_jax():
    kw = dict(num_quantiles=8, min_q_weight=10.0, gamma=0.9, n_step=3, target_update_freq=2, lr=1e-2)
    jalgo = jo.DiscreteCQL(jd.QRDQNNet(HID, 3, num_quantiles=8), JaxDiscrete(3), **kw)
    talgo = to.DiscreteCQL(td.QRDQNNet(4, HID, 3, num_quantiles=8), Discrete(3), device="cpu", **kw)
    _discrete_two_updates(jalgo, talgo, _steps(4, 3), None)


@pytest.mark.parametrize("mode", ["exp", "binary", "all"])
def test_discrete_crr_two_updates_match_jax(mode):
    kw = dict(lr=1e-2, gamma=0.9, policy_improvement_mode=mode, beta=0.5, min_q_weight=10.0, target_update_freq=2)
    jalgo = jo.DiscreteCRR(jc.QNet(HID, 3), jc.QNet(HID, 3), JaxDiscrete(3), **kw)
    talgo = to.DiscreteCRR(tc.QNet(4, HID, 3), tc.QNet(4, HID, 3), Discrete(3), device="cpu", **kw)
    _discrete_two_updates(jalgo, talgo, _steps(4, 3), ("actor", "critic"))


def test_offline_updates_take_the_per_update_branch():
    """Every offline class but TD3BC overrides ``update``; the trainer's
    update loop then calls it once per update, never the presample."""
    from tianshou_tpu_torch.algos.base import Algorithm

    for cls in (to.BC, to.BCQ, to.CQL, to.DiscreteBCQ, to.DiscreteCQL, to.DiscreteCRR):
        assert cls.update is not Algorithm.update, cls.__name__
    assert to.TD3BC.update is Algorithm.update and to.TD3BC.supports_presampled
    assert dataclasses.is_dataclass(to.CQLTrainState) and dataclasses.is_dataclass(to.BCQTrainState)
