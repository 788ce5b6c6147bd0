"""The distributional DQN family of the port (tianshou_tpu_torch:
networks/discrete, ConvQRDQNNet, algos/c51, algos/qrdqn) against the JAX
package, on the CPU in float32 at a small size (obs 4, actions 3, hidden
(32, 32), batch 16).

- Forwards with weights carried by params_from_flax, atol 1e-5:
  NoisyLinear and C51Net (noisy dueling, noisy single-stream, plain) with
  the JAX package's own noise draws injected, QRDQNNet, IQN and FQF at the
  same fractions, FQF's fraction proposals, ConvQRDQNNet at MinAtar's shape.
- quantile_huber_loss and C51's projection, atol 1e-6, and the projection's
  identity and terminal cases of tests/test_distributional_e2e.py.
- Two updates each of C51, Rainbow, QRDQN, IQN and FQF from the same
  parameters and batch (Rainbow's noise and IQN's fractions recorded from
  the JAX update and injected): losses, every parameter (online, target,
  FQF's fraction proposal) and the written-back priorities within rtol 1e-4
  / atol 1e-5; the target copy fires at the second update.
- The optax-form RMSprop against optax.rmsprop at gradients near 1e-4,
  where torch.optim.RMSprop's placement of eps differs by orders of
  magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tianshou_tpu.algos.c51 import C51 as JaxC51
from tianshou_tpu.algos.c51 import Rainbow as JaxRainbow
from tianshou_tpu.algos.qrdqn import FQF as JaxFQF
from tianshou_tpu.algos.qrdqn import IQN as JaxIQN
from tianshou_tpu.algos.qrdqn import QRDQN as JaxQRDQN
from tianshou_tpu.algos.qrdqn import quantile_huber_loss as jax_qhl
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.networks import conv as jconv
from tianshou_tpu.networks import discrete as jd
from tianshou_tpu_torch.algos.c51 import C51, Rainbow
from tianshou_tpu_torch.algos.qrdqn import FQF, IQN, QRDQN, RMSprop, quantile_huber_loss
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.networks import conv as tconv
from tianshou_tpu_torch.networks import discrete as td
from tianshou_tpu_torch.networks.convert import params_from_flax

OBS, A, HID, B, N_STEP = 4, 3, (32, 32), 16, 2
ATOMS, QUANTILES, FRACTIONS = 11, 16, 8


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


class _RecordNormals:
    """Records every ``jax.random.normal`` draw the JAX package makes while
    on (the noisy layers draw theirs through it, in layer order)."""

    def __init__(self, monkeypatch):
        self.draws = []
        monkeypatch.setattr(jax.random, "normal", _recording(jax.random.normal, self.draws))

    def pairs(self, start, layers):
        """The ``(eps_in, eps_out)`` pairs of ``layers`` noisy layers from
        draw ``start`` on."""
        d = self.draws[start:start + 2 * layers]
        return [(_t(d[2 * i]), _t(d[2 * i + 1])) for i in range(layers)]


# -- networks -------------------------------------------------------------------
def _obs(n=9, seed=4):
    return (np.random.default_rng(seed).normal(size=(n, OBS)) * 2).astype(np.float32)


def test_noisy_linear_matches_flax(monkeypatch):
    x = _obs()
    jnet, tnet = jd.NoisyLinear(7), td.NoisyLinear(OBS, 7)
    params = jnet.init({"params": jax.random.key(0), "noise": jax.random.key(1)}, jnp.asarray(x))
    sd = params_from_flax({"NoisyMLP_0": {"NoisyLinear_0": jax.device_get(params["params"])}})
    tnet.load_state_dict({k.removeprefix("a.layers.0."): v for k, v in sd.items()})
    rec = _RecordNormals(monkeypatch)
    ref = jnet.apply(params, jnp.asarray(x), True, rngs={"noise": jax.random.key(2)})
    jax.effects_barrier()
    with torch.no_grad():
        _close(tnet(_t(x), rec.pairs(0, 1)[0]), ref, rtol=0)
        _close(tnet(_t(x)), jnet.apply(params, jnp.asarray(x), False), rtol=0)
    assert not np.allclose(np.asarray(ref), np.asarray(jnet.apply(params, jnp.asarray(x), False)))


@pytest.mark.parametrize("kind", ["noisy-dueling", "noisy-single", "plain"])
def test_c51_net_matches_flax(kind, monkeypatch):
    noisy, dueling = kind != "plain", kind == "noisy-dueling"
    x = _obs()
    jnet = jd.C51Net(HID, A, num_atoms=ATOMS, noisy=noisy, dueling=dueling)
    tnet = td.C51Net(OBS, HID, A, num_atoms=ATOMS, noisy=noisy, dueling=dueling)
    params = jnet.init({"params": jax.random.key(0), "noise": jax.random.key(1)}, jnp.asarray(x))
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    rec = _RecordNormals(monkeypatch)
    if noisy:
        ref = jnet.apply(params, jnp.asarray(x), True, rngs={"noise": jax.random.key(3)})
        jax.effects_barrier()
        layers = 4 if dueling else 2
        assert len(rec.draws) == 2 * layers
        noise = rec.pairs(0, layers)
        g = torch.Generator().manual_seed(0)
        drawn = td.draw_noise(tnet, g)
        assert [(a.shape, b.shape) for a, b in drawn] == [(a.shape, b.shape) for a, b in noise]
    else:
        ref, noise = jnet.apply(params, jnp.asarray(x)), None
    with torch.no_grad():
        got = tnet(_t(x), noise)
        assert got.shape == (9, A, ATOMS)
        _close(got, ref, rtol=0)
        _close(got.sum(-1), np.ones((9, A)), rtol=0)
        if noisy:
            _close(tnet(_t(x)), jnet.apply(params, jnp.asarray(x), False), rtol=0)


def test_quantile_nets_match_flax():
    x = _obs()
    taus = np.random.default_rng(5).random((9, 6)).astype(np.float32)
    # QRDQNNet
    jq, tq = jd.QRDQNNet(HID, A, num_quantiles=QUANTILES), td.QRDQNNet(OBS, HID, A, num_quantiles=QUANTILES)
    params = jq.init(jax.random.key(0), jnp.asarray(x))
    tq.load_state_dict(params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        _close(tq(_t(x)), jq.apply(params, jnp.asarray(x)), rtol=0)
    # IQN at the same fractions
    ji, ti = jd.ImplicitQuantileNetwork(HID, A), td.ImplicitQuantileNetwork(OBS, HID, A)
    params = ji.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(taus))
    ti.load_state_dict(params_from_flax(jax.device_get(params), heads=("phi", "head1", "head2")))
    with torch.no_grad():
        got = ti(_t(x), _t(taus))
        assert got.shape == (9, 6, A)
        _close(got, ji.apply(params, jnp.asarray(x), jnp.asarray(taus)), rtol=0)
    # FQF: the features, the quantiles and the fraction proposals
    jf, tf = jd.FullQuantileFunction(HID, A), td.FullQuantileFunction(OBS, HID, A)
    params = jf.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(taus))
    tf.load_state_dict(params_from_flax(jax.device_get(params)))
    jp, tp = jd.FractionProposalNetwork(num_fractions=FRACTIONS), td.FractionProposalNetwork(HID[-1], FRACTIONS)
    feat = jf.apply(params, jnp.asarray(x), method="features")
    fparams = jp.init(jax.random.key(3), feat)
    tp.load_state_dict(params_from_flax(jax.device_get(fparams), heads=("head",)))
    with torch.no_grad():
        tfeat = tf.features(_t(x))
        _close(tfeat, feat, rtol=0)
        _close(tf.quantiles(tfeat, _t(taus)), jf.apply(params, feat, jnp.asarray(taus), method="quantiles"),
               rtol=0)
        for g, r in zip(tp(tfeat), jp.apply(fparams, feat)):
            _close(g, r, rtol=0)


def test_conv_qrdqn_net_matches_flax_at_minatar_shape():
    x = np.random.default_rng(6).random((5, 10, 10, 4)).astype(np.float32)
    jnet = jconv.ConvQRDQNNet(num_actions=A, num_quantiles=QUANTILES, encoder="minatar",
                              encoder_kwargs={"compute_dtype": jnp.float32})
    tnet = tconv.ConvQRDQNNet((10, 10, 4), A, QUANTILES, "minatar", {"compute_dtype": torch.float32})
    params = jnet.init(jax.random.key(0), jnp.asarray(x))
    tnet.load_state_dict(params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        got = tnet(_t(x))
    assert got.shape == (5, A, QUANTILES)
    _close(got, jnet.apply(params, jnp.asarray(x)), rtol=0, atol=1e-4)


# -- losses and the projection ------------------------------------------------
def test_quantile_huber_loss_matches_jax():
    rng = np.random.default_rng(7)
    cur = (rng.normal(size=(B, 5)) * 2).astype(np.float32)
    tgt = (rng.normal(size=(B, 7)) * 2).astype(np.float32)
    tau = rng.random((B, 5)).astype(np.float32)
    for g, r in zip(quantile_huber_loss(_t(cur), _t(tgt), _t(tau)), jax_qhl(cur, tgt, tau)):
        _close(g, r, rtol=1e-6, atol=1e-6)
    # K = 1: zero loss against itself, |u| = 1 at a unit offset, and the
    # asymmetry at tau = 0.9
    c, t5 = torch.tensor([[0.5], [-1.0]]), torch.full((2, 1), 0.5)
    assert float(quantile_huber_loss(c, c, t5)[0].abs().max()) == 0.0
    loss, td_abs = quantile_huber_loss(c, c + 1.0, t5)
    assert bool((loss > 0).all()) and torch.equal(td_abs, torch.ones(2))
    t9 = torch.full((1, 1), 0.9)
    assert float(quantile_huber_loss(torch.zeros(1, 1), torch.ones(1, 1), t9)[0]) > float(
        quantile_huber_loss(torch.zeros(1, 1), -torch.ones(1, 1), t9)[0])


def _c51_pair(jcls=JaxC51, tcls=C51, noisy=False, **kw):
    kw = dict(num_atoms=ATOMS, v_min=-5.0, v_max=5.0, gamma=0.9, n_step=N_STEP, lr=1e-3, **kw)
    jalgo = jcls(jd.C51Net(HID, A, num_atoms=ATOMS, noisy=noisy), JaxDiscrete(A), **kw)
    talgo = tcls(td.C51Net(OBS, HID, A, num_atoms=ATOMS, noisy=noisy), Discrete(A), device="cpu", **kw)
    return jalgo, talgo


def test_projection_matches_jax_and_keeps_its_cases():
    jalgo, talgo = _c51_pair()
    rng = np.random.default_rng(8)
    probs = rng.dirichlet(np.ones(ATOMS), B).astype(np.float32)
    returns = (rng.normal(size=B) * 3).astype(np.float32)
    discount = rng.uniform(0.5, 1.0, B).astype(np.float32)
    mask = (rng.random(B) < 0.7).astype(np.float32)
    got = talgo._project(*map(_t, (probs, returns, discount, mask)))
    _close(got, jalgo._project(*map(jnp.asarray, (probs, returns, discount, mask))), rtol=0, atol=1e-6)
    _close(got.sum(-1), np.ones(B), rtol=0, atol=1e-6)
    # the support projected onto itself is the identity
    p = torch.softmax(_t(rng.normal(size=(4, ATOMS)).astype(np.float32)), -1)
    _close(talgo._project(p, torch.zeros(4), torch.ones(4), torch.ones(4)), p, rtol=0, atol=1e-6)
    # terminated: all mass on the atom at `returns` (+2 is atom 7)
    m = talgo._project(p, torch.full((4,), 2.0), torch.ones(4), torch.zeros(4))
    _close(m[:, 7], np.ones(4), rtol=0, atol=1e-6)


# -- updates --------------------------------------------------------------------
def _dqn_sampled(seed):
    """A DQN-style sampled tuple (C51, Rainbow) on both sides."""
    rng = np.random.default_rng(seed)
    a = dict(env_idx=rng.integers(0, 2, B).astype(np.int32), pos=rng.permutation(B).astype(np.int32),
             weight=rng.uniform(0.5, 1.5, B).astype(np.float32), obs=_obs(B, seed),
             act=rng.integers(0, A, B).astype(np.int32),
             rew_chain=(rng.normal(size=(B, N_STEP)) * 2).astype(np.float32),
             done_chain=(rng.random((B, N_STEP)) < 0.2).astype(np.int32), obs_next=_obs(B, seed + 50),
             terminated=rng.random(B) < 0.3)

    def side(asarray, batch):
        c = {k: asarray(v) for k, v in a.items()}
        return (c["env_idx"], c["pos"], c["weight"], batch(obs=c["obs"], act=c["act"]), c["rew_chain"],
                c["done_chain"], batch(obs_next=c["obs_next"], terminated=c["terminated"]))

    return side(jnp.asarray, JaxBatch), side(_t, Batch)


def _quantile_sampled(seed):
    """A quantile-family presample tuple on both sides."""
    rng = np.random.default_rng(seed)
    a = dict(env_idx=rng.integers(0, 2, B).astype(np.int32), pos=rng.permutation(B).astype(np.int32),
             weight=rng.uniform(0.5, 1.5, B).astype(np.float32), obs=_obs(B, seed),
             act=rng.integers(0, A, B).astype(np.int32), obs_next=_obs(B, seed + 50),
             terminated=rng.random(B) < 0.3, returns=(rng.normal(size=B) * 2).astype(np.float32),
             discount=rng.choice([0.9, 0.81], B).astype(np.float32))
    mask = 1.0 - a["terminated"].astype(np.float32)

    def side(asarray, batch):
        c = {k: asarray(v) for k, v in a.items()}
        return (c["env_idx"], c["pos"], c["weight"], batch(obs=c["obs"], act=c["act"]),
                batch(obs_next=c["obs_next"], terminated=c["terminated"]), asarray(mask), c["returns"],
                c["discount"])

    return side(jnp.asarray, JaxBatch), side(_t, Batch)


class _PriorityEcho:
    """A stand-in buffer for both packages whose write-back returns the
    priorities as the new buffer state (so that a jitted update returns
    them)."""

    @staticmethod
    def update_priorities(bstate, env_idx, pos, td_abs):
        return td_abs


def _make(kind):
    """``(jax algo, port algo, heads, fraction heads)`` with
    ``target_update_freq=2``."""
    common = dict(gamma=0.9, n_step=N_STEP, lr=1e-3, target_update_freq=2)
    if kind in ("c51", "rainbow"):
        jalgo, talgo = _c51_pair(*((JaxRainbow, Rainbow) if kind == "rainbow" else (JaxC51, C51)),
                                 noisy=kind == "rainbow", target_update_freq=2)
        return jalgo, talgo, None
    if kind == "qrdqn":
        return (JaxQRDQN(jd.QRDQNNet(HID, A, num_quantiles=QUANTILES), JaxDiscrete(A), num_quantiles=QUANTILES,
                         **common),
                QRDQN(td.QRDQNNet(OBS, HID, A, num_quantiles=QUANTILES), Discrete(A), num_quantiles=QUANTILES,
                      device="cpu", **common), None)
    if kind == "iqn":
        kw = dict(sample_size=8, online_sample_size=6, target_sample_size=5, **common)
        return (JaxIQN(jd.ImplicitQuantileNetwork(HID, A), JaxDiscrete(A), **kw),
                IQN(td.ImplicitQuantileNetwork(OBS, HID, A), Discrete(A), device="cpu", **kw),
                ("phi", "head1", "head2"))
    kw = dict(num_fractions=FRACTIONS, fraction_lr=1e-3, ent_coef=10.0, **common)
    return (JaxFQF(jd.FullQuantileFunction(HID, A), jd.FractionProposalNetwork(num_fractions=FRACTIONS),
                   JaxDiscrete(A), **kw),
            FQF(td.FullQuantileFunction(OBS, HID, A), td.FractionProposalNetwork(HID[-1], FRACTIONS), Discrete(A),
                device="cpu", **kw), None)


def _assert_params(module, flax_params, heads, msg):
    ref = params_from_flax(jax.device_get(flax_params), heads=heads)
    got = module.state_dict()
    assert set(got) == set(ref), msg
    for k in ref:
        _close(got[k], ref[k], rtol=1e-4, atol=1e-5, msg=f"{msg} {k}")


@pytest.mark.parametrize("kind", ["c51", "rainbow", "qrdqn", "iqn", "fqf"])
def test_two_updates_match_jax(kind, monkeypatch):
    jalgo, talgo, heads = _make(kind)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    sd = params_from_flax(jax.device_get(jts.params), heads=heads)
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    if kind == "fqf":
        tts.fraction.load_state_dict(params_from_flax(jax.device_get(jts.fraction_params), heads=("head",)))
    echo = _PriorityEcho()
    rec = _RecordNormals(monkeypatch) if kind == "rainbow" else None
    taus = []
    if kind == "iqn":
        jalgo._rowwise_taus = _recording(jalgo._rowwise_taus, taus)
    sampled = _dqn_sampled if kind in ("c51", "rainbow") else _quantile_sampled
    update = jax.jit(lambda ts, s, k: jalgo.update_sampled(ts, echo, None, s, k))
    for step in (1, 2):
        js, ts_ = sampled(step)
        key = jax.random.key(10 + step)
        start = len(rec.draws) if rec else len(taus)
        jts, jprio, jm = update(jts, js, key)
        jax.effects_barrier()
        if kind == "rainbow":
            d = rec.draws[start:]
            assert len(d) == 24 and all(np.array_equal(x, y) for x, y in zip(d[8:16], d[16:]))
            extra = dict(noise=(rec.pairs(start, 4), rec.pairs(start + 8, 4)))
        elif kind == "iqn":
            tau_t, tau_dbl, tau_onl = map(_t, taus[start:start + 3])  # the JAX update's call order
            extra = dict(taus=(tau_t, tau_onl, tau_dbl))
        else:
            extra = {}
        tts, tprio, tm = talgo.update_sampled(tts, echo, None, ts_, **extra)
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k], rtol=1e-4, atol=1e-5, msg=f"{kind} step {step} {k}")
        _close(tprio, jprio, rtol=1e-4, atol=1e-5, msg=f"{kind} step {step} priorities")
        assert tts.step == int(jts.step) == step
        _assert_params(tts.online, jts.params, heads, f"{kind} online")
        _assert_params(tts.target, jts.target_params, heads, f"{kind} target")
        if kind == "fqf":
            _assert_params(tts.fraction, jts.fraction_params, ("head",), "fqf fraction")
    # the target copy fired at step 2
    assert all(torch.equal(a, b) for a, b in zip(tts.online.state_dict().values(), tts.target.state_dict().values()))


def test_act_explores_and_stays_legal():
    obs = _t(_obs(512))
    g = torch.Generator().manual_seed(0)
    for kind in ("c51", "rainbow", "qrdqn", "iqn", "fqf"):
        _, talgo, _ = _make(kind)
        ts = talgo.init(torch.Generator().manual_seed(1))
        greedy = talgo.act(ts, obs, g, explore=False)
        assert greedy.shape == (512,) and int(greedy.min()) >= 0 and int(greedy.max()) < A
        explored = talgo.act(ts, obs, g, explore=True, explore_param=0.5)
        assert not torch.equal(explored, greedy), kind
        if kind == "rainbow":  # weight noise alone: epsilon is ignored
            assert torch.equal(talgo.act(ts, obs, g, explore=False), greedy)


# -- FQF's optimizer ----------------------------------------------------------
def test_rmsprop_matches_optax_at_small_gradients():
    rng = np.random.default_rng(9)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [(rng.normal(size=(5, 3)) * 1e-4).astype(np.float32) for _ in range(3)]
    opt = optax.rmsprop(1e-3)
    jp, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0))
    ours, theirs = RMSprop([tp], 1e-3), torch.optim.RMSprop([tp2 := torch.nn.Parameter(_t(p0))], lr=1e-3)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for param, o in ((tp, ours), (tp2, theirs)):
            param.grad = _t(g)
            o.step()
    _close(tp.detach(), jp, rtol=1e-6, atol=1e-8)
    # torch's own RMSprop moves by a different amount altogether here
    assert np.abs((tp2.detach() - _t(p0)).numpy()).max() > 10 * np.abs(np.asarray(jp) - p0).max()
