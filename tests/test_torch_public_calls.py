"""Public calls of already-ported modules against the JAX package's, on
the CPU: ``ReplayBuffer.sample``; ``contains`` and ``dtype`` of
``Discrete``, ``MultiDiscrete`` and ``Box``; ``MovAvg.mean`` and
``MovAvg.std``; ``HostVectorEnv.seed``; ``A2C.values``;
``FQF.q_values_fqf``; the ``data/tree.py`` helpers.  Values within atol
1e-5 (network outputs) or exactly; the port's discrete dtype is int64
where the JAX package's is int32.  Also the exploration noise of
``exploration/noise.py``: the same draws give the JAX package's values, and
the JAX package's own noise tests (tests/test_spaces_noise.py: moments,
mean reversion, correlation; tests/test_utils_misc.py
``test_noise_processes``) hold on the port's processes.
"""

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.a2c import A2C as JaxA2C
from tianshou_tpu.algos.qrdqn import FQF as JaxFQF
from tianshou_tpu.data import tree as jtree
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs import spaces as jspaces
from tianshou_tpu.envs.host import HostVectorEnv as JaxHostVectorEnv
from tianshou_tpu.exploration.noise import GaussianNoise as JaxGaussianNoise
from tianshou_tpu.exploration.noise import OUNoise as JaxOUNoise
from tianshou_tpu.networks import common as jc
from tianshou_tpu.networks import continuous as jcont
from tianshou_tpu.networks import discrete as jd
from tianshou_tpu.utils.statistics import MovAvg as JaxMovAvg
from tianshou_tpu_torch.algos.a2c import A2C
from tianshou_tpu_torch.algos.qrdqn import FQF
from tianshou_tpu_torch.data import tree as ttree
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs import spaces as tspaces
from tianshou_tpu_torch.envs.host import HostVectorEnv
from tianshou_tpu_torch.exploration.noise import GaussianNoise, OUNoise
from tianshou_tpu_torch.networks import common as tc
from tianshou_tpu_torch.networks import continuous as tcont
from tianshou_tpu_torch.networks import discrete as td
from tianshou_tpu_torch.networks.convert import onpolicy_state_from_flax, params_from_flax
from tianshou_tpu_torch.utils.statistics import MovAvg

OBS, HID = 4, (16, 16)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, ref, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5, atol=atol, err_msg=msg)


def test_replay_buffer_sample_matches_jax():
    rng = np.random.default_rng(0)
    jbuf, tbuf = JaxReplayBuffer(8, 2), ReplayBuffer(8, 2)
    steps = [dict(obs=rng.normal(size=(2, 3)).astype(np.float32), act=rng.integers(0, 3, 2),
                  rew=rng.normal(size=2).astype(np.float32), terminated=rng.random(2) < 0.2,
                  truncated=np.zeros(2, bool), obs_next=rng.normal(size=(2, 3)).astype(np.float32))
             for _ in range(11)]
    jbs = jbuf.init(JaxBatch({k: jnp.asarray(v[0]) for k, v in steps[0].items()}))
    tbs = tbuf.init(Batch({k: _t(v[0]) for k, v in steps[0].items()}), device="cpu")
    for tr in steps:
        jbs = jbuf.add(jbs, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
        tbs = tbuf.add(tbs, Batch({k: _t(v) for k, v in tr.items()}))
    env_idx, pos = rng.integers(0, 2, 13), rng.integers(0, 8, 13)
    jbuf.sample_indices = lambda st, key, b: (jnp.asarray(env_idx), jnp.asarray(pos))
    jbatch, jenv, jpos = jbuf.sample(jbs, jax.random.key(0), 13)
    idx = tbuf.sample_indices  # the port's own draw first: valid slots
    for i in range(20):
        e, p = idx(tbs, torch.Generator().manual_seed(i), 13)
        assert bool(((e >= 0) & (e < 2) & (p >= 0) & (p < 8)).all())
    tbuf.sample_indices = lambda st, g, b: (_t(env_idx), _t(pos))
    tbatch, tenv, tpos = tbuf.sample(tbs, torch.Generator().manual_seed(0), 13)
    np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert set(tbatch) == set(jbatch) and "done" in tbatch
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)


SPACES = [
    (jspaces.Discrete(5), tspaces.Discrete(5), [0, 4, 5, -1, [1, 2], [[3, 4]], [0, 7]]),
    (jspaces.MultiDiscrete((3, 4)), tspaces.MultiDiscrete((3, 4)), [[0, 0], [2, 3], [3, 0], [0, 4], [[1, 1], [2, 3]],
                                                                    [-1, 2]]),
    (jspaces.Box(-1.0, 2.0, (2,)), tspaces.Box(-1.0, 2.0, (2,)), [[0.0, 0.0], [-1.0, 2.0], [-1.0000005, 2.0000005],
                                                               [-1.1, 0.0], [0.0, 2.01], [[0.5, 1.5], [3.0, 0.0]]]),
    (jspaces.Box((-1.0, 0.0), (1.0, 5.0), (2,)), tspaces.Box((-1.0, 0.0), (1.0, 5.0), (2,)),
     [[0.0, 4.0], [0.5, -0.1], [1.0, 5.0], [-2.0, 1.0]]),
]


@pytest.mark.parametrize("case", range(len(SPACES)))
def test_space_contains_and_dtype_match_jax(case):
    jsp, tsp, values = SPACES[case]
    for v in values:
        for x in (v, np.asarray(v), torch.as_tensor(v)):
            assert tsp.contains(x) == jsp.contains(np.asarray(v)), (v, type(x))
    assert {False, True} <= {jsp.contains(np.asarray(v)) for v in values}
    jkind, tkind = np.dtype(jsp.dtype).kind, torch.empty((), dtype=tsp.dtype).numpy().dtype.kind
    assert jkind == tkind
    sample = tsp.sample(torch.Generator().manual_seed(0), (64,))
    assert sample.dtype == tsp.dtype and tsp.contains(sample)


def test_movavg_mean_and_std_match_jax():
    jm, tm = JaxMovAvg(size=5), MovAvg(size=5)
    assert tm.mean() == jm.mean() == 0.0 and tm.std() == jm.std() == 0.0
    for value in (1.0, [2.0, np.nan, 3.0], np.inf, [4.0, 5.0, -6.0], 7.5):
        assert tm.add(value) == jm.add(value)
        assert tm.mean() == jm.mean() and tm.std() == jm.std()
    assert tm.std() > 0


def test_host_vector_env_seed_matches_jax():
    jenv = JaxHostVectorEnv([lambda: gym.make("CartPole-v1")] * 3)
    tenv = HostVectorEnv([lambda: gym.make("CartPole-v1")] * 3)
    try:
        jenv.seed(7)
        tenv.seed(7)
        assert tenv._seeds == jenv._seeds == [7, 8, 9]
        np.testing.assert_array_equal(tenv.reset(seed=7), jenv.reset(seed=7))
    finally:
        jenv.close()
        tenv.close()


def test_a2c_values_match_jax():
    jalgo = JaxA2C(jc.QNet(HID, 2), jcont.ValueNet(HID), jspaces.Discrete(2))
    talgo = A2C(tc.QNet(OBS, HID, 2), tcont.ValueNet(OBS, HID), tspaces.Discrete(2), device="cpu")
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.load(onpolicy_state_from_flax(jax.device_get(jts)))
    obs = np.random.default_rng(1).normal(size=(7, OBS)).astype(np.float32)
    ref = jalgo.values(jts.params["critic"], jnp.asarray(obs))
    with torch.no_grad():
        got = talgo.values(tts.critic, torch.from_numpy(obs))
    assert got.shape == (7,)
    _close(got, ref)


def test_fqf_q_values_match_jax():
    kw = dict(num_fractions=8, fraction_lr=1e-3)
    jalgo = JaxFQF(jd.FullQuantileFunction(HID, 3), jd.FractionProposalNetwork(num_fractions=8), jspaces.Discrete(3),
                   **kw)
    talgo = FQF(td.FullQuantileFunction(OBS, HID, 3), td.FractionProposalNetwork(HID[-1], 8), tspaces.Discrete(3),
                device="cpu", **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    tts = talgo.init(torch.Generator().manual_seed(0))
    tts.online.load_state_dict(params_from_flax(jax.device_get(jts.params)))
    tts.fraction.load_state_dict(params_from_flax(jax.device_get(jts.fraction_params), heads=("head",)))
    obs = (np.random.default_rng(2).normal(size=(9, OBS)) * 2).astype(np.float32)
    ref = jalgo.q_values_fqf(jts, jnp.asarray(obs))
    with torch.no_grad():
        got = talgo.q_values_fqf(tts, torch.from_numpy(obs))
    assert got.shape == (9, 3)
    _close(got, ref)
    torch.testing.assert_close(talgo.act(tts, torch.from_numpy(obs), None, explore=False), got.argmax(-1))


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    a = {"obs": rng.normal(size=(4, 3)).astype(np.float32), "act": rng.integers(0, 5, 4),
         "nested": {"h": rng.normal(size=(4, 2, 2)).astype(np.float32)}}
    return a, jax.tree.map(jnp.asarray, a), ttree.tree_map(_t, a)


def _equal(got, ref):
    jax.tree.map(lambda r, g: np.testing.assert_array_equal(g.numpy(), np.asarray(r)), ref, got)


def test_tree_helpers_match_jax():
    a, ja, ta = _trees(0)
    b, jb, tb = _trees(1)
    idx = np.array([2, 0, 3])
    _equal(ttree.tree_slice(ta, _t(idx)), jtree.tree_slice(ja, jnp.asarray(idx)))
    _equal(ttree.tree_slice(ta, 1), jtree.tree_slice(ja, 1))
    cond = np.array([True, False, False, True])
    _equal(ttree.tree_where(_t(cond), ta, tb), jtree.tree_where(jnp.asarray(cond), ja, jb))
    assert ttree.tree_where(_t(cond), (), ()) == ()
    example = {"x": np.zeros((3,), np.float32), "n": np.zeros((), np.int32)}
    jz = jtree.tree_zeros_like_leading(example, (2, 5))
    tz = ttree.tree_zeros_like_leading(ttree.tree_map(_t, example), (2, 5))
    _equal(tz, jz)
    assert tz["x"].dtype == torch.float32 and tz["n"].dtype == torch.int32
    value = ttree.tree_slice(tb, 0)
    jv = jtree.tree_slice(jb, 0)
    updated = ttree.tree_dynamic_update(ta, value, 2)
    _equal(updated, jtree.tree_dynamic_update(ja, jv, 2))
    _equal(ta, ja)  # the input tree is unchanged, as the JAX call's
    assert ttree.tree_leading_shape(ta) == jtree.tree_leading_shape(ja) == (4,)
    assert ttree.tree_leading_shape(ta, 2) == jtree.tree_leading_shape(ja, 2) == (4,)  # "act" sorts first
    assert ttree.tree_leading_shape(ttree.tree_slice(ta, 0)["nested"], 2) == (2, 2)
    assert ttree.tree_leading_shape(()) == jtree.tree_leading_shape(()) == ()


# -- exploration noise ------------------------------------------------------------
def test_noise_matches_jax_on_the_same_draws():
    normal = np.random.default_rng(3).normal(size=(6,)).astype(np.float32)
    key = jax.random.key(0)
    jg, tg = JaxGaussianNoise(mu=0.5, sigma=2.0), GaussianNoise(mu=0.5, sigma=2.0, device="cpu")
    _, tx = tg.sample(tg.init_state((6,)), None, (6,), normal=_t(normal))
    _, jx = jg.sample(jg.init_state((6,)), key, (6,))
    _close(tx, 0.5 + 2.0 * normal)
    assert jx.shape == tx.shape
    jo, to = JaxOUNoise(sigma=0.3, theta=0.15, x0=1.0), OUNoise(sigma=0.3, theta=0.15, x0=1.0, device="cpu")
    jst, tst = jo.init_state((6,)), to.init_state((6,))
    _close(tst, jst)
    for i in range(3):
        k = jax.random.key(i)
        jst, jx = jo.sample(jst, k)
        tst, tx = to.sample(tst, None, normal=_t(jax.random.normal(k, (6,))))
        _close(tx, jx, msg=f"OU step {i}")
        torch.testing.assert_close(tx, tst)


def test_gaussian_noise_moments():
    """tests/test_spaces_noise.py ``test_gaussian_noise_moments``."""
    noise = GaussianNoise(mu=0.5, sigma=2.0, device="cpu")
    st = noise.init_state((4,))
    _, x = noise.sample(st, torch.Generator().manual_seed(0), (50000,))
    assert abs(float(x.mean()) - 0.5) < 0.05
    assert abs(float(x.std()) - 2.0) < 0.05


def test_ou_noise_mean_reversion_and_stationary_variance():
    """tests/test_spaces_noise.py
    ``test_ou_noise_mean_reversion_and_stationary_variance``."""
    noise = OUNoise(mu=0.0, sigma=0.3, theta=0.15, dt=0.01, x0=2.0, device="cpu")
    st = noise.init_state((2000,))
    g = torch.Generator().manual_seed(0)
    first = None
    for _ in range(500):
        st, x = noise.sample(st, g)
        if first is None:
            first = float(x.mean().abs())
    # mean decays from x0=2 toward mu=0
    assert float(st.mean()) < first / 2
    # stationary std ~ sigma * sqrt(dt / (2 theta dt)) = sigma/sqrt(2 theta)
    target = 0.3 * np.sqrt(0.01) / np.sqrt(2 * 0.15 * 0.01)
    assert abs(float(st.std()) - target) < 0.15 * target


def test_ou_noise_is_correlated_gaussian_is_not():
    """tests/test_spaces_noise.py ``test_ou_noise_is_correlated_gaussian_is_not``."""
    ou = OUNoise(dt=0.01, device="cpu")
    g = GaussianNoise(device="cpu")
    gen = torch.Generator().manual_seed(1)
    st = ou.init_state((5000,))
    xs = []
    for _ in range(2):
        st, x = ou.sample(st, gen)
        xs.append(x.numpy())
    ou_corr = np.corrcoef(xs[0], xs[1])[0, 1]
    _, ga = g.sample(None, gen, (5000,))
    _, gb = g.sample(None, gen, (5000,))
    g_corr = np.corrcoef(ga.numpy(), gb.numpy())[0, 1]
    # from x0=0, consecutive OU steps share the first increment:
    # corr(x1, x2) ~ 1/sqrt(2) for small theta*dt; i.i.d. Gaussian is ~0
    assert ou_corr > 0.5, ou_corr
    assert abs(g_corr) < 0.05


def test_noise_processes():
    """tests/test_utils_misc.py ``test_noise_processes``."""
    g = GaussianNoise(sigma=2.0, device="cpu")
    st = g.init_state((4,))
    st, n = g.sample(st, torch.Generator().manual_seed(0), (1000,))
    assert 1.5 < float(n.std()) < 2.5
    ou = OUNoise(sigma=0.3, theta=0.15, device="cpu")
    st = ou.init_state((4,))
    vals = []
    for i in range(100):
        st, n = ou.sample(st, torch.Generator().manual_seed(i))
        vals.append(n.numpy())
    # mean-reverting around 0, temporally correlated
    arr = np.stack(vals)
    assert abs(arr.mean()) < 0.5
    corr = np.corrcoef(arr[:-1, 0], arr[1:, 0])[0, 1]
    assert corr > 0.5
