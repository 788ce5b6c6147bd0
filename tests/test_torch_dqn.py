"""DQN port (tianshou_tpu_torch/algos/dqn.py) against the JAX DQN: from the
same parameters and the same sampled tuple, in float32, three update_sampled
steps give the same loss and parameters within rtol 1e-4 / atol 1e-5 (Adam's
bias correction rounds differently in optax and PyTorch), and the target
copy fires at target_update_freq."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.algos.dqn import DQN as JaxDQN
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
from tianshou_tpu.networks.conv import ConvQNet as JaxConvQNet
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.envs.spaces import Discrete
from tianshou_tpu_torch.networks.conv import ConvQNet
from tianshou_tpu_torch.networks.convert import params_from_flax

OBS, A, B, N_STEP = (36, 36, 2), 4, 16, 3


def make_pair(target_update_freq, seed=0, lr=1e-3, gamma=0.99):
    jalgo = JaxDQN(
        JaxConvQNet(num_actions=A, encoder="nature", encoder_kwargs={"compute_dtype": jnp.float32}),
        JaxDiscrete(A), lr=lr, gamma=gamma, n_step=N_STEP, target_update_freq=target_update_freq,
    )
    jts = jalgo.init(jax.random.key(seed), jnp.zeros(OBS, jnp.uint8))
    talgo = DQN(
        ConvQNet(OBS, A, encoder_kwargs={"compute_dtype": torch.float32}), Discrete(A),
        lr=lr, gamma=gamma, n_step=N_STEP, target_update_freq=target_update_freq, device="cpu",
    )
    tts = talgo.init(torch.Generator().manual_seed(seed))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    return jalgo, jts, talgo, tts


def sampled_pair(seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        env_idx=rng.integers(0, 2, B).astype(np.int32),
        pos=rng.integers(0, 8, B).astype(np.int32),
        weight=np.ones(B, np.float32),
        obs=rng.integers(0, 256, (B, *OBS), dtype=np.uint8),
        act=rng.integers(0, A, B).astype(np.int32),
        rew_chain=rng.normal(size=(B, N_STEP)).astype(np.float32),
        done_chain=(rng.random((B, N_STEP)) < 0.2).astype(np.int32),
        obs_next=rng.integers(0, 256, (B, *OBS), dtype=np.uint8),
        terminated=rng.random(B) < 0.3,
    )
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    jax_sampled = (j["env_idx"], j["pos"], j["weight"], JaxBatch(obs=j["obs"], act=j["act"]),
                   j["rew_chain"], j["done_chain"], JaxBatch(obs_next=j["obs_next"], terminated=j["terminated"]))
    torch_sampled = (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]),
                     t["rew_chain"], t["done_chain"], Batch(obs_next=t["obs_next"], terminated=t["terminated"]))
    return jax_sampled, torch_sampled


def assert_params_close(torch_module, flax_params, rtol=1e-4, atol=1e-5):
    ref = params_from_flax(jax.device_get(flax_params))
    got = torch_module.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=rtol, atol=atol, err_msg=k)


def test_three_updates_match_jax():
    jalgo, jts, talgo, tts = make_pair(target_update_freq=2)
    jbuf = JaxReplayBuffer(8, 2)  # uniform replay: update_priorities is a no-op
    update = jax.jit(lambda ts, s: jalgo.update_sampled(ts, jbuf, None, s, jax.random.key(0)))
    for step in range(1, 4):
        js, ts_ = sampled_pair(step)
        jts, _, jm = update(jts, js)
        tts, _, tm = talgo.update_sampled(tts, None, None, ts_)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(tm["td_abs_mean"]), float(jm["td_abs_mean"]), rtol=1e-4, atol=1e-5)
        assert tts.step == int(jts.step) == step
        assert_params_close(tts.online, jts.params)
        assert_params_close(tts.target, jts.target_params)


@pytest.mark.parametrize("freq", [0, 1, 2, 3])
def test_target_copy_fires_at_target_update_freq(freq):
    _, _, talgo, tts = make_pair(target_update_freq=freq)
    initial = {k: v.clone() for k, v in tts.online.state_dict().items()}
    for step in range(1, 5):
        _, ts_ = sampled_pair(10 + step)
        tts, _, _ = talgo.update_sampled(tts, None, None, ts_)
        online = tts.online.state_dict()
        target = tts.target.state_dict()
        same = all(torch.equal(online[k], target[k]) for k in online)
        if freq == 0:
            assert tts.target is tts.online
        elif step % freq == 0:
            assert same, step
        else:
            assert not same, step
            if step < freq:
                assert all(torch.equal(initial[k], target[k]) for k in target)
    assert all(not p.requires_grad for p in tts.target.parameters()) or freq == 0


def test_eps_greedy_act():
    _, _, talgo, tts = make_pair(target_update_freq=0)
    obs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (64, *OBS), dtype=np.uint8))
    greedy = tts.online(obs).argmax(-1)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(talgo.act(tts, obs, g, explore=False), greedy)
    assert torch.equal(talgo.act(tts, obs, g, explore=True, explore_param=0.0), greedy)
    rand = talgo.act(tts, obs, g, explore=True, explore_param=1.0)
    assert rand.dtype == torch.int64 and int(rand.min()) >= 0 and int(rand.max()) < A
    assert len(torch.unique(rand)) > 1


# -- the options of slice 2: is_double=False, huber=True, action masks -----
MLP_OBS, MLP_A = 8, 5


def make_mlp_pair(seed=0, **options):
    from tianshou_tpu.networks.common import QNet as JaxQNet
    from tianshou_tpu_torch.networks.common import QNet

    kw = dict(lr=1e-3, gamma=0.9, n_step=N_STEP, target_update_freq=2, **options)
    jalgo = JaxDQN(JaxQNet((32, 32), MLP_A), JaxDiscrete(MLP_A), **kw)
    jts = jalgo.init(jax.random.key(seed), jnp.zeros((MLP_OBS,), jnp.float32))
    talgo = DQN(QNet(MLP_OBS, (32, 32), MLP_A), Discrete(MLP_A), device="cpu", **kw)
    tts = talgo.init(torch.Generator().manual_seed(seed))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    return jalgo, jts, talgo, tts


def mlp_sampled_pair(seed, masked):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, MLP_OBS)).astype(np.float32) * 3
    obs_next = rng.normal(size=(B, MLP_OBS)).astype(np.float32) * 3
    common = dict(
        env_idx=rng.integers(0, 2, B).astype(np.int32), pos=rng.integers(0, 8, B).astype(np.int32),
        weight=rng.uniform(0.5, 1.5, B).astype(np.float32), act=rng.integers(0, MLP_A, B).astype(np.int32),
        rew_chain=(rng.normal(size=(B, N_STEP)) * 3).astype(np.float32),
        done_chain=(rng.random((B, N_STEP)) < 0.2).astype(np.int32), terminated=rng.random(B) < 0.3,
    )
    if masked:
        mask = rng.random((B, MLP_A)) < 0.6
        mask[np.arange(B), common["act"]] = True
        mask_next = rng.random((B, MLP_A)) < 0.6
        mask_next[:, 0] = True
        obs = {"obs": obs, "mask": mask}
        obs_next = {"obs": obs_next, "mask": mask_next}

    def side(asarray, batch):
        c = {k: asarray(v) for k, v in common.items()}
        tree = lambda o: batch({k: asarray(v) for k, v in o.items()}) if isinstance(o, dict) else asarray(o)
        return (c["env_idx"], c["pos"], c["weight"], batch(obs=tree(obs), act=c["act"]), c["rew_chain"],
                c["done_chain"], batch(obs_next=tree(obs_next), terminated=c["terminated"]))

    return side(jnp.asarray, JaxBatch), side(torch.from_numpy, Batch)


@pytest.mark.parametrize("options", [dict(is_double=False), dict(huber=True), dict(masked=True)],
                         ids=["single-q", "huber", "action-mask"])
def test_three_updates_with_options_match_jax(options):
    masked = options.pop("masked", False)
    jalgo, jts, talgo, tts = make_mlp_pair(**options)
    jbuf = JaxReplayBuffer(8, 2)
    update = jax.jit(lambda ts, s: jalgo.update_sampled(ts, jbuf, None, s, jax.random.key(0)))
    for step in range(1, 4):
        js, ts_ = mlp_sampled_pair(step, masked)
        jts, _, jm = update(jts, js)
        tts, _, tm = talgo.update_sampled(tts, None, None, ts_)
        for k in ("loss", "td_abs_mean"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
        assert_params_close(tts.online, jts.params)
        assert_params_close(tts.target, jts.target_params)
    if options.get("huber"):
        assert float(tm["td_abs_mean"]) > 1.0  # the loss's linear branch was taken


def test_masked_act_respects_the_mask():
    jalgo, jts, talgo, tts = make_mlp_pair()
    rng = np.random.default_rng(0)
    n = 20_000
    obs = torch.from_numpy(rng.normal(size=(n, MLP_OBS)).astype(np.float32))
    mask = torch.zeros(n, MLP_A, dtype=torch.bool)
    mask[:, [1, 3, 4]] = True
    o = Batch(obs=obs, mask=mask)
    greedy = talgo.act(tts, o, torch.Generator().manual_seed(0), explore=False)
    ref = np.asarray(jalgo.act(jts, JaxBatch(obs=jnp.asarray(obs.numpy()), mask=jnp.asarray(mask.numpy())),
                               jax.random.key(0), False)[0])
    np.testing.assert_array_equal(greedy.numpy(), ref)
    rand = talgo.act(tts, o, torch.Generator().manual_seed(1), explore=True, explore_param=1.0)
    counts = np.bincount(rand.numpy(), minlength=MLP_A)
    assert counts[[0, 2]].sum() == 0
    expected = n / 3
    chi2 = ((counts[[1, 3, 4]] - expected) ** 2 / expected).sum()
    assert chi2 < 25.0, counts  # 2 degrees of freedom: 25 lies beyond the 1e-5 tail


def test_random_policy_respects_mask_and_box():
    from tianshou_tpu_torch.algos.base import RandomPolicy
    from tianshou_tpu_torch.envs.spaces import Box

    g = torch.Generator().manual_seed(0)
    n = 6000
    mask = torch.zeros(n, 4, dtype=torch.bool)
    mask[: n // 2, :2] = True
    mask[n // 2:, 3] = True
    pol = RandomPolicy(Discrete(4), device="cpu")
    ts = pol.init(g)
    a = pol.act(ts, Batch(obs=torch.zeros(n, 2), mask=mask), g, True)
    assert bool(mask[torch.arange(n), a].all())
    assert abs(float((a[: n // 2] == 0).float().mean()) - 0.5) < 0.05
    a = pol.act(ts, torch.zeros(n, 2), g, True)
    assert set(a.tolist()) == {0, 1, 2, 3}
    box = RandomPolicy(Box(low=(-2.0, 0.0), high=(2.0, 1.0), shape=(2,)), device="cpu")
    a = box.act(ts, torch.zeros(n, 3), g, True)
    assert a.shape == (n, 2) and float(a.min()) >= -1.0 and float(a.max()) <= 1.0
    env_a = box.map_action(a)
    assert float(env_a[:, 0].min()) >= -2.0 and float(env_a[:, 1].max()) <= 1.0
    assert float(env_a[:, 0].min()) < -1.9 and float(env_a[:, 0].max()) > 1.9
