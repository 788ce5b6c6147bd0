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
