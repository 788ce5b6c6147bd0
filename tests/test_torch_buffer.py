"""Replay buffer port (tianshou_tpu_torch/data/buffer.py) against the JAX
buffer: the same write sequence gives identical storage, cursors and sizes;
the same (env_idx, pos) give identical next/prev positions, gathers and
n-step chains; uniform sampling passes a chi-square test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBuffer as JaxReplayBuffer
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer

N_ENVS, CAP = 3, 5


def _transitions(n_adds, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_adds):
        term = rng.random(N_ENVS) < 0.2
        trunc = (rng.random(N_ENVS) < 0.2) & ~term
        out.append(dict(
            obs=rng.integers(0, 256, (N_ENVS, 4, 4, 2), dtype=np.uint8),
            act=rng.integers(0, 4, N_ENVS).astype(np.int32),
            rew=rng.normal(size=N_ENVS).astype(np.float32),
            terminated=term,
            truncated=trunc,
            obs_next=rng.integers(0, 256, (N_ENVS, 4, 4, 2), dtype=np.uint8),
        ))
    return out


def _fill(n_adds):
    trs = _transitions(n_adds)
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS)
    jst = jbuf.init(JaxBatch({k: jnp.asarray(v[0]) for k, v in trs[0].items()}))
    tst = tbuf.init(Batch({k: torch.from_numpy(v)[0] for k, v in trs[0].items()}), device="cpu")
    for tr in trs:
        jst = jbuf.add(jst, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
        tst = tbuf.add(tst, Batch({k: torch.from_numpy(v) for k, v in tr.items()}))
    return jbuf, jst, tbuf, tst


def _all_slots():
    env = np.repeat(np.arange(N_ENVS), CAP)
    pos = np.tile(np.arange(CAP), N_ENVS)
    return env, pos


@pytest.mark.parametrize("n_adds", [3, 8, 13])
def test_writes_match_jax(n_adds):
    _, jst, _, tst = _fill(n_adds)
    np.testing.assert_array_equal(tst.cursor.numpy(), np.asarray(jst.cursor))
    np.testing.assert_array_equal(tst.size.numpy(), np.asarray(jst.size))
    assert set(tst.storage) == set(jst.storage)
    for k in jst.storage:
        ref = np.asarray(jst.storage[k])
        got = tst.storage[k].numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_adds", [3, 8])
def test_positions_gathers_and_chains_match_jax(n_adds):
    jbuf, jst, tbuf, tst = _fill(n_adds)
    env, pos = _all_slots()
    je, jp = jnp.asarray(env, jnp.int32), jnp.asarray(pos, jnp.int32)
    te, tp = torch.from_numpy(env), torch.from_numpy(pos)
    np.testing.assert_array_equal(tbuf.next_pos(tst, te, tp).numpy(), np.asarray(jbuf.next_pos(jst, je, jp)))
    np.testing.assert_array_equal(tbuf.prev_pos(tst, te, tp).numpy(), np.asarray(jbuf.prev_pos(jst, je, jp)))
    jget, tget = jbuf.get(jst, je, jp), tbuf.get(tst, te, tp)
    assert set(tget) == set(jget)
    for k in jget:
        np.testing.assert_array_equal(tget[k].numpy(), np.asarray(jget[k]))
    for j, t in zip(jbuf.nstep_chain(jst, je, jp, 3), tbuf.nstep_chain(tst, te, tp, 3)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_get_in_bfloat16_goes_through_gather_rows_cast():
    jbuf, jst, tbuf, tst = _fill(8)
    env, pos = _all_slots()
    got = tbuf.get(tst, torch.from_numpy(env), torch.from_numpy(pos), keys=("obs", "obs_next"),
                   dtypes={"obs": torch.bfloat16, "obs_next": torch.bfloat16})
    ref = jbuf.get(jst, jnp.asarray(env), jnp.asarray(pos), keys=("obs", "obs_next"))
    for k in ("obs", "obs_next"):
        assert got[k].dtype == torch.bfloat16 and got[k].shape == (N_ENVS * CAP, 4, 4, 2)
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy(),
            np.asarray(ref[k].astype(jnp.bfloat16)).view(np.int16),
        )


@pytest.mark.parametrize("n_adds", [3, 8])
def test_sample_indices_uniform_over_valid_slots(n_adds):
    _, _, tbuf, tst = _fill(n_adds)
    n = 30_000
    env, pos = tbuf.sample_indices(tst, torch.Generator().manual_seed(0), n)
    assert env.shape == pos.shape == (n,)
    valid = np.zeros((N_ENVS, CAP), bool)
    for e in range(N_ENVS):
        size, cursor = int(tst.size[e]), int(tst.cursor[e])
        valid[e, [(cursor - 1 - k) % CAP for k in range(size)]] = True
    counts = np.zeros((N_ENVS, CAP), np.int64)
    np.add.at(counts, (env.numpy(), pos.numpy()), 1)
    assert counts[~valid].sum() == 0
    observed = counts[valid]
    expected = n / valid.sum()
    chi2 = ((observed - expected) ** 2 / expected).sum()
    # chi-square with valid.sum() - 1 <= 14 degrees of freedom: 50 lies
    # beyond its 1e-5 upper tail, so only a non-uniform sampler fails
    assert chi2 < 50.0, chi2
