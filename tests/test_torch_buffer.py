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


# -- memory options (stack_num, save_only_last_obs, ignore_obs_next) ------
def _stacked_transitions(n_adds, k, seed=1):
    """Transitions whose observations are ``[N, k, 3, 3]`` uint8 stacks, as
    a FrameStack env emits them, with episode ends."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_adds):
        term = rng.random(N_ENVS) < 0.2
        out.append(dict(
            obs=rng.integers(0, 256, (N_ENVS, k, 3, 3), dtype=np.uint8),
            act=rng.integers(0, 4, N_ENVS).astype(np.int32),
            rew=rng.normal(size=N_ENVS).astype(np.float32),
            terminated=term,
            truncated=(rng.random(N_ENVS) < 0.15) & ~term,
            obs_next=rng.integers(0, 256, (N_ENVS, k, 3, 3), dtype=np.uint8),
        ))
    return out


def _fill_with(options, trs, cap=CAP):
    jbuf, tbuf = JaxReplayBuffer(cap, N_ENVS, **options), ReplayBuffer(cap, N_ENVS, **options)
    jst = jbuf.init(JaxBatch({k: jnp.asarray(v[0]) for k, v in trs[0].items()}))
    tst = tbuf.init(Batch({k: torch.from_numpy(v)[0] for k, v in trs[0].items()}), device="cpu")
    for tr in trs:
        jst = jbuf.add(jst, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
        tst = tbuf.add(tst, Batch({k: torch.from_numpy(v) for k, v in tr.items()}))
    return jbuf, jst, tbuf, tst


def _assert_storage_equal(tst, jst):
    np.testing.assert_array_equal(tst.cursor.numpy(), np.asarray(jst.cursor))
    np.testing.assert_array_equal(tst.size.numpy(), np.asarray(jst.size))
    assert set(tst.storage) == set(jst.storage)
    for k in jst.storage:
        assert tst.storage[k].shape == jst.storage[k].shape, k
        np.testing.assert_array_equal(tst.storage[k].numpy(), np.asarray(jst.storage[k]), err_msg=k)


MEMORY_OPTIONS = [
    dict(stack_num=k, save_only_last_obs=last, ignore_obs_next=ign)
    for k in (3, 4) for last in (False, True) for ign in (False, True)
]


@pytest.mark.parametrize("options", MEMORY_OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_memory_options_storage_and_stacked_get_match_jax(options):
    trs = _stacked_transitions(13, options["stack_num"])
    jbuf, jst, tbuf, tst = _fill_with(options, trs)
    _assert_storage_equal(tst, jst)
    if options["save_only_last_obs"]:
        assert tst.storage["obs"].shape == (N_ENVS, CAP, 3, 3)
    assert ("obs_next" in tst.storage) != options["ignore_obs_next"]
    env, pos = _all_slots()
    jget = jbuf.get(jst, jnp.asarray(env), jnp.asarray(pos), keys=("obs", "obs_next"))
    tget = tbuf.get(tst, torch.from_numpy(env), torch.from_numpy(pos), keys=("obs", "obs_next"))
    for k in ("obs", "obs_next"):
        assert tget[k].shape == jget[k].shape
        np.testing.assert_array_equal(tget[k].numpy(), np.asarray(jget[k]), err_msg=k)
    # the bf16 stacked gather (one gather_rows_cast per key) equals JAX's
    # stack cast to bf16; on the CPU it runs the plain version, no kernel
    from tianshou_tpu_torch.ops.gather import gather_rows_cast

    gather_rows_cast.launches = 0
    bf = tbuf.get(tst, torch.from_numpy(env), torch.from_numpy(pos), keys=("obs", "obs_next"),
                  dtypes={"obs": torch.bfloat16, "obs_next": torch.bfloat16})
    assert gather_rows_cast.launches == 0
    for k in ("obs", "obs_next"):
        assert bf[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(bf[k].view(torch.int16).numpy(),
                                      np.asarray(jget[k].astype(jnp.bfloat16)).view(np.int16), err_msg=k)


def test_stacked_bf16_gather_is_one_kernel_call_per_key(monkeypatch):
    """The stacked presample flattens the [B, k] position chain into B * k
    rows of one gather_rows_cast call per key."""
    from tianshou_tpu_torch.data import buffer as buffer_mod

    calls = []

    def spy(rows, idx):
        calls.append(tuple(idx.shape))
        return rows.index_select(0, idx).to(torch.bfloat16)

    monkeypatch.setattr(buffer_mod, "gather_rows_cast", spy)
    options = dict(stack_num=4, save_only_last_obs=True, ignore_obs_next=True)
    _, _, tbuf, tst = _fill_with(options, _stacked_transitions(13, 4))
    env, pos = _all_slots()
    out = tbuf.get(tst, torch.from_numpy(env), torch.from_numpy(pos), keys=("obs", "obs_next"),
                   dtypes={"obs": torch.bfloat16, "obs_next": torch.bfloat16})
    assert calls == [(len(env) * 4,)] * 2
    assert out["obs"].shape == out["obs_next"].shape == (len(env), 4, 3, 3)


@pytest.mark.parametrize("stack_num", [2, 3, 4])
def test_avail_mask_matches_jax_and_sampling_covers_it(stack_num):
    options = dict(stack_num=stack_num, save_only_last_obs=True, ignore_obs_next=True, sample_avail=True)
    jbuf, jst, tbuf, tst = _fill_with(options, _stacked_transitions(23, stack_num), cap=16)
    mask = tbuf._avail_mask(tst)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jbuf._avail_mask(jst)))
    np.testing.assert_array_equal(tbuf._age_limit(tst).numpy(), np.asarray(jbuf._age_limit(jst)))
    assert 0 < int(mask.sum()) < mask.numel()
    env, pos = tbuf.sample_indices(tst, torch.Generator().manual_seed(0), 4096)
    got = set(zip(env.tolist(), pos.tolist()))
    assert got == set(zip(*np.nonzero(mask.numpy())))


def test_sample_avail_masks_short_stacks():
    """The port's copy of tests/test_buffer.py's sample_avail case: episodes
    of 5, 2 and 4 steps; only slots with two predecessors in their episode
    are sampled, and all of them are."""
    k = 3
    buf = ReplayBuffer(16, 1, stack_num=k, save_only_last_obs=True, ignore_obs_next=True, sample_avail=True)
    ex = Batch(obs=torch.zeros(k, 1), act=torch.zeros((), dtype=torch.int32), rew=torch.zeros(()),
               terminated=torch.zeros((), dtype=torch.bool), truncated=torch.zeros((), dtype=torch.bool),
               obs_next=torch.zeros(k, 1))
    st = buf.init(ex, device="cpu")
    step = 0
    for ep_len in (5, 2, 4):
        for j in range(ep_len):
            st = buf.add(st, Batch(obs=torch.full((1, k, 1), float(step)), act=torch.zeros(1, dtype=torch.int32),
                                   rew=torch.zeros(1), terminated=torch.tensor([j == ep_len - 1]),
                                   truncated=torch.zeros(1, dtype=torch.bool), obs_next=torch.zeros(1, k, 1)))
            step += 1
    _, pos = buf.sample_indices(st, torch.Generator().manual_seed(0), 512)
    assert set(pos.tolist()) == {2, 3, 4, 9, 10}


def _as_jax(tr):
    return JaxBatch({k: jnp.asarray(v) for k, v in tr.items()})


def _as_torch(tr):
    return Batch({k: torch.from_numpy(np.asarray(v)) for k, v in tr.items()})


@pytest.mark.parametrize("options", [{}, dict(stack_num=2, save_only_last_obs=True, ignore_obs_next=True)],
                         ids=["plain", "dedup"])
def test_add_masked_and_merge_match_jax(options):
    k = options.get("stack_num", 2)
    trs = _stacked_transitions(9, k, seed=3)
    jbuf, jst, tbuf, tst = _fill_with(options, trs[:4])
    rng = np.random.default_rng(4)
    for tr in trs[4:]:
        mask = rng.random(N_ENVS) < 0.6
        jst = jbuf.add_masked(jst, _as_jax(tr), jnp.asarray(mask))
        tst = tbuf.add_masked(tst, _as_torch(tr), torch.from_numpy(mask))
    _assert_storage_equal(tst, jst)
    # merge a second buffer (wrapped, with partly filled envs) into the first
    j2, js2, t2, ts2 = _fill_with(options, _stacked_transitions(7, k, seed=5), cap=4)
    jst = jbuf.merge(jst, j2, js2)
    tst = tbuf.merge(tst, t2, ts2)
    _assert_storage_equal(tst, jst)


def test_add_trajectory_from_data_and_chronological_match_jax():
    trs = _transitions(7, seed=6)
    traj = {k: np.stack([tr[k] for tr in trs]) for k in trs[0]}  # [T, N, ...]
    jbuf, tbuf = JaxReplayBuffer(CAP, N_ENVS), ReplayBuffer(CAP, N_ENVS)
    jst = jbuf.add_trajectory(jbuf.init(_as_jax({k: v[0, 0] for k, v in traj.items()})), _as_jax(traj))
    tst = tbuf.add_trajectory(tbuf.init(_as_torch({k: v[0, 0] for k, v in traj.items()}), device="cpu"),
                              _as_torch(traj))
    _assert_storage_equal(tst, jst)
    jchron, tchron = jbuf.chronological(jst), tbuf.chronological(tst)
    for k in jchron:
        assert tchron[k].shape == (CAP, N_ENVS) + jchron[k].shape[2:]
        np.testing.assert_array_equal(tchron[k].numpy(), np.asarray(jchron[k]), err_msg=k)
    data = {k: v[:, 0] for k, v in traj.items()}  # one env's 7 steps as a dataset
    jb, js = JaxReplayBuffer.from_data(_as_jax(data), stack_num=2)
    tb, ts = ReplayBuffer.from_data(_as_torch(data), stack_num=2, device="cpu")
    assert (tb.capacity, tb.num_envs, tb.stack_num) == (jb.capacity, jb.num_envs, jb.stack_num) == (7, 1, 2)
    _assert_storage_equal(ts, js)
    e, p = jnp.zeros(7, jnp.int32), jnp.arange(7)
    np.testing.assert_array_equal(tb.stacked_obs(ts, torch.zeros(7, dtype=torch.int64), torch.arange(7)).numpy(),
                                  np.asarray(jb.stacked_obs(js, e, p)))
