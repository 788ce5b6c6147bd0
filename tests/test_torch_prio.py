"""Prioritized replay of the port (tianshou_tpu_torch: ops/segtree, data/prio,
the write-back of DQN, TD3 and SAC, the trainer's per-update sampling
branch) against the JAX package, on the CPU in float32.

- The sum tree: after the same unique-index updates both packages hold the
  same tree (exact: each node is one float32 add of its children), and the
  descent gives the same leaves on the same ``u``; a write-back with
  duplicate indices leaves every internal node equal to the sum of its
  children.  The wrappers take the plain loop for a CPU tensor (one
  ``plain`` on the counter ``segtree.route``, no kernel launch counted) and
  refuse a wrong dtype, shape or a non-contiguous tree, a device without a
  kernel, and leaves outside the tree; the kernels themselves are held to
  the plain loop on the card (tests/test_torch_segtree_cuda.py).
- PER add / sample / update_priorities / set_beta against the JAX buffer in
  both ``weight_norm`` modes on the same uniform draws: indices exact,
  weights and tree rtol 1e-6; and against the numpy oracle of
  tests/test_prio.py (rtol 1e-4).
- One DQN, one TD3 and one SAC update on a PER buffer from the same
  parameters, sample and noise: parameters rtol 1e-4 / atol 1e-5, the tree
  and the running extrema after the write-back rtol 1e-4.
- The trainer presamples once for uniform replay and samples per update
  for PER and for an overridden ``update``; ``add_masked`` and ``merge``
  keep a PER state's own fields.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.prio import PrioritizedReplayBuffer as JaxPER
from tianshou_tpu.ops import segtree as jseg
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer, PrioritizedReplayBufferState
from tianshou_tpu_torch.ops import segtree as tseg

OBS, B = 4, 16


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


# -- the sum tree --------------------------------------------------------------
@pytest.mark.parametrize("capacity", [48, 20_000])
def test_segtree_matches_jax(capacity):
    rng = np.random.default_rng(0)
    jtree, ttree = jseg.segtree_init(capacity), tseg.segtree_init(capacity, "cpu")
    assert ttree.shape == jtree.shape and tseg.segtree_capacity(ttree) == jseg.segtree_capacity(jtree)
    naive = np.zeros(capacity)
    for _ in range(6):
        idx = rng.choice(capacity, size=min(capacity, 40), replace=False)  # unique: scatter order is unspecified
        vals = rng.random(idx.size).astype(np.float32)
        jtree = jseg.segtree_update(jtree, jnp.asarray(idx), jnp.asarray(vals))
        assert tseg.segtree_update(ttree, _t(idx), _t(vals)) is ttree  # in place
        naive[idx] = vals
        np.testing.assert_array_equal(ttree.numpy(), np.asarray(jtree))
    np.testing.assert_allclose(float(tseg.segtree_total(ttree)), naive.sum(), rtol=1e-5)
    u = (rng.random(256) * float(tseg.segtree_total(ttree))).astype(np.float32)
    got = tseg.segtree_sample(ttree, _t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jseg.segtree_sample(jtree, jnp.asarray(u))))
    prefix = np.cumsum(naive.astype(np.float32))
    inside = u < prefix[-1] * (1 - 1e-5)  # away from the float32 rounding of the top
    np.testing.assert_array_equal(got.numpy()[inside], np.searchsorted(prefix, u[inside], side="right"))


def test_segtree_duplicate_writeback_keeps_every_sum():
    rng = np.random.default_rng(1)
    tree = tseg.segtree_init(100, "cpu")
    tseg.segtree_update(tree, torch.arange(100), _t(rng.random(100).astype(np.float32)))
    idx = torch.tensor([3, 3, 3, 57, 57, 99, 0, 0])
    vals = _t(rng.random(8).astype(np.float32) + 2.0)
    tseg.segtree_update(tree, idx, vals)
    cap = tseg.segtree_capacity(tree)
    n = torch.arange(1, cap)
    assert torch.equal(tree[n], tree[2 * n] + tree[2 * n + 1])
    for leaf in (3, 57, 99, 0):
        assert float(tree[cap + leaf]) in vals[idx == leaf].tolist()


def test_segtree_sampling_is_proportional():
    tree = tseg.segtree_init(8, "cpu")
    tseg.segtree_update(tree, torch.arange(8), torch.tensor([1.0, 0.0, 3.0, 0.0, 0.0, 0.0, 0.0, 4.0]))
    u = torch.rand(8000, generator=torch.Generator().manual_seed(0)) * tseg.segtree_total(tree)
    counts = np.bincount(tseg.segtree_sample(tree, u).numpy(), minlength=8) / 8000
    np.testing.assert_allclose(counts[[0, 2, 7]], [1 / 8, 3 / 8, 4 / 8], atol=0.02)
    assert counts[[1, 3, 4, 5, 6]].sum() == 0


def _filled_tree(slots, seed):
    rng = np.random.default_rng(seed)
    tree = tseg.segtree_init(slots, "cpu")
    tseg.segtree_update_plain(tree, torch.arange(slots), _t(rng.random(slots).astype(np.float32)))
    return tree, rng


def _wrapper_and_plain(op, tree, rng):
    """``(wrapper call, plain call)`` of one operation on ``tree``: an update
    by flat index, by ``(env, pos)`` rows and by a 0-d value at each env's
    cursor (a ring's add), a descent of scaled ``u``, a draw of ``u`` in
    [0, 1)."""
    envs, cap = 4, tseg.segtree_capacity(tree) // 4
    pos = _t(rng.choice(cap, envs, replace=False))
    rows = _t(rng.permutation(envs))
    vals = _t(rng.random(envs).astype(np.float32) + 1.0)
    u01 = _t(rng.random(64).astype(np.float32))
    if op == "update":
        idx = _t(rng.choice(envs * cap, 16, replace=False))
        vals = _t(rng.random(16).astype(np.float32))
        return (lambda t: tseg.segtree_update(t, idx, vals)), (lambda t: tseg.segtree_update_plain(t, idx, vals))
    if op == "update_rows":
        return (lambda t: tseg.segtree_update(t, pos, vals, rows=rows, row_stride=cap),
                lambda t: tseg.segtree_update_plain(t, rows * cap + pos, vals))
    if op == "update_add":
        value = torch.tensor(2.5)
        return (lambda t: tseg.segtree_update(t, pos, value, row_stride=cap),
                lambda t: tseg.segtree_update_plain(t, torch.arange(envs) * cap + pos, value))
    if op == "sample":
        return (lambda t: tseg.segtree_sample(t, u01 * t[1]), lambda t: tseg.segtree_sample_plain(t, u01 * t[1]))
    return (lambda t: tseg.segtree_draw(t, u01, envs * cap - 3, cap),
            lambda t: tseg.segtree_draw_plain(t, u01, envs * cap - 3, cap))


@pytest.mark.parametrize("op", ["update", "update_rows", "update_add", "sample", "draw"])
def test_segtree_wrappers_take_the_plain_loop_on_cpu(op):
    """A CPU tensor takes the plain loop: the same result, one ``plain`` on
    the counter ``segtree.route``, no kernel launch counted."""
    from tianshou_tpu_torch.utils import trace

    tree, rng = _filled_tree(48, seed=2)
    wrapper, plain = _wrapper_and_plain(op, tree, rng)
    launches = [f.launches for f in (tseg.segtree_update, tseg.segtree_draw)]
    trace.clear()
    try:
        a, b = tree.clone(), tree.clone()
        got, want = wrapper(a), plain(b)
        routes = {tag: n for (name, tag), n in trace.counters().items() if name == "segtree.route"}
    finally:
        trace.clear()
    assert routes == {"plain": 1}
    assert [f.launches for f in (tseg.segtree_update, tseg.segtree_draw)] == launches
    assert torch.equal(a, b)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and torch.equal(g, w)


_TREE, _IDX, _VALS = tseg.segtree_init(48, "cpu"), torch.arange(4), torch.ones(4)
BAD_CALLS = {
    "float64 tree": lambda: tseg.segtree_update(_TREE.double(), _IDX, _VALS),
    "non-contiguous tree": lambda: tseg.segtree_update(torch.zeros(256)[::2], _IDX, _VALS),
    "tree not a power of two": lambda: tseg.segtree_update(torch.zeros(96), _IDX, _VALS),
    "2-D tree": lambda: tseg.segtree_update(_TREE.view(2, 64), _IDX, _VALS),
    "float idx": lambda: tseg.segtree_update(_TREE, _IDX.float(), _VALS),
    "2-D idx": lambda: tseg.segtree_update(_TREE, _IDX.view(2, 2), _VALS),
    "values of another length": lambda: tseg.segtree_update(_TREE, _IDX, torch.ones(5)),
    "integer values": lambda: tseg.segtree_update(_TREE, _IDX, torch.ones(4, dtype=torch.int64)),
    "rows of another length": lambda: tseg.segtree_update(_TREE, _IDX, _VALS, rows=torch.arange(3), row_stride=8),
    "float64 tree, sample": lambda: tseg.segtree_sample(_TREE.double(), torch.rand(4)),
    "integer u, sample": lambda: tseg.segtree_sample(_TREE, _IDX),
    "float64 u, draw": lambda: tseg.segtree_draw(_TREE, torch.rand(4, dtype=torch.float64), 48, 12),
    "2-D u, draw": lambda: tseg.segtree_draw(_TREE, torch.rand(2, 2), 48, 12),
    "non-contiguous tree, draw": lambda: tseg.segtree_draw(torch.zeros(256)[::2], torch.rand(4), 48, 12),
    "slots past the leaves, draw": lambda: tseg.segtree_draw(_TREE, torch.rand(4), 65, 13),
    "row_len 0, draw": lambda: tseg.segtree_draw(_TREE, torch.rand(4), 48, 0),
    "tree on a device without a kernel": lambda: tseg.segtree_update(_TREE.to("meta"), _IDX.to("meta"),
                                                                      _VALS.to("meta")),
    "sample off the CPU": lambda: tseg.segtree_sample(_TREE.to("meta"), torch.rand(4, device="meta")),
}


@pytest.mark.parametrize("case", list(BAD_CALLS))
def test_segtree_wrappers_reject_bad_inputs(case):
    with pytest.raises(ValueError):
        BAD_CALLS[case]()


# leaves outside the tree's 64 leaves: by flat index, by a negative row, by
# a row stride past the end (the kernel traps on the same calls,
# tests/test_torch_segtree_cuda.py)
OUT_OF_TREE = {
    "index past the end": lambda t: tseg.segtree_update(t, torch.tensor([3, 64]), torch.ones(2)),
    "negative index": lambda t: tseg.segtree_update(t, torch.tensor([-1]), torch.ones(1)),
    "negative row": lambda t: tseg.segtree_update(t, torch.tensor([0, 1]), torch.ones(2), rows=torch.tensor([1, -1]),
                                                  row_stride=12),
    "row stride past the end": lambda t: tseg.segtree_update(t, torch.tensor([5, 5]), torch.tensor(1.0),
                                                             row_stride=60),
}


@pytest.mark.parametrize("case", list(OUT_OF_TREE))
def test_segtree_update_refuses_leaves_outside_the_tree(case):
    """A leaf outside the tree raises and writes nothing (a negative index
    would otherwise land on an internal node)."""
    tree, _ = _filled_tree(48, seed=3)
    before = tree.clone()
    with pytest.raises(IndexError):
        OUT_OF_TREE[case](tree)
    assert torch.equal(tree, before)


# -- the buffer -----------------------------------------------------------------
def _transition(rng, num_envs, obs_dim=OBS, act=None):
    """One step for ``num_envs`` envs as numpy leaves."""
    return dict(
        obs=rng.normal(size=(num_envs, obs_dim)).astype(np.float32),
        act=rng.integers(0, 3, num_envs).astype(np.int32) if act is None else act(rng, num_envs),
        rew=rng.normal(size=num_envs).astype(np.float32),
        terminated=rng.random(num_envs) < 0.15,
        truncated=rng.random(num_envs) < 0.05,
        obs_next=rng.normal(size=(num_envs, obs_dim)).astype(np.float32),
    )


def _filled_pair(num_envs, capacity, steps, seed=0, obs_dim=OBS, act=None, **options):
    """The same transitions in the JAX and the port's PER buffer."""
    rng = np.random.default_rng(seed)
    jbuf, tbuf = JaxPER(capacity, num_envs, **options), PrioritizedReplayBuffer(capacity, num_envs, **options)
    first = _transition(rng, num_envs, obs_dim, act)
    jbs = jbuf.init(JaxBatch({k: jnp.asarray(v[0]) for k, v in first.items()}))
    tbs = tbuf.init(Batch({k: _t(v[0]) for k, v in first.items()}), device="cpu")
    assert isinstance(tbs, PrioritizedReplayBufferState)
    jadd = jax.jit(jbuf.add)
    for _ in range(steps):
        tr = _transition(rng, num_envs, obs_dim, act)
        jbs = jadd(jbs, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
        tbs = tbuf.add(tbs, Batch({k: _t(v) for k, v in tr.items()}))
    return jbuf, jbs, tbuf, tbs


def _write_pair(jbuf, jbs, tbuf, tbs, rng, n):
    """The same write-back of ``n`` unique slots on both sides."""
    flat = rng.choice(tbuf.num_envs * tbuf.capacity, n, replace=False)
    env, pos = flat // tbuf.capacity, flat % tbuf.capacity
    td = (rng.normal(size=n) * 3).astype(np.float32)
    jbs = jbuf.update_priorities(jbs, jnp.asarray(env, jnp.int32), jnp.asarray(pos, jnp.int32), jnp.asarray(td))
    tbs = tbuf.update_priorities(tbs, _t(env), _t(pos), _t(td))
    return jbs, tbs


def _assert_prio_state_close(jbs, tbs, rtol=1e-6, atol=0.0):
    for k in ("tree", "max_prio", "min_prio", "beta"):
        np.testing.assert_allclose(getattr(tbs, k).numpy(), np.asarray(getattr(jbs, k)), rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(tbs.cursor.numpy(), np.asarray(jbs.cursor))


@pytest.mark.parametrize("weight_norm", [True, False])
def test_per_buffer_matches_jax(weight_norm):
    jbuf, jbs, tbuf, tbs = _filled_pair(3, 16, 21, alpha=0.6, beta=0.4, weight_norm=weight_norm)
    _assert_prio_state_close(jbs, tbs)
    rng = np.random.default_rng(2)
    for rnd in range(4):
        jbs, tbs = _write_pair(jbuf, jbs, tbuf, tbs, rng, 7)
        if rnd == 1:
            jbs, tbs = jbuf.set_beta(jbs, 0.7), tbuf.set_beta(tbs, 0.7)
        if rnd == 2:  # new transitions enter at the running maximum
            tr = _transition(rng, 3)
            jbs = jbuf.add(jbs, JaxBatch({k: jnp.asarray(v) for k, v in tr.items()}))
            tbs = tbuf.add(tbs, Batch({k: _t(v) for k, v in tr.items()}))
        _assert_prio_state_close(jbs, tbs)
    assert float(tbs.max_prio) > 1.0 and float(tbs.min_prio) < 1.0
    tbs = tbuf.set_beta(tbs, torch.tensor(0.55, dtype=torch.float64))
    jbs = jbuf.set_beta(jbs, 0.55)
    key = jax.random.key(3)
    jenv, jpos, jw = jbuf.sample_with_weights(jbs, key, 256)
    tenv, tpos, tw = tbuf.sample_at(tbs, _t(jax.random.uniform(key, (256,))))
    np.testing.assert_array_equal(tenv.numpy(), np.asarray(jenv))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert tbs.beta.dtype == torch.float32 and len(np.unique(tw.numpy())) > 3
    # the generator's draw goes through the same function
    g = torch.Generator().manual_seed(0)
    u = torch.rand(64, generator=torch.Generator().manual_seed(0))
    for a, b in zip(tbuf.sample_with_weights(tbs, g, 64), tbuf.sample_at(tbs, u)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_per_weight_oracle_parity(weight_norm):
    """The numpy oracle of tests/test_prio.py: leaves hold ``prio ** alpha``,
    ``min_prio`` is the running min of the raw priorities, the weight is
    ``(leaf / min_prio) ** -beta``, over the batch max with weight_norm."""
    alpha, beta, n = 0.6, 0.4, 12
    rng = np.random.default_rng(3)
    buf = PrioritizedReplayBuffer(capacity=16, num_envs=1, alpha=alpha, beta=beta, weight_norm=weight_norm)
    example = _transition(rng, 1)
    st = buf.init(Batch({k: _t(v[0]) for k, v in example.items()}), device="cpu")
    leaves = np.zeros(16)
    max_prio = min_prio = 1.0
    for i in range(n):
        st = buf.add(st, Batch({k: _t(v) for k, v in _transition(rng, 1).items()}))
        leaves[i] = max_prio ** alpha
    for _ in range(4):
        idx = rng.permutation(n)[:5]
        td = rng.random(5) * 3.0
        st = buf.update_priorities(st, torch.zeros(5, dtype=torch.int64), _t(idx), _t(td.astype(np.float32)))
        prio = np.abs(td.astype(np.float32)).astype(np.float64) + 1e-6
        leaves[idx] = prio ** alpha
        max_prio, min_prio = max(max_prio, prio.max()), min(min_prio, prio.min())
    env_idx, pos, w = buf.sample_with_weights(st, torch.Generator().manual_seed(7), 64)
    assert int(env_idx.max()) == 0 and int(pos.max()) < n
    expected = (leaves[pos.numpy()] / min_prio) ** (-beta)
    if weight_norm:
        expected = expected / expected.max()
    np.testing.assert_allclose(w.numpy(), expected, rtol=1e-4)


def test_add_masked_and_merge_keep_the_per_fields():
    _, _, tbuf, tbs = _filled_pair(2, 8, 5)
    rng = np.random.default_rng(4)
    tbs = tbuf.update_priorities(tbs, torch.tensor([0, 1]), torch.tensor([2, 3]), torch.tensor([5.0, 0.01]))
    before = dataclasses.replace(tbs, tree=tbs.tree.clone())
    tr = Batch({k: _t(v) for k, v in _transition(rng, 2).items()})
    masked = tbuf.add_masked(tbs, tr, torch.tensor([True, False]))
    assert isinstance(masked, PrioritizedReplayBufferState)
    assert masked.tree is tbs.tree and masked.max_prio is tbs.max_prio and masked.min_prio is tbs.min_prio
    assert masked.beta is tbs.beta and masked.cursor.tolist() == [6, 5]
    src = ReplayBuffer(4, 2)
    sbs = src.init(Batch({k: v[0] for k, v in tr.items()}), device="cpu")
    for _ in range(3):
        sbs = src.add(sbs, Batch({k: _t(v) for k, v in _transition(rng, 2).items()}))
    merged = tbuf.merge(masked, src, sbs)
    assert isinstance(merged, PrioritizedReplayBufferState)
    assert torch.equal(merged.tree, before.tree) and float(merged.max_prio) == float(before.max_prio) > 1.0
    assert merged.cursor.tolist() == [1, 0] and merged.size.tolist() == [8, 8]


# -- updates that write the priorities back -------------------------------------
def _dqn_pair():
    from tianshou_tpu.algos.dqn import DQN as JaxDQN
    from tianshou_tpu.envs.spaces import Discrete as JaxDiscrete
    from tianshou_tpu.networks.common import QNet as JaxQNet
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.convert import params_from_flax

    kw = dict(lr=1e-3, gamma=0.9, n_step=2, target_update_freq=2)
    jalgo = JaxDQN(JaxQNet((32, 32), 3), JaxDiscrete(3), **kw)
    jts = jalgo.init(jax.random.key(0), jnp.zeros((OBS,), jnp.float32))
    talgo = DQN(QNet(OBS, (32, 32), 3), Discrete(3), device="cpu", **kw)
    tts = talgo.init(torch.Generator().manual_seed(0))
    sd = params_from_flax(jax.device_get(jts.params))
    tts.online.load_state_dict(sd)
    tts.target.load_state_dict(sd)
    return jalgo, jts, talgo, tts


def _assert_dqn_close(jts, tts):
    from tianshou_tpu_torch.networks.convert import params_from_flax

    for mod, fp in ((tts.online, jts.params), (tts.target, jts.target_params)):
        ref = params_from_flax(jax.device_get(fp))
        for k, v in mod.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["dqn", "td3", "sac"])
def test_update_on_per_buffer_writes_back_as_jax(kind):
    if kind == "dqn":
        jalgo, jts, talgo, tts = _dqn_pair()
        jbuf, jbs, tbuf, tbs = _filled_pair(2, 32, 40, seed=5, alpha=0.6, beta=0.4)
    else:
        from tests.test_torch_continuous import A as CA, OBS as COBS, _algo_pair, _assert_state_close, _jax_noise

        jalgo, jts, talgo, tts = _algo_pair(kind)
        act = lambda rng, n: rng.uniform(-1, 1, (n, CA)).astype(np.float32)  # noqa: E731
        jbuf, jbs, tbuf, tbs = _filled_pair(2, 32, 40, seed=5, obs_dim=COBS, act=act, alpha=0.6, beta=0.4)
    rng = np.random.default_rng(6)
    jbs, tbs = _write_pair(jbuf, jbs, tbuf, tbs, rng, 9)  # unequal priorities before the update
    # a key whose sample names no slot twice: a duplicated slot's write-back
    # keeps one of its values in an order neither package fixes
    for seed in range(100):
        key = jax.random.key(seed)
        k_s, k_l = jax.random.split(key)
        u = _t(jax.random.uniform(k_s, (B,)))
        env, pos, _ = tbuf.sample_at(tbs, u)
        if len(set((env * tbuf.capacity + pos).tolist())) == B:
            break
    jts, jbs, jm = jax.jit(lambda ts, bs, k: jalgo.update(ts, jbuf, bs, k, B))(jts, jbs, key)
    tbuf.sample_with_weights = lambda st, g, b: tbuf.sample_at(st, u)
    sampled = talgo.presample(tbuf, tbs, None, B)
    assert len(set((sampled[0] * tbuf.capacity + sampled[1]).tolist())) == B
    assert float(sampled[2].min()) < 0.9  # the IS weights are not all one
    prev_tree = tbs.tree.clone()
    noise = None if kind == "dqn" else _jax_noise(kind, k_l)
    if noise is None:
        tts, tbs, tm = talgo.update_sampled(tts, tbuf, tbs, sampled)
    else:
        tts, tbs, tm = talgo.update_sampled(tts, tbuf, tbs, sampled, noise=noise)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    if kind == "dqn":
        _assert_dqn_close(jts, tts)
    else:
        _assert_state_close(kind, jts, tts)
    _assert_prio_state_close(jbs, tbs, rtol=1e-4, atol=1e-6)
    assert not torch.equal(prev_tree, tbs.tree)


def test_trainer_samples_per_update_for_per_and_presamples_for_uniform():
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    class OwnUpdate(DQN):
        def update(self, ts, buffer, bstate, generator, batch_size):
            return super().update(ts, buffer, bstate, generator, batch_size)

    k, batch = 3, 4
    calls = []
    for name, cls, per in (("uniform", DQN, False), ("per", DQN, True), ("own update", OwnUpdate, False)):
        algo = cls(QNet(OBS, (16,), 3), Discrete(3), n_step=2, device="cpu")
        ts = algo.init(torch.Generator().manual_seed(0))
        if per:
            _, _, buf, bs = _filled_pair(2, 8, 10)
        else:
            buf = ReplayBuffer(8, 2)
            rng = np.random.default_rng(0)
            bs = buf.init(Batch({k_: _t(v[0]) for k_, v in _transition(rng, 2).items()}), device="cpu")
            for _ in range(10):
                bs = buf.add(bs, Batch({k_: _t(v) for k_, v in _transition(rng, 2).items()}))
        sizes = []
        presample = algo.presample
        algo.presample = lambda b, s, g, n: sizes.append(n) or presample(b, s, g, n)
        tree = bs.tree.clone() if per else None
        ts, bs, m = build_update_scan(algo, buf, batch, k)(ts, bs, torch.Generator().manual_seed(1))
        calls.append((name, sizes))
        assert ts.step == k and np.isfinite(float(m["loss"]))
        if per:
            assert isinstance(bs, PrioritizedReplayBufferState) and not torch.equal(tree, bs.tree)
    assert calls == [("uniform", [k * batch]), ("per", [batch] * k), ("own update", [batch] * k)]


@pytest.mark.parametrize("kind,pipeline", [("rainbow-per", False), ("fqf", True)])
def test_host_path_samples_per_update_and_acts_through_the_algorithm(kind, pipeline):
    """The trainer's host path over CartPole-v1: Rainbow on a PER buffer
    takes the per-update branch there too (its write-back moves the tree);
    FQF acts through its quantile net and fraction proposals, snapshotted
    together when pipelined."""
    import math

    import gymnasium as gym

    from tianshou_tpu_torch.algos.c51 import Rainbow
    from tianshou_tpu_torch.algos.qrdqn import FQF
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.envs import host as thost
    from tianshou_tpu_torch.networks.discrete import C51Net, FractionProposalNetwork, FullQuantileFunction
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    make = lambda: gym.make("CartPole-v1")  # noqa: E731
    train, test = thost.HostVectorEnv([make] * 4), thost.HostVectorEnv([make] * 2)
    if kind == "fqf":
        algo = FQF(FullQuantileFunction(4, (16,), 2), FractionProposalNetwork(16, 8), train.action_space,
                   num_fractions=8, n_step=3, target_update_freq=10, device="cpu")
        buf = ReplayBuffer(64, 4)
    else:
        algo = Rainbow(C51Net(4, (16,), 2, num_atoms=11, noisy=True), train.action_space, num_atoms=11, v_min=0.0,
                       v_max=50.0, n_step=3, target_update_freq=10, device="cpu")
        buf = PrioritizedReplayBuffer(64, 4)
    trainer = OffPolicyTrainer(
        algo, HostCollector(algo, train, buf, device="cpu"), HostCollector(algo, test, device="cpu"), buf,
        max_epoch=1, step_per_epoch=40, step_per_collect=8, update_per_step=0.5, batch_size=16,
        episode_per_test=2, warmup_steps=16, train_param_fn=lambda e, s: 0.1, pipeline_host_updates=pipeline,
        device="cpu")
    info = trainer.run()
    assert (info.env_step, info.gradient_step) == (16 + 5 * 8, 5 * 4) == (info.env_step, trainer.train_state.step)
    assert math.isfinite(info.last_metrics["loss"]) and info.best_reward >= 8
    if kind == "fqf":
        assert math.isfinite(info.last_metrics["fraction_loss"])
    else:
        bs = trainer.buffer_state
        assert isinstance(bs, PrioritizedReplayBufferState) and float(bs.max_prio) != 1.0
    train.close()
    test.close()
