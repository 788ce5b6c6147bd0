"""The port's ``Batch`` (tianshou_tpu_torch/data/batch.py): the copies of
``tests/test_batch.py`` (10 tests) and ``tests/test_batch_edge.py`` (34) on
torch tensors, where the JAX tests use jax arrays (numpy leaves stay numpy
in both packages), and the same numpy inputs through both classes.

The JAX tests of pytree behaviour (``jax.tree.map``, ``jit``, ``scan``,
``vmap``, key paths) become the same checks through the port's tree
helpers (``data/tree.py``): the map keeps the ``Batch``, a loop carries
it, and a per-row function over its rows gives the batched result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tianshou_tpu_torch
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# tests/test_batch.py
# ---------------------------------------------------------------------------
def test_construction_and_access():
    b = Batch(obs=np.zeros((4, 3)), act=[1, 2, 3, 4], nested={"x": np.ones(4)})
    assert isinstance(b.nested, Batch)
    assert b.act.shape == (4,)
    assert "obs" in b and "missing" not in b
    assert set(b.keys()) == {"obs", "act", "nested"}
    with pytest.raises(AttributeError):
        _ = b.missing
    b.new_key = 7.0
    assert float(b.new_key) == 7.0


def test_scalar_promotion_and_ragged_rejection():
    b = Batch(x=1, y=2.5)
    assert b.x.shape == ()
    with pytest.raises(TypeError):
        Batch(z=[[1, 2], [3]])


def test_indexing_distributes():
    b = Batch(obs=torch.arange(12).reshape(4, 3), nested=Batch(v=torch.arange(4)))
    s = b[1:3]
    assert s.obs.shape == (2, 3)
    assert s.nested.v.tolist() == [1, 2]
    one = b[0]
    assert one.obs.shape == (3,)
    idx = np.array([0, 2])
    assert b[idx].obs.shape == (2, 3)
    assert b[torch.tensor([0, 2])].obs.shape == (2, 3)


def test_len_and_shape():
    b = Batch(a=torch.zeros((5, 2)), c=Batch(d=torch.zeros((5, 7))))
    assert len(b) == 5
    assert b.shape == (5,)
    b2 = Batch(a=torch.zeros((5, 2)), b=torch.zeros((5, 2, 4)))
    assert b2.shape == (5, 2)
    with pytest.raises(TypeError):
        len(Batch())


def test_cat_and_stack():
    b1 = Batch(x=torch.ones((2, 3)), n=Batch(y=torch.zeros(2)))
    b2 = Batch(x=torch.zeros((3, 3)), n=Batch(y=torch.ones(3)))
    c = Batch.cat([b1, b2])
    assert c.x.shape == (5, 3)
    assert c.n.y.shape == (5,)
    s = Batch.stack([b1, b1])
    assert s.x.shape == (2, 2, 3)


def test_split():
    b = Batch(x=torch.arange(10))
    parts = b.split(3, shuffle=False)
    assert [len(p) for p in parts] == [3, 3, 3, 1]
    parts = b.split(3, shuffle=False, merge_last=True)
    assert [len(p) for p in parts] == [3, 3, 4]
    # shuffled split is a permutation
    parts = b.split(5, seed=0)
    got = np.sort(np.concatenate([p.x.numpy() for p in parts]))
    assert np.array_equal(got, np.arange(10))


def test_pytree_roundtrip_and_jit():
    b = Batch(x=torch.ones((4, 2)), n=Batch(y=torch.zeros(4)))
    leaves = tree_leaves(b)
    it = iter(leaves)
    b2 = tree_map(lambda _: next(it), b)
    assert b == b2
    out = tree_map(lambda v: v + 1, b)
    assert torch.allclose(out.x, torch.full((4, 2), 2.0))
    assert isinstance(out, Batch) and isinstance(out.n, Batch)


def test_setitem_slice():
    b = Batch(x=np.zeros((4, 2)))
    b[1:3] = Batch(x=np.ones((2, 2)))
    assert np.allclose(b.x[1:3], 1.0)
    assert np.allclose(b.x[0], 0.0)
    # tensor leaves are written in place
    bt = Batch(x=torch.zeros((4, 2)))
    leaf = bt.x
    bt[0] = Batch(x=torch.ones(2))
    assert torch.allclose(bt.x[0], torch.ones(2)) and bt.x is leaf


def test_to_torch_numpy():
    b = Batch(x=np.ones(3)).to_torch("cpu")
    assert isinstance(b.x, torch.Tensor)
    b = b.to_numpy()
    assert isinstance(b.x, np.ndarray)


def test_cat_zero_pads_missing_keys():
    """Missing keys are zero-filled on concatenation."""
    b1 = Batch(x=torch.ones((2, 3)), extra=torch.ones(2))
    b2 = Batch(x=torch.zeros((3, 3)))
    c = Batch.cat([b1, b2])
    assert c.x.shape == (5, 3)
    assert c.extra.tolist() == [1, 1, 0, 0, 0]
    # nested missing sub-batch
    b3 = Batch(x=torch.ones((2, 3)), n=Batch(y=torch.ones((2, 4))))
    b4 = Batch(x=torch.zeros((1, 3)))
    c2 = Batch.cat([b3, b4])
    assert c2.n.y.shape == (3, 4)
    assert torch.equal(c2.n.y[2], torch.zeros(4))


# ---------------------------------------------------------------------------
# tests/test_batch_edge.py
# ---------------------------------------------------------------------------
def test_nested_dict_promotes_to_batch():
    b = Batch(info={"a": torch.zeros(3), "deep": {"x": torch.ones(3)}})
    assert isinstance(b.info, Batch)
    assert isinstance(b.info.deep, Batch)
    assert b.info.deep.x.shape == (3,)


def test_scalar_and_list_promotion_dtypes():
    b = Batch(i=3, f=1.5, flag=True, lst=[1, 2, 3])
    assert b.i.dtype == torch.int64 and b.i.shape == ()
    assert b.f.dtype.is_floating_point
    assert b.flag.dtype == torch.bool
    assert b.lst.shape == (3,)


def test_ragged_and_object_sequences_rejected():
    with pytest.raises(TypeError):
        Batch(x=[[1, 2], [3]])
    with pytest.raises(TypeError):
        Batch(x=[object(), object()])
    with pytest.raises(TypeError):
        Batch(x="a string is not an array")


def test_copy_constructor_is_shallow_dict_copy():
    """Batch(b) copies the key map but aliases the leaves."""
    a = torch.zeros(3)
    b1 = Batch(x=a)
    b2 = Batch(b1)
    b2.y = torch.ones(3)
    assert "y" not in b1  # key map independent
    b2.x[0] = 7.0
    assert b1.x[0] == 7.0  # leaf aliased


def test_getattr_missing_raises_attribute_error():
    b = Batch(x=torch.zeros(2))
    with pytest.raises(AttributeError):
        _ = b.nope
    # and hasattr-style probing works (no KeyError leak)
    assert not hasattr(b, "nope")


def test_delattr_and_delitem():
    b = Batch(x=torch.zeros(2), y=torch.ones(2))
    del b.x
    assert "x" not in b
    del b["y"]
    assert b.is_empty()
    with pytest.raises(AttributeError):
        del b.x


def test_len_is_min_over_leaves():
    b = Batch(x=torch.zeros((5, 2)), y=torch.zeros((3,)))
    assert len(b) == 3


def test_len_raises_on_scalar_leaf_and_empty():
    with pytest.raises(TypeError):
        len(Batch(x=torch.tensor(1.0)))
    with pytest.raises(TypeError):
        len(Batch())
    # an empty nested batch is skipped, not counted
    b = Batch(x=torch.zeros((4, 2)), sub=Batch())
    assert len(b) == 4
    # truth stays the dict's: a batch with keys is true, an empty one false
    assert Batch(x=torch.tensor(1.0)) and not Batch()


def test_shape_common_prefix():
    b = Batch(x=torch.zeros((4, 2, 7)), y=torch.zeros((4, 2, 3)))
    assert b.shape == (4, 2)
    b2 = Batch(x=torch.zeros((4, 2)), y=torch.zeros((5, 2)))
    assert b2.shape == ()
    assert Batch().shape == ()


def test_index_scalar_int_drops_leading_dim():
    b = Batch(x=torch.arange(12).reshape(4, 3), sub=Batch(y=torch.arange(4)))
    row = b[2]
    assert row.x.shape == (3,)
    assert row.sub.y == 2


def test_index_bool_mask_and_fancy():
    b = Batch(x=torch.arange(5), y=torch.arange(5) * 10)
    m = torch.tensor([True, False, True, False, True])
    assert b[m].x.tolist() == [0, 2, 4]
    assert b[torch.tensor([3, 1])].y.tolist() == [30, 10]
    assert b[m.numpy()].x.tolist() == [0, 2, 4]


def test_index_negative_and_slice_step():
    b = Batch(x=torch.arange(6))
    assert b[-1].x == 5
    assert b[::2].x.tolist() == [0, 2, 4]
    # torch has no negative step: flip, where numpy slices [::-1]
    assert b[torch.arange(5, -1, -1)].x.tolist() == [5, 4, 3, 2, 1, 0]
    assert Batch(x=np.arange(6))[::-1].x.tolist() == [5, 4, 3, 2, 1, 0]


def test_setitem_slice_mixed_numpy_torch_leaves():
    b = Batch(n=np.zeros(4))
    b["j"] = torch.zeros(4)
    val = Batch(n=np.ones(2), j=torch.ones(2))
    b[1:3] = val
    np.testing.assert_array_equal(b.n, [0, 1, 1, 0])
    assert b.j.tolist() == [0, 1, 1, 0]


def test_setitem_slice_nested():
    b = Batch(sub=Batch(x=torch.zeros(4)))
    b[::2] = Batch(sub=Batch(x=torch.ones(2)))
    assert b.sub.x.tolist() == [1, 0, 1, 0]


def test_setitem_slice_requires_batch_value():
    b = Batch(x=torch.zeros(4))
    with pytest.raises(TypeError):
        b[1:3] = torch.ones(2)


def test_cat_basic_and_empty_filtering():
    a = Batch(x=torch.ones((2, 3)))
    b = Batch(x=torch.zeros((3, 3)))
    c = Batch.cat([a, Batch(), b])
    assert c.x.shape == (5, 3)
    assert Batch.cat([]).is_empty()
    assert Batch.cat([Batch(), Batch()]).is_empty()


def test_cat_pads_missing_top_level_key():
    a = Batch(x=torch.ones((2, 3)), y=torch.ones(2))
    b = Batch(x=torch.zeros((3, 3)))  # no y
    c = Batch.cat([a, b])
    assert c.y.tolist() == [1, 1, 0, 0, 0]


def test_cat_pads_missing_nested_key():
    """Zero-pad at any nesting level, aligning sub-batches with partially
    overlapping keys."""
    a = Batch(x=torch.ones(2), info=Batch(p=torch.ones(2)))
    b = Batch(x=torch.zeros(3), info=Batch(q=torch.full((3,), 5.0)))
    c = Batch.cat([a, b])
    assert c.info.p.tolist() == [1, 1, 0, 0, 0]
    assert c.info.q.tolist() == [0, 0, 5, 5, 5]


def test_cat_pads_entirely_missing_nested_batch():
    a = Batch(x=torch.ones(2), info=Batch(p=torch.ones((2, 4))))
    b = Batch(x=torch.zeros(3))  # no info at all
    c = Batch.cat([a, b])
    assert c.info.p.shape == (5, 4)
    assert torch.equal(c.info.p[2:], torch.zeros((3, 4)))


def test_cat_three_way_nested_union():
    a = Batch(info=Batch(p=torch.ones(1)), x=torch.ones(1))
    b = Batch(info=Batch(q=torch.ones(2) * 2), x=torch.ones(2))
    c = Batch(info=Batch(r=torch.ones(1) * 3), x=torch.ones(1))
    out = Batch.cat([a, b, c])
    assert set(out.info.keys()) == {"p", "q", "r"}
    assert out.info.p.tolist() == [1, 0, 0, 0]
    assert out.info.q.tolist() == [0, 2, 2, 0]
    assert out.info.r.tolist() == [0, 0, 0, 3]


def test_cat_axis1():
    a = Batch(x=torch.ones((2, 3)))
    b = Batch(x=torch.zeros((2, 2)))
    assert Batch.cat([a, b], axis=1).x.shape == (2, 5)


def test_cat_preserves_torch_leaves():
    a = Batch(x=torch.ones((2, 3)))
    b = Batch(x=torch.zeros((3, 3)))
    c = Batch.cat([a, b])
    assert isinstance(c.x, torch.Tensor)
    # numpy stays numpy; a mix becomes tensors
    assert isinstance(Batch.cat([Batch(x=np.ones(2)), Batch(x=np.ones(1))]).x, np.ndarray)
    assert isinstance(Batch.cat([Batch(x=np.ones(2)), Batch(x=torch.ones(1, dtype=torch.float64))]).x,
                      torch.Tensor)


def test_stack_basic_and_axis():
    rows = [Batch(x=torch.full((3,), i), sub=Batch(y=torch.tensor(float(i)))) for i in range(4)]
    s0 = Batch.stack(rows)
    assert s0.x.shape == (4, 3)
    assert s0.sub.y.tolist() == [0, 1, 2, 3]
    vec_rows = [Batch(x=torch.full((3,), i)) for i in range(4)]
    s1 = Batch.stack(vec_rows, axis=1)
    assert s1.x.shape == (3, 4)


def test_stack_empty_list():
    assert Batch.stack([]).is_empty()


def test_split_sizes_and_content_no_shuffle():
    b = Batch(x=torch.arange(10))
    parts = b.split(3, shuffle=False)
    assert [len(p) for p in parts] == [3, 3, 3, 1]
    assert parts[0].x.tolist() == [0, 1, 2]
    assert parts[-1].x.tolist() == [9]


def test_split_merge_last():
    b = Batch(x=torch.arange(10))
    parts = b.split(3, shuffle=False, merge_last=True)
    assert [len(p) for p in parts] == [3, 3, 4]
    assert parts[-1].x.tolist() == [6, 7, 8, 9]
    # exact division: merge_last is a no-op
    parts = Batch(x=torch.arange(9)).split(3, shuffle=False, merge_last=True)
    assert [len(p) for p in parts] == [3, 3, 3]
    # size >= n: single chunk
    parts = Batch(x=torch.arange(4)).split(100, shuffle=False)
    assert len(parts) == 1 and len(parts[0]) == 4


def test_split_shuffle_is_permutation_and_seedable():
    b = Batch(x=torch.arange(20))
    p1 = Batch.cat(b.split(6, shuffle=True, seed=0))
    assert sorted(p1.x.tolist()) == list(range(20))
    p2 = Batch.cat(b.split(6, shuffle=True, seed=0))
    assert torch.equal(p1.x, p2.x)  # deterministic under seed
    pg = Batch.cat(b.split(6, shuffle=True, generator=torch.Generator().manual_seed(3)))
    assert sorted(pg.x.tolist()) == list(range(20))


def test_key_order_does_not_affect_equality_or_leaves():
    b1 = Batch(a=torch.zeros(2), z=torch.ones(2))
    b2 = Batch(z=torch.ones(2), a=torch.zeros(2))
    assert b1 == b2
    by_key = {k: v for k, v in zip(sorted(b1), [b1[k] for k in sorted(b1)])}
    assert all(torch.equal(by_key[k], b2[k]) for k in by_key)


def test_tree_map_and_key_paths():
    b = Batch(x=torch.ones((2, 3)), sub=Batch(y=torch.ones(2)))
    doubled = tree_map(lambda v: v * 2, b)
    assert isinstance(doubled, Batch)
    assert doubled.sub.y.tolist() == [2, 2]
    paths = []

    def walk(tree, prefix=""):
        for k, v in tree.items():
            walk(v, f"{prefix}[{k!r}]") if isinstance(v, Batch) else paths.append(f"{prefix}[{k!r}]")

    walk(b)
    assert set(paths) == {"['x']", "['sub']['y']"}
    # a map whose function returns no array keeps the structure (the tree
    # helpers rebuild a Batch unparsed)
    none = tree_map(lambda v: None, b)
    assert isinstance(none.sub, Batch) and none["x"] is None and none.sub["y"] is None
    assert len(tree_leaves(b)) == 2


def test_batch_through_loop_carry():
    carry, hist = Batch(x=torch.zeros(2)), []
    for _ in range(3):
        hist.append(carry.x)
        carry = Batch(x=carry.x + 1)
    assert carry.x.tolist() == [3, 3]
    assert torch.stack(hist).shape == (3, 2)


def test_map_over_rows():
    b = Batch(x=torch.arange(6.0).reshape(3, 2))
    out = Batch.stack([Batch(y=b[i].x.sum()) for i in range(len(b))])
    assert out.y.tolist() == [1, 5, 9]


def test_eq_deep_and_mismatch():
    a = Batch(x=torch.ones(2), sub=Batch(y=torch.zeros(2)))
    assert a == Batch(x=torch.ones(2), sub=Batch(y=torch.zeros(2)))
    assert a != Batch(x=torch.ones(2), sub=Batch(y=torch.ones(2)))
    assert a != Batch(x=torch.ones(2))  # key set differs
    assert a != Batch(x=torch.ones(3), sub=Batch(y=torch.zeros(2)))  # shape differs


def test_eq_nan_aware():
    a = Batch(x=torch.tensor([np.nan, 1.0]))
    assert a == Batch(x=torch.tensor([np.nan, 1.0]))


def test_repr_mentions_keys_and_shapes():
    r = repr(Batch(obs=torch.zeros((4, 3)), sub=Batch(y=torch.zeros(4))))
    assert "obs" in r and "(4, 3)" in r and "sub" in r


# ---------------------------------------------------------------------------
# the same numpy inputs through both classes
# ---------------------------------------------------------------------------
def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [dict(obs=rng.normal(size=(n, 3)).astype(np.float32), act=rng.integers(0, 4, n),
                 info=dict(p=rng.random(n), **({"q": rng.random((n, 2))} if n % 2 else {})))
            for n in (2, 3, 5)]


def _same(port, jax_batch):
    assert sorted(port) == sorted(jax_batch.keys())
    for k in port:
        a, b = port[k], jax_batch[k]
        if isinstance(a, Batch):
            _same(a, b)
        else:
            an = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            bn = np.asarray(b)
            assert an.dtype == bn.dtype and an.shape == bn.shape, k
            np.testing.assert_array_equal(an, bn, err_msg=k)


@pytest.mark.parametrize("op", ["cat", "cat_axis1", "stack", "index", "split", "setitem", "len_shape", "parse"])
def test_same_numpy_inputs_through_both_classes(op):
    dicts = _inputs()
    ours, theirs = [Batch(d) for d in dicts], [JaxBatch(d) for d in dicts]
    if op == "cat":
        _same(Batch.cat(ours), JaxBatch.cat(theirs))
    elif op == "cat_axis1":
        same_len = [Batch(obs=np.ones((2, k), np.float32)) for k in (1, 3)]
        _same(Batch.cat(same_len, axis=1), JaxBatch.cat([JaxBatch(b) for b in same_len], axis=1))
    elif op == "stack":
        _same(Batch.stack([ours[1], ours[1]]), JaxBatch.stack([theirs[1], theirs[1]]))
    elif op == "index":
        idx = np.array([4, 0, 2])
        _same(ours[2][idx], theirs[2][idx])
        _same(ours[2][1:4], theirs[2][1:4])
        _same(ours[2][3], theirs[2][3])
    elif op == "split":
        for a, b in zip(ours[2].split(2, seed=1), theirs[2].split(2, seed=1)):
            _same(a, b)
        for a, b in zip(ours[2].split(2, shuffle=False, merge_last=True),
                        theirs[2].split(2, shuffle=False, merge_last=True)):
            _same(a, b)
    elif op == "setitem":
        ours[2][1:3] = Batch(dicts[2])[3:5]
        theirs[2][1:3] = JaxBatch(dicts[2])[3:5]
        _same(ours[2], theirs[2])
    elif op == "len_shape":
        for a, b in zip(ours, theirs):
            assert len(a) == len(b) and a.shape == b.shape and repr(a) == repr(b)
    else:
        mixed = dict(i=3, f=1.5, flag=True, lst=[1, 2, 3], fl=[0.5, 1.5], nested={"x": [[1, 2], [3, 4]]})
        a = Batch(mixed).to_numpy()
        _same(a, JaxBatch(mixed))
        assert JaxBatch(mixed) == JaxBatch(a.to_numpy())


def test_package_exports_batch():
    assert tianshou_tpu_torch.Batch is Batch
    assert "Batch" in tianshou_tpu_torch.__all__


def test_jax_leaves_read_through_to_torch():
    jb = JaxBatch(x=jnp.arange(4.0)).to_numpy()
    tb = Batch(dict(jb.items())).to_torch("cpu")
    assert torch.equal(tb.x, torch.arange(4.0))
    assert len(jax.tree_util.tree_leaves(jb)) == 1  # the JAX batch is untouched


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_to_torch_refuses_cuda_without_it():
    with pytest.raises(RuntimeError):
        Batch(x=np.ones(2)).to_torch("cuda")
