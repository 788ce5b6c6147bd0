"""Buffer persistence of the port (tianshou_tpu_torch/data/persistence.py)
against the JAX package's (tianshou_tpu/data/persistence.py), on the CPU.

- Files cross between the packages both ways, a prioritized state's sum
  tree, extrema and beta included: exact equality of every leaf and of its
  dtype (the port's int64 cursors against the JAX package's int32, and
  int64 datasets, which the JAX package reads as int32).
- ``buffer_from_d4rl`` on an ``.npz`` file, an HDF5 file and a mapping, the
  reference library's layout (as tests/test_d4rl.py:123-230),
  ``normalize_obs_in_buffer`` (rtol 1e-5: the port sums in float64, numpy
  in float32) and ``load_any_buffer``: the same states as the JAX package
  builds.
- The module imports, and an ``.npz`` dataset loads, with ``h5py`` hidden;
  an HDF5 call then raises ``ImportError``.
"""

import importlib
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.data import persistence as jp
from tianshou_tpu.data.batch import Batch as JaxBatch
from tianshou_tpu.data.buffer import ReplayBufferState as JaxState
from tianshou_tpu.data.prio import PrioritizedReplayBufferState as JaxPERState
from tianshou_tpu_torch.data import persistence as tp
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBufferState
from tianshou_tpu_torch.data.prio import PrioritizedReplayBufferState

N_ENVS, CAP = 2, 8


def _arrays(seed=0):
    """A ring's leaves, with a nested ``policy`` group."""
    rng = np.random.default_rng(seed)
    shape = (N_ENVS, CAP)
    return {
        "obs": rng.normal(size=shape + (3,)).astype(np.float32),
        "act": rng.integers(0, 4, shape).astype(np.int32),
        "rew": rng.normal(size=shape).astype(np.float32),
        "terminated": rng.random(shape) < 0.2,
        "truncated": rng.random(shape) < 0.1,
        "obs_next": rng.normal(size=shape + (3,)).astype(np.float32),
        "policy": {"log_prob": rng.normal(size=shape).astype(np.float32)},
    }


PER = dict(tree=np.random.default_rng(1).random(2 * 16).astype(np.float32), max_prio=np.float32(2.5),
           min_prio=np.float32(0.125), beta=np.float32(0.55))


def _torch_state(prioritized, seed=0):
    storage = Batch({k: Batch({kk: torch.from_numpy(vv) for kk, vv in v.items()}) if isinstance(v, dict)
                     else torch.from_numpy(v) for k, v in _arrays(seed).items()})
    fields = dict(storage=storage, cursor=torch.tensor([3, 0]), size=torch.tensor([8, 5]))
    if not prioritized:
        return ReplayBufferState(**fields)
    return PrioritizedReplayBufferState(**fields, **{k: torch.tensor(v) for k, v in PER.items()})


def _jax_state(prioritized, seed=0):
    storage = JaxBatch({k: JaxBatch({kk: jnp.asarray(vv) for kk, vv in v.items()}) if isinstance(v, dict)
                        else jnp.asarray(v) for k, v in _arrays(seed).items()})
    fields = dict(storage=storage, cursor=jnp.asarray([3, 0], jnp.int32), size=jnp.asarray([8, 5], jnp.int32))
    if not prioritized:
        return JaxState(**fields)
    return JaxPERState(**fields, **{k: jnp.asarray(v) for k, v in PER.items()})


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):  # a dict, or a JAX Batch
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_state(port_state, jax_state, per_fields):
    got, ref = _leaves(port_state.storage), _leaves(jax_state.storage)
    assert set(got) == set(ref)
    for k in ref:
        # the JAX package reads an int64 dataset as int32 (x64 is off)
        assert got[k].dtype == ref[k].dtype or (got[k].dtype, ref[k].dtype) == (np.int64, np.int32), k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for name in ("cursor", "size", *per_fields):
        np.testing.assert_array_equal(np.asarray(getattr(port_state, name)), np.asarray(getattr(jax_state, name)),
                                      err_msg=name)
    assert port_state.cursor.dtype == torch.int64


@pytest.mark.parametrize("prioritized", [False, True])
def test_round_trip(tmp_path, prioritized):
    path = str(tmp_path / "buf.h5")
    state = _torch_state(prioritized)
    tp.save_buffer_hdf5(path, state)
    loaded = tp.load_buffer_hdf5(path, device="cpu")
    assert type(loaded) is type(state)
    per = tuple(PER) if prioritized else ()
    _assert_same_state(loaded, _jax_state(prioritized), per)
    with h5py.File(path, "r") as f:
        assert f["cursor"].dtype == np.int32 and bool(f.attrs["prioritized"]) == prioritized


@pytest.mark.parametrize("prioritized", [False, True])
def test_jax_written_file_loads_into_the_port(tmp_path, prioritized):
    path = str(tmp_path / "jax.h5")
    jp.save_buffer_hdf5(path, _jax_state(prioritized))
    loaded = tp.load_buffer_hdf5(path, device="cpu")
    assert isinstance(loaded, PrioritizedReplayBufferState) == prioritized
    # the JAX package writes no min_prio: the port starts it at 1
    per = ("tree", "max_prio", "beta") if prioritized else ()
    _assert_same_state(loaded, _jax_state(prioritized), per)
    if prioritized:
        assert float(loaded.min_prio) == 1.0


@pytest.mark.parametrize("prioritized", [False, True])
def test_port_written_file_loads_into_jax(tmp_path, prioritized):
    path = str(tmp_path / "port.h5")
    tp.save_buffer_hdf5(path, _torch_state(prioritized))
    loaded = jp.load_buffer_hdf5(path)
    assert isinstance(loaded, JaxPERState) == prioritized
    per = ("tree", "max_prio", "beta") if prioritized else ()
    _assert_same_state(_torch_state(prioritized), loaded, per)


def test_pytree_round_trip_between_packages(tmp_path):
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": Batch(c=np.ones(3, np.int32)), "fn": lambda x: x + 1,
            "ragged": [[1], [2, 3]], "t": torch.tensor([1.5, 2.5])}
    for save, load in ((tp.save_pytree_hdf5, jp.load_pytree_hdf5), (jp.save_pytree_hdf5, tp.load_pytree_hdf5)):
        path = str(tmp_path / f"{save.__module__}.h5")
        src = dict(tree)
        if save is jp.save_pytree_hdf5:
            src.pop("t")
            src["b"] = JaxBatch(c=np.ones(3, np.int32))
        save(path, src)
        out = load(path)
        np.testing.assert_array_equal(out["a"], tree["a"])
        np.testing.assert_array_equal(out["b"]["c"], np.ones(3, np.int32))
        assert type(out["b"]).__name__ == "Batch"
        assert out["fn"](1) == 2 and out["ragged"] == [[1], [2, 3]]
    np.testing.assert_array_equal(jp.load_pytree_hdf5(str(tmp_path / f"{tp.__name__}.h5"))["t"], [1.5, 2.5])


def _toy_dataset(n=64, obs_dim=3, act_dim=1):
    """tests/test_d4rl.py's ``_toy_dataset``."""
    rng = np.random.default_rng(0)
    terminals = np.zeros(n, bool)
    terminals[20] = True
    timeouts = np.zeros(n, bool)
    timeouts[45] = True
    return {
        "observations": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.normal(size=(n, act_dim)).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float64),
        "terminals": terminals,
        "timeouts": timeouts,
        "next_observations": rng.normal(size=(n, obs_dim)).astype(np.float32),
    }


@pytest.mark.parametrize("source", ["mapping", "npz", "h5"])
def test_buffer_from_d4rl_matches_jax(tmp_path, source):
    data = _toy_dataset()
    if source == "mapping":
        src = data
    else:
        src = str(tmp_path / f"d.{source}")
        if source == "npz":
            np.savez(src, **data)
        else:
            with h5py.File(src, "w") as f:
                for k, v in data.items():
                    f.create_dataset(k, data=v)
    buf, state = tp.buffer_from_d4rl(src, device="cpu")
    jbuf, jstate = jp.buffer_from_d4rl(src)
    assert (buf.capacity, buf.num_envs) == (jbuf.capacity, jbuf.num_envs) == (64, 1)
    assert state.storage["rew"].dtype == torch.float32
    _assert_same_state(state, jstate, ())
    # n-step chains stop at the terminal: the ring's episode structure
    rew_chain, done_chain, term_pos = buf.nstep_chain(state, torch.zeros(1, dtype=torch.int64), torch.tensor([19]), 3)
    assert int(done_chain[0].sum()) >= 1 and int(term_pos[0]) == 20


def test_buffer_from_d4rl_rejects_missing_keys():
    data = _toy_dataset()
    del data["next_observations"]
    with pytest.raises(AssertionError, match="missing"):
        tp.buffer_from_d4rl(data, device="cpu")


def test_normalize_obs_matches_jax():
    data = _toy_dataset(n=256)
    _, state = tp.buffer_from_d4rl(data, device="cpu")
    _, jstate = jp.buffer_from_d4rl(data)
    state2, mean, std = tp.normalize_obs_in_buffer(state)
    jstate2, jmean, jstd = jp.normalize_obs_in_buffer(jstate)
    np.testing.assert_allclose(mean, jmean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std, jstd, rtol=1e-5)
    for k in ("obs", "obs_next"):
        np.testing.assert_allclose(state2.storage[k].numpy(), np.asarray(jstate2.storage[k]), rtol=1e-5, atol=1e-5)
    obs = state2.storage["obs"][0].numpy()
    np.testing.assert_allclose(obs.mean(0), 0.0, atol=1e-5)
    assert state.storage["obs"] is not state2.storage["obs"] and state2.storage["act"] is state.storage["act"]


def _reference_file(path, kind):
    """The reference library's layout, as the three files of
    tests/test_d4rl.py:123-230 write it."""
    rng = np.random.default_rng(1)
    with h5py.File(path, "w") as f:
        if kind == "full":
            maxsize, size, index = 10, 7, 3
            f.attrs.update(maxsize=maxsize, _index=index, _size=size, stack_num=1)
            meta = f.create_group("_meta")
            for k, v in {"obs": rng.normal(size=(maxsize, 4)).astype(np.float32),
                         "act": rng.integers(0, 2, maxsize).astype(np.int64),
                         "rew": rng.normal(size=maxsize), "terminated": np.zeros(maxsize, bool),
                         "truncated": np.zeros(maxsize, bool), "done": np.zeros(maxsize, bool),
                         "obs_next": rng.normal(size=(maxsize, 4)).astype(np.float32)}.items():
                meta.create_dataset(k, data=v)
        elif kind == "done_only":
            f.attrs.update(maxsize=4, _index=0, _size=4)
            meta = f.create_group("_meta")
            meta.create_dataset("obs", data=np.zeros((4, 2), np.float32))
            meta.create_dataset("act", data=np.zeros(4, np.int64))
            meta.create_dataset("rew", data=np.ones(4))
            meta.create_dataset("done", data=np.asarray([0, 1, 0, 0], bool))
            meta.create_dataset("obs_next", data=np.zeros((4, 2), np.float32))
        else:
            maxsize = 16
            f.attrs.update(maxsize=maxsize, _index=0, _size=maxsize)
            f.create_group("options").attrs.update(stack_num=4, ignore_obs_next=True, save_only_last_obs=True)
            meta = f.create_group("_meta")
            meta.create_dataset("obs", data=np.arange(maxsize * 16, dtype=np.uint8).reshape(maxsize, 4, 4))
            meta.create_dataset("act", data=np.zeros(maxsize, np.int64))
            meta.create_dataset("rew", data=np.ones(maxsize))
            meta.create_dataset("terminated", data=np.zeros(maxsize, bool))
            meta.create_dataset("truncated", data=np.zeros(maxsize, bool))


@pytest.mark.parametrize("kind", ["full", "done_only", "atari"])
def test_reference_layout_matches_jax(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    _reference_file(path, kind)
    buf, state = tp.load_reference_buffer_hdf5(path, device="cpu")
    jbuf, jstate = jp.load_reference_buffer_hdf5(path)
    for opt in ("capacity", "num_envs", "stack_num", "ignore_obs_next", "save_only_last_obs"):
        assert getattr(buf, opt) == getattr(jbuf, opt), opt
    _assert_same_state(state, jstate, ())
    if kind == "full":
        batch, _, pos = buf.sample(state, torch.Generator().manual_seed(0), 32)
        assert batch["obs"].shape == (32, 4) and int(pos.max()) < 10
        # only the filled window [index - size, index) is sampled
        assert set(pos.tolist()) <= {(3 - 7 + t) % 10 for t in range(7)}
    if kind == "done_only":
        np.testing.assert_array_equal(state.storage["terminated"][0].numpy(), [0, 1, 0, 0])
        assert not state.storage["truncated"].any()
    if kind == "atari":
        got = buf.get(state, torch.zeros(8, dtype=torch.int64), torch.arange(4, 12), keys=("obs", "obs_next"))
        ref = jbuf.get(jstate, jnp.zeros(8, jnp.int32), jnp.arange(4, 12), keys=("obs", "obs_next"))
        for k in ("obs", "obs_next"):
            assert got[k].shape == (8, 4, 4, 4)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_load_any_buffer_dispatch(tmp_path):
    own = str(tmp_path / "own.h5")
    tp.save_buffer_hdf5(own, _torch_state(False))
    buf, state = tp.load_any_buffer(own, device="cpu")
    assert (buf.capacity, buf.num_envs) == (CAP, N_ENVS) and int(state.size.sum()) == 13
    d4 = str(tmp_path / "d4.h5")
    with h5py.File(d4, "w") as f:
        for k, v in _toy_dataset().items():
            f.create_dataset(k, data=v)
    npz = str(tmp_path / "d4.npz")
    np.savez(npz, **_toy_dataset())
    ref = str(tmp_path / "ref.h5")
    _reference_file(ref, "done_only")
    for path, capacity in ((d4, 64), (npz, 64), (ref, 4)):
        buf, state = tp.load_any_buffer(path, device="cpu")
        jbuf, jstate = jp.load_any_buffer(path)
        assert buf.capacity == jbuf.capacity == capacity
        _assert_same_state(state, jstate, ())
    junk = str(tmp_path / "junk.h5")
    with h5py.File(junk, "w") as f:
        f.create_dataset("whatever", data=np.zeros(3))
    with pytest.raises(ValueError, match="unrecognized buffer layout"):
        tp.load_any_buffer(junk, device="cpu")


def test_loaders_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the default device is usable here")
    npz = str(tmp_path / "d4.npz")
    np.savez(npz, **_toy_dataset())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.buffer_from_d4rl(npz)


def test_npz_loads_without_h5py(tmp_path, monkeypatch):
    npz = str(tmp_path / "d4.npz")
    np.savez(npz, **_toy_dataset())
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.delitem(sys.modules, tp.__name__)
    fresh = importlib.import_module(tp.__name__)
    assert fresh is not tp
    buf, state = fresh.buffer_from_d4rl(npz, device="cpu")
    assert buf.capacity == 64
    buf, state = fresh.load_any_buffer(npz, device="cpu")
    np.testing.assert_array_equal(state.storage["obs"][0].numpy(), _toy_dataset()["observations"])
    with pytest.raises(ImportError):
        fresh.save_buffer_hdf5(str(tmp_path / "x.h5"), state)
    with pytest.raises(ImportError):
        fresh.load_any_buffer(str(tmp_path / "x.h5"), device="cpu")
