"""Buffer persistence: HDF5 save and load of a replay buffer's state, and
dataset import (port of ``tianshou_tpu/data/persistence.py``).

The files are the JAX package's, name for name, so that a file either
package writes loads into the other:

- ``save_buffer_hdf5``: ``storage/<key>[/<subkey>...]`` datasets (gzip) of
  ``[num_envs, capacity, ...]`` leaves, ``cursor`` and ``size`` (int32), a
  ``prioritized`` root attribute and, for a prioritized state, ``tree``,
  ``max_prio`` and ``beta``.  The port also writes ``min_prio``, which the
  JAX package does not store (and ignores when it reads); a file without it
  loads with ``min_prio`` at 1, the value a fresh prioritized state starts
  from.
- ``save_pytree_hdf5``: any nested mapping of arrays, with what numpy
  cannot hold as a plain array cloudpickled into a ``pickled`` uint8
  dataset.
- ``load_reference_buffer_hdf5``: the reference library's ``save_hdf5``
  layout (root attributes and a ``_meta`` group).
- ``buffer_from_d4rl``: a D4RL qlearning dataset (``observations, actions,
  rewards, terminals, next_observations[, timeouts]``) from an ``.npz``
  file, an HDF5 file or a mapping; ``terminals`` become ``terminated`` and
  ``timeouts`` ``truncated``.

``h5py`` is imported by the functions that open HDF5 files only, so that an
``.npz`` dataset or a mapping loads without it; on a machine without
``h5py`` an HDF5 call raises ``ImportError``.  The loaders put the state on
``device`` (default ``"cuda"``, which raises without CUDA).  A state is
read on the host once to save it; the port updates a state in place, so
what is saved is the state at the call.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.prio import PrioritizedReplayBufferState
from tianshou_tpu_torch.data.tree import tree_leaves
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = [
    "save_buffer_hdf5",
    "load_buffer_hdf5",
    "save_pytree_hdf5",
    "load_pytree_hdf5",
    "buffer_from_d4rl",
    "normalize_obs_in_buffer",
    "load_reference_buffer_hdf5",
    "load_any_buffer",
]

_PER_FIELDS = ("tree", "max_prio", "min_prio", "beta")


def _numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Leaves of a nested mapping under ``/``-joined names."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = _numpy(v)
    return out


def save_pytree_hdf5(path: str, tree: Any) -> None:
    """Save a nested structure: mappings become groups (a ``Batch`` is
    tagged ``batch``), array leaves datasets, and anything numpy cannot hold
    as a non-object array (callables, objects, ragged lists) a cloudpickled
    uint8 dataset tagged ``pickled``."""
    import cloudpickle
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["generic_pytree"] = True

        def emit(prefix: str, obj: Any) -> None:
            if isinstance(obj, Batch):
                f.require_group(prefix or "/").attrs["batch"] = True
            if isinstance(obj, Mapping):
                grp = f.require_group(prefix or "/")
                grp.attrs.setdefault("batch", False)
                for k, v in obj.items():
                    emit(f"{prefix}/{k}" if prefix else str(k), v)
                return
            try:
                arr = _numpy(obj)
                if arr.dtype == object:
                    raise TypeError
                f.create_dataset(prefix, data=arr)
            except (TypeError, ValueError):
                payload = np.frombuffer(cloudpickle.dumps(obj), np.uint8)
                ds = f.create_dataset(prefix, data=payload)
                ds.attrs["pickled"] = True

        emit("", tree)


def load_pytree_hdf5(path: str) -> Any:
    """Inverse of :func:`save_pytree_hdf5`: numpy leaves, ``Batch`` where
    the group is tagged so, else ``dict``."""
    import pickle

    import h5py

    with h5py.File(path, "r") as f:

        def read(obj):
            if isinstance(obj, h5py.Dataset):
                if obj.attrs.get("pickled", False):
                    return pickle.loads(obj[...].tobytes())
                return np.asarray(obj[...])
            out = {k: read(obj[k]) for k in obj.keys()}
            return Batch(out) if obj.attrs.get("batch", False) else out

        return read(f["/"])


def save_buffer_hdf5(path: str, state: ReplayBufferState) -> None:
    """Write ``state`` (a prioritized one with its tree, extrema and beta)
    in the JAX package's layout."""
    import h5py

    prioritized = isinstance(state, PrioritizedReplayBufferState)
    with h5py.File(path, "w") as f:
        f.attrs["prioritized"] = prioritized
        for name, arr in _flatten(state.storage, "storage/").items():
            f.create_dataset(name, data=arr, compression="gzip")
        f.create_dataset("cursor", data=_numpy(state.cursor).astype(np.int32))
        f.create_dataset("size", data=_numpy(state.size).astype(np.int32))
        if prioritized:
            for name in _PER_FIELDS:
                f.create_dataset(name, data=_numpy(getattr(state, name)))


def _tensor(x: Any, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _read_group(group, device: torch.device) -> Batch:
    """A nested ``Batch`` of tensors from ``/``-joined dataset names."""
    import h5py

    out: dict = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            parts = name.split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = _tensor(obj[...], device)

    group.visititems(visit)

    def batched(d):
        return Batch({k: batched(v) if isinstance(v, dict) else v for k, v in d.items()})

    return batched(out)


def load_buffer_hdf5(path: str, device: str | torch.device = "cuda") -> ReplayBufferState:
    """The state :func:`save_buffer_hdf5` (of either package) wrote, on
    ``device``; cursors and sizes as int64."""
    import h5py

    dev = resolve_device(device)
    with h5py.File(path, "r") as f:
        fields = dict(
            storage=_read_group(f["storage"], dev),
            cursor=_tensor(f["cursor"][...], dev, torch.int64),
            size=_tensor(f["size"][...], dev, torch.int64),
        )
        if not f.attrs.get("prioritized", False):
            return ReplayBufferState(**fields)
        per = {name: _tensor(f[name][...], dev, torch.float32) for name in _PER_FIELDS if name in f}
        per.setdefault("min_prio", torch.ones((), device=dev))
        return PrioritizedReplayBufferState(**fields, **per)


def load_reference_buffer_hdf5(source, device: str | torch.device = "cuda") -> tuple[ReplayBuffer, ReplayBufferState]:
    """``(buffer, state)`` from a file of the reference library's
    ``ReplayBuffer.save_hdf5``: its scalars (``maxsize``, ``_index``,
    ``_size``) as root attributes, its memory options as root attributes or
    those of an ``options`` group, and the ring as the ``_meta`` group's
    datasets.  The ring, cursor and fill level carry over into a single-env
    state; an old file with ``done`` alone maps it to ``terminated``; a file
    with no ``obs_next`` (the reference's Atari buffers) gives a buffer with
    ``ignore_obs_next`` and, with stacks, ``save_only_last_obs``."""
    import h5py

    dev = resolve_device(device)
    with h5py.File(str(source), "r") as f:
        if "_meta" not in f:
            raise ValueError(f"{source}: not a reference-layout buffer file (no _meta)")
        meta = f["_meta"]
        storage: dict = {}
        for k in ("obs", "act", "rew", "terminated", "truncated", "obs_next"):
            if k in meta and isinstance(meta[k], h5py.Dataset):
                storage[k] = _tensor(np.asarray(meta[k])[None], dev)
        if "obs" not in storage or "act" not in storage:
            raise ValueError(f"{source}: the _meta group lacks obs or act: {sorted(meta.keys())}")
        if "rew" in storage:
            storage["rew"] = storage["rew"].to(torch.float32)
        if "terminated" not in storage and "done" in meta:
            storage["terminated"] = _tensor(np.asarray(meta["done"])[None], dev)
            storage["truncated"] = torch.zeros_like(storage["terminated"])
        maxsize = int(f.attrs["maxsize"])
        index = int(f.attrs.get("_index", 0))
        size = int(f.attrs.get("_size", maxsize))
        opts = f["options"].attrs if "options" in f else f.attrs
        stack_num = int(opts.get("stack_num", f.attrs.get("stack_num", 1)))
        ignore_obs_next = "obs_next" not in storage
        save_only_last_obs = bool(opts.get("save_only_last_obs", False)) or (stack_num > 1 and ignore_obs_next)
    buf = ReplayBuffer(
        capacity=maxsize,
        num_envs=1,
        stack_num=max(1, stack_num),
        save_only_last_obs=save_only_last_obs,
        ignore_obs_next=ignore_obs_next,
    )
    state = ReplayBufferState(
        storage=Batch(storage),
        cursor=torch.full((1,), index, dtype=torch.int64, device=dev),
        size=torch.full((1,), size, dtype=torch.int64, device=dev),
    )
    return buf, state


# D4RL qlearning-dataset keys -> the buffer's reserved keys
_D4RL_KEYS = {
    "observations": "obs",
    "actions": "act",
    "rewards": "rew",
    "next_observations": "obs_next",
}


def _is_npz(path: str) -> bool:
    return path.endswith(".npz") or path.endswith(".npy")


def buffer_from_d4rl(source, device: str | torch.device = "cuda") -> tuple[ReplayBuffer, ReplayBufferState]:
    """``(buffer, state)``: a single-env buffer exactly full of a D4RL
    qlearning dataset, from an ``.npz`` path, an HDF5 path or a mapping with
    its keys.  Rewards become float32; ``timeouts`` (all false when absent)
    become ``truncated``, so that bootstrap masking tells termination from
    truncation."""
    close = None
    if isinstance(source, (str, bytes)):
        s = str(source)
        if _is_npz(s):
            source = np.load(s)
        else:
            import h5py

            source = close = h5py.File(s, "r")
    try:
        missing = [k for k in (*_D4RL_KEYS, "terminals") if k not in source]
        if missing:
            raise AssertionError(f"not a D4RL qlearning dataset; missing {missing}")
        data = {ours: np.asarray(source[k]) for k, ours in _D4RL_KEYS.items()}
        terminals = np.asarray(source["terminals"]).astype(bool)
        data["terminated"] = terminals
        data["truncated"] = (
            np.asarray(source["timeouts"]).astype(bool) if "timeouts" in source else np.zeros_like(terminals)
        )
        data["rew"] = data["rew"].astype(np.float32)
    finally:
        if close is not None:
            close.close()
    return ReplayBuffer.from_data(Batch(data), device=device)


def load_any_buffer(path: str, device: str | torch.device = "cuda") -> tuple[ReplayBuffer, ReplayBufferState]:
    """``(buffer, state)`` from any supported file: :func:`save_buffer_hdf5`'s
    layout (a ``storage`` group), the reference library's (a ``_meta``
    group), or a D4RL qlearning dataset (``.npz``, or HDF5 with
    ``observations``)."""
    s = str(path)
    if _is_npz(s):
        return buffer_from_d4rl(s, device)
    import h5py

    with h5py.File(s, "r") as f:
        keys = set(f.keys())
    if "storage" in keys:
        state = load_buffer_hdf5(s, device)
        capacity = tree_leaves(state.storage)[0].shape[1]
        return ReplayBuffer(capacity=capacity, num_envs=state.cursor.shape[0]), state
    if "_meta" in keys:
        return load_reference_buffer_hdf5(s, device)
    if "observations" in keys:
        return buffer_from_d4rl(s, device)
    raise ValueError(
        f"{path}: unrecognized buffer layout (expected a 'storage' group, a reference '_meta' group, or D4RL "
        f"qlearning keys; found {sorted(keys)[:8]})"
    )


def normalize_obs_in_buffer(state: ReplayBufferState, eps: float = 1e-8) -> tuple[ReplayBufferState, np.ndarray, np.ndarray]:
    """``(state, mean, std)``: ``obs`` and ``obs_next`` standardised with the
    mean and population std of ``obs`` over the whole dataset (``std =
    sqrt(var + eps)``), in a new state whose other leaves are shared; the
    statistics come back as float32 numpy arrays, for the evaluation envs.
    The statistics are summed in float64 on the state's device."""
    obs = state.storage["obs"].to(torch.float32)
    flat = obs.reshape(-1, obs.shape[-1]).to(torch.float64)
    mean = flat.mean(0)
    std = torch.sqrt(flat.var(0, correction=0) + eps)
    mean32, std32 = mean.to(torch.float32), std.to(torch.float32)
    storage = Batch(state.storage)
    storage["obs"] = (obs - mean32) / std32
    storage["obs_next"] = (state.storage["obs_next"].to(torch.float32) - mean32) / std32
    return dataclasses.replace(state, storage=storage), mean32.cpu().numpy(), std32.cpu().numpy()
