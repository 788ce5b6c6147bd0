"""Multi-process data parallelism over ``torch.distributed`` (port of
``tianshou_tpu/parallel/distributed.py``).

The JAX package joins every host to one ``jax.distributed`` runtime and
runs the learner over the global device mesh, XLA inserting the gradient
all-reduce.  Here every rank is one process on one device (NCCL on the
card, gloo on the CPU) running the same eager program on its own rows: it
steps its own shard of envs into its own buffer, and the learner's
optimizer steps average their gradients over the process group
(:func:`~tianshou_tpu_torch.algos.base.sync_gradients`).

Only ``all_reduce`` and ``broadcast`` are used on tensors that may live on
the card: gloo supports nothing else on CUDA tensors and NCCL supports
everything, so one code runs in the gloo CPU tests, in two gloo ranks on
one card and over NCCL.  An all-gather becomes a zero-filled global buffer
in which each rank writes its own rows, then an ``all_reduce`` sum
(:func:`gather_env_axis`, bitwise: the buffer is summed as bytes).

:func:`init_distributed` keeps the JAX signature and adds ``device``; its
defaults come from torchrun's variables, then from the JAX package's, so
a launch script written for either starts the port.  With one process it
starts nothing and returns ``False``.  :func:`process_count` and
:func:`process_index` read the default process group, 1 and 0 without one,
as ``jax.process_count()`` does without a runtime.  The global arrays of
:func:`host_sharded_array` are ``DTensor``s (``parallel/mesh.py``).
"""

from __future__ import annotations

import contextlib
import os
from collections.abc import Iterator
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.tree import tree_leaves, tree_map
from tianshou_tpu_torch.parallel.mesh import make_mesh, mesh_device
from tianshou_tpu_torch.utils.device import resolve_device
from tianshou_tpu_torch.utils.graphs import compile_step, named_tensors

__all__ = [
    "init_distributed",
    "is_distributed",
    "group_of",
    "process_count",
    "process_index",
    "global_mesh",
    "process_env_slice",
    "host_sharded_array",
    "host_shard_pytree",
    "make_distributed_update",
    "data_parallel",
    "gather_env_axis",
    "mean_over_ranks",
    "average_metrics",
    "rank_seed",
]


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Join the default process group; ``True`` when running distributed.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` default to torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``, then to ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.  With fewer than two
    processes nothing starts and the result is ``False``.  ``device="cuda"``
    takes NCCL and ``torch.cuda.set_device(local_device_ids[0])``
    (default ``LOCAL_RANK``, else 0) and raises without CUDA or NCCL: a
    CUDA group never falls back to gloo.  ``"cpu"`` takes gloo."""
    dev = resolve_device(device)
    if coordinator_address is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        else:
            coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError(f"{num_processes} processes but no process id (RANK or JAX_PROCESS_ID)")
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("device 'cuda' needs NCCL, which this build of torch lacks")
        local = local_device_ids[0] if local_device_ids else (_env_int("LOCAL_RANK") or 0)
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id)
    return True


def group_of(mesh: DeviceMesh | None = None, axis_name: str = "dp"):
    """The process group of ``mesh``'s axis, else the default group; ``None``
    without a process group (one process)."""
    if mesh is not None:
        return mesh.get_group(axis_name)
    return dist.group.WORLD if dist.is_initialized() else None


def process_count(group=None) -> int:
    """The ranks of ``group`` (default: the default group); 1 without one."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def process_index(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_distributed() -> bool:
    return process_count() > 1


def global_mesh(axis_name: str = "dp", device: str | torch.device = "cuda") -> DeviceMesh:
    """A 1-D mesh over every rank of the default process group, the
    learner's data-parallel axis."""
    return make_mesh(None, axis_name, device)


def process_env_slice(total_envs: int) -> tuple[int, int]:
    """``(start, count)`` of this process's contiguous env shard: each rank
    owns ``total_envs / process_count()`` envs and steps and stores only
    those."""
    n_proc = process_count()
    if total_envs % n_proc:
        raise ValueError(f"total_envs={total_envs} must divide evenly over {n_proc} processes")
    per = total_envs // n_proc
    return process_index() * per, per


def host_sharded_array(local: Any, mesh: DeviceMesh, axis_name: str = "dp") -> DTensor:
    """The global array whose leading axis is sharded over the mesh, from
    this rank's ``[local_n, ...]`` rows (numpy or a tensor); its global
    leading size is ``local_n * ranks``.  No rank holds the global rows."""
    if mesh.mesh_dim_names != (axis_name,):
        raise ValueError(f"a 1-D mesh named {axis_name!r} is needed, not {mesh.mesh_dim_names}")
    t = torch.as_tensor(np.asarray(local) if not isinstance(local, torch.Tensor) else local).to(mesh_device(mesh))
    return DTensor.from_local(t, mesh, [Shard(0)], run_check=False)


def host_shard_pytree(local_tree: Any, mesh: DeviceMesh, axis_name: str = "dp") -> Any:
    """:func:`host_sharded_array` over every leaf of a rank-local tree."""
    return tree_map(lambda x: host_sharded_array(x, mesh, axis_name), local_tree)


def rank_seed(seed: int, rank: int) -> int:
    """A seed for rank ``rank``'s own streams (env resets, replay sampling),
    distinct across ranks and fixed by ``(seed, rank)``."""
    return int(np.random.SeedSequence((int(seed), int(rank))).generate_state(1)[0])


@contextlib.contextmanager
def data_parallel(algo, group, rows: int) -> Iterator[None]:
    """Within the block, ``algo``'s optimizer steps average their gradients
    over ``group`` and its per-row draws are made for the global batch of
    ``rows`` rows a rank, this rank's block taken (``Algorithm.process_group``
    and ``row_block``); restored on exit.  ``group`` ``None``: one process,
    nothing changes."""
    saved = algo.process_group, algo.row_block
    if group is not None:
        algo.process_group = group
        algo.row_block = (process_index(group) * rows, process_count(group) * rows)
    try:
        yield
    finally:
        algo.process_group, algo.row_block = saved


def mean_over_ranks(values: list[float], group, device: torch.device) -> list[float]:
    """``values`` averaged over the ranks of ``group`` (one ``all_reduce`` of
    a float64 tensor on ``device``; unchanged without a group)."""
    if group is None:
        return [float(v) for v in values]
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    return (t / process_count(group)).tolist()


def average_metrics(metrics: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Device metrics averaged over the ranks of ``group``, still on the
    device: one ``all_reduce`` of the stacked values (unchanged without a
    group).  A rank's loss is the mean over its rows, so the average is the
    global batch's, the value the JAX package's global step reports."""
    if group is None or not metrics:
        return metrics
    values = torch.stack([v.float() for v in metrics.values()])
    dist.all_reduce(values, group=group)
    return dict(zip(metrics, (values / process_count(group)).unbind()))


def gather_env_axis(traj: Any, group, axis: int = 1) -> Any:
    """The global trajectory on every rank from each rank's ``[T, N_local,
    ...]`` leaves: ``[T, N_local * ranks, ...]``, rank ``r``'s envs at
    ``[r * N_local, (r + 1) * N_local)``.  Each rank writes its rows into a
    zero-filled global buffer and one ``all_reduce`` sums the buffers as
    bytes (each leaf padded to 8), so every value arrives bitwise, a float
    ``-0.0`` included."""
    if group is None:
        return traj
    n, r = process_count(group), process_index(group)
    glob, chunks = [], []
    for x in tree_leaves(traj):
        shape = list(x.shape)
        shape[axis] *= n
        g = torch.zeros(shape, dtype=x.dtype, device=x.device)
        g.narrow(axis, r * x.shape[axis], x.shape[axis]).copy_(x)
        glob.append(g)
        chunks.append(g.reshape(-1).view(torch.uint8))
        chunks.append(torch.zeros((-chunks[-1].numel()) % 8, dtype=torch.uint8, device=x.device))
    flat = torch.cat(chunks)
    dist.all_reduce(flat, group=group)
    parts = flat.split([c.numel() for c in chunks])[0::2]
    out = iter([part.view(g.dtype).view(g.shape) for part, g in zip(parts, glob)])
    return tree_map(lambda _: next(out), traj)


def make_distributed_update(algo, mesh: DeviceMesh | None = None, axis_name: str = "dp"):
    """The multi-process learner step ``update(ts, transitions, generator)
    -> (ts, metrics)``.

    ``transitions`` are this rank's rows of a global one-step batch (keys
    ``obs, act, rew, terminated, truncated, obs_next``; tensors on the
    algorithm's device), ``generator`` the learn generator every rank holds
    in lockstep.  The gradients are averaged over the mesh's group (the
    default group without a mesh), so every rank ends the step with the same
    parameters, and so are the metrics (:func:`average_metrics`).  Needs the
    ``presample``/``update_sampled`` split; one-step targets only, as in the
    JAX package: replay-backed n-step training across processes is
    :class:`~tianshou_tpu_torch.trainer.distributed.DistributedOffPolicyTrainer`.

    It runs compiled, as the JAX package jits it (:class:`_StagedUpdate`):
    on CUDA over NCCL (or without a process group) each call copies
    ``transitions`` into a static staging dict and replays a CUDA graph of
    the eager update (``update.eager``), the gradient all-reduces and the
    metrics' among its nodes; it returns the graph's static ``ts`` and
    metrics, which the next call overwrites.  On the CPU, or over a gloo
    group, the eager update runs on the staging."""
    if not getattr(algo, "supports_presampled", False):
        raise ValueError("make_distributed_update needs the presample/update_sampled split (supports_presampled)")
    n_step = int(getattr(algo, "n_step", 1))
    assert n_step == 1, (
        f"make_distributed_update serves 1-step targets only, but the algorithm is configured with "
        f"n_step={n_step}; use DistributedOffPolicyTrainer for the replay-backed pipeline")
    return _StagedUpdate(algo, group_of(mesh, axis_name))


class _StagedUpdate:
    """:func:`make_distributed_update`'s ``update``.  :meth:`eager` is the
    update op by op.  A call copies ``transitions`` into the static staging
    dict (one multi-tensor copy) and runs the compiled step over ``(ts,
    staging)`` (:func:`~tianshou_tpu_torch.utils.graphs.compile_step`: on
    CUDA over NCCL, or without a process group, a ``CapturedStep``, its
    first call the warm-up and the capture, later ones replays; on the CPU
    or over a gloo group :meth:`eager` on the staging).  The step is kept
    for the train state, its tensors, the transitions' shapes and dtypes and
    the generator of its first call: a call with another of them compiles
    (captures) again, so that a graph never replays over a state it was not
    captured over."""

    def __init__(self, algo, group):
        self.algo, self.group = algo, group
        self.compiled = None
        self.staging: dict[str, torch.Tensor] | None = None
        self._key: tuple = ()
        self._schema: list = []

    def eager(self, ts, transitions: dict, generator: torch.Generator):
        """The update op by op: ``(ts, metrics)``, the metrics averaged over
        the group."""
        b = transitions["act"].shape[0]
        dev = transitions["act"].device
        done = transitions["terminated"] | transitions["truncated"]
        sampled = (
            torch.zeros(b, dtype=torch.int64, device=dev),  # env_idx (unused: no buffer)
            torch.zeros(b, dtype=torch.int64, device=dev),  # pos
            torch.ones(b, dtype=torch.float32, device=dev),  # importance weights
            Batch(obs=transitions["obs"], act=transitions["act"]),
            transitions["rew"].to(torch.float32)[:, None],  # one-step chains
            done.to(torch.int32)[:, None],
            Batch(obs_next=transitions["obs_next"], terminated=transitions["terminated"]),
        )
        with data_parallel(self.algo, self.group, b):
            ts, _, metrics = self.algo.update_sampled(ts, None, None, sampled, generator)
        return ts, average_metrics(metrics, self.group)

    def _step(self, ts, staging, bstate, generator, explore_param):
        ts, metrics = self.eager(ts, staging, generator)
        return ts, staging, bstate, None, metrics

    def __call__(self, ts, transitions: dict, generator: torch.Generator):
        schema = [(k, v.shape, v.dtype) for k, v in transitions.items()]
        key = (ts, generator, *(t for _, t in named_tensors(ts)))
        if len(key) != len(self._key) or any(a is not b for a, b in zip(key, self._key)) or schema != self._schema:
            self.staging = {k: torch.empty_like(v) for k, v in transitions.items()}
            self.compiled = compile_step(self._step, transitions["act"].device, ts, self.staging, None,
                                         key=lambda: self.algo.update_pattern(ts, 1), groups=(self.group,),
                                         name="distributed.update")
            self._schema = schema
        with torch.no_grad():
            torch._foreach_copy_(list(self.staging.values()), list(transitions.values()))
        ts, _, _, _, metrics = self.compiled(ts, self.staging, None, generator, 0.0)
        # as the call left it: the first step (the capture) creates the
        # optimizer's state
        self._key = (ts, generator, *(t for _, t in named_tensors(ts)))
        return ts, metrics
