"""Device meshes for data parallelism (port of ``tianshou_tpu/parallel/mesh.py``).

The JAX package shards the env and batch axis of the pipeline's pytrees over
a ``jax.sharding.Mesh`` and lets XLA insert the collectives.  The port runs
one eager program per rank over ``torch.distributed`` (NCCL on the card,
gloo on the CPU), one device a rank.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the JAX package's axis name (``"dp"``); its group
(``mesh.get_group("dp")``) is the one the distributed trainers average
gradients over.

:func:`shard_leading_axis` and :func:`replicate` return ``DTensor``s, the
counterpart of a global ``jax.Array``: ``.full_tensor()`` is the global
value, ``.to_local()`` this rank's rows.  The trainers do not compute on
them: the kernel, the generators and the port's in-place updates do not go
through ``DTensor``'s sharding propagation, so the trainers work on local
tensors and call the collectives themselves (``trainer/distributed.py``).

The ensemble axis: :func:`make_mesh2` is the JAX package's ``(n /
second_size, second_size)`` mesh named ``("dp", "ep")``, and
:func:`shard_ensemble_axis` places a tree as the JAX function does
(``Shard(0)`` on ``"ep"`` where the leading dimension is the ensemble's
size, replicated elsewhere).  Where XLA partitions the update from those
layouts, the port's ensembles are model-parallel modules:
:func:`shard_ensemble_modules` shards every ``EnsembleMLP`` of a train
state over the ``"ep"`` group (``EnsembleMLP.shard_``: each rank keeps its
``K / ep`` members and the forward gathers all K with the autograd pair of
``networks/common.py``), and the off-policy distributed trainer does so for
a two-axis mesh.  A rank's ``"dp"`` group is the ranks of its ``"ep"``
coordinate: the ranks that hold the same members.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.networks.common import EnsembleMLP
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["make_mesh", "make_mesh2", "shard_leading_axis", "shard_ensemble_axis", "shard_ensemble_modules",
           "replicate", "mesh_device"]


def _needs_group(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group: call init_distributed (or "
                           "torch.distributed.init_process_group) on every rank first")


def make_mesh(n_devices: int | None = None, axis_name: str = "dp", device: str | torch.device = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over the first ``n_devices`` ranks of
    the default process group (all of them by default), one device a rank
    (``device``'s type: ``"cuda"`` over NCCL, ``"cpu"`` over gloo).  Every
    rank of the group calls it.  Raises without a process group
    (:func:`~tianshou_tpu_torch.parallel.distributed.init_distributed`)."""
    dev = resolve_device(device)
    _needs_group("make_mesh")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis_name,))


def make_mesh2(
    n_devices: int | None = None,
    second_size: int = 2,
    axis_names: tuple[str, str] = ("dp", "ep"),
    device: str | torch.device = "cuda",
) -> DeviceMesh:
    """A 2-D mesh ``(n / second_size, second_size)`` over the first
    ``n_devices`` ranks (all by default): data parallelism on the first
    axis, ensemble parallelism on the second.  Rank ``r`` sits at ``(r //
    second_size, r % second_size)``.  Every rank of the group calls it."""
    dev = resolve_device(device)
    _needs_group("make_mesh2")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    assert n % second_size == 0, (n, second_size)
    return DeviceMesh(dev.type, torch.arange(n).reshape(n // second_size, second_size),
                      mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def _placements(mesh: DeviceMesh, axis_name: str, sharded: bool) -> list:
    """``Shard(0)`` on ``axis_name`` (when ``sharded``), ``Replicate()`` on
    every other axis."""
    return [Shard(0) if sharded and name == axis_name else Replicate() for name in mesh.mesh_dim_names]


def shard_leading_axis(tree: Any, mesh: DeviceMesh, axis_name: str = "dp") -> Any:
    """Place every leaf of ``tree`` (the global value, the same on every
    rank) on the mesh, by the JAX package's rule: a leaf whose leading
    dimension is non-zero and divisible by the axis size is sharded along it
    (``Shard(0)``), every other leaf (scalars, odd sizes) replicated."""
    n = _axis_size(mesh, axis_name)
    dev = mesh_device(mesh)

    def place(x):
        t = torch.as_tensor(x).to(dev)
        sharded = t.dim() >= 1 and t.shape[0] > 0 and t.shape[0] % n == 0
        return distribute_tensor(t, mesh, _placements(mesh, axis_name, sharded))

    return tree_map(place, tree)


def shard_ensemble_axis(tree: Any, mesh: DeviceMesh, ensemble_size: int, axis_name: str = "ep") -> Any:
    """Place every leaf of ``tree`` (the global value, the same on every
    rank) on the mesh by the JAX package's rule for ``[K, ...]`` ensemble
    parameters and optimizer state: a leaf whose leading dimension equals
    ``ensemble_size`` is sharded over ``axis_name``, every other leaf
    replicated."""
    size = _axis_size(mesh, axis_name)
    assert ensemble_size % size == 0, (ensemble_size, size)
    dev = mesh_device(mesh)

    def place(x):
        t = torch.as_tensor(x).to(dev)
        sharded = t.dim() >= 1 and t.shape[0] == ensemble_size
        return distribute_tensor(t, mesh, _placements(mesh, axis_name, sharded))

    return tree_map(place, tree)


def _modules_and_optimizers(state: Any) -> tuple[list[nn.Module], list[torch.optim.Optimizer]]:
    """The modules and optimizers of a train state (a dataclass, a dict, a
    list or tuple of them, or a module)."""
    modules, optimizers, seen = [], [], set()

    def walk(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, nn.Module):
            modules.append(x)
        elif isinstance(x, torch.optim.Optimizer):
            optimizers.append(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(state)
    return modules, optimizers


def shard_ensemble_modules(state: Any, group) -> int:
    """Shard every ``EnsembleMLP`` of ``state`` (a train state: its online
    and target critics, and the optimizers that step them) over the process
    ``group`` (a mesh's ``"ep"`` group), in place; returns how many."""
    modules, optimizers = _modules_and_optimizers(state)
    ensembles = {id(m): m for module in modules for m in module.modules() if isinstance(m, EnsembleMLP)}
    for m in ensembles.values():
        m.shard_(group, optimizers)
    return len(ensembles)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every leaf of ``tree`` replicated on the mesh."""
    dev = mesh_device(mesh)
    return tree_map(lambda x: distribute_tensor(torch.as_tensor(x).to(dev), mesh, [Replicate()]), tree)
