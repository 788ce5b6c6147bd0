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

The ensemble axis (``make_mesh2``, ``shard_ensemble_axis``) is not ported
yet: in eager PyTorch it is model parallelism inside ``CriticEnsemble``'s
forward, a slice of its own.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["make_mesh", "shard_leading_axis", "replicate", "mesh_device"]


def make_mesh(n_devices: int | None = None, axis_name: str = "dp", device: str | torch.device = "cuda") -> DeviceMesh:
    """A 1-D mesh named ``axis_name`` over the first ``n_devices`` ranks of
    the default process group (all of them by default), one device a rank
    (``device``'s type: ``"cuda"`` over NCCL, ``"cpu"`` over gloo).  Every
    rank of the group calls it.  Raises without a process group
    (:func:`~tianshou_tpu_torch.parallel.distributed.init_distributed`)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed (or "
                           "torch.distributed.init_process_group) on every rank first")
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(axis_name,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


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
        return distribute_tensor(t, mesh, [Shard(0) if sharded else Replicate()])

    return tree_map(place, tree)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every leaf of ``tree`` replicated on the mesh."""
    dev = mesh_device(mesh)
    return tree_map(lambda x: distribute_tensor(torch.as_tensor(x).to(dev), mesh, [Replicate()]), tree)
