"""The port's ``parallel/`` package (tianshou_tpu_torch.parallel) on the
CPU over gloo, against the JAX package's ``parallel/`` on the 8-device
virtual CPU mesh of ``tests/conftest.py``.

Two-rank cases run this file itself as two subprocesses (``run_ranks``:
``python tests/test_torch_parallel.py <case> <rank> <world> <port> <out>``),
each a gloo rank on a free port of 127.0.0.1, every wait bounded and every
process killed in a ``finally``; the other port test files of the
multi-device slice launch their ranks through the same helper.

- ``shard_leading_axis`` places a pytree as the JAX package does at axis
  size 2 (sharded where the leading size is non-zero and divisible, else
  replicated); ``full_tensor()`` is the input and rank r's ``to_local()``
  is the JAX shard on device r of ``make_mesh(2)``; ``replicate``,
  ``host_sharded_array`` and ``host_shard_pytree`` build the global
  arrays from each rank's rows.
- ``process_env_slice`` follows the JAX formula on two ranks and refuses an
  uneven split; ``init_distributed`` returns ``False`` without variables,
  raises for ``"cuda"`` without CUDA, and joins a group from torchrun's
  variables and from the JAX package's.
- ``gather_env_axis`` assembles a trajectory bitwise (``-0.0``, bools,
  bf16); ``mean_over_ranks`` averages; ``make_distributed_update`` keeps
  the JAX ``n_step`` assertion.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 240.0
LAUNCH_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS",
                    "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.settimeout(5.0)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, case: str, world: int = 2, timeout: float = RANK_TIMEOUT, env: dict | None = None,
              rank_env=None, inputs=None) -> list:
    """Run ``case`` of ``script`` (a test file) as ``world`` gloo ranks, each
    a subprocess with ``env`` (and ``rank_env(rank)``) over a copy of this
    process's environment less the launch variables, ``inputs`` handed to
    every rank through a ``torch.save`` file; returns each rank's result
    (what the case returned).  Every wait is bounded and every process is
    killed in a ``finally``."""
    port = free_port()
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARIABLES}
    base.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **(env or {}))
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        in_path = os.path.join(tmp, "inputs.pt")
        torch.save(inputs, in_path)
        procs, logs = [], []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, script, case, str(r), str(world), str(port), outs[r], in_path],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO,
                    env={**base, **(rank_env(r) if rank_env else {})}))
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {case} failed:\n{log[-4000:]}"
        return [torch.load(o, weights_only=False) for o in outs]


def rank_main(cases: dict) -> None:
    """A rank's entry: ``<case> <rank> <world> <port> <out> <inputs>``.
    Joins a gloo group of ``world`` ranks (unless the case joins by
    itself), runs ``cases[case](ctx)`` (``ctx``: ``rank``, ``world``,
    ``port``, ``inputs``) and saves its result to ``out``."""
    case, rank, world, port, out, in_path = sys.argv[1:]
    ctx = types.SimpleNamespace(rank=int(rank), world=int(world), port=int(port),
                                inputs=torch.load(in_path, weights_only=False))
    torch.set_num_threads(1)
    import torch.distributed as dist

    fn = cases[case]
    if not getattr(fn, "joins_itself", False):
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{ctx.port}", world_size=ctx.world,
                                rank=ctx.rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        torch.save(fn(ctx), out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def joins_itself(fn):
    """Mark a case that starts its own process group."""
    fn.joins_itself = True
    return fn


# -- the ranks' cases -------------------------------------------------------------
def _tree():
    """A pytree of every placement case: divisible, odd, empty, scalar."""
    rng = np.random.default_rng(0)
    return {"obs": rng.normal(size=(8, 3)).astype(np.float32), "idx": np.arange(6, dtype=np.int64),
            "odd": rng.normal(size=(5, 2)).astype(np.float32), "empty": np.zeros((0, 4), np.float32),
            "step": np.asarray(7, np.int32)}


def _case_placement(ctx):
    from tianshou_tpu_torch.parallel.mesh import make_mesh, replicate, shard_leading_axis

    mesh = make_mesh(ctx.world, device="cpu")
    placed = shard_leading_axis(_tree(), mesh)
    rep = replicate({"w": np.ones((4, 2), np.float32)}, mesh)
    return {"placements": {k: type(v.placements[0]).__name__ for k, v in placed.items()},
            "full": {k: v.full_tensor() for k, v in placed.items()},
            "local": {k: v.to_local() for k, v in placed.items()},
            "replicated": (type(rep["w"].placements[0]).__name__, rep["w"].to_local())}


def _case_host_shards(ctx):
    from tianshou_tpu_torch.parallel.distributed import global_mesh, host_shard_pytree, process_env_slice

    mesh = global_mesh(device="cpu")
    local = {"obs": np.full((3, 2), ctx.rank, np.float32), "act": torch.arange(3) + 10 * ctx.rank}
    g = host_shard_pytree(local, mesh)
    uneven = None
    try:
        process_env_slice(9)
    except ValueError as e:
        uneven = str(e)
    return {"shape": tuple(g["obs"].shape), "full_obs": g["obs"].full_tensor(), "full_act": g["act"].full_tensor(),
            "slice": process_env_slice(16), "uneven": uneven}


@joins_itself
def _case_init_from_env(ctx):
    from tianshou_tpu_torch.parallel.distributed import init_distributed, is_distributed, process_index

    ok = init_distributed(device="cpu")
    return {"ok": ok, "distributed": is_distributed(), "rank": process_index()}


def _case_gather(ctx):
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.tree import tree_map
    from tianshou_tpu_torch.parallel.distributed import gather_env_axis, mean_over_ranks

    def traj(r):
        g = torch.Generator().manual_seed(r)
        obs = torch.randn(5, 3, 2, generator=g)
        obs[0, 0, 0] = -0.0
        return Batch(obs=obs, act=torch.randint(0, 4, (5, 3), generator=g),
                     done=torch.rand(5, 3, generator=g) < 0.5,
                     policy=Batch(logp=torch.randn(5, 3, generator=g).to(torch.bfloat16)))

    world = torch.distributed.group.WORLD
    out = tree_map(torch.clone, gather_env_axis(traj(ctx.rank), world))  # views of one buffer
    return {"out": out, "want": [traj(r) for r in range(ctx.world)],
            "mean": mean_over_ranks([float(ctx.rank), 2.0 * ctx.rank], world, torch.device("cpu"))}


CASES = {"placement": _case_placement, "host_shards": _case_host_shards, "init_from_env": _case_init_from_env,
         "gather": _case_gather}


# -- the tests ----------------------------------------------------------------------
def test_shard_leading_axis_places_as_jax_does():
    import jax
    from jax.sharding import PartitionSpec as P

    from tianshou_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from tianshou_tpu.parallel.mesh import shard_leading_axis as jax_shard

    ranks = run_ranks(__file__, "placement")
    jmesh = jax_make_mesh(2)
    jplaced = jax_shard(_tree(), jmesh)
    for k, v in _tree().items():
        sharded = jplaced[k].sharding.spec == P("dp", *([None] * (np.ndim(v) - 1)))
        for r, res in enumerate(ranks):
            assert res["placements"][k] == ("Shard" if sharded else "Replicate"), k
            np.testing.assert_array_equal(res["full"][k].numpy(), v, err_msg=k)
            shard = next(s for s in jplaced[k].addressable_shards if s.device == jmesh.devices[r])
            np.testing.assert_array_equal(res["local"][k].numpy(), np.asarray(shard.data), err_msg=f"{k} rank {r}")
    assert [k for k in _tree() if ranks[0]["placements"][k] == "Shard"] == ["obs", "idx"]
    for res in ranks:
        assert res["replicated"][0] == "Replicate"
        np.testing.assert_array_equal(res["replicated"][1].numpy(), np.ones((4, 2), np.float32))
    assert jax.device_count() >= 2


def test_host_shard_pytree_and_process_env_slice_on_two_ranks():
    ranks = run_ranks(__file__, "host_shards")
    for r, res in enumerate(ranks):
        assert res["shape"] == (6, 2)
        np.testing.assert_array_equal(res["full_obs"].numpy(), np.repeat([[0.0], [1.0]], 3, axis=0) * np.ones(2))
        np.testing.assert_array_equal(res["full_act"].numpy(), np.asarray([0, 1, 2, 10, 11, 12]))
        # the JAX formula: (process_index * per, per)
        assert res["slice"] == (r * 8, 8)
        assert "must divide evenly" in res["uneven"]


@pytest.mark.parametrize("names", ["torchrun", "jax"])
def test_init_distributed_reads_the_launch_variables(names):
    port = free_port()
    if names == "torchrun":
        env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2"}
        per_rank = "RANK"
    else:
        env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2"}
        per_rank = "JAX_PROCESS_ID"
    results = run_ranks(__file__, "init_from_env", env=env, rank_env=lambda r: {per_rank: str(r)})
    assert [r["ok"] for r in results] == [True, True]
    assert [r["rank"] for r in results] == [0, 1] and all(r["distributed"] for r in results)


def test_init_distributed_without_variables_or_cuda(monkeypatch):
    from tianshou_tpu.parallel.distributed import init_distributed as jax_init
    from tianshou_tpu_torch.parallel.distributed import (
        init_distributed,
        is_distributed,
        process_count,
        process_env_slice,
        process_index,
    )

    for name in LAUNCH_VARIABLES:
        monkeypatch.delenv(name, raising=False)
    assert init_distributed(device="cpu") is False and jax_init() is False
    # one process: nothing starts, as in JAX
    assert init_distributed("127.0.0.1:1", 1, 0, device="cpu") is False
    assert not is_distributed() and (process_count(), process_index()) == (1, 0)
    assert process_env_slice(12) == (0, 12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_distributed()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_distributed("127.0.0.1:1", 2, 0, device="cuda")


def test_gather_env_axis_is_bitwise_and_mean_over_ranks_averages():
    ranks = run_ranks(__file__, "gather")
    for res in ranks:
        out, want = res["out"], res["want"]
        for key in ("obs", "act", "done"):
            ref = torch.cat([w[key] for w in want], dim=1)
            assert out[key].dtype == ref.dtype and torch.equal(out[key], ref), key
        assert torch.equal(out["policy"]["logp"], torch.cat([w["policy"]["logp"] for w in want], dim=1))
        assert torch.signbit(out["obs"][0, 0, 0]) and torch.signbit(out["obs"][0, 3, 0])  # -0.0 survives
        assert res["mean"] == [0.5, 1.0]


def test_make_distributed_update_serves_one_step_targets_only():
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.parallel.distributed import make_distributed_update

    with pytest.raises(AssertionError, match="1-step targets only"):
        make_distributed_update(DQN(QNet(4, (8,), 2), Discrete(2), n_step=3, device="cpu"))
    update = make_distributed_update(DQN(QNet(4, (8,), 2), Discrete(2), device="cpu"))
    assert callable(update)


if __name__ == "__main__":
    rank_main(CASES)
