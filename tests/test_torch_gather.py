"""gather_rows_cast port (tianshou_tpu_torch/ops/gather.py) against the JAX
Pallas kernel in interpret mode and the jnp path: bitwise, since every
uint8 value is exact in bfloat16.  The CUDA kernel itself is checked
against its plain version on the card by chip_smoke.py."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.ops.pallas_gather import gather_rows_cast as jax_gather_rows_cast
from tianshou_tpu_torch.ops.gather import gather_rows_cast, gather_rows_cast_plain


def _inputs(R, F, B, seed):
    rng = np.random.default_rng(seed)
    storage = rng.integers(0, 256, (R, F), dtype=np.uint8)
    idx = rng.integers(0, R, (B,)).astype(np.int32)
    return storage, idx


def _bits(x_bf16_torch):
    return x_bf16_torch.view(torch.int16).numpy()


@pytest.mark.parametrize("R,F,B", [(64, 16 * 8, 40), (16, 13, 9), (8, 28224 // 64, 33)])
def test_gather_rows_cast_matches_jax_bitwise(R, F, B):
    storage, idx = _inputs(R, F, B, seed=R + F + B)
    ref_jnp = np.asarray(jnp.asarray(storage)[jnp.asarray(idx)].astype(jnp.bfloat16))
    # F % 8 != 0 takes the jnp path inside the JAX function as well
    ref_pallas = np.asarray(jax_gather_rows_cast(jnp.asarray(storage), jnp.asarray(idx), interpret=True))
    for idx_t in (torch.from_numpy(idx), torch.from_numpy(idx).to(torch.int64)):
        got = gather_rows_cast(torch.from_numpy(storage), idx_t)
        assert got.dtype == torch.bfloat16 and got.shape == (B, F)
        np.testing.assert_array_equal(_bits(got), ref_jnp.view(np.int16))
        np.testing.assert_array_equal(_bits(got), ref_pallas.view(np.int16))


def test_gather_rows_cast_cpu_does_not_count_launches():
    storage, idx = _inputs(16, 32, 5, seed=0)
    before = gather_rows_cast.launches
    gather_rows_cast(torch.from_numpy(storage), torch.from_numpy(idx))
    assert gather_rows_cast.launches == before == 0


@pytest.mark.parametrize(
    "storage,idx",
    [
        (torch.zeros((4, 8), dtype=torch.float32), torch.zeros(2, dtype=torch.int64)),
        (torch.zeros((4, 8, 2), dtype=torch.uint8), torch.zeros(2, dtype=torch.int64)),
        (torch.zeros((8, 4), dtype=torch.uint8).t(), torch.zeros(2, dtype=torch.int64)),
        (torch.zeros((4, 8), dtype=torch.uint8), torch.zeros(2, dtype=torch.float32)),
    ],
    ids=["float-storage", "3d-storage", "non-contiguous", "float-idx"],
)
def test_gather_rows_cast_rejects_bad_inputs(storage, idx):
    with pytest.raises(ValueError):
        gather_rows_cast(storage, idx)


def test_build_module_imports_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", os.defpath)
    build = importlib.reload(importlib.import_module("tianshou_tpu_torch.ops._build"))
    assert "gather_rows_cast" in build.kernel_names()
    assert "-gencode" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    from torch.utils.cpp_extension import CUDA_HOME

    # where no toolkit is installed, a build raises instead of falling back
    if CUDA_HOME is None and not any(build.BUILD_DIR.glob("libgather_rows_cast_*.so")):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build()



# -- the launch plan of the CUDA kernel (computed in Python, checked here) ----
H100_SMS = 132
PLAN_CASES = {
    # the callers' shapes (R, F, B), both base pointers aligned
    "atari": (8192, 28224, 13312, True, "grouped"),
    "hl_atari": (8192, 28224, 13312, True, "grouped"),
    "atari_dedup": (8192, 7056, 53248, True, "grouped"),
    "atari_host": (100_000, 7056, 1280, True, "pipeline"),
    # chip_smoke.py's edge cases
    "F=13, B=9": (16, 13, 9, True, "simple"),
    "F=4100": (300, 4100, 1001, True, "simple"),
    "base offset 3": (64, 28224, 77, False, "simple"),
    "B=1": (1000, 7056, 1, True, "pipeline"),
    "unequal runs": (4096, 7056, H100_SMS * 70 + 37, True, "grouped"),
    "idx * F > 2^32": (700_000, 7056, 4096, True, "pipeline"),
    "idx * F > 2^32, grouped": (30_000, 150_000, 7500, True, "grouped"),
}


def _chunk_spans(feat, chunk):
    """``(offset, bytes)`` of each bulk copy of one row, as the kernel walks a
    row (``produce_row`` in csrc/gather_rows_cast.cu)."""
    return [(off, min(chunk, feat - off)) for off in range(0, feat, chunk)]


def _block_rows(batch, grid):
    """The output rows of each block of the output-order pipeline, as
    ``gather_rows_cast_pipeline`` walks them."""
    return [range(k, batch, grid) for k in range(grid)]


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_launch_plan_at_every_caller_shape_and_edge_case(case):
    from tianshou_tpu_torch.ops import gather as g

    rows, feat, batch, aligned, route = PLAN_CASES[case]
    plan = g.launch_plan(rows, feat, batch, aligned, H100_SMS)
    assert plan.route == route
    assert 1 <= plan.grid <= batch
    if route == "simple":
        assert plan.grid == batch
        return
    # bulk copies: multiples of 16 bytes on 16-byte boundaries, covering
    # each row exactly once, in order
    spans = _chunk_spans(feat, plan.chunk)
    assert plan.chunk % 16 == 0 and plan.chunk <= g.MAX_CHUNK
    assert all(off % 16 == 0 and size % 16 == 0 and 0 < size <= plan.chunk for off, size in spans)
    assert [off for off, _ in spans] == list(np.cumsum([0] + [size for _, size in spans[:-1]]))
    assert sum(size for _, size in spans) == feat
    # the ring: at least 3 stages, within a block's shared memory
    assert 3 <= plan.stages <= g.MAX_STAGES
    assert plan.smem_bytes >= g.BARRIER_BYTES + plan.stages * plan.chunk
    assert plan.smem_bytes <= g.SMEM_PER_BLOCK
    assert plan.warps in g.WARP_CHOICES
    if route == "grouped":  # the row counts and this block's output rows too
        assert batch <= 65_536 and 4 * batch >= rows
        assert plan.smem_bytes >= g.BARRIER_BYTES + plan.stages * plan.chunk + 4 * rows + 2 * batch
        assert plan.grid <= H100_SMS
    else:  # every output row in exactly one block's rows
        rows_of = _block_rows(batch, plan.grid)
        assert sorted(b for r in rows_of for b in r) == list(range(batch))
        per_sm = -(-plan.grid // H100_SMS)
        assert per_sm * (plan.smem_bytes + g.SMEM_RESERVED) <= g.SMEM_PER_SM
        assert per_sm * (plan.warps + 1) * 32 <= 2048


def test_launch_plan_forced_routes():
    from tianshou_tpu_torch.ops import gather as g

    # the comparison route and the other pipeline, where the inputs allow them
    assert g.launch_plan(8192, 28224, 13312, True, H100_SMS, "simple").route == "simple"
    assert g.launch_plan(8192, 28224, 13312, True, H100_SMS, "pipeline").route == "pipeline"
    assert g.launch_plan(100_000, 7056, 1280, True, H100_SMS).route == "pipeline"
    with pytest.raises(ValueError, match="16-byte"):
        g.launch_plan(64, 28224, 77, False, H100_SMS, "pipeline")
    with pytest.raises(ValueError, match="16-byte"):
        g.launch_plan(16, 13, 9, True, H100_SMS, "grouped")
    with pytest.raises(ValueError, match="shared memory"):
        g.launch_plan(100_000, 7056, 1280, True, H100_SMS, "grouped")
    with pytest.raises(ValueError, match="unknown"):
        g.launch_plan(64, 16, 8, True, H100_SMS, "fastest")


def test_c_source_declares_every_registered_entry_point():
    """Each C entry point ``_build._SIGNATURES`` names is defined in its
    source with as many parameters, pointers and the stream where ctypes
    passes ``c_void_p`` and 64-bit integers where it passes ``c_int64``."""
    import ctypes
    import re

    from tianshou_tpu_torch.ops import _build

    for name, functions in _build._SIGNATURES.items():
        src = (_build.CSRC_DIR / f"{name}.cu").read_text()
        for fn, (_, argtypes) in functions.items():
            m = re.search(rf"\bint {fn}\(([^)]*)\)\s*\{{", src)
            assert m, f"{fn} is not defined in {name}.cu"
            params = [" ".join(p.split()) for p in m.group(1).split(",")]
            assert len(params) == len(argtypes), (fn, params)
            for param, argtype in zip(params, argtypes):
                if argtype is ctypes.c_void_p:
                    assert "*" in param or param.startswith("cudaStream_t"), param
                else:
                    assert argtype is ctypes.c_int64 and param.startswith("int64_t "), param
