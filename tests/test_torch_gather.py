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

