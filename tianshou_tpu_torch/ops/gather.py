"""Fused replay-row gather + uint8 -> bfloat16 decode (port of
``tianshou_tpu/ops/pallas_gather.py``).

``gather_rows_cast(storage [R, F] uint8, idx [B]) -> [B, F] bfloat16``.  On a
CUDA tensor it launches the hand-written Hopper kernel
``csrc/gather_rows_cast.cu`` (built at first use by :mod:`._build`); on a
CPU tensor it computes :func:`gather_rows_cast_plain`.  There is no fallback
from one to the other: a CUDA tensor gets the kernel or an error.  Every
uint8 value is exact in bf16, so both are bitwise equal to a gather followed
by a cast.  Indices are assumed in ``[0, R)``, as in the TPU kernel.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.ops import _build

__all__ = ["gather_rows_cast", "gather_rows_cast_plain"]


def gather_rows_cast_plain(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the reference the kernel is tested against."""
    return storage.index_select(0, idx.to(torch.int64)).to(torch.bfloat16)


def gather_rows_cast(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, :] = bf16(storage[idx[b], :])``.

    ``storage`` is a 2-D contiguous uint8 tensor, ``idx`` a 1-D int64 (or
    int32, widened) tensor on the same device.  Each launch of the CUDA
    kernel adds one to ``gather_rows_cast.launches``.
    """
    if storage.dim() != 2 or storage.dtype != torch.uint8 or not storage.is_contiguous():
        raise ValueError(
            f"storage must be a contiguous 2-D uint8 tensor, got {storage.dtype} "
            f"{tuple(storage.shape)} contiguous={storage.is_contiguous()}"
        )
    if idx.dim() != 1 or idx.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"idx must be a 1-D int64/int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != storage.device:
        raise ValueError(f"idx on {idx.device} but storage on {storage.device}")
    if storage.device.type == "cpu":
        return gather_rows_cast_plain(storage, idx)
    if storage.device.type != "cuda":
        raise ValueError(f"no gather_rows_cast kernel for device {storage.device}")
    idx = idx.to(torch.int64).contiguous()
    (rows, feat), batch = storage.shape, idx.shape[0]
    out = torch.empty((batch, feat), dtype=torch.bfloat16, device=storage.device)
    if batch == 0 or feat == 0:
        return out
    lib = _build.library("gather_rows_cast")
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    code = lib.ts_gather_rows_cast(
        storage.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, feat, batch, stream
    )
    _build.check(lib, code, "gather_rows_cast launch")
    gather_rows_cast.launches += 1
    return out


gather_rows_cast.launches = 0
