"""Fused replay-row gather + uint8 -> bfloat16 decode (port of
``tianshou_tpu/ops/pallas_gather.py``).

``gather_rows_cast(storage [R, F] uint8, idx [B]) -> [B, F] bfloat16``.  On a
CUDA tensor it launches the hand-written Hopper kernel
``csrc/gather_rows_cast.cu`` (built at first use by :mod:`._build`) by the
plan of :func:`launch_plan`; on a CPU tensor it computes
:func:`gather_rows_cast_plain`.  There is no fallback from one to the other:
a CUDA tensor gets the kernel or an error.  Every uint8 value is exact in
bf16, so both are bitwise equal to a gather followed by a cast.  Indices are
assumed in ``[0, R)``, as in the TPU kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tianshou_tpu_torch.ops import _build

__all__ = ["LaunchPlan", "gather_rows_cast", "gather_rows_cast_plain", "launch_plan"]

# the pipelines' constants, as in csrc/gather_rows_cast.cu: a block's
# consumer warps (one of 8, 16, 24, 31) and the ring's most stages
WARP_CHOICES = (8, 16, 24, 31)
MAX_STAGES = 8
BARRIER_BYTES = 2 * MAX_STAGES * 8
# a Hopper SM's shared memory: 228 KB, of which a block may take 227 KB and
# the runtime reserves 1 KB per resident block
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233_472, 232_448, 1024
# the plan's choices, from tools/gather_sweep.py on an H100 (PERF.md):
# bulk copies of at most 16 KB; the grouped route 24 consumer warps and a
# ring of 3, one block an SM; the output-order pipeline a ring of 4, with 16
# consumer warps and one block an SM where each block gets 32 rows or more,
# else 8 warps and up to 4 blocks an SM (short runs: more blocks hide each
# one's first index and row)
MAX_CHUNK = 16_384
GROUPED_WARPS, GROUPED_STAGES = 24, 3
STAGES, RUN_ROWS = 4, 32
LONG_RUN_WARPS, SHORT_RUN_WARPS, SHORT_RUN_BLOCKS = 16, 8, 4
# route codes of the C entry point
ROUTES = {"simple": 0, "pipeline": 1, "grouped": 2}


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch runs: its route, its grid (rows on the simple route,
    persistent blocks on the pipelines), the consumer warps of a block, the
    bytes of each bulk copy, the ring's stages and the dynamic shared memory
    of a block."""

    route: str
    grid: int
    warps: int = 0
    chunk: int = 0
    stages: int = 0
    smem_bytes: int = 0


def _chunk(feat: int, max_chunk: int = MAX_CHUNK) -> int:
    """The bulk copy's bytes: a row in equal pieces of at most ``max_chunk``,
    rounded up to 16."""
    pieces = -(-feat // max_chunk)
    return (-(-feat // pieces) + 15) // 16 * 16


def _grouped_smem(rows: int, batch: int, chunk: int, stages: int) -> int:
    """Barriers, ring, a count per storage row and an output row per draw."""
    return BARRIER_BYTES + stages * chunk + 4 * rows + (2 * batch + 15) // 16 * 16


@functools.lru_cache(maxsize=256)
def launch_plan(rows: int, feat: int, batch: int, aligned: bool, sms: int, route: str | None = None) -> LaunchPlan:
    """The plan of one launch at ``storage [rows, feat]``, ``idx [batch]``.
    ``aligned``: both base pointers on a 16-byte boundary; ``sms``: the
    card's multiprocessors.  The pipelines need ``feat % 16 == 0`` and
    aligned pointers (a bulk copy moves 16-byte multiples between 16-byte
    boundaries); other inputs take the simple route.  Of the two, "grouped"
    (each distinct row read once) serves batches that draw rows often
    (``batch >= rows / 4``: a quarter or more of the draws repeat a row)
    where its counts and output rows fit a block's shared memory, one block
    an SM; "pipeline" (output order) the rest.  ``route`` forces one (a
    pipeline only where the inputs allow it)."""
    fits = aligned and feat % 16 == 0
    chunk = _chunk(feat)
    grouped_smem = _grouped_smem(rows, batch, chunk, GROUPED_STAGES)
    if route is None:
        if not fits:
            route = "simple"
        elif batch <= 65_536 and 4 * batch >= rows and grouped_smem <= SMEM_PER_BLOCK:
            route = "grouped"
        else:
            route = "pipeline"
    if route not in ROUTES:
        raise ValueError(f"unknown gather_rows_cast route {route!r}; expected one of {sorted(ROUTES)}")
    if route == "simple":
        return LaunchPlan("simple", grid=batch)
    if not fits:
        raise ValueError(f"the pipelines need F % 16 == 0 and 16-byte aligned pointers (F={feat})")
    if route == "grouped":
        if batch > 65_536 or grouped_smem > SMEM_PER_BLOCK:
            raise ValueError(f"the grouped route does not fit R={rows}, B={batch} in a block's shared memory")
        return LaunchPlan("grouped", grid=min(batch, sms), warps=GROUPED_WARPS, chunk=chunk,
                          stages=GROUPED_STAGES, smem_bytes=grouped_smem)
    smem = BARRIER_BYTES + STAGES * chunk
    if batch >= RUN_ROWS * sms:
        warps, per_sm = LONG_RUN_WARPS, 1
    else:
        warps, per_sm = SHORT_RUN_WARPS, max(1, min(SHORT_RUN_BLOCKS, SMEM_PER_SM // (smem + SMEM_RESERVED)))
    return LaunchPlan("pipeline", grid=min(batch, sms * per_sm), warps=warps, chunk=chunk, stages=STAGES,
                      smem_bytes=smem)


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def gather_rows_cast_plain(storage: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the reference the kernel is tested against."""
    return storage.index_select(0, idx.to(torch.int64)).to(torch.bfloat16)


def gather_rows_cast(storage: torch.Tensor, idx: torch.Tensor, *, route: str | None = None) -> torch.Tensor:
    """``out[b, :] = bf16(storage[idx[b], :])``.

    ``storage`` is a 2-D contiguous uint8 tensor, ``idx`` a 1-D int64 (or
    int32, widened) tensor on the same device.  Each launch of the CUDA
    kernel adds one to ``gather_rows_cast.launches``; a call under a CUDA
    graph capture launches nothing (the graph's replays run the kernel, and
    a profiler counts those).  ``route`` forces a
    route of :func:`launch_plan`, to compare them; the default follows the
    inputs.
    """
    if storage.dim() != 2 or storage.dtype != torch.uint8 or not storage.is_contiguous():
        raise ValueError(
            f"storage must be a contiguous 2-D uint8 tensor, got {storage.dtype} "
            f"{tuple(storage.shape)} contiguous={storage.is_contiguous()}"
        )
    if idx.dim() != 1 or idx.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"idx must be a 1-D int64/int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    device = storage.device
    if idx.device != device:
        raise ValueError(f"idx on {idx.device} but storage on {device}")
    if device.type == "cpu":
        return gather_rows_cast_plain(storage, idx)
    if device.type != "cuda":
        raise ValueError(f"no gather_rows_cast kernel for device {device}")
    if idx.dtype != torch.int64 or not idx.is_contiguous():
        idx = idx.to(torch.int64).contiguous()
    (rows, feat), batch = storage.shape, idx.shape[0]
    out = torch.empty((batch, feat), dtype=torch.bfloat16, device=device)
    if batch == 0 or feat == 0:
        return out
    index = device.index if device.index is not None else torch.cuda.current_device()
    aligned = (storage.data_ptr() | out.data_ptr()) % 16 == 0
    _launch(storage, idx, out, launch_plan(rows, feat, batch, aligned, _sm_count(index), route), index)
    return out


def _launch(storage: torch.Tensor, idx: torch.Tensor, out: torch.Tensor, plan: LaunchPlan, index: int) -> None:
    """Launches the kernel by ``plan`` on the current stream of card
    ``index`` (``idx`` int64 and contiguous, ``out`` allocated) and counts
    the launch.  The raw stream handle costs a tenth of
    ``torch.cuda.current_stream(index).cuda_stream`` to look up."""
    (rows, feat), batch = storage.shape, idx.shape[0]
    lib = _build.library("gather_rows_cast")
    code = lib.ts_gather_rows_cast(
        storage.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, feat, batch, ROUTES[plan.route], plan.grid,
        plan.warps, plan.chunk, plan.stages, plan.smem_bytes, index, torch._C._cuda_getCurrentRawStream(index),
    )
    _build.check(lib, code, "gather_rows_cast launch")
    if not torch.cuda.is_current_stream_capturing():  # a capture records the launch; each replay runs it
        gather_rows_cast.launches += 1


gather_rows_cast.launches = 0
