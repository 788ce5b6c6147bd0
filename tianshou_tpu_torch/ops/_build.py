"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled with ``nvcc`` for Hopper (``sm_90a``) at first use into
``build/tianshou_tpu_torch/`` at the repository root, named after a hash of
its source and flags so that an edited source is rebuilt.  Libraries are
loaded with ``ctypes``.  Nothing here runs at import: the CPU tests import
every module on machines without ``nvcc``.  A missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "kernel_names", "build", "library", "check"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tianshou_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points of each source: name -> {function: (restype, argtypes)}.
# Every library also exports ``ts_cuda_error_string(int) -> const char*``.
_SIGNATURES: dict[str, dict[str, tuple]] = {
    "gather_rows_cast": {
        # (storage, idx, out, R, F, B, route, grid, warps, chunk, stages,
        #  smem_bytes, device, stream) -> cudaError_t
        "ts_gather_rows_cast": (_INT, [_P, _P, _P, *[_I64] * 10, _P]),
    },
    "segtree": {
        # (tree, cap, u, B, slots, row_len, env, pos, p, device, stream)
        #  -> cudaError_t
        "ts_segtree_draw": (_INT, [_P, _I64, _P, *[_I64] * 3, _P, _P, _P, _I64, _P]),
        # (tree, cap, rows, idx, row_stride, values, value_step, B, device,
        #  stream) -> cudaError_t
        "ts_segtree_update": (_INT, [_P, _I64, _P, _P, _I64, _P, _I64, _I64, _I64, _P]),
    },
}


def kernel_names() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME); the port's CUDA "
        "kernels are built from csrc/ with it at first use"
    )


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> float:
    """Build the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Each compiles into a
    temporary file that is renamed into place on success, so a cut build
    leaves no library behind.  Returns the wall seconds taken."""
    t0 = time.perf_counter()
    todo = [n for n in (names or kernel_names()) if not _target(n).is_file()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, Path(tmp)))
    errors = []
    for name, proc, tmp in jobs:
        out, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, _target(name))
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{out}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``restype`` and ``argtypes`` set on each C entry point."""
    build([name])
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    lib.ts_cuda_error_string.restype = ctypes.c_char_p
    lib.ts_cuda_error_string.argtypes = [_INT]
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.ts_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
