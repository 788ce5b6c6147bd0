"""ctypes bindings for the native C++ environment pool (port of
``tianshou_tpu/envs/cpp_pool.py``).

Batched env dynamics compiled for the host, stepped by a persistent thread
pool inside the library, with no Python work per env step.
:class:`CppVectorEnv` has :class:`~tianshou_tpu_torch.envs.host.HostVectorEnv`'s
surface, so :class:`~tianshou_tpu_torch.collect.host_collector.HostCollector`
and the trainers drive it unchanged.

The library is compiled from the repository's ``native/cpp_envpool.cpp``
with ``g++ -O3 -std=c++17 -shared -fPIC -pthread`` at first use, into
``build/tianshou_tpu_torch/`` at the repository root, named after a hash of
the source and flags, so that an edited source is rebuilt.  The port never
loads or rewrites ``native/libtpuenvpool.so``: that binary belongs to the
JAX package and was built on another host.  Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from tianshou_tpu_torch.envs.host import HostStepResult
from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = ["CppVectorEnv", "build_native_lib", "NATIVE_SOURCE", "BUILD_DIR"]

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SOURCE = _ROOT / "native" / "cpp_envpool.cpp"
BUILD_DIR = _ROOT / "build" / "tianshou_tpu_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_SPACES = {
    "CartPole-v1": (Box(low=-np.inf, high=np.inf, shape=(4,)), Discrete(2)),
    "Pendulum-v1": (
        Box(low=(-1.0, -1.0, -8.0), high=(1.0, 1.0, 8.0), shape=(3,)),
        Box(low=-2.0, high=2.0, shape=(1,)),
    ),
    "MountainCar-v0": (Box(low=(-1.2, -0.07), high=(0.6, 0.07), shape=(2,)), Discrete(3)),
    "Acrobot-v1": (
        Box(
            low=(-1.0, -1.0, -1.0, -1.0, -4 * np.pi, -9 * np.pi),
            high=(1.0, 1.0, 1.0, 1.0, 4 * np.pi, 9 * np.pi),
            shape=(6,),
        ),
        Discrete(3),
    ),
    # a 2-link planar reacher (RK4 x 4 substeps of the manipulator's
    # dynamics a control step; see native/cpp_envpool.cpp)
    "Reacher2": (Box(low=-np.inf, high=np.inf, shape=(10,)), Box(low=-1.0, high=1.0, shape=(2,))),
}


def _target() -> Path:
    h = hashlib.sha256(NATIVE_SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtpuenvpool_{h.hexdigest()[:16]}.so"


def build_native_lib() -> Path:
    """The pool's shared library, compiled first if it is not built yet.
    The compiler writes a temporary file that is renamed into place, so a
    cut build leaves no library behind and concurrent builds are safe."""
    target = _target()
    if target.is_file():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(NATIVE_SOURCE)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {NATIVE_SOURCE} (exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_lib()))
    lib.envpool_create.restype = ctypes.c_void_p
    lib.envpool_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_int]
    lib.envpool_destroy.restype = None
    lib.envpool_destroy.argtypes = [ctypes.c_void_p]
    for f in (lib.envpool_obs_dim, lib.envpool_discrete, lib.envpool_act_dim):
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p]
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.envpool_reset.restype = None
    lib.envpool_reset.argtypes = [ctypes.c_void_p, fp]
    lib.envpool_step.restype = None
    lib.envpool_step.argtypes = [ctypes.c_void_p, fp, fp, fp, u8, u8, fp]
    return lib


class CppVectorEnv:
    """The native batched env pool, with :class:`HostVectorEnv`'s surface.
    Env ``i`` draws from its own SplitMix64 stream seeded from ``seed``."""

    is_host_env = True

    def __init__(self, task: str, num_envs: int, seed: int = 0, num_threads: int = 0):
        if task not in _SPACES:
            raise KeyError(f"native pool supports {sorted(_SPACES)}, got {task}")
        self.task = task
        self.num_envs = num_envs
        self.observation_space, self.action_space = _SPACES[task]
        self._lib = _load()
        self._pool = self._lib.envpool_create(task.encode(), num_envs, seed, num_threads)
        if not self._pool:
            raise RuntimeError(f"envpool_create failed for {task} x {num_envs}")
        self._act_dim = self._lib.envpool_act_dim(self._pool)
        d = self._lib.envpool_obs_dim(self._pool)
        self._obs = np.empty((num_envs, d), np.float32)
        self._carry = np.empty((num_envs, d), np.float32)
        self._rew = np.empty((num_envs,), np.float32)
        self._term = np.empty((num_envs,), np.uint8)
        self._trunc = np.empty((num_envs,), np.uint8)

    def reset(self, seed: int | None = None) -> np.ndarray:
        """Every env's reset observation.  The seed is fixed at
        construction; ``seed`` is accepted for the host-env surface and
        ignored, as in the JAX package."""
        self._lib.envpool_reset(self._pool, self._obs)
        return self._obs.copy()

    def step(self, actions: np.ndarray) -> tuple[HostStepResult, np.ndarray]:
        """Step every env (auto-reset): ``(the true transition, carry obs)``."""
        acts = np.ascontiguousarray(np.asarray(actions, np.float32).reshape(-1))
        if acts.size != self.num_envs * max(1, self._act_dim):
            raise ValueError(f"{self.task}: {acts.size} action values for {self.num_envs} envs")
        self._lib.envpool_step(self._pool, acts, self._obs, self._rew, self._term, self._trunc, self._carry)
        return (
            HostStepResult(self._obs.copy(), self._rew.copy(), self._term.astype(bool), self._trunc.astype(bool)),
            self._carry.copy(),
        )

    def close(self) -> None:
        if self._pool:
            self._lib.envpool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        if getattr(self, "_pool", None):
            self.close()
