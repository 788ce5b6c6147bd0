#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``tianshou_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel under ``tianshou_tpu_torch/csrc`` with ``nvcc``;
3. kernels: each kernel against its plain PyTorch version on the card
   (bitwise) at the shapes its paths give it, then timed beside the plain
   version, the PyTorch library call and the least time the card could take
   (its bound);
4. reference: small slices run on the card and on the CPU from the same
   parameters and env phases (the pixel path, and the pixel path with the
   deduplicated frame-stack buffer): identical actions and replay storage,
   the same bf16 presample (through the kernel on the card), the same
   update losses.  Then, in float32 with TF32 off: 3 SAC and 3 TD3 updates
   from the same parameters, batch and injected noise (losses and
   parameters within rtol 1e-4 / atol 1e-5), a 20-step on-device Pendulum
   segment (storage within atol 1e-5: the card's sin/cos may differ from
   the CPU's in the last bit), and the host path's packed transfer
   (``TreePacker``) bitwise, including three copies queued behind a busy
   stream, which would show a pinned buffer overwritten under a copy.
   Then the on-policy slice, in float32 with TF32 off: GAE on a [256, 8]
   rollout; a PPO rollout processed with ``ret_norm`` (critic values, GAE,
   the running return statistics) and 3 minibatch updates of it with value
   clipping; one TRPO learn (conjugate gradient, line search, 5 critic
   steps); all within rtol 1e-4 / atol 1e-5 of the CPU's.  Then one TRPO
   learn at the ``trpo_pendulum`` widths on observations at Pendulum's own
   scale, unscaled: in float64 the card's within rtol 1e-7 / atol 1e-9 of
   the CPU's, and in float32 the card's and the CPU's actor steps each
   within ``TRPO_FLOAT32_STEP_LIMIT`` (relative) of the CPU's float64 step.
   Then prioritized replay and the distributional family, in float32 with
   TF32 off, within rtol 1e-4 / atol 1e-5 of the CPU (indices exact): the
   sum tree at ``rainbow_per``'s 20,000 slots (update, and the descent on
   the same draws), PER weights in both modes, and one update each of DQN
   on a PER buffer (the tree after the write-back included), C51, Rainbow
   (the same noise), QRDQN, IQN (the same fractions) and FQF (both of its
   parameter sets);
5. paths, each at full width: 2 warm-up and 5 timed supersteps, one more
   superstep in which a host synchronisation raises, one under the profiler
   (device kernels and busy time), where the time of a superstep goes,
   then the trainer's ``run()`` for one epoch of two supersteps with a test
   phase, the launch counts read over exactly that run.  The paths
   (``PATHS``):
   - ``atari``: SyntheticPixelEnv 84x84x4, NatureCNN in bf16, 128 envs x
     16 steps, batch 512, 26 updates a superstep, 2 ``gather_rows_cast``
     launches each;
   - ``atari_dedup``: the same with 4 frames a stack, channel-first, in a
     ``ReplayBuffer(stack_num=4, save_only_last_obs=True,
     ignore_obs_next=True)`` that stores each frame once; still exactly 2
     launches a superstep (one per stacked key);
   - ``cartpole``: the CartPole headline, QNet (128, 128, 128) in float32,
     1024 envs x 64 steps, batch 1024, 410 updates a superstep;
   - ``minatar``: MinAtar Breakout, the MinAtar CNN in bf16, 256 envs x 32
     steps, batch 512, 102 updates a superstep;
   - ``sac_pendulum``: the JAX package's SAC threshold configuration on the
     on-device Pendulum: 10 envs x 10 steps, 12 updates of batch 256 a
     superstep, GaussianActor and twin critics (128, 128), automatic alpha,
     a 2000-slot ring per env, 1000 warm-up steps in ``run()``;
   - ``td3_pendulum``: the same with TD3 (DeterministicActor (128, 128),
     exploration noise 0.1, policy noise 0.2, noise clip 0.5, delay 2);
   - ``sac_host``: the host-env path at the widths of the JAX ``bench.py``
     host stage (SAC HalfCheetah): 8 ``HostVectorEnv`` envs x 8 steps, 64
     updates of batch 256 a segment, GaussianActor and twin critics
     (256, 256), fixed alpha, a 5000-slot ring per env, 2000 warm-up steps.
     The envs are a numpy stand-in with HalfCheetah-v4's spaces
     (``HalfCheetahStandIn``: the card's machine has no MuJoCo), whose step
     costs microseconds: host-path times understate the env's share.  Its
     sync guard covers the device part of a segment (unpack,
     ``add_trajectory`` and the updates), in which with the upload PyTorch
     must dispatch exactly one host-to-device copy, the packed segment;
     segments are also timed with ``pipeline_host_updates`` on, in turns
     with it off;
   - ``ppo_cartpole``: the JAX package's PPO CartPole test configuration on
     the on-device CartPole: 16 envs x 128 steps, QNet and ValueNet
     (64, 64), 10 passes of 8 minibatches of 256 (80 updates) a superstep,
     lr 3e-4, GAE 0.95, grad norm 0.5, advantage normalisation;
   - ``trpo_pendulum``: the JAX package's TRPO Pendulum test configuration:
     16 envs x 128 steps, GaussianActor and ValueNet (64, 64), 2 learns of
     batch 2048 a superstep, max KL 0.005, backtracking 0.8, 5 critic steps,
     return and advantage normalisation;
   - ``ppo_host``: the host-env path at the MuJoCo PPO widths
     (``examples/mujoco_ppo.py``): 8 ``NormObsHostVectorEnv`` envs of
     ``HalfCheetahStandIn`` x 256 steps, GaussianActor (sigma_init -0.5)
     and ValueNet (64, 64), 10 passes of 32 minibatches of 64 (320 updates)
     a segment, a linear learning-rate decay, value coefficient 0.25, return
     normalisation and ``recompute_advantage``, 10 test envs.  Its sync
     guard and its one copy are checked as ``sac_host``'s, with the
     learning as the device part;
   - ``rainbow_per``: the JAX package's Rainbow CartPole test configuration
     on a ``PrioritizedReplayBuffer`` (alpha 0.6, beta 0.4): 10 envs x 10
     steps, 10 updates of batch 64, each sampling its own batch from the sum
     tree and writing its cross-entropy back, ``C51Net((128, 128), 51
     atoms, noisy)``, 1000 warm-up steps; its breakdown times the tree's
     descent, the sample with its gathers, one write-back and one PER add
     on their own;
   - ``qrdqn_minatar``: ``examples/dqn_minatar.py --algo qrdqn`` at its
     defaults: MinAtar Breakout, ``ConvQRDQNNet`` (200 quantiles, the MinAtar
     CNN in bf16), 32 envs x 4 steps, 32 presampled updates of batch 64, a
     3125-slot ring per env, 5000 warm-up steps.

It then prints a ``paths`` JSON line, the ``kernels`` JSON line and, last,
the ``ok`` JSON line.  Without CUDA, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

H100_BYTES_PER_S = 3.35e12  # HBM3 of an H100 SXM
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores

# per path: envs, steps a segment, batch, updates a superstep, ring capacity
PATHS = {
    "atari": dict(num_envs=128, segment=16, batch=512, updates=26, capacity=64),
    "atari_dedup": dict(num_envs=128, segment=16, batch=512, updates=26, capacity=64),
    "cartpole": dict(num_envs=1024, segment=64, batch=1024, updates=410, capacity=64),
    "minatar": dict(num_envs=256, segment=32, batch=512, updates=102, capacity=64),
    "sac_pendulum": dict(num_envs=10, segment=10, batch=256, updates=12, capacity=2000, warmup=1000,
                         update_per_step=0.125),
    "td3_pendulum": dict(num_envs=10, segment=10, batch=256, updates=12, capacity=2000, warmup=1000,
                         update_per_step=0.125),
    "sac_host": dict(num_envs=8, segment=8, batch=256, updates=64, capacity=5000, warmup=2000),
    # on-policy: envs, steps a segment, minibatch, passes over the rollout,
    # minibatch updates (learn calls) a superstep, test envs and episodes
    "ppo_cartpole": dict(num_envs=16, segment=128, batch=256, repeat=10, updates=80, test_envs=16, episodes=10),
    "trpo_pendulum": dict(num_envs=16, segment=128, batch=2048, repeat=2, updates=2, test_envs=16, episodes=10),
    "ppo_host": dict(num_envs=8, segment=256, batch=64, repeat=10, updates=320, test_envs=10, episodes=10),
    # the distributional family: Rainbow on a prioritized ring (each update
    # samples its own batch), QRDQN at MinAtar conv width (presampled)
    "rainbow_per": dict(num_envs=10, segment=10, batch=64, updates=10, capacity=2000, warmup=1000,
                        update_per_step=0.1),
    "qrdqn_minatar": dict(num_envs=32, segment=4, batch=64, updates=32, capacity=100_000 // 32, warmup=5000,
                          update_per_step=0.25),
}
DQN_PATHS = ("atari", "atari_dedup", "cartpole", "minatar", "rainbow_per", "qrdqn_minatar")
PER_PATHS = ("rainbow_per",)
HOST_PATHS = ("sac_host", "ppo_host")
ONPOLICY_PATHS = ("ppo_cartpole", "trpo_pendulum", "ppo_host")
# the metrics each family's superstep (segment) and run() must report, finite
FAMILY_METRICS = {"dqn": ("loss",), "continuous": ("critic_loss", "actor_loss"),
                  "ppo": ("loss", "policy_loss", "value_loss"), "trpo": ("value_loss", "accepted", "kl")}
# launches of gather_rows_cast a superstep: obs and obs_next of the presample;
# the on-policy paths use no replay buffer
KERNEL_LAUNCHES = {"atari": 2, "atari_dedup": 2, "cartpole": 0, "minatar": 0, "sac_pendulum": 0,
                   "td3_pendulum": 0, "sac_host": 0, "ppo_cartpole": 0, "trpo_pendulum": 0, "ppo_host": 0,
                   "rainbow_per": 0, "qrdqn_minatar": 0}
# the MuJoCo PPO example's learning-rate decay runs to zero over every
# minibatch update of its default run: 100 epochs x 5 segments x 10 passes x
# 32 minibatches (examples/mujoco_ppo.py)
PPO_HOST_DECAY_UPDATES = 100 * 5 * 10 * 32
# trpo_pendulum's TRPO settings (tests/test_algos_e2e.py:176-194)
TRPO_PENDULUM = dict(critic_lr=1e-3, gamma=0.95, gae_lambda=0.95, optim_critic_iters=5, max_kl=0.005,
                     backtrack_coeff=0.8)
# how far a float32 TRPO step at Pendulum's scale may sit from the float64
# step, relative to its length: 10 conjugate-gradient iterations amplify
# float32 rounding by the Fisher matrix's condition number.  About 5x the
# larger of the readings on an H100 (the card 1.09e-3, the CPU 1.48e-4;
# PERF.md)
TRPO_FLOAT32_STEP_LIMIT = 5e-3


def family(path: str) -> str:
    if path in DQN_PATHS:
        return "dqn"
    return path.split("_")[0] if path in ONPOLICY_PATHS else "continuous"


def log(msg: str) -> None:
    print(msg, flush=True)


class HalfCheetahStandIn:
    """A numpy env with HalfCheetah-v4's spaces, for the host path on a
    machine without MuJoCo: float64 observations in ``Box(-inf, inf,
    (17,))``, actions in ``Box(-1, 1, (6,))``, never terminated, truncated
    at 1000 steps.  ``reset(seed)`` draws its dynamics (a tanh of a random
    linear map plus noise) and its reward weights; the reward is a
    projection of the state minus HalfCheetah's control cost ``0.1 *
    |a|^2``.  A step costs microseconds, far less than MuJoCo's."""

    OBS_DIM, ACT_DIM, MAX_STEPS = 17, 6, 1000

    def __init__(self):
        from tianshou_tpu_torch.envs.spaces import Box

        self.observation_space = Box(low=-math.inf, high=math.inf, shape=(self.OBS_DIM,))
        self.action_space = Box(low=-1.0, high=1.0, shape=(self.ACT_DIM,))
        self._draw(None)

    def _draw(self, seed):
        self._rng = np.random.default_rng(seed)
        n, m = self.OBS_DIM, self.ACT_DIM
        self._a = self._rng.normal(0.0, 0.9 / math.sqrt(n), (n, n))
        self._b = self._rng.normal(0.0, 0.5 / math.sqrt(m), (n, m))
        self._w = self._rng.normal(0.0, 1.0 / math.sqrt(n), n)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._draw(seed)
        self._t = 0
        self._x = self._rng.normal(0.0, 0.1, self.OBS_DIM)
        return self._x.copy(), {}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float64), -1.0, 1.0)
        self._x = np.tanh(self._a @ self._x + self._b @ a) + self._rng.normal(0.0, 0.01, self.OBS_DIM)
        self._t += 1
        reward = float(self._w @ self._x) - 0.1 * float(a @ a)
        return self._x.copy(), reward, False, self._t >= self.MAX_STEPS, {}

    def close(self):
        pass


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build() -> None:
    from tianshou_tpu_torch.ops import _build

    secs = _build.build()
    log(f"build: {_build.kernel_names()} in {secs:.2f} s into {_build.BUILD_DIR}")


def _time_gather(storage, idx, what: str) -> dict:
    """The kernel, its plain version and the library call on one input, and
    the bound from the rows these indices read."""
    from tianshou_tpu_torch.ops.gather import gather_rows_cast, gather_rows_cast_plain

    (rows, feat), batch = storage.shape, idx.shape[0]
    ms = time_ms(lambda: gather_rows_cast(storage, idx))
    plain_ms = time_ms(lambda: gather_rows_cast_plain(storage, idx))
    library_ms = time_ms(lambda: torch.index_select(storage, 0, idx).to(torch.bfloat16))
    unique_rows = int(torch.unique(idx).numel())
    moved = unique_rows * feat + batch * feat * 2 + batch * 8  # rows read, bf16 written, indices
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = batch * feat / H100_FP32_OPS_PER_S * 1e3  # one conversion per byte
    bound_ms = max(bytes_ms, ops_ms)
    log(f"gather_rows_cast {what} at R={rows} F={feat} B={batch} ({unique_rows} distinct rows): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select+to {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({moved / 1e9:.3f} GB at 3.35 TB/s); "
        f"{moved / (ms * 1e-3) / 1e12:.3f} TB/s achieved, {bound_ms / ms:.3f} of the bound")
    return {"shape": [rows, feat, batch], "distinct_rows": unique_rows, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def phase_kernels() -> dict:
    from tianshou_tpu_torch.ops.gather import gather_rows_cast, gather_rows_cast_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def storage_of(rows, feat, offset=0):
        flat = torch.randint(0, 256, (rows * feat + offset,), generator=gen, device=dev, dtype=torch.uint8)
        return flat[offset:].view(rows, feat)

    def random_idx(rows, batch):
        return torch.randint(0, rows, (batch,), generator=gen, device=dev)

    def stacked_idx(num_envs, capacity, batch, stack):
        """Rows of ``batch`` frame stacks: each a chain of ``stack``
        consecutive slots of one env's ring, flattened oldest first."""
        env = torch.randint(0, num_envs, (batch, 1), generator=gen, device=dev)
        pos = torch.randint(0, capacity, (batch, 1), generator=gen, device=dev)
        chain = torch.remainder(pos - torch.arange(stack - 1, -1, -1, device=dev), capacity)
        return (env * capacity + chain).reshape(-1)

    atari, dedup = PATHS["atari"], PATHS["atari_dedup"]
    ring = atari["num_envs"] * atari["capacity"]
    # (storage, idx): the slice's stored-stack shape; the deduplicated
    # layout's stacked gather of single 84x84 frames; an unaligned row
    # width; a batch that fills no round number of blocks with rows wider
    # than one block; a storage base off the 16-byte alignment
    cases = [
        (storage_of(ring, 84 * 84 * 4), random_idx(ring, atari["updates"] * atari["batch"])),
        (storage_of(ring, 84 * 84), stacked_idx(dedup["num_envs"], dedup["capacity"],
                                                dedup["updates"] * dedup["batch"], 4)),
        (storage_of(16, 13), random_idx(16, 9)),
        (storage_of(300, 4100), random_idx(300, 1001)),
        (storage_of(64, 28224, offset=3), random_idx(64, 77)),
    ]
    max_err = 0.0
    for storage, idx in cases:
        got = gather_rows_cast(storage, idx)
        torch.cuda.synchronize()
        ref = gather_rows_cast_plain(storage, idx)
        what = f"R={storage.shape[0]} F={storage.shape[1]} B={idx.shape[0]} offset={storage.storage_offset()}"
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"gather_rows_cast differs from its plain version at {what}")
        max_err = max(max_err, float((got.float() - ref.float()).abs().max()))
        log(f"kernel check gather_rows_cast {what}: bitwise equal")

    stored = _time_gather(*cases[0], "stored stacks (atari)")
    stacked = _time_gather(*cases[1], "stacked single frames (atari_dedup)")
    return {
        "name": "gather_rows_cast",
        "route": "cuda",
        "source": "tianshou_tpu_torch/csrc/gather_rows_cast.cu",
        "replaces": "tianshou_tpu/ops/pallas_gather.py:38",
        "launches": None,
        "max_abs_err": max_err,
        **{k: stored[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shapes": {"atari": stored, "atari_dedup": stacked},
    }


def continuous_algo(kind: str, obs_dim: int, act_dim: int, action_space, hidden, device, **kw):
    """SAC (``kind`` "sac", automatic alpha unless ``auto_alpha=False``) or
    TD3 with the JAX package's threshold settings."""
    from tianshou_tpu_torch.algos.ddpg import TD3
    from tianshou_tpu_torch.algos.sac import SAC
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor, GaussianActor

    critic = CriticEnsemble(obs_dim, act_dim, hidden, num_critics=2)
    if kind == "sac":
        return SAC(GaussianActor(obs_dim, hidden, act_dim, conditioned_sigma=True), critic, action_space,
                   actor_lr=1e-3, critic_lr=1e-3, gamma=0.99, tau=0.005, n_step=1, device=device, **kw)
    return TD3(DeterministicActor(obs_dim, hidden, act_dim), critic, action_space, actor_lr=1e-3, critic_lr=1e-3,
               gamma=0.99, tau=0.005, n_step=1, exploration_noise=0.1, policy_noise=0.2, noise_clip=0.5,
               update_actor_freq=2, device=device, **kw)


def build_path(path: str, device, test_envs: int = 8, pipeline: bool = False, **small):
    """A path's configuration through the port's entry points; ``small``
    overrides sizes (the card-vs-CPU reference runs a small slice)."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    cfg = {**PATHS[path], **small}
    num_envs, segment, batch, updates, capacity = (
        cfg[k] for k in ("num_envs", "segment", "batch", "updates", "capacity"))
    buffer_options = {}
    dqn = None
    if path in ("atari", "atari_dedup"):
        from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv
        from tianshou_tpu_torch.networks.conv import ConvQNet

        channels, num_actions = cfg.get("channels", 4), cfg.get("num_actions", 6)
        env = SyntheticPixelEnv(cfg.get("height", 84), cfg.get("width", 84), channels, num_actions=num_actions,
                                episode_len=cfg.get("episode_len", 512), channel_first=path == "atari_dedup")
        if path == "atari_dedup":
            buffer_options = dict(stack_num=channels, save_only_last_obs=True, ignore_obs_next=True)
        net = ConvQNet(env.observation_space.shape, num_actions, "nature",
                       encoder_kwargs={"compute_dtype": cfg.get("compute_dtype", torch.bfloat16)})
        dqn = dict(gamma=0.99, n_step=3, target_update_freq=1000)
    elif path == "cartpole":
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.common import QNet

        env = CartPole()
        net = QNet(env.observation_space.shape, (128, 128, 128), env.action_space.n)
        dqn = dict(gamma=0.9, n_step=3, target_update_freq=320)
    elif path == "minatar":
        from tianshou_tpu_torch.envs.minatar import make_minatar
        from tianshou_tpu_torch.networks.conv import ConvQNet

        env = make_minatar("breakout")
        net = ConvQNet(env.observation_space.shape, env.action_space.n, "minatar",
                       encoder_kwargs={"compute_dtype": torch.bfloat16})
        dqn = dict(gamma=0.99, n_step=3, target_update_freq=1000)
    elif path == "rainbow_per":
        # tests/test_distributional_e2e.py:109-121, the PER of tests/test_prio.py:151
        from tianshou_tpu_torch.algos.c51 import Rainbow
        from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
        from tianshou_tpu_torch.envs.classic import CartPole
        from tianshou_tpu_torch.networks.discrete import C51Net

        env = CartPole()
        algo = Rainbow(C51Net(4, (128, 128), 2, num_atoms=51, noisy=True), env.action_space,
                       num_atoms=51, v_min=0.0, v_max=200.0, gamma=0.95, n_step=3, target_update_freq=320,
                       device=device)
        buffer = PrioritizedReplayBuffer(capacity, num_envs, alpha=0.6, beta=0.4)
        test_envs = 10
    elif path == "qrdqn_minatar":
        # examples/dqn_minatar.py --algo qrdqn, its defaults
        from tianshou_tpu_torch.algos.qrdqn import QRDQN
        from tianshou_tpu_torch.envs.minatar import make_minatar
        from tianshou_tpu_torch.networks.conv import ConvQRDQNNet

        env = make_minatar("breakout")
        net = ConvQRDQNNet(env.observation_space.shape, env.action_space.n, 200, "minatar")
        algo = QRDQN(net, env.action_space, num_quantiles=200, lr=3e-4, gamma=0.99, n_step=3,
                     target_update_freq=1000, device=device)
    elif path in ("sac_pendulum", "td3_pendulum"):
        from tianshou_tpu_torch.envs.classic import Pendulum

        env = Pendulum()
        algo = continuous_algo(path[:3], 3, 1, env.action_space, cfg.get("hidden", (128, 128)), device)
        test_envs = 10
    elif path == "sac_host":
        env = HalfCheetahStandIn()
        algo = continuous_algo("sac", env.OBS_DIM, env.ACT_DIM, env.action_space, (256, 256), device,
                               auto_alpha=False)
    else:
        raise ValueError(f"unknown path {path!r}; have {sorted(PATHS)}")
    if path not in PER_PATHS:
        buffer = ReplayBuffer(capacity, num_envs, **buffer_options)
    if dqn is not None:
        algo = DQN(net, env.action_space, lr=1e-3, device=device, **dqn)
    if path in HOST_PATHS:
        from tianshou_tpu_torch.collect.host_collector import HostCollector
        from tianshou_tpu_torch.envs.host import HostVectorEnv

        train = HostCollector(algo, HostVectorEnv([HalfCheetahStandIn] * num_envs), buffer, device=device)
        test = HostCollector(algo, HostVectorEnv([HalfCheetahStandIn] * 2), device=device)
        episodes = 1
    else:
        train = Collector(algo, VectorEnv(env, num_envs, device=device), buffer, device=device)
        test = Collector(algo, VectorEnv(env, test_envs, device=device), device=device)
        episodes = test_envs
    steps = num_envs * segment
    trainer = OffPolicyTrainer(
        algo, train, test, buffer, max_epoch=1, step_per_epoch=2 * steps, step_per_collect=steps,
        update_per_step=cfg.get("update_per_step", updates / steps), batch_size=batch, episode_per_test=episodes, device=device,
        # the DQN family explores with epsilon 0.1 (Rainbow through its
        # weight noise, ignoring it); TD3 takes its default, its own
        # exploration noise (SAC samples and ignores it)
        train_param_fn=(lambda epoch, step: 0.1) if path in DQN_PATHS else None,
        warmup_steps=cfg.get("warmup", 0), pipeline_host_updates=pipeline,
    )
    if (trainer.segment_len, trainer.updates_per_segment) != (segment, updates):
        raise AssertionError(f"trainer split {trainer.segment_len} steps / {trainer.updates_per_segment} updates")
    return env, algo, train, buffer, trainer


def init_states(algo, collector, buffer, seed=0):
    from tianshou_tpu_torch.utils.device import fork_generator, make_generator

    gen = make_generator(seed, collector.device)
    cstate = collector.reset(fork_generator(gen))
    ts = algo.init(fork_generator(gen))
    bstate = None if buffer is None else buffer.init(collector.example_transition(ts, cstate), device=collector.device)
    return gen, ts, cstate, bstate


def phase_reference(path: str) -> None:
    """A small slice on the card and on the CPU from the same start: the card
    must take the same greedy actions (float32, TF32 off), store the same
    ring bitwise, gather the same bf16 presample (through the kernel, whole
    stacks in one launch on the deduplicated layout), and find the same
    update losses (rtol 1e-3: cuDNN and the CPU sum the convolutions in
    different orders)."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.envs.synthetic import SyntheticPixelState
    from tianshou_tpu_torch.ops.gather import gather_rows_cast
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    small = dict(height=36, width=36, channels=2, num_actions=4, num_envs=4, segment=20,
                 batch=16, updates=3, capacity=16, compute_dtype=torch.float32, episode_len=64)
    seeds = torch.tensor([11, 222, 3333, 44444], dtype=torch.int32)
    runs = {}
    state_dict = None
    for device in ("cuda", "cpu"):
        env, algo, col, buffer, _ = build_path(path, device, **small)
        _, ts, cstate, bstate = init_states(algo, col, buffer)
        if state_dict is None:
            state_dict = {k: v.cpu() for k, v in ts.online.state_dict().items()}
        ts.online.load_state_dict(state_dict)
        ts.target.load_state_dict(state_dict)
        es = SyntheticPixelState(torch.zeros(4, dtype=torch.int32, device=device), seeds.to(device))
        cstate.env_state, cstate.obs = es, env.frame(es.t, es.seed)
        cstate, bstate, _ = rollout_segment(algo, col.venv, buffer, small["segment"], explore=False)(
            ts, cstate, bstate, 0.0)
        env_idx = torch.arange(48, device=device) % 4
        pos = (torch.arange(48, device=device) * 7) % 16
        gather_rows_cast.launches = 0
        bf16 = buffer.get(bstate, env_idx, pos, keys=("obs", "obs_next"),
                          dtypes={"obs": torch.bfloat16, "obs_next": torch.bfloat16})
        if gather_rows_cast.launches != (2 if device == "cuda" else 0):
            raise AssertionError(f"{device}: {gather_rows_cast.launches} gather_rows_cast launches for 2 keys")
        buffer.sample_with_weights = lambda st, g, b, e=env_idx, p=pos: (e, p, torch.ones(b, device=e.device))
        ts, bstate, metrics = build_update_scan(algo, buffer, small["batch"], small["updates"])(
            ts, bstate, None)
        runs[device] = (bstate, bf16, {k: float(v) for k, v in metrics.items()})
    (gb, gbf, gm), (cb, cbf, cm) = runs["cuda"], runs["cpu"]
    for k in cb.storage:
        if not torch.equal(gb.storage[k].cpu(), cb.storage[k]):
            raise AssertionError(f"{path}: replay storage {k!r} differs between the card and the CPU")
    for k in ("obs", "obs_next"):
        if not torch.equal(gbf[k].cpu().view(torch.int16), cbf[k].view(torch.int16)):
            raise AssertionError(f"{path}: bf16 presample of {k!r} differs between the card and the CPU")
    for k in cm:
        if not math.isclose(gm[k], cm[k], rel_tol=1e-3):
            raise AssertionError(f"{path}: {k}: card {gm[k]} vs CPU {cm[k]}")
    log(f"reference {path}: card equals CPU on actions, replay storage and bf16 presample "
        f"{tuple(gbf['obs'].shape)}; losses card {gm['loss']:.6f} CPU {cm['loss']:.6f}")


def _assert_close(what: str, got, ref, rtol=1e-4, atol=1e-5) -> float:
    """Raise unless ``got`` (on the card) is within the tolerance of
    ``ref`` (on the CPU); returns the largest absolute difference."""
    got = got.detach().cpu()
    ref = ref.detach().cpu()
    if got.shape != ref.shape or not torch.allclose(got, ref, rtol=rtol, atol=atol):
        diff = float((got.float() - ref.float()).abs().max()) if got.shape == ref.shape else math.nan
        raise AssertionError(f"{what}: card and CPU differ beyond rtol {rtol} / atol {atol} (largest difference "
                             f"{diff:.3e})")
    return float((got - ref).abs().max()) if got.numel() else 0.0


def phase_reference_continuous() -> None:
    """The continuous slice on the card against the CPU (float32, TF32
    off): 3 SAC and 3 TD3 updates from the same parameters, batch and
    noise; a 20-step greedy Pendulum segment; the packed host transfer."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.classic import Pendulum, PendulumState
    from tianshou_tpu_torch.envs.spaces import Box
    from tianshou_tpu_torch.utils.transfer import TreePacker

    obs_dim, act_dim, hidden, batch = 3, 1, (32, 32), 16
    box = Box(low=-2.0, high=2.0, shape=(act_dim,))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        a = dict(env_idx=rng.integers(0, 2, batch), pos=rng.integers(0, 8, batch),
                 weight=rng.uniform(0.5, 1.5, batch).astype(np.float32),
                 obs=rng.normal(size=(batch, obs_dim)).astype(np.float32),
                 act=rng.uniform(-1, 1, (batch, act_dim)).astype(np.float32),
                 rew=rng.normal(size=(batch, 1)).astype(np.float32),
                 done=(rng.random((batch, 1)) < 0.2).astype(np.int32),
                 obs_next=rng.normal(size=(batch, obs_dim)).astype(np.float32),
                 terminated=rng.random(batch) < 0.3,
                 noise=rng.normal(size=(2, batch, act_dim)).astype(np.float32))
        batches.append(a)
    for kind in ("sac", "td3"):
        runs = {}
        for device in ("cuda", "cpu"):
            algo = continuous_algo(kind, obs_dim, act_dim, box, hidden, device)
            ts = algo.init(torch.Generator(device=device).manual_seed(0))
            if device == "cuda":
                init = {k: {n: v.detach().cpu() for n, v in getattr(ts, k).state_dict().items()}
                        for k in ("actor", "critic", "target_actor", "target_critic") if getattr(ts, k) is not None}
            for k, sd in init.items():
                getattr(ts, k).load_state_dict(sd)
            losses = []
            for b in batches:
                t = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
                sampled = (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]), t["rew"],
                           t["done"], Batch(obs_next=t["obs_next"], terminated=t["terminated"]))
                noise = (t["noise"][0], t["noise"][1]) if kind == "sac" else t["noise"][0]
                ts, _, m = algo.update_sampled(ts, None, None, sampled, noise=noise)
                losses.append(torch.stack([m["critic_loss"], m["actor_loss"]]))
            runs[device] = (ts, torch.stack(losses))
        (gts, gl), (cts, cl) = runs["cuda"], runs["cpu"]
        err = _assert_close(f"{kind} losses", gl, cl)
        for k in ("actor", "critic", "target_actor", "target_critic"):
            if getattr(gts, k) is None:
                continue
            for n, v in getattr(gts, k).state_dict().items():
                err = max(err, _assert_close(f"{kind} {k}.{n}", v, getattr(cts, k).state_dict()[n]))
        if kind == "sac":
            err = max(err, _assert_close("sac log_alpha", gts.log_alpha, cts.log_alpha))
        log(f"reference {kind}: 3 updates on the card equal the CPU's within rtol 1e-4 / atol 1e-5 "
            f"(largest difference {err:.3e}); critic losses card {gl[:, 0].tolist()} CPU {cl[:, 0].tolist()}")

    # a 20-step greedy SAC segment of the on-device Pendulum from the same
    # start states and parameters
    start = rng.uniform(-3.0, 3.0, (2, 4)).astype(np.float32)
    storage, sd = {}, None
    for device in ("cuda", "cpu"):
        _, algo, col, buffer, _ = build_path("sac_pendulum", device, num_envs=4, capacity=32, hidden=hidden,
                                             updates=5)
        _, ts, cstate, bstate = init_states(algo, col, buffer)
        sd = sd or {n: v.detach().cpu() for n, v in ts.actor.state_dict().items()}
        ts.actor.load_state_dict(sd)
        st = PendulumState(torch.from_numpy(start[0]).to(device), torch.from_numpy(start[1]).to(device),
                           torch.zeros(4, dtype=torch.int32, device=device))
        cstate.env_state, cstate.obs = st, Pendulum._obs(st)
        cstate, bstate, _ = rollout_segment(algo, col.venv, buffer, 20, explore=False)(ts, cstate, bstate, 0.0)
        storage[device] = bstate.storage
    err = max(_assert_close(f"pendulum storage {k}", storage["cuda"][k].float(), storage["cpu"][k].float(),
                            rtol=0, atol=1e-5) for k in storage["cpu"])
    log(f"reference sac_pendulum: a 20-step greedy segment stores the same ring on the card and the CPU "
        f"(largest difference {err:.3e}, atol 1e-5)")

    # the packed host transfer: bitwise, and three copies queued behind a
    # busy stream (the third reuses the first pinned buffer, so its pack
    # must wait for the first copy to have read it)
    def tree(seed):
        r = np.random.default_rng(seed)
        return {"obs": r.normal(size=(8, 8, 17)), "rew": r.normal(size=(8, 8)).astype(np.float32),
                "terminated": r.random((8, 8)) < 0.1, "truncated": r.random((8, 8)) < 0.1,
                "obs_next": r.normal(size=(8, 8, 17))}

    trees = [tree(i) for i in range(3)]
    packer = TreePacker(trees[0], "cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of a busy stream ahead of the copies
    flats = [packer.to_device(t) for t in trees]
    for i, (t, flat) in enumerate(zip(trees, flats)):
        got = packer.unpack(flat)
        ref = TreePacker(t, "cpu").unpack(torch.from_numpy(packer.pack(t)))
        for k in t:
            if not torch.equal(got[k].cpu(), ref[k]):
                raise AssertionError(f"TreePacker: copy {i} leaf {k!r} differs on the card")
    log(f"reference TreePacker: 3 packed copies of {packer.total} floats, queued behind a busy stream, "
        "arrive bitwise equal")


def _fresh_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _read(metrics: dict) -> dict[str, float]:
    """Device metrics on the host, in one synchronising copy."""
    return dict(zip(metrics, torch.stack([v.float() for v in metrics.values()]).tolist()))


def _check_metrics(path: str, metrics: dict[str, float]) -> None:
    missing = [k for k in FAMILY_METRICS[family(path)] if k not in metrics]
    if missing or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{path}: metrics {metrics}, missing {missing}")


def timed(step, n: int, warmup: int = 2) -> tuple[float, dict[str, float]]:
    """``warmup`` calls of ``step`` (which returns device metrics), then
    ``n`` timed ones closed by reading the last metrics: ``(seconds,
    metrics)``."""
    for _ in range(warmup):
        metrics = step()
    _read(metrics)
    t0 = time.perf_counter()
    for _ in range(n):
        metrics = step()
    metrics = _read(metrics)
    return time.perf_counter() - t0, metrics


def sync_guarded(fn) -> None:
    """``fn()`` with every host synchronisation PyTorch knows of made an
    error."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def breakdown(parts: dict, reps: int = 3) -> dict[str, float]:
    """The parts of a superstep (segment) run in turn, each alone between
    two synchronisations, ``reps`` times: each part's median ms."""
    times = {k: [] for k in parts}
    for _ in range(reps):
        for k, fn in parts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: sorted(v)[reps // 2] * 1e3 for k, v in times.items()}


def superstep_of(trainer, state: list, generator):
    """The trainer's superstep over ``state`` (``[ts, cstate, bstate]``,
    updated in place; ``bstate`` is None on the on-policy paths): ``step()
    -> device metrics``."""
    fn = trainer._build_superstep()

    def step():
        if state[2] is None:
            state[0], state[1], _, metrics = fn(state[0], state[1], generator)
        else:
            state[0], state[1], state[2], _, metrics = fn(*state, generator, 0.1)
        return metrics

    return step


def phase_superstep(path: str, gather) -> dict:
    """An on-device path at full width: 2 warm-up and 5 timed supersteps,
    one under the sync guard, one under the profiler (device kernels and
    busy time), and the breakdown: the rollout, then the presample and the
    updates (off-policy) or one processing pass and the learning (on-policy:
    every processing pass and the minibatch updates)."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.data.tree import tree_leaves, tree_map
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    cfg = PATHS[path]
    _fresh_memory()
    env, algo, col, buffer, trainer = build(path)
    gen, *state = init_states(algo, col, buffer)
    step = superstep_of(trainer, state, gen)
    n, steps = 5, cfg["num_envs"] * cfg["segment"]
    gather.launches = 0
    dt, metrics = timed(step, n)
    launches = gather.launches
    if launches != KERNEL_LAUNCHES[path] * (n + 2):
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times in {n + 2} supersteps, "
                             f"not {KERNEL_LAUNCHES[path] * (n + 2)}")
    _check_metrics(path, metrics)
    # the superstep keeps everything on the device: an operation in it that
    # PyTorch knows to synchronise the host with the card raises
    sync_guarded(step)
    check_policy(path, algo, state[0], state[1].obs, gen, env)
    peak = torch.cuda.max_memory_allocated() / 2**30
    kernels, busy_ms = _profile_counts(step)
    result = {"env_steps_per_s": n * steps / dt, "ms_per_superstep": dt / n * 1e3, **metrics,
              "updates_per_superstep": cfg["updates"], "gather_rows_cast_per_superstep": launches / (n + 2),
              "device_kernels_per_superstep": kernels, "device_busy_ms_per_superstep_profiled": busy_ms,
              "max_memory_allocated_gib": peak}
    if buffer is not None:
        result["ring_gb"] = sum(x.numel() * x.element_size() for x in tree_leaves(state[2].storage)) / 1e9
    log(f"{path}: {n} supersteps of {cfg['num_envs']} envs x {cfg['segment']} steps + {cfg['updates']} updates of "
        f"batch {cfg['batch']}: {result['env_steps_per_s']:.1f} env-steps/s, {result['ms_per_superstep']:.2f} ms "
        f"per superstep, metrics {metrics}, gather_rows_cast launches {launches} in {n + 2}, max_memory_allocated "
        f"{peak:.3f} GiB; a superstep under torch.cuda.set_sync_debug_mode('error') raised no host sync; "
        f"profiled superstep: {kernels} device kernels, device busy {busy_ms:.2f} ms")

    # where a superstep's time goes: its parts timed alone
    if buffer is None:
        seg = rollout_segment(algo, col.venv, None, cfg["segment"], explore=True, record_traj=True)
        learn = trainer._build_learn()
        held = {}

        def rollout():
            state[1], _, outputs = seg(state[0], state[1], None, 0.0)
            held["traj"] = outputs["traj"]

        def learning():
            state[0], _ = learn(state[0], held["traj"], gen)

        parts = {"rollout": rollout, "processing pass": lambda: algo.process_rollout(state[0], held["traj"]),
                 "learn incl. processing": learning}
        result["processing_passes_per_superstep"] = _processing_passes(algo, cfg["repeat"])
    else:
        seg = rollout_segment(algo, col.venv, buffer, cfg["segment"], explore=True)
        updates_fn = build_update_scan(algo, buffer, cfg["batch"], cfg["updates"])

        def rollout():
            state[1], state[2], _ = seg(state[0], state[1], state[2], 0.1)

        def updates():
            state[0], state[2], _ = updates_fn(state[0], state[2], gen)

        if path in PER_PATHS:
            # each update samples its own batch: the sum-tree descent and
            # weights alone, with the gathers, the write-back of one update
            # and the PER add of one rollout step, each on its own
            held = {"sampled": algo.presample(buffer, state[2], gen, cfg["batch"]),
                    "step": tree_map(lambda x: x[:, 0], state[2].storage)}

            def write_back():
                env_idx, pos, weight = held["sampled"][:3]
                state[2] = buffer.update_priorities(state[2], env_idx, pos, weight)

            parts = {"rollout": rollout,
                     "per sample_with_weights": lambda: buffer.sample_with_weights(state[2], gen, cfg["batch"]),
                     "per sample incl. gathers": lambda: algo.presample(buffer, state[2], gen, cfg["batch"]),
                     "per write-back": write_back,
                     "per add (one rollout step)": lambda: buffer.add(state[2], held["step"]),
                     "updates incl. sampling": updates}
        else:
            parts = {"rollout": rollout,
                     "presample": lambda: algo.presample(buffer, state[2], gen, cfg["updates"] * cfg["batch"]),
                     "updates incl. presample": updates}
    result["breakdown_ms"] = breakdown(parts)
    log(f"{path} breakdown (median of 3, ms): " + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))
    if path in PER_PATHS:
        # device kernels and busy time of each PER operation, profiled alone
        result["per_kernels_busy_ms"] = {k: _profile_counts(parts[k]) for k in parts if k.startswith("per ")}
        log(f"{path} PER operations profiled alone (device kernels, busy ms): " + ", ".join(
            f"{k} {n} / {b:.3f}" for k, (n, b) in result["per_kernels_busy_ms"].items()))
    return result


def check_policy(path: str, algo, ts, obs, gen, env) -> None:
    """The trained policy's outputs on the last observations: finite
    Q-values of the right shape (DQN); finite greedy actions of the action
    space's shape, in [-1, 1] for the off-policy continuous actors and legal
    for a discrete space."""
    space = env.action_space
    with torch.no_grad():
        out = algo.q_values(ts.online, obs) if path in DQN_PATHS else algo.act(ts, obs, gen, explore=False)
    shape = (obs.shape[0],) + ((space.n,) if path in DQN_PATHS else tuple(getattr(space, "shape", ()) or ()))
    if tuple(out.shape) != shape or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"{path}: bad policy output: {tuple(out.shape)}, expected {shape}")
    if family(path) == "continuous" and float(out.abs().max()) > 1.0:
        raise AssertionError(f"{path}: actions outside [-1, 1]")
    if not out.is_floating_point() and not bool(((out >= 0) & (out < space.n)).all()):
        raise AssertionError(f"{path}: illegal discrete actions")


class _OffPolicyHost:
    """A segment of ``sac_host`` in its parts, through the trainer's host
    loop: :meth:`collect` on the host envs, :meth:`upload` (the one packed
    copy), :meth:`device` (unpack, ``add_trajectory`` and the updates)."""

    def __init__(self, trainer):
        self.loop, _ = trainer._host_setup()

    @property
    def ts(self):
        return self.loop.ts

    @property
    def generator(self):
        return self.loop.generator

    def collect(self):
        return self.loop.collect(0.0)[1]

    def upload(self, traj):
        return self.loop.host_step.upload(traj)

    def device(self, uploaded):
        lp = self.loop
        lp.ts, lp.bstate, lp.metrics = lp.host_step.device(lp.ts, lp.bstate, uploaded, lp.generator)
        lp.ts_act = lp.ts
        return lp.metrics


class _OnPolicyHost:
    """A segment of ``ppo_host`` in the same parts: :meth:`device` unpacks
    and learns (every processing pass and the minibatch updates)."""

    def __init__(self, trainer):
        self.ts, self.generator, self._g_collect = trainer._host_setup()
        self._learn = trainer._build_learn()
        self._col, self._segment = trainer.train_collector, trainer.segment_len

    def collect(self):
        return self._col.collect(self.ts, None, self._segment, self._g_collect, explore=True, record_traj=True)[2]

    def upload(self, traj):
        return self._col.upload(traj)

    def device(self, uploaded):
        self.ts, metrics = self._learn(self.ts, self._col.unpack(uploaded), self.generator)
        return metrics


def phase_host(path: str, gather) -> dict:
    """A host-env path at full width: 2 warm-up and 5 timed segments
    (collect on the host envs, one packed copy, the device part), the device
    part of one more under the sync guard, one in which PyTorch must
    dispatch exactly one host-to-device copy (the packed segment), one under
    the profiler, the breakdown, and for ``sac_host`` segments with
    ``pipeline_host_updates`` on and off in turns."""
    from tianshou_tpu_torch.data.tree import tree_leaves
    from tianshou_tpu_torch.utils.transfer import TreePacker

    cfg = PATHS[path]
    onpolicy = path in ONPOLICY_PATHS
    _fresh_memory()
    env, algo, col, _, trainer = build(path)
    hp = (_OnPolicyHost if onpolicy else _OffPolicyHost)(trainer)
    n, steps = 5, cfg["num_envs"] * cfg["segment"]
    gather.launches = 0
    copies = TreePacker.copies
    dt, metrics = timed(lambda: hp.device(hp.upload(hp.collect())), n)
    copies = TreePacker.copies - copies
    if gather.launches != 0 or copies != n + 2:
        raise AssertionError(f"{path}: {copies} packed copies and {gather.launches} gather launches in {n + 2} "
                             "segments")
    _check_metrics(path, metrics)

    # the device part of a segment makes no host synchronisation
    uploaded = hp.upload(hp.collect())
    sync_guarded(lambda: hp.device(uploaded))

    # exactly one host-to-device copy in a segment's upload and device part:
    # every tensor copy from the host that PyTorch dispatches is counted (the
    # profiler's device trace loses this copy's record in a long process,
    # while its runtime call is always traced)
    traj = hp.collect()
    floats = sum(np.size(x) for x in tree_leaves(traj) if isinstance(x, np.ndarray))
    with _HostToDeviceCopies() as h2d:
        hp.device(hp.upload(traj))
    if h2d.copies != [(floats,)]:
        raise AssertionError(f"{path}: host-to-device copies in a segment, not one of {floats} floats: "
                             f"{h2d.copies}")
    traj = hp.collect()
    kernels, busy_ms = _profile_counts(lambda: hp.device(hp.upload(traj)))
    check_policy(path, algo, hp.ts, torch.as_tensor(col.obs, device=algo.device), hp.generator, env)
    peak = torch.cuda.max_memory_allocated() / 2**30

    held = {}

    def collect():
        held["traj"] = hp.collect()

    def upload():
        held["up"] = hp.upload(held["traj"])

    parts = {"host collect": collect, "pack + copy": upload}
    if onpolicy:
        parts["processing pass"] = lambda: algo.process_rollout(hp.ts, col.unpack(held["up"]))
    parts["device part"] = lambda: hp.device(held["up"])
    result = {"env_steps_per_s": n * steps / dt, "ms_per_segment": dt / n * 1e3, **metrics,
              "updates_per_segment": cfg["updates"], "h2d_copies_per_segment": len(h2d.copies),
              "device_kernels_per_segment": kernels, "device_busy_ms_per_segment_profiled": busy_ms,
              "max_memory_allocated_gib": peak, "breakdown_ms": breakdown(parts)}
    log(f"{path}: {n} segments of {cfg['num_envs']} host envs x {cfg['segment']} steps + {cfg['updates']} updates "
        f"of batch {cfg['batch']}: {result['env_steps_per_s']:.1f} env-steps/s, {result['ms_per_segment']:.2f} ms "
        f"per segment (stand-in env: env time understated), metrics {metrics}, {copies} packed copies in {n + 2}, "
        f"max_memory_allocated {peak:.3f} GiB; the device part under torch.cuda.set_sync_debug_mode('error') raised "
        f"no host sync; one host-to-device copy dispatched in a segment ({floats} floats); {kernels} device kernels "
        f"and device busy {busy_ms:.2f} ms in its device part")
    if onpolicy:
        result["processing_passes_per_segment"] = _processing_passes(algo, cfg["repeat"])
    log(f"{path} breakdown (median of 3, ms): " + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))
    closing = [trainer]
    if not onpolicy:
        result["pipeline_ms_per_segment"], piped_trainer = _pipeline_turns(path, hp.loop, n)
        closing.append(piped_trainer)
    for t in closing:
        t.train_collector.venv.close()
        t.test_collector.venv.close()
    return result


def _pipeline_turns(path: str, loop, n: int):
    """``pipeline_host_updates``: segments with acting on a side stream from
    a snapshot of the actor, in turns with ``loop``'s sequential ones: the
    mean ms a segment of each, and the pipelined trainer."""

    def segments(lp, k):
        for _ in range(k):
            _, traj = lp.collect(0.0)
            lp.update(traj)
        lp.read_metrics()  # synchronises

    _, _, _, _, piped_trainer = build_path(path, "cuda", pipeline=True)
    piped, _ = piped_trainer._host_setup()
    segments(piped, 2)
    turns = {"sequential": [], "pipelined": []}
    for name in ("sequential", "pipelined", "pipelined", "sequential"):
        lp = loop if name == "sequential" else piped
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        segments(lp, n)
        turns[name].append((time.perf_counter() - t0) / n * 1e3)
    means = {k: sum(v) / len(v) for k, v in turns.items()}
    log(f"{path} pipeline_host_updates (ms a segment, mean of 2 turns of {n}, order seq/pipe/pipe/seq): "
        + ", ".join(f"{k} {v:.2f} ({', '.join(f'{x:.2f}' for x in turns[k])})" for k, v in means.items()))
    return means, piped_trainer


def phase_main_path(path: str, gather) -> int:
    """The trainer's ``run()`` on the path for one epoch of two supersteps
    (segments) with a test phase; the launch count is read over exactly that
    run."""
    cfg = PATHS[path]
    trainer = build(path)[-1]
    gather.launches = 0
    info = trainer.run()
    launches = gather.launches
    log(f"{path} {type(trainer).__name__}.run(): {info}")
    if launches != KERNEL_LAUNCHES[path] * 2:
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times in run(), "
                             f"not {KERNEL_LAUNCHES[path] * 2}")
    warmup = cfg.get("warmup", 0) // cfg["num_envs"] * cfg["num_envs"]  # whole steps of every env
    env_steps = warmup + 2 * cfg["num_envs"] * cfg["segment"]
    if info.env_step != env_steps or info.gradient_step != 2 * cfg["updates"]:
        raise AssertionError(f"{path}: counters env_step={info.env_step} gradient_step={info.gradient_step}")
    _check_metrics(path, info.last_metrics)
    if not math.isfinite(info.best_reward):
        raise AssertionError(f"{path}: non-finite best reward: {info}")
    if path in HOST_PATHS:
        trainer.train_collector.venv.close()
        trainer.test_collector.venv.close()
    return launches


def build_onpolicy_path(path: str, device):
    """An on-policy path through the port's entry points: ``(env, algo,
    train collector, None, trainer)``, the shape of :func:`build_path`'s."""
    from tianshou_tpu_torch.algos.npg import TRPO
    from tianshou_tpu_torch.algos.pg import linear_schedule
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.continuous import GaussianActor, ValueNet
    from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer

    cfg = PATHS[path]
    hidden = (64, 64)
    if path == "ppo_cartpole":
        from tianshou_tpu_torch.envs.classic import CartPole

        env = CartPole()
        algo = PPO(QNet(4, hidden, 2), ValueNet(4, hidden), env.action_space, lr=3e-4, gamma=0.99, gae_lambda=0.95,
                   max_grad_norm=0.5, ent_coef=0.0, device=device)
    elif path == "trpo_pendulum":
        from tianshou_tpu_torch.envs.classic import Pendulum

        env = Pendulum()
        algo = TRPO(GaussianActor(3, hidden, 1), ValueNet(3, hidden), env.action_space, device=device, **TRPO_PENDULUM)
    elif path == "ppo_host":
        env = HalfCheetahStandIn()
        algo = PPO(GaussianActor(env.OBS_DIM, hidden, env.ACT_DIM, sigma_init=-0.5), ValueNet(env.OBS_DIM, hidden),
                   env.action_space, lr=linear_schedule(3e-4, 0.0, PPO_HOST_DECAY_UPDATES), gamma=0.99,
                   gae_lambda=0.95, eps_clip=0.2, vf_coef=0.25, ent_coef=0.0, max_grad_norm=0.5, adv_norm=False,
                   ret_norm=True, recompute_advantage=True, device=device)
    else:
        raise ValueError(f"unknown on-policy path {path!r}; have {ONPOLICY_PATHS}")
    if path in HOST_PATHS:
        from tianshou_tpu_torch.collect.host_collector import HostCollector
        from tianshou_tpu_torch.envs.host import NormObsHostVectorEnv

        train_venv = NormObsHostVectorEnv([HalfCheetahStandIn] * cfg["num_envs"])
        test_venv = NormObsHostVectorEnv([HalfCheetahStandIn] * cfg["test_envs"], update_rms=False)
        test_venv.set_rms(train_venv.get_rms())  # the test envs read the live statistics
        train = HostCollector(algo, train_venv, device=device)
        test = HostCollector(algo, test_venv, device=device)
    else:
        train = Collector(algo, VectorEnv(env, cfg["num_envs"], device=device), device=device)
        test = Collector(algo, VectorEnv(env, cfg["test_envs"], device=device), device=device)
    steps = cfg["num_envs"] * cfg["segment"]
    trainer = OnPolicyTrainer(algo, train, test, max_epoch=1, step_per_epoch=2 * steps, step_per_collect=steps,
                              repeat_per_collect=cfg["repeat"], batch_size=cfg["batch"],
                              episode_per_test=cfg["episodes"], device=device)
    if (trainer.segment_len, trainer.updates_per_segment) != (cfg["segment"], cfg["updates"]):
        raise AssertionError(f"trainer split {trainer.segment_len} steps / {trainer.updates_per_segment} updates")
    return env, algo, train, None, trainer


def build(path: str):
    """A path at full width on the card: ``(env, algo, train collector,
    buffer or None, trainer)``."""
    return build_onpolicy_path(path, "cuda") if path in ONPOLICY_PATHS else build_path(path, "cuda")


def _processing_passes(algo, repeat: int) -> int:
    """Critic + GAE passes over the rollout a superstep: the first
    processing, the return statistics' own, one a pass with
    ``recompute_advantage``."""
    return (1 + bool(getattr(algo, "ret_norm", False)) + repeat * bool(getattr(algo, "recompute_advantage", False))
            if hasattr(algo, "gae_lambda") else 1)


class _HostToDeviceCopies(TorchDispatchMode):
    """While on, records the shape of every tensor copy from the host to the
    card that PyTorch dispatches (``copy_`` into a CUDA tensor from a CPU
    one, or a ``to``/``_to_copy`` of a CPU tensor onto the card)."""

    def __init__(self):
        super().__init__()
        self.copies: list[tuple[int, ...]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.copy_.default:
            dst, src = args[0], args[1]
        elif func is torch.ops.aten._to_copy.default:
            dst, src = out, args[0]
        else:
            return out
        if src.device.type == "cpu" and dst.device.type == "cuda":
            self.copies.append(tuple(src.shape))
        return out


def _profile_counts(fn) -> tuple[int, float]:
    """``fn`` under ``torch.profiler``: device kernels and the device's busy
    milliseconds (the union of their intervals).  The window opens with
    about a second of a busy stream (``torch.cuda._sleep``'s spin kernel,
    left out of the counts) before ``fn``'s work: the profiler drops device
    activity from the start of a window, more of it the longer the process
    has run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2_000_000_000)
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return len(events), busy_us / 1e3


def phase_reference_onpolicy() -> None:
    """The on-policy slice on the card against the CPU (float32, TF32 off),
    from the same parameters and inputs: GAE on a [256, 8] rollout; a PPO
    rollout processed with ret_norm (critic values, GAE, the return
    statistics) and 3 minibatch updates of it with value clipping; one TRPO
    learn.  Within rtol 1e-4 / atol 1e-5."""
    from tianshou_tpu_torch.algos.npg import TRPO
    from tianshou_tpu_torch.algos.ppo import PPO
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.envs.spaces import Box
    from tianshou_tpu_torch.networks.continuous import GaussianActor, ValueNet
    from tianshou_tpu_torch.ops.returns import gae_advantages

    rng = np.random.default_rng(0)
    T, N = 256, 8
    arrays = dict(rew=rng.normal(size=(T, N)), val=rng.normal(size=(T, N)), val_next=rng.normal(size=(T, N)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    terminated = rng.random((T, N)) < 0.02
    done = terminated | (rng.random((T, N)) < 0.02)
    got, ref = (gae_advantages(*(torch.from_numpy(x).to(dev) for x in (*arrays.values(), terminated, done)),
                               0.99, 0.95) for dev in ("cuda", "cpu"))
    err = max(_assert_close(f"gae {name}", g, r) for name, g, r in zip(("adv", "ret"), got, ref))
    log(f"reference gae_advantages [256, 8]: card equals CPU within rtol 1e-4 / atol 1e-5 (largest difference "
        f"{err:.3e})")

    obs_dim, act_dim, hidden, B = 5, 2, (32, 32), 64
    box = Box(low=-1.0, high=1.0, shape=(act_dim,))
    traj = dict(obs=rng.normal(size=(32, 8, obs_dim)).astype(np.float32),
                act=rng.normal(size=(32, 8, act_dim)).astype(np.float32),
                rew=rng.normal(size=(32, 8)).astype(np.float32), terminated=rng.random((32, 8)) < 0.05,
                truncated=rng.random((32, 8)) < 0.05, obs_next=rng.normal(size=(32, 8, obs_dim)).astype(np.float32),
                log_prob=(rng.normal(size=(32, 8)) - 2.0).astype(np.float32))
    perm = rng.permutation(32 * 8)[: 3 * B].reshape(3, B)
    # observations small enough that the Fisher matrix is well conditioned:
    # 10 conjugate-gradient iterations amplify float32 rounding by its
    # condition number (at half this scale a float32 learn on the CPU sits
    # 1.6e-4 beyond rtol 1e-4 of a float64 one; at this scale within it)
    mb_trpo = dict(obs=rng.normal(size=(B, obs_dim)).astype(np.float32) / 8,
                   act=rng.normal(size=(B, act_dim)).astype(np.float32),
                   adv=rng.normal(size=B).astype(np.float32), ret=rng.normal(size=B).astype(np.float32),
                   logp_old=(rng.normal(size=B) - 2.0).astype(np.float32))
    for kind in ("ppo", "trpo"):
        runs, init = {}, None
        for dev in ("cuda", "cpu"):
            actor, critic = GaussianActor(obs_dim, hidden, act_dim, sigma_init=-0.5), ValueNet(obs_dim, hidden)
            if kind == "ppo":
                algo = PPO(actor, critic, box, lr=1e-3, ret_norm=True, value_clip=True, max_grad_norm=0.5, device=dev)
            else:
                algo = TRPO(actor, critic, box, critic_lr=1e-3, max_kl=0.01, device=dev)
            ts = algo.init(torch.Generator(device=dev).manual_seed(0))
            if init is None:
                init = {k: {n: v.detach().cpu() for n, v in getattr(ts, k).state_dict().items()}
                        for k in ("actor", "critic")}
            ts.actor.load_state_dict(init["actor"])
            ts.critic.load_state_dict(init["critic"])
            out = []
            if kind == "ppo":
                t = {k: torch.from_numpy(v).to(dev) for k, v in traj.items()}
                rollout = Batch(obs=t["obs"], act=t["act"], rew=t["rew"], terminated=t["terminated"],
                                truncated=t["truncated"], obs_next=t["obs_next"], policy=Batch(log_prob=t["log_prob"]))
                ts = algo.update_rollout_stats(ts, rollout)  # so that the return scale is not 1
                processed = algo.process_rollout(ts, rollout)
                out += [processed["adv"], processed["ret"], ts.ret_var]
                idx = torch.from_numpy(perm).to(dev)
                for i in range(3):
                    ts, m = algo.learn(ts, Batch({k: v[idx[i]] for k, v in processed.items()}))
                    out.append(torch.stack([m[k] for k in sorted(m)]))
            else:
                ts, m = algo.learn(ts, Batch({k: torch.from_numpy(v).to(dev) for k, v in mb_trpo.items()}))
                out.append(torch.stack([m[k] for k in sorted(m)]))
            runs[dev] = (ts, out)
        (gts, gout), (cts, cout) = runs["cuda"], runs["cpu"]
        err = max(_assert_close(f"{kind} output {i}", g, c) for i, (g, c) in enumerate(zip(gout, cout)))
        for part in ("actor", "critic"):
            for name, v in getattr(gts, part).state_dict().items():
                err = max(err, _assert_close(f"{kind} {part}.{name}", v, getattr(cts, part).state_dict()[name]))
        what = ("a rollout processed with ret_norm and 3 minibatch updates" if kind == "ppo"
                else f"one learn (accepted {float(gout[-1][0]):.0f} on both)")
        log(f"reference {kind}: {what} on the card equal the CPU's within rtol 1e-4 / atol 1e-5 (largest "
            f"difference {err:.3e})")

    # TRPO at the trpo_pendulum path's widths and settings on observations
    # at Pendulum's own scale (cos, sin and an angular velocity in [-8, 8]),
    # unscaled: in float64 the card must equal the CPU within rtol 1e-7 /
    # atol 1e-9; in float32 the card's and the CPU's natural-gradient steps
    # are read against the CPU's float64 step
    B = 2048
    theta, speed = rng.uniform(-np.pi, np.pi, B), rng.uniform(-8.0, 8.0, B)
    mb = dict(obs=np.stack([np.cos(theta), np.sin(theta), speed], 1), act=rng.normal(0.0, 1.0, (B, 1)),
              adv=rng.normal(size=B), ret=rng.normal(0.0, 3.0, B), logp_old=rng.normal(-1.5, 0.3, B))
    mb = {k: v.astype(np.float32) for k, v in mb.items()}
    runs, init = {}, None
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64),
                       ("cuda", torch.float64)):
        algo = TRPO(GaussianActor(3, (64, 64), 1, compute_dtype=dtype).to(dtype),
                    ValueNet(3, (64, 64), compute_dtype=dtype).to(dtype), Box(low=-2.0, high=2.0, shape=(1,)),
                    device=dev, **TRPO_PENDULUM)
        ts = algo.init(torch.Generator(device=dev).manual_seed(0))
        if init is None:
            init = {k: {n: v.detach().clone() for n, v in getattr(ts, k).state_dict().items()}
                    for k in ("actor", "critic")}
        ts.actor.load_state_dict(init["actor"])
        ts.critic.load_state_dict(init["critic"])
        ts, m = algo.learn(ts, Batch({k: torch.from_numpy(v).to(dev, dtype) for k, v in mb.items()}))
        runs[dev, dtype] = ({part: {n: v.detach().cpu().double() for n, v in getattr(ts, part).state_dict().items()}
                             for part in ("actor", "critic")}, {k: float(v) for k, v in m.items()})

    def step_error(key) -> float:
        """The relative distance of ``key``'s actor step from the CPU's
        float64 step."""
        (got, _), (ref, _), a0 = runs[key], runs["cpu", torch.float64], init["actor"]
        diff = sum(float(((got["actor"][n] - ref["actor"][n]) ** 2).sum()) for n in a0)
        size = sum(float(((ref["actor"][n] - a0[n].double()) ** 2).sum()) for n in a0)
        return math.sqrt(diff / size)

    accepted = {f"{dev} {str(dtype)[6:]}": m["accepted"] for (dev, dtype), (_, m) in runs.items()}
    if set(accepted.values()) != {1.0}:
        raise AssertionError(f"trpo at Pendulum's scale: accepted {accepted}")
    err = max(_assert_close(f"trpo float64 {part}.{n}", v, runs["cpu", torch.float64][0][part][n], rtol=1e-7,
                            atol=1e-9)
              for part, sd in runs["cuda", torch.float64][0].items() for n, v in sd.items())
    errors = {f"{dev} {str(dtype)[6:]}": step_error((dev, dtype)) for dev, dtype in runs if (dev, dtype) != (
        "cpu", torch.float64)}
    if max(errors.values()) > TRPO_FLOAT32_STEP_LIMIT:
        raise AssertionError(f"trpo at Pendulum's scale: steps' relative distance from the CPU's float64 step "
                             f"{errors}, limit {TRPO_FLOAT32_STEP_LIMIT}")
    log(f"reference trpo at Pendulum's scale (batch {B}, (64, 64), max KL 0.005, accepted on all four): the "
        f"float64 learn on the card equals the CPU's within rtol 1e-7 / atol 1e-9 (largest difference {err:.3e}); "
        f"the actor steps' relative distance from the CPU's float64 step: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errors.items()) + f" (limit {TRPO_FLOAT32_STEP_LIMIT} for float32)")


def phase_reference_distributional() -> None:
    """Prioritized replay and the distributional family on the card against
    the CPU (float32, TF32 off, rtol 1e-4 / atol 1e-5, indices exact): the
    sum tree at 20,000 slots (update and descent on the same ``u``); PER
    weights in both modes; one update each of DQN on a PER buffer (with the
    tree after the write-back), C51, Rainbow (the same noise), QRDQN, IQN
    (the same fractions) and FQF (the quantile net and the fraction
    proposal after the step), from the same parameters and batch."""
    from tianshou_tpu_torch.algos.c51 import C51, Rainbow
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.algos.qrdqn import FQF, IQN, QRDQN
    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
    from tianshou_tpu_torch.data.tree import tree_map
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.networks.discrete import (
        C51Net, FractionProposalNetwork, FullQuantileFunction, ImplicitQuantileNetwork, QRDQNNet, draw_noise)
    from tianshou_tpu_torch.ops.segtree import segtree_init, segtree_sample, segtree_total, segtree_update

    rng = np.random.default_rng(0)
    # the sum tree at the rainbow_per ring's 20,000 slots
    slots = PATHS["rainbow_per"]["num_envs"] * PATHS["rainbow_per"]["capacity"]
    n = min(4096, slots // 2)
    idx = rng.choice(slots, n, replace=False)
    vals = rng.random(n).astype(np.float32)
    u01 = rng.random(n).astype(np.float32)
    trees, leaves = {}, {}
    for dev in ("cuda", "cpu"):
        tree = segtree_init(slots, dev)
        segtree_update(tree, torch.from_numpy(idx).to(dev), torch.from_numpy(vals).to(dev))
        trees[dev] = tree
        leaves[dev] = segtree_sample(tree, torch.from_numpy(u01).to(dev) * segtree_total(tree))
    err = _assert_close("segtree_update tree", trees["cuda"], trees["cpu"])
    if not torch.equal(leaves["cuda"].cpu(), leaves["cpu"]):
        raise AssertionError("segtree_sample: the card and the CPU descend to different leaves")
    log(f"reference segtree at {slots} slots: {n} updated leaves give the same tree (largest difference "
        f"{err:.3e}) and {n} draws the same leaves on the card and the CPU")

    obs_dim, n_act, hidden, batch = 4, 3, (32, 32), 16
    steps = [dict(obs=rng.normal(size=(2, obs_dim)).astype(np.float32), act=rng.integers(0, n_act, 2),
                  rew=rng.normal(size=2).astype(np.float32), terminated=rng.random(2) < 0.15,
                  truncated=rng.random(2) < 0.05, obs_next=rng.normal(size=(2, obs_dim)).astype(np.float32))
             for _ in range(40)]
    td = (rng.normal(size=24) * 3).astype(np.float32)
    written = rng.choice(64, 24, replace=False)

    def per_state(dev, weight_norm=True):
        buf = PrioritizedReplayBuffer(32, 2, alpha=0.6, beta=0.4, weight_norm=weight_norm)
        bs = buf.init(Batch({k: torch.as_tensor(v[0]) for k, v in steps[0].items()}), device=dev)
        for tr in steps:
            bs = buf.add(bs, Batch({k: torch.from_numpy(v).to(dev) for k, v in tr.items()}))
        w = torch.from_numpy(written).to(dev)
        return buf, buf.update_priorities(bs, w // 32, w % 32, torch.from_numpy(td).to(dev))

    # a u whose sample names no slot twice: a duplicated slot's write-back
    # keeps one of its values, in no fixed order on the card
    buf, bs = per_state("cpu")
    for _ in range(100):
        u = torch.from_numpy(rng.random(batch).astype(np.float32))
        env_idx, pos, _ = buf.sample_at(bs, u)
        if len(set((env_idx * 32 + pos).tolist())) == batch:
            break
    for weight_norm in (True, False):
        out = {dev: per_state(dev, weight_norm) for dev in ("cuda", "cpu")}
        got = {dev: b.sample_at(st, u.to(dev)) for dev, (b, st) in out.items()}
        for name, g, c in zip(("env_idx", "pos"), got["cuda"][:2], got["cpu"][:2]):
            if not torch.equal(g.cpu(), c):
                raise AssertionError(f"PER sample: {name} differs between the card and the CPU")
        err = _assert_close(f"PER weights (weight_norm={weight_norm})", got["cuda"][2], got["cpu"][2])
        log(f"reference PER (weight_norm={weight_norm}): the same slots and weights on the card and the CPU "
            f"(largest difference {err:.3e})")

    def quantile_sample(dev):
        r = np.random.default_rng(1)
        a = dict(env_idx=r.integers(0, 2, batch), pos=r.permutation(batch), weight=r.uniform(0.5, 1.5, batch),
                 obs=r.normal(size=(batch, obs_dim)), act=r.integers(0, n_act, batch),
                 obs_next=r.normal(size=(batch, obs_dim)), terminated=r.random(batch) < 0.3,
                 returns=r.normal(size=batch) * 2, discount=r.choice([0.9, 0.81], batch))
        t = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v).to(dev) for k, v in a.items()}
        mask = 1.0 - t["terminated"].to(torch.float32)
        return (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]),
                Batch(obs_next=t["obs_next"], terminated=t["terminated"]), mask, t["returns"], t["discount"])

    def c51_sample(dev):
        r = np.random.default_rng(2)
        a = dict(env_idx=r.integers(0, 2, batch), pos=r.permutation(batch),
                 weight=r.uniform(0.5, 1.5, batch).astype(np.float32),
                 obs=r.normal(size=(batch, obs_dim)).astype(np.float32), act=r.integers(0, n_act, batch),
                 rew=(r.normal(size=(batch, 3)) * 2).astype(np.float32),
                 done=(r.random((batch, 3)) < 0.2).astype(np.int32),
                 obs_next=r.normal(size=(batch, obs_dim)).astype(np.float32), terminated=r.random(batch) < 0.3)
        t = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
        return (t["env_idx"], t["pos"], t["weight"], Batch(obs=t["obs"], act=t["act"]), t["rew"], t["done"],
                Batch(obs_next=t["obs_next"], terminated=t["terminated"]))

    kw = dict(gamma=0.9, n_step=3, lr=1e-3, target_update_freq=1)
    space = Discrete(n_act)
    makers = {
        "dqn-per": lambda dev: DQN(QNet(obs_dim, hidden, n_act), space, device=dev, **kw),
        "c51": lambda dev: C51(C51Net(obs_dim, hidden, n_act, num_atoms=11), space, num_atoms=11, v_min=-5.0,
                               v_max=5.0, device=dev, **kw),
        "rainbow": lambda dev: Rainbow(C51Net(obs_dim, hidden, n_act, num_atoms=11, noisy=True), space,
                                       num_atoms=11, v_min=-5.0, v_max=5.0, device=dev, **kw),
        "qrdqn": lambda dev: QRDQN(QRDQNNet(obs_dim, hidden, n_act, num_quantiles=16), space, num_quantiles=16,
                                   device=dev, **kw),
        "iqn": lambda dev: IQN(ImplicitQuantileNetwork(obs_dim, hidden, n_act), space, sample_size=8,
                               online_sample_size=6, target_sample_size=5, device=dev, **kw),
        "fqf": lambda dev: FQF(FullQuantileFunction(obs_dim, hidden, n_act),
                               FractionProposalNetwork(hidden[-1], 8), space, num_fractions=8, fraction_lr=1e-3,
                               device=dev, **kw),
    }
    for kind, make in makers.items():
        runs, init, extra = {}, None, {}
        for dev in ("cuda", "cpu"):
            algo = make(dev)
            ts = algo.init(torch.Generator(device=dev).manual_seed(0))
            parts = ("online", "fraction") if kind == "fqf" else ("online",)
            if init is None:
                init = {p: {n: v.detach().cpu() for n, v in getattr(ts, p).state_dict().items()} for p in parts}
                g = torch.Generator(device=dev).manual_seed(1)
                if kind == "rainbow":
                    extra = dict(noise=(draw_noise(ts.target, g), draw_noise(ts.online, g)))
                elif kind == "iqn":
                    extra = dict(taus=tuple(torch.rand((batch, k), generator=g, device=dev) for k in (5, 6, 5)))
            for p in parts:
                getattr(ts, p).load_state_dict(init[p])
            ts.target.load_state_dict(init["online"])
            dev_extra = {k: tree_map(lambda x: x.to(dev), v) for k, v in extra.items()}
            if kind == "dqn-per":
                buf, bs = per_state(dev)
                buf.sample_with_weights = lambda st, gen, b, buf=buf, dev=dev: buf.sample_at(st, u.to(dev))
                sampled = algo.presample(buf, bs, None, batch)
                ts, bs, m = algo.update_sampled(ts, buf, bs, sampled)
                out = [m["loss"], bs.tree, bs.max_prio, bs.min_prio]
            else:
                sampled = (quantile_sample if kind in ("qrdqn", "iqn", "fqf") else c51_sample)(dev)
                ts, _, m = algo.update_sampled(ts, None, None, sampled, **dev_extra)
                out = [torch.stack([m[k] for k in sorted(m)])]
            runs[dev] = (ts, out, parts)
        (gts, gout, parts), (cts, cout, _) = runs["cuda"], runs["cpu"]
        err = max(_assert_close(f"{kind} output {i}", g, c) for i, (g, c) in enumerate(zip(gout, cout)))
        for p in (*parts, "target"):
            for name, v in getattr(gts, p).state_dict().items():
                err = max(err, _assert_close(f"{kind} {p}.{name}", v, getattr(cts, p).state_dict()[name]))
        log(f"reference {kind}: one update on the card equals the CPU's within rtol 1e-4 / atol 1e-5 (largest "
            f"difference {err:.3e}" + (", the tree after the write-back included)" if kind == "dqn-per" else ")"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tianshou_tpu_torch.ops.gather import gather_rows_cast

    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernel = phase_kernels()
    for path in ("atari", "atari_dedup"):
        phase_reference(path)
    phase_reference_continuous()
    phase_reference_onpolicy()
    phase_reference_distributional()
    results, launches = {}, 0
    for path in PATHS:
        results[path] = (phase_host if path in HOST_PATHS else phase_superstep)(path, gather_rows_cast)
        launches += phase_main_path(path, gather_rows_cast)
    kernel["launches"] = launches
    stored, dedup = results["atari"], results["atari_dedup"]
    log("atari memory regime: frames stored once (atari_dedup) beside stored stacks (atari): "
        + ", ".join(f"{k} {dedup[k]:.4f} vs {stored[k]:.4f}" for k in (
            "ring_gb", "max_memory_allocated_gib", "ms_per_superstep", "env_steps_per_s")))
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"card": smi, "paths": results}))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
