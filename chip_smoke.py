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
   stream, which would show a pinned buffer overwritten under a copy;
5. paths, each at full width: 2 warm-up and 5 timed supersteps, one more
   superstep in which a host synchronisation raises, where the time of a
   superstep goes, then ``OffPolicyTrainer.run()`` for one epoch of two
   supersteps with a test phase, the launch counts read over exactly that
   run.  The paths (``PATHS``):
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
     ``add_trajectory`` and the updates); the profiler must see exactly one
     host-to-device copy a segment; segments are also timed with
     ``pipeline_host_updates`` on, in turns with it off.

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
}
DQN_PATHS = ("atari", "atari_dedup", "cartpole", "minatar")
HOST_PATHS = ("sac_host",)
# launches of gather_rows_cast a superstep: obs and obs_next of the presample
KERNEL_LAUNCHES = {"atari": 2, "atari_dedup": 2, "cartpole": 0, "minatar": 0,
                   "sac_pendulum": 0, "td3_pendulum": 0, "sac_host": 0}


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
        # DQN explores with epsilon 0.1; TD3 takes its default, its own
        # exploration noise (SAC samples and ignores it)
        train_param_fn=(lambda epoch, step: 0.1) if dqn is not None else None,
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
    bstate = buffer.init(collector.example_transition(ts, cstate), device=collector.device)
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
        raise AssertionError(f"{what}: card and CPU differ beyond rtol {rtol} / atol {atol}")
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


def phase_superstep(path: str, gather) -> dict:
    """The path's superstep at full width: timed, under the sync guard, and
    broken down."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    cfg = PATHS[path]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    env, algo, col, buffer, trainer = build_path(path, "cuda")
    gen, ts, cstate, bstate = init_states(algo, col, buffer)
    superstep = trainer._build_superstep()
    steps = cfg["num_envs"] * cfg["segment"]
    loss_key = "loss" if path in DQN_PATHS else "critic_loss"
    for _ in range(2):
        ts, cstate, bstate, outputs, metrics = superstep(ts, cstate, bstate, gen, 0.1)
    torch.cuda.synchronize()
    gather.launches = 0
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        ts, cstate, bstate, outputs, metrics = superstep(ts, cstate, bstate, gen, 0.1)
    loss = float(metrics[loss_key])  # synchronises
    dt = time.perf_counter() - t0
    launches = gather.launches
    if launches != KERNEL_LAUNCHES[path] * n:
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times in {n} supersteps, "
                             f"not {KERNEL_LAUNCHES[path] * n}")
    if not math.isfinite(loss):
        raise AssertionError(f"{path}: non-finite loss {loss}")
    # the superstep keeps everything on the device: an operation in it that
    # PyTorch knows to synchronise the host with the card raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, cstate, bstate, outputs, metrics = superstep(ts, cstate, bstate, gen, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_policy(path, algo, ts, cstate.obs, gen, env)
    from tianshou_tpu_torch.data.tree import tree_leaves

    peak = torch.cuda.max_memory_allocated() / 2**30
    ring_gb = sum(x.numel() * x.element_size() for x in tree_leaves(bstate.storage)) / 1e9
    result = {"env_steps_per_s": n * steps / dt, "ms_per_superstep": dt / n * 1e3, loss_key: loss,
              "gather_rows_cast_per_superstep": launches / n, "max_memory_allocated_gib": peak,
              "ring_gb": ring_gb}
    log(f"{path}: {n} supersteps of {cfg['num_envs']} envs x {cfg['segment']} steps + {cfg['updates']} "
        f"updates of batch {cfg['batch']}: {result['env_steps_per_s']:.1f} env-steps/s, "
        f"{result['ms_per_superstep']:.2f} ms per superstep, {loss_key} {loss:.5f}, gather_rows_cast launches "
        f"{launches}, replay ring {ring_gb:.4f} GB, max_memory_allocated {peak:.3f} GiB; a superstep under "
        f"torch.cuda.set_sync_debug_mode('error') raised no host sync")

    # where a superstep's time goes: its three parts timed alone
    seg = rollout_segment(algo, col.venv, buffer, cfg["segment"], explore=True)
    updates_fn = build_update_scan(algo, buffer, cfg["batch"], cfg["updates"])
    parts = {"rollout": [], "presample": [], "updates incl. presample": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cstate, bstate, _ = seg(ts, cstate, bstate, 0.1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        algo.presample(buffer, bstate, gen, cfg["updates"] * cfg["batch"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ts, bstate, metrics = updates_fn(ts, bstate, gen)
        float(metrics[loss_key])
        t3 = time.perf_counter()
        parts["rollout"].append(t1 - t0)
        parts["presample"].append(t2 - t1)
        parts["updates incl. presample"].append(t3 - t2)
    result["breakdown_ms"] = {k: sorted(v)[1] * 1e3 for k, v in parts.items()}
    log(f"{path} breakdown (median of 3, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))
    return result


def check_policy(path: str, algo, ts, obs, gen, env) -> None:
    """The trained policy's outputs on the last observations: finite
    Q-values of the right shape (DQN), finite actions in [-1, 1] (the
    continuous algorithms)."""
    with torch.no_grad():
        if path in DQN_PATHS:
            out = algo.q_values(ts.online, obs)
            shape = (obs.shape[0], env.action_space.n)
        else:
            out = algo.act(ts, obs, gen, explore=False)
            shape = (obs.shape[0],) + tuple(env.action_space.shape)
            if float(out.abs().max()) > 1.0:
                raise AssertionError(f"{path}: actions outside [-1, 1]")
    if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{path}: bad policy output: {tuple(out.shape)}, expected {shape}")


def phase_host(path: str, gather) -> dict:
    """The host-env path at full width: 2 warm-up and 5 timed segments
    (collect on the host envs, then one host step), the device part of one
    more under the sync guard, one under the profiler (exactly one
    host-to-device copy), the breakdown, and segments with
    ``pipeline_host_updates`` on and off in turns."""
    from torch.profiler import ProfilerActivity, profile

    from tianshou_tpu_torch.data.batch import Batch
    from tianshou_tpu_torch.utils.transfer import TreePacker

    cfg = PATHS[path]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    env, algo, col, buffer, trainer = build_path(path, "cuda")
    loop, _ = trainer._host_setup()
    steps = cfg["num_envs"] * cfg["segment"]

    def segments(lp, n):
        for _ in range(n):
            _, traj = lp.collect(0.0)
            lp.update(traj)
        return lp.read_metrics()  # synchronises

    segments(loop, 2)
    gather.launches = 0
    copies = TreePacker.copies
    n = 5
    t0 = time.perf_counter()
    metrics = segments(loop, n)
    dt = time.perf_counter() - t0
    copies = TreePacker.copies - copies
    if gather.launches != 0 or copies != n:
        raise AssertionError(f"{path}: {copies} packed copies and {gather.launches} gather launches in {n} segments")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{path}: non-finite metrics {metrics}")

    # the device part of a segment (unpack, add_trajectory, the updates)
    # makes no host synchronisation
    _, traj = loop.collect(0.0)
    uploaded = loop.host_step.upload(traj)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop.ts, loop.bstate, loop.metrics = loop.host_step.device(loop.ts, loop.bstate, uploaded, loop.generator)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    # exactly one host-to-device copy in a segment's host step
    _, traj = loop.collect(0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop.update(traj)
        torch.cuda.synchronize()
    device_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    h2d = [e.name for e in device_events if "HtoD" in e.name]
    if not device_events or len(h2d) != 1:
        raise AssertionError(f"{path}: {len(h2d)} host-to-device copies in a host step "
                             f"({len(device_events)} device events traced): {h2d}")
    check_policy(path, algo, loop.ts, torch.as_tensor(col.obs, device=algo.device), loop.generator, env)

    # where a segment's time goes: its parts timed alone
    parts = {"host collect": [], "pack + copy + add_trajectory": [], "updates incl. presample": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, traj = loop.collect(0.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        packer, flat, act = loop.host_step.upload(traj)
        bstate = buffer.add_trajectory(loop.bstate, Batch(**packer.unpack(flat), act=act))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loop.ts, loop.bstate, m = loop.host_step.updates_fn(loop.ts, bstate, loop.generator)
        float(m["critic_loss"])
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v)
    peak = torch.cuda.max_memory_allocated() / 2**30
    result = {"env_steps_per_s": n * steps / dt, "ms_per_segment": dt / n * 1e3, "critic_loss": metrics["critic_loss"],
              "h2d_copies_per_segment": copies / n, "max_memory_allocated_gib": peak,
              "breakdown_ms": {k: sorted(v)[1] * 1e3 for k, v in parts.items()}}
    log(f"{path}: {n} segments of {cfg['num_envs']} host envs x {cfg['segment']} steps + {cfg['updates']} updates "
        f"of batch {cfg['batch']}: {result['env_steps_per_s']:.1f} env-steps/s, {result['ms_per_segment']:.2f} ms "
        f"per segment (stand-in env: env time understated), critic_loss {metrics['critic_loss']:.5f}, "
        f"{copies} packed host-to-device copies, max_memory_allocated {peak:.3f} GiB; the device part under "
        f"torch.cuda.set_sync_debug_mode('error') raised no host sync; the profiler saw one copy: {h2d[0]}")
    log(f"{path} breakdown (median of 3, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))

    # pipeline_host_updates: the same segments with acting on a side stream
    # from a snapshot of the actor, in turns with the sequential loop
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
    result["pipeline_ms_per_segment"] = {k: sum(v) / len(v) for k, v in turns.items()}
    log(f"{path} pipeline_host_updates (ms a segment, mean of 2 turns of {n}, order seq/pipe/pipe/seq): "
        + ", ".join(f"{k} {v:.2f} ({', '.join(f'{x:.2f}' for x in turns[k])})"
                    for k, v in result["pipeline_ms_per_segment"].items()))
    for lp in (loop, piped):
        lp.trainer.train_collector.venv.close()
        lp.trainer.test_collector.venv.close()
    return result


def phase_main_path(path: str, gather) -> int:
    """``OffPolicyTrainer.run()`` on the path; the launch count is read over
    exactly that run."""
    cfg = PATHS[path]
    _, _, train, _, trainer = build_path(path, "cuda")
    gather.launches = 0
    info = trainer.run()
    launches = gather.launches
    log(f"{path} OffPolicyTrainer.run(): {info}")
    if launches != KERNEL_LAUNCHES[path] * 2:
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times in run(), "
                             f"not {KERNEL_LAUNCHES[path] * 2}")
    env_steps = cfg.get("warmup", 0) + 2 * cfg["num_envs"] * cfg["segment"]
    if info.env_step != env_steps or info.gradient_step != 2 * cfg["updates"]:
        raise AssertionError(f"{path}: counters env_step={info.env_step} gradient_step={info.gradient_step}")
    keys = ("loss",) if path in DQN_PATHS else ("critic_loss", "actor_loss")
    if not all(math.isfinite(info.last_metrics[k]) for k in keys) or not math.isfinite(info.best_reward):
        raise AssertionError(f"{path}: non-finite result: {info}")
    if path in HOST_PATHS:
        train.venv.close()
        trainer.test_collector.venv.close()
    return launches


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
