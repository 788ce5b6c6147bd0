#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``tianshou_tpu_torch``) on one
NVIDIA GPU.  Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA;
2. build: every kernel under ``tianshou_tpu_torch/csrc`` with ``nvcc``;
3. kernels: each kernel against its plain PyTorch version on the card
   (bitwise), then timed beside the plain version, the PyTorch library call
   and the least time the card could take (its bound);
4. reference: a small slice run on the card and on the CPU from the same
   parameters and env phases: identical actions and replay storage, the
   same bf16 presample, the same update losses;
5. slice: the pixel DQN superstep at full width (SyntheticPixelEnv 84x84x4,
   NatureCNN in bf16, 128 envs x 16 steps, batch 512, 26 updates a
   superstep): 2 warm-up and 5 timed supersteps, 2 ``gather_rows_cast``
   launches each, one more superstep in which a host synchronisation
   raises, and where the time of a superstep goes;
6. main path: ``OffPolicyTrainer.run()`` for one epoch of two supersteps
   with a test phase, the launch counts taken over exactly that run.

It then prints the ``kernels`` JSON line and, last, the ``ok`` JSON line.
Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3 of an H100 SXM
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores

NUM_ENVS, SEGMENT, BATCH, UPDATES, CAPACITY = 128, 16, 512, 26, 64


def log(msg: str) -> None:
    print(msg, flush=True)


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


def phase_kernels() -> dict:
    from tianshou_tpu_torch.ops.gather import gather_rows_cast, gather_rows_cast_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(rows, feat, batch, offset=0):
        flat = torch.randint(0, 256, (rows * feat + offset,), generator=gen, device=dev, dtype=torch.uint8)
        idx = torch.randint(0, rows, (batch,), generator=gen, device=dev)
        return flat[offset:].view(rows, feat), idx

    # (rows, features, batch, base offset): the slice's shape, an unaligned
    # row width, a batch that fills no round number of blocks with rows
    # wider than one block, and a storage base off the 16-byte alignment
    cases = [(8192, 28224, 13312, 0), (16, 13, 9, 0), (300, 4100, 1001, 0), (64, 28224, 77, 3)]
    max_err = 0.0
    for rows, feat, batch, offset in cases:
        storage, idx = inputs(rows, feat, batch, offset)
        got = gather_rows_cast(storage, idx)
        torch.cuda.synchronize()
        ref = gather_rows_cast_plain(storage, idx)
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError(f"gather_rows_cast differs from its plain version at {rows, feat, batch, offset}")
        max_err = max(max_err, float((got.float() - ref.float()).abs().max()))
        log(f"kernel check gather_rows_cast R={rows} F={feat} B={batch} offset={offset}: bitwise equal")

    rows, feat, batch = NUM_ENVS * CAPACITY, 84 * 84 * 4, UPDATES * BATCH
    storage, idx = inputs(rows, feat, batch)
    ms = time_ms(lambda: gather_rows_cast(storage, idx))
    plain_ms = time_ms(lambda: gather_rows_cast_plain(storage, idx))
    library_ms = time_ms(lambda: torch.index_select(storage, 0, idx).to(torch.bfloat16))
    unique_rows = int(torch.unique(idx).numel())
    moved = unique_rows * feat + batch * feat * 2 + batch * 8  # rows read, bf16 written, indices
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = batch * feat / H100_FP32_OPS_PER_S * 1e3  # one conversion per byte
    bound_ms = max(bytes_ms, ops_ms)
    log(f"gather_rows_cast at R={rows} F={feat} B={batch} ({unique_rows} distinct rows): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_select+to {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({moved / 1e9:.3f} GB at 3.35 TB/s); "
        f"{moved / (ms * 1e-3) / 1e12:.3f} TB/s achieved, {bound_ms / ms:.3f} of the bound")
    return {
        "name": "gather_rows_cast",
        "route": "cuda",
        "source": "tianshou_tpu_torch/csrc/gather_rows_cast.cu",
        "replaces": "tianshou_tpu/ops/pallas_gather.py:38",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
    }


def build_slice(device, height=84, width=84, channels=4, num_actions=6, num_envs=NUM_ENVS,
                segment=SEGMENT, batch=BATCH, updates=UPDATES, capacity=CAPACITY,
                compute_dtype=torch.bfloat16, test_envs=8, episode_len=512):
    """The atari-stage configuration through the port's entry points."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv
    from tianshou_tpu_torch.networks.conv import ConvQNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    env = SyntheticPixelEnv(height, width, channels, num_actions=num_actions, episode_len=episode_len)
    buffer = ReplayBuffer(capacity, num_envs)
    net = ConvQNet(env.observation_space.shape, num_actions, "nature",
                   encoder_kwargs={"compute_dtype": compute_dtype})
    algo = DQN(net, env.action_space, lr=1e-3, gamma=0.99, n_step=3, target_update_freq=1000, device=device)
    train = Collector(algo, VectorEnv(env, num_envs, device=device), buffer, device=device)
    test = Collector(algo, VectorEnv(env, test_envs, device=device), device=device)
    steps = num_envs * segment
    trainer = OffPolicyTrainer(
        algo, train, test, buffer, max_epoch=1, step_per_epoch=2 * steps, step_per_collect=steps,
        update_per_step=updates / steps, batch_size=batch, episode_per_test=test_envs, device=device,
        train_param_fn=lambda epoch, step: 0.1,
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


def phase_reference() -> None:
    """Small slice on the card and on the CPU from the same start: the card
    must take the same greedy actions (float32, TF32 off), store the same
    ring bitwise, gather the same bf16 presample through the kernel, and
    find the same update losses (rtol 1e-3: cuDNN and the CPU sum the
    convolutions in different orders)."""
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.envs.synthetic import SyntheticPixelState
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    small = dict(height=36, width=36, channels=2, num_actions=4, num_envs=4, segment=20,
                 batch=16, updates=3, capacity=16, compute_dtype=torch.float32, episode_len=64)
    seeds = torch.tensor([11, 222, 3333, 44444], dtype=torch.int32)
    runs = {}
    state_dict = None
    for device in ("cuda", "cpu"):
        env, algo, col, buffer, _ = build_slice(device, **small)
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
        bf16 = buffer.get(bstate, env_idx, pos, keys=("obs", "obs_next"),
                          dtypes={"obs": torch.bfloat16, "obs_next": torch.bfloat16})
        buffer.sample_with_weights = lambda st, g, b, e=env_idx, p=pos: (e, p, torch.ones(b, device=e.device))
        ts, bstate, metrics = build_update_scan(algo, buffer, small["batch"], small["updates"])(
            ts, bstate, None)
        runs[device] = (bstate, bf16, {k: float(v) for k, v in metrics.items()})
    (gb, gbf, gm), (cb, cbf, cm) = runs["cuda"], runs["cpu"]
    for k in cb.storage:
        if not torch.equal(gb.storage[k].cpu(), cb.storage[k]):
            raise AssertionError(f"replay storage {k!r} differs between the card and the CPU")
    for k in ("obs", "obs_next"):
        if not torch.equal(gbf[k].cpu().view(torch.int16), cbf[k].view(torch.int16)):
            raise AssertionError(f"bf16 presample of {k!r} differs between the card and the CPU")
    for k in cm:
        if not math.isclose(gm[k], cm[k], rel_tol=1e-3):
            raise AssertionError(f"{k}: card {gm[k]} vs CPU {cm[k]}")
    log(f"reference: card equals CPU on actions, replay storage and bf16 presample; "
        f"losses card {gm['loss']:.6f} CPU {cm['loss']:.6f}")


def phase_slice(gather) -> None:
    from tianshou_tpu_torch.collect.collector import rollout_segment
    from tianshou_tpu_torch.trainer.offpolicy import build_update_scan

    torch.cuda.reset_peak_memory_stats()
    env, algo, col, buffer, trainer = build_slice("cuda")
    gen, ts, cstate, bstate = init_states(algo, col, buffer)
    superstep = trainer._build_superstep()
    steps = NUM_ENVS * SEGMENT
    for _ in range(2):
        ts, cstate, bstate, outputs, metrics = superstep(ts, cstate, bstate, gen, 0.1)
    torch.cuda.synchronize()
    gather.launches = 0
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        ts, cstate, bstate, outputs, metrics = superstep(ts, cstate, bstate, gen, 0.1)
    loss = float(metrics["loss"])  # synchronises
    dt = time.perf_counter() - t0
    launches = gather.launches
    if launches != 2 * n:
        raise AssertionError(f"gather_rows_cast launched {launches} times in {n} supersteps, not {2 * n}")
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    # the superstep keeps everything on the device: an operation in it that
    # PyTorch knows to synchronise the host with the card raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts, cstate, bstate, outputs, metrics = superstep(ts, cstate, bstate, gen, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("slice: a superstep under torch.cuda.set_sync_debug_mode('error') raised no host sync")
    with torch.no_grad():
        q = ts.online(cstate.obs)
    if q.shape != (NUM_ENVS, env.action_space.n) or not bool(torch.isfinite(q).all()):
        raise AssertionError(f"bad Q-values: {tuple(q.shape)}")
    log(f"slice: {n} supersteps of {steps} env steps + {UPDATES} updates of batch {BATCH}: "
        f"{n * steps / dt:.1f} env-steps/s, {dt / n * 1e3:.2f} ms per superstep, loss {loss:.5f}, "
        f"gather_rows_cast launches {launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # where a superstep's time goes: its three parts timed alone
    seg = rollout_segment(algo, col.venv, buffer, SEGMENT, explore=True)
    updates_fn = build_update_scan(algo, buffer, BATCH, UPDATES)
    parts = {"rollout": [], "presample": [], "updates incl. presample": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cstate, bstate, _ = seg(ts, cstate, bstate, 0.1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        algo.presample(buffer, bstate, gen, UPDATES * BATCH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ts, bstate, metrics = updates_fn(ts, bstate, gen)
        float(metrics["loss"])
        t3 = time.perf_counter()
        parts["rollout"].append(t1 - t0)
        parts["presample"].append(t2 - t1)
        parts["updates incl. presample"].append(t3 - t2)
    log("slice breakdown (median of 3, ms): " + ", ".join(
        f"{k} {sorted(v)[1] * 1e3:.2f}" for k, v in parts.items()))


def phase_main_path(gather) -> int:
    _, _, _, _, trainer = build_slice("cuda")
    gather.launches = 0
    info = trainer.run()
    launches = gather.launches
    log(f"OffPolicyTrainer.run(): {info}")
    if launches != 2 * 2:
        raise AssertionError(f"gather_rows_cast launched {launches} times in run(), not 4")
    if info.env_step != 2 * NUM_ENVS * SEGMENT or info.gradient_step != 2 * UPDATES:
        raise AssertionError(f"counters env_step={info.env_step} gradient_step={info.gradient_step}")
    if not math.isfinite(info.last_metrics["loss"]) or not math.isfinite(info.best_reward):
        raise AssertionError(f"non-finite result: {info}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tianshou_tpu_torch.ops.gather import gather_rows_cast

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    kernel = phase_kernels()
    phase_reference()
    phase_slice(gather_rows_cast)
    kernel["launches"] = phase_main_path(gather_rows_cast)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
