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
   update losses;
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
     steps, batch 512, 102 updates a superstep.

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

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3 of an H100 SXM
H100_FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores

# per path: envs, steps a segment, batch, updates a superstep, ring capacity
PATHS = {
    "atari": dict(num_envs=128, segment=16, batch=512, updates=26, capacity=64),
    "atari_dedup": dict(num_envs=128, segment=16, batch=512, updates=26, capacity=64),
    "cartpole": dict(num_envs=1024, segment=64, batch=1024, updates=410, capacity=64),
    "minatar": dict(num_envs=256, segment=32, batch=512, updates=102, capacity=64),
}
# launches of gather_rows_cast a superstep: obs and obs_next of the presample
KERNEL_LAUNCHES = {"atari": 2, "atari_dedup": 2, "cartpole": 0, "minatar": 0}


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


def build_path(path: str, device, test_envs: int = 8, **small):
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
    else:
        raise ValueError(f"unknown path {path!r}; have {sorted(PATHS)}")
    buffer = ReplayBuffer(capacity, num_envs, **buffer_options)
    algo = DQN(net, env.action_space, lr=1e-3, device=device, **dqn)
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
    with torch.no_grad():
        q = algo.q_values(ts.online, cstate.obs)
    if q.shape != (cfg["num_envs"], env.action_space.n) or not bool(torch.isfinite(q).all()):
        raise AssertionError(f"{path}: bad Q-values: {tuple(q.shape)}")
    from tianshou_tpu_torch.data.tree import tree_leaves

    peak = torch.cuda.max_memory_allocated() / 2**30
    ring_gb = sum(x.numel() * x.element_size() for x in tree_leaves(bstate.storage)) / 1e9
    result = {"env_steps_per_s": n * steps / dt, "ms_per_superstep": dt / n * 1e3, "loss": loss,
              "gather_rows_cast_per_superstep": launches / n, "max_memory_allocated_gib": peak,
              "ring_gb": ring_gb}
    log(f"{path}: {n} supersteps of {cfg['num_envs']} envs x {cfg['segment']} steps + {cfg['updates']} "
        f"updates of batch {cfg['batch']}: {result['env_steps_per_s']:.1f} env-steps/s, "
        f"{result['ms_per_superstep']:.2f} ms per superstep, loss {loss:.5f}, gather_rows_cast launches "
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
        float(metrics["loss"])
        t3 = time.perf_counter()
        parts["rollout"].append(t1 - t0)
        parts["presample"].append(t2 - t1)
        parts["updates incl. presample"].append(t3 - t2)
    result["breakdown_ms"] = {k: sorted(v)[1] * 1e3 for k, v in parts.items()}
    log(f"{path} breakdown (median of 3, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["breakdown_ms"].items()))
    return result


def phase_main_path(path: str, gather) -> int:
    """``OffPolicyTrainer.run()`` on the path; the launch count is read over
    exactly that run."""
    cfg = PATHS[path]
    _, _, _, _, trainer = build_path(path, "cuda")
    gather.launches = 0
    info = trainer.run()
    launches = gather.launches
    log(f"{path} OffPolicyTrainer.run(): {info}")
    if launches != KERNEL_LAUNCHES[path] * 2:
        raise AssertionError(f"{path}: gather_rows_cast launched {launches} times in run(), "
                             f"not {KERNEL_LAUNCHES[path] * 2}")
    if info.env_step != 2 * cfg["num_envs"] * cfg["segment"] or info.gradient_step != 2 * cfg["updates"]:
        raise AssertionError(f"{path}: counters env_step={info.env_step} gradient_step={info.gradient_step}")
    if not math.isfinite(info.last_metrics["loss"]) or not math.isfinite(info.best_reward):
        raise AssertionError(f"{path}: non-finite result: {info}")
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
    results, launches = {}, 0
    for path in PATHS:
        results[path] = phase_superstep(path, gather_rows_cast)
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
