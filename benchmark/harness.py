"""One run of one cell: set-up, the measured window of ``OffPolicyTrainer.run()``,
the trace of a sub-window, the reference's comparison and the result line.

The window opens when the first epoch's test phase ends (every CUDA graph
of the run is captured by then) and closes at the first superstep that
completes ``seconds`` later.  Everything before it is set-up.  The run then
goes on to the end of that epoch, untimed, where ``stop_fn`` ends it.
Times come from the benchmark's logger (:class:`BenchLogger`): each
superstep's train data arrives after the trainer's one host read of it,
each epoch end's counters before its test phase and the test result after
it.

Correctness follows the first :data:`FOLLOWED` supersteps of the run
(set-up; the first is the capture's eager warm-up, the rest replays of the
graph the window replays): after each, the benchmark keeps the program's
first update's loss and gradients (:mod:`benchmark.builders.dqn_device`),
the replay indices its presample returned, its train state and optimizer
moments, a host copy of the ring and the state of the generator the
superstep sampled from.  Once the window has closed, the peak memory has
been read and the program is freed, the reference
(:mod:`benchmark.reference`) takes each followed superstep from the state
before it (the benchmark's weights and a fresh optimizer before the first,
the program's state before the others), draws the replay indices itself
from that generator state and works the superstep out again: the first
update's loss and gradients, the parameters' change over the superstep,
and the rollout's greedy actions; and it checks every transition of the
final ring.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from benchmark import compare, flops, subwindow
from tianshou_tpu_torch.utils.logger import BaseLogger

__all__ = ["BenchLogger", "CellRun", "load_cell", "run_cell", "FORBIDDEN_MODULES"]

ROOT = Path(__file__).resolve().parent
#: top-level module names that no run may load, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "tianshou_tpu")
#: the supersteps the reference follows: the capture's eager warm-up and
#: two replays
FOLLOWED = 3


def load_cell(workload: str, manifest: dict) -> dict:
    """The cell ``workload`` of ``manifest`` (``BENCHMARK.json``) with its
    configuration, traffic mix and metric entries, each found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((ROOT.parent / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
            "per_layer": [m for m in manifest["per_layer"] if mine(m)]}


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class BenchLogger(BaseLogger):
    """The trainer's logger: hands each call to the run, unfiltered."""

    def __init__(self, run: "CellRun"):
        super().__init__()
        self.run = run

    def write(self, step, data):
        pass

    def log_train_data(self, data, step):
        self.run.on_superstep(data)

    def save_data(self, epoch, env_step, gradient_step, save_checkpoint_fn=None):
        self.run.on_epoch_end()
        super().save_data(epoch, env_step, gradient_step, save_checkpoint_fn)

    def log_test_data(self, data, step):
        self.run.on_test()

    def log_update_data(self, data, step):
        pass

    def log_info_data(self, data, step):
        pass


class CellRun:
    """The state of one run: timestamps, the reference's snapshots and the
    traced sub-window."""

    def __init__(self, spec: dict, seed: int, seconds: float, traced: bool, t0: float):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.seed, self.seconds, self.traced, self.t0 = seed, seconds, traced, t0
        self.followed = FOLLOWED
        self.supersteps: list[dict] = []  # t_end, dt (wall since the previous mark), in_window
        self.tests: list[tuple[float, float]] = []
        self.window_start = self.window_end = None
        self.last_mark = None
        self.epoch_end_t = None
        self.snapshots: list[dict] = []
        self.sample_states: list[torch.Tensor] = []
        self.eps_values: list[float] = []
        self.eps = None
        self.algo = self.buffer = self.trainer = None
        self.tracer: subwindow.SubWindow | None = None
        self.trace_result: dict | None = None
        self.profiled_until: float | None = None

    # -- hooks -------------------------------------------------------------
    def train_param_fn(self, epoch: int, env_step: int) -> float:
        s = len(self.supersteps) + 1  # the superstep about to run
        if s == 1:
            self.t_first_launch = time.perf_counter()
        eps = self.eps(env_step)
        self.algo.current_superstep = s
        if s <= self.followed:
            self.eps_values.append(eps)
            if s >= 2:
                self.sample_states.append(self.algo.sample_generator.get_state())
        if self.tracer is not None:
            self.tracer.launch()
        return eps

    def stop_fn(self, reward: float) -> bool:
        return self.window_end is not None

    def on_superstep(self, data: dict) -> None:
        now = time.perf_counter()
        s = len(self.supersteps) + 1
        rec = {"t_end": now, "dt": now - (self.last_mark if self.last_mark is not None else now),
               "in_window": False}
        if self.window_start is not None and self.window_end is None:
            rec["in_window"] = True
            if now - self.window_start >= self.seconds:
                self.window_end = now
        self.supersteps.append(rec)
        self.last_mark = now
        if s <= self.followed:
            self._snapshot(s)
        if self.tracer is not None:
            self.tracer.superstep_done()
            if self.tracer.done:
                self.trace_result = self.tracer.finish()
                # the next superstep's time starts after the trace's processing
                self.profiled_until = self.last_mark = time.perf_counter()
                self.tracer = None

    def on_epoch_end(self) -> None:
        self.epoch_end_t = time.perf_counter()

    def on_test(self) -> None:
        now = time.perf_counter()
        if self.window_start is not None and self.window_end is None:
            self.tests.append((self.epoch_end_t, now))
        self.last_mark = now
        if self.window_start is None:
            self.window_start = now
            if self.traced:
                self.tracer = subwindow.SubWindow(self.traffic["trace_supersteps"])
                self.tracer.start()

    # -- the reference's snapshots -------------------------------------------
    def _snapshot(self, s: int) -> None:
        """After followed superstep ``s``: the program's first update's loss
        and gradients, the replay indices its presample returned, its state
        (train state and optimizer moments) and the ring on the host, and
        the state of the generator the superstep sampled from."""
        rec = self.algo.superstep_pass(s)
        # no optimizer step, or a leaf without a gradient: the optimizer got zeros
        grads = rec["grads"] or {}
        ts = self.algo.train_state
        opt = ts.optimizer.state
        self.snapshots.append({
            "loss1": float(rec["losses"][0]), "eps": self.eps_values[s - 1],
            "grads1": {n_: _host(grads[n_] if grads.get(n_) is not None else torch.zeros_like(p))
                       for n_, p in ts.online.named_parameters()},
            "env_idx": _host(rec["env_idx"]), "pos": _host(rec["pos"]),
            "sample_state": self.algo.first_sample_state if s == 1 else self.sample_states[s - 2],
            "ring": _host_ring(self.buffer.current()),
            "online": {n_: _host(p) for n_, p in ts.online.named_parameters()},
            "target": {n_: _host(p) for n_, p in ts.target.named_parameters()},
            # an optimizer that never stepped has no moments: zero, as Adam starts
            "exp_avg": {n_: _host(opt.get(p, {}).get("exp_avg", torch.zeros_like(p)))
                        for n_, p in ts.online.named_parameters()},
            "exp_avg_sq": {n_: _host(opt.get(p, {}).get("exp_avg_sq", torch.zeros_like(p)))
                           for n_, p in ts.online.named_parameters()},
            "adam_step": [float(opt[p]["step"]) if p in opt else 0.0 for p in ts.online.parameters()],
            "device_step": int(ts.device_step) if ts.device_step is not None else ts.step,
        })
        if s == self.followed:
            self.algo.recording = False
            self.algo.passes.clear()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that the program's later steps cannot change."""
    return t.detach().to("cpu", copy=True)


def _host_ring(state) -> dict:
    return {"storage": {k: _host(v) for k, v in state.storage.items()}, "cursor": _host(state.cursor),
            "size": _host(state.size)}


def build_program(spec: dict, run: CellRun, seed: int, device: str):
    builder = importlib.import_module(f"benchmark.builders.{spec['config']['builder']}")
    eps = builder.eps_schedule(spec["config"])
    run.eps = eps
    trainer, algo, buffer = builder.build(spec["config"], spec["traffic"], seed, device, BenchLogger(run),
                                          run.train_param_fn, run.stop_fn)
    run.trainer, run.algo, run.buffer = trainer, algo, buffer
    return trainer


def judge(run: CellRun, device: str) -> tuple[bool, dict, dict]:
    """The reference against the program: ``(correct, {name: (value,
    limit)}, every number)``."""
    every = numbers(run, device)
    return (*compare.decide(every, run.traffic["limits"]), every)


def numbers(run: CellRun, device: str, followed: dict | None = None,
            rounding: dict | None = None) -> dict[str, float]:
    """Every number of the comparison of a finished run (``followed``: the
    reference's :func:`follow`; ``rounding``: the reference in the
    configuration's compute precision, for a configuration that computes
    below float32; each worked out here when not given)."""
    reference = importlib.import_module(f"benchmark.reference.{run.config['reference']}")
    if followed is None:
        followed = reference.follow(run.config, run.traffic, run.seed, run.snapshots, device)
    mode = reference.precision_mode(run.config)
    if rounding is None and mode != "fp32":
        rounding = reference.follow(run.config, run.traffic, run.seed, run.snapshots, device, mode=mode)
    out = compare.training_numbers(compare.program_steps(run.snapshots, followed["initial"]), followed["steps"],
                                   followed["act_gap"], rounding["steps"] if rounding else None)
    out["index_faults"] = followed["index_faults"]
    out.update(reference.check_ring(run.config, run.final_ring, device, run.final_env))
    return out


def execute(spec: dict, seed: int, seconds: float, traced: bool, device: str, t0: float) -> CellRun:
    """One whole run of the program; returns the run with its peak memory,
    final ring and env state on the host, the program freed."""
    run = CellRun(spec, seed, seconds, traced, t0)
    trainer = build_program(spec, run, seed, device)
    run.t_built = time.perf_counter()
    trainer.run()
    if run.window_end is None:
        raise RuntimeError("the run ended before its window closed")
    on_cuda = device.startswith("cuda")
    run.peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    run.final_ring = _host_ring(trainer.buffer_state)
    env = trainer.collect_state.env_state
    run.final_env = {k: _host(v) for k, v in env._asdict().items()}
    run.trainer = run.algo = run.buffer = trainer = None
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    run.setup_s = run.window_start - t0
    run.flops_per_superstep = flops.superstep_flops(spec["config"], spec["traffic"])
    return run


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device: str, t0: float) -> dict:
    """One whole run; returns the result line's object."""
    run = execute(spec, seed, seconds, traced, device, t0)
    correct, checks, every = judge(run, device)
    metrics = {}
    entries = spec["per_layer"] if traced else spec["end_to_end"]
    for entry in entries:
        value = load_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    window = [r for r in run.supersteps if r["in_window"]]
    out = {"correct": correct, "attempted": len(window), "failed": 0, "metrics": metrics,
           "device": device_info(run.peak, device.startswith("cuda"))}
    if traced and run.trace_result is not None:
        out["device"]["busy_s"] = run.trace_result["busy_s"]
        out["device"]["window_s"] = run.trace_result["window_s"]
        out["breakdown"] = run.trace_result["breakdown"]
    out["numbers"] = every
    out["setup_parts_s"] = setup_parts(run)
    times = [r["dt"] * 1e3 for r in window]
    out["window"] = {"seconds": run.window_end - run.window_start, "supersteps": len(window),
                     "superstep_ms_quantiles": [percentile(times, q) for q in (0, 10, 25, 50, 75, 90, 100)],
                     "test_phases": len(run.tests), "test_phases_s": sum(b - a for a, b in run.tests)}
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return out


def setup_parts(run: CellRun) -> dict:
    """Where the set-up went, by the hooks' clock: imports and building the
    program, the trainer's start with the ring's fill (up to the first superstep's launch), the first
    superstep (its warm-up and capture), the rest of the first epoch with its
    test phase."""
    first = run.supersteps[0]["t_end"]
    return {"imports_and_build": run.t_built - run.t0, "start_and_ring_fill": run.t_first_launch - run.t_built,
            "first_superstep": first - run.t_first_launch, "rest_of_epoch_1": run.window_start - first}


def device_info(peak: int, on_cuda: bool) -> dict:
    if not on_cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1, "memory_peak_bytes": peak}


def forbidden_loaded(names=None) -> list[str]:
    """The top-level names of ``names`` (default: the loaded modules),
    compared whole, that are in :data:`FORBIDDEN_MODULES`."""
    return sorted({name.split(".")[0] for name in (sys.modules if names is None else names)}
                  & set(FORBIDDEN_MODULES))


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    at = (len(xs) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)
