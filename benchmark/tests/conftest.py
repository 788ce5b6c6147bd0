"""Shared helpers of the benchmark's tests: the repository's root on
``sys.path`` and the cells shrunk to a size the CPU runs in seconds."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


#: a configuration and a cell whose files the benchmark holds but whose
#: entries ``BENCHMARK.json`` does not list yet (PERF.md, Open questions)
STAGED = {"config": {"name": "mlp_dqn", "source": "https://github.com/thu-ml/tianshou/blob/v1.0.0/test/discrete/test_dqn.py",
                     "file": "benchmark/configs/mlp_dqn.json", "reduced": [], "why": "staged"},
          "cell": {"name": "mlp_dqn.replay", "config": "mlp_dqn", "traffic": "mlp_dqn.replay", "chips": 1,
                   "why": "staged"}}


def staged_manifest() -> dict:
    """``BENCHMARK.json`` with the staged configuration and cell added."""
    m = manifest()
    m["configs"].append(STAGED["config"])
    m["workloads"].append(STAGED["cell"])
    return m


def tiny_spec(cell: str, **config_overrides) -> dict:
    """``cell``'s spec with its traffic shrunk (4 envs, 4 steps, 2 updates
    of batch 8, a ring of 64 an env, 4 supersteps an epoch) and synthetic
    episodes of 40 steps, so that the ring holds episode ends."""
    from benchmark.harness import load_cell

    spec = copy.deepcopy(load_cell(cell, staged_manifest()))
    if spec["config"]["env"]["kind"] == "synthetic_pixel":
        spec["config"]["env"]["episode_len"] = 40
    spec["config"].update(config_overrides)
    if spec["config"]["compute_dtype"] == "float32":
        # a float32 configuration has no rounding of its own to scale by
        spec["traffic"]["limits"].pop("grad_cos_replay_ratio", None)
    spec["traffic"].update(num_envs=4, segment=4, updates=2, batch=8, capacity=64, warmup_steps=256,
                           step_per_epoch=64, test_envs=2, episodes=2)
    return spec


@pytest.fixture
def cpu_run():
    """``cpu_run(spec, seed) -> result``: a whole run on the CPU (the look
    for a card skipped), a window of half a second."""
    import time

    from benchmark.harness import run_cell

    def go(spec, seed=2**31 + 7):
        return run_cell(spec, seed, 0.5, False, "cpu", time.perf_counter())

    return go
