"""The Rainbow cell at a small size on the CPU: the reference
(``benchmark/reference/rainbow.py``) against the program, each planted
fault of ``benchmark/calibrate_rainbow.py`` against the cell's limits, the
frozen FLOP count against a count by hand, the cell's entries found by
name, and the builder's tracer switch."""

import copy
import time

import pytest

from benchmark import flops_rainbow, harness
from benchmark.calibrate_rainbow import FAULTS, planted
from benchmark.reference import rainbow as reference
from benchmark.tests.conftest import manifest

CELL = "nature_rainbow.replay"
#: the numbers each fault must push past its limit (any one of them)
BROKEN_BY = {
    "write_back_skipped": ("tree_faults",),
    "projection_shifted": ("grad_cos", "delta_gap"),
    "noise_not_drawn": ("grad_cos", "delta_gap", "index_faults"),
    "uniform_draws": ("index_faults",),
    "state_unchanged": ("delta_gap",),
    "half_batch": ("grad_cos", "tree_faults", "prio_gap"),
    "prio_rows_altered": ("prio_gap",),
    "reward_altered": ("env_faults",),
    "action_altered": ("act_gap",),
}


def tiny(dtype: str = "float32") -> dict:
    """The cell with 36x36 frames, 16-unit noisy streams, 11 atoms, 4 envs
    of 4 steps, 2 updates of batch 8, a ring of 64 an env and 40-step
    episodes.  In float32 both sides do the same arithmetic, so the
    configuration's own rounding, which scales ``grad_cos_replay_ratio``,
    is not there."""
    spec = copy.deepcopy(harness.load_cell(CELL, manifest()))
    c = spec["config"]
    c["env"].update(height=36, width=36, episode_len=40)
    c["network"]["head"].update(hidden=16, num_atoms=11)
    c["compute_dtype"] = dtype
    if dtype == "float32":
        spec["traffic"]["limits"].pop("grad_cos_replay_ratio")
    spec["traffic"].update(num_envs=4, segment=4, updates=2, batch=8, capacity=64, warmup_steps=256,
                           step_per_epoch=64, test_envs=2, episodes=2)
    return spec


def _run(spec, seed):
    """A whole run with a window of one superstep."""
    return harness.execute(spec, seed, 0.0, False, "cpu", time.perf_counter())


def test_cell_entries_load_by_name():
    spec = harness.load_cell(CELL, manifest())
    assert spec["config"]["name"] == "nature_rainbow" and spec["config"]["builder"] == "rainbow_device"
    assert spec["config"]["reduced"] == ["task"] and spec["config"]["network"]["head"]["noisy_std"] == 0.1
    assert {m["name"] for m in spec["per_layer"]} == {"per_sample_ms", "per_write_back_ms", "mfu.rainbow"}
    assert {m["name"] for m in spec["end_to_end"]} == {"env_steps_per_s", "grad_steps_per_s", "setup_s"}
    assert set(spec["traffic"]["limits"]) == {"grad_cos", "grad_cos_replay_ratio", "delta_gap", "act_gap",
                                              "index_faults", "env_faults", "tree_faults", "prio_gap"}
    for name in ("per_sample_ms", "per_write_back_ms", "mfu.rainbow"):
        assert callable(harness.load_reader(name))


def test_reference_follows_the_program_in_float32():
    run = _run(tiny(), 2**31 + 3)
    ref = reference.follow(run.config, run.traffic, run.seed, run.snapshots, "cpu")
    numbers = harness.numbers(run, "cpu", followed=ref)
    assert numbers["index_faults"] == 0 and numbers["tree_faults"] == 0 and numbers["env_faults"] == 0
    assert numbers["act_gap"] == 0.0
    assert max(v for k, v in numbers.items() if not k.endswith("faults")) < 1e-4, numbers
    # the draws were the program's own: the tree's rounding decided none
    assert ref["index_ties"] == 0 and run.snapshots[0]["env_idx"].numel() == 2 * 8


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_breaks_its_limit(fault, cpu_run):
    with planted(fault):
        out = cpu_run(tiny())
    assert not out["correct"]
    assert any(out["checks"][n]["value"] > out["checks"][n]["limit"] for n in BROKEN_BY[fault]), out["checks"]


def test_sound_run_is_correct_and_untraced(cpu_run):
    from tianshou_tpu_torch.utils import trace

    out = cpu_run(tiny())
    assert out["correct"], out["checks"]
    assert not trace.enabled() and "env_steps_per_s" in out["metrics"] and "setup_s" in out["metrics"]


@pytest.mark.parametrize("traced", [False, True])
def test_builder_turns_the_tracer_on_in_a_traced_run(traced):
    from benchmark.builders import rainbow_device
    from tianshou_tpu_torch.utils import trace

    spec = tiny()
    run = harness.CellRun(spec, 2**31 + 5, 0.0, traced, time.perf_counter())
    try:
        rainbow_device.build(spec["config"], spec["traffic"], run.seed, "cpu", harness.BenchLogger(run),
                             run.train_param_fn, run.stop_fn)
        assert trace.enabled() == traced
        if traced:  # spans kept, but no range on the profiler's device track
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with trace.span("tianshou.superstep"):
                    pass
            assert not [e for e in prof.profiler.kineto_results.events() if e.name().startswith("tianshou.")]
            assert trace.spans()[-1].name == "tianshou.superstep"
    finally:
        trace.disable()
        trace.clear()


def test_flops_by_hand():
    """84x84x4 frames, 6 actions, 51 atoms, 512-unit streams: convolutions
    of 3,276,800, 2,654,208 and 1,806,336 multiply-adds, streams of
    1,605,632 + 156,672 (advantage) and 1,605,632 + 26,112 (value)."""
    spec = harness.load_cell(CELL, manifest())
    convs = 3_276_800 + 2_654_208 + 1_806_336
    macs = convs + 1_605_632 + 156_672 + 1_605_632 + 26_112
    fwd = 2 * macs
    assert flops_rainbow.forward_flops(spec["config"]) == fwd == 22_262_784
    trained = fwd + (fwd + 2 * (macs - 3_276_800)) + 2 * fwd
    assert flops_rainbow.trained_sample_flops(spec["config"]) == trained == 104_760_320
    assert flops_rainbow.superstep_flops(spec["config"], spec["traffic"]) == 2048 * fwd + 26 * 512 * trained
