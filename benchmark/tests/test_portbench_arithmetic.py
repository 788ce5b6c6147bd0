"""The yardstick's arithmetic: FLOPs from shapes, the gather bound and the
distinct rows a presample reads."""

import importlib.util
import json

import pytest
import torch

from benchmark import flops, roofline
from benchmark.tests.conftest import ROOT


def _config(name):
    return json.loads((ROOT / "benchmark/configs" / f"{name}.json").read_text())


def _gather_reader():
    spec = importlib.util.spec_from_file_location("gather_roofline", ROOT / "benchmark/metrics/gather_roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_flops_from_shapes():
    nature, mlp = _config("nature_dqn"), _config("mlp_dqn")
    assert flops.forward_flops(nature) == 18_692_096  # 18.69 MFLOP
    assert round(flops.trained_sample_flops(nature) / 1e6, 1) == 86.9
    assert flops.forward_flops(mlp) == 67_072  # 67.1 kFLOP
    traffic = json.loads((ROOT / "benchmark/traffic/nature_dqn.replay.json").read_text())
    assert flops.superstep_flops(nature, traffic) == 26 * 512 * flops.trained_sample_flops(nature) + 2048 * 18_692_096


def test_gather_bound():
    t, what = roofline.gather_bound_s(7056, 53_248, 41_300)
    assert what == "bytes"
    assert t == pytest.approx((41_300 * 7056 + 53_248 * 7056 * 2 + 53_248 * 8) / 3.35e12)
    # writing two bytes a row element outweighs one conversion an element
    assert roofline.gather_bound_s(10**6, 1, 0)[1] == "bytes"


@pytest.mark.parametrize("rows, draws, span", [(100_096, 13_312, 4), (100_352, 3_072, 4), (5_000, 4_000, 4)])
def test_expected_distinct_matches_counted_draws(rows, draws, span):
    """The expectation against the distinct rows that uniform stacks of
    ``span`` consecutive rows of a ring actually touch, averaged over
    draws."""
    g = torch.Generator().manual_seed(rows + draws)
    counts = []
    for _ in range(20):
        start = torch.randint(0, rows, (draws,), generator=g)
        touched = (start[:, None] - torch.arange(span)[None]) % rows
        counts.append(torch.unique(touched).numel())
    counted = sum(counts) / len(counts)
    assert _gather_reader().expected_distinct(rows, draws, span) == pytest.approx(counted, rel=0.01)
