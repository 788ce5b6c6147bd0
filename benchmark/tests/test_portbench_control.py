"""The control on the card at each cell's own size: the reference computed
one precision below the configuration's (fp8 below bfloat16, TF32 below
float32) and put in the program's place fails the comparison, while the
program passes it, on three seeds."""

import json

import pytest

from benchmark.tests.conftest import manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.calibrate import readings
    from benchmark.compare import decide
    from benchmark.harness import load_cell

    spec = load_cell(cell, manifest())
    limits = spec["traffic"]["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        r = readings(spec, seed, "cuda")
        assert decide(r["program"], limits)[0], json.dumps(r)
        training = {k: v for k, v in limits.items() if k in r["control"]}
        assert not decide(r["control"], training)[0], json.dumps(r)
        assert not decide(r["half_batch"], training)[0], json.dumps(r)
        assert not decide(r["random_acts"], {"act_gap": limits["act_gap"]})[0], json.dumps(r)
