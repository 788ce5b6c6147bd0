"""``run.py`` as the driver starts it: no result without a card, none from a
folder that holds only the benchmark; on a card, one short run."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

ARGS = ["--workload", "nature_dqn.actors", "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"]


def _run(cwd, timeout=300):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = _run(ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
