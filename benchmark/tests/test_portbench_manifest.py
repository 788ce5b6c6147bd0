"""BENCHMARK.json against the benchmark's contract, and every piece of a
cell found by name."""

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(TEXT.match(w) for w in m["command"])
    assert not any(w.startswith("/") or ".." in w for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    cells = len(m["workloads"])
    # a full check of 24 cells fits 43200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, cells // 4)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_keys():
    m = manifest()
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    cells = {w["name"] for w in m["workloads"]}
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["moves"] in e2e and TEXT.match(p["layer"])
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
        assert set(metric.get("workloads", cells)) <= cells
        names.append(metric["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_piece_found_by_name():
    from benchmark.harness import load_cell, load_reader

    m = manifest()
    used = set()
    for w in m["workloads"]:
        spec = load_cell(w["name"], m)
        assert spec["config"]["name"] == w["config"]
        assert {"num_envs", "segment", "updates", "batch", "capacity", "limits"} <= set(spec["traffic"])
        assert spec["end_to_end"] and spec["per_layer"]
        used.add(w["config"])
        for metric in spec["end_to_end"] + spec["per_layer"]:
            assert callable(load_reader(metric["name"]))
    for c in m["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and str(path.relative_to(ROOT)).startswith(tuple(m["paths"]))
        assert sorted(json.loads(path.read_text())["reduced"]) == sorted(c["reduced"])


def test_added_files_picked_up_without_edits(tmp_path):
    """A throwaway configuration, traffic mix and metric, added as new files
    and entries in a copy, are found with no file of the benchmark edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    cfg = json.loads((ROOT / "benchmark/configs/nature_dqn.json").read_text())
    cfg["name"] = "toy_dqn"
    (tmp_path / "benchmark/configs/toy_dqn.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "benchmark/traffic/nature_dqn.actors.json").read_text())
    traffic["num_envs"] = 7
    (tmp_path / "benchmark/traffic/toy_dqn.tiny.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/metrics/toy_metric.py").write_text("def read(run):\n    return 42.0\n")
    m["configs"].append({"name": "toy_dqn", "source": "https://example.org", "file": "benchmark/configs/toy_dqn.json",
                         "reduced": [], "why": "a throwaway"})
    m["workloads"].append({"name": "toy_dqn.tiny", "config": "toy_dqn", "traffic": "toy_dqn.tiny", "chips": 1,
                           "why": "a throwaway"})
    m["per_layer"].append({"name": "toy_metric", "unit": "x", "better": "higher", "source": "host_clock",
                           "layer": "trainer", "moves": "env_steps_per_s", "workloads": ["toy_dqn.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import json; from benchmark.harness import load_cell, load_reader; "
            "s = load_cell('toy_dqn.tiny', json.load(open('BENCHMARK.json'))); "
            "print(s['config']['name'], s['traffic']['num_envs'], [x['name'] for x in s['per_layer']][-1], "
            "load_reader('toy_metric')(None))")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["toy_dqn", "7", "toy_metric", "42.0"]
    for p in (ROOT / "benchmark").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            copy = tmp_path / p.relative_to(ROOT)
            assert copy.read_bytes() == p.read_bytes(), p
