"""Run one cell of ``BENCHMARK.json`` on one NVIDIA H100 and print its result.

    python3 benchmark/run.py --workload nature_dqn.replay --seed 7 --seconds 20 --trace 0

The last line of standard output is the result: ``correct``, ``attempted``
(the window's supersteps), ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` also ``breakdown``, and last ``checks``: each number of the comparison
with its limit, which also close standard error.  Without CUDA, or with
fewer cards than the cell asks for, it exits 2 and prints no result; if a
module of JAX or of the JAX package was loaded, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache of the run at a fixed path inside the checkout
    cache = ROOT / "build" / "bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # the checkout's root, not this folder: its modules are imported as benchmark.*
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT)] + [q for q in sys.path if Path(q or ".").resolve() != here]
    import torch

    from benchmark.harness import forbidden_loaded, load_cell, run_cell

    spec = load_cell(args.workload, json.loads((ROOT / "BENCHMARK.json").read_text()))
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_loaded()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card: {_card()}; memory_peak_bytes {result['device']['memory_peak_bytes']}", file=sys.stderr)
    print(f"window: {json.dumps(result['window'])}; set-up: {json.dumps(result['setup_parts_s'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
