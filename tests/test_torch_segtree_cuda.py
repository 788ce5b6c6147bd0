"""The sum tree's CUDA kernels (tianshou_tpu_torch/csrc/segtree.cu, through
tianshou_tpu_torch/ops/segtree.py) against the plain loop on the card,
bitwise.

- At 100,096 slots (the 128 x 782 ring of ``nature_rainbow.replay``, a tree
  of 2^17 leaves) and at 48, for batches of 1, 128, 512 and 13,312: an
  update of distinct leaves (at most the slots) by flat index, by a ring's
  ``(env, pos)`` rows and by one 0-d value at each env's cursor leaves the
  whole tree bitwise the plain loop's; the draws' ``(env, pos, p)`` are the
  plain loop's, ``u`` at 0 and just below 1 included; the bare descent
  ``segtree_sample`` refuses a CUDA tensor (the card descends with
  ``segtree_draw``).
- A leaf outside the tree, by index, by row or by row stride, fails the
  update's launch: a process that makes such a call sees the next
  synchronising call raise, as the CPU raises ``IndexError``.
- Duplicate leaves: every internal node is exactly the sum of its children
  and each duplicated leaf holds one of its written values.
- ``PrioritizedReplayBuffer.sample_at`` in both ``weight_norm`` modes and
  ``update_priorities`` at the cell's ring are bitwise the plain path's (the
  plain loop run on the card's tensors).
- The kernels replay in a CUDA graph as they run eagerly, and a prioritized
  trainer's ``run()`` takes only the kernels (``segtree.route``).

Skipped without CUDA; on a card: ``python3 -m pytest --noconftest -q
tests/test_torch_segtree_cuda.py -m cuda``.  Imports no JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tianshou_tpu_torch.data import prio
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.ops import segtree as tseg
from tianshou_tpu_torch.utils import trace

# the rings: (num_envs, capacity), num_envs * capacity slots
RINGS = {100_096: (128, 782), 48: (4, 12)}
BELOW_ONE = np.nextafter(np.float32(1), np.float32(0))


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("the sum tree's kernels need an NVIDIA GPU")
    return torch.device("cuda")


def _f32(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)


def _i64(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(dev)


def _filled(slots: int, rng, dev) -> torch.Tensor:
    tree = tseg.segtree_init(slots, dev)
    tseg.segtree_update_plain(tree, torch.arange(slots, device=dev), _f32(rng.random(slots) + 0.01, dev))
    return tree


def _bitwise(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    diff = (got != want).nonzero()
    assert diff.numel() == 0, f"{what}: {diff.shape[0]} entries differ, the first at {diff[:4].flatten().tolist()}"


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 128, 512, 13_312])
@pytest.mark.parametrize("slots", list(RINGS))
def test_kernels_match_the_plain_loop_bitwise(slots, batch):
    dev = _card()
    rng = np.random.default_rng(slots + batch)
    envs, capacity = RINGS[slots]
    base = _filled(slots, rng, dev)
    n = min(batch, slots)
    flat = rng.choice(slots, n, replace=False)
    vals = _f32(rng.random(n) * 3, dev)
    cursor = rng.integers(0, capacity, envs)
    updates = {
        "flat": (lambda t: tseg.segtree_update(t, _i64(flat, dev), vals),
                 lambda t: tseg.segtree_update_plain(t, _i64(flat, dev), vals)),
        "rows": (lambda t: tseg.segtree_update(t, _i64(flat % capacity, dev), vals, rows=_i64(flat // capacity, dev),
                                               row_stride=capacity),
                 lambda t: tseg.segtree_update_plain(t, _i64(flat, dev), vals)),
        "add": (lambda t: tseg.segtree_update(t, _i64(cursor, dev), _f32(2.5, dev).reshape(()), row_stride=capacity),
                lambda t: tseg.segtree_update_plain(t, _i64(np.arange(envs) * capacity + cursor, dev),
                                                    _f32(2.5, dev).reshape(()))),
    }
    for name, (kernel_update, plain_update) in updates.items():
        kernel, plain = base.clone(), base.clone()
        before = tseg.segtree_update.launches
        assert kernel_update(kernel) is kernel
        plain_update(plain)
        torch.cuda.synchronize()
        assert tseg.segtree_update.launches == before + 1
        _bitwise(f"update ({name}) at {slots} slots, batch {n}", kernel, plain)

    tree = kernel  # the tree after the last update, the same on both routes
    u = _f32(np.concatenate([[0.0, BELOW_ONE], rng.random(batch)]), dev)
    before = tseg.segtree_draw.launches
    got = tseg.segtree_draw(tree, u, slots, capacity)
    want = tseg.segtree_draw_plain(tree, u, slots, capacity)
    assert tseg.segtree_draw.launches == before + 1
    for what, g, w in zip(("env", "pos", "p"), got, want):
        _bitwise(f"draw's {what} at {slots} slots, batch {batch}", g, w)
    with pytest.raises(ValueError):
        tseg.segtree_sample(tree, u * tseg.segtree_total(tree))


# each call runs in a process of its own: a trap leaves the process's CUDA
# context unusable
OUT_OF_TREE = {
    "index past the end": "tseg.segtree_update(tree, torch.tensor([3, 64], device='cuda'), torch.ones(2, device='cuda'))",
    "negative row": "tseg.segtree_update(tree, torch.tensor([0, 1], device='cuda'), torch.ones(2, device='cuda'), "
                    "rows=torch.tensor([1, -1], device='cuda'), row_stride=12)",
    "row stride past the end": "tseg.segtree_update(tree, torch.tensor([5, 5], device='cuda'), "
                               "torch.ones((), device='cuda'), row_stride=60)",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(OUT_OF_TREE))
def test_leaves_outside_the_tree_fail_the_launch(case):
    _card()
    code = (
        "import torch\n"
        "from tianshou_tpu_torch.ops import segtree as tseg\n"
        "tree = tseg.segtree_init(48, 'cuda')\n"
        "tseg.segtree_update(tree, torch.arange(48, device='cuda'), torch.ones(48, device='cuda'))\n"
        "torch.cuda.synchronize()\n"
        "try:\n"
        f"    {OUT_OF_TREE[case]}\n"
        "    torch.cuda.synchronize()\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n"
        "else:\n"
        "    print('nothing raised')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert "raised:" in proc.stdout, f"{case}: {proc.stdout}{proc.stderr[-2000:]}"


@pytest.mark.cuda
@pytest.mark.parametrize("slots", list(RINGS))
def test_duplicate_leaves_keep_every_sum(slots):
    dev = _card()
    rng = np.random.default_rng(slots)
    tree = _filled(slots, rng, dev)
    idx = rng.integers(0, slots, 4096)  # at 48 slots every leaf many times
    vals = rng.random(4096).astype(np.float32) + 2.0
    tseg.segtree_update(tree, _i64(idx, dev), _f32(vals, dev))
    cap = tseg.segtree_capacity(tree)
    n = torch.arange(1, cap, device=dev)
    _bitwise(f"internal nodes at {slots} slots", tree[n], tree[2 * n] + tree[2 * n + 1])
    leaves = tree[cap:].cpu().numpy()
    won = np.zeros(cap, bool)
    np.logical_or.at(won, idx, leaves[idx] == vals)
    assert won[np.unique(idx)].all(), "a duplicated leaf holds none of its written values"


def _ring_state(buffer: PrioritizedReplayBuffer, rng, dev):
    state = buffer.init(Batch(obs=torch.zeros(4), act=torch.zeros((), dtype=torch.int64), rew=torch.zeros(()),
                              terminated=torch.zeros((), dtype=torch.bool),
                              truncated=torch.zeros((), dtype=torch.bool), obs_next=torch.zeros(4)), device=dev)
    slots = buffer.num_envs * buffer.capacity
    tseg.segtree_update_plain(state.tree, torch.arange(slots, device=dev), _f32(rng.random(slots) + 0.01, dev))
    state.min_prio.fill_(0.05)
    state.max_prio.fill_(3.0)
    return state


def _plain_update(tree, idx, values, *, rows=None, row_stride=0):
    base = rows if rows is not None else torch.arange(idx.shape[0], device=idx.device)
    return tseg.segtree_update_plain(tree, base * row_stride + idx, values)


@pytest.mark.cuda
@pytest.mark.parametrize("weight_norm", [True, False])
def test_prioritized_buffer_on_the_kernels_equals_the_plain_path(weight_norm, monkeypatch):
    dev = _card()
    rng = np.random.default_rng(7)
    envs, capacity = RINGS[100_096]
    buffer = PrioritizedReplayBuffer(capacity, envs, alpha=0.5, beta=0.4, weight_norm=weight_norm)
    u = _f32(np.concatenate([[0.0, BELOW_ONE], rng.random(510)]), dev)
    flat = rng.choice(envs * capacity, 512, replace=False)
    env_idx, pos = _i64(flat // capacity, dev), _i64(flat % capacity, dev)
    td = _f32(rng.normal(size=512) * 2, dev)
    runs = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(prio, "segtree_draw", tseg.segtree_draw_plain)
            monkeypatch.setattr(prio, "segtree_update", _plain_update)
        s = _ring_state(buffer, np.random.default_rng(7), dev)
        drawn = buffer.sample_at(s, u)
        s = buffer.update_priorities(s, env_idx, pos, td)
        torch.cuda.synchronize()
        runs[route] = (*drawn, s.tree, s.max_prio, s.min_prio)
    names = ("env", "pos", "weight", "tree", "max_prio", "min_prio")
    for name, got, want in zip(names, runs["kernel"], runs["plain"]):
        _bitwise(f"{name} (weight_norm={weight_norm})", got, want)


@pytest.mark.cuda
def test_kernels_replay_in_a_cuda_graph():
    dev = _card()
    rng = np.random.default_rng(3)
    envs, capacity = RINGS[100_096]
    base = _filled(envs * capacity, rng, dev)
    u = _f32(rng.random(512), dev)

    def step(tree):
        env, pos, p = tseg.segtree_draw(tree, u, envs * capacity, capacity)
        tseg.segtree_update(tree, pos, p * 0.5, rows=env, row_stride=capacity)  # duplicates write one value
        return env, pos, p

    graphed, eager = base.clone(), base.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(graphed)  # builds and loads the library outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graphed.copy_(base)
    launches = (tseg.segtree_draw.launches, tseg.segtree_update.launches)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = step(graphed)
    assert (tseg.segtree_draw.launches, tseg.segtree_update.launches) == launches  # a capture launches nothing
    for _ in range(3):
        g.replay()
        want = step(eager)
    torch.cuda.synchronize()
    _bitwise("tree after 3 replays", graphed, eager)
    for what, a, b in zip(("env", "pos", "p"), out, want):
        _bitwise(f"replayed {what}", a, b)


@pytest.mark.cuda
def test_prioritized_trainer_runs_only_the_kernels(monkeypatch):
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    dev = _card()

    def refused(*args, **kwargs):
        raise AssertionError("a CUDA tree call took the plain loop")

    for name in ("segtree_update_plain", "segtree_sample_plain", "segtree_draw_plain"):
        monkeypatch.setattr(tseg, name, refused)
    env = CartPole()
    algo = DQN(QNet(4, (32,), 2), env.action_space, target_update_freq=50, device=dev)
    buffer = PrioritizedReplayBuffer(capacity=200, num_envs=4)
    trainer = OffPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, 4, device=dev), buffer, device=dev),
        Collector(algo, VectorEnv(env, 2, device=dev), device=dev), buffer, device=dev, max_epoch=2,
        step_per_epoch=64, step_per_collect=32, update_per_step=0.0625, batch_size=16, episode_per_test=2,
        warmup_steps=32, seed=0, train_param_fn=lambda e, s: 0.5)
    trace.clear()
    try:
        trainer.run()
        routes = {tag: n for (name, tag), n in trace.counters().items() if name == "segtree.route"}
    finally:
        trace.clear()
    print(f"segtree.route over a prioritized run(): {routes}")
    assert set(routes) == {"kernel"} and routes["kernel"] > 0
