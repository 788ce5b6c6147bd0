"""Pixel Rainbow (the Nature CNN's features, dueling noisy C51 streams,
prioritized replay on the deduplicated ring) at a small size on the CPU,
against the benchmark's plain reference (``benchmark/reference/rainbow.py``)
with the benchmark's seeded weights loaded into both: 36x36x4 frames,
16-unit noisy streams, 11 atoms, batch 8.

- ``ConvC51Net``'s probabilities with given noise and with ``noise=None``;
- one ``Rainbow.update`` on a ``PrioritizedReplayBuffer`` with
  ``save_only_last_obs``, ``ignore_obs_next`` and ``stack_num=4``: the
  drawn slots, the loss, the gradients and the written priorities;
- ``NatureCNN(hidden=None)`` against the features that ``hidden=512``
  feeds its dense layer;
- the prioritized ring's stacks and next stacks equal the uniform ring's
  at the same slots.
"""

import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import rainbow as reference
from benchmark.reference.dqn import Ring
from benchmark.reference.rainbow import make_weights, noise_sizes
from tianshou_tpu_torch.algos.c51 import Rainbow
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.synthetic import SyntheticPixelEnv
from tianshou_tpu_torch.networks import conv
from tianshou_tpu_torch.networks.discrete import ConvC51Net, draw_noise
from tianshou_tpu_torch.utils.device import make_generator

SIZE, ACTIONS, ATOMS, HIDDEN, BATCH = 36, 6, 11, 16, 8
SEED = 2**31 + 21
CONFIG = {
    "env": {"kind": "synthetic_pixel", "height": SIZE, "width": SIZE, "channels": 4, "num_actions": ACTIONS,
            "episode_len": 10, "channel_first": True},
    "network": {"kind": "nature_cnn", "convs": [[32, 8, 4], [64, 4, 2], [64, 3, 1]], "hidden": 512,
                "head": {"kind": "dueling_noisy_c51", "hidden": HIDDEN, "num_atoms": ATOMS, "v_min": -10.0,
                         "v_max": 10.0, "noisy_std": 0.1}},
    "compute_dtype": "float32", "gamma": 0.99, "n_step": 3, "frames_stack": 4, "save_only_last_obs": True,
    "ignore_obs_next": True, "alpha": 0.5,
}


def _env() -> SyntheticPixelEnv:
    return SyntheticPixelEnv(SIZE, SIZE, 4, ACTIONS, episode_len=10, channel_first=True)


def _net() -> ConvC51Net:
    return ConvC51Net((4, SIZE, SIZE), ACTIONS, ATOMS, HIDDEN, noisy_std=0.1,
                      encoder_kwargs={"compute_dtype": torch.float32})


def _load(net: torch.nn.Module, weights: dict) -> None:
    named = dict(net.named_parameters())
    assert set(named) == set(weights)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])


def test_probabilities_match_the_reference():
    weights = make_weights(CONFIG, SEED, "cpu")
    net = _net()
    _load(net, weights)
    obs = torch.randint(0, 256, (5, 4, SIZE, SIZE), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    noise = draw_noise(net, torch.Generator().manual_seed(2))
    # module order: the advantage stream's two layers, then the value stream's
    assert [t.numel() for pair in noise for t in pair] == noise_sizes(CONFIG)
    for n in (noise, None):
        got = net(obs, n)
        assert got.shape == (5, ACTIONS, ATOMS) and got.dtype == torch.float32
        torch.testing.assert_close(got, reference.forward(weights, obs, CONFIG, "fp32", n), rtol=1e-5, atol=1e-6)
    assert not torch.allclose(net(obs, noise), net(obs, None))


def _filled(buffer, steps: int):
    """``buffer`` filled by ``steps`` random steps of 4 synthetic envs, and
    an algorithm and train state on the benchmark's weights."""
    env = _env()
    algo = Rainbow(_net(), env.action_space, num_atoms=ATOMS, lr=6.25e-5, gamma=0.99, n_step=3,
                   target_update_freq=500, device="cpu")
    ts = algo.init(make_generator(0, "cpu"))
    weights = make_weights(CONFIG, SEED, "cpu")
    _load(ts.online, weights)
    _load(ts.target, weights)
    col = Collector(algo, VectorEnv(env, 4, device="cpu"), buffer, device="cpu")
    cstate = col.reset(make_generator(1, "cpu"))
    bstate = buffer.init(col.example_transition(ts, cstate), device="cpu")
    _, bstate, _, _ = col.collect(ts, cstate, bstate, steps, random=True)
    return algo, ts, bstate, weights


def _host_ring(bstate) -> dict:
    return {"storage": dict(bstate.storage), "cursor": bstate.cursor.clone(), "size": bstate.size.clone()}


def test_one_update_on_the_prioritized_deduplicated_ring():
    buffer = PrioritizedReplayBuffer(16, 4, stack_num=4, alpha=0.5, beta=0.4, weight_norm=True,
                                     save_only_last_obs=True, ignore_obs_next=True)
    algo, ts, bstate, weights = _filled(buffer, 24)  # wrapped, with episode ends
    assert bstate.storage["obs"].shape == (4, 16, SIZE, SIZE) and "obs_next" not in bstate.storage
    g = torch.Generator().manual_seed(3)
    bstate = buffer.update_priorities(bstate, torch.arange(4).repeat(4), torch.arange(16),
                                      torch.rand(16, generator=g) * 4)
    leaves = bstate.tree[bstate.tree.shape[0] // 2:][:64].clone()
    ring = _host_ring(bstate)
    state = g.get_state()
    drawn, grads = [], {}
    names = {p: n for n, p in ts.online.named_parameters()}
    ts.optimizer.register_step_pre_hook(lambda opt, a, k: grads.update(
        {names[p]: p.grad.clone() for group in opt.param_groups for p in group["params"]}))
    presample = algo.presample

    def spy(*args):
        out = presample(*args)
        drawn.append(out[0] * 16 + out[1])
        return out

    algo.presample = spy
    ts, bstate, metrics = algo.update(ts, buffer, bstate, g, BATCH)
    g.set_state(state)
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()}
    ref = reference.update_step(params, weights, Ring(ring, "cpu"), leaves, g, drawn[0], CONFIG, 0.4)
    assert ref["faults"] == 0 and torch.equal(ref["flat"], drawn[0])
    torch.testing.assert_close(metrics["loss"], ref["loss"], rtol=1e-5, atol=1e-6)
    for name, r in zip(params, ref["grads"]):
        torch.testing.assert_close(grads[name], r, rtol=1e-4, atol=1e-6, msg=name)
    written = bstate.tree[bstate.tree.shape[0] // 2:][drawn[0]]
    torch.testing.assert_close(written, (ref["ce"] + 1e-6) ** 0.5, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nature_cnn_features_without_the_dense_layer(dtype, monkeypatch):
    full = conv.NatureCNN((4, SIZE, SIZE), compute_dtype=dtype)
    bare = conv.NatureCNN((4, SIZE, SIZE), hidden=None, compute_dtype=dtype)
    assert bare.dense is None and bare.out_features == 64 and full.out_features == 512
    bare.convs.load_state_dict(full.convs.state_dict())
    seen = []
    linear = F.linear

    def spy(x, *args):
        seen.append(x)
        return linear(x, *args)

    monkeypatch.setattr(conv.F, "linear", spy)
    obs = torch.randint(0, 256, (3, 4, SIZE, SIZE), dtype=torch.uint8, generator=torch.Generator().manual_seed(4))
    full(obs)
    out = bare(obs)
    assert len(seen) == 1 and out.dtype == torch.float32
    assert torch.equal(out, seen[0].to(torch.float32))


def test_prioritized_stacks_equal_the_uniform_rings():
    rings = {}
    for kind in (ReplayBuffer, PrioritizedReplayBuffer):
        buffer = kind(16, 4, stack_num=4, save_only_last_obs=True, ignore_obs_next=True)
        rings[kind] = (buffer, _filled(buffer, 27)[2])
    env = torch.arange(4).repeat_interleave(16)
    pos = torch.arange(16).repeat(4)
    for dtype in (None, torch.bfloat16):
        got = [b.get(s, env, pos, keys=("obs", "obs_next", "act"), dtypes={"obs": dtype, "obs_next": dtype})
               for b, s in rings.values()]
        for key in ("obs", "obs_next", "act"):
            assert got[0][key].shape[:2] == ((64, 4) if key != "act" else (64,))
            assert torch.equal(got[0][key], got[1][key]), key
