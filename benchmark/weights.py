"""The Q-network's initial weights, made by the benchmark from the seed and
handed alike to the program and to the reference.

Every weight is a normal draw clipped at two standard deviations and scaled
by ``gain / sqrt(fan_in)``; biases are zero.  One draw on the device covers
all weights, sliced leaf by leaf in the order of :func:`spec`, whose names
are the program's parameter names.
"""

from __future__ import annotations

import math

import torch

__all__ = ["spec", "make_weights", "weight_seed"]


def weight_seed(seed: int) -> int:
    """The weights' stream, apart from the trainer's, which takes ``seed``
    itself."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x5DEECE66D) % (1 << 63)


def spec(config: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """``(name, shape, std)`` of every parameter; ``std`` 0 for a bias."""
    net, env = config["network"], config["env"]
    out: list[tuple[str, tuple[int, ...], float]] = []
    if net["kind"] == "nature_cnn":
        c, h, w = env["channels"], env["height"], env["width"]
        for i, (oc, k, s) in enumerate(net["convs"]):
            out.append((f"encoder.convs.{i}.weight", (oc, c, k, k), 1.0 / math.sqrt(c * k * k)))
            out.append((f"encoder.convs.{i}.bias", (oc,), 0.0))
            c, h, w = oc, (h - k) // s + 1, (w - k) // s + 1
        flat = c * h * w
        out.append(("encoder.dense.weight", (net["hidden"], flat), 1.0 / math.sqrt(flat)))
        out.append(("encoder.dense.bias", (net["hidden"],), 0.0))
        out.append(("head.weight", (env["num_actions"], net["hidden"]), 1.0 / math.sqrt(net["hidden"])))
        out.append(("head.bias", (env["num_actions"],), 0.0))
    elif net["kind"] == "mlp":
        sizes = [env["obs_dim"], *net["hidden_sizes"], env["num_actions"]]
        last = len(sizes) - 2
        for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
            gain = 1.0 if i == last else math.sqrt(2.0)
            out.append((f"mlp.layers.{i}.weight", (fo, fi), gain / math.sqrt(fi)))
            out.append((f"mlp.layers.{i}.bias", (fo,), 0.0))
    else:
        raise ValueError(f"no weights for network kind {net['kind']!r}")
    return out


def make_weights(config: dict, seed: int, device: str | torch.device) -> dict[str, torch.Tensor]:
    """float32 ``name -> tensor`` on ``device``, from one normal draw of a
    generator on ``device`` seeded by :func:`weight_seed`."""
    leaves = spec(config)
    g = torch.Generator(device=device)
    g.manual_seed(weight_seed(seed))
    total = sum(math.prod(shape) for _, shape, std in leaves if std)
    flat = torch.randn((total,), generator=g, device=device, dtype=torch.float32).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        if std:
            out[name] = flat[at:at + n].view(shape).mul(std)
            at += n
        else:
            out[name] = torch.zeros(shape, device=device, dtype=torch.float32)
    return out
