"""Model FLOPs of a Rainbow superstep (``network.head.kind``
``dueling_noisy_c51``), counted from the configuration's shapes as
:mod:`benchmark.flops` counts DQN's: a multiply-add is two FLOPs; the
noise's composition into the noisy weights, the biases, activations,
softmax, projection, cross-entropy, sum tree and optimizer are not counted.

The layers are the Nature CNN's three convolutions and the noisy streams'
four matrix products over the 3,136 features (advantage: features ->
hidden -> ``A * num_atoms``; value: features -> hidden -> ``num_atoms``).
A trained sample costs a forward and a backward on ``obs`` (the backward
computes no gradient of the first convolution's input), the target
network's forward on ``obs_next`` and, with double Q-learning, the online
network's forward there too.  An acting step costs one forward.  Frozen
here so that the yardstick does not move with the program.
"""

from __future__ import annotations

__all__ = ["layers", "forward_flops", "trained_sample_flops", "superstep_flops"]


def layers(config: dict) -> list[tuple[int, int]]:
    """``(multiply-adds a sample, multiply-adds of the input gradient a
    sample)`` of each weight layer, the first convolution first."""
    net, env = config["network"], config["env"]
    head = net["head"]
    c, h, w = env["channels"], env["height"], env["width"]
    out = []
    for oc, k, s in net["convs"]:
        oh, ow = (h - k) // s + 1, (w - k) // s + 1
        macs = oh * ow * oc * k * k * c
        out.append((macs, macs))
        c, h, w = oc, oh, ow
    feat, hidden, atoms = c * h * w, head["hidden"], head["num_atoms"]
    for o in (env["num_actions"] * atoms, atoms):
        out += [(feat * hidden, feat * hidden), (hidden * o, hidden * o)]
    return out


def forward_flops(config: dict) -> int:
    """FLOPs of one forward of one sample."""
    return 2 * sum(m for m, _ in layers(config))


def trained_sample_flops(config: dict) -> int:
    """FLOPs of one sample of one update."""
    ls = layers(config)
    fwd = 2 * sum(m for m, _ in ls)
    bwd = fwd + 2 * sum(d for _, d in ls[1:])
    return fwd + bwd + (2 if config.get("is_double", True) else 1) * fwd


def superstep_flops(config: dict, traffic: dict) -> int:
    """FLOPs of one superstep: the rollout's acting forwards and the
    updates."""
    acting = traffic["num_envs"] * traffic["segment"] * forward_flops(config)
    return acting + traffic["updates"] * traffic["batch"] * trained_sample_flops(config)
