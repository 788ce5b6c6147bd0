"""Model FLOPs of a DQN superstep, counted from the configuration's shapes
(a multiply-add is two FLOPs; biases, activations and the optimizer are not
counted).

A trained sample costs a forward and a backward on ``obs`` (the backward
computes no gradient of the first layer's input), the target network's
forward on ``obs_next`` and, with double Q-learning, the online network's
forward there too.  An acting step costs one forward.  Recomputation is not
counted.  Frozen here so that the yardstick does not move with the
program.
"""

from __future__ import annotations

__all__ = ["layers", "forward_flops", "trained_sample_flops", "superstep_flops"]


def layers(config: dict) -> list[tuple[int, int]]:
    """``(multiply-adds a sample, multiply-adds of the input gradient a
    sample)`` of each weight layer of ``config``'s Q-network, input first."""
    net, env = config["network"], config["env"]
    out: list[tuple[int, int]] = []
    if net["kind"] == "nature_cnn":
        c, h, w = env["channels"], env["height"], env["width"]
        for oc, k, s in net["convs"]:
            oh, ow = (h - k) // s + 1, (w - k) // s + 1
            macs = oh * ow * oc * k * k * c
            out.append((macs, macs))  # the input gradient is a transposed convolution of the same size
            c, h, w = oc, oh, ow
        sizes = [h * w * c, net["hidden"], env["num_actions"]]
    elif net["kind"] == "mlp":
        sizes = [env["obs_dim"], *net["hidden_sizes"], env["num_actions"]]
    else:
        raise ValueError(f"no FLOP count for network kind {net['kind']!r}")
    out.extend((i * o, i * o) for i, o in zip(sizes[:-1], sizes[1:]))
    return out


def forward_flops(config: dict) -> int:
    """FLOPs of one forward of one sample."""
    return 2 * sum(m for m, _ in layers(config))


def trained_sample_flops(config: dict) -> int:
    """FLOPs of one sample of one update: forward and backward on ``obs``
    (no input gradient at the first layer), and the forwards on
    ``obs_next``."""
    ls = layers(config)
    fwd = 2 * sum(m for m, _ in ls)
    bwd = 2 * sum(m for m, _ in ls) + 2 * sum(d for _, d in ls[1:])
    next_forwards = 2 if config.get("is_double", True) else 1
    return fwd + bwd + next_forwards * fwd


def superstep_flops(config: dict, traffic: dict) -> int:
    """FLOPs of one superstep: the rollout's acting forwards and the
    updates."""
    acting = traffic["num_envs"] * traffic["segment"] * forward_flops(config)
    return acting + traffic["updates"] * traffic["batch"] * trained_sample_flops(config)
