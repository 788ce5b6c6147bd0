"""Plain PyTorch reference of a double-DQN superstep's learning half, over
the ring, in float32 (TF32 off).

It takes the benchmark's initial weights (:mod:`benchmark.weights`), the
ring as the program held it after each followed superstep and the state of
the generator that superstep sampled from, and works the rest out itself:
the replay indices (uniform over every stored transition, drawn from that
generator state), frame stacks rebuilt along each env's episode-aware
``prev`` chain, n-step chains along its ``next`` chain, the bootstrap at the
chain's end (double Q: the online network picks the action, the target
network values it, masked where the episode terminated), the squared TD
loss over each update's slice of the indices, Adam, and the periodic target
copy.  It imports nothing of the program.

Every argmax (the double-Q action and the greedy action the rollouts are
held to) is decided in the configuration's compute precision: for a
bfloat16 encoder, the encoder's inputs, weights and biases are cast to
bfloat16 for it (:func:`decide_mode`).  A float32 argmax flips near-ties
that the configuration's rounding decides otherwise, and one flipped
bootstrap moves a whole update (PERF.md, section 6).  The values, losses,
gradients and optimizer steps stay float32.

``mode`` puts the reference in the program's place at another precision:
``"fp8"`` (each encoder layer's input and weight rounded to float8 e4m3 with
a per-tensor scale, straight through in the backward) and ``"tf32"`` (TF32
on) are the controls, and ``"bf16"`` is the configuration's own precision
throughout (:func:`precision_mode`): the scale of the configuration's
rounding, against which the replays' gradients are judged
(:mod:`benchmark.compare`).  ``half_batch``
drops the second half of every update's batch and ``random_acts`` the
rollouts' actions (planted faults).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark.reference.envs import acting_obs, check_ring
from benchmark.weights import make_weights

__all__ = ["forward", "precision_mode", "decide_mode", "draw_indices", "gather", "follow", "check_ring"]

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def forward(params: dict, x: torch.Tensor, config: dict, mode: str = "fp32") -> torch.Tensor:
    """Q-values ``[B, A]`` in float32 for observations ``x`` (``[B, S, H, W]``
    uint8 stacks or ``[B, obs_dim]`` floats)."""
    q = {"fp8": _fp8, "bf16": _bf16}.get(mode, lambda t: t)
    qb = _bf16 if mode == "bf16" else (lambda t: t)  # fp8 keeps float32 biases
    net = config["network"]
    x = x.to(torch.float32)
    if net["kind"] == "nature_cnn":
        for i, (_, _, stride) in enumerate(net["convs"]):
            w, b = params[f"encoder.convs.{i}.weight"], params[f"encoder.convs.{i}.bias"]
            x = F.relu(F.conv2d(q(x), q(w), qb(b), stride=stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # the (h, w, c) flatten
        x = F.relu(F.linear(q(x), q(params["encoder.dense.weight"]), qb(params["encoder.dense.bias"])))
        return F.linear(x.to(torch.float32), params["head.weight"], params["head.bias"])
    layers = len(net["hidden_sizes"]) + 1
    for i in range(layers):
        x = F.linear(x, params[f"mlp.layers.{i}.weight"], params[f"mlp.layers.{i}.bias"])
        if i < layers - 1:
            x = F.relu(x)
    return x


def precision_mode(config: dict) -> str:
    """The mode of :func:`forward` that computes in the configuration's
    compute precision: ``"bf16"`` for a bfloat16 encoder, else ``"fp32"``."""
    if config["network"]["kind"] == "nature_cnn" and config["compute_dtype"] == "bfloat16":
        return "bf16"
    return "fp32"


def decide_mode(config: dict, mode: str) -> str:
    """The precision in which ``mode``'s argmaxes are decided: the
    configuration's compute precision for the float32 reference, else the
    mode's own."""
    return precision_mode(config) if mode == "fp32" else mode


@contextlib.contextmanager
def _precision(mode: str):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Ring:
    """One env-major ring ``[N, C, ...]`` with its cursors and sizes and the
    episode-aware position arithmetic."""

    def __init__(self, ring: dict, device):
        self.s = {k: v.to(device) for k, v in ring["storage"].items()}
        self.cursor, self.size = ring["cursor"].to(device), ring["size"].to(device)
        self.capacity = self.s["act"].shape[1]
        self.done = self.s["terminated"] | self.s["truncated"]

    def next(self, e, p):
        newest = torch.remainder(self.cursor[e] - 1, self.capacity)
        return torch.where(self.done[e, p] | (p == newest), p, torch.remainder(p + 1, self.capacity))

    def prev(self, e, p):
        oldest = torch.remainder(self.cursor[e] - self.size[e], self.capacity)
        q = torch.remainder(p - 1, self.capacity)
        return torch.where(self.done[e, q] | (p == oldest), p, q)

    def obs(self, e, p, stack: int, key: str = "obs"):
        if stack == 1:
            return self.s[key][e, p]
        chain = [p]
        for _ in range(stack - 1):
            chain.append(self.prev(e, chain[-1]))
        chain = torch.stack(chain[::-1], dim=1)
        return self.s[key][e[:, None].expand_as(chain), chain]


def draw_indices(ring: Ring, generator_state: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` replay indices ``(env, pos)`` drawn from a generator in
    ``generator_state``: uniform over every stored transition of every env,
    one float64 uniform a draw scaled by the count, the envs in order and
    each env's transitions oldest first (the arithmetic of
    ``tianshou_tpu_torch/data/buffer.py``, ``ReplayBuffer.sample_indices``,
    frozen here)."""
    dev = ring.cursor.device
    g = torch.Generator(device=dev)
    g.set_state(generator_state)
    sizes = ring.size.to(torch.int64)
    ends = torch.cumsum(sizes, 0)
    total = max(int(ends[-1]), 1)
    u = torch.rand((n,), generator=g, device=dev, dtype=torch.float64)
    flat = torch.clamp((u * total).to(torch.int64), max=total - 1)
    env = torch.searchsorted(ends, flat, right=True)
    age = flat - (ends[env] - sizes[env])
    oldest = torch.remainder(ring.cursor[env].to(torch.int64) - sizes[env], ring.capacity)
    return env, torch.remainder(oldest + age, ring.capacity)


def gather(ring: Ring, e: torch.Tensor, p: torch.Tensor, config: dict) -> dict:
    """The sampled transitions: ``obs``, ``act``, the n-step ``rew`` and
    ``done`` chains, and ``obs_next`` and ``terminated`` at the chain's
    end."""
    stack = config.get("frames_stack", 1) if config.get("save_only_last_obs", False) else 1
    out = {"obs": ring.obs(e, p, stack), "act": ring.s["act"][e, p]}
    rews, dones, cur = [], [], p
    for _ in range(config["n_step"]):
        rews.append(ring.s["rew"][e, cur])
        dones.append(ring.done[e, cur])
        cur = ring.next(e, cur)
    out["rew"], out["done"] = torch.stack(rews, 1), torch.stack(dones, 1)
    if config.get("ignore_obs_next", False):
        out["obs_next"] = ring.obs(e, ring.next(e, cur), stack)
    else:
        out["obs_next"] = ring.s["obs_next"][e, cur]
    out["terminated"] = ring.s["terminated"][e, cur]
    return out


def nstep_target(rew: torch.Tensor, done: torch.Tensor, q_end: torch.Tensor, terminated: torch.Tensor,
                 gamma: float) -> torch.Tensor:
    """``sum_{j<m} gamma^j r_j + gamma^m q_end (1 - terminated)``, ``m`` the
    chain's length up to and including its first episode end."""
    n = rew.shape[1]
    any_done = done.any(1)
    m = torch.where(any_done, done.to(torch.int64).argmax(1) + 1, n)
    j = torch.arange(n, device=rew.device)
    disc = torch.pow(torch.tensor(gamma, dtype=torch.float64, device=rew.device), j.to(torch.float64))
    ret = ((j[None] < m[:, None]) * rew.to(torch.float64) * disc[None]).sum(1)
    boot = gamma ** m.to(torch.float64) * q_end.to(torch.float64) * (~terminated).to(torch.float64)
    return (ret + boot).to(torch.float32)


def greedy_agreement(params: dict, ring: "Ring", config: dict, traffic: dict, mode: str,
                     random_acts: bool = False) -> int:
    """How many of the actions that the superstep's rollout wrote (the last
    ``segment`` rows of every env) equal the reference's greedy action on
    the observation they were taken on, under ``params`` (those the rollout
    acted with).  ``random_acts`` puts uniform random actions in the
    rollout's place (a planted fault)."""
    seg, cap = traffic["segment"], ring.capacity
    t = torch.arange(seg, device=ring.cursor.device)
    pos = torch.remainder(ring.cursor[:, None] - seg + t[None], cap)  # [N, T]
    env = torch.arange(pos.shape[0], device=pos.device)[:, None].expand_as(pos)
    e, p = env.reshape(-1), pos.reshape(-1)
    agree = 0
    with torch.no_grad():
        for lo in range(0, e.numel(), 4096):
            ee, pp = e[lo:lo + 4096], p[lo:lo + 4096]
            obs = acting_obs(config, ring.s["obs"][ee, pp])
            greedy = forward(params, obs, config, decide_mode(config, mode)).argmax(-1)
            acted = ring.s["act"][ee, pp].to(torch.int64)
            if random_acts:
                acted = torch.randint(0, config["env"]["num_actions"], acted.shape, device=acted.device)
            agree += int((greedy == acted).sum())
    return agree


def _start(snapshots: list[dict], s: int, w0: dict, device) -> tuple:
    """The state superstep ``s`` (0-based) starts from: the benchmark's
    weights and a fresh Adam before the first, else the program's state
    after the one before."""
    if s == 0:
        zeros = {n: torch.zeros_like(w) for n, w in w0.items()}
        return ({n: w.clone() for n, w in w0.items()}, {n: w.clone() for n, w in w0.items()}, zeros,
                {n: z.clone() for n, z in zeros.items()}, 0, 0)
    prev = snapshots[s - 1]

    def dev(d):
        return {n: t.to(device=device, dtype=torch.float32, copy=True) for n, t in d.items()}

    return (dev(prev["online"]), dev(prev["target"]), dev(prev["exp_avg"]), dev(prev["exp_avg_sq"]),
            int(prev["adam_step"][0]), prev["device_step"])


def follow(config: dict, traffic: dict, seed: int, snapshots: list[dict], device, mode: str = "fp32",
           half_batch: bool = False, random_acts: bool = False, argmax: str | None = None) -> dict:
    """Each followed superstep worked out again from the state it started
    from (:func:`_start`): ``steps``, one dict a superstep with the first
    update's ``loss1`` and ``grads1`` and the parameters' change ``delta``
    (online and target leaves); ``act_gap``, the share
    of the rollouts' actions equal to the reference's greedy action under
    the parameters they acted with, less the share that epsilon-greedy
    acting gives (``1 - eps + eps / A``), in absolute value;
    ``index_faults``, the replay indices the program's presample returned
    that differ from the reference's own draw; and the ``initial``
    weights.  ``argmax`` overrides the precision of the double-Q argmax
    (the look behind the limits)."""
    w0 = make_weights(config, seed, device)
    k, batch = traffic["updates"], traffic["batch"]
    rows = batch // 2 if half_batch else batch
    lr, gamma, freq = config["lr"], config["gamma"], config["target_update_freq"]
    actions = config["env"]["num_actions"]
    pick = argmax or decide_mode(config, mode)
    agree = expected = total = 0.0
    faults = 0
    out = {"steps": [], "initial": {n: w.detach().to("cpu", copy=True) for n, w in w0.items()}}
    with _precision(mode):
        for s, snap in enumerate(snapshots):
            online, target, m, v, step, count = _start(snapshots, s, w0, device)
            start = {**{f"online.{n}": t.clone() for n, t in online.items()},
                     **{f"target.{n}": t.clone() for n, t in target.items()}}
            params = {n: t.requires_grad_(True) for n, t in online.items()}
            ring = Ring(snap["ring"], device)
            acted = traffic["num_envs"] * traffic["segment"]
            agree += greedy_agreement(params, ring, config, traffic, mode, random_acts)
            expected += acted * (1.0 - snap["eps"] + snap["eps"] / actions)
            total += acted
            env_idx, pos = draw_indices(ring, snap["sample_state"], k * batch)
            faults += int(((env_idx.cpu() != snap["env_idx"]) | (pos.cpu() != snap["pos"])).sum())
            data = gather(ring, env_idx, pos, config)
            del ring
            loss1 = grads1 = None
            for u in range(k):
                sl = slice(u * batch, u * batch + rows)
                with torch.no_grad():
                    nxt = data["obs_next"][sl]
                    a_star = forward(params, nxt, config, pick).argmax(-1, keepdim=True)
                    q_end = forward(target, nxt, config, mode).gather(-1, a_star).squeeze(-1)
                    y = nstep_target(data["rew"][sl], data["done"][sl], q_end, data["terminated"][sl], gamma)
                q = forward(params, data["obs"][sl], config, mode)
                q = q.gather(-1, data["act"][sl].to(torch.int64)[:, None]).squeeze(-1)
                loss = (q - y).pow(2).mean()
                grads = torch.autograd.grad(loss, list(params.values()))
                if grads1 is None:
                    loss1 = float(loss.detach())
                    grads1 = {n: g.to("cpu", copy=True) for n, g in zip(params, grads)}
                step += 1
                count += 1
                with torch.no_grad():
                    bc1, bc2 = 1 - BETA1 ** step, 1 - BETA2 ** step
                    for (name, p), g in zip(params.items(), grads):
                        m[name].mul_(BETA1).add_(g, alpha=1 - BETA1)
                        v[name].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                        p.sub_(lr * (m[name] / bc1) / ((v[name] / bc2).sqrt() + ADAM_EPS))
                    if freq > 0 and count % freq == 0:
                        target = {n: p.detach().clone() for n, p in params.items()}
            end = {**{f"online.{n}": p.detach() for n, p in params.items()},
                   **{f"target.{n}": t for n, t in target.items()}}
            out["steps"].append({"loss1": loss1, "grads1": grads1,
                                 "delta": {n: (end[n] - start[n]).to("cpu", copy=True) for n in start}})
            del data
    out["act_gap"] = abs(agree - expected) / total
    out["index_faults"] = faults
    return out
