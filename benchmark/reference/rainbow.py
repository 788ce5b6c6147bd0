"""Plain PyTorch reference of a Rainbow superstep's learning half over the
prioritized ring, in float32 (TF32 off).

The network (Hessel et al. 2018; Tianshou's Atari ``Rainbow``): the Nature
CNN's three convolutions (``F.conv2d``, NCHW), the flattened features in
``(h, w, c)`` order, and two streams of two noisy layers each, advantage
and value, whose weights are ``w_mu + w_sigma * f(eps_out) f(eps_in)^T``
with ``f(e) = sign(e) sqrt|e|`` (biases ``b_mu + b_sigma * f(eps_out)``),
combined as ``a - mean_a(a) + v`` and normalised by a softmax over the
atoms.  An update: proportional draws over the sum tree's leaves (float64
prefix sums and ``searchsorted``), importance weights ``p^-beta / max
p^-beta``, frame stacks and n-step chains along the ring's episode-aware
chains (:mod:`benchmark.reference.dqn`), the target distribution of the
target network at the chain's end for the action the online network picks
(double Q), shifted by the n-step return and projected onto the support
(Bellemare et al. 2017, algorithm 1, as a sum of each shifted atom's
triangular weights on its neighbours: no scatter), the importance-weighted
cross-entropy of the taken action's distribution, Adam, the periodic
target copy, and the priorities ``(ce + 1e-6)^alpha``.  It imports nothing
of the program.

Each followed superstep is worked out from the state before it, as
:mod:`benchmark.reference.dqn` does: the benchmark's weights
(:func:`make_weights`) and a fresh Adam before the first, the
program's state after the one before for the others.  The tree before a
superstep's updates is the fill's before the first (every stored slot at
``1^alpha``, the initial ``max_prio``), else the tree of the snapshot
before it with the rollout's new slots at that snapshot's
``max_prio^alpha``.  The reference redraws from the recorded generator
states, in the program's order, the rollout's acting noise (a draw of
every noisy layer and the envs' reset draw a step) and each update's
uniforms, the target network's noise and the online network's noise.

Departures from the published description, each with its reason:

- the features are flattened in Flax's ``(h, w, c)`` order, and the frames
  are not scaled by 1/255: the port's Nature CNN does neither (the
  weights come from the seed, so the function class is the same);
- the n-step chain's end is the port's (``next`` walked ``n_step`` times
  from the sampled slot), as in :mod:`benchmark.reference.dqn`;
- a draw lands on the program's leaf where its target lies within
  ``DRAW_TOL`` of the total from that leaf's prefix-sum interval: the
  program descends a float32 tree, whose rounding moves the boundaries by
  that much (``index_ties`` counts them; ``index_faults`` the others);
- after each update the tree takes the priorities the program wrote
  (``written_td`` of the snapshot), not the reference's own: the
  reference's parameters leave the program's over a superstep's updates
  (Adam's normalised steps turn rounding into steps of ``lr`` on leaves
  whose gradients are near zero), and with them its later priorities, by
  tens of percent on a fifth of the slots, so its draws from its own would
  drift apart for a reason that is no fault (``own_priorities`` makes the
  reference draw from its own, the look behind that choice).  The written
  priorities are held instead where the reference starts from the
  program's state, row by row in each superstep's first update
  (``prio_gap``), and the tree's leaves to what the program wrote
  (``tree_faults``);
- exploration is the noise alone (no epsilon), as in the port's Rainbow.

Every argmax (the double-Q action and the greedy action the rollout is held
to) is decided with the encoder in bfloat16 (:func:`decide_mode`), as
:mod:`benchmark.reference.dqn` does; the rest is float32.  ``mode``
``"fp8"`` (the control) and ``"bf16"`` (the configuration's rounding) put
the encoder at another precision, as there.

:func:`check_ring` reports the ring's ``env_faults`` and the numbers of the
trees that the latest :func:`follow` in the configuration's precision
checked (the harness runs it before ``check_ring``): ``tree_faults``
(internal nodes of the snapshots' trees that are not the float32 sum of
their children, nonzero padding leaves, and leaves that are not what the
rollout's new slots and the updates' write-backs put there) and
``prio_gap`` (:func:`follow`).  The harness hands ``check_ring`` only the
final ring, whose state holds no tree.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.dqn import ADAM_EPS, BETA1, BETA2, Ring, _bf16, _fp8, _precision, _start, gather
from benchmark.reference.envs import acting_obs
from benchmark.reference.envs import check_ring as env_check_ring
from benchmark.weights import weight_seed

__all__ = ["spec", "streams", "noise_sizes", "make_weights", "forward", "precision_mode", "decide_mode", "project",
           "draw", "update_step", "follow", "check_ring", "tree_faults", "leaf_faults", "prio_gaps", "DRAW_TOL",
           "PRIO_FORM"]

#: the share of the tree's total within which a draw's target may lie
#: outside the program's leaf's prefix-sum interval: the float32 rounding
#: of the tree's sums and of the descent moved targets by at most 2^-23.8
#: of the total over 8,000,000 draws on trees of 100,096 leaves, to which
#: this leaves a factor of 7
DRAW_TOL = 2.0 ** -21
#: the form of :func:`prio_gaps` that ``prio_gap`` takes
PRIO_FORM = "q99"
#: the tree numbers of the latest follow in the configuration's precision
#: (module docstring)
_LAST_TREES: dict[str, float] = {}


# -- the weights ---------------------------------------------------------------
# The Rainbow network's initial weights (``network.head.kind``
# ``dueling_noisy_c51``), made from the seed and handed alike to the program
# (the builder loads them) and to the reference.  The convolutions take
# :mod:`benchmark.weights`' rule: a normal draw clipped at two standard
# deviations and scaled by ``1 / sqrt(fan_in)``, zero biases.  Each noisy
# layer is initialised as Tianshou's ``NoisyLinear``: the means ``w_mu`` and
# ``b_mu`` uniform in ``[-1/sqrt(in), 1/sqrt(in))``, the scales ``w_sigma`` and
# ``b_sigma`` the constant ``noisy_std / sqrt(in)``.  One normal draw covers
# the convolutions and then one uniform draw the means, from one generator on
# the device seeded by :func:`benchmark.weights.weight_seed`, sliced leaf by
# leaf in the order of :func:`spec`, whose names are the program's parameter
# names.  They live here because the reference may import only the
# benchmark's own reference modules and :mod:`benchmark.weights`.


def streams(config: dict) -> list[tuple[str, list[tuple[int, int]]]]:
    """``(name, [(in, out) of each noisy layer])`` of the advantage stream
    ``a`` and the value stream ``v``, in the network's module order."""
    net, env = config["network"], config["env"]
    head = net["head"]
    c, h, w = env["channels"], env["height"], env["width"]
    for oc, k, s in net["convs"]:
        c, h, w = oc, (h - k) // s + 1, (w - k) // s + 1
    feat, hidden, atoms = c * h * w, head["hidden"], head["num_atoms"]
    return [("a", [(feat, hidden), (hidden, env["num_actions"] * atoms)]), ("v", [(feat, hidden), (hidden, atoms)])]


def noise_sizes(config: dict) -> list[int]:
    """The sizes of one draw of the network's noise, ``(in, out)`` of each
    noisy layer in module order (the program's ``draw_noise``)."""
    return [n for _, layers in streams(config) for i, o in layers for n in (i, o)]


def spec(config: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """``(name, shape, kind, scale)`` of every parameter: ``kind``
    ``normal`` (clipped normal times ``scale``), ``uniform`` (uniform in
    ``[-scale, scale)``) or ``const`` (filled with ``scale``)."""
    net, env = config["network"], config["env"]
    if net["kind"] != "nature_cnn" or net.get("head", {}).get("kind") != "dueling_noisy_c51":
        raise ValueError(f"no Rainbow weights for network {net}")
    out = []
    c = env["channels"]
    for i, (oc, k, _) in enumerate(net["convs"]):
        out.append((f"encoder.convs.{i}.weight", (oc, c, k, k), "normal", 1.0 / math.sqrt(c * k * k)))
        out.append((f"encoder.convs.{i}.bias", (oc,), "const", 0.0))
        c = oc
    sigma0 = net["head"]["noisy_std"]
    for name, layers in streams(config):
        for j, (fi, fo) in enumerate(layers):
            bound, sigma = 1.0 / math.sqrt(fi), sigma0 / math.sqrt(fi)
            p = f"{name}.layers.{j}"
            out += [(f"{p}.w_mu", (fo, fi), "uniform", bound), (f"{p}.b_mu", (fo,), "uniform", bound),
                    (f"{p}.w_sigma", (fo, fi), "const", sigma), (f"{p}.b_sigma", (fo,), "const", sigma)]
    return out


def make_weights(config: dict, seed: int, device: str | torch.device) -> dict[str, torch.Tensor]:
    """float32 ``name -> tensor`` on ``device``."""
    leaves = spec(config)
    g = torch.Generator(device=device)
    g.manual_seed(weight_seed(seed))
    count = {kind: sum(math.prod(shape) for _, shape, k, _ in leaves if k == kind) for kind in ("normal", "uniform")}
    draws = {"normal": torch.randn((count["normal"],), generator=g, device=device).clamp_(-2.0, 2.0),
             "uniform": torch.rand((count["uniform"],), generator=g, device=device).mul_(2.0).sub_(1.0)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale in leaves:
        n = math.prod(shape)
        if kind == "const":
            out[name] = torch.full(shape, scale, device=device, dtype=torch.float32)
        else:
            out[name] = draws[kind][at[kind]:at[kind] + n].view(shape).mul(scale)
            at[kind] += n
    return out


def _f(e: torch.Tensor) -> torch.Tensor:
    return torch.sign(e) * torch.sqrt(torch.abs(e))


def _stream(params: dict, x: torch.Tensor, name: str, noise: list | None) -> torch.Tensor:
    layers = 2
    for j in range(layers):
        p = f"{name}.layers.{j}"
        w, b = params[f"{p}.w_mu"], params[f"{p}.b_mu"]
        if noise is not None:
            e_in, e_out = _f(noise[j][0]), _f(noise[j][1])
            w = w + params[f"{p}.w_sigma"] * torch.outer(e_out, e_in)
            b = b + params[f"{p}.b_sigma"] * e_out
        x = F.linear(x, w, b)
        if j < layers - 1:
            x = F.relu(x)
    return x


def forward(params: dict, x: torch.Tensor, config: dict, mode: str = "fp32", noise: list | None = None):
    """Probabilities ``[B, A, atoms]`` for ``[B, S, H, W]`` uint8 stacks;
    ``noise`` is the list of ``(eps_in, eps_out)`` pairs of one draw
    (advantage stream first), ``None`` for the mean weights."""
    q = {"fp8": _fp8, "bf16": _bf16}.get(mode, lambda t: t)
    qb = _bf16 if mode == "bf16" else (lambda t: t)
    net = config["network"]
    x = x.to(torch.float32)
    for i, (_, _, stride) in enumerate(net["convs"]):
        w, b = params[f"encoder.convs.{i}.weight"], params[f"encoder.convs.{i}.bias"]
        x = F.relu(F.conv2d(q(x), q(w), qb(b), stride=stride))
    feat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
    n_a = 2
    a = _stream(params, feat, "a", None if noise is None else noise[:n_a])
    v = _stream(params, feat, "v", None if noise is None else noise[n_a:])
    a = a.reshape(x.shape[0], config["env"]["num_actions"], -1)
    return torch.softmax(a - a.mean(dim=1, keepdim=True) + v[:, None, :], dim=-1)


def precision_mode(config: dict) -> str:
    """``"bf16"`` for a bfloat16 encoder, else ``"fp32"``."""
    return "bf16" if config["compute_dtype"] == "bfloat16" else "fp32"


def decide_mode(config: dict, mode: str) -> str:
    return precision_mode(config) if mode == "fp32" else mode


def _noise(config: dict, g: torch.Generator, device) -> list:
    """One draw of the network's noise, as the program's ``draw_noise``."""
    sizes = noise_sizes(config)
    parts = torch.randn((sum(sizes),), generator=g, device=device).split(sizes)
    return list(zip(parts[0::2], parts[1::2]))


def _support(config: dict, device) -> torch.Tensor:
    h = config["network"]["head"]
    return torch.linspace(h["v_min"], h["v_max"], h["num_atoms"], device=device)


def project(p: torch.Tensor, returns: torch.Tensor, discount: torch.Tensor, mask: torch.Tensor,
            config: dict) -> torch.Tensor:
    """The categorical projection ``[B, atoms]`` of ``p`` ``[B, atoms]``
    shifted to ``returns + discount * mask * z``: each shifted atom's mass
    goes to the support atoms within one spacing, by ``1 - |Tz - z_j| /
    dz``."""
    h = config["network"]["head"]
    z = _support(config, p.device)
    dz = (h["v_max"] - h["v_min"]) / (h["num_atoms"] - 1)
    tz = (returns[:, None] + discount[:, None] * mask[:, None] * z[None]).clamp(h["v_min"], h["v_max"])
    share = (1.0 - (tz[:, :, None] - z[None, None, :]).abs() / dz).clamp(min=0.0)  # [B, i, j]
    return (share * p[:, :, None]).sum(1)


def _nstep_parts(rew: torch.Tensor, done: torch.Tensor, gamma: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sum_{j<m} gamma^j r_j, gamma^m)``, ``m`` the chain's length up to
    and including its first episode end."""
    n = rew.shape[1]
    m = torch.where(done.any(1), done.to(torch.int64).argmax(1) + 1, n)
    j = torch.arange(n, device=rew.device)
    disc = gamma ** j.to(torch.float64)
    ret = ((j[None] < m[:, None]) * rew.to(torch.float64) * disc[None]).sum(1)
    return ret.to(torch.float32), (gamma ** m.to(torch.float64)).to(torch.float32)


def draw(leaves: torch.Tensor, u: torch.Tensor, program: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """Proportional draws ``(flat slots, ties, faults)`` for the uniforms
    ``u`` over ``leaves`` (float64 prefix sums), each against the
    program's draw ``program``: where the program's leaf's interval holds
    the target within ``DRAW_TOL`` of the total, the draw is the
    program's (a tie); a fault where it does not."""
    cum = torch.cumsum(leaves.to(torch.float64), 0)
    total = cum[-1]
    t = u.to(torch.float64) * total
    flat = torch.clamp(torch.searchsorted(cum, t, right=True), max=leaves.numel() - 1)
    lo = torch.where(program > 0, cum[(program - 1).clamp(min=0)], 0.0)
    tol = DRAW_TOL * total
    near = (t >= lo - tol) & (t < cum[program] + tol)
    tie = (flat != program) & near
    flat = torch.where(tie, program, flat)
    return flat, int(tie.sum()), int((flat != program).sum())


def tree_faults(tree: torch.Tensor, slots: int) -> int:
    """Internal nodes of a heap-layout sum tree ``[2 * cap]`` that are not
    the float32 sum of their children (beyond one rounding), and padding
    leaves past ``slots`` that are not zero."""
    cap = tree.shape[0] // 2
    node = tree[1:cap].to(torch.float64)
    kids = tree[2:].view(cap - 1, 2).sum(1, dtype=torch.float32).to(torch.float64)
    bad = (node - kids).abs() > 2.0 ** -23 * kids.abs()
    return int(bad.sum()) + int((tree[cap + slots:] != 0).sum())


def leaf_faults(tree: torch.Tensor, leaves: torch.Tensor) -> int:
    """Leaves of a heap-layout sum tree ``[2 * cap]`` that differ from the
    expected ``leaves`` by more than a part in 10^5 (two writes of one
    slot in one batch hold the same transition, so the same value to
    within a row's rounding)."""
    got = tree[tree.shape[0] // 2:][:leaves.numel()].to(torch.float64)
    want = leaves.to(torch.float64)
    return int(((got - want).abs() > 1e-5 * want.abs()).sum())


def _acting(params: dict, ring: Ring, snap: dict, config: dict, traffic: dict, mode: str) -> int:
    """How many of the rollout's actions (the last ``segment`` rows of
    every env) equal the greedy action under the noise that the rollout
    drew for its step, redrawn from the acting generator's state."""
    dev = ring.cursor.device
    g = torch.Generator(device=dev)
    g.set_state(snap["ring"]["storage"]["act_rng"])
    n, seg, cap = traffic["num_envs"], traffic["segment"], ring.capacity
    z = _support(config, dev)
    env = torch.arange(n, device=dev)
    agree = 0
    with torch.no_grad():
        for t in range(seg):
            noise = _noise(config, g, dev)
            torch.randint(0, 1 << 20, (n,), generator=g, device=dev, dtype=torch.int32)  # the envs' reset draw
            pos = torch.remainder(ring.cursor - seg + t, cap)
            obs = acting_obs(config, ring.s["obs"][env, pos])
            greedy = (forward(params, obs, config, decide_mode(config, mode), noise) * z).sum(-1).argmax(-1)
            agree += int((greedy == ring.s["act"][env, pos].to(torch.int64)).sum())
    return agree


def _tree_before(snapshots: list[dict], s: int, ring: Ring, config: dict, traffic: dict, slots: int):
    """The tree's leaves ``[slots]`` before superstep ``s``'s updates."""
    alpha, cap = config["alpha"], ring.capacity
    dev = ring.cursor.device
    if s == 0:
        # every stored slot at the initial max_prio's 1 ** alpha
        return (torch.arange(cap, device=dev)[None, :] < ring.size[:, None]).reshape(-1).to(torch.float32)
    prev = snapshots[s - 1]["ring"]["storage"]
    tree = prev["tree"].to(dev)
    leaves = tree[tree.shape[0] // 2:][:slots].clone()
    t = torch.arange(traffic["segment"], device=dev)
    pos = torch.remainder(ring.cursor[:, None] - traffic["segment"] + t[None], cap)
    flat = (torch.arange(ring.cursor.shape[0], device=dev)[:, None] * cap + pos).reshape(-1)
    leaves[flat] = prev["max_prio"].to(dev)[0] ** alpha
    return leaves


def update_step(params: dict, target: dict, ring: Ring, leaves: torch.Tensor, g: torch.Generator,
                program: torch.Tensor, config: dict, beta: float, mode: str = "fp32") -> dict:
    """One update's learning half: the draws (:func:`draw`, against the
    program's flat slots ``program``) from ``g``'s uniforms over
    ``leaves``, the importance weights, the gathered transitions, the
    target and online noise drawn from ``g`` in that order, the target
    distribution, the cross-entropy and the loss, and the gradients of the
    online parameters ``params``: ``{"flat", "ties", "faults", "weight",
    "ce", "loss", "grads"}``."""
    device = leaves.device
    batch = program.shape[0]
    cap = ring.capacity
    z = _support(config, device)
    flat, ties, faults = draw(leaves, torch.rand((batch,), generator=g, device=device), program)
    w = leaves[flat].clamp(min=1e-12) ** (-beta)
    w = w / w.max()
    data = gather(ring, flat // cap, flat % cap, config)
    n_target, n_online = _noise(config, g, device), _noise(config, g, device)
    rows = torch.arange(batch, device=device)
    with torch.no_grad():
        nxt = data["obs_next"]
        a_star = (forward(params, nxt, config, decide_mode(config, mode), n_online) * z).sum(-1).argmax(-1)
        p_star = forward(target, nxt, config, mode, n_target)[rows, a_star]
        ret, disc = _nstep_parts(data["rew"], data["done"], config["gamma"])
        dist = project(p_star, ret, disc, (~data["terminated"]).to(torch.float32), config)
    p_a = forward(params, data["obs"], config, mode, n_online)[rows, data["act"].to(torch.int64)]
    ce = -(dist * torch.log(p_a.clamp(min=1e-8))).sum(-1)
    loss = (w * ce).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"flat": flat, "ties": ties, "faults": faults, "weight": w, "ce": ce.detach(), "loss": loss.detach(),
            "grads": grads}


def follow(config: dict, traffic: dict, seed: int, snapshots: list[dict], device, mode: str = "fp32",
           own_priorities: bool = False) -> dict:
    """Each followed superstep worked out again from the state it started
    from: ``steps`` (the first update's ``loss1`` and ``grads1`` and the
    parameters' change ``delta``), ``act_gap`` (the share of the rollouts'
    actions that differ from the greedy action under their redrawn noise),
    ``index_faults`` and ``index_ties`` (:func:`draw`), ``tree_faults``
    (:func:`tree_faults` and :func:`leaf_faults` of each snapshot's tree:
    the leaves before the superstep with the updates' written priorities
    put in, in order), ``prio_gap`` (the largest over the supersteps of the
    :data:`PRIO_FORM` of :func:`prio_gaps` over the first update's rows
    that drew the program's slot: the program's written priority ``(|td| +
    1e-6)^alpha`` against the reference's on the same transition, from the
    same parameters and noise), ``prio_looks`` (every form of each
    superstep's) and the ``initial`` weights."""
    w0 = make_weights(config, seed, device)
    k, batch = traffic["updates"], traffic["batch"]
    lr, freq, alpha = config["lr"], config["target_update_freq"], config["alpha"]
    agree = total = ties = faults = bad_nodes = 0
    prio_looks = []
    out = {"steps": [], "initial": {n: w.detach().to("cpu", copy=True) for n, w in w0.items()}}
    with _precision(mode):
        for s, snap in enumerate(snapshots):
            online, target, m, v, step, count = _start(snapshots, s, w0, device)
            start = {**{f"online.{n}": t.clone() for n, t in online.items()},
                     **{f"target.{n}": t.clone() for n, t in target.items()}}
            params = {n: t.requires_grad_(True) for n, t in online.items()}
            ring = Ring(snap["ring"], device)
            cap = ring.capacity
            slots = ring.cursor.shape[0] * cap
            agree += _acting(params, ring, snap, config, traffic, mode)
            total += traffic["num_envs"] * traffic["segment"]
            leaves = _tree_before(snapshots, s, ring, config, traffic, slots)
            beta = float(snap["ring"]["storage"]["beta"][0])
            program = (snap["env_idx"].to(device) * cap + snap["pos"].to(device)).reshape(k, batch)
            written = snap["ring"]["storage"]["written_td"].to(device)
            g = torch.Generator(device=device)
            g.set_state(snap["sample_state"])
            loss1 = grads1 = None
            for u in range(k):
                r = update_step(params, target, ring, leaves, g, program[u], config, beta, mode)
                ties, faults = ties + r["ties"], faults + r["faults"]
                flat, ce, grads = r["flat"], r["ce"], r["grads"]
                if grads1 is None:
                    loss1 = float(r["loss"])
                    grads1 = {n: g_.to("cpu", copy=True) for n, g_ in zip(params, grads)}
                step += 1
                count += 1
                with torch.no_grad():
                    bc1, bc2 = 1 - BETA1 ** step, 1 - BETA2 ** step
                    for (name, p), g_ in zip(params.items(), grads):
                        m[name].mul_(BETA1).add_(g_, alpha=1 - BETA1)
                        v[name].mul_(BETA2).addcmul_(g_, g_, value=1 - BETA2)
                        p.sub_(lr * (m[name] / bc1) / ((v[name] / bc2).sqrt() + ADAM_EPS))
                    if freq > 0 and count % freq == 0:
                        target = {n: p.detach().clone() for n, p in params.items()}
                    mine = (ce.detach() + 1e-6) ** alpha
                    whole = u < written.shape[0] and written[u].shape == program[u].shape
                    if u == 0:
                        agreed = flat == program[u]
                        prio_looks.append(prio_gaps((written[u][agreed] + 1e-6) ** alpha, mine[agreed]) if whole
                                          else dict.fromkeys(prio_gaps(mine, mine), math.inf))
                    if own_priorities:
                        leaves[flat] = mine
                    elif whole:
                        leaves[program[u]] = (written[u] + 1e-6) ** alpha
                    else:  # a write-back of other rows than the draw's
                        bad_nodes += batch
            end = {**{f"online.{n}": p.detach() for n, p in params.items()},
                   **{f"target.{n}": t for n, t in target.items()}}
            out["steps"].append({"loss1": loss1, "grads1": grads1,
                                 "delta": {n: (end[n] - start[n]).to("cpu", copy=True) for n in start}})
            tree = snap["ring"]["storage"]["tree"].to(device)
            bad_nodes += tree_faults(tree, slots) + (0 if own_priorities else leaf_faults(tree, leaves))
            del ring
    prio_gap = max((look[PRIO_FORM] for look in prio_looks), default=0.0)
    out.update(act_gap=1.0 - agree / total, index_faults=faults, index_ties=ties, tree_faults=bad_nodes,
               prio_gap=prio_gap, prio_looks=prio_looks)
    if mode == precision_mode(config) and not own_priorities:
        _LAST_TREES.clear()
        _LAST_TREES.update(tree_faults=bad_nodes, prio_gap=prio_gap)
    return out


def prio_gaps(prio: torch.Tensor, ref: torch.Tensor) -> dict[str, float]:
    """The program's priorities ``p`` against the reference's ``r``, row by
    row, by the relative gap ``|p - r| / r``: its ``median``, its 90th and
    99th percentiles ``q90`` and ``q99``, its ``max``, the ``share`` of
    rows beyond 0.01, and ``rms``, ``|p - r| / |r|`` over the rows
    together."""
    if not ref.numel():
        return {"median": 0.0, "q90": 0.0, "q99": 0.0, "max": 0.0, "share": 0.0, "rms": 0.0}
    r, p = ref.to(torch.float64), prio.to(torch.float64)
    rel = (p - r).abs() / r
    q = torch.quantile(rel, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=rel.device))
    return {"median": float(q[0]), "q90": float(q[1]), "q99": float(q[2]), "max": float(rel.max()),
            "share": float((rel > 0.01).to(torch.float64).mean()),
            "rms": float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r))}


def check_ring(config: dict, ring: dict, device, env_state: dict | None = None) -> dict:
    """``env_faults`` of the final ring (:mod:`benchmark.reference.envs`),
    with the tree numbers of the latest float32 :func:`follow`."""
    return {**env_check_ring(config, ring, device, env_state), **_LAST_TREES}
