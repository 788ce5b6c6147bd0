"""Plain checks of every transition a ring holds against the env's own rules,
row by row in each env's age order: what the rollouts wrote.

``synthetic_pixel`` (the port's ``SyntheticPixelEnv`` in the deduplicated
layout, one frame stored a transition): each frame is the env's pattern
``(101 c + 17 h + 29 w + phase) & 0xFF`` of its last channel ``c``; within
an episode the phase grows by 13 a step; episodes truncate after exactly
``episode_len`` steps and never terminate; the reward is ``(t + 1 + a) % 7
== 0`` for the step taken at time ``t``, where ``t`` is known from an
episode end before or after the row, or, in the episode under way, from
the envs' state after the ring's newest row, whose ``seed`` also fixes
the phase (``13 t + 7 seed``).

``cartpole``: ``obs_next`` against the CartPole-v1 Euler step of ``obs``
and the action in float64 (``env_gap``, the largest absolute difference);
termination where ``|x| > 2.4`` or ``|theta| > 12 degrees`` at ``obs_next``
(in float32, as the env compares); reward 1; the next row's ``obs`` equal
to ``obs_next`` within an episode and a reset state (every coordinate in
``[-0.05, 0.05]``) after its end; truncation at 500 steps.

``env_faults`` counts the rows that break a rule.
"""

from __future__ import annotations

import math

import torch

__all__ = ["check_ring", "acting_obs"]


def acting_obs(config: dict, stored: torch.Tensor) -> torch.Tensor:
    """The observations the policy acted on, from the rows the ring stored:
    CartPole's are stored whole; a synthetic frame's other channels follow
    from its last one's phase (``(101 c + 17 h + 29 w + phase) & 0xFF``)."""
    e = config["env"]
    if e["kind"] != "synthetic_pixel":
        return stored
    dev = stored.device
    h = torch.arange(e["height"], device=dev, dtype=torch.int32)
    w = torch.arange(e["width"], device=dev, dtype=torch.int32)
    c = torch.arange(e["channels"], device=dev, dtype=torch.int32)
    last = (e["channels"] - 1) * 101
    phase = torch.remainder(stored[:, 0, 0].to(torch.int32) - last, 256)
    base = (c * 101)[:, None, None] + (h * 17)[None, :, None] + (w * 29)[None, None, :]
    return ((base[None] + phase[:, None, None, None]) & 0xFF).to(torch.uint8)


def _age_order(ring: dict, device, envs: slice):
    """Every stored leaf of the envs ``envs`` in age order ``[n, S, ...]``
    (oldest first) and the validity mask ``[n, S]``."""
    cursor, size = ring["cursor"][envs].to(device), ring["size"][envs].to(device)
    cap = ring["storage"]["act"].shape[1]
    j = torch.arange(cap, device=device)
    pos = torch.remainder(cursor[:, None] - size[:, None] + j[None], cap)
    valid = j[None] < size[:, None]
    out = {}
    for k, v in ring["storage"].items():
        x = v[envs].to(device)
        idx = pos.reshape(pos.shape + (1,) * (x.dim() - 2)).expand((-1, -1) + x.shape[2:])
        out[k] = torch.gather(x, 1, idx)
    return out, valid


def _episode_marks(done: torch.Tensor, valid: torch.Tensor):
    """Per row: the age index of the next episode end at or after it (or a
    large number) and of the previous one before it (or -1)."""
    n, s = done.shape
    j = torch.arange(s, device=done.device).expand(n, s)
    d = done & valid
    nxt = torch.where(d, j, torch.full_like(j, 1 << 40)).flip(1).cummin(1).values.flip(1)
    prv = torch.where(d, j, torch.full_like(j, -1)).cummax(1).values
    prv = torch.cat([torch.full_like(prv[:, :1], -1), prv[:, :-1]], 1)
    return nxt, prv


def _synthetic(config: dict, ring: dict, device, env_state: dict | None) -> dict:
    e = config["env"]
    length, actions = e["episode_len"], e["num_actions"]
    h = torch.arange(e["height"], device=device, dtype=torch.int32)
    w = torch.arange(e["width"], device=device, dtype=torch.int32)
    base = (e["channels"] - 1) * 101 + (h * 17)[:, None] + (w * 29)[None, :]
    faults = 0
    n_envs = ring["cursor"].shape[0]
    for lo in range(0, n_envs, 16):
        rows, valid = _age_order(ring, device, slice(lo, lo + 16))
        size = ring["size"][lo:lo + 16].to(device)
        frames = rows["obs"].to(torch.int32)
        phase = torch.remainder(frames[:, :, 0, 0] - base[0, 0], 256)
        bad = (frames != ((base[None, None] + phase[:, :, None, None]) & 0xFF)).flatten(2).any(2)
        done = rows["truncated"] | rows["terminated"]
        bad |= rows["terminated"]
        act = rows["act"].to(torch.int64)
        bad |= (act < 0) | (act >= actions)
        cont = torch.remainder(phase[:, :-1] + 13, 256) == phase[:, 1:]
        step_ok = cont | done[:, :-1] | ~valid[:, 1:]
        bad[:, 1:] |= ~step_ok
        nxt, prv = _episode_marks(done, valid)
        j = torch.arange(done.shape[1], device=device)[None]
        known_next = nxt < (1 << 40)
        t = torch.where(prv >= 0, j - prv - 1, length - 1 - (nxt - j))
        known = (prv >= 0) | known_next
        if env_state is not None:
            # the episode under way: the env's step count and phase now
            t_now = env_state["t"][lo:lo + 16].to(device=device, dtype=torch.int64)[:, None]
            seed = env_state["seed"][lo:lo + 16].to(device=device, dtype=torch.int64)[:, None]
            current = valid & ~known_next
            t = torch.where(current, t_now - (size[:, None] - j), t)
            known = known | current
            bad |= current & (torch.remainder(13 * t + 7 * seed, 256) != phase)
        bad |= known & ((t < 0) | (t > length - 1))
        bad |= known_next & (prv >= 0) & (nxt - prv != length)
        want = (torch.remainder(t + 1 + act, 7) == 0).to(rows["rew"].dtype)
        bad |= known & (rows["rew"] != want)
        faults += int((bad & valid).sum())
    return {"env_faults": faults}


def _cartpole_step(s: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    x, x_dot, th, th_dot = s.unbind(-1)
    force = torch.where(act > 0, 10.0, -10.0).to(torch.float64)
    total, pole_ml, length = 1.1, 0.05, 0.5
    cos, sin = torch.cos(th), torch.sin(th)
    temp = (force + pole_ml * th_dot ** 2 * sin) / total
    th_acc = (9.8 * sin - cos * temp) / (length * (4.0 / 3.0 - 0.1 * cos ** 2 / total))
    x_acc = temp - pole_ml * th_acc * cos / total
    tau = 0.02
    return torch.stack([x + tau * x_dot, x_dot + tau * x_acc, th + tau * th_dot, th_dot + tau * th_acc], -1)


def _cartpole(config: dict, ring: dict, device) -> dict:
    faults, gap = 0, 0.0
    theta_limit = torch.tensor(12 * math.pi / 180, dtype=torch.float32)
    n_envs = ring["cursor"].shape[0]
    for lo in range(0, n_envs, 256):
        rows, valid = _age_order(ring, device, slice(lo, lo + 256))
        obs, nxt_obs, act = rows["obs"], rows["obs_next"], rows["act"].to(torch.int64)
        ref = _cartpole_step(obs.to(torch.float64), act)
        err = (nxt_obs.to(torch.float64) - ref).abs().amax(-1)
        gap = max(gap, float(torch.where(valid, err, 0.0).max()))
        term = (nxt_obs[..., 0].abs() > 2.4) | (nxt_obs[..., 2].abs() > theta_limit.to(device))
        done = rows["terminated"] | rows["truncated"]
        bad = (rows["terminated"] != term) | (rows["rew"] != 1.0) | (act < 0) | (act > 1)
        same = (obs[:, 1:] == nxt_obs[:, :-1]).all(-1)
        reset = (obs[:, 1:].abs() <= 0.05).all(-1)
        bad[:, 1:] |= ~torch.where(done[:, :-1], reset, same) & valid[:, 1:]
        _, prv = _episode_marks(done, valid)
        j = torch.arange(done.shape[1], device=device)[None]
        steps = j - prv  # the env's step count after the row's step
        want = (steps >= 500) & ~rows["terminated"]
        bad |= (prv >= 0) & (rows["truncated"] != want)
        faults += int((bad & valid).sum())
    return {"env_faults": faults, "env_gap": gap}


def check_ring(config: dict, ring: dict, device, env_state: dict | None = None) -> dict:
    """``env_faults`` (and ``env_gap`` where the env's state is float) of a
    host ring ``{"storage", "cursor", "size"}``; ``env_state``, the envs'
    state after the ring's newest rows, fixes the step count and phase of
    the episodes under way (synthetic frames)."""
    kind = config["env"]["kind"]
    if kind == "synthetic_pixel":
        return _synthetic(config, ring, device, env_state)
    if kind == "cartpole":
        return _cartpole(config, ring, device)
    raise ValueError(f"no ring check for env kind {kind!r}")
