"""Batched classic-control environments (port of
``tianshou_tpu/envs/classic.py``): CartPole, Pendulum, MountainCarContinuous,
Acrobot and NChain.

Each env steps a whole batch of instances: every state leaf is a
``[num_envs]`` tensor.  Only :meth:`reset` draws, from the generator it is
given; :meth:`step` is deterministic, in float32, and writes its arithmetic
in the JAX package's order so that both give the same trajectories (to the
last ulp, unless one compiler contracts a product and a sum into an FMA).
Physics constants are those of Gym's CartPole-v1, Pendulum-v1,
MountainCarContinuous-v0 and Acrobot-v1, with the same time limits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tianshou_tpu_torch.envs.base import StepResult, TorchEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = ["CartPole", "Pendulum", "MountainCarContinuous", "Acrobot", "NChain", "make_env"]

_INF = float("inf")


def _uniform(generator, shape, low, high, device):
    """``jax.random.uniform(key, shape, minval=low, maxval=high)``'s form:
    ``u * (high - low) + low``."""
    return torch.rand(shape, generator=generator, device=device) * (high - low) + low


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor  # int32


class CartPole(TorchEnv):
    """CartPole-v1: balance a pole on a force-controlled cart.

    Euler-integrated pole-on-cart dynamics; reward 1 per step; terminates
    when |x| > 2.4 or |theta| > 12 deg; truncates at 500 steps.
    """

    GRAVITY = 9.8
    MASS_CART = 1.0
    MASS_POLE = 0.1
    LENGTH = 0.5  # half pole length
    FORCE_MAG = 10.0
    TAU = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * math.pi / 180
    MAX_STEPS = 500

    observation_space = Box(low=-_INF, high=_INF, shape=(4,))
    action_space = Discrete(2)

    def reset(self, generator, num_envs, device):
        v = _uniform(generator, (num_envs, 4), -0.05, 0.05, device)
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        state = CartPoleState(v[:, 0], v[:, 1], v[:, 2], v[:, 3], t)
        return state, self._obs(state)

    @staticmethod
    def _obs(s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def step(self, state: CartPoleState, action: torch.Tensor, generator=None):
        force = torch.where(action > 0, self.FORCE_MAG, -self.FORCE_MAG).to(torch.float32)
        total_mass = self.MASS_CART + self.MASS_POLE
        pole_ml = self.MASS_POLE * self.LENGTH
        cos_t = torch.cos(state.theta)
        sin_t = torch.sin(state.theta)
        temp = (force + pole_ml * state.theta_dot**2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.LENGTH * (4.0 / 3.0 - self.MASS_POLE * cos_t**2 / total_mass)
        )
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        new = CartPoleState(
            x=state.x + self.TAU * state.x_dot,
            x_dot=state.x_dot + self.TAU * x_acc,
            theta=state.theta + self.TAU * state.theta_dot,
            theta_dot=state.theta_dot + self.TAU * theta_acc,
            t=state.t + 1,
        )
        terminated = (new.x.abs() > self.X_LIMIT) | (new.theta.abs() > self.THETA_LIMIT)
        truncated = (new.t >= self.MAX_STEPS) & ~terminated
        reward = torch.ones_like(new.x)
        return new, StepResult(self._obs(new), reward, terminated, truncated)


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor


class Pendulum(TorchEnv):
    """Pendulum-v1: swing up a pendulum with bounded torque.

    Reward ``-(angle^2 + 0.1*thdot^2 + 0.001*u^2)``; no termination;
    truncates at 200 steps.  Obs is ``[cos, sin, thdot]``; actions are
    ``[num_envs, 1]`` torques.
    """

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    observation_space = Box(low=(-1.0, -1.0, -8.0), high=(1.0, 1.0, 8.0), shape=(3,))
    action_space = Box(low=-2.0, high=2.0, shape=(1,))

    def reset(self, generator, num_envs, device):
        theta = _uniform(generator, (num_envs,), -math.pi, math.pi, device)
        theta_dot = _uniform(generator, (num_envs,), -1.0, 1.0, device)
        state = PendulumState(theta, theta_dot, torch.zeros_like(theta, dtype=torch.int32))
        return state, self._obs(state)

    @staticmethod
    def _obs(s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)

    def step(self, state: PendulumState, action: torch.Tensor, generator=None):
        u = torch.clamp(action.reshape(-1), -self.MAX_TORQUE, self.MAX_TORQUE)
        theta_norm = torch.remainder(state.theta + math.pi, 2 * math.pi) - math.pi
        cost = theta_norm**2 + 0.1 * state.theta_dot**2 + 0.001 * u**2
        new_dot = state.theta_dot + (
            3.0 * self.G / (2.0 * self.L) * torch.sin(state.theta)
            + 3.0 / (self.M * self.L**2) * u
        ) * self.DT
        new_dot = torch.clamp(new_dot, -self.MAX_SPEED, self.MAX_SPEED)
        new = PendulumState(theta=state.theta + new_dot * self.DT, theta_dot=new_dot, t=state.t + 1)
        terminated = torch.zeros_like(new.t, dtype=torch.bool)
        return new, StepResult(self._obs(new), -cost, terminated, new.t >= self.MAX_STEPS)


class MountainCarState(NamedTuple):
    position: torch.Tensor
    velocity: torch.Tensor
    t: torch.Tensor


class MountainCarContinuous(TorchEnv):
    """MountainCarContinuous-v0: drive up a hill with a weak engine."""

    MIN_POS = -1.2
    MAX_POS = 0.6
    MAX_SPEED = 0.07
    GOAL_POS = 0.45
    POWER = 0.0015
    MAX_STEPS = 999

    observation_space = Box(low=(-1.2, -0.07), high=(0.6, 0.07), shape=(2,))
    action_space = Box(low=-1.0, high=1.0, shape=(1,))

    def reset(self, generator, num_envs, device):
        pos = _uniform(generator, (num_envs,), -0.6, -0.4, device)
        state = MountainCarState(pos, torch.zeros_like(pos), torch.zeros_like(pos, dtype=torch.int32))
        return state, self._obs(state)

    @staticmethod
    def _obs(s: MountainCarState) -> torch.Tensor:
        return torch.stack([s.position, s.velocity], dim=-1)

    def step(self, state: MountainCarState, action: torch.Tensor, generator=None):
        force = torch.clamp(action.reshape(-1), -1.0, 1.0)
        velocity = state.velocity + force * self.POWER - 0.0025 * torch.cos(3 * state.position)
        velocity = torch.clamp(velocity, -self.MAX_SPEED, self.MAX_SPEED)
        position = torch.clamp(state.position + velocity, self.MIN_POS, self.MAX_POS)
        velocity = torch.where((position <= self.MIN_POS) & (velocity < 0), 0.0, velocity)
        new = MountainCarState(position, velocity, state.t + 1)
        terminated = position >= self.GOAL_POS
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force**2
        truncated = (new.t >= self.MAX_STEPS) & ~terminated
        return new, StepResult(self._obs(new), reward, terminated, truncated)


class AcrobotState(NamedTuple):
    theta1: torch.Tensor
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor
    t: torch.Tensor


class Acrobot(TorchEnv):
    """Acrobot-v1: swing a two-link pendulum above the bar (RK4 dynamics)."""

    DT = 0.2
    L1 = 1.0
    L2 = 1.0
    M1 = 1.0
    M2 = 1.0
    LC1 = 0.5
    LC2 = 0.5
    I1 = 1.0
    I2 = 1.0
    G = 9.8
    MAX_VEL1 = 4 * math.pi
    MAX_VEL2 = 9 * math.pi
    TORQUES = (-1.0, 0.0, 1.0)
    MAX_STEPS = 500

    observation_space = Box(
        low=(-1, -1, -1, -1, -4 * 3.1416, -9 * 3.1416),
        high=(1, 1, 1, 1, 4 * 3.1416, 9 * 3.1416),
        shape=(6,),
    )
    action_space = Discrete(3)

    def reset(self, generator, num_envs, device):
        v = _uniform(generator, (num_envs, 4), -0.1, 0.1, device)
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        state = AcrobotState(v[:, 0], v[:, 1], v[:, 2], v[:, 3], t)
        return state, self._obs(state)

    @staticmethod
    def _obs(s: AcrobotState) -> torch.Tensor:
        return torch.stack([
            torch.cos(s.theta1), torch.sin(s.theta1), torch.cos(s.theta2),
            torch.sin(s.theta2), s.dtheta1, s.dtheta2,
        ], dim=-1)

    def _dsdt(self, s: torch.Tensor, torque: torch.Tensor) -> torch.Tensor:
        """Time derivative of ``s [N, 4] = (theta1, theta2, dtheta1,
        dtheta2)``."""
        theta1, theta2, dtheta1, dtheta2 = s.unbind(-1)
        d1 = (
            self.M1 * self.LC1**2
            + self.M2 * (self.L1**2 + self.LC2**2 + 2 * self.L1 * self.LC2 * torch.cos(theta2))
            + self.I1
            + self.I2
        )
        d2 = self.M2 * (self.LC2**2 + self.L1 * self.LC2 * torch.cos(theta2)) + self.I2
        phi2 = self.M2 * self.LC2 * self.G * torch.cos(theta1 + theta2 - math.pi / 2)
        phi1 = (
            -self.M2 * self.L1 * self.LC2 * dtheta2**2 * torch.sin(theta2)
            - 2 * self.M2 * self.L1 * self.LC2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (self.M1 * self.LC1 + self.M2 * self.L1) * self.G * torch.cos(theta1 - math.pi / 2)
            + phi2
        )
        ddtheta2 = (
            torque
            + d2 / d1 * phi1
            - self.M2 * self.L1 * self.LC2 * dtheta1**2 * torch.sin(theta2)
            - phi2
        ) / (self.M2 * self.LC2**2 + self.I2 - d2**2 / d1)
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], dim=-1)

    def step(self, state: AcrobotState, action: torch.Tensor, generator=None):
        torque = action.to(torch.float32) - 1.0  # TORQUES[action], built on the device
        s0 = torch.stack([state.theta1, state.theta2, state.dtheta1, state.dtheta2], dim=-1)
        # RK4 integration over one DT
        k1 = self._dsdt(s0, torque)
        k2 = self._dsdt(s0 + self.DT / 2 * k1, torque)
        k3 = self._dsdt(s0 + self.DT / 2 * k2, torque)
        k4 = self._dsdt(s0 + self.DT * k3, torque)
        s1 = s0 + self.DT / 6 * (k1 + 2 * k2 + 2 * k3 + k4)

        def wrap(x):
            return torch.remainder(x + math.pi, 2 * math.pi) - math.pi

        new = AcrobotState(
            theta1=wrap(s1[:, 0]),
            theta2=wrap(s1[:, 1]),
            dtheta1=torch.clamp(s1[:, 2], -self.MAX_VEL1, self.MAX_VEL1),
            dtheta2=torch.clamp(s1[:, 3], -self.MAX_VEL2, self.MAX_VEL2),
            t=state.t + 1,
        )
        terminated = -torch.cos(new.theta1) - torch.cos(new.theta2 + new.theta1) > 1.0
        reward = torch.where(terminated, 0.0, -1.0)
        truncated = (new.t >= self.MAX_STEPS) & ~terminated
        return new, StepResult(self._obs(new), reward, terminated, truncated)


_MASK32 = 0xFFFFFFFF


def _threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` under the
    key ``(k0, k1)``: JAX's default random bit generator, on uint32 values
    held in int64 tensors."""
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


class NChainState(NamedTuple):
    s: torch.Tensor  # int32 state index
    t: torch.Tensor


class NChain(TorchEnv):
    """NChain: tabular chain MDP for PSRL-style model-based algorithms.

    Action 0 moves forward (reward 0, large reward ``BIG`` at the end);
    action 1 returns to start with small reward 2; a slip with probability
    ``SLIP`` flips the action.  The slip is a fixed function of ``(t, s)``:
    ``jax.random.uniform(fold_in(key(17), t * 1000 + s)) < SLIP``, computed
    here with the same Threefry bits, so both packages slip alike.
    """

    N = 5
    SLIP = 0.2
    SMALL = 2.0
    BIG = 10.0
    MAX_STEPS = 100

    observation_space = Box(low=0.0, high=4.0, shape=(1,))
    action_space = Discrete(2)

    def reset(self, generator, num_envs, device):
        zeros = torch.zeros((num_envs,), dtype=torch.int32, device=device)
        state = NChainState(zeros, zeros.clone())
        return state, self._obs(state)

    @staticmethod
    def _obs(st: NChainState) -> torch.Tensor:
        return st.s.to(torch.float32)[:, None]

    @staticmethod
    def _slip_uniform(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        data = (t.to(torch.int64) * 1000 + s.to(torch.int64)) & _MASK32
        zero = torch.zeros_like(data)
        k0, k1 = _threefry2x32(0, 17, zero, data)  # fold_in(key(17), data)
        bits0, bits1 = _threefry2x32(k0, k1, zero, zero)  # uniform((), key)
        bits = bits0 ^ bits1
        mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
        return mantissa.view(torch.float32) - 1.0

    def step(self, state: NChainState, action: torch.Tensor, generator=None):
        slip = self._slip_uniform(state.t, state.s) < self.SLIP
        a = torch.where(slip, 1 - action.to(torch.int32), action.to(torch.int32))
        fwd_s = torch.clamp(state.s + 1, max=self.N - 1)
        at_end = state.s == self.N - 1
        rew_fwd = torch.where(at_end, self.BIG, 0.0)
        s_new = torch.where(a == 0, fwd_s, 0).to(torch.int32)
        rew = torch.where(a == 0, rew_fwd, self.SMALL)
        new = NChainState(s_new, state.t + 1)
        terminated = torch.zeros_like(at_end)
        return new, StepResult(self._obs(new), rew, terminated, new.t >= self.MAX_STEPS)


_REGISTRY = {
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
    "MountainCarContinuous-v0": MountainCarContinuous,
    "Acrobot-v1": Acrobot,
    "NChain-v0": NChain,
}


def make_env(name: str) -> TorchEnv:
    """Env by name (the counterpart of ``gym.make``); ``MinAtar/...`` names
    go to :func:`~.minatar.make_minatar`."""
    if name.lower().startswith("minatar"):
        from tianshou_tpu_torch.envs.minatar import make_minatar

        return make_minatar(name)
    if name not in _REGISTRY:
        raise KeyError(f"Unknown env {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
