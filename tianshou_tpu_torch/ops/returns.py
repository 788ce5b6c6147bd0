"""Return and advantage estimators (port of ``tianshou_tpu/ops/returns.py``):
``gae_advantages`` and ``discounted_returns`` over time-major ``[T, ...]``
rollouts, ``nstep_return`` and ``nstep_return_components`` over pre-gathered
``[B, n]`` chains.

Semantics are the JAX package's: accumulation stops at ``done = terminated
| truncated``; a state's value is bootstrapped unless the episode
terminated there (truncated episodes do bootstrap).

The JAX package's reversed ``lax.scan`` is a Python loop over T here: the
per-step terms are computed for all T at once, and each step of the loop is
one fused multiply-add (two launches for ``discounted_returns``) written
into a preallocated ``[T, ...]`` output.  Every constant is a Python scalar
argument, never a device tensor made inside the loop (which would be a
host-to-device copy a step).
"""

from __future__ import annotations

import torch

__all__ = ["gae_advantages", "discounted_returns", "nstep_return", "nstep_return_components"]


def gae_advantages(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
    gae_lambda: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over the leading time axis of
    ``[T, ...]`` inputs; ``next_values`` are V(s_{t+1}), masked here where
    the step terminated.  Returns ``(advantages, returns)`` with ``returns =
    advantages + values``."""
    terminated = terminated.to(values.dtype)
    deltas = rewards + gamma * next_values * (1.0 - terminated) - values
    decay = (gamma * gae_lambda) * (1.0 - done.to(values.dtype))
    adv = torch.empty_like(deltas)
    carry = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = torch.addcmul(deltas[t], decay[t], carry, out=adv[t])
    return adv, adv + values


def discounted_returns(
    rewards: torch.Tensor,
    next_values: torch.Tensor,
    terminated: torch.Tensor,
    done: torch.Tensor,
    gamma: float,
) -> torch.Tensor:
    """Monte-Carlo discounted returns over ``[T, ...]``, restarting from the
    masked bootstrap ``next_values * ~terminated`` at every episode end and
    from that of the last step for an unfinished tail (GAE with
    ``gae_lambda=1``)."""
    boot = next_values * (1.0 - terminated.to(rewards.dtype))
    done = done.to(torch.bool)
    ret = torch.empty_like(rewards)
    carry = boot[-1]
    for t in range(rewards.shape[0] - 1, -1, -1):
        future = torch.where(done[t], boot[t], carry)
        carry = torch.add(rewards[t], future, alpha=gamma, out=ret[t])
    return ret


def nstep_return(
    rew_chain: torch.Tensor,
    done_chain: torch.Tensor,
    q_terminal: torch.Tensor,
    gamma: float,
) -> torch.Tensor:
    """n-step bootstrapped target from pre-gathered ``[B, n]`` chains
    (saturated at episode ends) and the value-masked terminal value
    ``q_terminal [B]``."""
    returns, discount = nstep_return_components(
        rew_chain, done_chain, gamma, dtype=q_terminal.dtype
    )
    return q_terminal * discount + returns


def nstep_return_components(
    rew_chain: torch.Tensor,
    done_chain: torch.Tensor,
    gamma: float,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(accumulated_returns [B], bootstrap_discount [B])`` with
    ``target = q_terminal * discount + returns``."""
    bsz, n = rew_chain.shape
    dev = rew_chain.device
    returns = torch.zeros((bsz,), dtype=dtype, device=dev)
    gammas = torch.full((bsz,), n, dtype=torch.int32, device=dev)
    for k in range(n - 1, -1, -1):
        dk = done_chain[:, k] > 0
        gammas = torch.where(dk, k + 1, gammas)
        returns = torch.where(dk, 0.0, returns)
        returns = rew_chain[:, k].to(dtype) + gamma * returns
    # a Python-scalar base: a device tensor made from ``gamma`` would be a
    # host-to-device copy that synchronises the stream on every update
    discount = torch.pow(gamma, gammas.to(dtype))
    return returns, discount
