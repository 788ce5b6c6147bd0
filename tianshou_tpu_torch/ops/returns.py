"""n-step return estimators (port of ``nstep_return`` and
``nstep_return_components`` in ``tianshou_tpu/ops/returns.py``).

Semantics are the JAX package's: accumulation stops at ``done = terminated
| truncated``; the caller value-masks the bootstrap with ``~terminated``.
"""

from __future__ import annotations

import torch

__all__ = ["nstep_return", "nstep_return_components"]


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
