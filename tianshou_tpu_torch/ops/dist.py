"""Distribution math (port of ``tianshou_tpu/ops/dist.py``): the diagonal
Gaussian, the tanh-squashed Gaussian and the categorical.

The JAX package draws inside each sampler from a key.  Here every sampler is
a deterministic function of its noise (``eps``, a standard normal draw, or
``gumbel``, a standard Gumbel draw), and the draw is a separate call on a
``torch.Generator``: torch's Philox stream never matches JAX's Threefry
stream, so the parity tests feed the JAX package's own draws to these
functions.

``tanh_log_prob_correction`` uses the stable form
``log(1 - tanh(u)^2) = 2 * (log 2 - u - softplus(-2u))``.  ``F.softplus``
switches to the identity above ``threshold=20``; there ``softplus(x)`` and
``x`` differ by ``log1p(exp(-x)) < 2.1e-9``, below float32 resolution at
that magnitude, so it agrees with ``jax.nn.softplus`` to float32 rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "standard_normal",
    "standard_gumbel",
    "normal_sample",
    "normal_log_prob",
    "normal_entropy",
    "tanh_normal_sample_and_log_prob",
    "tanh_log_prob_correction",
    "categorical_sample",
    "categorical_log_prob",
    "categorical_entropy",
    "kl_normal",
    "kl_categorical",
]

_LOG_2PI = math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


def standard_normal(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """``N(0, 1)`` noise shaped like ``like``, on its device."""
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def standard_gumbel(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise shaped like ``like`` (``-log(-log(U))``, ``U``
    uniform on the open interval as ``jax.random.gumbel`` draws it)."""
    tiny = torch.finfo(like.dtype).tiny
    u = torch.rand(like.shape, generator=generator, device=like.device, dtype=like.dtype)
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def normal_sample(mu: torch.Tensor, sigma: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return mu + sigma * eps


def normal_log_prob(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Summed over the trailing action dim (``Independent(Normal, 1)``)."""
    z = (x - mu) / sigma
    return (-0.5 * (z**2 + _LOG_2PI) - torch.log(sigma)).sum(dim=-1)


def normal_entropy(sigma: torch.Tensor) -> torch.Tensor:
    return (0.5 * (1.0 + _LOG_2PI) + torch.log(sigma)).sum(dim=-1)


def tanh_log_prob_correction(pre_tanh: torch.Tensor) -> torch.Tensor:
    """``sum_i log(1 - tanh(u_i)^2)``, computed stably."""
    return (2.0 * (_LOG_2 - pre_tanh - F.softplus(-2.0 * pre_tanh))).sum(dim=-1)


def tanh_normal_sample_and_log_prob(
    mu: torch.Tensor, sigma: torch.Tensor, eps: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reparameterised sample of ``tanh(Normal(mu, sigma))`` from the noise
    ``eps``, with its log-prob."""
    u = normal_sample(mu, sigma, eps)
    return torch.tanh(u), normal_log_prob(u, mu, sigma) - tanh_log_prob_correction(u)


def categorical_sample(logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sample from the noise ``gumbel`` (what
    ``jax.random.categorical`` computes from its key)."""
    return torch.argmax(logits + gumbel, dim=-1)


def categorical_log_prob(act: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return logp.gather(-1, act.to(torch.int64)[..., None]).squeeze(-1)


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def kl_normal(
    mu_p: torch.Tensor, sigma_p: torch.Tensor, mu_q: torch.Tensor, sigma_q: torch.Tensor
) -> torch.Tensor:
    """KL(p || q) for diagonal Gaussians, summed over the action dim."""
    var_ratio = (sigma_p / sigma_q) ** 2
    t = ((mu_p - mu_q) / sigma_q) ** 2
    return (0.5 * (var_ratio + t - 1.0) - torch.log(torch.sqrt(var_ratio))).sum(dim=-1)


def kl_categorical(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) between categorical distributions given logits."""
    logp = F.log_softmax(logits_p, dim=-1)
    logq = F.log_softmax(logits_q, dim=-1)
    return (logp.exp() * (logp - logq)).sum(dim=-1)
