"""Core fully connected networks (port of ``MLP``, ``QNet`` and
``DuelingQNet`` in ``tianshou_tpu/networks/common.py``).

Initialisation follows the JAX package: orthogonal hidden kernels with gain
sqrt(2), an orthogonal output kernel with gain 1, zero biases; the dueling
heads keep Flax's default lecun-normal.  Flax draws an orthogonal kernel on
``[in, out]`` and PyTorch on ``[out, in]``, so the two inits agree in law,
not in value: weights carried over by :mod:`.convert` give the same
function.  With ``compute_dtype`` (e.g. ``torch.bfloat16``) parameters stay
float32 and are cast for each layer, and the output is float32; with
``torch.float64`` (and the parameters cast by ``.double()``) the whole
forward, output included, stays in float64.

The ensemble, recurrent and branching nets come with their algorithms.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.networks.conv import _lecun_normal_

__all__ = ["MLP", "QNet", "DuelingQNet"]


def _flat_dim(input_shape: int | Sequence[int]) -> int:
    return input_shape if isinstance(input_shape, int) else math.prod(input_shape)


class MLP(nn.Module):
    """Plain MLP: hidden layers with ``activation``, optional linear output.
    Inputs ``[B, ...]`` are flattened to ``[B, prod(input_shape)]``."""

    def __init__(
        self,
        input_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        output_dim: int | None = None,
        activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.activation = activation
        self.compute_dtype = compute_dtype
        sizes = [_flat_dim(input_shape), *hidden_sizes]
        layers = [nn.Linear(i, o) for i, o in zip(sizes[:-1], sizes[1:])]
        self.has_output = output_dim is not None
        if self.has_output:
            layers.append(nn.Linear(sizes[-1], output_dim))
        self.layers = nn.ModuleList(layers)
        self.out_features = sizes[-1] if output_dim is None else output_dim
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for i, layer in enumerate(self.layers):
            is_output = self.has_output and i == len(self.layers) - 1
            nn.init.orthogonal_(layer.weight, gain=1.0 if is_output else math.sqrt(2.0), generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.input_dtype
        x = x.reshape(x.shape[0], -1).to(dt)
        for i, layer in enumerate(self.layers):
            x = F.linear(x, layer.weight.to(dt), layer.bias.to(dt))
            if not (self.has_output and i == len(self.layers) - 1):
                x = self.activation(x)
        return x.to(torch.promote_types(dt, torch.float32))


class QNet(nn.Module):
    """State -> Q-values for each discrete action."""

    def __init__(
        self,
        input_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        num_actions: int,
        activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.mlp = MLP(input_shape, hidden_sizes, num_actions, activation, compute_dtype)

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs)


class DuelingQNet(nn.Module):
    """Dueling architecture: Q = V + A - mean(A), float32 heads."""

    def __init__(
        self,
        input_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        num_actions: int,
        activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.mlp = MLP(input_shape, hidden_sizes, None, activation, compute_dtype)
        self.v = nn.Linear(self.mlp.out_features, 1)
        self.a = nn.Linear(self.mlp.out_features, num_actions)
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)
        for head in (self.v, self.a):
            _lecun_normal_(head.weight, generator)
            nn.init.zeros_(head.bias)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        feat = self.mlp(obs)
        v, a = self.v(feat), self.a(feat)
        return v + a - a.mean(dim=-1, keepdim=True)
