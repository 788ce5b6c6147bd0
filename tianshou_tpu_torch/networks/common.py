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

:class:`EnsembleMLP` holds K MLPs as one module: each layer is a ``[K, in,
out]`` weight and a ``[K, out]`` bias, and a forward is one batched product
per layer (``baddbmm``), not K separate MLPs.  Its first layer's input is
shared by the K members, so it broadcasts without a copy.  Each member
draws its own init, as ``nn.vmap``'s ``split_rngs`` gives.
:class:`QNetEnsemble` (DiscreteSAC's critics), the branch heads of
:class:`BranchingQNet` (BDQ) and ``CriticEnsemble`` are built on it.

:class:`RecurrentQNet` (DRQN) is a dense layer, an LSTM cell and a dense
head.  Its cell is Flax's ``OptimizedLSTMCell`` written out: the input
kernels have no bias, the hidden kernels have one, the gates are in the
order i, f, g, o (``torch.nn.LSTMCell``'s, whose ``bias_ih`` would be a
second, trainable bias), and the carry is Flax's ``(c, h)``.  The input
projection of every step of a sequence is one matmul.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.networks.conv import _lecun_normal_

__all__ = ["MLP", "QNet", "QNetEnsemble", "DuelingQNet", "RecurrentQNet", "EnsembleMLP", "BranchingQNet"]


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


class EnsembleMLP(nn.Module):
    """K independent MLPs evaluated together: ``[B, ...] -> [K, B,
    output_dim]``, the hidden layers with ReLU."""

    def __init__(
        self,
        ensemble_size: int,
        input_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        output_dim: int,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.ensemble_size = ensemble_size
        self.compute_dtype = compute_dtype
        sizes = [_flat_dim(input_shape), *hidden_sizes, output_dim]
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.empty(ensemble_size, i, o)) for i, o in zip(sizes[:-1], sizes[1:])])
        self.biases = nn.ParameterList([nn.Parameter(torch.empty(ensemble_size, o)) for o in sizes[1:]])
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        last = len(self.weights) - 1
        with torch.no_grad():
            for i, (w, b) in enumerate(zip(self.weights, self.biases)):
                for k in range(self.ensemble_size):
                    nn.init.orthogonal_(w[k], gain=1.0 if i == last else math.sqrt(2.0), generator=generator)
                nn.init.zeros_(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.input_dtype
        x = x.reshape(x.shape[0], -1).to(dt)  # [B, in], shared by the K members
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            w, b = w.to(dt), b.to(dt)[:, None, :]
            # [B, in] @ [K, in, out] broadcasts to [K, B, out]
            x = torch.matmul(x, w) + b if i == 0 else torch.baddbmm(b, x, w)
            if i != last:
                x = F.relu(x)
        return x.to(torch.float32)


class QNetEnsemble(EnsembleMLP):
    """K independent Q nets: ``obs -> [K, B, num_actions]`` (DiscreteSAC's
    critics)."""

    def __init__(
        self,
        input_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        num_actions: int,
        num_critics: int = 2,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__(num_critics, input_shape, hidden_sizes, num_actions, compute_dtype)


class BranchingQNet(nn.Module):
    """Branching dueling Q net for ``MultiDiscrete`` actions (BDQ): a shared
    trunk, a value head and one advantage head per branch, ``obs -> [B,
    num_branches, actions_per_branch]`` with ``Q = V + A - mean(A)`` in each
    branch."""

    def __init__(
        self,
        input_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        num_branches: int,
        actions_per_branch: int,
        value_hidden: Sequence[int] = (128,),
        action_hidden: Sequence[int] = (128,),
    ):
        super().__init__()
        self.mlp = MLP(input_shape, hidden_sizes)
        self.value = MLP(self.mlp.out_features, value_hidden, 1)
        self.branches = EnsembleMLP(num_branches, self.mlp.out_features, action_hidden, actions_per_branch)

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in (self.mlp, self.value, self.branches):
            m.reset_parameters(generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        feat = self.mlp(obs)
        v = self.value(feat)[:, None, :]  # [B, 1, 1]
        a = self.branches(feat).transpose(0, 1)  # [B, nb, apb]
        return v + a - a.mean(dim=-1, keepdim=True)


class LSTMCell(nn.Module):
    """Flax's ``OptimizedLSTMCell``: ``weight_ih [4H, in]`` (no bias),
    ``weight_hh [4H, H]`` and ``bias_hh [4H]``, gates i, f, g, o."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden_size))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's inits: lecun-normal input kernels, orthogonal hidden
        kernels (each gate's ``[H, H]`` block), zero biases."""
        with torch.no_grad():
            for gate in range(4):
                rows = slice(gate * self.hidden_size, (gate + 1) * self.hidden_size)
                _lecun_normal_(self.weight_ih[rows], generator)
                nn.init.orthogonal_(self.weight_hh[rows], generator=generator)
            nn.init.zeros_(self.bias_hh)

    def input_gates(self, x: torch.Tensor) -> torch.Tensor:
        """The input kernels' part of the gates with the hidden bias added,
        ``[..., 4H]``, computed for a whole sequence at once."""
        return F.linear(x, self.weight_ih, self.bias_hh)

    def forward(
        self, x_gates: torch.Tensor, carry: tuple[torch.Tensor, torch.Tensor]
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One step from the step's :meth:`input_gates`: the new ``(c, h)``."""
        c, h = carry
        gates = torch.addmm(x_gates, h, self.weight_hh.t())
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class RecurrentQNet(nn.Module):
    """LSTM-backed Q net over observation histories ``[B, L, obs_dim]``:
    ``(obs, carry) -> (q [B, num_actions], carry)``.  A ``[B, obs_dim]``
    observation is a history of one step.  ``carry`` is an explicit
    ``(c, h)`` pair of ``[B, hidden_size]`` tensors, so it can live in the
    collector's state; :meth:`init_carry` builds the zero state."""

    def __init__(self, obs_dim: int, hidden_size: int, num_actions: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.dense = nn.Linear(obs_dim, hidden_size)
        self.cell = LSTMCell(hidden_size, hidden_size)
        self.head = nn.Linear(hidden_size, num_actions)
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return torch.float32

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in (self.dense, self.head):
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
        self.cell.reset_parameters(generator)

    def init_carry(self, batch_size: int, device: str | torch.device | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """The zero ``(c, h)`` carry (on the parameters' device unless
        ``device`` is given)."""
        dev = self.head.weight.device if device is None else device
        z = torch.zeros((batch_size, self.hidden_size), device=dev)
        return z, z

    def forward(
        self, obs: torch.Tensor, carry: tuple[torch.Tensor, torch.Tensor]
    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        if obs.dim() == 2:
            obs = obs[:, None, :]
        x_gates = self.cell.input_gates(self.dense(obs.to(torch.float32)))  # [B, L, 4H]
        for t in range(x_gates.shape[1]):
            carry = self.cell(x_gates[:, t], carry)
        return self.head(carry[1]), carry
