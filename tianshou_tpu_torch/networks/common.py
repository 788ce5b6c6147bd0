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
shared by the K members, so it is expanded without a copy.  A scalar head
(a critic's) is a product and a sum over the hidden units, not a batched
product with one output column.  Every layer so computes a member the same
way whatever the number of members a product holds (on the H100, cuBLAS
picks its one-column kernel, and the weight gradient's kernel of a
broadcast first layer, by the number of members), so a sharded ensemble's
members equal the unsharded ensemble's bitwise.  Each member draws its own
init, as ``nn.vmap``'s ``split_rngs`` gives.
:class:`QNetEnsemble` (DiscreteSAC's critics), the branch heads of
:class:`BranchingQNet` (BDQ) and ``CriticEnsemble`` are built on it.

Ensemble parallelism (the JAX package's ``"ep"`` mesh axis): after
:meth:`EnsembleMLP.shard_` over a process group of ``ep`` ranks, a rank
holds its ``K / ep`` members (rank r members ``[r K/ep, (r+1) K/ep)``) and
its forward is the Megatron-style pair of operators around them.  At the
input, identity forward and an ``all_reduce`` (sum) of the input's gradient
backward: the input is the same on every rank, and each rank's backward
computes only its own members' share of it.  At the output, the ranks'
``[K/ep, B, out]`` are gathered into the full ``[K, B, out]`` forward (a
zero-filled buffer, each rank's members written in, one ``all_reduce`` of
its bytes: bitwise, on gloo's CUDA tensors too), and backward takes the
rank's own members' slice of the incoming gradient, with no communication.
Every rank then computes the same loss from the full output, so the
algorithms see ``[K, B, out]`` and need no change.
(``torch.distributed.nn.functional.all_gather`` would sum the gradient
over the ranks in its backward: ``ep`` times the members' gradients when
every rank computes the same loss.)  :meth:`EnsembleMLP.reset_parameters`
draws all K members from the generator and keeps the rank's, so a sharded
ensemble starts equal to the unsharded one.  :func:`full_state_dict`
gathers a module's sharded ensembles, :func:`load_full_state_dict` loads a
full state dict into a sharded module.

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.networks.conv import _lecun_normal_

__all__ = ["MLP", "QNet", "QNetEnsemble", "DuelingQNet", "RecurrentQNet", "EnsembleMLP", "BranchingQNet",
           "EnsembleShard", "full_state_dict", "load_full_state_dict", "sharded_members"]


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


class EnsembleShard:
    """An ensemble's place on the ``ep`` axis: the process ``group``, this
    rank's index in it and its size.  Copies of a sharded module (targets,
    templates) share it: the group is not copied."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    def __deepcopy__(self, memo):
        return self

    def members(self, ensemble_size: int) -> slice:
        """This rank's members of an ensemble of ``ensemble_size``."""
        k = ensemble_size // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The ranks' ``[K/ep, ...]`` members joined into ``[K, ...]``: a
        zero-filled buffer with this rank's members written in, summed over
        the group as bytes (exactly one rank writes each byte)."""
        full = local.new_zeros((local.shape[0] * self.size,) + tuple(local.shape[1:]))
        full[self.members(full.shape[0])] = local
        dist.all_reduce(full.view(torch.uint8), group=self.group)
        return full


class _ToEnsembleShards(torch.autograd.Function):
    """Identity forward; backward sums the input's gradient over the ``ep``
    group (each rank computed its own members' share)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.shard.group)
        return grad, None


class _FromEnsembleShards(torch.autograd.Function):
    """Gathers the members forward; backward keeps this rank's members'
    slice of the gradient (every rank computes the same loss)."""

    @staticmethod
    def forward(ctx, local, shard):
        ctx.shard = shard
        return shard.gather(local)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.shard.members(grad.shape[0])], None


class EnsembleMLP(nn.Module):
    """K independent MLPs evaluated together: ``[B, ...] -> [K, B,
    output_dim]``, the hidden layers with ReLU.  Sharded (:meth:`shard_`),
    it holds ``K / ep`` members and still returns all K."""

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
        self.shard: EnsembleShard | None = None
        sizes = [_flat_dim(input_shape), *hidden_sizes, output_dim]
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.empty(ensemble_size, i, o)) for i, o in zip(sizes[:-1], sizes[1:])])
        self.biases = nn.ParameterList([nn.Parameter(torch.empty(ensemble_size, o)) for o in sizes[1:]])
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def members(self) -> slice:
        """The members this module holds, of the K."""
        return slice(0, self.ensemble_size) if self.shard is None else self.shard.members(self.ensemble_size)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Every member's init in turn from ``generator``, all K of them
        when sharded, of which this rank keeps its own."""
        last = len(self.weights) - 1
        with torch.no_grad():
            for i, (w, b) in enumerate(zip(self.weights, self.biases)):
                full = w if self.shard is None else w.new_empty((self.ensemble_size,) + tuple(w.shape[1:]))
                for k in range(self.ensemble_size):
                    nn.init.orthogonal_(full[k], gain=1.0 if i == last else math.sqrt(2.0), generator=generator)
                if full is not w:
                    w.copy_(full[self.members()])
                nn.init.zeros_(b)

    def shard_(self, group, optimizers: Sequence[torch.optim.Optimizer] = ()) -> EnsembleMLP:
        """Keep this rank's ``K / ep`` members (``ep``: the size of the
        process ``group``), in place: each parameter keeps its identity, so
        ``optimizers`` that step it go on doing so, their per-parameter
        state (Adam's moments) sliced alike.  Returns the module."""
        if self.shard is not None:
            raise ValueError("the ensemble is sharded already")
        shard = EnsembleShard(group, dist.get_rank(group), dist.get_world_size(group))
        if self.ensemble_size % shard.size:
            raise ValueError(f"an ensemble of {self.ensemble_size} does not split over {shard.size} ranks")
        keep = shard.members(self.ensemble_size)
        with torch.no_grad():
            for p in self.parameters():
                for opt in optimizers:
                    state = opt.state.get(p, {})
                    for name, v in state.items():
                        if isinstance(v, torch.Tensor) and v.dim() > 0 and v.shape == p.shape:
                            state[name] = v[keep].clone()
                p.data = p.data[keep].clone()
        self.shard = shard
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.input_dtype
        x = x.reshape(x.shape[0], -1).to(dt)  # [B, in], shared by the K members
        if self.shard is not None:
            x = _ToEnsembleShards.apply(x, self.shard)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            w, b = w.to(dt), b.to(dt)[:, None, :]
            if i == 0:  # [B, in] expanded (a view) against [K, in, out]
                x = torch.baddbmm(b, x.expand(w.shape[0], *x.shape), w)
            elif i == last and w.shape[-1] == 1:  # a scalar head: a product and a sum over the hidden units
                x = (x * w[:, None, :, 0]).sum(dim=-1, keepdim=True) + b
            else:
                x = torch.baddbmm(b, x, w)
            if i != last:
                x = F.relu(x)
        x = x.to(torch.float32)
        return x if self.shard is None else _FromEnsembleShards.apply(x, self.shard)


def _sharded_ensembles(module: nn.Module) -> dict[str, EnsembleMLP]:
    return {name: m for name, m in module.named_modules() if isinstance(m, EnsembleMLP) and m.shard is not None}


def full_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state dict with every sharded ensemble's members
    gathered (all K); every rank of each ensemble's group calls it."""
    sd = module.state_dict()
    for name, ens in _sharded_ensembles(module).items():
        prefix = f"{name}." if name else ""
        for k, v in ens.state_dict().items():
            sd[prefix + k] = ens.shard.gather(v)
    return sd


def sharded_members(module: nn.Module) -> dict[str, slice]:
    """The members each state dict entry of ``module``'s sharded ensembles
    holds, by key."""
    return {(f"{name}." if name else "") + k: ens.members()
            for name, ens in _sharded_ensembles(module).items() for k in ens.state_dict()}


def load_full_state_dict(module: nn.Module, state: dict[str, torch.Tensor]):
    """Load a state dict of full ensembles (all K members, as an unsharded
    module holds them) into ``module``: a sharded ensemble takes its own
    members."""
    state = dict(state)
    for k, members in sharded_members(module).items():
        if k in state:
            state[k] = state[k][members]
    return module.load_state_dict(state)


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
