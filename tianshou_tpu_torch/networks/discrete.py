"""Distributional heads and noisy layers for discrete control (port of
``tianshou_tpu/networks/discrete.py``).

- :class:`NoisyLinear` is the factorised-Gaussian noisy layer (NoisyNet).
  Its forward is a deterministic function of the noise: it takes the raw
  standard normal pair ``(eps_in [in], eps_out [out])``, maps each through
  ``f(e) = sign(e) * sqrt(|e|)`` and adds ``w_sigma * outer(f(eps_out),
  f(eps_in))`` to the mean weight.  Without noise it is the mean linear
  layer.  :func:`draw_noise` draws the pairs of every noisy layer of a
  network from a generator in one launch, in the network's layer order
  (the order in which the JAX package's layers draw theirs), so a forward
  can be repeated with the same noise and the tests can inject the JAX
  package's draws.
- :class:`C51Net` (noisy branch dueling or not, plain branch an ``MLP``),
  :class:`ConvC51Net` (the pixel Rainbow network: Nature CNN features,
  dueling noisy streams) and :class:`QRDQNNet` return ``[B, A, atoms]`` probabilities and ``[B, A,
  K]`` quantiles.
- :class:`ImplicitQuantileNetwork` maps ``(obs [B, d], taus [B, K])`` to
  ``[B, K, A]`` through a cosine embedding of the fractions;
  :class:`FullQuantileFunction` is the same network with its state
  features and its quantile head exposed apart, for FQF's fraction
  proposals (:class:`FractionProposalNetwork`).

Initialisation follows the JAX package: ``MLP`` layers orthogonal, the
plain dense layers Flax's lecun-normal with zero biases, the fraction
proposal's kernel Xavier-uniform, the noisy means uniform in ``[-1/sqrt(in),
1/sqrt(in))`` with sigmas ``0.5 / sqrt(in)``.  PyTorch layers need their input
sizes up front, so every constructor takes ``input_shape`` (or the feature
width).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.networks.common import MLP, _flat_dim
from tianshou_tpu_torch.networks.conv import NatureCNN, _lecun_normal_

__all__ = [
    "NoisyLinear",
    "NoisyMLP",
    "C51Net",
    "ConvC51Net",
    "QRDQNNet",
    "ImplicitQuantileNetwork",
    "FractionProposalNetwork",
    "FullQuantileFunction",
    "draw_noise",
]

Noise = Sequence[tuple[torch.Tensor, torch.Tensor]]


def _scaled(e: torch.Tensor) -> torch.Tensor:
    return torch.sign(e) * torch.sqrt(torch.abs(e))


class NoisyLinear(nn.Module):
    """Factorised-Gaussian noisy linear layer; ``forward(x, None)`` uses the
    mean weights (evaluation)."""

    def __init__(self, in_features: int, out_features: int, sigma0: float = 0.5):
        super().__init__()
        self.in_features, self.out_features, self.sigma0 = in_features, out_features, sigma0
        self.w_mu = nn.Parameter(torch.empty(out_features, in_features))
        self.b_mu = nn.Parameter(torch.empty(out_features))
        self.w_sigma = nn.Parameter(torch.empty(out_features, in_features))
        self.b_sigma = nn.Parameter(torch.empty(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            for p in (self.w_mu, self.b_mu):
                p.uniform_(-bound, bound, generator=generator)
            for p in (self.w_sigma, self.b_sigma):
                p.fill_(self.sigma0 / math.sqrt(self.in_features))

    def forward(self, x: torch.Tensor, noise: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
        if noise is None:
            return F.linear(x, self.w_mu, self.b_mu)
        eps_in, eps_out = _scaled(noise[0]), _scaled(noise[1])
        w = self.w_mu + self.w_sigma * torch.outer(eps_out, eps_in)
        return F.linear(x, w, self.b_mu + self.b_sigma * eps_out)


def draw_noise(net: nn.Module, generator: torch.Generator) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Standard normal ``(eps_in, eps_out)`` for every :class:`NoisyLinear`
    of ``net`` in module order, from one draw of ``generator``."""
    layers = [m for m in net.modules() if isinstance(m, NoisyLinear)]
    sizes = [n for m in layers for n in (m.in_features, m.out_features)]
    flat = torch.randn((sum(sizes),), generator=generator, device=generator.device)
    parts = flat.split(sizes)
    return list(zip(parts[0::2], parts[1::2]))


class NoisyMLP(nn.Module):
    """An MLP of :class:`NoisyLinear` layers (the Rainbow head) with the
    noise scale ``sigma0``; ``noise`` holds one pair per layer, or is
    ``None`` for the mean weights."""

    def __init__(self, in_features: int, hidden_sizes: Sequence[int], output_dim: int, sigma0: float = 0.5):
        super().__init__()
        sizes = [in_features, *hidden_sizes, output_dim]
        self.layers = nn.ModuleList([NoisyLinear(i, o, sigma0) for i, o in zip(sizes[:-1], sizes[1:])])

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor, noise: Noise | None = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x, None if noise is None else noise[i])
            if i < last:
                x = F.relu(x)
        return x


class C51Net(nn.Module):
    """obs -> per-action categorical distribution over the support atoms,
    ``[B, A, num_atoms]`` probabilities.

    With ``noisy``: dense ReLU layers, then noisy heads of one 128-unit
    hidden layer, dueling (advantage head ``a`` then value head ``v``)
    unless ``dueling=False``; ``forward(obs, noise)`` takes the pairs of
    :func:`draw_noise` (``None``: the mean weights).  Without ``noisy``: an
    ``MLP`` with a linear output, and no noise."""

    def __init__(
        self,
        input_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        num_actions: int,
        num_atoms: int = 51,
        noisy: bool = False,
        dueling: bool = True,
    ):
        super().__init__()
        self.num_actions, self.num_atoms, self.noisy, self.dueling = num_actions, num_atoms, noisy, dueling
        out = num_actions * num_atoms
        if noisy:
            sizes = [_flat_dim(input_shape), *hidden_sizes]
            self.trunk = nn.ModuleList([nn.Linear(i, o) for i, o in zip(sizes[:-1], sizes[1:])])
            self.a = NoisyMLP(sizes[-1], (128,), out)
            self.v = NoisyMLP(sizes[-1], (128,), num_atoms) if dueling else None
        else:
            self.mlp = MLP(input_shape, hidden_sizes, out)
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return torch.float32

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        if not self.noisy:
            self.mlp.reset_parameters(generator)
            return
        for layer in self.trunk:
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
        for head in (self.a, self.v):
            if head is not None:
                head.reset_parameters(generator)

    def forward(self, obs: torch.Tensor, noise: Noise | None = None) -> torch.Tensor:
        bsz = obs.shape[0]
        shape = (bsz, self.num_actions, self.num_atoms)
        if not self.noisy:
            return torch.softmax(self.mlp(obs).reshape(shape), dim=-1)
        feat = obs.reshape(bsz, -1).to(torch.float32)
        for layer in self.trunk:
            feat = F.relu(layer(feat))
        n_a = len(self.a.layers)
        a = self.a(feat, None if noise is None else noise[:n_a]).reshape(shape)
        if self.v is None:
            return torch.softmax(a, dim=-1)
        v = self.v(feat, None if noise is None else noise[n_a:])
        logits = v[:, None, :] + a - a.mean(dim=1, keepdim=True)
        return torch.softmax(logits, dim=-1)


class ConvC51Net(nn.Module):
    """Pixel obs -> per-action categorical distribution ``[B, A,
    num_atoms]``: the Rainbow network of Hessel et al. 2018 (Tianshou's
    Atari ``Rainbow``).  The Nature CNN's convolutions without their dense
    layer (:class:`~tianshou_tpu_torch.networks.conv.NatureCNN` with
    ``hidden=None``) give the flattened features; two noisy streams of one
    ``hidden``-unit layer each, with noise scale ``noisy_std``, give the
    advantage ``a`` (``A * num_atoms`` logits) and the value ``v``
    (``num_atoms``), combined as ``v + a - mean_a(a)`` and normalised by a
    softmax over the atoms.  The streams run in float32; ``input_dtype`` is
    the encoder's, so the replay gathers observations straight into it.
    ``forward(obs, noise)`` takes the pairs of :func:`draw_noise`, which
    lists the advantage stream's layers first (``None``: the mean
    weights)."""

    def __init__(
        self,
        obs_shape: tuple[int, ...],
        num_actions: int,
        num_atoms: int = 51,
        hidden: int = 512,
        noisy_std: float = 0.5,
        encoder_kwargs: dict | None = None,
    ):
        super().__init__()
        self.num_actions, self.num_atoms = num_actions, num_atoms
        self.encoder = NatureCNN(obs_shape, **{**(encoder_kwargs or {}), "hidden": None})
        feat = self.encoder.out_features
        self.a = NoisyMLP(feat, (hidden,), num_actions * num_atoms, sigma0=noisy_std)
        self.v = NoisyMLP(feat, (hidden,), num_atoms, sigma0=noisy_std)

    @property
    def input_dtype(self) -> torch.dtype:
        return self.encoder.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for part in (self.encoder, self.a, self.v):
            part.reset_parameters(generator)

    def forward(self, obs: torch.Tensor, noise: Noise | None = None) -> torch.Tensor:
        feat = self.encoder(obs)
        n_a = len(self.a.layers)
        a = self.a(feat, None if noise is None else noise[:n_a]).reshape(obs.shape[0], self.num_actions,
                                                                          self.num_atoms)
        v = self.v(feat, None if noise is None else noise[n_a:])
        return torch.softmax(v[:, None, :] + a - a.mean(dim=1, keepdim=True), dim=-1)


class QRDQNNet(nn.Module):
    """obs -> per-action quantile values ``[B, A, num_quantiles]``."""

    def __init__(
        self, input_shape: int | Sequence[int], hidden_sizes: Sequence[int], num_actions: int,
        num_quantiles: int = 200,
    ):
        super().__init__()
        self.num_actions, self.num_quantiles = num_actions, num_quantiles
        self.mlp = MLP(input_shape, hidden_sizes, num_actions * num_quantiles)

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs).reshape(obs.shape[0], self.num_actions, self.num_quantiles)


class ImplicitQuantileNetwork(nn.Module):
    """IQN: ``(obs [B, d], taus [B, K]) -> [B, K, A]``.  The state features
    (an ``MLP`` trunk) are multiplied by ``relu(phi(cos(pi * tau * i)))``,
    ``i = 1..embedding_dim``, then two dense layers give the quantiles."""

    def __init__(
        self, input_shape: int | Sequence[int], hidden_sizes: Sequence[int], num_actions: int,
        embedding_dim: int = 64,
    ):
        super().__init__()
        self.embedding_dim = embedding_dim
        self.mlp = MLP(input_shape, hidden_sizes, None)
        width = self.mlp.out_features
        self.phi = nn.Linear(embedding_dim, width)
        self.head1 = nn.Linear(width, width)
        self.head2 = nn.Linear(width, num_actions)
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)
        for layer in (self.phi, self.head1, self.head2):
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs)

    def quantiles(self, feat: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
        """``[B, K, A]`` quantile values at ``taus [B, K]`` from the state
        features ``feat [B, F]``."""
        i = torch.arange(1, self.embedding_dim + 1, dtype=torch.float32, device=taus.device)
        phi = F.relu(self.phi(torch.cos(math.pi * taus[..., None] * i)))  # [B, K, F]
        return self.head2(F.relu(self.head1(feat[:, None, :] * phi)))

    def forward(self, obs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
        return self.quantiles(self.features(obs), taus)


class FullQuantileFunction(ImplicitQuantileNetwork):
    """FQF's quantile function: IQN's network, read through
    :meth:`features` (for the fraction proposals) and :meth:`quantiles`."""


class FractionProposalNetwork(nn.Module):
    """FQF's fraction proposal: state features ``[B, F]`` -> ``(taus [B,
    K+1], tau_hats [B, K], entropy [B])``, the cumulative softmax of one
    dense layer with a Xavier-uniform kernel."""

    def __init__(self, feature_dim: int, num_fractions: int = 32):
        super().__init__()
        self.head = nn.Linear(feature_dim, num_fractions)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        nn.init.xavier_uniform_(self.head.weight, generator=generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        logits = self.head(feat)
        probs = torch.softmax(logits, dim=-1)
        tau = torch.cumsum(probs, dim=-1)
        taus = torch.cat([torch.zeros_like(tau[:, :1]), tau], dim=-1)
        tau_hats = (taus[:, :-1] + taus[:, 1:]) / 2.0
        entropy = -(probs * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
        return taus, tau_hats, entropy
