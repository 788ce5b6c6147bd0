"""Convolutional encoders and heads for pixel observations (port of
``MinAtarCNN``, ``NatureCNN``, ``ConvQNet``, ``ConvValueNet`` and
``ConvDuelingQNet`` in ``tianshou_tpu/networks/conv.py``).

The public layout is the JAX package's: observations come in as
``[B, H, W, C]`` (or ``[B, S, H, W]`` stacks, see :func:`_to_hwc`), and the
flatten before the first dense layer is in Flax's ``(h, w, c)`` order, so
weights carried over from Flax (:mod:`.convert`) give the same function.
Inside, the convolutions run on an NCHW view of the NHWC tensor.

With ``compute_dtype=torch.bfloat16`` (the default) parameters stay float32
and are cast for each layer; the encoder returns float32 features, as in
the JAX package.  Initialisation follows Flax's defaults: lecun-normal
kernels (truncated normal, variance ``1 / fan_in``) and zero biases.

``MinAtarCNN``'s 3x3 convolution keeps Flax's default ``"SAME"`` padding
(one cell on each side, so a 10x10 grid stays 10x10).  ``ConvQRDQNNet`` is
the QRDQN head over either encoder.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MinAtarCNN", "NatureCNN", "ConvQNet", "ConvValueNet", "ConvDuelingQNet", "ConvQRDQNNet"]

# stddev of a standard normal truncated to [-2, 2] (Flax's variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _to_hwc(x: torch.Tensor, layout: str = "auto") -> torch.Tensor:
    """Normalise pixel layouts to ``[B, H, W, C']``:

    - ``[B, H, W, C]``: channels-last already;
    - ``[B, S, H, W]``: channel-first stack of grayscale frames, the stack
      becomes channels;
    - ``[B, S, H, W, C]``: stacked multi-channel frames, stack folded into
      channels.

    ``layout`` tells the 4-D forms apart: ``"hwc"``, ``"chw"``, or
    ``"auto"``, which reads a last dimension above 8 as channel-first.
    """
    if x.dim() == 5:
        b, s, h, w, c = x.shape
        x = x.movedim(1, -2).reshape(b, h, w, s * c)
    elif x.dim() == 4:
        chw = layout == "chw" or (layout == "auto" and x.shape[-1] > 8)
        if chw:
            x = x.movedim(1, -1)
    return x


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class MinAtarCNN(nn.Module):
    """MinAtar-scale encoder: 3x3x16 conv ("SAME") + dense(128), ReLU.

    ``obs_shape`` is one observation's shape, in any layout that
    :func:`_to_hwc` reads.
    """

    def __init__(
        self,
        obs_shape: tuple[int, ...],
        hidden: int = 128,
        channels: int = 16,
        compute_dtype: torch.dtype | None = torch.bfloat16,
        layout: str = "auto",
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layout = layout
        h, w, c = _to_hwc(torch.empty((1, *obs_shape), device="meta"), layout).shape[1:]
        self.convs = nn.ModuleList([nn.Conv2d(c, channels, 3, padding=1)])
        self.dense = nn.Linear(h * w * channels, hidden)
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in (*self.convs, self.dense):
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.input_dtype
        conv = self.convs[0]
        x = _to_hwc(x, self.layout).to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # Flax's (h, w, c) flatten
        x = F.relu(F.linear(x, self.dense.weight.to(dt), self.dense.bias.to(dt)))
        return x.to(torch.float32)


class NatureCNN(nn.Module):
    """DeepMind Nature-DQN encoder (84x84 stacked frames -> 512 features).

    ``obs_shape`` is one observation's shape, in any layout that
    :func:`_to_hwc` reads; PyTorch layers need their input sizes up front.
    """

    def __init__(
        self,
        obs_shape: tuple[int, ...],
        hidden: int = 512,
        compute_dtype: torch.dtype | None = torch.bfloat16,
        layout: str = "auto",
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layout = layout
        h, w, c = _to_hwc(torch.empty((1, *obs_shape), device="meta"), layout).shape[1:]
        convs = []
        for out, k, s in ((32, 8, 4), (64, 4, 2), (64, 3, 1)):
            convs.append(nn.Conv2d(c, out, k, stride=s))
            c, h, w = out, (h - k) // s + 1, (w - k) // s + 1
        if h < 1 or w < 1:
            raise ValueError(f"observation {obs_shape} is too small for NatureCNN (needs >= 36x36)")
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(h * w * c, hidden)
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype the encoder computes in; the replay presample gathers
        observations straight into it."""
        return self.compute_dtype or torch.float32

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in (*self.convs, self.dense):
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.input_dtype
        x = _to_hwc(x, self.layout).to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW view
        for conv in self.convs:
            x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # Flax's (h, w, c) flatten
        x = F.relu(F.linear(x, self.dense.weight.to(dt), self.dense.bias.to(dt)))
        return x.to(torch.float32)


_ENCODERS = {"minatar": MinAtarCNN, "nature": NatureCNN}


def _encoder(name: str, obs_shape: tuple[int, ...], kwargs: dict | None) -> nn.Module:
    if name not in _ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; have {sorted(_ENCODERS)}")
    return _ENCODERS[name](obs_shape, **(kwargs or {}))


class _ConvHeads(nn.Module):
    """An encoder and float32 linear heads over its features; subclasses
    name the heads and combine them."""

    heads: tuple[str, ...]

    def __init__(self, obs_shape, head_dims: tuple[int, ...], encoder: str, encoder_kwargs: dict | None):
        super().__init__()
        self.encoder = _encoder(encoder, obs_shape, encoder_kwargs)
        for name, dim in zip(self.heads, head_dims):
            setattr(self, name, nn.Linear(self.encoder.dense.out_features, dim))
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.encoder.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.encoder.reset_parameters(generator)
        for name in self.heads:
            head = getattr(self, name)
            _lecun_normal_(head.weight, generator)
            nn.init.zeros_(head.bias)


class ConvQNet(_ConvHeads):
    """Pixel obs -> Q-values: encoder + linear head (the Atari ``DQN``
    net).  ``encoder`` is ``"minatar"`` or ``"nature"``."""

    heads = ("head",)

    def __init__(self, obs_shape, num_actions: int, encoder: str = "nature", encoder_kwargs: dict | None = None):
        super().__init__(obs_shape, (num_actions,), encoder, encoder_kwargs)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(obs))


class ConvValueNet(_ConvHeads):
    """Pixel obs -> scalar state value ``[B]`` (on-policy conv critic)."""

    heads = ("head",)

    def __init__(self, obs_shape, encoder: str = "minatar", encoder_kwargs: dict | None = None):
        super().__init__(obs_shape, (1,), encoder, encoder_kwargs)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(obs)).squeeze(-1)


class ConvDuelingQNet(_ConvHeads):
    """Dueling head over a conv encoder: Q = V + A - mean(A)."""

    heads = ("v", "a")

    def __init__(self, obs_shape, num_actions: int, encoder: str = "minatar", encoder_kwargs: dict | None = None):
        super().__init__(obs_shape, (1, num_actions), encoder, encoder_kwargs)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        feat = self.encoder(obs)
        v, a = self.v(feat), self.a(feat)
        return v + a - a.mean(dim=-1, keepdim=True)


class ConvQRDQNNet(_ConvHeads):
    """Pixel obs -> per-action quantile values ``[B, A, num_quantiles]``:
    an encoder and one linear head (the Atari QRDQN net)."""

    heads = ("head",)

    def __init__(self, obs_shape, num_actions: int, num_quantiles: int = 200, encoder: str = "minatar",
                 encoder_kwargs: dict | None = None):
        self.num_actions, self.num_quantiles = num_actions, num_quantiles
        super().__init__(obs_shape, (num_actions * num_quantiles,), encoder, encoder_kwargs)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(obs)).reshape(obs.shape[0], self.num_actions, self.num_quantiles)
