"""Convolutional encoders and heads for pixel observations (port of
``MinAtarCNN``, ``NatureCNN``, ``ConvQNet``, ``ConvValueNet`` and
``ConvDuelingQNet`` in ``tianshou_tpu/networks/conv.py``).

The public layout is the JAX package's: observations come in as
``[B, H, W, C]`` (or ``[B, S, H, W]`` stacks, see :func:`_to_hwc`), and the
flatten before the first dense layer is in Flax's ``(h, w, c)`` order, so
weights carried over from Flax (:mod:`.convert`) give the same function.
Parameters keep PyTorch's float32 NCHW (``[O, C, kh, kw]``) layout.

Inside, a float32 encoder's convolutions run on an NCHW view of the NHWC
tensor.  ``NatureCNN`` in a 16-bit compute dtype runs them channels-last
from input to flatten (:func:`_conv_nhwc`): NHWC activations and
channels-last weights, the layout cuDNN's tensor-core engines take, so
cuDNN converts nothing around them and the flatten is a view.  A strided
first layer whose input channels are not a multiple of 8, which cuDNN runs
in float32 otherwise, is rewritten by space-to-depth into a stride-1
convolution over ``C * s * s`` channels that computes the same sums.  The
counter ``conv.route`` (:mod:`~tianshou_tpu_torch.utils.trace`) counts each
convolution call by route: ``s2d_nhwc``, ``nhwc`` or ``nchw``.

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

from tianshou_tpu_torch.utils import trace

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
    ``hidden=None`` drops the dense layer: the encoder returns the
    flattened convolution features (3,136 at 84x84), as the Rainbow
    network's noisy streams take them.  :attr:`out_features` is the
    feature width either way.
    """

    def __init__(
        self,
        obs_shape: tuple[int, ...],
        hidden: int | None = 512,
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
        self.dense = None if hidden is None else nn.Linear(h * w * c, hidden)
        self.out_features = h * w * c if hidden is None else hidden
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        """The dtype the encoder computes in; the replay presample gathers
        observations straight into it."""
        return self.compute_dtype or torch.float32

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in (*self.convs, *([] if self.dense is None else [self.dense])):
            _lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.input_dtype
        x = _to_hwc(x, self.layout)
        if dt in (torch.bfloat16, torch.float16):
            for conv in self.convs:
                x = F.relu(_conv_nhwc(x, conv, dt))
        else:
            x = x.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW view
            for conv in self.convs:
                trace.count("conv.route", "nchw")
                x = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride))
            x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1)  # Flax's (h, w, c) flatten
        if self.dense is not None:
            x = F.relu(F.linear(x, self.dense.weight.to(dt), self.dense.bias.to(dt)))
        return x.to(torch.float32)


def _folds(conv: nn.Conv2d) -> bool:
    """Whether :func:`_conv_nhwc` runs ``conv`` (square and unpadded, as
    NatureCNN's are) by space-to-depth: its stride is above 1 and divides
    its kernel, and its input channels are not a multiple of 8, for which
    cuDNN has no 16-bit tensor-core engine."""
    k, s = conv.kernel_size[0], conv.stride[0]
    return s > 1 and k % s == 0 and conv.in_channels % 8 != 0


class _NHWCWeight(torch.autograd.Function):
    """A ``[O, C, k, k]`` weight as the channels-last ``[O, C*s*s, k/s,
    k/s]`` weight of its space-to-depth convolution (at ``s`` 1 the same
    weight, channels-last), in ``dtype``: one copy.  Channel ``c*s*s + dy*s
    + dx`` at tap ``(a, b)`` is ``w[:, c, a*s + dy, b*s + dx]``, the order of
    :func:`_conv_nhwc`'s input.  The gradient comes back in one copy too, in
    the parameter's dtype and contiguous layout: the optimizer's foreach
    kernels take a slow path, one launch a tensor, where a gradient's
    strides differ from its state's.  Written in the ``setup_context``
    form, so that ``torch.func.vmap`` (TRPO's line search over
    ``functional_call``) batches it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(w: torch.Tensor, dtype: torch.dtype, s: int) -> torch.Tensor:
        k = w.shape[-1]
        w = w.unflatten(2, (k // s, s)).unflatten(4, (k // s, s))  # [O, C, k/s, s, k/s, s]
        w = w.permute(0, 2, 4, 1, 3, 5).to(dtype, memory_format=torch.contiguous_format)
        return w.flatten(3).permute(0, 3, 1, 2)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        w, _, ctx.s = inputs
        ctx.param_dtype = w.dtype

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        s = ctx.s
        g = g.permute(0, 2, 3, 1).unflatten(3, (-1, s, s)).permute(0, 3, 1, 4, 2, 5)  # [O, C, k/s, s, k/s, s]
        return g.to(ctx.param_dtype, memory_format=torch.contiguous_format).flatten(4).flatten(2, 3), None, None


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    """``conv`` over ``x`` (``[B, H, W, C]``, any strides and dtype) in
    ``dt``, channels-last; returns its ``[B, H', W', O]`` output, NHWC in
    memory.

    Where :func:`_folds` holds, space-to-depth: rows and columns past
    ``(out - 1) * s + k`` (which no output reads) are cropped, the input
    becomes ``[B, H/s, W/s, C*s*s]`` in one copy that also casts it, and a
    stride-1 ``k/s`` convolution with the matching weight
    (:class:`_NHWCWeight`) computes the same sums."""
    s = conv.stride[0]
    if _folds(conv):
        trace.count("conv.route", "s2d_nhwc")
        k = conv.kernel_size[0]
        h, w = ((n - k) // s * s + k for n in x.shape[1:3])
        x = x[:, :h, :w].unflatten(1, (h // s, s)).unflatten(3, (w // s, s))  # [B, H/s, s, W/s, s, C]
        x = x.permute(0, 1, 3, 5, 2, 4).to(dt, memory_format=torch.contiguous_format).flatten(3)
        weight, s = _NHWCWeight.apply(conv.weight, dt, s), 1
    else:
        trace.count("conv.route", "nhwc")
        x = x.to(dt, memory_format=torch.contiguous_format)
        weight = _NHWCWeight.apply(conv.weight, dt, 1)
    return F.conv2d(x.permute(0, 3, 1, 2), weight, conv.bias.to(dt), stride=s).permute(0, 2, 3, 1)


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
