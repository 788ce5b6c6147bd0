"""Carry Flax parameters over to the port's modules.

Flax keeps convolution kernels as HWIO and dense kernels as ``[in, out]``;
PyTorch keeps OIHW and ``[out, in]``.  Because :class:`~.conv.NatureCNN`
flattens in Flax's ``(h, w, c)`` order, the dense kernel needs only a
transpose.  Arrays come in as numpy (``jax.device_get`` of the Flax tree),
so this module imports nothing of JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["params_from_flax"]


def _layer(prefix: str, flax_layer: Mapping, out: dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(flax_layer["kernel"], np.float32)
    if kernel.ndim == 4:
        weight = kernel.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif kernel.ndim == 2:
        weight = kernel.T  # [in, out] -> [out, in]
    else:
        raise ValueError(f"{prefix}: unexpected kernel shape {kernel.shape}")
    out[f"{prefix}.weight"] = torch.from_numpy(np.ascontiguousarray(weight))
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(flax_layer["bias"], np.float32))


def params_from_flax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """State dict of :class:`~.conv.ConvQNet` (NatureCNN encoder) from the
    Flax ``ConvQNet(encoder="nature")`` parameter tree, e.g.
    ``{'params': {'NatureCNN_0': {'Conv_0': {'kernel': (8, 8, 4, 32), ...},
    ..., 'Dense_0': {'kernel': (3136, 512), ...}}, 'Dense_0': {...}}}``."""
    tree = flax_params.get("params", flax_params)
    enc = tree["NatureCNN_0"]
    out: dict[str, torch.Tensor] = {}
    for i in range(3):
        _layer(f"encoder.convs.{i}", enc[f"Conv_{i}"], out)
    _layer("encoder.dense", enc["Dense_0"], out)
    _layer("head", tree["Dense_0"], out)
    return out
