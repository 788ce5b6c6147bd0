"""Carry Flax parameters over to the port's modules.

Flax keeps convolution kernels as HWIO and dense kernels as ``[in, out]``;
PyTorch keeps OIHW and ``[out, in]``.  Because the port's encoders flatten
in Flax's ``(h, w, c)`` order, a dense kernel needs only a transpose.
Arrays come in as numpy (``jax.device_get`` of the Flax tree), so this
module imports nothing of JAX.

Flax names submodules by class and creation order; the port's names are:

| Flax                                   | port                         |
| -------------------------------------- | ---------------------------- |
| ``NatureCNN_0`` / ``MinAtarCNN_0``     | ``encoder``                  |
| encoder ``Conv_i``, ``Dense_0``        | ``convs.i``, ``dense``       |
| ``MLP_0``                              | ``mlp``                      |
| MLP ``Dense_i``                        | ``layers.i``                 |
| one top-level ``Dense_0``              | ``head``                     |
| top-level ``Dense_0``, ``Dense_1``     | ``v``, ``a`` (dueling heads) |

which covers ``MLP``, ``QNet``, ``DuelingQNet``, ``MinAtarCNN``,
``NatureCNN``, ``ConvQNet``, ``ConvValueNet`` and ``ConvDuelingQNet``, and
of the continuous nets ``DeterministicActor`` and ``Critic`` (an
``MLP_0`` alone).  ``heads`` names the top-level ``Dense`` layers where
the default above does not fit: ``GaussianActor`` passes
``heads=("mu", "sigma")``; its state-independent ``log_sigma`` parameter
keeps its name.

The distributional nets: ``QRDQNNet`` and a plain ``C51Net`` are an
``MLP_0`` alone; ``ImplicitQuantileNetwork`` is ``MLP_0`` and three top-level
``Dense`` layers, ``heads=("phi", "head1", "head2")``;
``FullQuantileFunction`` names its modules ``trunk`` (-> ``mlp``), ``phi``,
``head1`` and ``head2``; ``FractionProposalNetwork`` is one ``Dense_0``,
``heads=("head",)``; ``ConvQRDQNNet`` is an encoder and one head.  A noisy
``C51Net`` keeps its dense layers as ``trunk.i`` and its ``NoisyMLP_0`` /
``NoisyMLP_1`` as ``a`` / ``v``, whose ``NoisyLinear`` kernels ``w_mu`` and
``w_sigma`` are transposed like any dense kernel.

The ensembles' Flax trees are ``nn.vmap``'s, with a leading K axis on
every leaf: ``VmapCritic_0`` (``CriticEnsemble``) and ``VmapQNet_0``
(``QNetEnsemble``) -> ``MLP_0`` -> ``Dense_i``, and ``VmapMLP_0``
(``EnsembleMLP``) -> ``Dense_i``.  The port keeps the same ``[K, in, out]``
kernels (``weights.i``, no transpose, the layout ``baddbmm`` takes) and
``[K, out]`` biases (``biases.i``).  ``BranchingQNet`` is ``MLP_0`` (the
trunk, -> ``mlp``), ``MLP_1`` (the value head, -> ``value``) and
``VmapMLP_0`` (the branch heads, -> ``branches``).  ``RecurrentQNet`` is
``Dense_0`` (-> ``dense``), ``OptimizedLSTMCell_0`` (-> ``cell``) and
``Dense_1`` (-> ``head``); the cell's per-gate kernels ``ii/if/ig/io``
(no bias) and ``hi/hf/hg/ho`` are stacked in that gate order into
``weight_ih`` and ``weight_hh`` (transposed), their biases into
``bias_hh``.

Modules that name their submodules in ``setup`` keep those names: BCQ's
``VAE`` (``encoder`` and ``decoder`` MLPs, ``mean_head`` and
``log_std_head`` Dense layers) and ICM's ``ICMNet`` (``encoder``,
``forward_head`` and ``inverse_head`` MLPs); an MLP ``name``'s ``Dense_i``
becomes ``name.layers.i``.  BCQ's ``Perturbation`` is an ``MLP_0`` alone.

:func:`onpolicy_state_from_flax` carries an on-policy train state: the
``{"actor": ..., "critic": ...}`` parameters (a ``ValueNet`` critic is an
``MLP_0`` alone) and the running return statistics ``ret_mean``,
``ret_var`` and ``ret_count``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

from tianshou_tpu_torch.networks.common import load_full_state_dict

__all__ = ["params_from_flax", "onpolicy_state_from_flax", "load_flax_params"]

_ENCODERS = ("NatureCNN_0", "MinAtarCNN_0")


def _layer(prefix: str, flax_layer: Mapping, out: dict[str, torch.Tensor]) -> None:
    kernel = np.asarray(flax_layer["kernel"], np.float32)
    if kernel.ndim == 4:
        weight = kernel.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif kernel.ndim == 2:
        weight = kernel.T  # [in, out] -> [out, in]
    else:
        raise ValueError(f"{prefix}: unexpected kernel shape {kernel.shape}")
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(weight, order="C"))  # a writable, contiguous copy
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(flax_layer["bias"], np.float32))


def _numbered(tree: Mapping, kind: str) -> list[str]:
    """``kind_0, kind_1, ...`` in numeric order."""
    names = [k for k in tree if k.startswith(kind + "_")]
    return sorted(names, key=lambda k: int(k.rsplit("_", 1)[1]))


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _encoder(tree: Mapping, prefix: str, out: dict) -> None:
    for i, name in enumerate(_numbered(tree, "Conv")):
        _layer(_join(prefix, f"convs.{i}"), tree[name], out)
    _layer(_join(prefix, "dense"), tree["Dense_0"], out)


def _mlp(tree: Mapping, prefix: str, out: dict) -> None:
    for i, name in enumerate(_numbered(tree, "Dense")):
        _layer(_join(prefix, f"layers.{i}"), tree[name], out)


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


def _ensemble(tree: Mapping, prefix: str = "", out: dict | None = None) -> dict[str, torch.Tensor]:
    """One ``nn.vmap``-ed MLP: ``Vmap*_0`` (-> ``MLP_0``) -> ``Dense_i``."""
    (vmapped,) = [k for k in tree if k.startswith("Vmap")]
    mlp = tree[vmapped].get("MLP_0", tree[vmapped])
    out = {} if out is None else out
    for i, name in enumerate(_numbered(mlp, "Dense")):
        out[_join(prefix, f"weights.{i}")] = _tensor(mlp[name]["kernel"])
        out[_join(prefix, f"biases.{i}")] = _tensor(mlp[name]["bias"])
    return out


def _lstm(cell: Mapping, prefix: str, out: dict) -> None:
    """An ``OptimizedLSTMCell``'s per-gate kernels, stacked i, f, g, o."""
    gates = "ifgo"
    out[f"{prefix}.weight_ih"] = _tensor(np.concatenate([np.asarray(cell["i" + g]["kernel"]).T for g in gates]))
    out[f"{prefix}.weight_hh"] = _tensor(np.concatenate([np.asarray(cell["h" + g]["kernel"]).T for g in gates]))
    out[f"{prefix}.bias_hh"] = _tensor(np.concatenate([np.asarray(cell["h" + g]["bias"]) for g in gates]))


def _noisy(tree: Mapping, prefix: str, out: dict) -> None:
    """A ``NoisyMLP``'s ``NoisyLinear_i`` layers.  Flax stores ``w_mu`` and
    ``b_mu`` as draws from ``[0, 2 / sqrt(in))`` and shifts them by
    ``-1 / sqrt(in)`` in every forward; the port stores the shifted
    means."""
    for i, name in enumerate(_numbered(tree, "NoisyLinear")):
        layer, p = tree[name], f"{prefix}.layers.{i}"
        w_mu = np.asarray(layer["w_mu"], np.float32)
        bound = np.float32(1.0 / np.sqrt(w_mu.shape[0]))
        out[f"{p}.w_mu"] = _tensor((w_mu - bound).T)
        out[f"{p}.b_mu"] = _tensor(np.asarray(layer["b_mu"], np.float32) - bound)
        out[f"{p}.w_sigma"] = _tensor(np.asarray(layer["w_sigma"], np.float32).T)
        out[f"{p}.b_sigma"] = _tensor(layer["b_sigma"])


def _noisy_c51(tree: Mapping) -> dict[str, torch.Tensor]:
    """``C51Net(noisy=True)``: dense ``Dense_i`` -> ``trunk.i``, then the
    advantage head ``NoisyMLP_0`` -> ``a`` and the value head
    ``NoisyMLP_1`` -> ``v``."""
    out: dict[str, torch.Tensor] = {}
    for i, name in enumerate(_numbered(tree, "Dense")):
        _layer(f"trunk.{i}", tree[name], out)
    for port_name, name in zip(("a", "v"), _numbered(tree, "NoisyMLP")):
        _noisy(tree[name], port_name, out)
    return out


def _setup_named(tree: Mapping) -> bool:
    """Whether every submodule of ``tree`` has a ``setup`` name (no
    ``Class_i`` auto-name)."""
    return bool(tree) and all(isinstance(v, Mapping) and not re.fullmatch(r"[A-Z]\w*_\d+", k)
                              for k, v in tree.items())


def params_from_flax(flax_params: Mapping, heads: tuple[str, ...] | None = None) -> dict[str, torch.Tensor]:
    """State dict of the port's counterpart of a Flax network, from its
    parameter tree, e.g. for ``ConvQNet(encoder="nature")``
    ``{'params': {'NatureCNN_0': {'Conv_0': {'kernel': (8, 8, 4, 32), ...},
    ..., 'Dense_0': {'kernel': (3136, 512), ...}}, 'Dense_0': {...}}}``.
    ``heads``: the port's names of the top-level ``Dense`` layers, in Flax's
    order."""
    tree = flax_params.get("params", flax_params)
    if "OptimizedLSTMCell_0" in tree:
        out: dict[str, torch.Tensor] = {}
        _layer("dense", tree["Dense_0"], out)
        _lstm(tree["OptimizedLSTMCell_0"], "cell", out)
        _layer("head", tree["Dense_1"], out)
        return out
    if "VmapMLP_0" in tree and "MLP_0" in tree:
        # BranchingQNet
        out = {}
        _mlp(tree["MLP_0"], "mlp", out)
        _mlp(tree["MLP_1"], "value", out)
        return _ensemble(tree, "branches", out)
    if any(k.startswith("Vmap") for k in tree):
        return _ensemble(tree)
    if any(k.startswith("NoisyMLP") for k in tree):
        return _noisy_c51(tree)
    out: dict[str, torch.Tensor] = {}
    if "trunk" in tree:
        # FullQuantileFunction names its modules in ``setup``
        _mlp(tree["trunk"], "mlp", out)
        for name in ("phi", "head1", "head2"):
            _layer(name, tree[name], out)
        return out
    if _setup_named(tree):
        # a Dense layer or an MLP under each name (VAE, ICMNet)
        for name, sub in tree.items():
            if "kernel" in sub:
                _layer(name, sub, out)
            else:
                _mlp(sub, name, out)
        return out
    if "log_sigma" in tree:
        out["log_sigma"] = _tensor(tree["log_sigma"])
    body = [k for k in (*_ENCODERS, "MLP_0") if k in tree]
    if not body and heads is not None:
        # top-level Dense layers alone (FractionProposalNetwork)
        for name, flax_name in zip(heads, _numbered(tree, "Dense"), strict=True):
            _layer(name, tree[flax_name], out)
        return out
    if not body:
        # a bare encoder or a bare MLP
        (_encoder if "Conv_0" in tree else _mlp)(tree, "", out)
        return out
    if body[0] == "MLP_0":
        _mlp(tree["MLP_0"], "mlp", out)
    else:
        _encoder(tree[body[0]], "encoder", out)
    flax_heads = _numbered(tree, "Dense")
    names = heads if heads is not None else {0: (), 1: ("head",), 2: ("v", "a")}[len(flax_heads)]
    if len(names) != len(flax_heads):
        raise ValueError(f"{len(flax_heads)} top-level Dense layers but heads={names}")
    for name, flax_name in zip(names, flax_heads):
        _layer(name, tree[flax_name], out)
    return out


def _heads_of(module: torch.nn.Module) -> tuple[str, ...] | None:
    """The ``heads`` :func:`params_from_flax` needs for ``module``."""
    name = type(module).__name__
    if name == "GaussianActor":
        return ("mu", "sigma") if module.conditioned_sigma else ("mu",)
    if name == "ImplicitQuantileNetwork":
        return ("phi", "head1", "head2")
    if name == "FractionProposalNetwork":
        return ("head",)
    return getattr(module, "heads", None)  # the conv nets name their heads


def load_flax_params(module: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """``module`` with the Flax counterpart's parameters loaded (strict),
    the heads picked from its class: what the high-level factories build
    takes no per-class argument.  A sharded ensemble (``EnsembleMLP.shard_``)
    takes its own members of the Flax ensemble."""
    load_full_state_dict(module, params_from_flax(flax_params, heads=_heads_of(module)))
    return module


def onpolicy_state_from_flax(state, actor_heads: tuple[str, ...] | None = None) -> dict:
    """``{"actor": state dict, "critic": state dict, "ret_mean": tensor,
    ...}`` from the JAX package's on-policy ``TrainState`` with numpy
    leaves (``jax.device_get``); ``critic`` and the return statistics only
    where the state has them.  ``actor_heads`` as for
    :func:`params_from_flax` (``("mu",)`` for a ``GaussianActor`` with a
    state-independent sigma)."""
    params = state.params
    out: dict = {"actor": params_from_flax(params["actor"], heads=actor_heads)}
    if "critic" in params:
        out["critic"] = params_from_flax(params["critic"])
    for name in ("ret_mean", "ret_var", "ret_count"):
        value = getattr(state, name, None)
        if value is not None:
            out[name] = _tensor(value)
    return out
