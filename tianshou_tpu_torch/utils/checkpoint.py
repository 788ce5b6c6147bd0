"""Checkpoint and restore of a training state: parameters, optimizer state,
replay buffer and counters (port of ``tianshou_tpu/utils/checkpoint.py``,
which writes orbax checkpoints).

A checkpoint is a directory (``path``, or ``path/step_N``) holding one
``torch.save`` file: the state's tensor leaves as a flat list, each copied
to host memory on its own, and a description of the structure around them
(dataclasses, dicts, ``Batch``es, tuples and lists, modules as state dicts,
optimizers as their state dicts, generators as their states, and plain
numbers).  The file holds only tensors and plain containers, so
``torch.load(weights_only=True)`` reads it.

:func:`restore_checkpoint` rebuilds the state in the structure of a
template, with every tensor on the template's device, and raises on any
difference of structure, shape or dtype.  The restored state owns its
storage and shares none with the template (the port updates the ring and
the sum tree in place), while tensors that share storage in the template,
and modules the template holds twice (a ``target`` that is the online
network), are shared alike in the result.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any

import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_checkpoint_step"]

_FILE = "checkpoint.pt"
_FORMAT = "tianshou_tpu_torch.checkpoint/1"
_VALUES = (bool, int, float, str, type(None))


def _describe(x: Any, leaves: list[torch.Tensor]) -> Any:
    """The structure of ``x``, its tensors appended to ``leaves`` as host
    copies that own their storage (a view is copied alone, not with its
    base)."""

    def leaf(t: torch.Tensor) -> dict:
        leaves.append(t.detach().to("cpu", copy=True))
        return {"kind": "tensor", "index": len(leaves) - 1}

    if isinstance(x, torch.Tensor):
        return leaf(x)
    if isinstance(x, nn.Module):
        return {"kind": "module", "type": type(x).__qualname__,
                "state": {k: leaf(v) for k, v in x.state_dict().items()}}
    if isinstance(x, torch.optim.Optimizer):
        return {"kind": "optimizer", "type": type(x).__qualname__, "state": _describe(x.state_dict(), leaves)}
    if isinstance(x, torch.Generator):
        return {"kind": "generator", "state": leaf(x.get_state())}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"kind": "dataclass", "type": type(x).__qualname__,
                "fields": {f.name: _describe(getattr(x, f.name), leaves) for f in dataclasses.fields(x)}}
    if isinstance(x, dict):
        return {"kind": "dict", "type": type(x).__qualname__,
                "items": [[k, _describe(v, leaves)] for k, v in x.items()]}
    if isinstance(x, (tuple, list)):
        return {"kind": "list" if isinstance(x, list) else "tuple", "items": [_describe(v, leaves) for v in x]}
    if isinstance(x, _VALUES):
        return {"kind": "value", "value": x}
    raise TypeError(f"cannot checkpoint a {type(x).__qualname__}")


def _rebuild(desc: Any, leaves: list[torch.Tensor]) -> Any:
    """A description's plain value (the saved state dict of an optimizer)."""
    kind = desc["kind"]
    if kind == "tensor":
        return leaves[desc["index"]]
    if kind == "dict":
        return {k: _rebuild(v, leaves) for k, v in desc["items"]}
    if kind in ("tuple", "list"):
        items = [_rebuild(v, leaves) for v in desc["items"]]
        return tuple(items) if kind == "tuple" else items
    if kind == "value":
        return desc["value"]
    raise ValueError(f"unexpected {kind!r} inside an optimizer's state")


def save_checkpoint(path: str, state: Any, step: int | None = None, overwrite: bool = True) -> str:
    """Save ``state`` into the directory ``path`` (``path/step_N`` with
    ``step``); returns the directory.  Tensors are copied to host memory
    one at a time, so the card never holds a second copy of the state."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    target = os.path.join(path, _FILE)
    if os.path.exists(target) and not overwrite:
        raise FileExistsError(target)
    leaves: list[torch.Tensor] = []
    tree = _describe(state, leaves)
    os.makedirs(path, exist_ok=True)
    torch.save({"format": _FORMAT, "tree": tree, "leaves": leaves}, target + ".tmp")
    os.replace(target + ".tmp", target)
    return path


def _check(what: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ValueError(f"{what}: checkpoint has {got.dtype}{list(got.shape)}, "
                         f"template {want.dtype}{list(want.shape)}")


class _Restorer:
    def __init__(self, leaves: list[torch.Tensor]):
        self.leaves = leaves
        # template object id -> its copy: shared modules and parameters stay
        # shared, and an optimizer's copy steps the copied parameters
        self.memo: dict[int, Any] = {}

    def tensor(self, what: str, template: torch.Tensor, desc: dict) -> torch.Tensor:
        leaf = self.leaves[desc["index"]]
        _check(what, leaf, template)
        out = copy.deepcopy(template, self.memo)  # storage of its own, views kept as views
        with torch.no_grad():
            out.copy_(leaf)
        return out

    def __call__(self, template: Any, desc: Any, what: str = "state") -> Any:
        kind = desc["kind"]
        expect = self._kind(template)
        if kind != expect:
            raise ValueError(f"{what}: checkpoint holds a {kind}, template a {expect}")
        if kind == "tensor":
            return self.tensor(what, template, desc)
        if kind in ("module", "optimizer", "dataclass", "dict") and desc.get("type") != type(template).__qualname__:
            raise ValueError(f"{what}: checkpoint holds a {desc.get('type')}, template a {type(template).__qualname__}")
        if kind == "module":
            out = copy.deepcopy(template, self.memo)
            params = out.state_dict(keep_vars=True)
            if set(params) != set(desc["state"]):
                raise ValueError(f"{what}: state dict keys differ: {sorted(set(params) ^ set(desc['state']))}")
            with torch.no_grad():
                for k, t in params.items():
                    leaf = self.leaves[desc["state"][k]["index"]]
                    _check(f"{what}.{k}", leaf, t)
                    t.copy_(leaf)
            return out
        if kind == "optimizer":
            out = copy.deepcopy(template, self.memo)
            saved = _rebuild(desc["state"], self.leaves)
            params = [p for group in out.param_groups for p in group["params"]]
            ids = [i for group in saved["param_groups"] for i in group["params"]]
            if len(ids) != len(params):
                raise ValueError(f"{what}: {len(ids)} parameters in the checkpoint, {len(params)} in the template")
            for i, p in zip(ids, params):
                for k, v in saved["state"].get(i, {}).items():
                    if isinstance(v, torch.Tensor) and v.dim() > 0 and v.shape != p.shape:
                        raise ValueError(f"{what}: state {k!r} of a {list(p.shape)} parameter is {list(v.shape)}")
            out.load_state_dict(saved)
            return out
        if kind == "generator":
            out = torch.Generator(device=template.device)
            out.set_state(self.leaves[desc["state"]["index"]])
            return out
        if kind == "dataclass":
            out = copy.copy(template)
            for f in dataclasses.fields(template):
                if f.name not in desc["fields"]:
                    raise ValueError(f"{what}: no field {f.name!r} in the checkpoint")
                object.__setattr__(out, f.name, self(getattr(template, f.name), desc["fields"][f.name],
                                                     f"{what}.{f.name}"))
            return out
        if kind == "dict":
            items = dict((k, v) for k, v in desc["items"])
            if list(items) != list(template):
                raise ValueError(f"{what}: keys {list(items)} in the checkpoint, {list(template)} in the template")
            return type(template)((k, self(v, items[k], f"{what}[{k!r}]")) for k, v in template.items())
        if kind in ("tuple", "list"):
            if len(desc["items"]) != len(template):
                raise ValueError(f"{what}: {len(desc['items'])} items in the checkpoint, {len(template)} in the template")
            items = [self(t, d, f"{what}[{i}]") for i, (t, d) in enumerate(zip(template, desc["items"]))]
            if hasattr(template, "_fields"):
                return type(template)(*items)
            return type(template)(items)
        return desc["value"]

    @staticmethod
    def _kind(x: Any) -> str:
        if isinstance(x, torch.Tensor):
            return "tensor"
        if isinstance(x, nn.Module):
            return "module"
        if isinstance(x, torch.optim.Optimizer):
            return "optimizer"
        if isinstance(x, torch.Generator):
            return "generator"
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return "dataclass"
        if isinstance(x, dict):
            return "dict"
        if isinstance(x, (tuple, list)):
            return "list" if isinstance(x, list) else "tuple"
        return "value"


def restore_checkpoint(path: str, template: Any) -> Any:
    """The state saved in the directory ``path``, rebuilt in ``template``'s
    structure on its devices; raises ``ValueError`` on any mismatch."""
    saved = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu", weights_only=True)
    if saved.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a checkpoint of this package")
    return _Restorer(saved["leaves"])(template, saved["tree"])


def latest_checkpoint_step(base: str) -> int | None:
    """The largest ``N`` of the ``step_N`` directories under ``base``."""
    if not os.path.isdir(base):
        return None
    steps = [
        int(d.split("_", 1)[1])
        for d in os.listdir(base)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None
