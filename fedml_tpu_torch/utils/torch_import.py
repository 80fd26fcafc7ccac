"""Import reference PyTorch checkpoints into the port's parameters (the
port's own copy of ``fedml_tpu/utils/torch_import.py``).

The reference's pretrained loading (``torch.load`` of a ``{'state_dict':
...}`` checkpoint, the DataParallel ``module.`` prefix stripped) meets
the port's flat flax-keyed dict (``Conv_0/kernel``, or ``params/...``
and ``batch_stats/...`` for a stateful model).  Both sides enumerate the
same sequence of units (conv, norm, dense) in creation order, so the
import zips the two walks, structurally: conv kernels OIHW -> HWIO,
dense ``[out, in]`` -> ``[in, out]``, a norm's ``weight`` -> ``scale``,
its running statistics -> ``batch_stats/<unit>/{mean,var}``.  Any unit
count or shape mismatch raises (a silent partial load is how a wrong
checkpoint hides)."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.pytree import Tree


def strip_module_prefix(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Strip DataParallel's leading ``module.`` only (a mid-key
    ``module.`` belongs to a real attribute name)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """``torch.load`` -> a numpy state_dict (the reference's
    ``{'state_dict': ...}`` wrapper unwrapped, the prefix stripped)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.detach().cpu().numpy()
            for k, v in strip_module_prefix(sd).items()
            if hasattr(v, "detach")}


def _torch_units(sd: Dict[str, Any]) -> List[Dict[str, np.ndarray]]:
    """Consecutive same-prefix entries grouped into per-module units."""
    units: List[Dict[str, np.ndarray]] = []
    prev = None
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        prefix, name = k.rsplit(".", 1) if "." in k else ("", k)
        if prefix != prev:
            units.append({})
            prev = prefix
        units[-1][name] = (v.detach().cpu().numpy() if hasattr(v, "detach")
                           else np.asarray(v))
    return units


_TYPE_RANK = {"Conv": 0, "ConvTranspose": 0, "Norm": 1}


def _elem_key(name: str):
    """Creation order from flax's auto-names: ``Conv_i`` before ``Norm_i``
    before a container of the same index, unindexed names (``fc``)
    last."""
    prefix, _, idx = name.rpartition("_")
    if prefix and idx.isdigit():
        return (0, int(idx), _TYPE_RANK.get(prefix, 2), prefix)
    return (1, 0, 0, name)


def _flax_units(params: Tree, prefix: str
                ) -> List[Tuple[Tuple[str, ...], Dict[str, str]]]:
    """The leaf modules (holding ``kernel``, or ``scale``, or only a
    ``bias``) of the flat dict's ``prefix`` collection, in creation
    order: ``(path, {leaf name: flat key})``."""
    mods: Dict[Tuple[str, ...], Dict[str, str]] = {}
    for key in params:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        mods.setdefault(tuple(path), {})[leaf] = key
    units = [(p, leaves) for p, leaves in mods.items()
             if "kernel" in leaves or "scale" in leaves
             or set(leaves) == {"bias"}]
    units.sort(key=lambda u: tuple(_elem_key(p) for p in u[0]))
    return units


def _put(out: Tree, key: str, value: np.ndarray) -> None:
    like = out[key]
    if tuple(value.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(like.shape)} vs torch "
                         f"{tuple(value.shape)}")
    out[key] = torch.as_tensor(np.ascontiguousarray(value)).to(
        dtype=like.dtype, device=like.device)


def import_torch_state_dict(params: Tree, state_dict: Dict[str, Any]
                            ) -> Tree:
    """A new flat dict: ``params`` (bare, or ``params/...`` +
    ``batch_stats/...``) filled from an ordered torch state_dict."""
    stateful = any(k.startswith("params/") for k in params)
    prefix = "params/" if stateful else ""
    out = {k: v.clone() for k, v in params.items()}
    t_units = _torch_units(state_dict)
    f_units = _flax_units(params, prefix)
    if len(t_units) != len(f_units):
        raise ValueError(
            f"unit count mismatch: torch has {len(t_units)} modules, the "
            f"port's model {len(f_units)} — architectures differ")
    for (path, leaves), tu in zip(f_units, t_units):
        where = "/".join(path)
        if "kernel" in leaves:
            w = tu.get("weight")
            if w is None:
                raise ValueError(f"{where}: torch unit has no weight")
            ndim = out[leaves["kernel"]].dim()
            if ndim == 4:                          # OIHW -> HWIO
                w = w.transpose(2, 3, 1, 0)
            elif ndim == 2:                        # [out, in] -> [in, out]
                w = w.T
            _put(out, leaves["kernel"], w)
            if "bias" in leaves and "bias" in tu:
                _put(out, leaves["bias"], tu["bias"])
            continue
        if "scale" in leaves and "weight" in tu:
            _put(out, leaves["scale"], tu["weight"])
        if "bias" in leaves and "bias" in tu:
            _put(out, leaves["bias"], tu["bias"])
        if "running_mean" in tu and stateful:
            stats = f"batch_stats/{where}/"
            if stats + "mean" in out:
                _put(out, stats + "mean", tu["running_mean"])
                _put(out, stats + "var", tu["running_var"])
    return out


def load_pretrained_resnet(path: str, depth: int = 56,
                           num_classes: int = 10):
    """``resnet56(class_num, pretrained=True, path=...)``: the BatchNorm
    model and its stateful parameters with the checkpoint's weights and
    running statistics."""
    from fedml_tpu_torch.models import resnet56, resnet110
    from fedml_tpu_torch.trainer.workload import ClassificationWorkload
    model = (resnet56 if depth == 56 else resnet110)(num_classes,
                                                     norm="batch")
    params = ClassificationWorkload(model, num_classes,
                                    stateful=True).init()
    return model, import_torch_state_dict(params,
                                          load_torch_checkpoint(path))
