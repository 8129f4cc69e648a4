"""Carry YOLO11-seg weights across from the JAX package: the flax
``variables`` tree (given as numpy arrays) becomes the port model's
``state_dict`` (the port's own copy of the logic of
``poseestimator_tpu/models/yolo/weights.py::variables_to_state_dict``).

Conventions: flax HWIO conv kernels -> torch OIHW; the flax ConvTranspose
kernel (kh, kw, in, out) is spatially flipped -> torch (in, out, kh, kw);
BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var (plus a
zero ``num_batches_tracked``); flax module names ``m{i}``, ``m_{k}``,
``ffn_{k}`` and the head's ``m23_cv{2,3,4}_{level}`` map back to the
Ultralytics ``model.{i}.{...}`` keys. ``state_dict_to_variables`` is the
inverse: a port state dict (a trained checkpoint's) as flax variables with
numpy leaves. ``translate_key`` names the flax leaf an Ultralytics key
carries, and ``load_checkpoint`` reads any weights source the detector
accepts into the port's state dict.
"""
from __future__ import annotations

import os
import re
from typing import Any, Mapping

import numpy as np
import torch

_INV_HEAD_SEQ = {
    **{f"m23_cv2_{i}": ("cv2", i, {"b0": "0", "b1": "1", "b2": "2"}) for i in range(3)},
    **{f"m23_cv4_{i}": ("cv4", i, {"m0": "0", "m1": "1", "m2": "2"}) for i in range(3)},
    **{f"m23_cv3_{i}": ("cv3", i, {"c0_0": "0.0", "c0_1": "0.1", "c1_0": "1.0",
                                   "c1_1": "1.1", "c2": "2"}) for i in range(3)},
}


def _inner(parts) -> list[str]:
    out = []
    for p in parts:
        mm = re.match(r"^m_(\d+)$", p)
        if mm:
            out += ["m", mm.group(1)]
        elif p in ("ffn_0", "ffn_1"):
            out += ["ffn", p[-1]]
        else:
            out.append(p)
    return out


def _torch_base(path) -> str | None:
    """Module path of a flax leaf's parent -> dotted torch module path."""
    top = path[0]
    if top == "m23_proto":
        return ".".join(["model.23.proto", *_inner(path[1:-1])])
    if top in _INV_HEAD_SEQ:
        branch, level, names = _INV_HEAD_SEQ[top]
        return ".".join([f"model.23.{branch}.{level}.{names[path[1]]}",
                         *_inner(path[2:-1])])
    m = re.match(r"^m(\d+)$", top)
    if m:
        return ".".join([f"model.{m.group(1)}", *_inner(path[1:-1])])
    return None


def _walk(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def variables_to_state_dict(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> port state_dict."""
    out: dict[str, torch.Tensor] = {}
    for path, w in _walk(variables.get("params", {})):
        base, leaf = _torch_base(path), path[-1]
        if base is None:
            raise KeyError(f"unmapped flax parameter {'/'.join(path)}")
        if leaf == "kernel":
            if path[-2] == "upsample":
                w = np.transpose(w[::-1, ::-1], (2, 3, 0, 1))
            else:
                w = np.transpose(w, (3, 2, 0, 1))
            key = base + ".weight"
        elif leaf == "scale":
            key = base + ".weight"
        elif leaf == "bias":
            key = base + ".bias"
        else:
            raise KeyError(f"unknown flax leaf {'/'.join(path)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(w, np.float32))
    for path, w in _walk(variables.get("batch_stats", {})):
        base = _torch_base(path)
        stat = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        out[f"{base}.{stat}"] = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        out[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out


_HEAD_SEQ = {(branch, names[k]): k for branch, _, names in _INV_HEAD_SEQ.values() for k in names}


def _flax_inner(parts) -> list[str]:
    out, i = [], 0
    while i < len(parts):
        if parts[i] in ("m", "ffn") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def _flax_path(module: str) -> tuple:
    """Dotted torch module path -> the flax path of that module (the inverse
    of ``_torch_base``)."""
    parts = module.split(".")
    if parts[0] != "model":
        raise KeyError(f"unmapped torch module {module}")
    i = parts[1]
    if i == "23" and parts[2] == "proto":
        return ("m23_proto", *_flax_inner(parts[3:]))
    if i == "23":
        branch, level = parts[2], parts[3]
        for n in (2, 1):  # "0.0"-style names of cv3 first, then "0"
            seq = ".".join(parts[4:4 + n])
            if (branch, seq) in _HEAD_SEQ:
                return (f"m23_{branch}_{level}", _HEAD_SEQ[(branch, seq)],
                        *_flax_inner(parts[4 + n:]))
        raise KeyError(f"unmapped torch module {module}")
    return (f"m{i}", *_flax_inner(parts[2:]))


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """Port state dict -> flax ``{"params", "batch_stats"}`` with numpy
    float32 leaves (``num_batches_tracked`` has no flax counterpart)."""
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        w = t.detach().to("cpu", torch.float32).numpy()
        path = _flax_path(module)
        if leaf in ("running_mean", "running_var"):
            _put(stats, (*path, "mean" if leaf == "running_mean" else "var"), w.copy())
        elif leaf == "bias":
            _put(params, (*path, "bias"), w.copy())
        elif leaf == "weight" and w.ndim == 1:
            _put(params, (*path, "scale"), w.copy())
        elif leaf == "weight" and path[-1] == "upsample":
            _put(params, (*path, "kernel"),
                 np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]))
        elif leaf == "weight":
            _put(params, (*path, "kernel"), np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))))
        else:
            raise KeyError(f"unknown state dict entry {key}")
    return {"params": params, "batch_stats": stats}


def load_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load flax variables into the port model with ``strict=True``."""
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model


def translate_key(torch_key: str):
    """An Ultralytics ``state_dict`` key -> ``(flax module path, leaf kind)``,
    or None for a key with no flax leaf (``num_batches_tracked``, the fixed
    DFL projection, anything outside ``model.``). Leaf kinds: ``conv.weight``,
    ``bn.{weight,bias,running_mean,running_var}``, ``plain.{weight,bias}``
    (the head's biased output convs), ``deconv.{weight,bias}`` (the proto
    upsample)."""
    key = torch_key
    if key.startswith("model.model."):
        key = key[len("model."):]
    if not key.startswith("model.") or key.endswith("num_batches_tracked") or ".dfl." in key:
        return None
    module, leaf = key.rsplit(".", 1)
    try:
        path = _flax_path(module)
    except KeyError:
        return None
    if path[-1] == "conv":
        return path, "conv.weight"
    if path[-1] == "bn":
        return path, f"bn.{leaf}"
    if path == ("m23_proto", "upsample"):
        return path, f"deconv.{leaf}"
    return path, f"plain.{leaf}"


def _is_tensor_map(d) -> bool:
    return all(hasattr(v, "shape") for v in d.values())


def _torch_load(path):
    """``torch.load`` of a full Ultralytics checkpoint without Ultralytics:
    classes that do not import unpickle as empty ``nn.Module``s, enough to
    walk to ``state_dict()``."""
    import pickle

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (torch.nn.Module,), {})

    class StubPickleModule:
        Unpickler = StubUnpickler

        @staticmethod
        def load(f, **kw):
            return StubUnpickler(f).load()

    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=StubPickleModule)


def load_checkpoint(source) -> dict[str, torch.Tensor]:
    """A weights source -> the port model's float32 state dict (the port's
    ``variables``): a port checkpoint ``.pt`` or state dict, flax variables
    (or a ``.npz`` holding them under ``"variables"``), an Ultralytics
    checkpoint, state dict or ``nn.Module``. The JAX trainer's orbax
    checkpoint directories are not read."""
    if isinstance(source, (str, os.PathLike)):
        path = str(source)
        if os.path.isdir(path):
            raise NotImplementedError(
                "orbax checkpoint directories are not supported; export the variables "
                "to .npz or an Ultralytics-style state dict")
        if path.endswith(".npz"):
            return variables_to_state_dict(np.load(path, allow_pickle=True)["variables"].item())
        source = _torch_load(path)
    if isinstance(source, Mapping) and "params" in source:
        if not _is_tensor_map(source["params"]):
            return variables_to_state_dict(source)  # flax variables
        source = source["params"]  # a port checkpoint
    if isinstance(source, Mapping) and "model" in source and not _is_tensor_map(source):
        source = source["model"]
    if hasattr(source, "state_dict"):
        source = source.state_dict()
    if not isinstance(source, Mapping):
        raise TypeError(f"cannot interpret checkpoint of type {type(source)}")
    out = {}
    for k, v in source.items():
        if k.startswith("model.model."):
            k = k[len("model."):]
        if translate_key(k) is None and not k.endswith("num_batches_tracked"):
            continue  # the fixed DFL projection (decode_boxes computes it), non-model keys
        v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        out[k] = v.float() if v.is_floating_point() else v  # fp16 checkpoints
    return out
