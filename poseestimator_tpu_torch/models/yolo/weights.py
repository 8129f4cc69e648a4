"""Carry YOLO11-seg weights across from the JAX package: the flax
``variables`` tree (given as numpy arrays) becomes the port model's
``state_dict`` (the port's own copy of the logic of
``poseestimator_tpu/models/yolo/weights.py::variables_to_state_dict``).

Conventions: flax HWIO conv kernels -> torch OIHW; the flax ConvTranspose
kernel (kh, kw, in, out) is spatially flipped -> torch (in, out, kh, kw);
BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var (plus a
zero ``num_batches_tracked``); flax module names ``m{i}``, ``m_{k}``,
``ffn_{k}`` and the head's ``m23_cv{2,3,4}_{level}`` map back to the
Ultralytics ``model.{i}.{...}`` keys.
"""
from __future__ import annotations

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


def load_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load flax variables into the port model with ``strict=True``."""
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model
