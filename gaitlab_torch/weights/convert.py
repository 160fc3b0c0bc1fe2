"""gaitlab flax variables -> this package's torch state_dicts (GRNet, YOLO).

Inverts gaitlab/weights/torch_import.py::_convert_leaf without importing
jax or gaitlab: the variables arrive as nested mappings of arrays
({'params': ..., 'batch_stats': ...}; jax arrays convert through numpy).

  conv    kernel (kh,kw,I,O)          -> weight (O,I,kh,kw)
  Dense   kernel (I,O)                -> weight (O,I); for shape_mlp and
          cam_mlp the token-major input order (j*C + c) becomes the
          reference's channel-major one (c*J + j)
  LC      weight (J,I,O)              -> weight (1,O,I,J,1,1)
  BN      scale/bias, mean/var        -> weight/bias,
                                         running_mean/running_var
                                         (+ num_batches_tracked = 0)

gaitlab's module names are the reference's torch paths with '.' written
'_' (layer1_0, fuse_layers_0_1_0, upsample_stage_2_1, ...). Its YOLO
module names are the port's own (conv{i}.conv, conv{i}.bn, conv{i}).
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# a flax module name = torch attribute name + '_'-joined Sequential indices
_MODULE_NAME = re.compile(r"^(upsample_stage_\d|[a-z_]*[a-z]\d?)((?:_\d+)*)$")
_LEAF = {"kernel": "weight", "scale": "weight", "weight": "weight",
         "bias": "bias", "mean": "running_mean", "var": "running_var"}
_TOKEN_MAJOR_DENSE = ("shape_mlp", "cam_mlp")
NUM_JOINTS = 24


def torch_module_path(flax_names) -> str:
    """('backbone', 'stage2_0', 'branches_0_1') -> 'backbone.stage2.0.branches.0.1'."""
    parts = []
    for name in flax_names:
        m = _MODULE_NAME.match(name)
        if m is None:
            raise KeyError(f"unrecognised flax module name {name!r}")
        parts.append(m.group(1))
        parts.extend(i for i in m.group(2).split("_") if i)
    return ".".join(parts)


def _convert_leaf(module: str, leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and v.ndim == 4:  # HWIO -> OIHW
        return v.transpose(3, 2, 0, 1)
    if leaf == "kernel" and v.ndim == 2:  # (I,O) -> (O,I)
        v = v.T
        if module in _TOKEN_MAJOR_DENSE:
            o, i = v.shape
            c = i // NUM_JOINTS
            v = v.reshape(o, NUM_JOINTS, c).transpose(0, 2, 1).reshape(o, i)
        return v
    if leaf == "weight" and v.ndim == 3:  # LC (J,I,O) -> (1,O,I,J,1,1)
        return v.transpose(2, 1, 0)[None, :, :, :, None, None]
    return v


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _state_dict(variables: Mapping, module_path) -> dict:
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            *mods, leaf = path
            module = module_path(mods)
            v = _convert_leaf(mods[-1], leaf, np.asarray(value, np.float32))
            sd[f"{module}.{_LEAF[leaf]}"] = torch.from_numpy(
                np.ascontiguousarray(v))
            if leaf == "mean":
                sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_from_flax(variables: Mapping) -> dict:
    """gaitlab GRNetCore (or sub-module) variables -> torch state_dict."""
    return _state_dict(variables, torch_module_path)


def yolo_state_dict_from_flax(variables: Mapping) -> dict:
    """gaitlab YoloNet variables -> the state_dict of gaitlab_torch's
    YoloNet, whose submodules carry the Flax names ('conv{i}.conv',
    'conv{i}.bn', 'conv{i}')."""
    return _state_dict(variables, ".".join)
