"""gaitlab flax variables -> this package's torch state_dicts (GRNet, YOLO,
the legacy HMR).

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
'_' (layer1_0, fuse_layers_0_1_0, upsample_stage_2_1,
downsample_stage_1_0, ...; HMR's
backbone/layer2_0/downsample_0, head/decpose). Its YOLO
module names are the port's own (conv{i}.conv, conv{i}.bn, conv{i}).

The gait branch ('pfeat_corrector') has no reference checkpoint; the
port's modules carry gaitlab's names there, and `gait_state_dict_from_flax`
maps it leaf by leaf:
  Dense        kernel (I,O)            -> weight (O,I)
  attention    query/key/value kernel (I,H,D) -> weight (H*D,I), bias (H,D)
               -> (H*D); out kernel (H,D,O) -> weight (O,H*D)
  LayerNorm    scale                   -> weight
  token LC     weight (J,I,O), bias (J,O) as they are
  GRU          l{k}_{fwd|bwd}/{ir,iz,in,hr,hz,hn} -> weight_ih_l{k}[_reverse]
               = [ir|iz|in]^T, weight_hh = [hr|hz|hn]^T, bias_ih =
               [b_ir|b_iz|b_in], bias_hh = [0|0|b_hn] (Flax has no b_hr,
               b_hz)
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# a flax module name = torch attribute name + '_'-joined Sequential indices
_MODULE_NAME = re.compile(
    r"^((?:up|down)sample_stage_\d|[a-z_]*[a-z]\d?)((?:_\d+)*)$")
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


def _state_dict(variables: Mapping, module_path, skip=()) -> dict:
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(coll, {})):
            if path[0] in skip:
                continue
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
    sd = _state_dict(variables, torch_module_path, skip=("pfeat_corrector",))
    gait = variables.get("params", {}).get("pfeat_corrector")
    if gait is not None:
        sd.update({f"pfeat_corrector.{k}": v for k, v in
                   gait_state_dict_from_flax(gait)[0].items()})
    return sd


_GRU_CELL = re.compile(r"^l(\d+)_(fwd|bwd)$")
_ATTENTION = ("temporal", "spatial")


def _gru_leaves(rnn: Mapping, prefix: tuple, sd: dict, sources: dict):
    """Pack gaitlab's GRU cells (one Dense per gate) into nn.GRU tensors."""
    for cell_name, cell in rnn.items():
        m = _GRU_CELL.match(cell_name)
        if m is None:
            raise KeyError(f"unrecognised GRU cell {cell_name!r}")
        sfx = f"_l{m.group(1)}" + ("_reverse" if m.group(2) == "bwd" else "")
        kernel = {g: np.asarray(cell[g]["kernel"], np.float32).T
                  for g in ("ir", "iz", "in", "hr", "hz", "hn")}
        b_hn = np.asarray(cell["hn"]["bias"], np.float32)
        packed = {
            f"weight_ih{sfx}": np.concatenate(
                [kernel["ir"], kernel["iz"], kernel["in"]]),
            f"weight_hh{sfx}": np.concatenate(
                [kernel["hr"], kernel["hz"], kernel["hn"]]),
            f"bias_ih{sfx}": np.concatenate(
                [np.asarray(cell[g]["bias"], np.float32)
                 for g in ("ir", "iz", "in")]),
            f"bias_hh{sfx}": np.concatenate(
                [np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn]),
        }
        src = {f"weight_ih{sfx}": [(g, "kernel") for g in ("ir", "iz", "in")],
               f"weight_hh{sfx}": [(g, "kernel") for g in ("hr", "hz", "hn")],
               f"bias_ih{sfx}": [(g, "bias") for g in ("ir", "iz", "in")],
               f"bias_hh{sfx}": [("hn", "bias")]}
        for key, v in packed.items():
            name = ".".join(prefix + (key,))
            sd[name] = torch.from_numpy(np.ascontiguousarray(v))
            sources[name] = [prefix + (cell_name,) + s for s in src[key]]


def gait_state_dict_from_flax(params: Mapping) -> tuple[dict, dict]:
    """gaitlab's 'pfeat_corrector' params -> (the port's FeatCorrector
    state_dict, and for each of its keys the gaitlab leaf paths it was
    made from)."""
    sd, sources = {}, {}
    rnns = []
    for path, value in _leaves(params):
        *mods, leaf = path
        if "rnn" in mods:
            i = mods.index("rnn")
            if tuple(mods[:i + 1]) not in rnns:
                rnns.append(tuple(mods[:i + 1]))
            continue
        v = np.asarray(value, np.float32)
        parent = mods[-2] if len(mods) > 1 else ""
        if leaf == "kernel":
            if parent in _ATTENTION and mods[-1] == "out":
                v = v.reshape(-1, v.shape[-1]).T     # (H,D,O) -> (O,H*D)
            elif parent in _ATTENTION:
                v = v.reshape(v.shape[0], -1).T      # (I,H,D) -> (H*D,I)
            else:
                v = v.T                              # (I,O) -> (O,I)
        elif leaf == "bias" and parent in _ATTENTION:
            v = v.reshape(-1)
        elif leaf not in ("bias", "scale", "weight"):
            raise KeyError(f"unrecognised leaf {'/'.join(path)}")
        name = ".".join(mods + [_LEAF[leaf]])
        sd[name] = torch.from_numpy(np.ascontiguousarray(v))
        sources[name] = [tuple(path)]
    for prefix in rnns:
        sub = params
        for k in prefix:
            sub = sub[k]
        _gru_leaves(sub, prefix, sd, sources)
    return sd, sources


def yolo_state_dict_from_flax(variables: Mapping) -> dict:
    """gaitlab YoloNet variables -> the state_dict of gaitlab_torch's
    YoloNet, whose submodules carry the Flax names ('conv{i}.conv',
    'conv{i}.bn', 'conv{i}')."""
    return _state_dict(variables, ".".join)


def hmr_state_dict_from_flax(variables: Mapping) -> dict:
    """gaitlab HMRCore variables -> the state_dict of gaitlab_torch's
    HMRCore (ResNet backbone, regressor head)."""
    return _state_dict(variables, torch_module_path)
