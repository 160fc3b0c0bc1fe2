"""Reference checkpoint loading.

The port's modules carry the reference's state_dict keys, so the three
checkpoint flavours load with key filtering only, no layout translation:
  1. a GRNet checkpoint ({'gen_state_dict': ...}, the demo's checkpoint)
     into a GRNetCore;
  2. a PARE lightning checkpoint ('model.head.*' keys, with the
     regressor's init_pose / init_shape / init_cam and the temperature,
     which the port's head does not hold) into a PareHead;
  3. an HRNet checkpoint, filtered to the pretrained layers, into the
     backbone.
Each loader returns the module's keys the checkpoint lacked and the
checkpoint's keys the module does not have.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# HRNet layers taken from a pretrained checkpoint, and the upsampling
# heads taken with them
HRNET_PRETRAINED_LAYERS = (
    "conv1", "bn1", "conv2", "bn2", "layer1", "transition1", "stage2",
    "transition2", "stage3", "transition3", "stage4",
)
HRNET_HEAD_LAYERS = (
    "final_layer", "upsample_stage_2", "upsample_stage_3", "upsample_stage_4",
)
PARE_INIT_KEYS = ("init_pose", "init_shape", "init_cam", "temperature")


def _load(module: nn.Module, state: Mapping[str, Any],
          strict: bool = False) -> tuple[list, list]:
    """Load the tensors of `state` whose keys `module` has. Returns (the
    module's keys not in `state`, BN step counters aside; the keys of
    `state` the module does not have). With `strict`, a missing key raises
    KeyError and nothing is loaded."""
    own = module.state_dict()
    found = {k: torch.as_tensor(v) for k, v in state.items() if k in own}
    missing = [k for k in own if k not in found
               and not k.endswith("num_batches_tracked")]
    if strict and missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} weights, e.g. "
                       f"{missing[:3]}")
    unused = [k for k in state if k not in own]
    module.load_state_dict(found, strict=False)
    return missing, unused


def load_grnet_ckpt(module: nn.Module, path: str) -> tuple[list, list, dict]:
    """Flavour 1: load the 'backbone.*' / 'head.*' tensors of a GRNet
    checkpoint into `module` (a GRNetCore). Returns (missing keys, unused
    checkpoint keys, the checkpoint dict). Tensors only: the file is read
    with weights_only=True."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    missing, unused = _load(module, state.get("gen_state_dict", state))
    return missing, unused, state


def strip_prefix(state: Mapping[str, Any], prefix: str) -> dict:
    """The keys under 'model.<prefix>' with that prefix removed, and the
    keys outside 'model' as they are (the reference's load_ckpt_w_prefix)."""
    out = {}
    full = "model." + prefix
    for k, v in state.items():
        if k.startswith(full):
            out[k[len(full):]] = v
        elif not k.startswith("model"):
            out[k] = v
    return out


def import_pare_head_ckpt(state_dict: Mapping[str, Any], head: nn.Module,
                          strict: bool = False) -> tuple[dict, list, list]:
    """Flavour 2: a PARE lightning checkpoint's `state_dict` ('model.head.*'
    keys) into `head` (a PareHead). Returns (the init parameters found, as
    numpy: init_pose, init_shape, init_cam, temperature; missing keys;
    unused keys). With `strict`, a missing key raises KeyError."""
    head_state = strip_prefix(state_dict, "head.")
    init = {k: np.asarray(torch.as_tensor(head_state.pop(k)).cpu())
            for k in PARE_INIT_KEYS if k in head_state}
    missing, unused = _load(head, head_state, strict)
    return init, missing, unused


def import_hrnet_ckpt(state: Mapping[str, Any], backbone: nn.Module,
                      include_heads: bool = True, strict: bool = False
                      ) -> tuple[list, list]:
    """Flavour 3: an HRNet checkpoint into `backbone`, filtered to the
    pretrained layers, with the upsampling heads when `include_heads` or
    when the file wraps its tensors in 'state_dict'. Returns (missing
    keys, unused keys). With `strict`, a missing key raises KeyError."""
    if "state_dict" in state:
        state = state["state_dict"]
        allowed = HRNET_PRETRAINED_LAYERS + HRNET_HEAD_LAYERS
    else:
        allowed = HRNET_PRETRAINED_LAYERS + (
            HRNET_HEAD_LAYERS if include_heads else ())
    filtered = {k: v for k, v in state.items() if k.split(".")[0] in allowed}
    return _load(backbone, filtered, strict)
