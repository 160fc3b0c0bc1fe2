"""Reference checkpoint loading.

The port's modules carry the reference's state_dict keys, so a reference
GRNet checkpoint (flavour 1: {'gen_state_dict': ...}, the demo's
checkpoint) loads with no key or layout translation. The PARE lightning
and HRNet checkpoint flavours are not ported yet.
"""

from __future__ import annotations

from torch import nn
import torch


def load_grnet_ckpt(module: nn.Module, path: str) -> tuple[list, list, dict]:
    """Load the 'backbone.*' / 'head.*' tensors of a GRNet checkpoint into
    `module` (a GRNetCore). Returns (missing keys, unused checkpoint keys,
    the checkpoint dict). Tensors only: the file is read with
    weights_only=True."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    gen = state.get("gen_state_dict", state)
    own = module.state_dict()
    found = {k: v for k, v in gen.items() if k in own}
    missing = [k for k in own if k not in found
               and not k.endswith("num_batches_tracked")]
    unused = [k for k in gen if k not in own]
    module.load_state_dict(found, strict=False)
    return missing, unused, state
