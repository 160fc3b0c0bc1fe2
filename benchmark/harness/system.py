"""What every architecture's system shares (arch/<arch>.py builds the
rest): the order of SMPL's tensors in the program's SMPLParams, and the
TF32 switches set for a block."""

from __future__ import annotations

import torch

SMPL_KEYS = ("v_template", "shapedirs", "posedirs", "J_regressor",
             "lbs_weights", "J_regressor_extra")


class tf32:
    """cuDNN's and cuBLAS's TF32 switches set for a block, then restored."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.old
