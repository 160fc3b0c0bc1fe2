"""The frozen counting (counts/flops.py) against torch's FlopCounterMode
on a small trunk, and the peaks' arithmetic."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import flops, peaks


SMALL = dict(backbone_width=8, backbone_modules=(1, 1, 1),
             backbone_blocks=1, num_input_features=120)


def small_core(gait=False):
    from gaitlab_torch.nn.grnet import GRNetCore

    torch.manual_seed(0)
    return GRNetCore(**SMALL, use_gait_feat=gait, featcorr_h_size=64).eval()


def small_cfg():
    return {"model": dict(SMALL, num_joints=24), "crop_size": 64}


@pytest.mark.parametrize("rows", [1, 3])
def test_trunk_count_matches_flop_counter(rows):
    """The reference walk's direct-form count of the trunk's layers equals
    FlopCounterMode's count of the program's forward of the same trunk (to
    which B1, a custom op, is opaque)."""
    core = small_core()
    x = torch.randn(rows, 3, 64, 64)
    trunk = flops.count_trunk(core.state_dict(), small_cfg())
    with FlopCounterMode(display=False) as fcm, torch.inference_mode():
        core.head(core.backbone(x))
    ours = rows * (trunk["backbone"] + trunk["head"] + trunk["predict"])
    assert ours == fcm.get_total_flops()


def test_weight_bytes_are_the_convolutions():
    """Weights count once, as the convolutions' float32 values only:
    BatchNorm's terms fold into them."""
    core = small_core()
    sd = core.state_dict()
    convs = [m for n, m in core.named_modules()
             if n.startswith("backbone.") and isinstance(m, torch.nn.Conv2d)]
    assert flops.conv_weight_bytes(sd, "backbone.", "float32") == \
        4 * sum(m.weight.numel() for m in convs)
    assert 0 < flops.conv_weight_bytes(sd, flops.HR_HEAD, "float32") < \
        flops.conv_weight_bytes(sd, "backbone.", "float32")


@pytest.mark.parametrize("rows", [1, 5])
def test_b1_count_matches_flop_counter(rows):
    """B1's count is its plain version's two pooling products, as
    FlopCounterMode counts them, plus 5 FLOPs a logit for the softmax."""
    from gaitlab_torch.ops.keypoint_attention import keypoint_attention_plain

    hw, c1, c2, j = 56 * 56, 128, 64, 24
    f = torch.randn(rows, 56, 56, c1)
    c = torch.randn(rows, 56, 56, c2)
    h = torch.randn(rows, 56, 56, j)
    with FlopCounterMode(display=False) as fcm:
        keypoint_attention_plain(f, c, h)
    assert flops.b1_work(rows, hw, c1, c2, j)[0] == \
        fcm.get_total_flops() + 5 * rows * j * hw


def test_hr_head_is_part_of_backbone():
    trunk = flops.count_trunk(small_core().state_dict(), small_cfg())
    assert 0 < trunk["hr_head"] < trunk["backbone"]


def test_corrector_count_matches_flop_counter():
    """The corrector's count from its weights' sizes equals
    FlopCounterMode's count of its forward on the CPU (where the GRU
    runs as matrix products that the counter sees)."""
    core = small_core(gait=True)
    sd = core.state_dict()
    cfg = {"model": {"num_joints": 24, "num_features_pare": 128,
                     "featcorr_num_layers": 1}}
    t = 7
    with FlopCounterMode(display=False) as fcm, torch.inference_mode():
        core.pfeat_corrector(torch.randn(1, t, 24, 128), torch.randn(1, t, 3))
    assert flops.corrector_flops(t, sd, cfg) == fcm.get_total_flops()


def test_bound_is_the_larger_term():
    assert peaks.bound_s(495e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    with pytest.raises(ValueError):
        peaks.flop_peak("int8")
