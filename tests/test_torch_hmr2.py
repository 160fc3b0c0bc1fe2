"""HMR 2.0 (gaitlab_torch/nn/vit.py, nn/hmr2.py) against its plain
reference (tests/hmr2_reference.py) on the CPU, at a tiny size (a ViT of
width 64, 2 blocks, 4 heads, MLP 256; a 2-layer decoder of width 32, 4
heads of 8; 64-px crops) on seeded random weights: segment by segment,
through GRNetRunner.run_track over a track that spans two buckets, through
api.analyze_video and through cli/demo.py --arch hmr2. Then the runner's
trunk protocol with a trunk that has none of GRNet's attributes, the
modes HMR 2.0 runs (precision "default" and "high", bfloat16, "dp", the
pinned serving programs) and those it refuses.

Tolerance: the reference computes the same float32 products frame by
frame, the program batched; on the CPU the two agree to about 1e-5 of
each output's largest magnitude (GAP), so that is the limit. Computing in
bfloat16 misses it by orders of magnitude (test_bfloat16_trunk_fails_
the_tolerance), and two crops give poses more than 100 GAP apart
(test_outputs_depend_on_the_crop), so agreement within GAP is not
vacuous.
"""


import cv2
import numpy as np
import pytest
import torch
from torch import nn

import hmr2_reference as ref
from gaitlab_torch import api
from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.cli import demo
from gaitlab_torch.core import geometry
from gaitlab_torch.nn import hmr2
from gaitlab_torch.nn.grnet import GRNet, GRNetCore
from gaitlab_torch.pipeline.runner import GRNetRunner
from torch_threads import torch_threads  # noqa: F401

GAP = 1e-5
CROP = 64
TINY = dict(img_res=CROP, width=64, depth=2, heads=4, mlp=256,
            patch=16, patch_padding=2, dec_width=32, dec_depth=2,
            dec_heads=4, dec_head_dim=8, dec_mlp=32)
# the 4D-Humans sizes the reference reads from its configuration
REF_CFG = {k: TINY[k] for k in ("img_res", "patch", "patch_padding",
                                "heads", "depth", "dec_heads",
                                "dec_head_dim", "dec_depth")}


def gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def tiny_model(seed: int = 3) -> GRNet:
    """A tiny HMR 2.0 whose regressors move the mean pose, betas and
    camera by a visible, well-conditioned amount."""
    model = GRNet.create(seed=seed, device="cpu", trunk=hmr2.HMR2Core,
                         **TINY)
    head = model.module.smpl_head
    with torch.no_grad():
        for lin, gain in ((head.decpose, 0.3), (head.decshape, 0.5),
                          (head.deccam, 0.05)):
            lin.weight.mul_(gain)
    return model


def smpl_dict(model: GRNet) -> dict:
    return {k: v for k, v in model.smpl._asdict().items()
            if isinstance(v, torch.Tensor)}


def reference(model: GRNet, crops_nhwc: torch.Tensor) -> dict:
    sd = model.module.state_dict()
    return ref.forward(sd, smpl_dict(model), REF_CFG,
                       crops_nhwc.permute(0, 3, 1, 2).contiguous())


def frames_and_boxes(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(n, 120, 160, 3), dtype=np.uint8)
    side = rng.uniform(60, 100, size=n)
    boxes = np.stack([rng.uniform(60, 100, size=n),
                      rng.uniform(50, 70, size=n), side, side], 1)
    return frames, boxes.astype(np.float32)


def rotmats(pose_aa: np.ndarray) -> np.ndarray:
    return geometry.axis_angle_to_rotmat(
        torch.from_numpy(np.asarray(pose_aa, np.float32)).reshape(-1, 3)
    ).reshape(-1, 24, 3, 3).numpy()


def check_outputs(got: dict, want: dict, joints2d=True) -> None:
    """run_track's keys (or the demo's) against the reference's."""
    for k in ("verts", "joints3d", "betas", "pred_cam") + (
            ("joints2d",) if joints2d else ()):
        assert gap(got[k], want[k]) < GAP, k
    assert gap(rotmats(got["pose"]), want["rotmat"]) < GAP, "pose"


@pytest.fixture(scope="module")
def model():
    return tiny_model()


@pytest.fixture(scope="module")
def crops(model):
    frames, boxes = frames_and_boxes(11)
    runner = GRNetRunner(model, buckets=(4, 8), crop_size=CROP)
    return runner.crop_track(frames, boxes)


def test_published_sizes():
    """The defaults are HMR 2.0's widths: ViT-H/16 (1280, 32 blocks, 16
    heads of 80, MLP 5120, 16x12 tokens from the middle 192 columns of a
    256 crop) and the 6-layer decoder (1024 wide, 8 heads of 64, context
    1280): 670.46 M parameters."""
    with torch.device("meta"):
        core = hmr2.HMR2Core()
    vit = core.backbone
    assert (core.img_res, vit.patch_embed.grid, vit.num_tokens) == \
        (256, (16, 12), 192)
    blk = vit.blocks[0]
    assert (len(vit.blocks), blk.attn.heads, blk.attn.qkv.weight.shape,
            blk.mlp.fc1.weight.shape) == (32, 16, (3840, 1280), (5120, 1280))
    layers = core.smpl_head.transformer.transformer.layers
    sa, ca, ff = (m.fn for m in layers[0])
    assert (len(layers), sa.heads, sa.to_qkv.weight.shape,
            ca.to_q.weight.shape, ca.to_kv.weight.shape,
            ca.to_out[0].weight.shape, ff.net[0].weight.shape) == \
        (6, 8, (1536, 1024), (512, 1024), (1024, 1280), (1024, 512),
         (1024, 1024))
    assert sum(p.numel() for p in core.parameters()) == 670_459_037


def test_segments_match_reference(model, crops):
    """embed, blocks and decoder one at a time against the reference's
    patch embedding, ViT and decoder head on the same inputs."""
    core = model.module
    sd = core.state_dict()
    x = crops.permute(0, 3, 1, 2).contiguous()
    cut = CROP // 8
    with torch.inference_mode():
        emb = core.run_segments({"x": x}, ["embed"])["x"]
        want = torch.nn.functional.conv2d(
            x[..., cut:-cut], sd["backbone.patch_embed.proj.weight"],
            sd["backbone.patch_embed.proj.bias"], stride=16, padding=2
        ).flatten(2).transpose(1, 2)
        want = want + sd["backbone.pos_embed"][:, 1:] \
            + sd["backbone.pos_embed"][:, :1]
        assert gap(emb, want) < GAP
        tokens = core.run_segments({"x": emb}, ["blocks"])["x"]
        feats = ref.vit(sd, REF_CFG, x[..., cut:-cut])
        assert gap(tokens, feats.flatten(2).transpose(1, 2)) < GAP
        out = core.run_segments({"x": tokens}, ["decoder"])
    rot, betas, cam = ref.decoder_head(sd, REF_CFG, feats)
    assert gap(out["pred_pose"], rot) < GAP
    assert gap(out["pred_shape"], betas) < GAP
    assert gap(out["pred_cam"], cam) < GAP


def test_run_track_matches_reference(model):
    """11 frames at buckets 4 and 8: a forward of 8, then 3 padded to 4."""
    frames, boxes = frames_and_boxes(11)
    runner = GRNetRunner(model, buckets=(4, 8), crop_size=CROP)
    got = runner.run_track(frames, boxes)
    assert got["verts"].shape == (11, 6890, 3)
    assert got["joints3d"].shape == (11, 29, 3)
    check_outputs(got, reference(model, runner.crop_track(frames, boxes)))


def test_outputs_depend_on_the_crop(model, crops):
    """Two crops' rotations differ by more than 100 times the tolerance,
    and the camera's scale stays near the mean's 0.9."""
    want = reference(model, crops)
    assert gap(want["rotmat"][:1], want["rotmat"][1:2]) > 100 * GAP
    assert gap(want["betas"][:1], want["betas"][1:2]) > 100 * GAP
    assert 0.5 < float(want["pred_cam"][:, 0].min()) < \
        float(want["pred_cam"][:, 0].max()) < 1.3


def test_bfloat16_trunk_fails_the_tolerance(model, crops):
    """The same track with the trunk in bfloat16 (trunk_dtype): finite,
    near the reference, and outside the tolerance."""
    frames, boxes = frames_and_boxes(11)
    runner = GRNetRunner(model, buckets=(4, 8), crop_size=CROP,
                         trunk_dtype="bfloat16")
    got = runner.run_track(frames, boxes)
    want = reference(model, runner.crop_track(frames, boxes))
    assert np.isfinite(got["verts"]).all()
    gaps = [gap(got[k], want[k]) for k in ("verts", "betas", "pred_cam")]
    gaps.append(gap(rotmats(got["pose"]), want["rotmat"]))
    assert max(gaps) > 10 * GAP
    assert max(gaps) < 0.1


def test_spans_of_a_traced_track(model):
    """Under a profiler each bucket's forward holds the spans model/embed,
    model/blocks and model/decoder in order, with its rows and tokens (12
    patch tokens a row at 64 px, one decoder query a row), then
    model/regress; nothing is dropped."""
    from torch.profiler import ProfilerActivity, profile

    from gaitlab_torch import utils

    frames, boxes = frames_and_boxes(11)
    runner = GRNetRunner(model, buckets=(4, 8), crop_size=CROP)
    utils.SPAN_LOG.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     **utils._all_threads_config()):
            runner.run_track(frames, boxes)
        records, dropped = utils.SPAN_LOG.snapshot()
    finally:
        utils.SPAN_LOG.clear()
    assert dropped == 0
    forwards = sorted((x for x in records if x.name == "stream/forward"),
                      key=lambda x: x.t0)
    assert [x.counts["rows"] for x in forwards] == [8, 4]
    for f in forwards:
        inside = sorted((x for x in records if x.name.startswith("model/")
                         and f.t0 <= x.t0 and x.t1 <= f.t1),
                        key=lambda x: x.t0)
        rows = f.counts["rows"]
        assert [(x.name, x.counts.get("rows"), x.counts.get("tokens"))
                for x in inside] == [
            ("model/embed", rows, 12 * rows), ("model/blocks", rows, 12 * rows),
            ("model/decoder", rows, rows), ("model/regress", None, None)]


def test_identity_6d():
    """HMR 2.0's 6D layout: [1,0,0,0,1,0] is the identity, and a random
    6D vector gives the reference's rotation (not SPIN's layout's)."""
    eye = hmr2.rot6d_to_rotmat(torch.tensor(hmr2.IDENTITY_6D))
    assert torch.equal(eye, torch.eye(3)[None])
    x = torch.randn(5, 6, generator=torch.Generator().manual_seed(0))
    got = hmr2.rot6d_to_rotmat(x)
    assert gap(got, ref.rot6d_to_rotmat(x)) < GAP
    assert gap(got, geometry.rot6d_to_rotmat(x)) > 0.01
    # zero regressors leave the mean parameters
    core = hmr2.HMR2Core(**TINY).eval()
    head = core.smpl_head
    with torch.no_grad():
        for lin in (head.decpose, head.decshape, head.deccam):
            lin.weight.zero_()
            lin.bias.zero_()
        out = core(torch.randn(2, 3, CROP, CROP))
    assert torch.allclose(out["pred_pose"], torch.eye(3).expand(2, 24, 3, 3))
    assert torch.equal(out["pred_cam"], torch.tensor([[0.9, 0.0, 0.0]] * 2))
    assert not out["pred_shape"].any()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """320x240, 44 frames, one walker crossing the frame at 5 px a frame."""
    vid = str(tmp_path_factory.mktemp("torch_hmr2") / "hmr2_walk.mp4")
    rng = np.random.default_rng(2)
    bg = rng.integers(40, 70, size=(240, 320, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 20.0,
                             (320, 240))
    for i in range(44):
        frame = bg.copy()
        x = 15 + 5 * i
        cv2.rectangle(frame, (x, 50), (x + 40, 210), (210, 190, 180), -1)
        cv2.circle(frame, (x + 20, 62), 12, (200, 170, 160), -1)
        writer.write(frame)
    writer.release()
    return vid


def check_people(model, vid, results) -> None:
    """Each person's outputs against the reference on the runner's crops
    of the same decoded frames and boxes."""
    from gaitlab_torch.pipeline import coords, video

    frames = np.stack(list(video.read_frames(vid)))
    runner = GRNetRunner(model, buckets=(16,), crop_size=CROP)
    assert results
    for r in results.values():
        bboxes, fidx = r["bboxes"], r["frame_ids"]
        assert len(fidx) > 16  # two forwards: 16, then the padded tail
        want = reference(model, runner.crop_track(frames[fidx], bboxes))
        check_outputs(r, want, joints2d=False)
        want2d = coords.convert_crop_coords_to_orig_img(
            bboxes, want["joints2d"].numpy(), 224)
        assert gap(r["joints2d"], want2d) < GAP


def tiny_for_the_entry_points(monkeypatch, model) -> None:
    """GRNet.create hands the entry points the tiny model when they ask
    for an HMR2Core."""
    create = GRNet.create

    def tiny(trunk=GRNetCore, **kw):
        return model if trunk is hmr2.HMR2Core else create(trunk=trunk, **kw)

    monkeypatch.setattr(GRNet, "create", staticmethod(tiny))


def test_analyze_video(model, clip, monkeypatch):
    """api.analyze_video, two-pass and one-pass, with an HMR 2.0 runner
    from load_pipeline(arch="hmr2") at 64-px crops."""
    tiny_for_the_entry_points(monkeypatch, model)
    monkeypatch.setenv("GAITLAB_BUCKETS", "16")
    got_model, runner = api.load_pipeline(arch="hmr2", device="cpu")
    assert got_model is model and runner.crop_size == CROP
    for onepass in (False, True):
        res = api.analyze_video(clip, runner=runner, joint_type="spin2",
                                smooth=False, onepass=onepass)
        check_people(model, clip, res)


def test_demo_arch_hmr2(model, clip, tmp_path, monkeypatch):
    """cli/demo.py --arch hmr2 from the raw video (median background,
    SORT, the frame folder) on the CPU."""
    tiny_for_the_entry_points(monkeypatch, model)
    monkeypatch.setenv("GAITLAB_BUCKETS", "16")
    args = demo.build_parser().parse_args(
        ["--vid_file", clip, "--detector", "median_bg", "--output_folder",
         str(tmp_path), "--save_vid", "--cpu_only", "--arch", "hmr2"])
    check_people(model, clip, demo.main(args))


class MeanColourTrunk(nn.Module):
    """A trunk of the runner's protocol and nothing of GRNet's: the crop's
    mean colour through one linear layer to a pose, betas and camera."""

    use_gait_feat = False
    img_res = 32

    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(3, 24 * 6 + 10 + 3)
        self.precision = "float32"

    def at_modes(self, precision, head_precision):
        return self

    def segments(self):
        return [("pool", self.precision), ("regress_head", self.precision)]

    def run_segments(self, carry, names):
        for name in names:
            x = carry["x"]
            if name == "pool":
                carry = {"x": x.mean((2, 3))}
            else:
                d = self.fc(x)
                rot = hmr2.rot6d_to_rotmat(
                    d[:, :144] + torch.tensor(hmr2.IDENTITY_6D * 24))
                carry = {"pred_pose": rot.reshape(-1, 24, 3, 3),
                         "pred_shape": d[:, 144:154],
                         "pred_cam": d[:, 154:] + torch.tensor(hmr2.MEAN_CAM)}
        return carry

    def forward(self, images):
        return self.run_segments({"x": images}, ["pool", "regress_head"])


def test_runner_takes_any_trunk_of_the_protocol():
    trunk = MeanColourTrunk().eval()
    assert not any(hasattr(trunk, a) for a in (
        "backbone_region_precision", "backbone_resize_precision",
        "with_precision", "head_precision", "head", "backbone"))
    model = GRNet(module=trunk, smpl=body_smpl.synthetic_smpl_params(),
                  device=torch.device("cpu"))
    runner = GRNetRunner(model, buckets=(4, 8), crop_size=32)
    assert (runner.resolved_region_precision(),
            runner.resolved_resize_precision()) == ((), "highest")
    frames, boxes = frames_and_boxes(11)
    out = runner.run_track(frames, boxes)
    assert out["verts"].shape == (11, 6890, 3)
    crops = runner.crop_track(frames, boxes).permute(0, 3, 1, 2)
    with torch.inference_mode():
        want = model.forward(crops)[0]
    np.testing.assert_allclose(out["verts"], want["verts"][0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("precision", ["default", "high"])
def test_other_precisions_run(model, crops, precision):
    """On the CPU there is no TF32: "default" is one float32 product and
    equals "float32"; "high" splits each product into bf16-masked parts
    (nn/layers.py), about 2^-16 of each, so it agrees to 1e-4. The decoder
    follows head_precision ("auto": "default" under "high")."""
    runner = GRNetRunner(model, buckets=(4, 8), crop_size=CROP,
                         precision=precision)
    core = runner._live()["core"]
    head = "default"
    assert [m for _, m in core.segments()] == [precision, precision, head]
    assert core.backbone is model.module.backbone  # a view: same weights
    got = runner.forward_crops(crops)
    base = GRNetRunner(model, buckets=(4, 8), crop_size=CROP
                       ).forward_crops(crops)
    if precision == "default":
        for k in got:
            np.testing.assert_array_equal(got[k], base[k])
    else:
        assert 0 < gap(got["verts"], base["verts"]) < 1e-4


def test_data_parallel_matches(model, crops, monkeypatch):
    """parallel="dp" over two CPU replicas splits each bucket in halves."""
    from gaitlab_torch.parallel import mesh

    monkeypatch.setattr(mesh, "devices_for",
                        lambda dev: [torch.device("cpu")] * 2)
    got = GRNetRunner(model, buckets=(4, 8), crop_size=CROP,
                      parallel="dp").forward_crops(crops)
    want = GRNetRunner(model, buckets=(4, 8), crop_size=CROP
                       ).forward_crops(crops)
    for k in want:
        assert gap(got[k], want[k]) < GAP, k


def test_serving_round_trip(model, tmp_path):
    """serve.save_artifacts exports HMR 2.0's bucket forwards (its trunk's
    segments, then SMPL at its img_res) and load_runner's pinned programs
    give the live runner's outputs."""
    from gaitlab_torch import serve

    runner = GRNetRunner(model, buckets=(4, 8), crop_size=CROP,
                         crop_on="host")
    serve.save_artifacts(runner, str(tmp_path), platforms=("cpu",))
    pinned = serve.load_runner(str(tmp_path), device="cpu")
    assert (pinned.crop_size, pinned.resolved_region_precision()) == (CROP, ())
    frames, boxes = frames_and_boxes(11)
    got, want = pinned.run_track(frames, boxes), runner.run_track(frames,
                                                                  boxes)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_refusals(model, monkeypatch):
    """What HMR 2.0 does not run raises ValueError naming it."""
    from gaitlab_torch.parallel import mesh

    monkeypatch.setattr(mesh, "devices_for",
                        lambda dev: [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="parallel='pp'"):
        GRNetRunner(model, buckets=(4, 8), crop_size=CROP, parallel="pp")
    with pytest.raises(ValueError, match="64-px crops"):
        GRNetRunner(model, buckets=(4,)).forward_crops(
            torch.zeros(2, 224, 224, 3))
    with pytest.raises(ValueError, match="precision mode 'bf16'"):
        model.module.at_modes("bf16", None)
    with pytest.raises(ValueError, match="gait corrector"):
        demo.build_model(arch="hmr2", use_gait_feat=True, device="cpu")
    with pytest.raises(ValueError, match="arch='vitpose'"):
        demo.build_model(arch="vitpose", device="cpu")
    with pytest.raises(NotImplementedError, match="not written yet"):
        api.load_pipeline(ckpt="hmr2_ckpt.ckpt", arch="hmr2", device="cpu")
    with pytest.raises(ValueError, match="divide by 8"):
        hmr2.HMR2Core(**dict(TINY, img_res=60))
