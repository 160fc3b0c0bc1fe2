"""GRNet: HRNet backbone + PARE head [+ gait-feature corrector] + SMPL
regression.

Counterpart of gaitlab/nn/grnet.py. `GRNetCore` is the neural trunk (an
nn.Module whose state_dict keys are the reference GRNet's 'backbone.*' /
'head.*' keys, and 'pfeat_corrector.*' for the gait branch, named as
gaitlab names it); `vp_regress` is the SMPL regression and output
assembly; `GRNet` bundles the trunk, the SMPL tensors and the device.

Output contract:
  [{'theta': (B,T,85), 'verts': (B,T,6890,3), 'kp_2d': (B,T,J,2),
    'kp_3d': (B,T,J,3), 'rotmat': (B,T,24,3,3)}]
with the gait branch also 'pred_avg' (1,3), 'pred_phase' (1,N,4) and
'pred_cparam' (N,3).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.core import geometry
from gaitlab_torch.device import resolve_device, upload
from gaitlab_torch.nn.gait import FeatCorrector, camera_reparam
from gaitlab_torch.nn.hrnet import REGIONS, HRNetCfg, PoseHighResolutionNet
from gaitlab_torch.nn.layers import check_mode, precision_scope
from gaitlab_torch.nn.pare_head import PareHead
from gaitlab_torch.pipeline.crop import normalize_image
from gaitlab_torch.utils import span


class GRNetCore(nn.Module):
    """HRNet-W32 backbone + PARE head, and with `use_gait_feat` the
    gait-feature corrector between the head's pooling and its regressors.
    The width, depth and head-feature knobs exist so that tests can build
    small models; the featcorr_* knobs are gaitlab's MODEL.FEAT_CORR.*.

    As in gaitlab, the backbone's BatchNorms always run on their running
    statistics, whatever `.train()` says, and with `freeze_backbone` the
    backbone runs without autograd: gradients reach the head (and the
    corrector) only, and the backbone's activations are not kept.

    Precision (layers.MODES). The forward is a sequence of precision
    segments (`segments`): the six backbone regions, then the head (with
    the gait branch: the head's per-frame part, the corrector, the second
    prediction), each run in its own layers.precision_scope. `precision`
    is gaitlab's enclosing matmul precision (float32 here unless
    `with_precision` says otherwise); `head_precision` (None: inherit),
    `backbone_region_precision` and `backbone_resize_precision` are
    gaitlab's GRNetCore fields of the same names.

    The backbone's variants (nn/hrnet.py) are gaitlab's fields
    `pack_low_channel`, `backbone_cast_after`, `backbone_act_store` and
    `stem_s2d`, kept in the backbone's cfg: a view at other modes
    (`with_precision`), a copy and a replica keep them, and
    `with_backbone` makes a view with others.

    It is the runner's trunk (pipeline/runner.py's trunk protocol):
    `use_gait_feat`, `img_res`, `at_modes`, `segments`, `run_segments`."""

    # the crop size vp_regress projects at (PARE's and SPIN's 224, whatever
    # crop a test runs), and the entry points' crop
    img_res = 224

    def __init__(self, num_joints: int = 24, num_input_features: int = 480,
                 num_features_pare: int = 128, num_features_smpl: int = 64,
                 backbone_width: int = 32, backbone_modules: tuple = (1, 4, 3),
                 backbone_blocks: int = 4, use_gait_feat: bool = False,
                 featcorr_avg_dim: int = 3, featcorr_estim_phase: bool = True,
                 featcorr_num_layers: int = 1, featcorr_h_size: int = 1024,
                 featcorr_num_heads: int = 4, featcorr_use_jwff: bool = False,
                 freeze_backbone: bool = True,
                 head_precision: Optional[str] = None,
                 backbone_region_precision: tuple = (),
                 backbone_resize_precision: str = "highest",
                 pack_low_channel: int = 0, backbone_cast_after: tuple = (),
                 backbone_act_store: tuple = (), stem_s2d: bool = False):
        super().__init__()
        self.use_gait_feat = use_gait_feat
        self.freeze_backbone = freeze_backbone
        self.precision = "float32"
        self.head_precision = head_precision
        self.backbone = PoseHighResolutionNet(HRNetCfg.w(
            backbone_width, pack_low_channel=pack_low_channel,
            region_precision=backbone_region_precision,
            cast_after=backbone_cast_after, act_store=backbone_act_store,
            stem_s2d=stem_s2d, modules=backbone_modules,
            blocks=backbone_blocks,
            resize_precision=backbone_resize_precision))
        self.head = PareHead(num_joints, num_input_features,
                             num_features_pare, num_features_smpl)
        if head_precision is not None:
            self.head.precision = check_mode(head_precision)
        if use_gait_feat:
            self.pfeat_corrector = FeatCorrector(
                num_joints, num_features_pare, featcorr_avg_dim,
                featcorr_estim_phase, featcorr_num_layers, featcorr_h_size,
                featcorr_num_heads, featcorr_use_jwff)

    @property
    def backbone_region_precision(self) -> tuple:
        return self.backbone.cfg.region_precision

    @property
    def backbone_resize_precision(self) -> str:
        return self.backbone.cfg.resize_precision

    def region_precision_at(self, precision: str) -> tuple:
        """The backbone's per-region modes under the runner's `precision`:
        the module's own override wins; else ("heads", "w2x") under "high"
        (gaitlab's upsample-head convs at two passes), and no region
        otherwise."""
        if self.backbone_region_precision:
            return tuple(self.backbone_region_precision)
        return (("heads", "w2x"),) if precision == "high" else ()

    def resize_precision_at(self, precision: str) -> str:
        """gaitlab's resize precision under the runner's `precision`: a
        non-default module setting wins, else "high" under "high" and
        "highest" otherwise. The port's resize does no matmul, so this only
        travels (nn/hrnet.py)."""
        if self.backbone_resize_precision != "highest":
            return self.backbone_resize_precision
        return "high" if precision == "high" else "highest"

    def at_modes(self, precision: str, head_precision: Optional[str]
                 ) -> "GRNetCore":
        """This trunk at the runner's `precision` and (resolved)
        `head_precision`, the backbone's regions and resize resolved from
        them: itself when it runs at them already, else a `with_precision`
        view. A view is made even when the targets are None or (): "inherit"
        must clear a module-level override, or a module built with
        head_precision="default" would keep its head at one TF32 pass inside
        a float32 run."""
        want = (precision, head_precision, self.region_precision_at(precision),
                self.resize_precision_at(precision))
        if want == (self.precision, self.head_precision,
                    tuple(self.backbone_region_precision),
                    self.backbone_resize_precision):
            return self
        return self.with_precision(*want)

    def with_precision(self, precision: str = "float32",
                       head_precision: Optional[str] = None,
                       region_precision: tuple = (),
                       resize_precision: str = "highest") -> "GRNetCore":
        """This trunk at other modes (gaitlab's module.clone of the same
        fields, with `precision` the global one): a shallow copy whose
        backbone and head are shallow copies too, sharing every parameter,
        buffer and deeper submodule with this one, so that weights loaded
        into either are the other's."""
        core = self.with_backbone(region_precision=region_precision,
                                  resize_precision=resize_precision)
        core.backbone.precision = check_mode(precision)
        head = copy.copy(self.head)
        head.precision = check_mode(head_precision or precision)
        core._modules["head"] = head
        core.precision, core.head_precision = precision, head_precision
        return core

    def with_backbone(self, **fields) -> "GRNetCore":
        """This trunk with other backbone cfg fields (HRNetCfg's
        pack_low_channel, cast_after, act_store, stem_s2d, region and
        resize precision): a shallow copy whose backbone is a shallow copy
        too, sharing every parameter, buffer and deeper submodule. Fields
        that shape the parameters (width, the heads, the stages) raise."""
        shaped = {"width", "downsample", "use_conv", "stage2", "stage3",
                  "stage4"} & set(fields)
        if shaped:
            raise ValueError(f"with_backbone: {sorted(shaped)} shape the "
                             "parameters")
        core = copy.copy(self)
        core._modules = dict(self._modules)
        backbone = copy.copy(self.backbone)
        backbone.cfg = dataclasses.replace(self.backbone.cfg, **fields)
        core._modules["backbone"] = backbone
        return core

    def train(self, mode: bool = True) -> "GRNetCore":
        super().train(mode)
        self.backbone.train(False)  # gaitlab: backbone(images, train=False)
        return self

    def segments(self) -> list:
        """The forward's precision segments in order, as (name, mode)."""
        segs = [(r, self.backbone.region_mode(r)) for r in REGIONS]
        head = self.head.precision
        if not self.use_gait_feat:
            return segs + [("head", head)]
        return segs + [("frame_head", head), ("corrector", self.precision),
                       ("predict", head)]

    def run_segments(self, carry: dict, names) -> dict:
        """Run the named segments on a carry dict: {"x": images[, "bbox",
        "cimg", "n_valid"]} before the first; between the regions "x" is a
        region's output; after the last, the head's output dict. Each
        segment is a span `model/<name>`."""
        modes = dict(self.segments())
        for name in names:
            with span("model/" + name):
                carry = self._segment(name, modes[name], carry)
        return carry

    def _segment(self, name: str, mode: str, carry: dict) -> dict:
        if name in REGIONS:
            grad = (contextlib.nullcontext()
                    if not (self.freeze_backbone and torch.is_grad_enabled())
                    else torch.no_grad())
            with grad:
                return {**carry, "x": self.backbone.run_region(name,
                                                               carry["x"])}
        if name == "head":
            return self.head(carry["x"])
        if name == "frame_head":
            bbox, cimg = carry.get("bbox"), carry.get("cimg")
            if bbox is None or cimg is None:
                raise ValueError("the gait branch needs bbox and cimg")
            feats = self.head.feature_extractor(carry["x"])
            patt = self.head.predict(feats["point_local_feat"],
                                     feats["cam_shape_feats"])
            feats["cparams"] = camera_reparam(
                _at_least_f32(patt["pred_cam"]), bbox, cimg)
            if carry.get("n_valid") is not None:
                feats["n_valid"] = carry["n_valid"]
            return feats
        if name == "corrector":
            n_valid = carry.get("n_valid")
            cparams = carry["cparams"]
            dtype = self.pfeat_corrector.gfeat_fc.weight.dtype
            with precision_scope(mode):
                corrected, pred_avg, pred_phase = self.pfeat_corrector(
                    carry["point_local_feat"][None].to(dtype),
                    cparams[None].to(dtype),
                    None if n_valid is None
                    else torch.as_tensor(n_valid).reshape(1))
            out = {k: v for k, v in carry.items()
                   if k in ("cam_shape_feats", "pred_segm_mask", "cparams")}
            out.update(corrected=corrected[0], pred_avg=pred_avg,
                       pred_phase=pred_phase)
            return out
        if name == "predict":
            out = self.head.predict(carry["corrected"],
                                    carry["cam_shape_feats"])
            if "pred_segm_mask" in carry:
                out["pred_segm_mask"] = carry["pred_segm_mask"]
            out.update(pred_avg=carry["pred_avg"],
                       pred_phase=carry["pred_phase"],
                       pred_cparam=carry["cparams"])
            return out
        raise ValueError(f"segment {name!r}")

    def forward(self, images: torch.Tensor,
                bbox: Optional[torch.Tensor] = None,
                cimg: Optional[torch.Tensor] = None,
                n_valid: Optional[torch.Tensor] = None) -> dict:
        """images: (N, 3, 224, 224) normalized crops of one track. bbox (N,4)
        and cimg (N,2) feed the gait branch; n_valid (a 0-d int tensor, read
        on the device) says how many leading frames are real when the
        runner pads the track to a bucket: padded frames then stay out of
        the gait GRU and attention."""
        carry = {"x": images, "bbox": bbox, "cimg": cimg, "n_valid": n_valid}
        return self.run_segments(carry, [n for n, _ in self.segments()])

    def frame_part(self, images: torch.Tensor, bbox: torch.Tensor,
                   cimg: torch.Tensor) -> dict:
        """The gait branch's per-frame part, which a data-parallel runner
        splits over replicas: the backbone, the PARE feature extractor, the
        first prediction and the camera reparametrisation ->
        {"point_local_feat", "cam_shape_feats", "pred_segm_mask",
        "cparams"}, one row per frame."""
        return self.run_segments({"x": images, "bbox": bbox, "cimg": cimg},
                                 REGIONS + ("frame_head",))

    def track_part(self, frames: dict, n_valid=None) -> dict:
        """The gait branch's part over the whole track: the corrector on
        frame_part's rows, then the second prediction."""
        return self.run_segments({**frames, "n_valid": n_valid},
                                 ("corrector", "predict"))


def _at_least_f32(v):
    """A bf16 (trunk_dtype) tensor as float32; anything else as it is."""
    if torch.is_tensor(v) and v.dtype in (torch.bfloat16, torch.float16):
        return v.float()
    return v


def vp_regress(smpl_params: body_smpl.SMPLParams, patt_output: dict,
               batch_size: int = 1,
               J_regressor: Optional[torch.Tensor] = None,
               joint_mode: str = "spin2", focal_length: float = 5000.0,
               img_res: int = 224) -> list[dict]:
    """SMPL regression + output assembly (reference VPRegressor.forward).
    Always float32 with TF32 off, in its own precision segment, whatever
    mode the trunk ran at (gaitlab pins SMPL to HIGHEST); a bf16 trunk's
    outputs are cast to float32 first."""
    patt_output = {k: _at_least_f32(v) for k, v in patt_output.items()}
    with precision_scope("float32"):
        return _vp_regress(smpl_params, patt_output, batch_size, J_regressor,
                           joint_mode, focal_length, img_res)


def _vp_regress(smpl_params, patt_output, batch_size, J_regressor,
                joint_mode, focal_length, img_res) -> list[dict]:
    pred_rotmat = patt_output["pred_pose"]  # (N,24,3,3)
    n = pred_rotmat.shape[0]
    smpl_out = body_smpl.smpl_head(
        smpl_params, pred_rotmat, patt_output["pred_shape"],
        cam=patt_output["pred_cam"], focal_length=focal_length,
        img_res=img_res, normalize_joints2d=True, joint_mode=joint_mode)
    pose = geometry.rotmat_to_axis_angle(
        pred_rotmat.reshape(-1, 3, 3)).reshape(n, 72)
    seqlen = n // batch_size

    joints3d = smpl_out["smpl_joints3d"]
    if J_regressor is not None:
        joints3d = torch.einsum("jv,nvk->njk", J_regressor,
                                smpl_out["smpl_vertices"])
        if J_regressor.shape[0] < 24:
            joints3d = joints3d[:, list(body_smpl.H36M_TO_J14)]

    theta = torch.cat([patt_output["pred_cam"], pose,
                       patt_output["pred_shape"]], dim=1)
    out = {
        "theta": theta.reshape(batch_size, seqlen, -1),
        "verts": smpl_out["smpl_vertices"].reshape(batch_size, seqlen, -1, 3),
        "kp_2d": smpl_out["smpl_joints2d"].reshape(batch_size, seqlen, -1, 2),
        "kp_3d": joints3d.reshape(batch_size, seqlen, -1, 3),
        "rotmat": pred_rotmat.reshape(batch_size, seqlen, -1, 3, 3),
    }
    for k in ("pred_avg", "pred_phase", "pred_cparam"):  # gait branch
        if k in patt_output:
            out[k] = patt_output[k]
    return [out]


BUCKET_KEYS = ("theta", "verts", "kp_2d", "kp_3d", "pred_avg", "pred_phase")
REGRESS = "regress"  # the SMPL regression's segment, after the trunk's


class _Segments(nn.Module):
    """A trunk's run_segments as a module's forward, for functional_call."""

    def __init__(self, core: GRNetCore):
        super().__init__()
        self.core = core

    def forward(self, carry: dict, names: list) -> dict:
        return self.core.run_segments(carry, names)


class BucketForward(nn.Module):
    """The runner's forward at one bucket, with the weights as inputs:
    (state_dict of a GRNetCore, SMPLParams, NHWC crops[, bbox, cimg,
    n_valid]) -> per-frame theta (N,85), verts, kp_2d, kp_3d (and the gait
    branch's pred_phase (N,4)), and pred_avg (1,3). With `raw_uint8` the
    crops are uint8 and normalized here. The trunk is held outside the
    module's parameters, so a `torch.export` of it carries no weights.

    `names` limits it to some of the segments (the trunk's `segments`,
    then REGRESS): a part after the first takes (state, smpl, carry) and
    hands on a carry dict, and only the part with REGRESS returns the
    outputs. `parts` cuts the forward where the TF32 switches change: a
    program records the masks and casts of its segments but not the
    switches, which the caller sets around each part."""

    def __init__(self, core: GRNetCore, joint_mode: str = "spin2",
                 raw_uint8: bool = True, names=None):
        super().__init__()
        self.__dict__["core"] = core  # not a submodule: no parameters
        self.joint_mode = joint_mode
        self.raw_uint8 = raw_uint8
        every = [n for n, _ in core.segments()] + [REGRESS]
        self.names = every if names is None else list(names)
        self.first = self.names[0] == every[0]

    def parts(self) -> list:
        """[(tf32, BucketForward of the segments in a run of one TF32
        setting)] in order."""
        modes = dict(self.core.segments(), **{REGRESS: "float32"})
        runs = []
        for name in self.names:
            tf32 = modes[name] != "float32"
            if runs and runs[-1][0] == tf32:
                runs[-1][1].append(name)
            else:
                runs.append((tf32, [name]))
        return [(tf32, BucketForward(self.core, self.joint_mode,
                                     self.raw_uint8, names))
                for tf32, names in runs]

    def forward(self, state: dict, smpl: body_smpl.SMPLParams, *inputs):
        if self.first:
            images, bbox, cimg, n_valid = (tuple(inputs) + (None,) * 3)[:4]
            x = normalize_image(images) if self.raw_uint8 else images
            carry = {"x": x.permute(0, 3, 1, 2).contiguous()}
            if self.core.use_gait_feat:
                carry.update(bbox=bbox, cimg=cimg, n_valid=n_valid)
        else:
            carry = inputs[0]
        names = [n for n in self.names if n != REGRESS]
        if names:
            carry = torch.func.functional_call(
                _Segments(self.core), {"core." + k: v for k, v in
                                       state.items()}, (carry, names))
        if REGRESS not in self.names:
            return carry
        out = vp_regress(smpl, carry, joint_mode=self.joint_mode,
                         img_res=self.core.img_res)[0]
        return {k: v if k == "pred_avg" else v[0]
                for k, v in out.items() if k in BUCKET_KEYS}


@dataclass
class GRNet:
    """The trunk module (a GRNetCore, or any trunk of the runner's protocol:
    nn/hmr2.py's HMR2Core), the SMPL tensors and the device they live on."""

    module: GRNetCore
    smpl: body_smpl.SMPLParams
    device: torch.device
    joint_mode: str = "spin2"

    @staticmethod
    def create(smpl_params: Optional[body_smpl.SMPLParams] = None,
               seed: int = 0, joint_mode: str = "spin2", device=None,
               trunk: type = GRNetCore, **module_kwargs) -> "GRNet":
        """A `trunk` (GRNetCore by default) of `module_kwargs` with random
        weights from `seed`, in eval mode, on `device` (default: the card;
        raises when CUDA is absent and the CPU was not asked for). Without
        `smpl_params`, synthetic SMPL tensors are used."""
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            module = trunk(**module_kwargs)
        if smpl_params is None:
            smpl_params = body_smpl.synthetic_smpl_params()
        return GRNet(module=module.to(device).eval(),
                     smpl=smpl_params.to(device), device=device,
                     joint_mode=joint_mode)

    def forward(self, images: torch.Tensor,
                J_regressor: Optional[torch.Tensor] = None,
                bbox=None, cimg=None, n_valid: Optional[int] = None
                ) -> list[dict]:
        """images: (B,T,3,H,W) or (T,3,H,W) crops, or NHWC (N,H,W,3), on the
        model's device, at the trunk's modes (float32 with TF32 off unless
        the module says otherwise). bbox (N,4) [cx,cy,w,h]
        and cimg (N,2) image centres (arrays or tensors) feed the gait
        branch; n_valid (an int) marks the real frames of a padded track."""
        if images.dim() == 5:  # (B,T,3,H,W)
            b = images.shape[0]
            x = images.reshape((-1,) + tuple(images.shape[2:]))
        elif images.dim() == 4 and images.shape[1] == 3:  # (T,3,H,W)
            b, x = 1, images
        elif images.dim() == 4:  # (N,H,W,3)
            b, x = 1, images.permute(0, 3, 1, 2)
        else:
            raise ValueError(f"Wrong input rank: {tuple(images.shape)}")
        kw = {}
        if self.module.use_gait_feat:
            kw = {k: upload(torch.as_tensor(v, dtype=torch.float32),
                            self.device)
                  for k, v in (("bbox", bbox), ("cimg", cimg))
                  if v is not None}
            if n_valid is not None:
                kw["n_valid"] = upload(torch.tensor(n_valid), self.device)
        with torch.inference_mode():
            patt = self.module(x.contiguous(), **kw)
            with span("model/regress"):
                return vp_regress(self.smpl, patt, batch_size=b,
                                  J_regressor=J_regressor,
                                  joint_mode=self.joint_mode,
                                  img_res=self.module.img_res)
