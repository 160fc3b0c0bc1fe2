"""Version-pinned serving artifacts via `torch.export`.

Counterpart of gaitlab/serve.py. Each artifact is one bucket's forward,
`fwd(state_dict, smpl, images[, bbox, cimg, n_valid])` at ONE static batch
size: the runner's `_forward(n, raw_uint8)` (pipeline/runner.py), crop ->
backbone -> head [-> gait branch] -> SMPL -> projection, saved as a `.pt2`
program that reloads WITHOUT the model code, from the artifact plus the
weight arrays, so a deployment runs the exact pinned program however the
Python model evolves.

Both kernels are custom ops (`gaitlab::keypoint_attention_fused`,
`gaitlab::blendshapes`): each is one node of the graph, and the device the
program runs on picks its implementation (the CUDA kernel on the card).
Importing this module registers them, and SMPLParams for serialization.
The gait branch's real-frame count `n_valid` is an input of the program,
read on the device at run time.

The weights stay OUTSIDE the programs (their state_dicts are empty) and
ship beside them as `weights.npz`, keyed by the state_dict's keys (in
float32; a bf16 trunk's programs get them cast once at load). A program
records its device, so each platform gets its own files, exported on that
device (the card's needs a machine with one).

A program records the masks and casts of a precision mode but not the
TF32 switches, which cuDNN and cuBLAS read when an op is launched. So a
bucket's forward is cut where its segments' TF32 setting changes
(nn/grnet.py BucketForward.parts): one program per run of one setting,
`forward_b{n}.{platform}.pt2` when there is one (float32: TF32 off
throughout), `forward_b{n}.{i}.{platform}.pt2` for part i otherwise (the
trunk at "high" or "default" with TF32 on, then the SMPL regression with
it off). The manifest lists each part's setting under "tf32", and
`ServingModel` runs each part with the TF32 gate (device.math_mode) set
so. It also records the modes the programs run: precision, the resolved
head precision and region modes, and trunk_dtype. Typical flow::

    runner = GRNetRunner(model)
    serve.save_artifacts(runner, "artifacts/")        # cuda + cpu programs
    ...                                # later, possibly another machine
    arts = serve.load_artifacts("artifacts/")         # the card's programs
    out = arts.call(None, None, crops_uint8)          # picks the bucket
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

# the programs' kernel nodes: importing the wrappers registers the ops
import gaitlab_torch.ops.blendshapes  # noqa: F401
import gaitlab_torch.ops.keypoint_attention  # noqa: F401
import gaitlab_torch.ops.upsample_bilinear  # noqa: F401
import gaitlab_torch.ops.vit_linear  # noqa: F401
from gaitlab_torch.body.smpl import SMPLParams
from gaitlab_torch.device import math_mode, resolve_device, upload
from gaitlab_torch.pipeline.runner import TRUNK_DTYPES, GRNetRunner, _pad_rows

# The programs' input trees hold SMPLParams (a NamedTuple): register its
# serialization once, so that they load in a fresh interpreter.
try:
    pytree._register_namedtuple(
        SMPLParams, serialized_type_name="gaitlab_torch.body.smpl.SMPLParams")
except ValueError:
    pass  # already registered in this process

_MANIFEST = "manifest.json"
_WEIGHTS = "weights.npz"
# 2: a list of programs per bucket and platform, their TF32 settings
# ("tf32") and the resolved modes; 1 (no "manifest_version"): one float32
# program per bucket and platform
MANIFEST_VERSION = 2


def _program_smpl(smpl: SMPLParams) -> SMPLParams:
    """The SMPL tensors a program takes: the host-side faces stay out."""
    return smpl._replace(faces=None)


def export_forward(runner: GRNetRunner, batch: int, raw_uint8: bool = True,
                   platforms: Sequence[str] = ("cuda", "cpu")) -> dict:
    """Export one bucket's forward for each platform: {platform: [(tf32,
    torch.export.ExportedProgram) for each part]}. The example inputs are
    made on each platform's device, which must be present (the card's
    raises without CUDA); a later part's are the previous part's outputs
    on them."""
    fwd = runner._forward(batch, raw_uint8)
    model = runner.model
    cs = runner.crop_size
    programs = {}
    for platform in platforms:
        dev = resolve_device(platform)

        def like(x):
            return torch.zeros_like(x, device=dev)

        state = {k: like(v) for k, v in fwd.core.state_dict().items()}
        smpl = SMPLParams(*(like(x) if isinstance(x, torch.Tensor) else x
                            for x in _program_smpl(model.smpl)))
        inputs = [torch.zeros((batch, cs, cs, 3), device=dev,
                              dtype=torch.uint8 if raw_uint8
                              else torch.float32)]
        if model.module.use_gait_feat:
            inputs += [torch.zeros((batch, 4), device=dev),
                       torch.ones((batch, 2), device=dev),
                       torch.tensor(batch, device=dev)]
        parts = []
        for i, (tf32, part) in enumerate(fwd_parts := fwd.parts()):
            args = (state, smpl, *inputs)
            with torch.no_grad():
                ep = torch.export.export(part, args, strict=False)
                if i + 1 < len(fwd_parts):
                    with math_mode(tf32):
                        inputs = [part(*args)]
            ep.example_inputs = None  # the weights' copies stay out of the file
            parts.append((tf32, ep))
        programs[platform] = parts
    return programs


def save_weights(out_dir: str, model) -> str:
    """Write the model's weights (the trunk's state_dict and SMPLParams)
    next to the artifacts as `var:<state_dict key>` and `smpl:<field>`
    arrays, so a deployment starts from the directory alone: the programs
    take the weights as inputs."""
    flat = {"var:" + k: v.detach().cpu().numpy()
            for k, v in model.module.state_dict().items()}
    for name, val in model.smpl._asdict().items():
        if val is not None:
            flat["smpl:" + name] = np.asarray(
                val.cpu() if isinstance(val, torch.Tensor) else val)
    np.savez(os.path.join(out_dir, _WEIGHTS), **flat)
    return _WEIGHTS


def load_weights(path: str):
    """Inverse of save_weights: (state_dict, SMPLParams) on the CPU; the
    faces stay a numpy array, absent fields None."""
    z = np.load(os.path.join(path, _WEIGHTS))
    state, smpl_kw = {}, {}
    for k in z.files:
        kind, rest = k.split(":", 1)
        if kind == "var":
            state[rest] = torch.from_numpy(z[k])
        elif rest == "faces":
            smpl_kw[rest] = z[k]
        else:
            smpl_kw[rest] = torch.from_numpy(z[k])
    return state, SMPLParams(**smpl_kw)


def save_artifacts(runner: GRNetRunner, out_dir: str,
                   buckets: Optional[Sequence[int]] = None,
                   raw_uint8: bool = True,
                   platforms: Sequence[str] = ("cuda", "cpu"),
                   include_weights: bool = True) -> dict:
    """Export every bucket for every platform, write
    `forward_b{n}.{platform}.pt2` + manifest (+ the weights, so the
    directory is a complete deployment)."""
    os.makedirs(out_dir, exist_ok=True)
    buckets = tuple(buckets) if buckets else tuple(runner.buckets)
    manifest = {
        "format": "torch.export",
        "manifest_version": MANIFEST_VERSION,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "crop_size": runner.crop_size,
        "raw_uint8": bool(raw_uint8),
        # the modes the programs run (resolved, as gaitlab records them)
        "precision": runner.precision,
        "head_precision": runner.resolved_head_precision(),
        "region_precision": [list(r) for r in
                             runner.resolved_region_precision()],
        "resize_precision": runner.resolved_resize_precision(),
        "trunk_dtype": runner.trunk_dtype,
        "gait": bool(runner.model.module.use_gait_feat),
        "joint_mode": runner.model.joint_mode,
        "buckets": list(buckets),
        "files": {},
    }
    for b in buckets:
        files = {}
        for platform, parts in export_forward(runner, b, raw_uint8,
                                              platforms).items():
            manifest["tf32"] = [tf32 for tf32, _ in parts]
            files[platform] = ([f"forward_b{b}.{platform}.pt2"]
                               if len(parts) == 1 else
                               [f"forward_b{b}.{i}.{platform}.pt2"
                                for i in range(len(parts))])
            for name, (_, ep) in zip(files[platform], parts):
                torch.export.save(ep, os.path.join(out_dir, name))
        manifest["files"][str(b)] = files
    if include_weights:
        manifest["weights"] = save_weights(out_dir, runner.model)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServingModel:
    """Loaded bucket programs of one platform, with runner-style padded
    dispatch."""

    def __init__(self, manifest: dict, exported: dict, device,
                 variables=None, smpl=None):
        self.manifest = manifest
        self.device = torch.device(device)
        # bucket -> the parts' torch.export.ExportedPrograms, in order
        self.exported = exported
        self._programs = {b: [ep.module() for ep in eps]
                          for b, eps in exported.items()}
        self.buckets = sorted(exported)
        # the weights from the artifact directory, on the device, when
        # shipped there
        self.variables = variables
        self.smpl = smpl

    def _run(self, b: int, variables, smpl, images, bbox=None, cimg=None,
             n_valid=None) -> dict:
        """Bucket b's programs on device tensors of b rows, each part with
        the TF32 switches its manifest entry says; n_valid an int."""
        smpl = _program_smpl(smpl)
        inputs = [images]
        if self.manifest["gait"]:
            inputs += [bbox, cimg,
                       upload(torch.tensor(n_valid), self.device)]
        with torch.inference_mode():
            for tf32, prog in zip(self.manifest["tf32"], self._programs[b]):
                with math_mode(tf32):
                    inputs = [prog(variables, smpl, *inputs)]
        return inputs[0]

    def call(self, variables, smpl, images, bbox=None, cimg=None,
             n_valid=None) -> dict:
        """Run one batch, padding to the smallest covering bucket by
        repeating the last row; numpy outputs.

        variables/smpl may be None when the artifact directory shipped
        weights (save_artifacts include_weights). Outputs are sliced back
        to the true row count (pred_avg, a sequence-level aggregate, is
        returned as it is)."""
        variables = self.variables if variables is None else variables
        smpl = self.smpl if smpl is None else smpl
        if variables is None or smpl is None:
            raise ValueError("no weights: pass variables/smpl or export "
                             "with include_weights=True")
        n = images.shape[0]
        covering = [b for b in self.buckets if b >= n]
        if not covering:
            raise ValueError(
                f"batch {n} exceeds the largest exported bucket "
                f"{self.buckets[-1]}")
        b = covering[0]

        def rows(x):
            return None if x is None else _pad_rows(
                upload(torch.as_tensor(x), self.device), b)

        out = self._run(b, variables, smpl, rows(images), rows(bbox),
                        rows(cimg), n if n_valid is None else n_valid)
        return {k: (v if k == "pred_avg" else v[:n]).cpu().numpy()
                for k, v in out.items()}


def read_manifest(path: str) -> dict:
    """A save_artifacts directory's manifest, in this version's layout. A
    manifest without "manifest_version" (version 1) was written before the
    precision modes: one program a bucket and platform, float32 with TF32
    off throughout, which is what it is read as. A version this module does
    not know raises."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    version = manifest.get("manifest_version", 1)
    if version == 1:
        manifest.update(
            manifest_version=MANIFEST_VERSION,
            files={b: {p: [f] for p, f in files.items()}
                   for b, files in manifest["files"].items()},
            tf32=[False], head_precision=None, region_precision=[],
            resize_precision="highest", trunk_dtype=None)
    elif version != MANIFEST_VERSION:
        raise ValueError(f"{path}: manifest_version {version}, but this "
                         f"version reads 1 and {MANIFEST_VERSION}: export "
                         "the artifacts again")
    return manifest


def load_artifacts(path: str, device=None) -> ServingModel:
    """Load a save_artifacts directory's programs for `device` (None: the
    card) and its weights onto it; no model code needed beyond this
    module."""
    device = resolve_device(device)
    manifest = read_manifest(path)
    if device.type not in manifest["platforms"]:
        raise ValueError(f"{path} has no {device.type} programs (platforms "
                         f"{manifest['platforms']})")
    exported = {int(b): [torch.export.load(os.path.join(path, f))
                         for f in files[device.type]]
                for b, files in manifest["files"].items()}
    variables = smpl = None
    if manifest.get("weights") and os.path.isfile(
            os.path.join(path, manifest["weights"])):
        variables, smpl = load_weights(path)
        dtype = TRUNK_DTYPES.get(manifest["trunk_dtype"])
        variables = {k: upload(v if dtype is None or not v.is_floating_point()
                               else v.to(dtype), device)
                     for k, v in variables.items()}
        smpl = smpl.to(device)
    return ServingModel(manifest, exported, device, variables, smpl)


# --------------------------------------------------------- pipeline runner


@dataclass
class ServingRunner(GRNetRunner):
    """A GRNetRunner whose bucket forwards are the loaded programs of a
    ServingModel (see load_runner)."""

    serving: Optional[ServingModel] = None

    @property
    def takes_uint8(self) -> bool:
        return bool(self.serving.manifest["raw_uint8"])

    def _live(self, check: bool = True) -> dict:
        return {}  # the programs and their weights derive from no model

    def resolved_region_precision(self) -> tuple:
        """The exported programs' backbone regions (the manifest's)."""
        return tuple(tuple(r) for r in
                     self.serving.manifest["region_precision"])

    def resolved_resize_precision(self) -> str:
        return self.serving.manifest["resize_precision"]

    def _forward(self, n: int, raw_uint8: bool = False):
        if bool(raw_uint8) != self.takes_uint8:
            raise ValueError(
                f"artifacts were exported with raw_uint8={self.takes_uint8}; "
                f"this dispatch path needs {raw_uint8} (set crop_on "
                "accordingly)")
        if n not in self.serving.buckets:
            raise ValueError(f"no exported program for bucket {n} "
                             f"(have {self.serving.buckets})")
        return self.serving._programs[n]

    def _forward_bucket(self, crops: torch.Tensor, bbox=None, cimg=None
                        ) -> dict:
        m = crops.shape[0]
        b = self._bucket(m)
        self._forward(b, crops.dtype == torch.uint8)
        s = self.serving
        out = s._run(b, s.variables, s.smpl, _pad_rows(crops, b),
                     None if bbox is None else _pad_rows(bbox, b),
                     None if cimg is None else _pad_rows(cimg, b), m)
        return {k: v if k == "pred_avg" else v[:m] for k, v in out.items()}


def load_runner(path: str, device=None, **runner_kwargs) -> ServingRunner:
    """A GRNetRunner whose per-bucket forwards are the PINNED exported
    programs: the full pipeline (host decode, detect/track, host crop,
    bucketed padded dispatch, streaming/one-pass) runs unchanged on top,
    but nothing is traced from Python model code and the weights come from
    the artifact directory."""
    serving = load_artifacts(path, device)
    man = serving.manifest
    if serving.variables is None:
        raise ValueError(f"{path} has no weights.npz: export with "
                         "include_weights=True, or run from the runner")
    # the only model attributes the runner's paths read; the modes come
    # back from the manifest (gaitlab's load_runner reads them so)
    model = SimpleNamespace(
        module=SimpleNamespace(use_gait_feat=bool(man["gait"])),
        smpl=serving.smpl, device=serving.device,
        joint_mode=man["joint_mode"])
    kw = dict(buckets=tuple(man["buckets"]), crop_size=man["crop_size"],
              precision=man["precision"],
              head_precision=man["head_precision"],
              trunk_dtype=man["trunk_dtype"],
              # exported programs take raw uint8 crops -> host-crop feed
              crop_on="host" if man["raw_uint8"] else "device")
    kw.update(runner_kwargs)
    return ServingRunner(model, serving=serving, **kw)
