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
ship beside them as `weights.npz`, keyed by the state_dict's keys. A
program records its device, so each platform gets its own file,
`forward_b{n}.{platform}.pt2`, exported on that device (the card's needs a
machine with one). Typical flow::

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
from gaitlab_torch.body.smpl import SMPLParams
from gaitlab_torch.device import float32_math, resolve_device, upload
from gaitlab_torch.pipeline.runner import GRNetRunner, _pad_rows

# The programs' input trees hold SMPLParams (a NamedTuple): register its
# serialization once, so that they load in a fresh interpreter.
try:
    pytree._register_namedtuple(
        SMPLParams, serialized_type_name="gaitlab_torch.body.smpl.SMPLParams")
except ValueError:
    pass  # already registered in this process

_MANIFEST = "manifest.json"
_WEIGHTS = "weights.npz"


def _program_smpl(smpl: SMPLParams) -> SMPLParams:
    """The SMPL tensors a program takes: the host-side faces stay out."""
    return smpl._replace(faces=None)


def export_forward(runner: GRNetRunner, batch: int, raw_uint8: bool = True,
                   platforms: Sequence[str] = ("cuda", "cpu")) -> dict:
    """Export one bucket's forward for each platform: {platform:
    torch.export.ExportedProgram}. The example inputs are made on each
    platform's device, which must be present (the card's raises without
    CUDA)."""
    fwd = runner._forward(batch, raw_uint8)
    model = runner.model
    cs = runner.crop_size
    programs = {}
    for platform in platforms:
        dev = resolve_device(platform)

        def like(x):
            return torch.empty_like(x, device=dev)

        args = [{k: like(v) for k, v in model.module.state_dict().items()},
                SMPLParams(*(like(x) if isinstance(x, torch.Tensor) else x
                             for x in _program_smpl(model.smpl))),
                torch.zeros((batch, cs, cs, 3), device=dev,
                            dtype=torch.uint8 if raw_uint8 else torch.float32)]
        if model.module.use_gait_feat:
            args += [torch.zeros((batch, 4), device=dev),
                     torch.zeros((batch, 2), device=dev),
                     torch.tensor(batch, device=dev)]
        with torch.no_grad():
            ep = torch.export.export(fwd, tuple(args), strict=False)
        ep.example_inputs = None  # the weights' copies stay out of the file
        programs[platform] = ep
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
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "crop_size": runner.crop_size,
        "raw_uint8": bool(raw_uint8),
        "precision": runner.precision,
        # what the programs run: everything in float32, TF32 off
        "head_precision": "float32",
        "trunk_dtype": "float32",
        "gait": bool(runner.model.module.use_gait_feat),
        "joint_mode": runner.model.joint_mode,
        "buckets": list(buckets),
        "files": {},
    }
    for b in buckets:
        files = {}
        for platform, ep in export_forward(runner, b, raw_uint8,
                                           platforms).items():
            files[platform] = f"forward_b{b}.{platform}.pt2"
            torch.export.save(ep, os.path.join(out_dir, files[platform]))
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
        self.exported = exported  # bucket -> torch.export.ExportedProgram
        self._programs = {b: ep.module() for b, ep in exported.items()}
        self.buckets = sorted(exported)
        # the weights from the artifact directory, on the device, when
        # shipped there
        self.variables = variables
        self.smpl = smpl

    def _run(self, b: int, variables, smpl, images, bbox=None, cimg=None,
             n_valid=None) -> dict:
        """Bucket b's program on device tensors of b rows, in float32 with
        TF32 off; n_valid an int."""
        args = [variables, _program_smpl(smpl), images]
        if self.manifest["gait"]:
            args += [bbox, cimg,
                     upload(torch.tensor(n_valid), self.device)]
        with float32_math(), torch.inference_mode():
            return self._programs[b](*args)

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


def load_artifacts(path: str, device=None) -> ServingModel:
    """Load a save_artifacts directory's programs for `device` (None: the
    card) and its weights onto it; no model code needed beyond this
    module."""
    device = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if device.type not in manifest["platforms"]:
        raise ValueError(f"{path} has no {device.type} programs (platforms "
                         f"{manifest['platforms']})")
    exported = {int(b): torch.export.load(os.path.join(path,
                                                       files[device.type]))
                for b, files in manifest["files"].items()}
    variables = smpl = None
    if manifest.get("weights") and os.path.isfile(
            os.path.join(path, manifest["weights"])):
        variables, smpl = load_weights(path)
        variables = {k: upload(v, device) for k, v in variables.items()}
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
    # the only model attributes the runner's paths read
    model = SimpleNamespace(
        module=SimpleNamespace(use_gait_feat=bool(man["gait"])),
        smpl=serving.smpl, device=serving.device,
        joint_mode=man["joint_mode"])
    kw = dict(buckets=tuple(man["buckets"]), crop_size=man["crop_size"],
              precision=man["precision"],
              # exported programs take raw uint8 crops -> host-crop feed
              crop_on="host" if man["raw_uint8"] else "device")
    kw.update(runner_kwargs)
    return ServingRunner(model, serving=serving, **kw)
