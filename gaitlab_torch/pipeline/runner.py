"""Track-level inference: frames -> crops -> bucketed trunk + SMPL -> numpy.

Counterpart of gaitlab/pipeline/runner.py. Frames arrive in
chunks (from memory, from image files through the prefetching
native loader, `ingest_chunk` at a time, or as a video reader decodes
them) and are cropped on the device (small
frames: only full frames cross to the card) or with cv2 on the host (large
frames: only crop_size^2 crops cross). The model runs at a small set of batch
sizes ("buckets"), with the tail padded by repeating its last crop, so
that every forward has one of a few shapes. The weights stay on the
model's device, and with a mesh (`parallel="dp"`) each bucket is split
over replicas of the model on the mesh's data axis; `parallel="pp"` runs
each track through the 2-stage pipeline of parallel/pipeline.py instead.

Forwards go through a `ForwardStream` session (`open_stream`): crop chunks
are fed as they come, a forward runs on the session's worker thread
whenever a largest bucket has filled, and the outputs stay on the device
until `finish` reads back once the keys of `fetch` (all by default;
batch_generation takes only kp_3d, not the vertices). Host data crosses
to the card as asynchronous copies from pinned memory (`device.upload`).
With the gait branch each forward also takes the chunk's bbox and
image-centre rows and its real-frame count (n_valid); the track-level
gait estimate (pred_avg) of each forward is then averaged with weights
equal to its real frames, and pred_phase is concatenated.

Precision: `precision` ("float32", the port's default, "high" or
"default"), `head_precision` ("auto" by default) and `trunk_dtype` (None
or "bfloat16") are gaitlab's, and resolve by gaitlab's rules
(`resolved_*_precision`). The forward runs a view of the model's trunk at
the resolved modes (`_resolved_module`), or under trunk_dtype a bf16 copy
of it; each of its segments switches the TF32 gate (device.math_mode) as
its mode says, and the SMPL regression always runs with TF32 off. What
the runner derives from the model (that view, the bf16 copy, the
data-parallel replicas and SMPL's tensors on their devices, the
pipeline) is rebuilt whenever `model.module` or `model.smpl` is
reassigned or one of their tensors has changed in place (a weight
reload), and the pipeline is built at first use, as gaitlab does.

The trunk: `model.module` is any nn.Module with these members, which is
all the runner reads of it (GRNet's GRNetCore and HMR 2.0's HMR2Core,
nn/hmr2.py):
  * `use_gait_feat`: whether forwards take bbox, cimg and n_valid rows and
    give pred_avg and pred_phase;
  * `img_res`: the crop size that vp_regress projects at, and the crop the
    entry points give the runner;
  * `at_modes(precision, head_precision)`: the trunk at the runner's
    resolved modes (itself, or a view sharing its tensors; GRNetCore
    resolves its backbone's regions and resize from them);
  * `segments()` and `run_segments(carry, names)`: the forward as named
    precision segments, each a span `model/<name>`; calling the module
    runs them all, once a bucket's forward.
A mode that a trunk cannot run raises ValueError where the runner is made
or its first forward runs, never falls back (the "pp" pipeline splits
GRNet's backbone from its head, so it takes a GRNetCore only).

`_forward(n, raw_uint8)` is one bucket's forward as a module whose weights
are inputs (gaitlab's jitted `GRNetRunner._forward`): `serve.py` exports
it, and its serving runner feeds the exported programs the bucket's raw
uint8 host crops (`takes_uint8`). The module imports no model code until
a live runner needs it.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import itertools
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np
import torch

from gaitlab_torch.device import upload
from gaitlab_torch.parallel import mesh as mesh_mod
from gaitlab_torch.parallel.replicas import Replicas, gather, scatter
from gaitlab_torch.pipeline import crop as crop_mod
from gaitlab_torch.pipeline import loader
from gaitlab_torch.utils import span, span_parent

if TYPE_CHECKING:
    from gaitlab_torch.nn.grnet import GRNet

DEFAULT_BUCKETS = (32, 64, 128, 256, 450)
OUTPUT_KEYS = ("theta", "verts", "kp_2d", "kp_3d")
GAIT_KEYS = ("pred_avg", "pred_phase")
PRECISIONS = ("float32", "high", "default")
TRUNK_DTYPES = {"bfloat16": torch.bfloat16}


@dataclass
class GRNetRunner:
    model: GRNet
    buckets: Optional[Sequence[int]] = None  # None -> $GAITLAB_BUCKETS or default
    crop_size: int = 224  # the entry points give the trunk's img_res
    bbox_scale: float = 1.0
    ingest_chunk: int = 32   # full-res frames decoded / staged at once
    # "float32" (TF32 off; the port's default, where gaitlab's is "high"),
    # "high" (three TF32 passes of bf16-masked parts: gaitlab's bf16_3x)
    # or "default" (one TF32 pass); layers.py says what each means here
    precision: str = "float32"
    # the PARE head's mode: "auto" = "default" under precision "high" (and
    # inherit otherwise), None = inherit, or a mode
    head_precision: Optional[str] = "auto"
    # "bfloat16": the trunk (backbone, head, corrector) runs on a bf16 copy
    # of the weights with bf16 activations; SMPL stays float32
    trunk_dtype: Optional[str] = None
    # "device": crop on the card; "host": cv2 on the CPU; "auto": host for
    # frames larger than twice the crop area, the device otherwise
    crop_on: str = "auto"
    # output keys read back to the host (None: all); the gait keys
    # pred_avg and pred_phase always come back when the model makes them
    fetch: Optional[Sequence[str]] = None
    # a ("data", "model") mesh (parallel/mesh.py): each bucket is split
    # evenly over replicas of the model on its data axis
    mesh: Optional[mesh_mod.DeviceMesh] = None
    # None: the model's device (or whatever `mesh` says); "dp": data
    # parallel over the mesh, by default one over the model's devices
    # (every visible card); "pp": the 2-stage pipeline (backbone group |
    # head+SMPL group) over them. The gait branch: "dp" only
    parallel: Optional[str] = None
    # "pp" only: the backbone group's size (default: half the devices)
    pp_n_stage0: Optional[int] = None
    # the bucket forward takes raw uint8 crops and normalizes them itself
    # (a serving runner's programs): host crops then stay uint8 until then
    takes_uint8 = False
    # what is derived from the model's weights (_live), and the weights'
    # identity and versions it was derived from
    _derived: dict = field(default_factory=dict, init=False, repr=False)
    _derived_from: object = field(default=None, init=False, repr=False)
    # each run_track's id in its spans
    _track_ids: itertools.count = field(default_factory=itertools.count,
                                        init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise ValueError(f"precision={self.precision!r}: use one of "
                             f"{PRECISIONS}")
        if self.head_precision not in (None, "auto") + PRECISIONS:
            raise ValueError(f"head_precision={self.head_precision!r}: use "
                             f"'auto', None or one of {PRECISIONS}")
        if self.trunk_dtype is not None and \
                self.trunk_dtype not in TRUNK_DTYPES:
            raise ValueError(f"trunk_dtype={self.trunk_dtype!r}: use None or "
                             f"one of {tuple(TRUNK_DTYPES)}")
        if self.parallel not in (None, "dp", "pp"):
            raise ValueError(f"parallel={self.parallel!r}: use 'dp'/'pp'")
        if self.parallel == "pp" and self.mesh is not None:
            raise ValueError("parallel='pp' builds its own device groups; "
                             "drop mesh= (or use parallel='dp')")
        if self.parallel == "pp" and self.model.module.use_gait_feat:
            raise ValueError(
                "parallel='pp' pipelines the per-frame trunk; the gait "
                "branch is track-sequential — use parallel='dp'")
        if self.crop_on not in ("auto", "device", "host"):
            raise ValueError(f"crop_on={self.crop_on!r}: use auto/device/host")
        if self.parallel == "dp" and self.mesh is None:
            self.mesh = mesh_mod.make_mesh(
                devices=mesh_mod.devices_for(self.model.device))
        if self.buckets is None:
            env = os.environ.get("GAITLAB_BUCKETS", "")
            self.buckets = (tuple(int(x) for x in env.split(",") if x)
                            if env else DEFAULT_BUCKETS)
        if self.mesh is not None:
            # each bucket splits evenly over the data axis
            d = self.mesh.shape[mesh_mod.DATA_AXIS]
            self.buckets = tuple({-(-b // d) * d for b in self.buckets})
        self.buckets = tuple(sorted(set(self.buckets)))
        if self.parallel == "pp":  # before any decode: fail fast
            from gaitlab_torch.parallel.pipeline import GRNetPipeline

            GRNetPipeline.check_devices(self.model, self.pp_n_stage0)

    # -- precision -----------------------------------------------------------

    def resolved_head_precision(self) -> Optional[str]:
        """The PARE head's mode: "auto" is "default" under precision "high"
        and inherit (None) otherwise, as in gaitlab."""
        head_prec = self.head_precision
        if head_prec == "auto":
            head_prec = "default" if self.precision == "high" else None
        return head_prec

    def resolved_region_precision(self) -> tuple:
        """GRNet's backbone per-region modes (GRNetCore.region_precision_at);
        a trunk without HRNet's regions has none."""
        at = getattr(self.model.module, "region_precision_at", None)
        return () if at is None else at(self.precision)

    def resolved_resize_precision(self) -> str:
        """GRNet's resize precision (GRNetCore.resize_precision_at); a trunk
        without HRNet's resizes reads "highest"."""
        at = getattr(self.model.module, "resize_precision_at", None)
        return "highest" if at is None else at(self.precision)

    @property
    def _dp(self) -> Optional[tuple]:
        """With a mesh: (the replicas, SMPL's tensors on their devices)."""
        return self._live().get("dp")

    def _resolved_module(self):
        """The model's trunk at the resolved modes (its `at_modes`: itself
        or a view sharing the model's weights)."""
        return self.model.module.at_modes(self.precision,
                                          self.resolved_head_precision())

    def _weights_state(self) -> tuple:
        """What tells a weight change: the identity of the module and of
        SMPL's tensors, and every tensor's version counter (bumped by each
        in-place write, such as load_state_dict's)."""
        module, smpl = self.model.module, self.model.smpl
        tensors = [*module.parameters(), *module.buffers(),
                   *(t for t in smpl if isinstance(t, torch.Tensor))]
        return (id(module), id(smpl),
                sum(0 if t.is_inference() else t._version for t in tensors))

    def _live(self, check: bool = True) -> dict:
        """What the forwards run, derived from the model's current weights:
        "core" (the resolved view, or its bf16 copy under trunk_dtype),
        "model" (a GRNet of it), with a mesh "dp" (its replicas and SMPL's
        tensors on their devices), and with parallel="pp" the pipeline,
        built here at first use. All of it is made again when the weights
        have changed since it was made (`_weights_state`); replica 0 is the
        trunk itself (the model's module when it runs at the resolved modes
        already, else a view of it, with the same tensors). The check walks
        every tensor, so a session makes it once, when it opens, and its
        buckets pass `check=False`, as gaitlab's session reads its
        variables once."""
        state = (self._weights_state() if check or not self._derived
                 else self._derived_from)
        if state != self._derived_from:
            core = self._resolved_module()
            if self.trunk_dtype is not None:
                core = copy.deepcopy(core).to(TRUNK_DTYPES[self.trunk_dtype])
            model = dataclasses.replace(self.model, module=core)
            self._derived = {"core": core, "model": model}
            if self.mesh is not None:
                reps = Replicas(core, self.mesh.data_devices)
                self._derived["dp"] = (reps, [self.model.smpl.to(dev)
                                              for dev in reps.devices])
            self._derived_from = state
        if self.parallel == "pp" and "pp" not in self._derived:
            from gaitlab_torch.parallel.pipeline import GRNetPipeline

            self._derived["pp"] = GRNetPipeline(self._derived["model"],
                                                n_stage0=self.pp_n_stage0)
        return self._derived

    def _bucket(self, n: int) -> int:
        i = bisect.bisect_left(self.buckets, n)
        return self.buckets[min(i, len(self.buckets) - 1)]

    # -- model forward at bucket sizes -------------------------------------

    def _forward(self, n: int, raw_uint8: bool = False):
        """The forward at bucket n as a module of (state_dict, SMPLParams,
        NHWC crops[, bbox, cimg, n_valid]) with the weights as inputs (of
        the trunk `_live` runs: bf16 under trunk_dtype): uint8 crops,
        normalized inside, with `raw_uint8`. What `serve.export_forward`
        exports, part by part (BucketForward.parts)."""
        from gaitlab_torch.nn.grnet import BucketForward

        return BucketForward(self._live()["core"], self.model.joint_mode,
                             raw_uint8)

    def _forward_bucket(self, crops: torch.Tensor, bbox=None, cimg=None
                        ) -> dict:
        """One forward of m <= max-bucket normalized NHWC crops (and, for
        the gait branch, their bbox/cimg rows), padded to the bucket size by
        repeating the last row; per-frame outputs sliced back to m frames,
        on the device. The gait branch is told that m frames are real."""
        m = crops.shape[0]
        b = self._bucket(m)
        crops = _pad_rows(crops, b)
        kw = {}
        if self.model.module.use_gait_feat:
            kw = dict(bbox=_pad_rows(bbox, b), cimg=_pad_rows(cimg, b),
                      n_valid=m)
        live = self._live(check=False)  # checked when the session opened
        if "dp" not in live:
            out = live["model"].forward(crops, **kw)[0]
        else:
            out = self._dp_forward(live["dp"], crops, **kw)
        res = {k: out[k][0, :m] for k in OUTPUT_KEYS + ("pred_phase",)
               if k in out}
        if "pred_avg" in out:
            res["pred_avg"] = out["pred_avg"]  # (1,3): one per forward
        return res

    def _dp_forward(self, dp: tuple, crops: torch.Tensor, bbox=None,
                    cimg=None, n_valid: Optional[int] = None) -> dict:
        """One padded bucket's forward, data-parallel over the mesh's data
        axis: the bucket split evenly over the replicas, each replica's part
        launched from its own thread on its own stream, the outputs gathered
        in order onto the first replica's device (model.forward's dict
        layout). With the gait branch the replicas run its per-frame part
        (GRNetCore.frame_part), and the corrector, sequential over the
        track, runs on the gathered rows on the first device, as gaitlab's
        sharding has it: the trunk split, the GRU not."""
        from gaitlab_torch.nn.grnet import vp_regress

        reps, smpls = dp
        dev0, joint_mode = reps.devices[0], self.model.joint_mode
        parent = span_parent()  # the replicas' threads have no open span

        def nchw(x):
            return x.permute(0, 3, 1, 2).contiguous()

        def whole(core, smpl, x):
            patt = core(nchw(x))
            with span("model/regress", parent=parent):
                out = vp_regress(smpl, patt, joint_mode=joint_mode,
                                 img_res=core.img_res)[0]
            return {k: out[k] for k in OUTPUT_KEYS}

        def frames(core, x, bb, ci):
            out = core.frame_part(nchw(x), bb, ci)
            del out["pred_segm_mask"]  # large, and nothing reads it
            return out

        parts = scatter(crops, reps.devices)
        with torch.inference_mode():
            if bbox is None:
                return gather(reps.apply(whole, list(zip(smpls, parts))),
                              dev0, dim=1)
            rows = gather(reps.apply(frames, list(zip(
                parts, scatter(bbox, reps.devices),
                scatter(cimg, reps.devices)))), dev0)
            patt = reps.modules[0].track_part(
                rows, upload(torch.tensor(n_valid), dev0))
            with span("model/regress"):
                return vp_regress(smpls[0], patt, joint_mode=joint_mode)[0]

    def _pp_forward(self, crops: torch.Tensor) -> dict:
        """A whole track's normalized crops through the 2-stage pipeline
        at its default microbatch: gaitlab's keys (theta, verts, kp_2d,
        kp_3d) that `fetch` asks for, as numpy arrays."""
        out = self._live()["pp"](crops)
        want = set(OUTPUT_KEYS if self.fetch is None else self.fetch)
        return {k: out[k][0] for k in OUTPUT_KEYS if k in want}

    def open_stream(self) -> "ForwardStream":
        """An incremental forward session: feed() crop chunks (and, for
        the gait branch, their bbox/cimg rows) as they come, finish()
        once. The session runs on what `_live` derives from the weights
        as they are now."""
        self._live()
        return ForwardStream(self)

    def _forward_stream(self, crop_chunks, bbox=None, cimg=None) -> dict:
        """Feed each crop chunk with its slice of the track's rows. When
        the chunks fail (a decode error, a frame count short of the
        bboxes), the session is closed first: a forward's error, if any,
        raises ahead of the chunks' own."""
        session = self.open_stream()
        s = 0
        try:
            for chunk in crop_chunks:
                e = s + chunk.shape[0]
                session.feed(chunk, bbox=None if bbox is None else bbox[s:e],
                             cimg=None if cimg is None else cimg[s:e])
                s = e
        except BaseException:
            session.close()
            raise
        return session.finish()

    def forward_crops(self, crops, bbox=None, cimg=None) -> dict:
        """Normalized NHWC crops (N,crop,crop,3) -> output dict of numpy
        arrays, run at bucket sizes. bbox/cimg (N,4)/(N,2) feed the gait
        branch when the model has one."""
        return self._forward_stream([crops], bbox=bbox, cimg=cimg)

    # -- crops ---------------------------------------------------------------

    def _frame_hw(self, frames_or_paths) -> tuple[int, int]:
        """(H, W) of a track's frames: an array, a chunked frame source or
        image paths (the first image is read)."""
        if isinstance(frames_or_paths, np.ndarray):
            return tuple(frames_or_paths.shape[1:3])
        if hasattr(frames_or_paths, "image_hw"):
            return tuple(frames_or_paths.image_hw)
        return tuple(loader.image_size(list(frames_or_paths)[0]))

    def _crop_stream(self, frames_or_paths, bboxes: np.ndarray,
                     scale: Optional[float] = None):
        """Yield normalized NHWC crop chunks on the model's device for a
        track given as an (N,H,W,3) uint8 array, a chunked frame source
        (video.VideoChunkReader) or a list of image paths; host crops stay
        uint8 on the host when the forward `takes_uint8`."""
        scale = self.bbox_scale if scale is None else scale
        n = len(bboxes)
        hh, ww = self._frame_hw(frames_or_paths)
        crop_on = self.crop_on
        if crop_on == "auto":
            crop_on = ("device" if hh * ww <= 2 * self.crop_size ** 2
                       else "host")
        device = self.model.device
        if isinstance(frames_or_paths, np.ndarray):
            chunks = (frames_or_paths[s:s + self.ingest_chunk]
                      for s in range(0, n, self.ingest_chunk))
        elif hasattr(frames_or_paths, "image_hw"):
            chunks = iter(frames_or_paths)
        else:
            # image paths: chunk i+1 is decoded on the loader's worker while
            # chunk i is cropped; into pinned memory when the frames go to
            # the card
            chunks = iter(loader.PrefetchLoader(
                frames_or_paths, chunk=self.ingest_chunk,
                pin=crop_on == "device" and device.type == "cuda"))
        # a reader with reuse_buffers=True hands out views that its next
        # chunk rewrites: both crops have read a chunk before the next is
        # decoded (the upload to the card copies it into pinned memory at
        # once, and the CPU crop gathers it into new tensors)
        s = 0
        for chunk in chunks:
            e = s + len(chunk)
            with span("runner/crop", frames=e - s):
                if crop_on == "host":
                    out = self._host_crop(chunk, bboxes[s:e], scale)
                    if not self.takes_uint8:
                        out = crop_mod.normalize_image(upload(out, device))
                else:
                    out = crop_mod.crop_and_normalize(
                        chunk, bboxes[s:e], scale=scale,
                        crop_size=self.crop_size, device=device)
            yield out
            s = e
        if s != n:
            raise FrameCountError(f"{s} frames for {n} bboxes")

    def _host_crop(self, chunk: np.ndarray, bboxes: np.ndarray,
                   scale: float) -> np.ndarray:
        """cv2 warpAffine crops (uint8), the reference's host preprocessing."""
        cs = self.crop_size
        out = np.empty((len(chunk), cs, cs, 3), np.uint8)
        for i, bb in enumerate(bboxes):
            out[i], _ = crop_mod.generate_patch_image(
                chunk[i], bb[0], bb[1], bb[2], bb[3], cs, cs, scale=scale)
        return out

    def crop_track(self, frames_or_paths, bboxes: np.ndarray,
                   scale: Optional[float] = None) -> torch.Tensor:
        """Frames + per-frame square bboxes -> normalized NHWC crops on the
        model's device."""
        return torch.cat(list(self._crop_stream(frames_or_paths, bboxes,
                                                scale)))

    # -- full track ----------------------------------------------------------

    def run_track(self, frames_or_paths, bboxes: np.ndarray,
                  scale: Optional[float] = None) -> dict:
        """The reference demo's model loop for one track.

        Returns numpy {'pred_cam' (N,3), 'verts' (N,6890,3), 'pose' (N,72),
        'betas' (N,10), 'joints3d' (N,J,3), 'joints2d' (N,J,2) normalized
        crop coords}, and with the gait branch 'pred_avg' (3,) and
        'pred_phase' (N,4); the branch gets each frame's bbox and the
        image centre."""
        with span("runner/track", parent=next(self._track_ids),
                  frames=len(bboxes)):
            bb = ci = None
            if self.model.module.use_gait_feat:
                h, w = self._frame_hw(frames_or_paths)
                bb = np.asarray(bboxes, np.float32)
                ci = np.full((len(bb), 2), [w * 0.5, h * 0.5], np.float32)
            out = self._forward_stream(
                self._crop_stream(frames_or_paths, bboxes, scale),
                bbox=bb, cimg=ci)
            return track_outputs(out)


class FrameCountError(ValueError):
    """A track's frame source gave another number of frames than it has
    bboxes (a video whose decode ends before its reported frame count)."""


_TRACK_KEYS = (("verts", "verts"), ("kp_3d", "joints3d"),
               ("kp_2d", "joints2d")) + tuple((k, k) for k in GAIT_KEYS)


def track_outputs(out: dict) -> dict:
    """Forward outputs (theta, verts, kp_3d, ...) -> run_track's keys, for
    the keys that were fetched."""
    res = {}
    if "theta" in out:
        res.update(pred_cam=out["theta"][:, :3], pose=out["theta"][:, 3:75],
                   betas=out["theta"][:, 75:])
    res.update({dst: out[src] for src, dst in _TRACK_KEYS if src in out})
    return res


def _pad_rows(rows: torch.Tensor, b: int) -> torch.Tensor:
    """rows padded to b by repeating the last one."""
    if len(rows) == b:
        return rows
    return torch.cat([rows, rows[-1:].expand((b - len(rows),)
                                             + tuple(rows.shape[1:]))])


class ForwardStream:
    """Incremental bucketed-forward session (GRNetRunner.open_stream).

    feed() takes crop chunks, as host uint8 crops (normalized on the
    device) or as normalized float crops (host or device), and for the gait
    branch the aligned bbox/cimg rows. Whenever a largest bucket has
    gathered, its forward goes to one worker thread, which copies the host
    chunks to the device (`device.upload`: pinned, asynchronous), normalizes
    and launches; feed() launches nothing. A forward launches a few
    thousand kernels, more than the card's launch queue holds, so the
    launching thread waits for the card through most of each forward: on
    the worker, that wait overlaps the caller's host work (decode,
    detection, crops). A fed chunk is read by the worker later, so the
    caller must not write to it afterwards. finish() launches the tail,
    waits for the worker, reads the runner's `fetch` keys back once and
    merges; close() ends a session that will not finish. An error of a
    forward raises at the next feed() or at finish(). With a mesh, the
    worker drives the replicas (GRNetRunner._dp_forward); with
    `parallel="pp"` the session keeps every chunk and hands the whole
    track to the pipeline in finish(), as gaitlab does."""

    def __init__(self, runner: GRNetRunner):
        self.runner = runner
        self.device = runner.model.device
        self.gait = runner.model.module.use_gait_feat
        self.pp = runner.parallel == "pp"
        self.max_b = 1 << 62 if self.pp else runner.buckets[-1]
        self._buf: list = []  # chunks (or their tails) not yet dispatched
        self._rows = {"bbox": [], "cimg": []}  # host rows not yet dispatched
        self._buffered = 0
        self._outs: list = []
        self._lengths: list = []
        self._err: list = []
        self._queue = None
        self._thread = None
        self._done = False

    def _to_device(self, chunk) -> torch.Tensor:
        x = upload(chunk, self.device)
        if x.dtype == torch.uint8 and not self.runner.takes_uint8:
            return crop_mod.normalize_image(x)
        return x

    def _work(self) -> None:
        """The worker: one forward per queued bucket, in order, until None;
        after an error it skips the rest."""
        while True:
            item = self._queue.get()
            if item is None:
                return
            if self._err:
                continue
            try:
                self._outs.append(self._forward(*item))
            except BaseException as e:  # raised at the next feed/finish
                self._err.append(e)

    def _forward(self, pieces: list, rows: dict, parent=None) -> dict:
        """One bucket's forward from its chunk slices and host rows, in a
        span of the track `parent` (the caller's, passed in the queue)."""
        m = sum(len(p) for p in pieces)
        with span("stream/forward", parent=parent,
                  rows=self.runner._bucket(m), frames=m):
            crops = torch.cat([self._to_device(p) for p in pieces])
            rows = {k: upload(v, self.device) for k, v in rows.items()}
            return self.runner._forward_bucket(crops, **rows)

    def _check_err(self) -> None:
        if self._err:
            raise self._err[0]

    def _take(self, m: int) -> list:
        """The first m buffered frames, as slices of the fed chunks."""
        pieces, n = [], 0
        while n < m:
            chunk = self._buf.pop(0)
            k = min(len(chunk), m - n)
            pieces.append(chunk[:k])
            if k < len(chunk):
                self._buf.insert(0, chunk[k:])
            n += k
        self._buffered -= m
        return pieces

    def _take_rows(self, m: int) -> dict:
        """The next m bbox and cimg rows (host)."""
        rows = {}
        for k, bufs in self._rows.items():
            cat = np.concatenate(bufs) if bufs else np.zeros((0, 0), np.float32)
            if len(cat) < m:
                raise ValueError(f"the gait branch needs a bbox/cimg row for "
                                 f"each of {m} frames, got {len(cat)} {k}")
            self._rows[k] = [cat[m:]] if len(cat) > m else []
            rows[k] = cat[:m]
        return rows

    def _dispatch(self, m: int) -> None:
        self._check_err()
        rows = self._take_rows(m) if self.gait else {}
        if self._thread is None:
            self._queue = queue.Queue(maxsize=2)
            self._thread = threading.Thread(target=self._work, daemon=True)
            self._thread.start()
        item = (self._take(m), rows, span_parent())
        with span("stream/wait"):  # while the queue is full
            self._queue.put(item)
        self._lengths.append(m)

    def feed(self, chunk, bbox=None, cimg=None) -> None:
        """Add a crop chunk (and, for the gait branch, its rows)."""
        if self._done:
            raise RuntimeError("feed() after finish()")
        self._check_err()
        self._buf.append(chunk)
        self._buffered += chunk.shape[0]
        for k, rows in (("bbox", bbox), ("cimg", cimg)):
            if rows is not None:
                self._rows[k].append(np.asarray(rows, np.float32))
        while self._buffered >= self.max_b:
            self._dispatch(self.max_b)

    def _join(self) -> None:
        if self._thread is not None:
            with span("stream/wait"):
                self._queue.put(None)
                self._thread.join()
            self._thread = None

    def close(self) -> None:
        """End the session without the tail or a read-back: wait for the
        queued forwards and drop their outputs. A forward's error raises
        here."""
        self._done = True
        self._join()
        self._outs = []
        self._check_err()

    def finish(self) -> dict:
        """Launch the tail, wait for the worker, read the fetched outputs
        back once, merge them."""
        if self._done:
            raise RuntimeError("finish() called twice")
        self._done = True
        if self.pp:
            if not self._buffered:
                return {}
            return self.runner._pp_forward(torch.cat(
                [self._to_device(c) for c in self._take(self._buffered)]))
        if self._buffered:
            self._dispatch(self._buffered)
        self._join()
        self._check_err()
        if not self._outs:  # no frame fed
            return {}
        fetch = self.runner.fetch
        want = None if fetch is None else set(fetch) | set(GAIT_KEYS)
        with span("stream/readback") as sp:
            fetched = [{k: v.cpu().numpy() for k, v in out.items()
                        if want is None or k in want} for out in self._outs]
            self._outs = []
            if sp and self.device.type != "cpu":
                sp.add(d2h_bytes=sum(a.nbytes for o in fetched
                                     for a in o.values()))
            merged = {}
            for k in fetched[0]:
                if k == "pred_avg":
                    # a track-level estimate per forward, weighted by its
                    # real frames (the tail forward may be mostly padding)
                    merged[k] = np.average([o[k][0] for o in fetched],
                                           axis=0, weights=self._lengths)
                else:
                    merged[k] = np.concatenate([o[k] for o in fetched])
        return merged
