"""Person detection for the tracking front end.

Counterpart of gaitlab/pipeline/detect.py:
  * `Detector`: the protocol, frames (N,H,W,3) uint8 RGB -> a list of
    (K_i, 5) [x1,y1,x2,y2,score] arrays;
  * `YoloDetector`: YOLOv3 (full or tiny, gaitlab_torch.nn.yolo) on the
    card, weights from a darknet `.weights` file, filtered to the person
    class and NMS'd on the host;
  * `MedianBackgroundDetector`: for static cameras (the clinic's corridor
    walks), a temporal-median background, thresholded foreground,
    connected components and person-shaped boxes, on the host (cv2);
  * `DnnPersonDetector`: cv2.dnn over a user-supplied .onnx model;
  * `CallableDetector`: wraps any function into the protocol.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Protocol

import numpy as np
import torch

from gaitlab_torch.device import float32_math, resolve_device

# gaitlab's operating points (its constructor defaults)
SCORE_THRESHOLD = 0.4   # objectness x person score a box must reach
NMS_THRESHOLD = 0.45    # IoU above which the weaker box goes
BG_THRESHOLD = 25.0     # channel-max |frame - background| of foreground
BG_MIN_AREA_FRAC = 2e-3  # the smallest blob, as a share of the frame
BG_MODEL_FRAMES = 60    # frames the median is taken over
BG_MAX_PIXELS = 160_000  # detection subsamples frames to at most this


class Detector(Protocol):
    def __call__(self, frames: np.ndarray) -> List[np.ndarray]:
        """frames (N,H,W,3) uint8 RGB -> per-frame (K,5) xyxy+score."""
        ...


class CallableDetector:
    def __init__(self, fn: Callable[[np.ndarray], List[np.ndarray]]):
        self.fn = fn

    def __call__(self, frames: np.ndarray) -> List[np.ndarray]:
        return self.fn(frames)


def _connected_components_boxes(mask: np.ndarray, min_area: int) -> np.ndarray:
    """Foreground mask -> (K,5) xyxy+score via cv2 connected components."""
    import cv2

    mask_u8 = (mask.astype(np.uint8)) * 255
    mask_u8 = cv2.morphologyEx(
        mask_u8, cv2.MORPH_CLOSE, np.ones((9, 9), np.uint8))
    mask_u8 = cv2.morphologyEx(
        mask_u8, cv2.MORPH_OPEN, np.ones((3, 3), np.uint8))
    n, labels, stats, _ = cv2.connectedComponentsWithStats(mask_u8, 8)
    boxes = []
    for i in range(1, n):
        x, y, w, h, area = stats[i]
        if area < min_area:
            continue
        if h < 0.6 * w:  # reject very flat blobs (not person-shaped)
            continue
        score = min(1.0, area / (3.0 * min_area))
        boxes.append([x, y, x + w, y + h, score])
    return np.array(boxes, np.float32).reshape(-1, 5)


def _nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> list:
    """Greedy IoU NMS (host numpy). boxes (K,4) xyxy."""
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = ((boxes[rest, 2] - boxes[rest, 0])
                  * (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(area_i + area_r - inter, 1e-9)
        order = rest[iou <= iou_thr]
    return keep


def letterbox(frames: np.ndarray, size: int):
    """uint8 RGB (N,H,W,3) -> uint8 (N,size,size,3) + (scale, (left, top)):
    each frame resized to fit, centred on a border of 128 (mid-gray, the
    darknet convention)."""
    import cv2

    n, h, w = frames.shape[:3]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    top, left = (size - nh) // 2, (size - nw) // 2
    out = np.full((n, size, size, 3), 128, np.uint8)
    for i in range(n):
        r = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_LINEAR)
        out[i, top:top + nh, left:left + nw] = r
    return out, scale, (left, top)


class YoloDetector:
    """YOLOv3 person detector on the card (the CPU only with device="cpu").

    Frames are letterboxed on the host to a square uint8 input, uploaded,
    divided by 255 and run through the network in batches of `batch` in
    float32 with TF32 off; the person-class filter (objectness x person
    score >= SCORE_THRESHOLD) and NMS run on the host. Weights: a standard
    darknet file, full `yolov3.weights` or `yolov3-tiny.weights`, the
    variant told from its size unless given. `forwards` counts the
    network's batch forwards."""

    def __init__(self, weights_path: str, input_size: int = 416,
                 batch: int = 12, variant: Optional[str] = None,
                 device=None):
        from gaitlab_torch.nn import yolo

        self.variant = variant or yolo.infer_variant(weights_path)
        self.device = resolve_device(device)
        self.input_size = int(input_size)
        self.batch = int(batch)
        net = yolo.YoloV3() if self.variant == "v3" else yolo.YoloV3Tiny()
        yolo.load_darknet_weights(weights_path, net)
        self.net = net.to(self.device).eval()
        self.forwards = 0

    def predict(self, boxed: np.ndarray) -> torch.Tensor:
        """Letterboxed uint8 (N,S,S,3) -> decoded (N, K, 6) [cx, cy, w, h,
        obj, person] on the detector's device."""
        from gaitlab_torch.nn import yolo

        x = torch.from_numpy(boxed).to(self.device)
        with float32_math(), torch.inference_mode():
            x = x.permute(0, 3, 1, 2).float() / 255.0
            out = yolo.detect(self.net, x.contiguous())
        self.forwards += 1
        return out[..., :5 + 1 + yolo.PERSON_CLASS]

    def __call__(self, frames: np.ndarray) -> List[np.ndarray]:
        frames = np.asarray(frames)
        preds = []
        # BN runs in inference mode, so a short last batch gives each frame
        # what a padded one would: no padding to a fixed batch
        for s0 in range(0, len(frames), self.batch):
            boxed, scale, (left, top) = letterbox(
                frames[s0:s0 + self.batch], self.input_size)
            preds.extend(self.predict(boxed).cpu().numpy())

        out = []
        for p in preds:
            conf = p[:, 4] * p[:, 5]  # objectness * person score
            sel = conf >= SCORE_THRESHOLD
            if not np.any(sel):
                out.append(np.zeros((0, 5), np.float32))
                continue
            p, conf = p[sel], conf[sel]
            # letterbox -> original image coordinates
            cx = (p[:, 0] - left) / scale
            cy = (p[:, 1] - top) / scale
            bw, bh = p[:, 2] / scale, p[:, 3] / scale
            boxes = np.stack([cx - bw / 2, cy - bh / 2,
                              cx + bw / 2, cy + bh / 2], axis=1)
            keep = _nms(boxes, conf, NMS_THRESHOLD)
            out.append(np.concatenate(
                [boxes[keep], conf[keep, None]], axis=1).astype(np.float32))
        return out


# gaitlab's name for the detector with the tiny network (`get_detector`
# picks the network by name)
YoloTinyDetector = YoloDetector


class DnnPersonDetector:
    """Person detector over cv2.dnn for a user-supplied one-file model (a
    YOLO-layout .onnx), filtered to the person class (COCO id 0) and
    NMS'd. Darknet `.weights` files go to YoloDetector on the card."""

    def __init__(self, model_path: str, input_size: int = 416):
        import cv2

        self.net = cv2.dnn.readNet(model_path)
        self.input_size = input_size

    def _detect_one(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        h, w = frame.shape[:2]
        blob = cv2.dnn.blobFromImage(
            frame, 1.0 / 255.0, (self.input_size, self.input_size),
            swapRB=False, crop=False)
        self.net.setInput(blob)
        outs = self.net.forward(self.net.getUnconnectedOutLayersNames())
        boxes, scores = [], []
        for out in outs:
            out = out.reshape(-1, out.shape[-1])
            for row in out:  # YOLO layout: cx,cy,w,h,obj,cls...
                cls_scores = row[5:]
                if cls_scores.size and np.argmax(cls_scores) != 0:
                    continue
                conf = float(row[4] * (cls_scores[0] if cls_scores.size
                                       else 1.0))
                if conf < SCORE_THRESHOLD:
                    continue
                cx, cy, bw, bh = row[:4] * np.array([w, h, w, h])
                boxes.append([cx - bw / 2, cy - bh / 2, bw, bh])
                scores.append(conf)
        if not boxes:
            return np.zeros((0, 5), np.float32)
        idx = cv2.dnn.NMSBoxes(boxes, scores, SCORE_THRESHOLD, NMS_THRESHOLD)
        out = []
        for i in np.ravel(idx):
            x, y, bw, bh = boxes[i]
            out.append([x, y, x + bw, y + bh, scores[i]])
        return np.array(out, np.float32).reshape(-1, 5)

    def __call__(self, frames: np.ndarray) -> List[np.ndarray]:
        return [self._detect_one(f) for f in frames]


def get_detector(name: str = "median_bg", input_size: Optional[int] = None,
                 batch: Optional[int] = None, device=None) -> "Detector":
    """Detector factory for the CLI --detector flag.

    'yolo' runs YOLOv3 on `device` (default: the card) when a darknet file
    is found: $GAITLAB_YOLO_WEIGHTS, or `yolov3.weights` /
    `yolov3-tiny.weights` under the asset dir (the variant told from the
    file; 'yolo_tiny' / 'yolo_v3' force one and accept only their own
    file). Without one it takes a user-supplied cv2.dnn model from
    $GAITLAB_DETECTOR_MODEL, and without that it warns and uses the
    median-background detector: a choice of algorithm when no weights
    exist, not a fallback from the card. input_size / batch are
    --yolo_img_size / --tracker_batch_size for the neural detectors.
    'dnn' runs the $GAITLAB_DETECTOR_MODEL model."""
    from gaitlab_torch.pipeline import fetch

    size_kw = {"input_size": int(input_size)} if input_size else {}
    if name in ("yolo", "yolo_tiny", "yolo_v3"):
        # an explicit variant overrides the file size
        variant = {"yolo_tiny": "tiny", "yolo_v3": "v3"}.get(name)
        weights = os.environ.get("GAITLAB_YOLO_WEIGHTS")
        if not weights:
            # a forced variant only accepts its own file: the other
            # variant's weights would fail the import on their size
            fnames = {"tiny": ("yolov3-tiny.weights",),
                      "v3": ("yolov3.weights",)}.get(
                variant, ("yolov3.weights", "yolov3-tiny.weights"))
            for fname in fnames:
                try:
                    weights = fetch.resolve_asset(fname)
                    break
                except FileNotFoundError:
                    weights = None
        if weights:
            if batch:
                size_kw["batch"] = int(batch)
            return YoloDetector(weights, variant=variant, device=device,
                                **size_kw)
        model = os.environ.get("GAITLAB_DETECTOR_MODEL")
        if model:
            return DnnPersonDetector(model, **size_kw)
        print("WARNING: no YOLO weights found (set $GAITLAB_YOLO_WEIGHTS "
              "or place yolov3.weights / yolov3-tiny.weights in the asset "
              "dir); using the median-background detector.")
        return MedianBackgroundDetector()
    if name == "median_bg":
        return MedianBackgroundDetector()
    if name == "dnn":
        model = os.environ.get("GAITLAB_DETECTOR_MODEL")
        if not model:
            raise ValueError("--detector dnn needs $GAITLAB_DETECTOR_MODEL")
        return DnnPersonDetector(model, **size_kw)
    raise ValueError(f"unknown detector: {name}")


class MedianBackgroundDetector:
    """Static-camera person detector: median background + foreground blobs.

    Suited to fixed-camera gait recordings, not to general scenes: plug an
    external model in through CallableDetector for moving cameras.
    Detection runs on frames subsampled to at most BG_MAX_PIXELS (a 1080p
    frame by a stride of 4): localizing a person-sized blob needs no more;
    boxes are reported in original-image coordinates."""

    def __init__(self):
        self.background: Optional[np.ndarray] = None

    @staticmethod
    def _shrink(frames: np.ndarray):
        h, w = frames.shape[1:3]
        if h * w <= BG_MAX_PIXELS:
            return frames, (1.0, 1.0)
        step = int(np.ceil((h * w / BG_MAX_PIXELS) ** 0.5))
        small = frames[:, ::step, ::step]
        return small, (w / small.shape[2], h / small.shape[1])

    def fit(self, frames: np.ndarray) -> "MedianBackgroundDetector":
        """Build the background model from a frame sample once, so that a
        long video can then stream through __call__ chunk by chunk."""
        frames, _ = self._shrink(np.asarray(frames))
        n = frames.shape[0]
        idx = np.linspace(0, n - 1, min(n, BG_MODEL_FRAMES)).astype(int)
        med = np.median(frames[idx].astype(np.float32), axis=0)
        # a uint8 background keeps cv2.absdiff on uint8; the <= 0.5
        # rounding is far below the threshold
        self.background = np.clip(np.round(med), 0, 255).astype(np.uint8)
        return self

    def __call__(self, frames: np.ndarray) -> List[np.ndarray]:
        import cv2

        frames = np.asarray(frames)
        one_shot = self.background is None
        if one_shot:
            self.fit(frames)
        small, scale = self._shrink(frames)
        background = self.background
        if one_shot:
            self.background = None  # a one-shot call stays stateless
        n, h, w = small.shape[:3]
        min_area = int(BG_MIN_AREA_FRAC * h * w)
        out = []
        for i in range(n):
            diff = cv2.absdiff(np.ascontiguousarray(small[i]), background)
            c0, c1, c2 = cv2.split(diff)
            fg = cv2.max(cv2.max(c0, c1), c2) > BG_THRESHOLD
            boxes = _connected_components_boxes(fg, min_area)
            if scale != (1.0, 1.0) and len(boxes):
                boxes[:, 0] *= scale[0]
                boxes[:, 2] *= scale[0]
                boxes[:, 1] *= scale[1]
                boxes[:, 3] *= scale[1]
            out.append(boxes)
        return out
