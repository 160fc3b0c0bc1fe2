"""What the benchmark makes from `--seed`: the model's weights and SMPL's
tensors (on the device, from one torch.Generator, in a few large draws),
the pool of frames, and the schedule of tracks (lengths, boxes).

Every seed gets the same set of track lengths (a deck of quantiles of the
traffic's length distribution) in its own order, so that seeds change
which frames and boxes the work sees and not how much work there is."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

# draws of the random weights, by role
BN_WEIGHT_STD = 0.1
BIAS_STD = 0.02


def seed_int(seed: int) -> int:
    """A seed of any size as a non-negative 63-bit integer."""
    return int(seed) % (1 << 63)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """The generator of one stream of draws (weights, SMPL, frames) for
    `seed` on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(seed_int(seed * 7919 + stream))
    return g


def _fan_in(mod: nn.Module, pname: str, p: torch.Tensor) -> int:
    name = type(mod).__name__
    if name == "LocallyConnected2d":   # (1, O, I, J, 1, 1)
        return p.shape[2]
    if name == "LocallyConnected":     # (J, I, O)
        return p.shape[1]
    if isinstance(mod, nn.GRU):
        return mod.hidden_size
    return int(np.prod(p.shape[1:]))


def make_weights(core: nn.Module, seed: int, device, overrides: dict
                 ) -> dict:
    """A state dict for `core` (whose modules give the names, shapes and
    roles; it may live on the meta device) drawn on `device`: one normal
    draw for every tensor at once, then scaled by role. Convolutions He
    (std sqrt(2/fan_in)), linear and locally connected weights and GRUs
    std 1/sqrt(fan_in), norms' scales 1 + 0.1 z, biases 0.02 z, the GRU's
    b_hr and b_hz 0 (the published cell has none). BatchNorm statistics
    are 0 and 1 until `calibrate`. `overrides` maps a key to {"gain": g}
    (the std times g) and/or {"add": [..]} (added to the draw)."""
    entries = []
    for mname, mod in core.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            entries.append((f"{mname}.{pname}" if mname else pname, mod,
                            pname, p))
    total = sum(p.numel() for *_, p in entries)
    z = torch.randn(total, generator=generator(seed, device, 1),
                    device=device)
    sd, off = {}, 0
    for key, mod, pname, p in entries:
        v = z[off:off + p.numel()].view(p.shape)
        off += p.numel()
        if isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            v = (1 + BN_WEIGHT_STD * v) if pname == "weight" \
                else BIAS_STD * v * 5
        elif pname.startswith("bias"):
            v = BIAS_STD * v
            if pname.startswith("bias_hh"):
                v = v.clone()
                v[:2 * mod.hidden_size] = 0.0
        else:
            gain = math.sqrt(2.0) if isinstance(mod, nn.Conv2d) else 1.0
            v = v * (gain / math.sqrt(_fan_in(mod, pname, p)))
        o = overrides.get(key, {})
        v = v * o.get("gain", 1.0)
        if "add" in o:
            v = v + torch.tensor(o["add"], device=device).view(p.shape)
        sd[key] = v.contiguous()
    for mname, mod in core.named_modules():
        if isinstance(mod, nn.BatchNorm2d):
            c = mod.num_features
            sd[f"{mname}.running_mean"] = torch.zeros(c, device=device)
            sd[f"{mname}.running_var"] = torch.ones(c, device=device)
            sd[f"{mname}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
    return sd


def make_smpl(seed: int, device, verts: int = 6890, betas: int = 10,
              joints: int = 24, extra: int = 9) -> dict:
    """Synthetic SMPL tensors at SMPL's sizes (there is no SMPL model file
    in the repository): a template, shape and pose directions, joint and
    extra-joint regressors and skinning weights with rows that sum to 1."""
    g = generator(seed, device, 2)

    def rows(shape, power):
        r = torch.rand(shape, generator=g, device=device) ** power
        return r / r.sum(-1, keepdim=True)

    return {
        "v_template": 0.3 * torch.randn((verts, 3), generator=g,
                                        device=device),
        "shapedirs": 0.01 * torch.randn((verts, 3, betas), generator=g,
                                        device=device),
        "posedirs": 0.001 * torch.randn((9 * (joints - 1), verts * 3),
                                        generator=g, device=device),
        "J_regressor": rows((joints, verts), 8),
        "lbs_weights": rows((verts, joints), 4),
        "J_regressor_extra": rows((extra, verts), 8),
    }


def make_pool(seed: int, device, n: int, hw: tuple) -> np.ndarray:
    """n frames (n, H, W, 3) uint8 on the host: smooth colour fields at
    several scales plus pixel noise, drawn on `device`."""
    g = generator(seed, device, 3)
    h, w = hw
    img = torch.zeros((n, 3, h, w), device=device)
    for div, amp in ((64, 60.0), (16, 40.0), (4, 20.0)):
        low = torch.randn((n, 3, -(-h // div), -(-w // div)), generator=g,
                          device=device)
        img += amp * torch.nn.functional.interpolate(
            low, size=(h, w), mode="bilinear", align_corners=False)
    img += 8.0 * torch.randn((n, 3, h, w), generator=g, device=device)
    img = (img + 128.0).clamp(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def deck(length: dict) -> list:
    """The traffic's track lengths: `deck` quantiles of its distribution
    ("log_uniform" or "uniform" over [min, max])."""
    lo, hi, k = length["min"], length["max"], length["deck"]
    qs = [(i + 0.5) / k for i in range(k)]
    if length["dist"] == "log_uniform":
        vals = [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                for q in qs]
    elif length["dist"] == "uniform":
        vals = [lo + q * (hi - lo) for q in qs]
    else:
        raise ValueError(f"length distribution {length['dist']!r}")
    return [int(round(v)) for v in vals]


class Track:
    """One track: its frames, as chunks of views into the pool, and its
    per-frame square boxes [cx, cy, w, h]."""

    def __init__(self, index: int, pool: np.ndarray, start: int,
                 boxes: np.ndarray, chunk: int):
        self.index = index
        self.pool, self.start, self.chunk = pool, start, chunk
        self.boxes = boxes
        self.image_hw = tuple(pool.shape[1:3])

    def __len__(self) -> int:
        return len(self.boxes)

    def _slot(self, k: int) -> int:
        span = len(self.pool) - self.chunk + 1
        return (self.start + k * self.chunk) % span

    def __iter__(self):
        """The frames as (m, H, W, 3) uint8 chunks, views of the pool (a
        video reader's chunks, decoded already)."""
        n = len(self)
        for k, s in enumerate(range(0, n, self.chunk)):
            a = self._slot(k)
            yield self.pool[a:a + min(self.chunk, n - s)]

    def frames(self) -> list:
        """The frames one by one, as the reference reads them."""
        return [f for c in self for f in c]


class Schedule:
    """The cell's tracks in order for `seed`: lengths from the deck,
    shuffled deck by deck; each track a walker crossing the frame.
    `extra(n)` makes a track of n frames outside the order (warm-up)."""

    def __init__(self, traffic: dict, seed: int, pool: np.ndarray,
                 chunk: int):
        self.rng_len = np.random.default_rng([seed_int(seed), 1])
        self.rng = np.random.default_rng([seed_int(seed), 2])
        self.traffic, self.pool, self.chunk = traffic, pool, chunk
        self.deck = deck(traffic["length"])
        self._lengths: list = []
        self._tracks: list = []

    def length(self, i: int) -> int:
        while len(self._lengths) <= i:
            self._lengths += [self.deck[j]
                              for j in self.rng_len.permutation(len(self.deck))]
        return self._lengths[i]

    def __getitem__(self, i: int) -> Track:
        while len(self._tracks) <= i:
            self._tracks.append(self._make(len(self._tracks)))
        return self._tracks[i]

    def extra(self, n: int) -> Track:
        return self._make(-1, n)

    def _make(self, i: int, n: int | None = None) -> Track:
        n = self.length(i) if n is None else n
        wk = self.traffic["walker"]
        h, w = self.pool.shape[1:3]
        r = self.rng
        side = h * r.uniform(*wk["box_frac"])
        x0, x1 = w * r.uniform(*wk["x_start"]), w * r.uniform(*wk["x_end"])
        if r.random() < 0.5:
            x0, x1 = x1, x0
        cy = h * (0.5 + r.uniform(-wk["y_jitter"], wk["y_jitter"]))
        t = np.arange(n) / max(n - 1, 1)
        steps = 2 * math.pi * n / wk["stride_frames"]
        cx = x0 + (x1 - x0) * t
        bob = wk["bob"] * side * np.sin(steps * t + r.uniform(0, 2 * math.pi))
        boxes = np.stack([cx, cy + bob, np.full(n, side), np.full(n, side)],
                         axis=1).astype(np.float32)
        start = int(r.integers(0, len(self.pool)))
        return Track(i, self.pool, start, boxes, self.chunk)


def buckets_used(traffic: dict, buckets: list) -> list:
    """The forward sizes the traffic's tracks run at: a track of L frames
    runs L // max forwards at the largest bucket and its remainder at the
    smallest bucket that holds it."""
    length = traffic["length"]
    top = max(buckets)
    used = set()
    for n in range(length["min"], length["max"] + 1):
        if n >= top:
            used.add(top)
        if n % top:
            used.add(min(b for b in buckets if b >= n % top))
    return sorted(used)
