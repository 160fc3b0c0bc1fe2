"""The toy's step counts: its trunk's products from the configuration's
sizes, SMPL's from counts/smpl.py."""

from __future__ import annotations

from benchmark.counts.smpl import SMPL_JOINTS, b2_work, smpl_products


class ToyCounts:
    def __init__(self, cfg: dict, sd: dict):
        m, s = cfg["model"], cfg["smpl"]
        width, mlp, patch = m["width"], m["mlp"], m["patch"]
        tokens = (cfg["crop_size"] // patch) ** 2
        out = sd["head.weight"].shape[0]
        self.trunk = (2 * tokens * width * 3 * patch * patch
                      + 2 * 2 * tokens * width * mlp + 2 * width * out)
        self.verts, self.betas = s["num_verts"], s["num_betas"]
        self.pose = 9 * (SMPL_JOINTS - 1)

    def forward_flops(self, real: int) -> float:
        return real * (self.trunk + self.b2(1)[0]
                       + smpl_products(1, self.verts, self.betas))

    def b2(self, rows: int) -> tuple:
        return b2_work(rows, self.verts, self.betas, self.pose)
