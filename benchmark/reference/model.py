"""GRNet in plain PyTorch, float32: the HRNet-W32 pose backbone with its
upsampling head (Sun et al., CVPR 2019; the PARE variant's
`upsample_stage_*` head), the PARE part-attention head (Kocabas et al.,
ICCV 2021) and, for MAX-GRNet, the gait-feature corrector (a
bidirectional GRU gait encoder and a temporal-spatial attention block),
written as functions of a state dict whose keys are the published
modules' names.

`Reference(sd, cfg)` runs it. The architecture comes from the
configuration (`cfg["model"]`: widths, modules, blocks, joints, the
corrector's sizes), the numbers from `sd`. With `calibrate=True` every
BatchNorm normalises by its input's own batch statistics and writes them
into `sd` as its running statistics: how the benchmark gives random
weights BatchNorm statistics that keep the network's output dependent on
its input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-6
LEAKY_SLOPE = 0.05


class Reference:
    def __init__(self, sd: dict, cfg: dict, calibrate: bool = False):
        self.sd = sd
        self.m = cfg["model"]
        self.calibrate = calibrate

    # -- building blocks ----------------------------------------------------

    def conv(self, x, p: str, stride: int = 1):
        w = self.sd[p + ".weight"]
        return F.conv2d(x, w, self.sd.get(p + ".bias"), stride,
                        (w.shape[-1] - 1) // 2)

    def bn(self, x, p: str):
        if self.calibrate:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            self.sd[p + ".running_mean"].copy_(mean)
            self.sd[p + ".running_var"].copy_(var)
        sd = self.sd
        scale = sd[p + ".weight"] / torch.sqrt(sd[p + ".running_var"] + BN_EPS)
        shift = sd[p + ".bias"] - sd[p + ".running_mean"] * scale
        return x * scale[:, None, None] + shift[:, None, None]

    def cbr(self, x, conv: str, bn: str, stride: int = 1, relu: bool = True):
        y = self.bn(self.conv(x, conv, stride), bn)
        return F.relu(y) if relu else y

    def linear(self, x, p: str):
        return F.linear(x, self.sd[p + ".weight"], self.sd.get(p + ".bias"))

    # -- HRNet ----------------------------------------------------------------

    def bottleneck(self, x, p: str):
        res = x
        if p + ".downsample.0.weight" in self.sd:
            res = self.cbr(x, p + ".downsample.0", p + ".downsample.1",
                           relu=False)
        y = self.cbr(x, p + ".conv1", p + ".bn1")
        y = self.cbr(y, p + ".conv2", p + ".bn2")
        y = self.cbr(y, p + ".conv3", p + ".bn3", relu=False)
        return F.relu(y + res)

    def basic(self, x, p: str):
        res = x
        if p + ".downsample.0.weight" in self.sd:
            res = self.cbr(x, p + ".downsample.0", p + ".downsample.1",
                           relu=False)
        y = self.cbr(x, p + ".conv1", p + ".bn1")
        y = self.cbr(y, p + ".conv2", p + ".bn2", relu=False)
        return F.relu(y + res)

    def transition(self, xs: list, p: str, n_out: int) -> list:
        out = []
        for i in range(n_out):
            if i < len(xs):
                out.append(self.cbr(xs[i], f"{p}.{i}.0", f"{p}.{i}.1")
                           if f"{p}.{i}.0.weight" in self.sd else xs[i])
                continue
            y = xs[-1]
            for j in range(i + 1 - len(xs)):  # stride-2 steps
                y = self.cbr(y, f"{p}.{i}.{j}.0", f"{p}.{i}.{j}.1", 2)
            out.append(y)
        return out

    def hr_module(self, xs: list, p: str) -> list:
        n, blocks = len(xs), self.m["backbone_blocks"]
        outs = []
        for i, x in enumerate(xs):
            for b in range(blocks):
                x = self.basic(x, f"{p}.branches.{i}.{b}")
            outs.append(x)
        if n == 1:
            return outs
        fused = []
        for i in range(n):
            y = None
            for j in range(n):
                q = f"{p}.fuse_layers.{i}.{j}"
                if j == i:
                    z = outs[j]
                elif j > i:  # 1x1 conv, BN, nearest upsampling
                    z = F.interpolate(self.cbr(outs[j], q + ".0", q + ".1",
                                               relu=False),
                                      scale_factor=2 ** (j - i),
                                      mode="nearest")
                else:  # stride-2 3x3 steps, ReLU between them
                    z = outs[j]
                    for k in range(i - j):
                        z = self.cbr(z, f"{q}.{k}.0", f"{q}.{k}.1", 2,
                                     relu=k < i - j - 1)
                y = z if y is None else y + z
            fused.append(F.relu(y))
        return fused

    def backbone(self, x):
        """(N,3,224,224) -> (N, 15*width, 56, 56)."""
        p = "backbone"
        x = self.cbr(x, p + ".conv1", p + ".bn1", 2)
        x = self.cbr(x, p + ".conv2", p + ".bn2", 2)
        for i in range(4):
            x = self.bottleneck(x, f"{p}.layer1.{i}")
        xs = [x]
        for stage, n_mod in zip((2, 3, 4), self.m["backbone_modules"]):
            xs = self.transition(xs, f"{p}.transition{stage - 1}", stage)
            for k in range(n_mod):
                xs = self.hr_module(xs, f"{p}.stage{stage}.{k}")
        feats = [xs[0]]
        for i in (1, 2, 3):  # upsampling head: i x [bilinear x2, conv, BN, ReLU]
            y = xs[i]
            q = f"{p}.upsample_stage_{i + 1}"
            for r in range(i):
                y = F.interpolate(y, scale_factor=2, mode="bilinear",
                                  align_corners=True)
                y = self.cbr(y, f"{q}.{4 * r + 1}", f"{q}.{4 * r + 2}")
            feats.append(y)
        return torch.cat(feats, dim=1)

    # -- PARE head --------------------------------------------------------------

    def head_features(self, feats):
        """Backbone features -> (part features (N,J,C1), pooled cam/shape
        features (N,J,C2)): softmax attention of each part's logits over
        the H*W positions, pooling both feature maps."""
        p = "head"
        k = self.cbr(feats, p + ".keypoint_deconv_layers.0",
                     p + ".keypoint_deconv_layers.1")
        k = self.cbr(k, p + ".keypoint_deconv_layers.3",
                     p + ".keypoint_deconv_layers.4")
        logits = self.conv(k, p + ".keypoint_final_layer")[:, 1:]
        s = self.cbr(feats, p + ".smpl_deconv_layers.0",
                     p + ".smpl_deconv_layers.1")
        s = self.cbr(s, p + ".smpl_deconv_layers.3",
                     p + ".smpl_deconv_layers.4")
        cam = self.conv(s, p + ".smpl_final_layer")
        n, j = logits.shape[:2]
        attn = torch.softmax(logits.reshape(n, j, -1), dim=-1)  # (N,J,HW)
        pool = [torch.bmm(attn, f.reshape(n, f.shape[1], -1).transpose(1, 2))
                for f in (s, cam)]
        return pool[0], pool[1]

    def head_predict(self, point_feat, cam_feat):
        """Pooled features -> (rotations (N,J,3,3), betas (N,10), cam
        (N,3)). The pose MLP is per part (unshared weights); the shape and
        cam MLPs read the pooled cam features flattened channel-major."""
        n = point_feat.shape[0]
        w = self.sd["head.pose_mlp.weight"][0, :, :, :, 0, 0]  # (6,C,J)
        rot6d = torch.einsum("nji,oij->njo", point_feat, w)
        flat = cam_feat.transpose(1, 2).reshape(n, -1)
        return (rot6d_to_rotmat(rot6d), self.linear(flat, "head.shape_mlp"),
                self.linear(flat, "head.cam_mlp"))

    # -- gait-feature corrector ---------------------------------------------

    def gru_layer(self, x, p: str, sfx: str):
        """One direction of one GRU layer over (T, I) -> (T, H); the
        reverse direction runs over the frames backwards and its outputs
        come back in frame order. Gates r, z, n in that order of the
        weights' rows: r = s(W_ir x + b_ir + W_hr h + b_hr), z likewise,
        n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h = (1-z) n + z h."""
        sd = self.sd
        w_ih, w_hh = sd[f"{p}.weight_ih{sfx}"], sd[f"{p}.weight_hh{sfx}"]
        b_ih, b_hh = sd[f"{p}.bias_ih{sfx}"], sd[f"{p}.bias_hh{sfx}"]
        hsz = w_hh.shape[1]
        rev = sfx.endswith("_reverse")
        xs = (x.flip(0) if rev else x) @ w_ih.T + b_ih  # (T, 3H)
        h = x.new_zeros(hsz)
        outs = []
        for t in range(xs.shape[0]):
            gh = w_hh @ h + b_hh
            r = torch.sigmoid(xs[t, :hsz] + gh[:hsz])
            z = torch.sigmoid(xs[t, hsz:2 * hsz] + gh[hsz:2 * hsz])
            nn_ = torch.tanh(xs[t, 2 * hsz:] + r * gh[2 * hsz:])
            h = (1 - z) * nn_ + z * h
            outs.append(h)
        out = torch.stack(outs)
        return (out.flip(0) if rev else out), h

    def gait_encoder(self, x, cparams):
        """x (T,J,C) pose features, cparams (T,3) -> pred_avg (3,),
        pred_phase (T,4)."""
        p = "pfeat_corrector.featnet"
        t, j, c = x.shape
        xc = torch.einsum("tk,jko->tjo", cparams,
                          self.sd[p + ".cparam_mlp.weight"])
        seq = (x + xc).reshape(t, j * c)
        finals = []
        for layer in range(2):
            dirs = []
            for sfx in ("", "_reverse"):
                o, h = self.gru_layer(seq, p + ".rnn", f"_l{layer}{sfx}")
                dirs.append(o)
                finals.append(h)
            seq = torch.cat(dirs, dim=-1)
        h = torch.cat(finals)

        def mlp(v, a, b):
            return self.linear(F.leaky_relu(self.linear(v, a), LEAKY_SLOPE), b)

        pred_avg = torch.cat([mlp(h, p + ".speed_fc", p + ".speed_out"),
                              mlp(h, p + ".step_fc", p + ".step_out")])
        pred_phase = torch.tanh(mlp(seq, p + ".phase_fc", p + ".phase_out"))
        return pred_avg, pred_phase

    def mha(self, x, p: str, heads: int):
        """Self-attention over the middle axis of x (B, L, D): per-head
        projections with bias, the query scaled by 1/sqrt(head size),
        softmax over keys, output projection with bias."""
        b, n, _ = x.shape
        q, k, v = (self.linear(x, f"{p}.{s}").reshape(b, n, heads, -1)
                   for s in ("query", "key", "value"))
        q = q / math.sqrt(q.shape[-1])
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.linear(torch.einsum("bhqk,bkhd->bqhd", w, v)
                           .reshape(b, n, -1), p + ".out")

    def corrector(self, x, cparams):
        """x (T,J,C) part features of T real frames, cparams (T,3) ->
        (corrected (T,J,C), pred_avg (3,), pred_phase (T,4))."""
        p = "pfeat_corrector"
        heads = self.m["featcorr_num_heads"]
        t, j, c = x.shape
        pred_avg, pred_phase = self.gait_encoder(x, cparams)

        def unit(v):
            return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                        + 1e-12)

        raw = torch.cat([pred_avg.expand(t, -1), unit(pred_phase[:, :2]),
                         unit(pred_phase[:, 2:])], dim=-1)
        gtok = self.linear(F.leaky_relu(self.linear(raw, p + ".gfeat_fc"),
                                        LEAKY_SLOPE), p + ".gfeat_token")
        y = torch.cat([x, gtok[:, None]], dim=1)  # (T, J+1, C)
        for i in range(self.m["featcorr_num_layers"]):
            q = f"{p}.block{i}"
            nt = y.shape[1]
            x_t = self.mha(y.reshape(1, t, nt * c), q + ".mulattn.temporal",
                           heads)[0]
            x_s = self.mha(y, q + ".mulattn.spatial", heads).reshape(t, -1)
            mix = self.linear(torch.cat([x_t, x_s], -1).mean(0),
                              q + ".mulattn.ts_attn")
            alpha = torch.softmax(mix.reshape(nt * c, 2), dim=-1)
            att = (x_t * alpha[:, 0] + x_s * alpha[:, 1]).reshape(t, nt, c)
            y = self.layer_norm(y + att, q + ".norm1")
            if q + ".jwff1.weight" in self.sd:  # per-token feed-forward
                hid = F.gelu(self.token_linear(y, q + ".jwff1"),
                             approximate="tanh")
                ff = self.token_linear(hid, q + ".jwff2")
            else:
                ff = self.linear(F.gelu(self.linear(y, q + ".pwff1"),
                                        approximate="tanh"), q + ".pwff2")
            y = self.layer_norm(y + ff, q + ".norm2")
        return x + y[:, :j], pred_avg, pred_phase

    def token_linear(self, x, p: str):
        out = torch.einsum("tjc,jco->tjo", x, self.sd[p + ".weight"])
        return out + self.sd[p + ".bias"]

    def layer_norm(self, x, p: str):
        return F.layer_norm(x, x.shape[-1:], self.sd[p + ".weight"],
                            self.sd[p + ".bias"], LN_EPS)


def rot6d_to_rotmat(x):
    """(..., 6) as 3x2 columns -> Gram-Schmidt rotation (..., 3, 3), norms
    clamped at 1e-6."""
    x = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = x[..., 0], x[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-6)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-6)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2)], dim=-1)


def camera_reparam(cam, bbox, cimg):
    """Crop-frame weak-perspective camera (T,3) -> image-frame camera
    parameters (T,3) of the gait branch: [s * w / 224, (box centre - image
    centre) / (s * w / 224) / 112 + (tx, ty)]."""
    scale = bbox[:, 2:3] / 224.0 * cam[:, 0:1]
    return torch.cat([scale, (bbox[:, :2] - cimg) / scale / 112.0
                      + cam[:, 1:]], dim=-1)
