"""Gait-corrector qualification under clinical-pipeline corruption, for
the PyTorch port, on one NVIDIA card.

The port's counterpart of scripts/gait_robustness.py (which stays as it
is), with the same study: the port's FeatCorrector (nn/gait.py; 6
joints, 8 channels, h_size 32, 2 heads, gait estimates trained through
the correction) is trained like tests/test_gait_training.py trains
gaitlab's (training.make_gait_train_step with w_feat 3, Adam at 3e-3,
batches of 8 from training.synthetic_gait_batch, TRAIN_STEPS steps),
then evaluated on held-out sequences under three corruption models,
trained against the untrained init at each level:

  * dropout(p): each frame is, with probability p, replaced by the last
    frame's features (a tracker coasting through an occlusion repeats
    its last crop; runs of repeats happen by chaining);
  * jitter(s): per-frame global gain/offset noise, features *
    (1 + s*n_t) + s*m_t with n_t, m_t ~ N(0,1) shared across the joints
    and channels of frame t (bbox jitter reframes the whole crop);
  * truncate(T): the sequence cut to its first T frames (SORT
    fragmentation), through the module's seq_lengths masking.

Then the transfer study: a fresh corrector from the same init, trained
only on a narrow regime A, evaluated on disjoint regimes (a non-
overlapping gait-frequency band, then also 2.5x camera sway and 1.6x
feature noise, disjoint seed families).

Its numbers differ from gaitlab's docs/GAIT_ROBUSTNESS.json (another
initialisation, cuDNN's GRU); what must hold is gaitlab's qualitative
envelope (tests/test_gait_training.py::test_robustness_artifact), which
tests/test_torch_scripts.py checks on this script's committed output.

    python3 scripts/torch_gait_robustness.py               # on the card
    python3 scripts/torch_gait_robustness.py --device cpu --steps 30

Writes docs/TORCH_GAIT_ROBUSTNESS.json (or --out) with the card's name
and power limit. Without --device cpu, a box without CUDA raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import os.path as osp
import sys
import time

import numpy as np

from torch_precision_study import REPO
from torch_stage_timing import SEED, card

T, J, C = 32, 6, 8
TRAIN_STEPS = 600
LR = 3e-3
OUT = osp.join(REPO, "docs", "TORCH_GAIT_ROBUSTNESS.json")
REGIME_A = dict(freq_range=(0.05, 0.14), cam_sway=0.08, noise=0.5)
REGIME_B = dict(freq_range=(0.16, 0.28), cam_sway=0.2, noise=0.8)
REGIME_B_FREQ_ONLY = dict(freq_range=(0.16, 0.28), cam_sway=0.08, noise=0.5)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def corrupt_dropout(feats: np.ndarray, p: float, rng) -> np.ndarray:
    """Occlusion model: frame t keeps frame t-1's features with prob p."""
    out = feats.copy()
    b, t = feats.shape[:2]
    drop = rng.random((b, t)) < p
    drop[:, 0] = False
    for i in range(1, t):
        out[drop[:, i], i] = out[drop[:, i], i - 1]
    return out


def corrupt_jitter(feats: np.ndarray, s: float, rng) -> np.ndarray:
    """Bbox-jitter model: per-frame global gain/offset (crop reframing
    moves every feature of the frame together)."""
    b, t = feats.shape[:2]
    gain = 1.0 + s * rng.standard_normal((b, t, 1, 1))
    off = s * rng.standard_normal((b, t, 1, 1))
    return feats * gain + off


def make_corrector(device, seed: int = SEED):
    """The study's FeatCorrector, initialised from `seed`, on `device`."""
    import torch

    from gaitlab_torch.nn.gait import FeatCorrector

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = FeatCorrector(num_joints=J, feat_dim=C, h_size=32,
                               num_heads=2, stop_gaitfeat_grad=False)
    return module.to(device)


def train(module, steps: int, device, **regime) -> None:
    """`steps` Adam steps of the gait trainer on fresh synthetic batches
    of 8 (seeds 0, 1, ...) from `regime`."""
    import torch

    from gaitlab_torch import training

    step = training.make_gait_train_step(
        module, torch.optim.Adam(module.parameters(), lr=LR), w_feat=3.0)
    for i in range(steps):
        batch = training.synthetic_gait_batch(8, t=T, j=J, c=C, seed=i,
                                              **regime)
        step({k: torch.from_numpy(v).to(device) for k, v in batch.items()})


def metrics(module, feats, cparams, batch, seq_lengths=None
            ) -> tuple[float, float]:
    """(phase error, speed MAE) of the corrector's estimates: phase error
    is 1 - the mean cosine of both phase 2-vectors to the true ones (0 =
    perfect, 1 = uncorrelated), over the first max(seq_lengths) frames;
    speed MAE is |pred_avg[:, 0] - gait_avg[:, 0]|'s mean."""
    import torch

    from gaitlab_torch.device import float32_math

    dev = next(module.parameters()).device
    with torch.no_grad(), float32_math():
        _, pred_avg, pred_phase = module(
            torch.as_tensor(feats, dtype=torch.float32, device=dev),
            torch.as_tensor(cparams, dtype=torch.float32, device=dev),
            None if seq_lengths is None
            else torch.as_tensor(seq_lengths, device=dev))
    pp = pred_phase.cpu().numpy()
    gp = np.asarray(batch["gait_phase"])
    if seq_lengths is not None:
        tt = int(np.max(seq_lengths))
        pp, gp = pp[:, :tt], gp[:, :tt]

    def nrm(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-9)

    cos = 0.5 * ((nrm(pp[..., :2]) * nrm(gp[..., :2])).sum(-1)
                 + (nrm(pp[..., 2:]) * nrm(gp[..., 2:])).sum(-1))
    speed = np.abs(pred_avg.cpu().numpy()[:, 0]
                   - np.asarray(batch["gait_avg"])[:, 0]).mean()
    return float(1.0 - cos.mean()), float(speed)


def cell(trained, untrained, feats, batch, seq_lengths=None, **key) -> dict:
    """One row: both correctors' metrics on the same inputs."""
    cp = np.asarray(batch["cparams"])
    pe_t, sp_t = metrics(trained, feats, cp, batch, seq_lengths)
    pe_0, sp_0 = metrics(untrained, feats, cp, batch, seq_lengths)
    row = {**key, "phase_err_trained": pe_t, "phase_err_untrained": pe_0,
           "speed_mae_trained": sp_t, "speed_mae_untrained": sp_0,
           "trained_beats_untrained": bool(pe_t < pe_0 and sp_t < sp_0)}
    log(f"[gait_robustness] {key}: phase {pe_t:.4f} (untrained {pe_0:.4f}) "
        f"speed {sp_t:.4f} (untrained {sp_0:.4f})")
    return row


def corruption_rows(trained, untrained) -> list:
    """The corruption sweep on held-out batches, a fresh corruption RNG
    per cell (gaitlab's seeds)."""
    from gaitlab_torch import training

    rows = []
    for p in (0.0, 0.1, 0.2, 0.4):
        batch = training.synthetic_gait_batch(16, t=T, j=J, c=C, seed=1000)
        feats = corrupt_dropout(batch["features"], p,
                                np.random.default_rng(7))
        rows.append(cell(trained, untrained, feats, batch,
                         corruption="dropout", level=p))
    for s in (0.1, 0.2, 0.4):
        batch = training.synthetic_gait_batch(16, t=T, j=J, c=C, seed=1001)
        feats = corrupt_jitter(batch["features"], s,
                               np.random.default_rng(8))
        rows.append(cell(trained, untrained, feats, batch,
                         corruption="bbox_jitter", level=s))
    for tt in (24, 16, 12):
        batch = training.synthetic_gait_batch(16, t=T, j=J, c=C, seed=1002)
        feats = batch["features"].copy()
        feats[:, tt:] = 0.0  # masked region content must not matter
        rows.append(cell(trained, untrained, feats, batch,
                         np.full((16,), tt, np.int64),
                         corruption="truncate", level=tt))
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    from gaitlab_torch import training
    from gaitlab_torch.device import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    untrained = make_corrector(dev)
    trained = copy.deepcopy(untrained)
    t0 = time.perf_counter()
    train(trained, args.steps, dev)
    train_s = time.perf_counter() - t0
    log(f"[gait_robustness] {args.steps} steps in {train_s:.1f} s")
    rows = corruption_rows(trained, untrained)

    transfer = copy.deepcopy(untrained)
    train(transfer, args.steps, dev, **REGIME_A)
    transfer_rows = []
    for name, regime, seed in (
            ("in_regime_holdout", REGIME_A, 4000),
            ("shifted_freq_band", REGIME_B_FREQ_ONLY, 5000),
            ("shifted_freq_cam_noise", REGIME_B, 6000)):
        batch = training.synthetic_gait_batch(16, t=T, j=J, c=C, seed=seed,
                                              **regime)
        transfer_rows.append(cell(transfer, untrained, batch["features"],
                                  batch, cell=name, regime=regime))

    out = {
        "script": "scripts/torch_gait_robustness.py",
        "card": card() if on_card else None,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "torch": torch.__version__,
        "what": ("the port's FeatCorrector phase/speed error under "
                 "clinical-pipeline corruption models, trained (clean "
                 "synthetic regime) vs untrained init"),
        "setup": {"t": T, "j": J, "c": C, "train_steps": args.steps,
                  "lr": LR, "base_feature_noise": 0.5},
        "train_s": train_s,
        "phase_err_metric": "1 - mean cosine to the true phase circle "
                            "(0 = perfect, 1 = uncorrelated)",
        "results": rows,
        "transfer": {
            "what": ("a fresh corrector trained only on regime A, "
                     "evaluated on disjoint regimes (non-overlapping "
                     "gait-frequency band, 2.5x camera sway, 1.6x feature "
                     "noise, disjoint seed families)"),
            "train_regime": REGIME_A,
            "results": transfer_rows,
        },
    }
    os.makedirs(osp.dirname(osp.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
