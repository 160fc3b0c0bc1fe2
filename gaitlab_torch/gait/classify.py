"""Dementia scoring from gait features.

Counterpart of gaitlab/gait/classify.py: `DementiaScorer`, a small MLP
over the gait_features vector that gives class logits (default 3: normal /
MCI-like / dementia-like gait) and a severity in [0, 1]; `fit`
(full-batch Adam, for the small clinical cohorts this is used with), and
`predict` and `score_clip` with a fitted scorer. A scorer fitted by
gaitlab is carried over with `scorer_from_flax`.

Validation status, as in gaitlab: no clinical data exists here, so the
scorer has been exercised only on separable synthetic feature
distributions; nothing has been validated against patient outcomes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from gaitlab_torch.device import float32_math, resolve_device
from gaitlab_torch.gait.features import FEATURE_NAMES

LAYERS = ("fc1", "fc2", "cls", "severity")


class DementiaScorer(nn.Module):
    def __init__(self, num_classes: int = 3, hidden: int = 32,
                 num_features: int = len(FEATURE_NAMES)):
        super().__init__()
        self.fc1 = nn.Linear(num_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.cls = nn.Linear(hidden, num_classes)
        self.severity = nn.Linear(hidden, 1)

    def forward(self, x: torch.Tensor):
        h = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return self.cls(h), torch.sigmoid(self.severity(h))[..., 0]


class FittedScorer(NamedTuple):
    params: dict          # DementiaScorer state_dict, on its device
    mean: np.ndarray
    std: np.ndarray
    num_classes: int


def scorer_from_flax(fitted, device=None) -> FittedScorer:
    """gaitlab's FittedScorer (flax params as numpy) -> the port's, with
    the parameters on `device` (default: the card)."""
    device = resolve_device(device)
    params = {}
    for name in LAYERS:
        leaf = fitted.params["params"][name]
        params[f"{name}.weight"] = torch.tensor(
            np.asarray(leaf["kernel"], np.float32).T, device=device)
        params[f"{name}.bias"] = torch.tensor(
            np.asarray(leaf["bias"], np.float32), device=device)
    return FittedScorer(params=params, mean=np.asarray(fitted.mean),
                        std=np.asarray(fitted.std),
                        num_classes=int(fitted.num_classes))


def init_state(num_classes: int, num_features: int, seed: int,
               device) -> dict:
    """The state_dict `fit` starts from: torch's init of DementiaScorer
    under `seed`. (gaitlab's starts from a Flax init, which other
    random numbers make; a test swaps this function for one that carries
    that init over.)"""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = DementiaScorer(num_classes, num_features=num_features)
    return {k: v.to(device) for k, v in model.state_dict().items()}


def fit(features: np.ndarray, labels: np.ndarray,
        severity: Optional[np.ndarray] = None, num_classes: int = 3,
        steps: int = 500, lr: float = 1e-2, seed: int = 0,
        device=None) -> FittedScorer:
    """Train on (N, F) feature vectors with int labels (and optional [0, 1]
    severity targets): full-batch Adam on cross-entropy plus the severity
    MSE, over features normalized by their mean and std. Runs on `device`
    (None: the card) in float32 with TF32 off."""
    device = resolve_device(device)
    x = np.asarray(features, np.float32)
    mean = x.mean(0)
    std = x.std(0) + 1e-6
    xn = torch.from_numpy(((x - mean) / std).astype(np.float32)).to(device)
    y = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
    sev = None if severity is None else torch.from_numpy(
        np.asarray(severity, np.float32)).to(device)

    model = DementiaScorer(num_classes, num_features=x.shape[1]).to(device)
    model.load_state_dict(init_state(num_classes, x.shape[1], seed, device))
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    with float32_math():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            logits, s = model(xn)
            loss = nn.functional.cross_entropy(logits, y)
            if sev is not None:
                loss = loss + torch.mean((s - sev) ** 2)
            loss.backward()
            opt.step()
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return FittedScorer(params=params, mean=mean, std=std,
                        num_classes=num_classes)


def predict(fitted: FittedScorer, features: np.ndarray) -> dict:
    """(N, F) -> {'label' (N,), 'probs' (N, C), 'severity' (N,)}, computed
    on the device of the scorer's parameters."""
    w1 = fitted.params["fc1.weight"]
    model = DementiaScorer(fitted.num_classes, hidden=w1.shape[0],
                           num_features=w1.shape[1]).to(w1.device)
    model.load_state_dict(fitted.params)
    x = ((np.asarray(features, np.float32) - fitted.mean) / fitted.std
         ).astype(np.float32)
    with float32_math(), torch.inference_mode():
        logits, sev = model.eval()(torch.from_numpy(x).to(w1.device))
        probs = torch.softmax(logits, dim=-1)
        return {"label": logits.argmax(-1).cpu().numpy(),
                "probs": probs.cpu().numpy(),
                "severity": sev.cpu().numpy()}


def score_clip(joints3d: np.ndarray, fitted: Optional[FittedScorer] = None,
               fps: float = 20.0) -> dict:
    """(T,25,3) joints -> gait features, and a class prediction when a
    fitted scorer is given."""
    from gaitlab_torch.gait.features import gait_features

    feats = gait_features(joints3d, fps=fps)
    out = {"features": feats}
    if fitted is not None:
        pred = predict(fitted, feats["feature_vector"][None])
        out.update({"label": int(pred["label"][0]),
                    "probs": pred["probs"][0],
                    "severity": float(pred["severity"][0])})
    return out
