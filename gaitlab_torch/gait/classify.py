"""Dementia scoring from gait features.

Counterpart of gaitlab/gait/classify.py: `DementiaScorer`, a small MLP
over the gait_features vector that gives class logits (default 3: normal /
MCI-like / dementia-like gait) and a severity in [0, 1]; `predict` and
`score_clip` with a fitted scorer. Scorers are fitted by gaitlab for now
and carried over with `scorer_from_flax`: `fit` is training, which comes
with the rest of training (ROADMAP A14).

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


def fit(*args, **kwargs) -> FittedScorer:
    raise NotImplementedError(
        "gaitlab_torch.gait.classify.fit is training, which is not ported "
        "yet (ROADMAP A14): fit with gaitlab.gait.classify.fit and carry "
        "the result over with scorer_from_flax")


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
