"""gaitlab_torch.gait (features, classify) against gaitlab.gait.

The same synthetic kinectv2 walkers (tests/test_gait_features.
synthetic_walk, clear sinusoidal steps) go through both packages: every
feature within rtol 1e-4 (atol 1e-6 for features that are 0), the
heel-strike frame indices equal. A scorer fitted by gaitlab is carried
over with scorer_from_flax and predicts the same labels, probabilities
and severities (rtol 1e-5, atol 1e-6 where the sigmoid saturates near
0) on the CPU; the port's own fit, from the same init, fits as gaitlab's
does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.gait import classify as jax_classify
from gaitlab.gait import features as jax_features
from gaitlab_torch.gait import classify as pt_classify
from gaitlab_torch.gait import features as pt_features
from test_gait_features import synthetic_walk


def rotate(J: np.ndarray, deg: float) -> np.ndarray:
    """The walker turned about the vertical axis (walking off-axis)."""
    a = np.deg2rad(deg)
    r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    return (J @ r.T).astype(np.float32)


def crippled(J: np.ndarray) -> np.ndarray:
    J = J.copy()
    hipx = J[:, 12, 0]
    J[:, 14, 0] = hipx + (J[:, 14, 0] - hipx) * 0.3
    return J


WALKERS = {
    "normal": lambda: synthetic_walk(n=160),
    "slow": lambda: synthetic_walk(n=120, speed=0.5, step_freq=1.0,
                                   step_amp=0.2),
    "fast_30fps": lambda: synthetic_walk(n=90, fps=30.0, speed=1.4,
                                         step_freq=2.0),
    "asymmetric": lambda: crippled(synthetic_walk(n=160)),
    "turned": lambda: rotate(synthetic_walk(n=140, speed=1.0), 30.0),
}


def assert_features_close(got: dict, want: dict):
    for k in jax_features.FEATURE_NAMES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["feature_vector"], want["feature_vector"],
                               rtol=1e-4, atol=1e-6)
    assert got["feature_vector"].dtype == np.float32
    assert set(got["events"]) == {"left", "right"}
    for side in ("left", "right"):
        np.testing.assert_array_equal(got["events"][side],
                                      want["events"][side], side)


def test_feature_names_agree():
    assert pt_features.FEATURE_NAMES == jax_features.FEATURE_NAMES


@pytest.mark.parametrize("walker", list(WALKERS))
def test_gait_features_match(walker):
    J = WALKERS[walker]()
    fps = 30.0 if walker == "fast_30fps" else 20.0
    want = jax_features.gait_features(J, fps=fps)
    got = pt_features.gait_features(J, fps=fps)
    assert_features_close(got, want)
    assert len(got["events"]["left"]) >= 3


@pytest.mark.parametrize("side", ["left", "right"])
def test_heel_strikes_and_leg_length_match(side):
    J = rotate(synthetic_walk(n=100, step_freq=1.5), -20.0)
    np.testing.assert_array_equal(
        pt_features.heel_strikes(J, side),
        np.asarray(jax_features.heel_strikes(jnp.asarray(J), side)))
    np.testing.assert_allclose(pt_features.leg_length(J),
                               np.asarray(jax_features.leg_length(J)),
                               rtol=1e-6)


def test_smooth_matches():
    x = np.random.default_rng(0).normal(size=(30, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(pt_features._smooth(x),
                               np.asarray(jax_features._smooth(x)),
                               rtol=1e-5, atol=1e-6)


def test_batch_gait_features_match():
    J = synthetic_walk(n=80)
    db = {"vid_name": np.array(["a"] * 80 + ["b"] * 80 + ["short"] * 10),
          "joints3D": np.concatenate([J, J * 1.1, J[:10]], axis=0)}
    want = jax_features.batch_gait_features(db)
    got = pt_features.batch_gait_features(db)
    assert set(got) == set(want) == {"a", "b"}
    for k in want:
        assert_features_close(got[k], want[k])


@pytest.fixture(scope="module")
def cohort():
    """Feature vectors of fast and slow walkers, and a gaitlab scorer
    fitted on them (a short fit: the point is carrying it over)."""
    rng = np.random.default_rng(1)
    feats, labels, sev = [], [], []
    for i in range(12):
        fast = i % 2 == 0
        J = synthetic_walk(n=120, speed=rng.uniform(1.1, 1.4) if fast
                           else rng.uniform(0.3, 0.6),
                           step_freq=rng.uniform(1.6, 2.0) if fast
                           else rng.uniform(0.8, 1.1))
        feats.append(jax_features.gait_features(J)["feature_vector"])
        labels.append(0 if fast else 1)
        sev.append(0.1 if fast else 0.8)
    feats = np.stack(feats)
    fitted = jax_classify.fit(feats, np.array(labels), severity=np.array(sev),
                              num_classes=2, steps=40)
    return feats, fitted


def test_predict_matches_gaitlab(cohort):
    feats, fitted = cohort
    scorer = pt_classify.scorer_from_flax(fitted, device="cpu")
    assert scorer.params["fc1.weight"].device.type == "cpu"
    want = jax_classify.predict(fitted, feats)
    got = pt_classify.predict(scorer, feats)
    np.testing.assert_array_equal(got["label"], want["label"])
    for k in ("probs", "severity"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_score_clip_matches_gaitlab(cohort):
    _, fitted = cohort
    scorer = pt_classify.scorer_from_flax(fitted, device="cpu")
    J = synthetic_walk(n=100, speed=0.9)
    want = jax_classify.score_clip(J, fitted)
    got = pt_classify.score_clip(J, scorer)
    assert set(got) == set(want) == {"features", "label", "probs",
                                     "severity"}
    assert got["label"] == want["label"]
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["severity"], want["severity"], rtol=1e-5,
                               atol=1e-6)
    assert_features_close(got["features"], want["features"])
    plain = pt_classify.score_clip(J)
    assert set(plain) == {"features"}


def test_fit_waits_for_training(cohort, monkeypatch):
    """`fit` is ported (the name is the one the test had while fit raised):
    from gaitlab's Flax init, carried over through the module's
    init_state hook, 200 full-batch Adam steps on the cohort reach
    gaitlab's fit: the same labels, probabilities and severities within
    rtol 1e-4, atol 1e-5 (float32 steps in two libraries' orders)."""
    import jax

    feats = cohort[0]
    labels = np.arange(len(feats)) % 2
    sev = np.where(labels == 0, 0.1, 0.8)
    seed = 3

    def flax_init(num_classes, num_features, s, device):
        assert (num_classes, num_features, s) == (2, feats.shape[1], seed)
        x = np.zeros((1, num_features), np.float32)
        init = jax_classify.DementiaScorer(num_classes=num_classes).init(
            jax.random.PRNGKey(s), x)
        return pt_classify.scorer_from_flax(jax_classify.FittedScorer(
            init, None, None, num_classes), device=device).params

    monkeypatch.setattr(pt_classify, "init_state", flax_init)
    kw = dict(severity=sev, num_classes=2, steps=200, seed=seed)
    want_fit = jax_classify.fit(feats, labels, **kw)
    got_fit = pt_classify.fit(feats, labels, device="cpu", **kw)
    np.testing.assert_allclose(got_fit.mean, want_fit.mean, rtol=1e-6)
    np.testing.assert_allclose(got_fit.std, want_fit.std, rtol=1e-6)
    want = jax_classify.predict(want_fit, feats)
    got = pt_classify.predict(got_fit, feats)
    np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(got["label"], labels)
    for k in ("probs", "severity"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_scorer_goes_to_the_card_by_default(cohort):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_classify.scorer_from_flax(cohort[1])
