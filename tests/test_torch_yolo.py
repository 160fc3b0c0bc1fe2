"""gaitlab_torch.nn.yolo and its YoloDetector against gaitlab's, on the CPU.

Both variants run in both packages: tiny at 128 px and the full YOLOv3
(Darknet-53, 75 convolutions) at 160 px, two frames each. The weights are
the port's random init with random BN affine terms, and BN statistics from
one train-mode pass over other random frames, so that activations stay of
order one through every layer. They cross to gaitlab through one darknet
file that both packages read, and come back through
`yolo_state_dict_from_flax`.

Tolerance: the two packages sum the same float32 products in different
orders (XLA:CPU against oneDNN), so the raw maps agree to
max|a - b| <= 1e-4 * max|b| (RTOL below), the decoded predictions to the
same share of each column group's largest value, and detector boxes to
1e-4 relative / 1e-3 px.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.nn import yolo as jax_yolo
from gaitlab.pipeline import detect as jax_detect
from gaitlab_torch.nn import yolo as pt_yolo
from gaitlab_torch.pipeline import detect as pt_detect
from gaitlab_torch.pipeline import fetch as pt_fetch
from gaitlab_torch.weights.convert import yolo_state_dict_from_flax

RTOL = 1e-4


def assert_close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    err = np.abs(got - want).max()
    limit = rtol * np.abs(want).max()
    assert err <= limit, f"{what}: max abs err {err:.3e} > {limit:.3e}"


def random_net(variant: str, size: int, seed: int = 0) -> pt_yolo.YoloNet:
    """Random weights with random BN affine terms and BN statistics from
    one train-mode pass over four random frames."""
    torch.manual_seed(seed)
    net = pt_yolo.YoloV3() if variant == "v3" else pt_yolo.YoloV3Tiny()
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                m.momentum = None  # cumulative: the pass's exact statistics
        net.train()
        net(torch.rand(4, 3, size, size, generator=g))
    return net.eval()


def jax_variables(path: str, variant: str):
    module = jax_yolo.YoloV3() if variant == "v3" else jax_yolo.YoloV3Tiny()
    # the variable shapes do not depend on the input size: init at 32 px
    init = module.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 32, 32, 3), jnp.float32))
    return module, jax_yolo.load_darknet_weights(path, init,
                                                 layers=module.layers)


@pytest.fixture(scope="module", params=[("tiny", 128), ("v3", 160)],
                ids=["tiny128", "v3_160"])
def pair(request, tmp_path_factory):
    """(variant, size, port net, darknet file, gaitlab module, gaitlab
    variables read from that file, two frames NHWC in [0,1])."""
    variant, size = request.param
    net = random_net(variant, size)
    path = str(tmp_path_factory.mktemp("yolo") / f"{variant}.weights")
    pt_yolo.save_darknet_weights(path, net)
    module, variables = jax_variables(path, variant)
    x = np.random.default_rng(9).random((2, size, size, 3), np.float32)
    return variant, size, net, path, module, variables, x


def port_maps(net, x):
    with torch.no_grad():
        return net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())


def test_raw_maps_and_decode_match_gaitlab(pair):
    variant, size, net, path, module, variables, x = pair
    want_maps = module.apply(variables, jnp.asarray(x))
    from_file = pt_yolo.load_darknet_weights(
        path, pt_yolo.YoloV3() if variant == "v3" else pt_yolo.YoloV3Tiny())
    from_flax = pt_yolo.YoloV3() if variant == "v3" else pt_yolo.YoloV3Tiny()
    from_flax.load_state_dict(yolo_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    grids = [size // 32, size // 16] + ([size // 8] if variant == "v3" else [])
    for route, m in (("darknet file", from_file), ("flax variables", from_flax)):
        maps = port_maps(m.eval(), x)
        assert [tuple(t.shape) for t in maps] == [(2, 255, g, g) for g in grids]
        for i, (got, want) in enumerate(zip(maps, want_maps)):
            assert np.abs(np.asarray(want)).max() > 0.1  # activations live
            assert_close(got.permute(0, 2, 3, 1).numpy(), want,
                         what=f"{route}: map {i}")
    with torch.no_grad():
        got = pt_yolo.detect(from_file, torch.from_numpy(x).permute(0, 3, 1, 2))
    # gaitlab's detect(), from the maps above rather than a second forward
    want = np.concatenate([np.asarray(jax_yolo.decode_predictions(
        m, e[1], size // m.shape[1])) for m, e in zip(
            want_maps, [e for e in module.layers if e[0] == "yolo"])], axis=1)
    assert got.shape == want.shape == (2, sum(3 * g * g for g in grids), 85)
    for cols in (slice(0, 2), slice(2, 4), slice(4, 85)):
        assert_close(got[..., cols].numpy(), want[..., cols],
                     what=f"decoded columns {cols}")


def test_weights_cross_unchanged(pair):
    """The darknet file and the flax route both give back the port's own
    weights bit for bit; gaitlab writes the same file from its variables."""
    variant, size, net, path, module, variables, _ = pair
    want = net.state_dict()
    fresh = pt_yolo.YoloV3() if variant == "v3" else pt_yolo.YoloV3Tiny()
    got = pt_yolo.load_darknet_weights(path, fresh).state_dict()
    sd = yolo_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          variables))
    assert set(got) == set(want) == set(sd)
    for k in want:
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
            torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    again = path + ".jax"
    jax_yolo.save_darknet_weights(again, variables, layers=module.layers)
    with open(path, "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()


def test_darknet_header_versions_and_errors(tmp_path):
    net = random_net("tiny", 64, seed=3)
    path = str(tmp_path / "t.weights")
    pt_yolo.save_darknet_weights(path, net)
    data = open(path, "rb").read()
    assert np.frombuffer(data[:12], np.int32).tolist() == [0, 2, 0]
    # darknet < 0.2 stores `seen` as int32
    old = (np.array([0, 1, 0], np.int32).tobytes()
           + np.array([7], np.int32).tobytes() + data[20:])
    loaded = pt_yolo.load_darknet_weights(old, pt_yolo.YoloV3Tiny())
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0,
                                       atol=0)
    with pytest.raises(ValueError, match="too short"):
        pt_yolo.load_darknet_weights(data[:-64], pt_yolo.YoloV3Tiny())
    with pytest.raises(ValueError, match="unread"):
        pt_yolo.load_darknet_weights(data + b"\0" * 8, pt_yolo.YoloV3Tiny())


def test_tables_and_infer_variant_match_gaitlab(tmp_path):
    for fn in ("tiny_layers", "v3_layers"):
        t = getattr(pt_yolo, fn)()
        assert t == getattr(jax_yolo, fn)()
        assert (pt_yolo.expected_float_count(t)
                == jax_yolo.expected_float_count(t))
    assert pt_yolo.expected_float_count(pt_yolo.v3_layers()) == 62001757
    assert pt_yolo.expected_float_count(pt_yolo.tiny_layers()) == 8858734
    for hdr in (20, 16):
        for n, want in ((8858734, "tiny"), (62001757, "v3")):
            path = str(tmp_path / f"{want}_{hdr}.weights")
            with open(path, "wb") as f:
                f.truncate(hdr + 4 * n)
            assert pt_yolo.infer_variant(path) == want
            assert jax_yolo.infer_variant(path) == want
    assert pt_yolo.infer_variant(b"\0" * (20 + 4 * 8858734)) == "tiny"
    with pytest.raises(ValueError, match="unrecognized"):
        pt_yolo.infer_variant(b"\0" * 1000)


def test_decode_matches_gaitlab_on_random_maps():
    """The head map is NCHW in the port and NHWC in gaitlab: decode must
    permute before it splits anchors and classes."""
    rng = np.random.default_rng(10)
    raw = rng.normal(size=(2, 7, 7, 255)).astype(np.float32)
    want = np.asarray(jax_yolo.decode_predictions(
        jnp.asarray(raw), jax_yolo.V3_ANCHORS_16, 16))
    got = pt_yolo.decode_predictions(
        torch.from_numpy(raw).permute(0, 3, 1, 2), pt_yolo.V3_ANCHORS_16, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def constant_head(net: pt_yolo.YoloNet, tx=0.0, tw=0.0, obj=3.0, cls0=3.0):
    """Zero every kernel, identity BN, and head biases that make every grid
    cell predict the same logits (tests/test_yolo.py's closed form)."""
    with torch.no_grad():
        for name, m in net.named_children():
            if isinstance(m, pt_yolo.ConvBN):
                m.conv.weight.zero_()
                m.bn.weight.fill_(1.0)
                m.bn.bias.zero_()
                m.bn.running_mean.zero_()
                m.bn.running_var.fill_(1.0)
            else:
                m.weight.zero_()
                bias = torch.full((3, 85), -10.0)
                bias[:, 0:2] = tx
                bias[:, 2:4] = tw
                bias[:, 4] = obj
                bias[:, 5] = cls0
                m.bias.copy_(bias.reshape(-1))
    return net.eval()


@pytest.mark.parametrize("variant,size", [("tiny", 128), ("v3", 160)])
def test_decode_closed_form(variant, size):
    net = constant_head(pt_yolo.YoloV3() if variant == "v3"
                        else pt_yolo.YoloV3Tiny())
    with torch.no_grad():
        d = pt_yolo.detect(net, torch.zeros(1, 3, size, size))[0].numpy()
    sig3 = 1.0 / (1.0 + np.exp(-3.0))
    strides = (32, 16, 8) if variant == "v3" else (32, 16)
    anchor_sets = ((pt_yolo.V3_ANCHORS_32, pt_yolo.V3_ANCHORS_16,
                    pt_yolo.V3_ANCHORS_8) if variant == "v3"
                   else (pt_yolo.ANCHORS_COARSE, pt_yolo.ANCHORS_FINE))
    off = 0
    for s, anchors in zip(strides, anchor_sets):
        g = size // s
        rows = d[off:off + g * g * 3].reshape(g, g, 3, 85)
        assert np.allclose(rows[0, 0, 0, :2], 0.5 * s)
        # rows run over (y, x, anchor): x grows along the second axis
        np.testing.assert_allclose(rows[2, 1, 0, :2], [1.5 * s, 2.5 * s])
        np.testing.assert_allclose(rows[0, 0, :, 2:4], anchors, rtol=1e-6)
        np.testing.assert_allclose(rows[..., 4:6], sig3, atol=1e-6)
        assert rows[..., 6:].max() < 1e-4
        off += g * g * 3
    assert off == len(d)


def frames_uint8(n=5, h=90, w=140, seed=11):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def test_yolo_detector_boxes_match_gaitlab(tmp_path):
    """Letterbox (non-square frames), decode, the person score threshold,
    the mapping back to the image and NMS: the same boxes as gaitlab's
    detector from the same darknet file. gaitlab pads the last batch to a
    fixed size; the port does not."""
    net = random_net("tiny", 128, seed=4)
    path = str(tmp_path / "yolov3-tiny.weights")
    pt_yolo.save_darknet_weights(path, net)
    frames = frames_uint8()
    want = jax_detect.YoloDetector(weights_path=path, input_size=128,
                                   batch=2)(frames)
    det = pt_detect.YoloDetector(weights_path=path, input_size=128, batch=2,
                                 device="cpu")
    got = det(frames)
    assert det.variant == "tiny" and det.forwards == 3
    assert len(got) == len(want) == len(frames)
    assert sum(len(w) for w in want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)


@pytest.fixture()
def tiny_file(tmp_path):
    path = tmp_path / "yolov3-tiny.weights"
    pt_yolo.save_darknet_weights(str(path), pt_yolo.YoloV3Tiny())
    return path


def test_yolo_detector_default_device_is_the_card(tiny_file):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_detect.YoloDetector(str(tiny_file))
    det = pt_detect.YoloDetector(str(tiny_file), input_size=64, batch=2,
                                 device="cpu")
    out = det(frames_uint8(3, 40, 60))
    assert len(out) == 3 and all(d.shape[1:] == (5,) for d in out)
    assert det.forwards == 2


def test_letterbox_matches_gaitlab():
    frames = frames_uint8(3, 90, 140)
    got = pt_detect.letterbox(frames, 128)
    # gaitlab's method reads only `input_size` from its detector
    want = jax_detect.YoloDetector._letterbox(SimpleNamespace(input_size=128),
                                              frames)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_get_detector_variant_forcing_and_operating_point(tiny_file,
                                                          monkeypatch):
    monkeypatch.setenv("GAITLAB_YOLO_WEIGHTS", str(tiny_file))
    det = pt_detect.get_detector("yolo", input_size=320, batch=4,
                                 device="cpu")
    assert isinstance(det, pt_detect.YoloDetector)
    assert (det.variant, det.input_size, det.batch) == ("tiny", 320, 4)
    assert pt_detect.get_detector("yolo_tiny", device="cpu").variant == "tiny"
    with pytest.raises(ValueError, match="too short"):
        pt_detect.get_detector("yolo_v3", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt_detect.get_detector("yolo")


def test_get_detector_asset_dir_and_fallbacks(tiny_file, monkeypatch,
                                              capsys):
    """Like gaitlab: the asset dir is searched for the forced variant's
    own file; without weights, a user cv2.dnn model, else the
    median-background detector with a warning."""
    tmp = tiny_file.parent
    (tmp / "yolov3.weights").write_bytes(b"\0" * 2048)  # a decoy, searched first
    monkeypatch.delenv("GAITLAB_YOLO_WEIGHTS", raising=False)
    monkeypatch.delenv("GAITLAB_DETECTOR_MODEL", raising=False)
    monkeypatch.setattr(pt_fetch, "ASSET_DIR", str(tmp))
    assert pt_detect.get_detector("yolo_tiny", device="cpu").variant == "tiny"
    (tmp / "yolov3.weights").unlink()
    assert pt_detect.get_detector("yolo", device="cpu").variant == "tiny"
    tiny_file.unlink()
    det = pt_detect.get_detector("yolo_v3", device="cpu")
    assert isinstance(det, pt_detect.MedianBackgroundDetector)
    assert "no YOLO weights found" in capsys.readouterr().out

    seen = {}

    class StubDnn:
        def __init__(self, model=None, config=None, **kw):
            seen.update(kw, model=model)

    monkeypatch.setattr(pt_detect, "DnnPersonDetector", StubDnn)
    monkeypatch.setenv("GAITLAB_DETECTOR_MODEL", "person.onnx")
    det = pt_detect.get_detector("yolo_tiny", input_size=320)
    assert isinstance(det, StubDnn)
    assert seen == {"model": "person.onnx", "input_size": 320}
    with pytest.raises(ValueError, match="unknown detector"):
        pt_detect.get_detector("nope")


def test_resolve_asset(tmp_path):
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "x.bin").write_bytes(b"1")
    assert pt_fetch.resolve_asset("x.bin", str(tmp_path)) == os.path.join(
        str(tmp_path), "a", "b", "x.bin")
    with pytest.raises(FileNotFoundError, match="GAITLAB_ASSET_DIR"):
        pt_fetch.resolve_asset("y.bin", str(tmp_path))
