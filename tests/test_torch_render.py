"""The port's render layer against gaitlab's, on the CPU.

- The host painter (render/raster.py): exact equality with gaitlab's.
- The z-buffer (render/raster_torch.py, on the CPU here) against
  gaitlab.render.raster_jax on JAX's CPU: the scenes of
  tests/test_raster_jax.py, and the SMPL-scale sphere of
  scripts/render_bench.py at 240x320 with both window classes in use.
  The z-buffers agree within 1e-6 and at least 99.9% of the pixels are
  equal (the two compute the same float32 arithmetic in other fused
  orders, so a fragment on a pixel edge may fall either way).
- overlay.render_video in skeleton mode and with mesh_render (painter,
  sideview), fed the same results dict in both packages: the decoded mp4
  frames are equal.
- prepare_rendering_results, images_to_video and the vis helpers.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaitlab.body import smpl as jax_smpl
from gaitlab.pipeline import coords as jax_coords
from gaitlab.pipeline import video as jax_video
from gaitlab.render import overlay as jax_overlay
from gaitlab.render import raster as jax_raster
from gaitlab.render import raster_jax
from gaitlab.render import vis as jax_vis
from gaitlab_torch.pipeline import coords as pt_coords
from gaitlab_torch.pipeline import video as pt_video
from gaitlab_torch.render import overlay as pt_overlay
from gaitlab_torch.render import raster as pt_raster
from gaitlab_torch.render import raster_torch
from gaitlab_torch.render import vis as pt_vis
from torch_threads import torch_threads  # noqa: F401

ZBUF_ATOL = 1e-6
MIN_PIXEL_AGREEMENT = 0.999
H, W = 240, 320


def sphere_mesh(rings: int = 85, segs: int = 81, r: float = 0.45):
    """scripts/render_bench.py's UV sphere: 6,966 vertices, 13,770 faces."""
    phi = np.linspace(0, np.pi, rings + 1)
    theta = np.linspace(0, 2 * np.pi, segs, endpoint=False)
    P, T = np.meshgrid(phi, theta, indexing="ij")
    verts = r * np.stack([np.sin(P) * np.cos(T), np.cos(P),
                          np.sin(P) * np.sin(T)], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(rings):
        for j in range(segs):
            a = i * segs + j
            b = i * segs + (j + 1) % segs
            c = (i + 1) * segs + j
            d = (i + 1) * segs + (j + 1) % segs
            faces += [[a, b, c], [b, d, c]]
    return verts, np.asarray(faces, np.int64)


# at this cam the sphere's faces fall in two window classes (8 and 16 px)
SPHERE_CAM = [1.1, 1.1 * 4 / 3, 0.05, -0.1]


@pytest.fixture(scope="module")
def sphere():
    return sphere_mesh()


@pytest.fixture(scope="module")
def background():
    return np.random.default_rng(3).integers(0, 255, (H, W, 3)).astype(
        np.uint8)


# -- the host painter --------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"wireframe": True},
                                {"angle": 270, "axis": [0, 1, 0]},
                                {"color": (0.2, 0.6, 0.9)}],
                         ids=["fill", "wireframe", "sideview", "color"])
def test_painter_matches_gaitlab(sphere, background, kw):
    verts, faces = sphere
    got = pt_raster.render_mesh(background, verts, SPHERE_CAM, faces, **kw)
    want = jax_raster.render_mesh(background, verts, SPHERE_CAM, faces, **kw)
    assert got.dtype == np.uint8 and (got != background).any()
    np.testing.assert_array_equal(got, want)


def test_painter_synthetic_smpl_matches_gaitlab(rng):
    """The demo's mesh: synthetic SMPL's 100 random faces."""
    params = jax_smpl.synthetic_smpl_params()
    verts = np.asarray(params.v_template)
    img = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    cam = [0.8, 1.0, 0.1, 0.2]
    np.testing.assert_array_equal(
        pt_raster.render_mesh(img, verts, cam, params.faces),
        jax_raster.render_mesh(img, verts, cam, params.faces))


# -- the z-buffer: scenes of tests/test_raster_jax.py -------------------------

def _scene_both(tris_pix, tris_z, shades, h=64, w=64, window=32):
    verts = np.array(tris_pix, np.float32).reshape(-1, 2)
    depth = np.array(tris_z, np.float32).repeat(3)
    faces = np.arange(verts.shape[0]).reshape(-1, 3)
    shades = np.asarray(shades, np.float32)
    color = np.array([255.0, 0.0, 0.0], np.float32)
    bg = np.zeros((h, w, 3), np.uint8)
    want = raster_jax.rasterize_zbuffer(
        jnp.asarray(verts), jnp.asarray(depth), jnp.asarray(faces, jnp.int32),
        jnp.asarray(shades), jnp.asarray(color), jnp.asarray(bg),
        height=h, width=w, window=window)
    got = raster_torch.rasterize_zbuffer(verts, depth, faces, shades, color,
                                         bg, height=h, width=w,
                                         window=window, device="cpu")
    return ([t.numpy() for t in got], [np.asarray(a) for a in want])


SCENES = {
    "coverage": ([[(10, 10), (30, 10), (10, 30)]], [1.0], [1.0], {}),
    "near_second": ([[(10, 10), (40, 10), (10, 40)]] * 2, [1.0, 2.0],
                    [0.2, 1.0], {}),
    "near_first": ([[(10, 10), (40, 10), (10, 40)]] * 2, [2.0, 1.0],
                   [1.0, 0.2], {}),
    "dim_occluder": ([[(10, 10), (40, 10), (10, 40)]] * 2, [2.0, 1.0],
                     [0.2, 1.0], {}),
    "offscreen_corner": ([[(-20, -20), (5, -20), (-20, 5)]], [1.0], [1.0],
                         {"h": 32, "w": 32}),
    "offscreen_far": ([[(100, 100), (120, 100), (100, 120)]], [1.0], [1.0],
                      {"h": 32, "w": 32}),
    "shared_edge": ([[(5, 5), (50, 5), (5, 50)], [(50, 5), (50, 50), (5, 50)]],
                    [1.0, 1.0], [0.3, 0.9], {}),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_zbuffer_scenes_match_raster_jax(name):
    tris, z, shades, kw = SCENES[name]
    (canvas, zbuf), (want_canvas, want_zbuf) = _scene_both(tris, z, shades,
                                                           **kw)
    np.testing.assert_allclose(zbuf, want_zbuf, rtol=0, atol=ZBUF_ATOL)
    np.testing.assert_array_equal(canvas, want_canvas)
    if name in ("near_second", "near_first"):
        assert canvas[15, 15, 0] > 200
    if name == "dim_occluder":
        assert canvas[15, 15, 0] < 100
    if name == "offscreen_far":
        assert canvas[:31, :31].sum() == 0


def _jax_sphere(img, pix, depth, tri, shade, groups, color):
    """render_mesh_jax's passes with the z-buffer kept."""
    h, w = img.shape[:2]
    pix_j = jnp.asarray(pix, jnp.float32)
    dep_j = jnp.asarray(depth, jnp.float32)
    zbuf = jnp.full((h * w,), raster_jax.FAR, jnp.float32)
    for idx, k in groups:
        zbuf = raster_jax.zbuffer_pass(pix_j, dep_j,
                                       jnp.asarray(tri[idx], jnp.int32),
                                       zbuf, height=h, width=w, window=k)
    canvas = jnp.concatenate([jnp.asarray(img, jnp.float32).reshape(-1, 3),
                              jnp.zeros((1, 3), jnp.float32)], axis=0)
    for idx, k in groups:
        canvas = raster_jax.color_pass(
            pix_j, dep_j, jnp.asarray(tri[idx], jnp.int32),
            jnp.asarray(shade[idx], jnp.float32), jnp.asarray(color), zbuf,
            canvas, height=h, width=w, window=k)
    out = np.clip(np.asarray(canvas[:-1]).reshape(h, w, 3), 0, 255)
    return out.astype(np.uint8), np.asarray(zbuf).reshape(h, w)


@pytest.mark.parametrize("kw", [{}, {"angle": 270, "axis": [0, 1, 0]}],
                         ids=["front", "sideview"])
def test_zbuffer_sphere_matches_raster_jax(sphere, background, kw):
    verts, faces = sphere
    color = np.asarray((1.0, 1.0, 0.9), np.float32) * 255.0
    pix, depth, tri, shade, groups = raster_torch.mesh_inputs(
        H, W, verts, SPHERE_CAM, faces, **kw)
    assert [k for _, k in groups] == [8, 16]  # both window classes
    want_img, want_zbuf = _jax_sphere(background, pix, depth, tri, shade,
                                      groups, color)
    canvas, zbuf = raster_torch._rasterize(pix, depth, tri, shade, color,
                                           background, groups, "cpu")
    got_img = canvas.clamp(0, 255).to(torch.uint8).numpy()
    zbuf = zbuf.numpy()
    covered = (zbuf < raster_torch.FAR) & (want_zbuf < raster_jax.FAR)
    assert covered.sum() > 0.2 * H * W
    np.testing.assert_array_equal(zbuf < raster_torch.FAR,
                                  want_zbuf < raster_jax.FAR)
    np.testing.assert_allclose(zbuf[covered], want_zbuf[covered], rtol=0,
                               atol=ZBUF_ATOL)
    agree = (got_img == want_img).all(-1).mean()
    print(f"z-buffer port vs raster_jax, {kw or 'front'}: {agree:.6f} of "
          f"pixels equal, max |zbuf diff| "
          f"{np.abs(zbuf - want_zbuf)[covered].max():.3e}")
    assert agree >= MIN_PIXEL_AGREEMENT
    # the public entry point paints the same image
    np.testing.assert_array_equal(
        raster_torch.render_mesh_zbuffer(background, verts, SPHERE_CAM, faces,
                                         device="cpu", **kw), got_img)
    np.testing.assert_array_equal(
        (got_img == raster_jax.render_mesh_jax(
            background, verts, SPHERE_CAM, faces, **kw)).all(-1),
        (got_img == want_img).all(-1))


def test_zbuffer_chunks_give_the_same_image(sphere, background,
                                            monkeypatch):
    """Chunking a class by faces changes neither the z-buffer nor the
    last-writer tie-break."""
    verts, faces = sphere
    whole = raster_torch.render_mesh_zbuffer(background, verts, SPHERE_CAM,
                                             faces, device="cpu")
    monkeypatch.setattr(raster_torch, "MAX_FRAGMENTS", 5000)
    chunked = raster_torch.render_mesh_zbuffer(background, verts, SPHERE_CAM,
                                               faces, device="cpu")
    np.testing.assert_array_equal(chunked, whole)


def test_window_classes_match_gaitlab(rng):
    for extents in (rng.random(500) * 20, rng.random(50) * 300,
                    np.r_[rng.random(300) * 6, [90.0, 120.0]], np.zeros(0)):
        got = raster_torch._window_classes(extents)
        want = raster_jax._window_classes(extents)
        assert [k for _, k in got] == [k for _, k in want]
        for (a, _), (b, _) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_zbuffer_default_device_is_the_card(sphere, background):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    verts, faces = sphere
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        raster_torch.render_mesh_zbuffer(background, verts, SPHERE_CAM, faces)


# -- overlay video -------------------------------------------------------------

N_FRAMES = 6


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """N_FRAMES 240x320 PNG frames, as video_to_images writes them."""
    d = tmp_path_factory.mktemp("render_frames")
    rng = np.random.default_rng(1)
    bg = rng.integers(40, 70, size=(H, W, 3)).astype(np.uint8)
    for i in range(N_FRAMES):
        frame = bg.copy()
        cv2.rectangle(frame, (40 + 10 * i, 40), (90 + 10 * i, 200),
                      (210, 190, 180), -1)
        cv2.imwrite(str(d / f"{i + 1:06d}.png"), frame)
    return str(d)


def _results():
    """Two persons in the demo pkl schema: person 0 on frames 0-4, person 1
    on frames 2-4; frame 5 has nobody (a passthrough frame)."""
    params = jax_smpl.synthetic_smpl_params()
    rng = np.random.default_rng(2)
    tmpl = np.asarray(params.v_template)
    out = {}
    for pid, fr in ((0, np.arange(0, 5)), (1, np.arange(2, 5))):
        n = len(fr)
        out[pid] = {
            "frame_ids": fr,
            "verts": (tmpl[None] * 0.8
                      + rng.normal(size=(n, 1, 3)) * 0.05).astype(np.float32),
            "orig_cam": np.tile([0.5, 0.65, -0.4 + 0.8 * pid, 0.1],
                                (n, 1)).astype(np.float32),
            "joints3d": (rng.normal(size=(n, 29, 3)) * 0.3).astype(np.float32),
            "joints2d": (rng.random((n, 29, 2)) * [W, H]).astype(np.float32),
            "pose": np.zeros((n, 72), np.float32),
            "betas": np.zeros((n, 10), np.float32),
        }
    return out, params.faces


def _decoded(path):
    cap = cv2.VideoCapture(path)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame)
    cap.release()
    return np.stack(out)


@pytest.mark.parametrize("kw", [
    {"joint_type": "spin"},
    {"mesh_render": True, "sideview": True},
    {"mesh_render": True, "wireframe": True}],
    ids=["skeleton", "mesh_sideview", "wireframe"])
def test_render_video_matches_gaitlab(frames, tmp_path, kw):
    import matplotlib.pyplot as plt

    results, faces = _results()
    nfl = list(range(N_FRAMES))
    outs = {}
    for name, mod in (("pt", pt_overlay), ("jax", jax_overlay)):
        plt.close("all")  # gaitlab leaves its figure open
        outs[name] = mod.render_video(
            results, nfl, frames, str(tmp_path / f"{name}.mp4"),
            orig_size=(W, H), smpl_faces=faces, **kw)
    got, want = _decoded(outs["pt"]), _decoded(outs["jax"])
    assert got.shape[0] == N_FRAMES
    if kw.get("sideview"):
        assert got.shape[1:3] == (H, 2 * W)
    elif not kw.get("mesh_render"):
        assert got.shape[1:3] == (500, 1000)  # the 10x5 in figure
    np.testing.assert_array_equal(got, want)
    assert not os.path.exists(f"{frames}_output")


def test_render_video_zbuffer_on_the_cpu(frames, tmp_path):
    """renderer="zbuffer" draws with the port's z-buffer on `device`."""
    results, faces = _results()
    out = pt_overlay.render_video(
        results, list(range(N_FRAMES)), frames, str(tmp_path / "zb.mp4"),
        orig_size=(W, H), mesh_render=True, smpl_faces=faces,
        renderer="zbuffer", device="cpu")
    assert _decoded(out).shape == (N_FRAMES, H, W, 3)


def test_render_video_display_warns_headless(frames, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    results, faces = _results()
    pt_overlay.render_video(results, list(range(N_FRAMES)), frames,
                            str(tmp_path / "d.mp4"), orig_size=(W, H),
                            mesh_render=True, smpl_faces=faces, display=True)
    assert "--display requires a display server" in capsys.readouterr().out


# -- helpers -----------------------------------------------------------------

@pytest.mark.parametrize("concat", [False, True])
def test_prepare_rendering_results_matches_gaitlab(concat):
    results, _ = _results()
    # concat needs somebody on every frame listed (np.concatenate)
    nfl = list(range(N_FRAMES - 1 if concat else N_FRAMES))
    got = pt_coords.prepare_rendering_results(results, nfl, concat=concat)
    want = jax_coords.prepare_rendering_results(results, nfl, concat=concat)
    assert list(got) == list(want) == nfl
    for f in nfl:
        if concat:
            assert set(got[f]) == set(want[f])
            for k in want[f]:
                np.testing.assert_array_equal(got[f][k], want[f][k])
        else:
            assert list(got[f]) == list(want[f])  # the render order
            for pid in want[f]:
                for k in want[f][pid]:
                    np.testing.assert_array_equal(got[f][pid][k],
                                                  want[f][pid][k])


def test_images_to_video_matches_gaitlab(frames, tmp_path):
    pt_video.images_to_video(frames, str(tmp_path / "pt" / "v.mp4"))
    jax_video.images_to_video(frames, str(tmp_path / "jax" / "v.mp4"))
    got = _decoded(str(tmp_path / "pt" / "v.mp4"))
    assert got.shape == (N_FRAMES, H, W, 3)
    np.testing.assert_array_equal(got, _decoded(str(tmp_path / "jax" /
                                                    "v.mp4")))
    with pytest.raises(ValueError, match="no frames"):
        pt_video.images_to_video(str(tmp_path), str(tmp_path / "e.mp4"))


def test_vis_panels_match_gaitlab(rng):
    params = jax_smpl.synthetic_smpl_params()
    n = 2
    video = rng.integers(0, 255, (n, 3, 64, 64, 3)).astype(np.uint8)
    preds = {"kp_2d": rng.uniform(-1, 1, (n, 3, 29, 3)).astype(np.float32),
             "verts": np.tile(np.asarray(params.v_template)[None, None],
                              (n, 3, 1, 1)) * 0.5,
             "theta": np.concatenate([np.tile([0.9, 0.0, 0.1], (n, 3, 1)),
                                      np.zeros((n, 3, 82))], -1)}
    target = {"kp_2d": rng.uniform(-1, 1, (n, 3, 29, 2)).astype(np.float32)}
    kw = dict(fmt="spin2", faces=params.faces)
    got = pt_vis.visualize_batch_vid_preds(video, preds, target, **kw)
    assert got.shape == (n, 3, 64, 64 * 5, 3)
    np.testing.assert_array_equal(
        got, jax_vis.visualize_batch_vid_preds(video, preds, target, **kw))
    flat = {k: v[0] for k, v in preds.items()}
    np.testing.assert_array_equal(
        pt_vis.batch_check_preds(video[0], flat, crop_size=64, **kw),
        jax_vis.batch_check_preds(video[0], flat, crop_size=64, **kw))
    np.testing.assert_array_equal(
        pt_vis.show_preds(video, preds, **kw),
        jax_vis.show_preds(video, preds, **kw))
    norm = rng.normal(size=(32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(pt_vis.denormalize_image(norm),
                                  jax_vis.denormalize_image(norm))
    img = rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
    j2d = rng.uniform(0, 64, (24, 2))
    np.testing.assert_array_equal(
        pt_vis.draw_smpl_joints2d(img.copy(), j2d),
        jax_vis.draw_smpl_joints2d(img.copy(), j2d))
    np.testing.assert_array_equal(
        pt_vis.render_image(img, np.asarray(params.v_template),
                            [0.8, 0.8, 0, 0], params.faces),
        jax_vis.render_image(img, np.asarray(params.v_template),
                             [0.8, 0.8, 0, 0], params.faces))
    j3d = rng.normal(size=(49, 3))
    np.testing.assert_allclose(pt_vis.body_orientation_rotmat(j3d),
                               jax_vis.body_orientation_rotmat(j3d))


def test_vis_sequence_matches_gaitlab(rng, tmp_path, monkeypatch):
    seq = rng.normal(size=(2, 17 * 3)) * 0.3
    got = pt_vis.visualize_sequence(seq, out_path=str(tmp_path / "s.mp4"))
    np.testing.assert_array_equal(got, jax_vis.visualize_sequence(seq))
    assert _decoded(str(tmp_path / "s.mp4")).shape[0] == 2
    for var in ("DISPLAY", "WAYLAND_DISPLAY"):
        monkeypatch.delenv(var, raising=False)
    assert pt_vis.show_video(got) is False  # headless: no window


def test_regressor_output_waits_for_spin():
    """The SPIN regressor is ported (nn/spin.py): the function runs it, on
    the HMR it is given (here one on the CPU; tests/test_torch_spin.py holds
    it against gaitlab), or on a fresh one on the card."""
    from gaitlab_torch.nn.spin import HMR

    verts, cam = pt_vis.regressor_output_from_features(
        np.zeros((1, 2, 2048), np.float32), hmr=HMR.create(device="cpu"))
    assert verts.shape == (1, 2, 6890, 3) and cam.shape == (1, 2, 3)
    assert np.isfinite(verts).all() and np.isfinite(cam).all()
