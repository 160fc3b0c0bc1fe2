"""The port's mesh export against gaitlab's, on the CPU.

- export_obj: byte-identical files.
- export_glb: the same glTF JSON chunk (every key, index, count and
  string equal; its floats, node translations and accessor bounds, within
  1e-5, the tolerance of the binary buffers: the rest mesh and joints are
  float32 sums taken in another order by each package), binary buffers
  within 1e-5.
- export_fbx: parsed node trees equal (names, property types, integers
  and strings exactly), float arrays within 1e-5.
- cli.fbx_output.main(..., device="cpu") against gaitlab's on one pkl.
"""

import json
import struct

import joblib
import numpy as np
import pytest

from gaitlab.body import smpl as jax_smpl
from gaitlab.cli import fbx_output as jax_cli
from gaitlab.render import export as jax_export
from gaitlab.render import fbx as jax_fbx
from gaitlab_torch.body import smpl as pt_smpl
from gaitlab_torch.cli import fbx_output as pt_cli
from gaitlab_torch.render import export as pt_export
from gaitlab_torch.render import fbx as pt_fbx

ATOL = 1e-5
T = 12


@pytest.fixture(scope="module")
def motion():
    rng = np.random.default_rng(4)
    pose = (rng.normal(size=(T, 72)) * 0.3).astype(np.float32)
    betas = (rng.normal(size=(10,)) * 0.05).astype(np.float32)
    trans = (rng.normal(size=(T, 3)) * 0.1).astype(np.float32)
    return pose, betas, trans


def parse_glb(path):
    with open(path, "rb") as f:
        magic, version, total = struct.unpack("<III", f.read(12))
        assert (magic, version) == (jax_export.GLB_MAGIC, 2)
        jlen, jtype = struct.unpack("<II", f.read(8))
        assert jtype == 0x4E4F534A
        gltf = json.loads(f.read(jlen))
        blen, btype = struct.unpack("<II", f.read(8))
        assert btype == 0x004E4942
        blob = f.read(blen)
        assert f.read() == b""
    return gltf, blob


def assert_tree_close(got, want, where="json"):
    """Equal structure, types and non-float values; floats within ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            assert_tree_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= ATOL, \
            (where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def assert_glb_close(got_path, want_path):
    (g_json, g_blob), (w_json, w_blob) = parse_glb(got_path), parse_glb(
        want_path)
    assert_tree_close(g_json, w_json)
    assert len(g_blob) == len(w_blob)
    comp = {5126: np.float32, 5125: np.uint32, 5121: np.uint8}
    for acc in w_json["accessors"]:
        view = w_json["bufferViews"][acc["bufferView"]]
        lo, hi = view["byteOffset"], view["byteOffset"] + view["byteLength"]
        dt = comp[acc["componentType"]]
        g, w = np.frombuffer(g_blob[lo:hi], dt), np.frombuffer(w_blob[lo:hi],
                                                               dt)
        if dt is np.float32:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, w)


def assert_fbx_close(got, want, where="fbx"):
    if "nodes" in want:
        assert got["version"] == want["version"]
        got, want = {"name": "", "props": [], "children": got["nodes"]}, {
            "name": "", "props": [], "children": want["nodes"]}
    assert got["name"] == want["name"], where
    where = f"{where}/{want['name']}"
    assert len(got["props"]) == len(want["props"]), where
    for g, w in zip(got["props"], want["props"]):
        assert type(g) is type(w), where
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, where
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                           err_msg=where)
            else:
                np.testing.assert_array_equal(g, w, err_msg=where)
        elif isinstance(w, float):
            assert abs(g - w) <= ATOL, (where, g, w)
        else:
            assert g == w, (where, g, w)
    assert len(got["children"]) == len(want["children"]), where
    for g, w in zip(got["children"], want["children"]):
        assert_fbx_close(g, w, where)


def test_export_obj_is_byte_identical(tmp_path, rng):
    verts = rng.normal(size=(6890, 3)).astype(np.float32)
    faces = np.asarray(jax_smpl.synthetic_smpl_params().faces)
    got = pt_export.export_obj(str(tmp_path / "pt.obj"), verts, faces)
    want = jax_export.export_obj(str(tmp_path / "jax.obj"), verts, faces)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_anim_skin_data_matches_gaitlab(motion):
    pose, betas, trans = motion
    got = pt_export.anim_skin_data(pose, betas, pt_smpl.synthetic_smpl_params(),
                                   trans, device="cpu")
    want = jax_export.anim_skin_data(pose, betas,
                                     jax_smpl.synthetic_smpl_params(), trans)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("with_trans", [False, True])
def test_export_glb_matches_gaitlab(tmp_path, motion, with_trans):
    pose, betas, trans = motion
    trans = trans if with_trans else None
    got = pt_export.export_glb(str(tmp_path / "pt.glb"), pose, betas,
                               pt_smpl.synthetic_smpl_params(), trans,
                               fps=20.0, device="cpu")
    want = jax_export.export_glb(str(tmp_path / "jax.glb"), pose, betas,
                                 jax_smpl.synthetic_smpl_params(), trans,
                                 fps=20.0)
    assert_glb_close(got, want)


@pytest.mark.parametrize("gender", ["male", "female", "neutral"])
def test_export_fbx_matches_gaitlab(tmp_path, motion, gender):
    pose, betas, trans = motion
    got = pt_fbx.export_fbx(str(tmp_path / "pt.fbx"), pose, betas,
                            pt_smpl.synthetic_smpl_params(), trans, fps=25.0,
                            gender=gender, device="cpu")
    want = jax_fbx.export_fbx(str(tmp_path / "jax.fbx"), pose, betas,
                              jax_smpl.synthetic_smpl_params(), trans,
                              fps=25.0, gender=gender)
    g_tree, w_tree = pt_fbx.parse_fbx(got), jax_fbx.parse_fbx(want)
    assert_fbx_close(g_tree, w_tree)
    assert len(pt_fbx.find_nodes(g_tree, "Model")) == 25  # mesh + 24 bones
    limbs = [n for n in pt_fbx.find_nodes(g_tree, "Model")
             if n["props"][2] == b"LimbNode"]
    assert len(limbs) == 24
    # the reader is the port's own: it reads gaitlab's file the same way
    assert_fbx_close(pt_fbx.parse_fbx(want), w_tree)


@pytest.fixture(scope="module")
def demo_pkl(tmp_path_factory):
    """A demo pkl of two persons (person 1 the longer track)."""
    rng = np.random.default_rng(5)
    results = {}
    for pid, n in ((0, 9), (1, 14)):
        results[pid] = {
            "frame_ids": np.arange(n),
            "pose": (rng.normal(size=(n, 72)) * 0.2).astype(np.float32),
            "betas": (rng.normal(size=(n, 10)) * 0.03).astype(np.float32),
        }
    path = str(tmp_path_factory.mktemp("fbx_cli") / "demo.pkl")
    joblib.dump(results, path)
    return path


@pytest.mark.parametrize("ext,extra", [
    (".fbx", []), (".glb", []),
    (".fbx", ["--gender", "female", "--person_id", "0",
              "--fps_source", "30", "--fps_target", "15"]),
    (".glb", ["--person_id", "0", "--fps_source", "60", "--start_origin",
              "0"])], ids=["fbx", "glb", "fbx_opts", "glb_opts"])
def test_cli_matches_gaitlab(tmp_path, demo_pkl, ext, extra, capsys):
    outs = {}
    for name, main in (("pt", lambda a: pt_cli.main(a, device="cpu")),
                       ("jax", jax_cli.main)):
        outs[name] = str(tmp_path / name / f"anim{ext}")
        assert main(["--input", demo_pkl, "--output", outs[name],
                     *extra]) == 0
    printed = capsys.readouterr().out
    assert printed.count("Exported") == 2
    if ext == ".fbx":
        assert_fbx_close(pt_fbx.parse_fbx(outs["pt"]),
                         jax_fbx.parse_fbx(outs["jax"]))
    else:
        assert_glb_close(outs["pt"], outs["jax"])


def test_cli_errors_match_gaitlab(tmp_path, demo_pkl):
    for argv in (["--input", str(tmp_path / "none.pkl"), "--output",
                  str(tmp_path / "a.fbx")],
                 ["--input", demo_pkl, "--output", str(tmp_path / "a.obj")],
                 ["--input", demo_pkl, "--output", str(tmp_path / "a.fbx"),
                  "--person_id", "7"]):
        assert pt_cli.main(argv, device="cpu") == jax_cli.main(argv) == 1


def test_export_from_pkl_matches_gaitlab(tmp_path, demo_pkl):
    got = pt_export.export_from_pkl(demo_pkl, str(tmp_path / "pt.glb"),
                                    device="cpu")
    want = jax_export.export_from_pkl(demo_pkl, str(tmp_path / "jax.glb"))
    assert_glb_close(got, want)
