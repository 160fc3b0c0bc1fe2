"""gaitlab_torch's batch_generation against gaitlab's on the CPU: the
joint database from the PNG folder and with --stream, sharding and
--resume, the failed-clip list, the 1-medoid bbox and the OpenPose
ingestion.

Both packages get the same small model (tests/test_torch_models.tiny_pair)
through their demo's `load_model`, at 64-pixel crops and bucket 16, in
float32. The shards must hold the same vid_name and bbox, and joints3D
within assert_close's rtol 1e-4 / atol 1e-5 (the model outputs' tolerance
of test_torch_models.py). The medoid index must be equal.
"""

import os
import os.path as osp
import tempfile

import cv2
import joblib
import numpy as np
import pytest
import scipy.io as sio

from gaitlab.body import smpl as jax_smpl
from gaitlab.cli import batch_generation as jax_bg
from gaitlab.cli import demo as jax_demo
from gaitlab.nn.grnet import GRNet as JaxGRNet
from gaitlab.pipeline import medoids as jax_medoids
from gaitlab.pipeline import openpose as jax_openpose
from gaitlab.pipeline.runner import GRNetRunner as JaxRunner
from gaitlab_torch.cli import batch_generation as pt_bg
from gaitlab_torch.cli import demo as pt_demo
from gaitlab_torch.pipeline import medoids as pt_medoids
from gaitlab_torch.pipeline import openpose as pt_openpose
from gaitlab_torch.pipeline.runner import GRNetRunner as PtRunner
from test_torch_models import assert_close, tiny_pair

CROP = 64
BUCKETS = "16"
# (name, fps, frames written, bbox rows or None): a clip at 20 fps; one at
# 30 fps resampled to 20 (20 frames) whose annotation is 3 frames short,
# so its bboxes are realigned; one without an annotation, skipped
CLIPS = (("a091b001c001d001", 20.0, 24, 24),
         ("a091b001c001d002", 30.0, 30, 17),
         ("a091b001c001d003", 20.0, 12, None))
SHARD_KEYS = {"vid_name", "bbox", "joints3D"}


def write_clip(path: str, fps: float, n: int, seed: int, size=(160, 120)):
    w, h = size
    rng = np.random.default_rng(seed)
    bg = rng.integers(40, 70, size=(h, w, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    for i in range(n):
        frame = bg.copy()
        x = 10 + 3 * i
        cv2.rectangle(frame, (x, 20), (x + 30, 100), (200, 180, 170), -1)
        writer.write(frame)
    writer.release()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The clips' folder and their bbox database (joblib, as gaitlab's
    openpose ingestion writes it)."""
    d = tmp_path_factory.mktemp("torch_batchgen")
    vids = d / "vids"
    vids.mkdir()
    annos = {}
    for i, (name, fps, n, rows) in enumerate(CLIPS):
        write_clip(str(vids / f"{name}.mp4"), fps, n, seed=i)
        if rows is not None:
            cx = np.linspace(25.0, 25.0 + 3 * rows, rows)
            annos[name] = np.stack(
                [cx, np.full(rows, 60.0), np.full(rows, 90.0),
                 np.full(rows, 90.0)], 1).astype(np.float32)
    bbox_path = str(d / "bbox.json")
    joblib.dump(annos, bbox_path)
    return d, str(vids), bbox_path


@pytest.fixture(scope="module")
def models():
    module, variables, port = tiny_pair(seed=11)
    jax_model = JaxGRNet(module=module, variables=variables,
                         smpl=jax_smpl.synthetic_smpl_params())
    return jax_model, port


@pytest.fixture
def patched(models, monkeypatch):
    """Both demos' load_model return the shared small model."""
    jax_model, port = models
    monkeypatch.setattr(jax_demo, "load_model",
                        lambda args, cfg=None, init_img=224: jax_model)
    monkeypatch.setattr(pt_demo, "load_model", lambda args, cfg: port)
    monkeypatch.setenv("GAITLAB_BUCKETS", BUCKETS)


def run(bg, corpus, out: str, **kw) -> int:
    _, vids, bbox_path = corpus
    return bg.prepare_data(fv=bbox_path, vid_folder=vids, outpath=out,
                           pretrained_file=None, precision="float32",
                           cpu_only=True, crop_size=CROP, **kw)


def merged(paths) -> dict:
    """{vid_name: (bbox, joints3D)} over shard files read with joblib."""
    out = {}
    for p in paths:
        db = joblib.load(p)
        assert set(db) == SHARD_KEYS
        for name in dict.fromkeys(db["vid_name"].tolist()):
            sel = db["vid_name"] == name
            assert name not in out, f"{name} in two shards"
            out[name] = (db["bbox"][sel], db["joints3D"][sel])
    return out


@pytest.fixture(scope="module")
def databases(corpus, models, tmp_path_factory):
    """gaitlab's and the port's databases, from the folder and --stream."""
    mp = pytest.MonkeyPatch()
    jax_model, port = models
    mp.setattr(jax_demo, "load_model",
               lambda args, cfg=None, init_img=224: jax_model)
    mp.setattr(pt_demo, "load_model", lambda args, cfg: port)
    mp.setenv("GAITLAB_BUCKETS", BUCKETS)
    d = tmp_path_factory.mktemp("torch_batchgen_db")
    dbs = {}
    try:
        for tag, stream in (("folder", False), ("stream", True)):
            for pkg, bg in (("pt", pt_bg), ("jax", jax_bg)):
                out = str(d / f"{pkg}_{tag}.json")
                assert run(bg, corpus, out, stream=stream) == 1
                assert not osp.exists(out[:-5] + "_failed.json")
                dbs[pkg, tag] = joblib.load(out[:-5] + "_0.json")
    finally:
        mp.undo()
    return dbs


@pytest.mark.parametrize("tag", ["folder", "stream"])
def test_database_matches_gaitlab(databases, tag):
    got, want = databases["pt", tag], databases["jax", tag]
    assert set(got) == set(want) == SHARD_KEYS
    np.testing.assert_array_equal(got["vid_name"], want["vid_name"])
    # clip 1: 24 frames; clip 2: 30 fps -> 20 frames, bboxes realigned
    assert list(dict.fromkeys(got["vid_name"].tolist())) == [
        CLIPS[0][0], CLIPS[1][0]]
    assert (got["vid_name"] == CLIPS[1][0]).sum() == 20
    np.testing.assert_array_equal(got["bbox"], want["bbox"])
    assert got["joints3D"].shape == (44, 25, 3)
    assert got["joints3D"].dtype == np.float32
    assert_close(got["joints3D"], want["joints3D"], rtol=1e-4, atol=1e-5,
                 what=f"{tag} joints3D")


def test_stream_matches_the_folder_run(databases):
    folder, stream = databases["pt", "folder"], databases["pt", "stream"]
    np.testing.assert_array_equal(stream["vid_name"], folder["vid_name"])
    np.testing.assert_array_equal(stream["bbox"], folder["bbox"])
    assert_close(stream["joints3D"], folder["joints3D"], rtol=1e-4,
                 atol=1e-5, what="stream vs folder")


def test_two_shards_cover_the_corpus_and_resume(corpus, patched, databases,
                                                tmp_path, monkeypatch):
    """Worker k takes every second clip in name order; the two workers'
    files never share a name and merge to the one-worker database.
    --resume leaves an existing shard untouched and runs no clip of it."""
    out = str(tmp_path / "db.json")
    for k in (0, 1):
        assert run(pt_bg, corpus, out, stream=True, num_shards=2,
                   shard_id=k) == 1
    # worker 0: clips 1 and 3 (no annotation); worker 1: clip 2
    files = sorted(os.listdir(tmp_path))
    assert files == ["db.w0_0.json", "db.w1_0.json"]
    shards = merged([str(tmp_path / f) for f in files])
    ref = databases["pt", "stream"]
    assert set(shards) == {CLIPS[0][0], CLIPS[1][0]}
    for name, (bbox, joints) in shards.items():
        sel = ref["vid_name"] == name
        np.testing.assert_array_equal(bbox, ref["bbox"][sel])
        assert_close(joints, ref["joints3D"][sel], rtol=1e-4, atol=1e-5,
                     what=name)

    first = tmp_path / "db.w0_0.json"
    mtime = first.stat().st_mtime_ns
    calls = []
    monkeypatch.setattr(pt_bg, "run_grnet_on_frames",
                        lambda *a: calls.append(a))
    assert run(pt_bg, corpus, out, stream=True, num_shards=2, shard_id=0,
               resume=True) == 0
    assert calls == [] and first.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("num_shards", [1, 2])
def test_flushes_keep_the_tail_together(tmp_path, monkeypatch, num_shards):
    """13 clips a shard each ($GAITLAB_BG_MAXVID=1): a flush before clips
    1 and 2, none once 10 or fewer remain, so the last 11 share a shard;
    names as gaitlab's _shard_path gives them. With --resume an existing
    shard is skipped and left as it is. The clips' input and model are
    stubbed: this is the loop's bookkeeping alone."""
    monkeypatch.setenv("GAITLAB_BG_MAXVID", "1")
    monkeypatch.setattr(pt_demo, "load_model", lambda args, cfg: None)
    vids = tmp_path / "vids"
    vids.mkdir()
    names = [f"a001b001c001d{i:03d}" for i in range(13 * num_shards)]
    for n in names:
        (vids / f"{n}.mp4").touch()
    bbox_path = str(tmp_path / "bbox.json")
    joblib.dump({n: np.zeros((2, 4), np.float32) for n in names}, bbox_path)
    ran = []

    def fake_prepare(path, anno, stream):
        ran.append(osp.basename(path))
        return None, np.asarray(anno), None

    monkeypatch.setattr(pt_bg, "_prepare_clip", fake_prepare)
    monkeypatch.setattr(pt_bg, "run_grnet_on_frames",
                        lambda runner, src, bb: np.zeros((len(bb), 25, 3)))
    out = str(tmp_path / "db.json")
    want = [pt_bg._shard_path(out, k, num_shards, 0) for k in range(3)]
    assert want == [jax_bg._shard_path(out, k, num_shards, 0)
                    for k in range(3)]
    joblib.dump({"untouched": True}, want[1])
    assert pt_bg.prepare_data(bbox_path, str(vids), out, resume=True,
                              cpu_only=True, num_shards=num_shards) == 3
    mine = names[::num_shards]
    assert ran == [f"{n}.mp4" for n in mine[:1] + mine[2:]]
    assert joblib.load(want[1]) == {"untouched": True}
    sizes = [len(set(joblib.load(p)["vid_name"].tolist()))
             for p in (want[0], want[2])]
    assert sizes == [1, 11]


def test_frame_mismatch_is_quarantined_in_both(models, patched, tmp_path):
    """A clip whose frames are MIN_FDIFF or more off its bboxes, and one
    that cannot be opened, go to _failed.json in both packages, with the
    same entries; the good clip is still written."""
    vids = tmp_path / "vids"
    vids.mkdir()
    write_clip(str(vids / "a092b001c001d001.mp4"), 20.0, 20, seed=3)
    write_clip(str(vids / "a092b001c001d002.mp4"), 20.0, 20, seed=4)
    (vids / "a092b001c001d003.mp4").write_bytes(b"not a video")
    bb = np.tile(np.array([60.0, 60.0, 90.0, 90.0], np.float32), (20, 1))
    annos = {"a092b001c001d001": bb, "a092b001c001d002": bb[:8],
             "a092b001c001d003": bb}
    bbox_path = str(tmp_path / "bbox.json")
    joblib.dump(annos, bbox_path)
    failed = {}
    for pkg, bg in (("pt", pt_bg), ("jax", jax_bg)):
        out = str(tmp_path / f"{pkg}.json")
        assert bg.prepare_data(fv=bbox_path, vid_folder=str(vids),
                               outpath=out, pretrained_file=None,
                               precision="float32", cpu_only=True,
                               crop_size=CROP, stream=True) == 1
        failed[pkg] = joblib.load(out[:-5] + "_failed.json")
        db = joblib.load(out[:-5] + "_0.json")
        assert set(db["vid_name"].tolist()) == {"a092b001c001d001"}
    assert failed["pt"] == failed["jax"]
    assert [f["vid_name"] for f in failed["pt"]] == [
        "a092b001c001d002.mp4", "a092b001c001d003.mp4"]
    assert failed["pt"][0]["error"] == "frame mismatch: 20 vs 8"


def test_a_fault_of_the_forward_is_not_quarantined(corpus, patched,
                                                   tmp_path, monkeypatch):
    """An error raised by the model's forward (as a kernel's or the card's
    would be) stops the run instead of marking the clip as failed."""
    def broken(self, *a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(PtRunner, "_forward_bucket", broken)
    for stream in (False, True):
        out = str(tmp_path / f"db{int(stream)}.json")
        with pytest.raises(RuntimeError, match="illegal memory access"):
            run(pt_bg, corpus, out, stream=stream)
        assert not osp.exists(out[:-5] + "_failed.json")
    # the clip's PNG folder was removed all the same
    assert not osp.exists(osp.join(tempfile.gettempdir(),
                                   f"{CLIPS[0][0]}_mp4_mpt"))


def test_a_short_decode_is_quarantined_unless_the_forward_failed(
        corpus, patched, tmp_path, monkeypatch):
    """A video that decodes fewer frames than it reports (here: reported
    4 more) is a clip input fault found late: listed as failed, the run
    goes on. Had a forward failed before it, that error raises instead."""
    from gaitlab_torch.pipeline import video as pt_video

    info = pt_video.get_video_info
    monkeypatch.setattr(pt_video, "get_video_info", lambda path: (
        info(path)[0] + 4,) + info(path)[1:])
    out = str(tmp_path / "db.json")
    assert run(pt_bg, corpus, out, stream=True) == 0
    failed = joblib.load(out[:-5] + "_failed.json")
    assert [f["error"] for f in failed] == ["24 frames for 28 bboxes",
                                            "20 frames for 23 bboxes"]

    def broken(self, *a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(PtRunner, "_forward_bucket", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run(pt_bg, corpus, str(tmp_path / "db2.json"), stream=True)


def test_precision_other_than_float32_is_not_ported(corpus, patched,
                                                    databases, tmp_path):
    """--precision reaches the runner and runs: "default" (one TF32 pass on
    the card) computes in float32 on the CPU, so its database is the
    float32 run's; a precision the runner does not know fails before any
    work."""
    def args(precision, name):
        return pt_bg.build_parser().parse_args(
            ["--vid_folder", corpus[1], "--bbox_path", corpus[2],
             "--outpath", str(tmp_path / name), "--precision", precision,
             "--cpu_only", "--crop_size", str(CROP)])

    seen = []
    real = PtRunner.__post_init__

    def post_init(self):
        real(self)
        seen.append((self.precision, self.resolved_head_precision()))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PtRunner, "__post_init__", post_init)
        pt_bg.main(args("default", "db.json"))
    assert seen == [("default", None)]
    got = joblib.load(str(tmp_path / "db_0.json"))
    want = databases["pt", "folder"]
    np.testing.assert_array_equal(got["vid_name"], want["vid_name"])
    assert_close(got["joints3D"], want["joints3D"], rtol=1e-6, atol=1e-7,
                 what="joints3D at default")
    with pytest.raises(ValueError, match="precision"):
        pt_bg.prepare_data(fv=corpus[2], vid_folder=corpus[1],
                           outpath=str(tmp_path / "db2.json"),
                           precision="bf16", cpu_only=True, crop_size=CROP)
    assert sorted(os.listdir(tmp_path)) == ["db_0.json"]

def test_parsers_have_the_same_flags():
    def flags(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.type)
                for a in parser._actions if a.dest not in ("help", "outpath")}

    assert flags(pt_bg.build_parser()) == flags(jax_bg.build_parser())
    assert (pt_bg.MIN_FDIFF, pt_bg.MAX_seqlen, pt_bg.MAX_VID,
            pt_bg.EXTRACT_FPS) == (jax_bg.MIN_FDIFF, jax_bg.MAX_seqlen,
                                   jax_bg.MAX_VID, jax_bg.EXTRACT_FPS)
    for name in ("a001b002c003d004.mp4", "clip.mp4", "a1.mp4"):
        assert pt_bg._sort_key(name) == jax_bg._sort_key(name)


def test_fetch_kp_3d_reads_back_only_the_joints(models, corpus):
    """GRNetRunner(fetch=("kp_3d",)).run_track gives only joints3d, in both
    packages, and the same joints as the default fetch."""
    jax_model, port = models
    frames = np.random.default_rng(5).integers(
        0, 255, (20, 96, 128, 3), dtype=np.uint8)
    bbox = np.tile(np.array([64.0, 48.0, 80.0, 80.0], np.float32), (20, 1))
    outs = {}
    for tag, make in (("pt", lambda **kw: PtRunner(port, **kw)),
                      ("jax", lambda **kw: JaxRunner(
                          jax_model, precision="float32", **kw))):
        kw = dict(crop_size=CROP, buckets=(16,))
        outs[tag] = make(fetch=("kp_3d",), **kw).run_track(frames, bbox)
        assert set(outs[tag]) == {"joints3d"}
        full = make(**kw).run_track(frames, bbox)
        assert {"pred_cam", "pose", "betas", "verts", "joints3d",
                "joints2d"} == set(full)
        np.testing.assert_array_equal(outs[tag]["joints3d"],
                                      full["joints3d"])
    assert_close(outs["pt"]["joints3d"], outs["jax"]["joints3d"],
                 rtol=1e-4, atol=1e-5, what="joints3d")


@pytest.mark.parametrize("shape", [(300, 3), (1030, 2), (10000, 3)],
                         ids=["300x3", "1030x2_tail", "10000x3_max_seqlen"])
def test_medoid_matches_gaitlab(shape):
    pts = np.random.default_rng(shape[0]).normal(size=shape).astype(
        np.float32)
    got = pt_medoids.medoid_1(pts, device="cpu")
    assert got == int(jax_medoids.medoid_1(pts))
    if shape[0] <= 1030:  # the float64 answer, where it is cheap
        d = np.linalg.norm(pts[:, None].astype(np.float64) - pts[None],
                           axis=-1)
        assert got == int(np.argmin(d.sum(1)))


def test_medoid_ties_go_to_the_first_index():
    pts = np.array([[0, 0], [1, 0], [1, 0], [2, 0]], np.float32)
    assert pt_medoids.medoid_1(pts, chunk=3, device="cpu") == 1


@pytest.mark.parametrize("span", [600, 200], ids=["large", "below_MIN_PIXEL"])
def test_bbox_from_joints2d_matches_gaitlab(span):
    rng = np.random.default_rng(span)
    kp = np.zeros((30, 25, 3), np.float32)
    kp[:, :, 0] = rng.uniform(800, 800 + span, (30, 25))
    kp[:, :, 1] = rng.uniform(300, 300 + span, (30, 25))
    kp[:, :, 2] = rng.uniform(0.2, 1.0, (30, 25))
    kp[3, 5, 2] = 0.01  # a low-confidence joint, replaced
    for smooth in (False, True):
        got = pt_medoids.get_bbox_from_joints2d(kp.copy(), smooth=smooth,
                                                device="cpu")
        want = jax_medoids.get_bbox_from_joints2d(kp.copy(), smooth=smooth)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # 1.1 x the median height, then x BS below MIN_PIXEL
    assert (got[0, 2] > pt_medoids.MIN_PIXEL) == (span == 600)


def test_load_openpose_anno_matches_gaitlab(tmp_path):
    """.mat skeletons: two with a dominant person, one with two near-equal
    persons (the larger bbox wins), an empty one and one without a usable
    frame (both listed as bad), and an interaction action (dropped)."""
    anno = tmp_path / "openpose"
    anno.mkdir()
    rng = np.random.default_rng(0)

    def person(n, x0, y0, span, conf):
        sk = np.zeros((n, 25, 3))
        sk[:, :, 0] = rng.uniform(x0, x0 + span, (n, 25))
        sk[:, :, 1] = rng.uniform(y0, y0 + span, (n, 25))
        sk[:, :, 2] = conf
        return sk

    two = np.stack([person(40, 0.3, 0.2, 0.3, 0.9),
                    person(40, 0.1, 0.1, 0.1, 0.1)])
    close = np.stack([person(30, 0.2, 0.2, 0.2, 0.8),
                      person(30, 0.5, 0.1, 0.4, 0.805)])
    none = person(20, 0.3, 0.3, 0.2, 0.9)[None]
    none[0, :, :22, 2] = 0.0  # 3 confident joints a frame: not more than M
    files = {"a001_clip1.mat": two, "a003_clip3.mat": close,
             "a002_clip2.mat": np.zeros((0, 0, 0, 0)),
             "a004_clip4.mat": none, "a44_clip5.mat": two,
             "a005_clip6.mat": person(25, 0.4, 0.3, 0.2, 0.7)[None]}
    for name, sk in files.items():
        sio.savemat(str(anno / name), {"skeleton": sk})
    res = {}
    for pkg, mod, kw in (("pt", pt_openpose, {"device": "cpu"}),
                         ("jax", jax_openpose, {})):
        out = mod.load_openpose_anno(str(anno), str(tmp_path / f"{pkg}.json"),
                                     str(tmp_path / f"{pkg}_bad.json"), **kw)
        assert joblib.load(str(tmp_path / f"{pkg}.json")).keys() == out.keys()
        res[pkg] = (out, joblib.load(str(tmp_path / f"{pkg}_bad.json")))
    (got, got_bad), (want, want_bad) = res["pt"], res["jax"]
    assert list(got) == list(want) == ["a001_clip1", "a003_clip3",
                                       "a005_clip6"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-5)
    assert got_bad == want_bad == ["a002_clip2.mat", "a004_clip4.mat"]
