"""Native binary-FBX (7.4) writer for animated skinned SMPL meshes.

Counterpart of gaitlab/render/fbx.py. The reference exports keyframed
`.fbx` through a full Blender install (lib/utils/fbx_output.py drives
`bpy.ops.export_scene.fbx`); this module emits the FBX 7.4 *binary
container directly*: rest-pose mesh + 24-LimbNode skeleton (reference bone names,
incl. the gendered `m_avg_`/`f_avg_` prefixes Unity SMPL rigs expect) +
per-vertex skin clusters + per-bone Euler rotation AnimationCurves, one
file, no external tooling. `export_glb` (render/export.py) remains the
recommended modern route; this covers pipelines that strictly require
`.fbx` (older Unity/Maya setups, doc/fbx.md workflows).

Format notes (public FBX binary spec, as also implemented by Blender's
io_scene_fbx encoder): 23-byte magic + u32 version, then nested node
records (u32 end-offset, u32 prop-count, u32 prop-bytes, u8 name-len,
name, typed properties, children, 13-byte null sentinel), a top-level
sentinel, and the fixed footer block. Arrays are written uncompressed
(encoding 0). Times are in KTime ticks (46 186 158 000 / s). Euler
angles are degrees in FBX's default eEulerXYZ order (X applied first →
column-form R = Rz·Ry·Rx).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from gaitlab_torch.body import smpl as body_smpl
from gaitlab_torch.render import export as _export

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"
_VERSION = 7400
_NULL_RECORD = b"\x00" * 13
_KTIME = 46186158000  # FBX ticks per second
# Fixed footer ids from the public binary-format spec.
_FOOTER_ID = bytes.fromhex("fabcab09d0c8d466b176fb831cf7267e")
_FOOTER_ID2 = bytes.fromhex("f85a8c6adef5d97eece90ce3758f290b")


# ---------------------------------------------------------------- low level

def _prop(value) -> bytes:
    """Serialize one typed property (scalar, string/bytes, or array)."""
    if isinstance(value, bool):
        return b"C" + struct.pack("<B", int(value))
    if isinstance(value, int):
        return b"L" + struct.pack("<q", value)
    if isinstance(value, float):
        return b"D" + struct.pack("<d", value)
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, bytes):
        return b"S" + struct.pack("<I", len(value)) + value
    if isinstance(value, np.ndarray):
        code = {"float32": b"f", "float64": b"d",
                "int32": b"i", "int64": b"l"}[str(value.dtype)]
        raw = np.ascontiguousarray(value.reshape(-1)).tobytes()
        return (code + struct.pack("<III", value.size, 0, len(raw)) + raw)
    raise TypeError(f"unsupported FBX property type: {type(value)}")


class _Node:
    """One FBX record: name, typed properties, child records."""

    def __init__(self, name: str, *props):
        self.name = name
        self.props = list(props)
        self.children: List[_Node] = []

    def child(self, name: str, *props) -> "_Node":
        node = _Node(name, *props)
        self.children.append(node)
        return node

    def serialize(self, offset: int) -> bytes:
        prop_bytes = b"".join(_prop(p) for p in self.props)
        name = self.name.encode()
        header_len = 13 + len(name)
        body = b""
        child_off = offset + header_len + len(prop_bytes)
        for c in self.children:
            piece = c.serialize(child_off)
            body += piece
            child_off += len(piece)
        if self.children or not self.props:
            body += _NULL_RECORD
            child_off += len(_NULL_RECORD)
        end = offset + header_len + len(prop_bytes) + len(body)
        return (struct.pack("<IIIB", end, len(self.props), len(prop_bytes),
                            len(name)) + name + prop_bytes + body)


def _obj_name(name: str, klass: str) -> bytes:
    """FBX stores object names as `name\\x00\\x01Class`."""
    return name.encode() + b"\x00\x01" + klass.encode()


def write_fbx(root_nodes: List[_Node], out_path: str) -> str:
    """Assemble header + records + sentinel + footer into a .fbx file."""
    blob = _MAGIC + struct.pack("<I", _VERSION)
    for node in root_nodes:
        blob += node.serialize(len(blob))
    blob += _NULL_RECORD
    blob += _FOOTER_ID
    blob += b"\x00" * 4
    pad = -len(blob) % 16 or 16
    blob += b"\x00" * pad
    blob += struct.pack("<I", _VERSION)
    blob += b"\x00" * 120
    blob += _FOOTER_ID2
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path


# ------------------------------------------------------------- math helpers

def _axis_angle_to_rotmat_np(aa: np.ndarray) -> np.ndarray:
    """Host-numpy Rodrigues for (...,3) axis-angle (fbx_output.py:81-93)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.clip(theta, 1e-12, None)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(x)
    K = np.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                 axis=-1).reshape(aa.shape[:-1] + (3, 3))
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + s * K + (1.0 - c) * (K @ K)


def _rotmat_to_euler_xyz_deg(R: np.ndarray) -> np.ndarray:
    """Decompose (...,3,3) as R = Rz·Ry·Rx → degrees in FBX eEulerXYZ.

    Branch handling mirrors the convention check in
    tests/test_fbx.py::test_euler_roundtrip; gimbal rows (|cos y| ≈ 0)
    pin z = 0 and fold the remaining freedom into x.
    """
    sy = np.clip(-R[..., 2, 0], -1.0, 1.0)
    y = np.arcsin(sy)
    gimbal = np.abs(sy) > 1.0 - 1e-7
    x = np.arctan2(R[..., 2, 1], R[..., 2, 2])
    z = np.arctan2(R[..., 1, 0], R[..., 0, 0])
    sign = np.sign(sy)
    x_g = np.arctan2(sign * R[..., 0, 1], sign * R[..., 0, 2])
    x = np.where(gimbal, x_g, x)
    z = np.where(gimbal, 0.0, z)
    return np.degrees(np.stack([x, y, z], axis=-1))


# ------------------------------------------------------------ scene builder

def _translation_matrix16(t: np.ndarray, sign: float = 1.0) -> np.ndarray:
    """Row-vector-convention FBX matrix (translation in elems 12..14)."""
    m = np.eye(4, dtype=np.float64)
    m[3, :3] = sign * np.asarray(t, np.float64)
    return m.reshape(16)


def export_fbx(
    out_path: str,
    pose: np.ndarray,
    betas: np.ndarray,
    smpl_params: Optional[body_smpl.SMPLParams] = None,
    trans: Optional[np.ndarray] = None,
    fps: float = 30.0,
    gender: str = "male",
    device=None,
) -> str:
    """Write an animated skinned SMPL binary FBX.

    Same input contract as `export_glb` (demo pkl schema: pose (T,72)
    axis-angle, betas (10,), optional trans (T,3)); `gender` selects the
    reference's `m_avg_`/`f_avg_` bone-name prefix, any other value
    leaves names bare. The skinning data is computed on `device` (None:
    the card).
    """
    d = _export.anim_skin_data(pose, betas, smpl_params, trans,
                               device=device)
    T, trans = d["T"], d["trans"]
    v = d["v_shaped"].astype(np.float64)
    faces = np.asarray(d["faces"], np.int64)
    joints_rest, parents = d["joints_rest"], d["parents"]
    top4, w4 = d["top4"], d["w4"]

    prefix = {"male": "m_avg_", "female": "f_avg_"}.get(gender, "")
    bone_names = [prefix + n for n in _export.SMPL_BONE_NAMES]

    # per-frame per-joint euler angles from the local axis-angle pose
    R = _axis_angle_to_rotmat_np(
        np.asarray(pose, np.float32).reshape(-1, 3).astype(np.float64))
    eulers = _rotmat_to_euler_xyz_deg(R).reshape(T, 24, 3)
    # unwrap along time so lerped playback never takes the long way
    # around a ±180° flip
    eulers = np.degrees(np.unwrap(np.radians(eulers), axis=0))

    key_time = (np.round(np.arange(T) / fps * _KTIME)).astype(np.int64)
    stop_time = int(round(max(T - 1, 1) / fps * _KTIME))

    ids = iter(range(1_000_000_000, 2_000_000_000))

    # ---- boilerplate sections
    header = _Node("FBXHeaderExtension")
    header.child("FBXHeaderVersion", 1003)
    header.child("FBXVersion", _VERSION)
    header.child("Creator", "gaitlab binary FBX writer")

    gs = _Node("GlobalSettings")
    gs.child("Version", 1000)
    gsp = gs.child("Properties70")
    for name, typ, label, val in [
            ("UpAxis", "int", "Integer", 1),
            ("UpAxisSign", "int", "Integer", 1),
            ("FrontAxis", "int", "Integer", 2),
            ("FrontAxisSign", "int", "Integer", 1),
            ("CoordAxis", "int", "Integer", 0),
            ("CoordAxisSign", "int", "Integer", 1),
            # SMPL is metric: 100 cm per unit
            ("UnitScaleFactor", "double", "Number", 100.0)]:
        gsp.child("P", name, typ, label, "", val)

    doc_id = next(ids)
    docs = _Node("Documents")
    docs.child("Count", 1)
    doc = docs.child("Document", doc_id, "", "Scene")
    doc.child("Properties70")
    doc.child("RootNode", 0)

    refs = _Node("References")

    objects = _Node("Objects")
    connections = _Node("Connections")

    def connect_oo(child_id: int, parent_id: int):
        connections.child("C", "OO", child_id, parent_id)

    def connect_op(child_id: int, parent_id: int, prop: str):
        connections.child("C", "OP", child_id, parent_id, prop)

    # ---- geometry
    geo_id = next(ids)
    geo = objects.child("Geometry", geo_id,
                        _obj_name("smpl", "Geometry"), "Mesh")
    geo.child("GeometryVersion", 124)
    geo.child("Vertices", v.reshape(-1))
    pvi = faces.astype(np.int32).copy()
    pvi[:, 2] = -pvi[:, 2] - 1  # last index of each polygon is bit-flipped
    geo.child("PolygonVertexIndex", pvi.reshape(-1))

    # ---- mesh model
    mesh_id = next(ids)
    mesh = objects.child("Model", mesh_id,
                         _obj_name("smpl_mesh", "Model"), "Mesh")
    mesh.child("Version", 232)
    mesh.child("Properties70")
    mesh.child("Shading", True)
    mesh.child("Culling", "CullingOff")
    connect_oo(geo_id, mesh_id)
    connect_oo(mesh_id, 0)

    # ---- skeleton (24 LimbNodes, reference bone order)
    bone_ids = []
    for j, name in enumerate(bone_names):
        bid = next(ids)
        bone_ids.append(bid)
        local_t = joints_rest[j] - (joints_rest[parents[j]]
                                    if j else np.zeros(3))
        bone = objects.child("Model", bid, _obj_name(name, "Model"),
                             "LimbNode")
        bone.child("Version", 232)
        bp = bone.child("Properties70")
        bp.child("P", "Lcl Translation", "Lcl Translation", "", "A",
                 float(local_t[0]), float(local_t[1]), float(local_t[2]))
        bp.child("P", "Lcl Rotation", "Lcl Rotation", "", "A",
                 0.0, 0.0, 0.0)
        bone.child("Shading", True)
        bone.child("Culling", "CullingOff")
        attr_id = next(ids)
        attr = objects.child("NodeAttribute", attr_id,
                             _obj_name("", "NodeAttribute"), "LimbNode")
        attr.child("TypeFlags", "Skeleton")
        connect_oo(attr_id, bid)
    for j, bid in enumerate(bone_ids):
        connect_oo(bid, bone_ids[parents[j]] if j else 0)

    # ---- skin deformer + one cluster per joint
    skin_id = next(ids)
    skin = objects.child("Deformer", skin_id,
                         _obj_name("", "Deformer"), "Skin")
    skin.child("Version", 101)
    skin.child("Link_DeformAcuracy", 50.0)
    connect_oo(skin_id, geo_id)
    for j, bid in enumerate(bone_ids):
        vert_sel, infl_sel = np.where(top4 == j)
        weights = w4[vert_sel, infl_sel].astype(np.float64)
        keep = weights > 0
        cid = next(ids)
        cluster = objects.child("Deformer", cid,
                                _obj_name("", "SubDeformer"), "Cluster")
        cluster.child("Version", 100)
        cluster.child("Indexes", vert_sel[keep].astype(np.int32))
        cluster.child("Weights", weights[keep])
        cluster.child("Transform",
                      _translation_matrix16(joints_rest[j], sign=-1.0))
        cluster.child("TransformLink",
                      _translation_matrix16(joints_rest[j]))
        connect_oo(cid, skin_id)
        connect_oo(bid, cid)

    # ---- animation: stack -> layer -> per-bone R curve node -> 3 curves
    stack_id = next(ids)
    stack = objects.child("AnimationStack", stack_id,
                          _obj_name("gait", "AnimStack"), "")
    sp = stack.child("Properties70")
    sp.child("P", "LocalStop", "KTime", "Time", "", stop_time)
    sp.child("P", "ReferenceStop", "KTime", "Time", "", stop_time)

    layer_id = next(ids)
    objects.child("AnimationLayer", layer_id,
                  _obj_name("base", "AnimLayer"), "").child(
                      "Properties70")
    connect_oo(layer_id, stack_id)

    def add_curves(values_txyz: np.ndarray, target_model: int, prop: str):
        """One CurveNode with d|X/Y/Z curves keyed at key_time."""
        cn_id = next(ids)
        cn = objects.child("AnimationCurveNode", cn_id,
                           _obj_name(prop[0], "AnimCurveNode"), "")
        cnp = cn.child("Properties70")
        for axis, comp in enumerate("XYZ"):
            cnp.child("P", f"d|{comp}", "Number", "", "A",
                      float(values_txyz[0, axis]))
        connect_oo(cn_id, layer_id)
        connect_op(cn_id, target_model,
                   "Lcl Rotation" if prop == "R" else "Lcl Translation")
        for axis, comp in enumerate("XYZ"):
            curve_id = next(ids)
            curve = objects.child("AnimationCurve", curve_id,
                                  _obj_name("", "AnimCurve"), "")
            curve.child("Default", float(values_txyz[0, axis]))
            curve.child("KeyVer", 4008)
            curve.child("KeyTime", key_time)
            curve.child("KeyValueFloat",
                        values_txyz[:, axis].astype(np.float32))
            curve.child("KeyAttrFlags", np.array([24836], np.int32))
            curve.child("KeyAttrDataFloat", np.zeros(4, np.float32))
            curve.child("KeyAttrRefCount", np.array([T], np.int32))
            connect_op(curve_id, cn_id, f"d|{comp}")

    for j, bid in enumerate(bone_ids):
        add_curves(eulers[:, j], bid, "R")
    # pelvis root translation (reference trans handling,
    # fbx_output.py:128-133): keyed on the pelvis LimbNode
    add_curves(trans.astype(np.float64) + joints_rest[0][None],
               bone_ids[0], "T")

    # ---- definitions (object-type counts)
    counts = {}
    for node in objects.children:
        counts[node.name] = counts.get(node.name, 0) + 1
    defs = _Node("Definitions")
    defs.child("Version", 100)
    defs.child("Count", sum(counts.values()) + 1)
    defs.child("ObjectType", "GlobalSettings").child("Count", 1)
    for name, n in sorted(counts.items()):
        defs.child("ObjectType", name).child("Count", n)

    takes = _Node("Takes")
    takes.child("Current", "")

    return write_fbx([header, gs, docs, refs, defs, objects,
                      connections, takes], out_path)


# The pkl -> fbx entry contract lives in gaitlab_torch/cli/fbx_output.py,
# which owns person selection, fps decimation,
# trans handling, and the .fbx/.glb extension dispatch — this module only
# provides export_fbx (pose/betas -> file).

# ------------------------------------------------------------------ reader

def parse_fbx(path: str) -> dict:
    """Parse a binary FBX back into nested dicts (validation reader).

    Independent of the writer's _Node tree: walks the byte format from
    the spec so tests catch container-level mistakes (offsets, sentinel
    placement, property encodings).
    """
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", blob, len(_MAGIC))[0]

    def read_props(data: bytes, n: int):
        props, off = [], 0
        for _ in range(n):
            code = data[off:off + 1]
            off += 1
            if code in b"CILFDY":
                fmt = {b"C": "<B", b"I": "<i", b"L": "<q", b"F": "<f",
                       b"D": "<d", b"Y": "<h"}[code]
                props.append(struct.unpack_from(fmt, data, off)[0])
                off += struct.calcsize(fmt)
            elif code in b"SR":
                ln = struct.unpack_from("<I", data, off)[0]
                props.append(data[off + 4:off + 4 + ln])
                off += 4 + ln
            elif code in b"fdilb":
                ln, enc, nbytes = struct.unpack_from("<III", data, off)
                off += 12
                raw = data[off:off + nbytes]
                off += nbytes
                if enc:
                    import zlib

                    raw = zlib.decompress(raw)
                dt = {b"f": np.float32, b"d": np.float64, b"i": np.int32,
                      b"l": np.int64, b"b": np.uint8}[code]
                props.append(np.frombuffer(raw, dt))
            else:
                raise ValueError(f"unknown property code {code!r}")
        return props

    def read_node(off: int):
        end, n_props, prop_len, name_len = struct.unpack_from(
            "<IIIB", blob, off)
        if end == 0:
            return None, off + 13
        name = blob[off + 13:off + 13 + name_len].decode()
        off2 = off + 13 + name_len
        props = read_props(blob[off2:off2 + prop_len], n_props)
        off2 += prop_len
        children = []
        while off2 < end:
            child, off2 = read_node(off2)
            if child is None:  # null sentinel closes this record
                break
            children.append(child)
        return {"name": name, "props": props, "children": children}, end

    nodes, off = [], len(_MAGIC) + 4
    while True:
        node, off = read_node(off)
        if node is None:
            break
        nodes.append(node)
    return {"version": version, "nodes": nodes}


def find_nodes(tree, name: str):
    """All nodes named `name` anywhere in a parse_fbx tree."""
    out = []
    stack = list(tree["nodes"]) if isinstance(tree, dict) and \
        "nodes" in tree else [tree]
    while stack:
        node = stack.pop()
        if node["name"] == name:
            out.append(node)
        stack.extend(node["children"])
    return out
