"""FBX (ASCII 7.x + binary/Kaydara) mocap import → motion dicts (a numpy
copy of emloco_tpu/kinematics/fbx.py).

Counterpart of poselib's fbx backend (pacer's
poselib/skeleton/backend/fbx/fbx_read_wrapper.py — a python-2.7 subprocess around the proprietary
Autodesk FBX SDK returning (joint_names, parents, transforms, fps), consumed
by SkeletonMotion.from_fbx, skeleton3d.py:1195+). Both containers of the
same scene graph are parsed with no external dependency — the documented
ASCII form below, and the Kaydara binary form (`parse_fbx_binary`: typed
node records with zlib-deflated arrays, 32-bit headers < v7500 and 64-bit
from v7500) which is what the SDK-written .fbx files actually use. Both
parsers produce the same FbxNode tree:

  Objects/Model ("LimbNode") nodes   → joints (name, id)
  Connections "OO" model→model       → parent tree
  Properties70 "Lcl Translation"     → rest-pose local offsets
  AnimationCurveNode —"OP"→ model    → which local property animates
  AnimationCurve (KeyTime/KeyValueFloat) —"OP" d|X/Y/Z→ curve node
                                     → per-axis keyframes (KTIME ticks)

Curves are sampled on a uniform clock (linear interpolation between keys,
constant extrapolation), Euler degrees composed per the model's
RotationOrder property (default eOrderXYZ), then conformed onto the
canonical 24-joint SMPL skeleton exactly like the BVH door (bvh.load_bvh):
the result is a motion dict {pose_aa (F,72), root_trans_offset (F,3), beta,
fps} ready for kinematics.motion_lib.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

# FBX time unit: 1/46186158000 s (FbxTime ktime)
KTIME_PER_SECOND = 46_186_158_000

# FBX ERotationOrder enum → channel sequence for INTRINSIC post-multiply
# composition (bvh._euler_to_aa). eOrderXYZ applies X first extrinsically,
# i.e. R = Rz·Ry·Rx — intrinsic composition of the REVERSED sequence.
_ROTATION_ORDERS = {
    0: "ZYX",  # eOrderXYZ
    1: "YZX",  # eOrderXZY
    2: "XZY",  # eOrderYZX
    3: "ZXY",  # eOrderYXZ
    4: "YXZ",  # eOrderZXY
    5: "XYZ",  # eOrderZYX
}

_TOKEN = re.compile(
    r'"(?:[^"\\]|\\.)*"'      # quoted string
    r"|[{}:,]"                # structure
    r"|[^\s{}:,\"]+"          # bare word / number
)


class FbxNode:
    __slots__ = ("name", "values", "children")

    def __init__(self, name: str, values: List, children: List["FbxNode"]):
        self.name = name
        self.values = values
        self.children = children

    def find(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]

    def first(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None


def _strip_comments(text: str) -> str:
    return "\n".join(line.split(";", 1)[0] for line in text.splitlines())


def _atom(tok: str):
    if tok.startswith('"'):
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


def parse_fbx_ascii(text: str) -> FbxNode:
    """ASCII FBX document → root FbxNode (name ''), recursive descent over
    the `Name: v, v { children }` grammar (arrays appear as an `a:` child)."""
    toks = _TOKEN.findall(_strip_comments(text))
    i = 0

    def parse_block(closing: bool):
        nonlocal i
        children = []
        while i < len(toks):
            if toks[i] == "}":
                if not closing:
                    raise ValueError("FBX parse: unbalanced '}'")
                i += 1
                return children
            name = toks[i]
            i += 1
            if i >= len(toks) or toks[i] != ":":
                raise ValueError(f"FBX parse: expected ':' after {name!r}")
            i += 1
            values: List = []
            # values: atoms separated by commas, until '{', '}', or the next
            # `ident :` pair
            while i < len(toks):
                t = toks[i]
                if t in ("{", "}"):
                    break
                if t == ",":
                    i += 1
                    continue
                if (i + 1 < len(toks) and toks[i + 1] == ":"
                        and values and toks[i - 1] != ","):
                    break                      # next sibling node
                values.append(_atom(t))
                i += 1
            kids = []
            if i < len(toks) and toks[i] == "{":
                i += 1
                kids = parse_block(True)
            children.append(FbxNode(name, values, kids))
        if closing:
            raise ValueError("FBX parse: missing '}'")
        return children

    return FbxNode("", [], parse_block(False))


# ---------------------------------------------------------------------------
# Binary (Kaydara) container
# ---------------------------------------------------------------------------

BINARY_MAGIC = b"Kaydara FBX Binary  \x00"

# scalar property type code → struct format
_BIN_SCALAR = {b"Y": "<h", b"C": "<b", b"I": "<i", b"F": "<f",
               b"D": "<d", b"L": "<q"}
# array property type code → element struct char
_BIN_ARRAY = {b"f": "f", b"d": "d", b"l": "q", b"i": "i", b"b": "b"}


def _bin_str(raw: bytes) -> str:
    """Binary name strings store "name\\x00\\x01Class" — the ASCII form is
    "Class::name" (see _model_name)."""
    if b"\x00\x01" in raw:
        name, cls = raw.split(b"\x00\x01", 1)
        return f"{cls.decode('latin-1')}::{name.decode('latin-1')}"
    return raw.decode("latin-1")


def parse_fbx_binary(data: bytes) -> FbxNode:
    """Kaydara binary FBX → the same FbxNode tree parse_fbx_ascii builds.

    Node record: endOffset, numProperties, propertyListLen (uint32, or
    uint64 from FBXVersion 7500), uint8 nameLen, name; then typed properties
    (scalars Y/C/I/F/D/L, zlib-optional arrays f/d/l/i/b, strings S, raw R);
    then nested children terminated by an all-zero sentinel record. Array
    properties surface as plain python numbers in node.values so the ASCII
    consumers (_array_values fallback path) read them unchanged."""
    import struct
    import zlib

    if not data.startswith(BINARY_MAGIC):
        raise ValueError("not a binary FBX (bad magic)")
    version = struct.unpack_from("<I", data, len(BINARY_MAGIC) + 2)[0]
    big = version >= 7500
    head_fmt = "<QQQB" if big else "<IIIB"
    head_sz = struct.calcsize(head_fmt)
    sentinel = head_sz                                  # all-zero record

    def read_props(pos: int, count: int) -> Tuple[List, int]:
        vals: List = []
        for _ in range(count):
            t = data[pos:pos + 1]
            pos += 1
            if t in _BIN_SCALAR:
                fmt = _BIN_SCALAR[t]
                (v,) = struct.unpack_from(fmt, data, pos)
                pos += struct.calcsize(fmt)
                vals.append(bool(v) if t == b"C" else
                            float(v) if t in (b"F", b"D") else int(v))
            elif t in _BIN_ARRAY:
                n, enc, clen = struct.unpack_from("<III", data, pos)
                pos += 12
                raw = data[pos:pos + clen]
                pos += clen
                if enc == 1:
                    raw = zlib.decompress(raw)
                arr = np.frombuffer(raw, dtype="<" + _BIN_ARRAY[t], count=n)
                vals.extend(arr.tolist())
            elif t == b"S":
                (n,) = struct.unpack_from("<I", data, pos)
                pos += 4
                vals.append(_bin_str(data[pos:pos + n]))
                pos += n
            elif t == b"R":
                (n,) = struct.unpack_from("<I", data, pos)
                pos += 4
                vals.append(data[pos:pos + n])
                pos += n
            else:
                raise ValueError(f"binary FBX: unknown property type {t!r}")
        return vals, pos

    def read_node(pos: int) -> Tuple[Optional[FbxNode], int]:
        head = struct.unpack_from(head_fmt, data, pos)
        end, nprops, _plen, nlen = head
        if end == 0:                                    # sentinel record
            return None, pos + sentinel
        pos += head_sz
        name = data[pos:pos + nlen].decode("latin-1")
        pos += nlen
        vals, pos = read_props(pos, nprops)
        children: List[FbxNode] = []
        while pos < end:
            child, pos = read_node(pos)
            if child is None:
                break
            children.append(child)
        return FbxNode(name, vals, children), end

    pos = len(BINARY_MAGIC) + 2 + 4
    children = []
    while pos + head_sz <= len(data):
        node, pos = read_node(pos)
        if node is None:                                # top-level sentinel
            break
        children.append(node)
    return FbxNode("", [], children)


def write_fbx_binary(root: FbxNode, version: int = 7400,
                     compress_arrays: bool = True) -> bytes:
    """Serialize an FbxNode tree to the Kaydara binary container (the
    inverse of parse_fbx_binary; exercised by the round-trip tests and
    usable as an exporter). ASCII array nodes (`*N { a: ... }`) become one
    typed array property — int-only arrays as 'l', mixed as 'd'."""
    import struct
    import zlib

    big = version >= 7500
    head_fmt = "<QQQB" if big else "<IIIB"
    head_sz = struct.calcsize(head_fmt)

    def prop_bytes(v) -> bytes:
        if isinstance(v, bool):
            return b"C" + struct.pack("<b", int(v))
        if isinstance(v, int):
            return b"L" + struct.pack("<q", v)
        if isinstance(v, float):
            return b"D" + struct.pack("<d", v)
        if isinstance(v, bytes):
            return b"R" + struct.pack("<I", len(v)) + v
        s = str(v)
        if "::" in s:
            cls, name = s.split("::", 1)
            raw = name.encode("latin-1") + b"\x00\x01" + cls.encode("latin-1")
        else:
            raw = s.encode("latin-1")
        return b"S" + struct.pack("<I", len(raw)) + raw

    def array_bytes(values: List) -> bytes:
        ints = all(isinstance(v, int) and not isinstance(v, bool)
                   for v in values)
        code, dt = (b"l", "<q") if ints else (b"d", "<d")
        raw = np.asarray(values, dtype=dt).tobytes()
        enc = 0
        if compress_arrays and len(raw) > 16:
            comp = zlib.compress(raw)
            if len(comp) < len(raw):
                raw, enc = comp, 1
        return code + struct.pack("<III", len(values), enc, len(raw)) + raw

    def node_bytes(node: FbxNode, offset: int) -> bytes:
        a = node.first("a")
        if a is not None:
            props = array_bytes([v for v in a.values
                                 if isinstance(v, (int, float))])
            nprops = 1
            kids = []
        else:
            vals = [v for v in node.values
                    if not (isinstance(v, str) and v.startswith("*"))]
            props = b"".join(prop_bytes(v) for v in vals)
            nprops = len(vals)
            kids = node.children
        name = node.name.encode("latin-1")
        body = props
        plen = len(props)
        child_blob = b""
        if kids:
            pos = offset + head_sz + len(name) + plen
            for c in kids:
                cb = node_bytes(c, pos)
                child_blob += cb
                pos += len(cb)
            child_blob += b"\x00" * head_sz             # sentinel
        total = head_sz + len(name) + plen + len(child_blob)
        head = struct.pack(head_fmt, offset + total, nprops, plen, len(name))
        return head + name + body + child_blob

    out = BINARY_MAGIC + b"\x1a\x00" + struct.pack("<I", version)
    pos = len(out)
    for child in root.children:
        nb = node_bytes(child, pos)
        out += nb
        pos += len(nb)
    out += b"\x00" * head_sz                            # top-level sentinel
    return out


def _load_tree(path_or_text) -> FbxNode:
    """Path / ASCII text / binary bytes → FbxNode tree (container sniffed
    by the Kaydara magic, like the SDK)."""
    if isinstance(path_or_text, bytes):
        if path_or_text.startswith(BINARY_MAGIC):
            return parse_fbx_binary(path_or_text)
        return parse_fbx_ascii(path_or_text.decode("latin-1"))
    if "\n" in path_or_text:
        return parse_fbx_ascii(path_or_text)
    with open(path_or_text, "rb") as f:
        data = f.read()
    if data.startswith(BINARY_MAGIC):
        return parse_fbx_binary(data)
    return parse_fbx_ascii(data.decode("latin-1"))


def _array_values(node: FbxNode) -> np.ndarray:
    """KeyTime/KeyValueFloat node → flat array (handles both the `*N { a: }`
    form and inline values)."""
    a = node.first("a")
    vals = a.values if a is not None else [
        v for v in node.values if isinstance(v, (int, float))]
    return np.asarray(vals, dtype=np.float64)


def _prop70(node: FbxNode, name: str) -> Optional[List]:
    props = node.first("Properties70")
    if props is None:
        return None
    for p in props.find("P"):
        if p.values and p.values[0] == name:
            return p.values
    return None


def _model_name(raw: str) -> str:
    # "Model::Hips" (ASCII uses '::'; binary uses \x00\x01)
    return raw.split("::", 1)[-1]


def _sample_curve(times: np.ndarray, values: np.ndarray,
                  clock: np.ndarray) -> np.ndarray:
    if len(times) == 0:
        return np.zeros_like(clock)
    return np.interp(clock, times, values)


def _aa_to_quat(aa: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    axis = aa / np.maximum(theta, 1e-12)
    half = theta / 2
    return np.concatenate([axis * np.sin(half), np.cos(half)], -1)


def _compose_aa(aa1: np.ndarray, aa2: np.ndarray) -> np.ndarray:
    """axis-angle of R(aa1)·R(aa2) (aa2 applied first), batched (F, 3)."""
    q1, q2 = _aa_to_quat(aa1), _aa_to_quat(aa2)
    x1, y1, z1, w1 = q1.T
    x2, y2, z2, w2 = q2.T
    q = np.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                  w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                  w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                  w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)
    w = np.clip(np.abs(q[:, 3]), 0.0, 1.0)
    theta = 2 * np.arccos(w) * np.sign(q[:, 3])
    sin_half = np.sqrt(np.maximum(1 - w * w, 1e-24))
    axis = q[:, :3] / np.maximum(sin_half, 1e-12)[:, None]
    small = sin_half < 1e-6
    axis[small] = [1.0, 0.0, 0.0]
    theta = np.where(small, 0.0, theta)
    return (axis * theta[:, None]).astype(np.float32)


def load_fbx(path_or_text, scale: float = 0.01, y_up: bool = True,
             fps: Optional[float] = None) -> Dict:
    """FBX file (ASCII or binary) / ASCII text / binary bytes → motion dict
    {pose_aa (F,72), root_trans_offset (F,3), beta, fps} (same contract as
    bvh.load_bvh). `scale` converts FBX units (commonly cm) to meters; `fps`
    overrides the sampling clock (default: inferred from the median key
    spacing, falling back to 30)."""
    from .bvh import _euler_to_aa, canonical_name
    from .curation import _UPRIGHT_R, conform_joints

    root = _load_tree(path_or_text)
    objects = root.first("Objects")
    conns = root.first("Connections")
    if objects is None or conns is None:
        raise ValueError("FBX: missing Objects/Connections sections")

    # joints
    models: Dict[int, FbxNode] = {}
    order: List[int] = []
    for m in objects.find("Model"):
        mid, raw_name = m.values[0], str(m.values[1])
        kind = str(m.values[2]) if len(m.values) > 2 else ""
        if kind in ("LimbNode", "Root", "Null", ""):
            models[int(mid)] = m
            order.append(int(mid))
    if not models:
        raise ValueError("FBX: no skeleton Model nodes")

    # connections
    oo: Dict[int, int] = {}                    # child model → parent model
    op_anim: Dict[int, Tuple[int, str]] = {}   # curvenode → (model, prop)
    op_curve: Dict[Tuple[int, str], int] = {}  # (curvenode, axis) → curve
    for c in conns.find("C"):
        kind = c.values[0]
        if kind == "OO":
            child, parent = int(c.values[1]), int(c.values[2])
            if child in models and parent in models:
                oo[child] = parent
        elif kind == "OP":
            src, dst, prop = int(c.values[1]), int(c.values[2]), \
                str(c.values[3])
            if dst in models and prop in ("Lcl Rotation", "Lcl Translation"):
                op_anim[src] = (dst, prop)
            elif prop in ("d|X", "d|Y", "d|Z"):
                op_curve[(dst, prop[2])] = src

    curves: Dict[int, FbxNode] = {
        int(c.values[0]): c for c in objects.find("AnimationCurve")}

    # sampling clock from the union of rotation-curve key times
    all_times: List[np.ndarray] = []
    for (cn, _axis), cid in op_curve.items():
        if cn in op_anim and cid in curves:
            kt = _array_values(curves[cid].first("KeyTime")
                               or FbxNode("KeyTime", [], []))
            if len(kt):
                all_times.append(kt / KTIME_PER_SECOND)
    if fps is None:
        if all_times:
            cat = np.unique(np.concatenate(all_times))
            dt = float(np.median(np.diff(cat))) if len(cat) > 1 else 1 / 30
            # round to a whole frame rate, but never round DOWN to zero for
            # sparse keyed-on-change takes (dt > 2 s)
            fps = float(round(1.0 / dt)) if dt > 0 else 30.0
            if fps <= 0:
                fps = 1.0 / dt
        else:
            fps = 30.0
    # the clock spans [first key, last key]: takes commonly start at a
    # nonzero LocalStart offset, and anchoring at t=0 would prepend a frozen
    # extrapolated prefix of arbitrary length
    t_start = min((t[0] for t in all_times), default=0.0)
    t_end = max((t[-1] for t in all_times), default=0.0)
    F = max(int(round((t_end - t_start) * fps)) + 1, 1)
    clock = t_start + np.arange(F) / fps

    # per-model sampled channels; axes WITHOUT a curve keep the model's
    # static rest value (the SDK's EvaluateLocalTransform semantics — a
    # partially animated joint still carries its static components)
    rot: Dict[int, np.ndarray] = {}
    pos = {mid: None for mid in models}
    static3 = lambda node, prop: np.asarray(
        (_prop70(node, prop) or [0, 0, 0])[-3:], np.float64)
    for cn, (mid, prop) in op_anim.items():
        chans = np.tile(static3(models[mid], prop), (F, 1))
        for k, axis in enumerate("XYZ"):
            cid = op_curve.get((cn, axis))
            if cid is None or cid not in curves:
                continue
            kt = _array_values(curves[cid].first("KeyTime")
                               or FbxNode("KeyTime", [], []))
            kv = _array_values(curves[cid].first("KeyValueFloat")
                               or FbxNode("KeyValueFloat", [], []))
            n = min(len(kt), len(kv))
            chans[:, k] = _sample_curve(kt[:n] / KTIME_PER_SECOND,
                                        kv[:n], clock)
        if prop == "Lcl Rotation":
            rot[mid] = chans
        else:
            pos[mid] = chans

    aa = np.zeros((F, len(order), 3), np.float32)
    trans = np.zeros((F, 3), np.float32)
    root_mid = next((m for m in order if oo.get(m) is None), order[0])
    for j, mid in enumerate(order):
        node = models[mid]
        ro_prop = _prop70(node, "RotationOrder")
        ro = _ROTATION_ORDERS.get(
            int(ro_prop[-1]) if ro_prop else 0, "ZYX")
        degs = rot.get(mid)
        if degs is None:                        # unanimated: static rest
            degs = np.tile(static3(node, "Lcl Rotation"), (F, 1))
        # compose in the (reversed) order sequence; degs columns follow it
        cols = {"X": 0, "Y": 1, "Z": 2}
        axes = [f"{c}rotation" for c in ro]
        aa_j = _euler_to_aa(axes, degs[:, [cols[c] for c in ro]])
        # joint orient: R = Rpre · Reuler (SDK EvaluateLocalTransform; the
        # PreRotation property is always composed in fixed XYZ order)
        pre = _prop70(node, "PreRotation")
        if pre is not None:
            pre_deg = np.asarray(pre[-3:], np.float64)[None, :]
            aa_pre = _euler_to_aa(["Zrotation", "Yrotation", "Xrotation"],
                                  pre_deg[:, [2, 1, 0]])
            aa_j = _compose_aa(np.tile(aa_pre, (F, 1)), aa_j)
        aa[:, j] = aa_j
        if mid == root_mid:
            p = pos[mid]
            if p is None:
                static_pos = _prop70(node, "Lcl Translation")
                p = np.tile(np.asarray(static_pos[-3:], np.float64),
                            (F, 1)) if static_pos is not None \
                    else np.zeros((F, 3))
            trans = (p * scale).astype(np.float32)

    names = [canonical_name(_model_name(str(models[m].values[1])))
             or f"__{_model_name(str(models[m].values[1]))}" for m in order]
    pose_aa = conform_joints(aa.reshape(F, -1), names).reshape(F, 24, 3)
    if y_up:
        pose_aa = pose_aa @ _UPRIGHT_R.T
        trans = trans @ _UPRIGHT_R.T
    return {"pose_aa": pose_aa.reshape(F, 72).astype(np.float32),
            "root_trans_offset": trans.astype(np.float32),
            "beta": np.zeros(16, np.float32),
            "fps": float(fps)}


def skeleton_from_fbx(path_or_text) -> Tuple[List[str], List[int]]:
    """(joint names, parent indices) — the reference wrapper's topology
    output (fbx_read_wrapper.py returns joint_names/parents). Accepts ASCII
    or binary containers like load_fbx."""
    root = _load_tree(path_or_text)
    objects, conns = root.first("Objects"), root.first("Connections")
    if objects is None or conns is None:
        raise ValueError("FBX: missing Objects/Connections sections")
    ids, names = [], []
    for m in objects.find("Model"):
        kind = str(m.values[2]) if len(m.values) > 2 else ""
        if kind not in ("LimbNode", "Root", "Null", ""):
            continue                    # meshes/cameras/lights aren't joints
        ids.append(int(m.values[0]))
        names.append(_model_name(str(m.values[1])))
    parent_of = {}
    for c in conns.find("C"):
        if c.values[0] == "OO" and int(c.values[1]) in ids \
                and int(c.values[2]) in ids:
            parent_of[int(c.values[1])] = int(c.values[2])
    idx = {mid: k for k, mid in enumerate(ids)}
    parents = [idx.get(parent_of.get(mid, -1), -1) for mid in ids]
    return names, parents
