"""emloco_tpu_torch against emloco_tpu: the SMPL body model, retargeting,
and the motion importers (BVH, FBX, curation).

Inputs are made with numpy from a seed and fed to both packages. SMPL's
vertices are within 1e-5 × max |v| (float32 blendshape and skinning
contractions summed in another order); the rotations and root paths of
retargeting within 2e-6 relative plus 2e-6 absolute (the FK tests'
float32 tolerance); the importers are numpy in both packages and equal
exactly; the AMASS ground fix within 1e-6 m. The JAX functions run under
jax.jit: one compile each instead of op-by-op dispatch.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.kinematics import body_model as jbm
from emloco_tpu.kinematics import bvh as jbvh
from emloco_tpu.kinematics import curation as jcur
from emloco_tpu.kinematics import fbx as jfbx
from emloco_tpu.kinematics import retarget as jret
from emloco_tpu.kinematics import skeleton as jsk
from emloco_tpu.kinematics import smpl as jsmpl
from emloco_tpu.ops import quat as jq
from emloco_tpu_torch.kinematics import body_model as tbm
from emloco_tpu_torch.kinematics import bvh as tbvh
from emloco_tpu_torch.kinematics import curation as tcur
from emloco_tpu_torch.kinematics import fbx as tfbx
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.kinematics import retarget as tret
from emloco_tpu_torch.kinematics import skeleton as tsk
from emloco_tpu_torch.kinematics import smpl as tsmpl
from tests.test_bvh import _BVH
from tests.test_fbx import make_fixture

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "smpl_fixture.npz")
TOL = dict(rtol=2e-6, atol=2e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _toy_model():
    """test_kinematics.py's synthetic SMPL model (V = 64, no posedirs)."""
    rng = np.random.RandomState(0)
    V = 64
    tree = jbm.canonical_skeleton()
    _, gpos = jsk.forward_kinematics(tree, jq.identity_like((1, 24)),
                                     jnp.zeros((1, 3)))
    gpos = np.asarray(gpos[0])
    owner = rng.randint(0, 24, V)
    v_template = gpos[owner] + rng.randn(V, 3).astype(np.float32) * 0.05
    w = np.zeros((V, 24), np.float32)
    w[np.arange(V), owner] = 1.0
    jreg = np.zeros((24, V), np.float32)
    for j in range(24):
        idx = np.where(owner == j)[0]
        if len(idx):
            jreg[j, idx] = 1.0 / len(idx)
    return jsmpl.SMPLModel(v_template=v_template,
                           shapedirs=rng.randn(V, 3, 16).astype(np.float32)
                           * 0.01,
                           posedirs=None, j_regressor=jreg, lbs_weights=w,
                           parents=jbm.PARENTS)


@pytest.mark.parametrize("which", ["fixture", "toy"])
def test_get_joints_verts_matches_jax(which):
    if which == "fixture":
        jm, tm = (jsmpl.SMPLModel.load_npz(FIXTURE),
                  tsmpl.SMPLModel.load_npz(FIXTURE))
        assert tm.posedirs is not None and tm.v_template.shape[0] == 192
        for f in ("v_template", "shapedirs", "posedirs", "j_regressor",
                  "lbs_weights", "parents"):
            np.testing.assert_array_equal(getattr(jm, f), getattr(tm, f))
    else:
        jm = _toy_model()
        tm = tsmpl.SMPLModel(**{f: getattr(jm, f) for f in (
            "v_template", "shapedirs", "posedirs", "j_regressor",
            "lbs_weights", "parents")})
    rng = np.random.RandomState(1)
    B = 5
    pose = rng.uniform(-0.6, 0.6, (B, 72)).astype(np.float32)
    betas = rng.randn(B, 10).astype(np.float32)
    trans = rng.randn(B, 3).astype(np.float32)
    jfwd = jax.jit(lambda *a: jsmpl.get_joints_verts(jm, *a))
    for tr in (None, trans):
        jv, jj = jfwd(*(jnp.asarray(a) for a in (pose, betas, tr)
                        if a is not None))
        tv, tj = tsmpl.get_joints_verts(tm, _t(pose), _t(betas),
                                        None if tr is None else _t(tr))
        jv, jj = np.asarray(jv), np.asarray(jj)
        scale = np.abs(jv).max()
        np.testing.assert_allclose(tv.numpy(), jv, rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(tj.numpy(), jj, rtol=0,
                                   atol=1e-5 * np.abs(jj).max())


def test_capsule_surface_matches_jax():
    rng = np.random.RandomState(2)
    N = 3
    betas = rng.randn(N, 16).astype(np.float32) * 0.3
    jp = jbm.build_body_params(jnp.asarray(betas))
    tp = tbm.build_body_params(betas, device="cpu")
    pos = rng.randn(N, 24, 3).astype(np.float32)
    rot = rng.randn(N, 24, 4).astype(np.float32)
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    for P in (8, 5):
        j = jax.jit(lambda a, b, P=P: jsmpl.capsule_surface(jp, a, b, P))(
            jnp.asarray(pos), jnp.asarray(rot))
        t = tsmpl.capsule_surface(tp, _t(pos), _t(rot), P)
        assert t.shape == (N, 24 * P, 3)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _reduced_tree(src):
    """A 14-joint skeleton of the canonical one's legs and spine, with
    perturbed rest offsets: its names are a subset of the canonical ones."""
    keep = ["Pelvis", "L_Hip", "L_Knee", "L_Ankle", "R_Hip", "R_Knee",
            "R_Ankle", "Torso", "Spine", "Chest", "Neck", "Head",
            "L_Shoulder", "R_Shoulder"]
    idx = [src.index(n) for n in keep]
    parents = []
    for j in idx:
        p = int(src.parents[j])
        while p >= 0 and p not in idx:
            p = int(src.parents[p])
        parents.append(-1 if p < 0 else idx.index(p))
    rng = np.random.RandomState(3)
    lt = src.local_translation[idx] * 1.1 + rng.randn(len(idx), 3).astype(
        np.float32) * 0.01
    return keep, np.array(parents), lt.astype(np.float32)


def _quat(rng, shape):
    q = rng.randn(*shape, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_retarget_matches_jax():
    src_np = tbm.canonical_skeleton()
    names, parents, lt = _reduced_tree(src_np)
    jsrc = jbm.canonical_skeleton()
    jtgt = jsk.SkeletonTree(names=tuple(names), parents=parents,
                            local_translation=lt)
    ttgt = tsk.SkeletonTree(names=tuple(names), parents=parents,
                            local_translation=lt)
    # the identity case on a motion of the library
    lib = tml.synthetic_walk_motions(speeds=(1.0,), duration=1.0,
                                     device="cpu")
    ms = tml.get_motion_state(lib, torch.zeros((5,), dtype=torch.long),
                              torch.linspace(0.0, 0.9, 5))
    jmap = {n: n for n in src_np.names}
    t_rot, t_pos = tret.retarget_motion(src_np, src_np, jmap,
                                        ms["local_rot"], ms["root_pos"])
    j_rot, j_pos = jax.jit(lambda a, b: jret.retarget_motion(
        jsrc, jsrc, jmap, a, b))(jnp.asarray(ms["local_rot"].numpy()),
                                 jnp.asarray(ms["root_pos"].numpy()))
    np.testing.assert_allclose(t_rot.numpy(), np.asarray(j_rot), **TOL)
    np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos), **TOL)
    dots = torch.abs((t_rot * ms["local_rot"]).sum(-1))
    np.testing.assert_allclose(dots.numpy(), 1.0, atol=1e-4)

    # canonical → reduced: random T-poses, a frame alignment, a scale, and
    # a map that leaves the knees, the chest and the shoulders unmapped
    rng = np.random.RandomState(4)
    F = 6
    local = _quat(rng, (F, 24))
    root = rng.randn(F, 3).astype(np.float32)
    tmap = {n: n for n in names if n not in ("L_Knee", "R_Knee", "Chest",
                                             "L_Shoulder", "R_Shoulder")}
    kw = dict(source_tpose_rot=_quat(rng, (24,)),
              target_tpose_rot=_quat(rng, (len(names),)),
              source_tpose_root=rng.randn(3).astype(np.float32),
              target_tpose_root=rng.randn(3).astype(np.float32),
              rotation_to_target=_quat(rng, (1,))[0])
    for scale in (None, 0.7):
        t_rot, t_pos = tret.retarget_motion(
            src_np, ttgt, tmap, _t(local), _t(root), scale=scale,
            **{k: _t(v) for k, v in kw.items()})
        j_rot, j_pos = jax.jit(lambda a, b, k, scale=scale: (
            jret.retarget_motion(jsrc, jtgt, tmap, a, b, scale=scale, **k)))(
            jnp.asarray(local), jnp.asarray(root),
            {k: jnp.asarray(v) for k, v in kw.items()})
        assert t_rot.shape == (F, len(names), 4)
        np.testing.assert_allclose(t_rot.numpy(), np.asarray(j_rot),
                                   rtol=2e-6, atol=4e-6)
        np.testing.assert_allclose(t_pos.numpy(), np.asarray(j_pos), **TOL)
    assert tret._auto_leg_scale(src_np, ttgt) == pytest.approx(
        jret._auto_leg_scale(jsrc, jtgt), rel=1e-12)
    with pytest.raises(ValueError, match="root"):
        tret.retarget_motion(src_np, ttgt, {"Head": "Head"}, _t(local),
                             _t(root))


def _equal_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_bvh_matches_jax():
    jj, jf, jt = jbvh.parse_bvh(_BVH)
    tj, tf, tt = tbvh.parse_bvh(_BVH)
    assert [(j.name, j.parent, list(j.channels)) for j in jj] == \
        [(j.name, j.parent, list(j.channels)) for j in tj]
    np.testing.assert_array_equal(jf, tf)
    assert jt == tt
    for y_up in (True, False):
        _equal_dicts(jbvh.load_bvh(_BVH, y_up=y_up),
                     tbvh.load_bvh(_BVH, y_up=y_up))
    for n in ("LeftUpLeg", "Spine2", "L_Wrist", "nothing"):
        assert jbvh.canonical_name(n) == tbvh.canonical_name(n)


def test_fbx_parse_write_load_matches_jax(tmp_path):
    text = make_fixture(frames=20)
    jt, tt = jfbx.parse_fbx_ascii(text), tfbx.parse_fbx_ascii(text)
    for version, compress in ((7400, True), (7500, False)):
        jb = jfbx.write_fbx_binary(jt, version=version,
                                   compress_arrays=compress)
        tb = tfbx.write_fbx_binary(tt, version=version,
                                   compress_arrays=compress)
        assert jb == tb
        _equal_dicts(jfbx.load_fbx(jb), tfbx.load_fbx(tb))
        # the binary form reads back to the ASCII form's motion
        np.testing.assert_allclose(tfbx.load_fbx(tb)["pose_aa"],
                                   tfbx.load_fbx(text)["pose_aa"], atol=1e-6)
    _equal_dicts(jfbx.load_fbx(text, fps=24.0), tfbx.load_fbx(text, fps=24.0))
    p = tmp_path / "take.fbx"
    p.write_bytes(tfbx.write_fbx_binary(tt, version=7500))
    _equal_dicts(jfbx.load_fbx(str(p)), tfbx.load_fbx(str(p)))
    assert jfbx.skeleton_from_fbx(text) == tfbx.skeleton_from_fbx(text)


def _motion(frames, seed):
    rng = np.random.RandomState(seed)
    trans = np.cumsum(rng.uniform(-0.02, 0.02, (frames, 3)), 0)
    trans[:, 2] += 0.93
    return {"pose_aa": rng.uniform(-0.4, 0.4, (frames, 72)).astype(
                np.float32),
            "root_trans_offset": trans.astype(np.float32),
            "beta": np.zeros(16, np.float32), "fps": 30.0}


def test_curation_matches_jax(tmp_path):
    d = {"walk_a": _motion(60, 0), "walk_b": _motion(20, 1),
         "run_c": _motion(90, 2), "jump_d": _motion(45, 3)}
    for kw in (dict(min_seconds=1.0), dict(min_seconds=0.5, max_seconds=2.0),
               dict(min_seconds=0.0, name_allowlist=["walk"]),
               dict(min_seconds=0.0,
                    predicate=lambda n, m: m["fps"] > 20)):
        assert jcur.filter_motions(d, **kw).keys() == \
            tcur.filter_motions(d, **kw).keys()
    assert list(jcur.merge_motion_dicts(d, d)) == \
        list(tcur.merge_motion_dicts(d, d))
    (ja, jb), (ta, tb) = (jcur.train_test_split(d, 0.25, seed=3),
                          tcur.train_test_split(d, 0.25, seed=3))
    assert (list(ja), list(jb)) == (list(ta), list(tb))
    _equal_dicts(jcur.flip_motion_lr(d["walk_a"]),
                 tcur.flip_motion_lr(d["walk_a"]))
    assert jcur.augment_with_flips(d).keys() == \
        tcur.augment_with_flips(d).keys()
    names = ["Pelvis", "L_Hip", "__extra", "Head"]
    src = np.random.RandomState(5).randn(7, 12).astype(np.float32)
    np.testing.assert_array_equal(jcur.conform_joints(src, names),
                                  tcur.conform_joints(src, names))
    path = str(tmp_path / "m.pkl")
    tcur.save_motion_dict(d, path)
    back = tcur.load_motion_dict(path)
    for k in d:
        _equal_dicts(d[k], back[k])


def test_amass_to_motion_matches_jax(tmp_path):
    rng = np.random.RandomState(6)
    F = 37
    raw = {"poses": rng.uniform(-0.3, 0.3, (F, 156)).astype(np.float32),
           "trans": (np.cumsum(rng.uniform(-0.01, 0.01, (F, 3)), 0)
                     + [0.0, 0.9, 0.0]).astype(np.float32),
           "betas": rng.randn(10).astype(np.float32),
           "mocap_framerate": np.array(60.0)}
    for fix in (True, False):
        j = jcur.amass_to_motion(dict(raw), ground_fix=fix)
        t = tcur.amass_to_motion(dict(raw), ground_fix=fix)
        assert j.keys() == t.keys() and j["fps"] == t["fps"]
        np.testing.assert_array_equal(j["pose_aa"], t["pose_aa"])
        np.testing.assert_array_equal(j["beta"], t["beta"])
        np.testing.assert_allclose(t["root_trans_offset"],
                                   j["root_trans_offset"], rtol=0, atol=1e-6)
    paths = []
    for i in range(2):
        p = str(tmp_path / f"seq{i}.npz")
        np.savez(p, **raw)
        paths.append(p)
    np.savez(str(tmp_path / "shape.npz"), betas=raw["betas"])
    out = tcur.amass_directory_to_dict(paths + [str(tmp_path /
                                                    "shape.npz")])
    assert sorted(out) == ["seq0", "seq1"]
