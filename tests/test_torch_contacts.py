"""The engine's contact variants, piece by piece, against the JAX engine:
the row tables, the self-contact geometry, gates and rows, the mesh
colliders, the terrain window lookup, the `poles` generator,
`from_smpl_npz`, and the 4-D oracles against the merged rows.

The pose is tests/test_engine.py:344-355's: two template humanoids and one
with varied betas, the left forearm folded into the torso (shoulder exp-map
(−2.2, 0, 0), elbow (0, 1.2, 0)), with seeded random velocities. Tolerances:
  - the static tables, the terrain window lookup, the generators and the
    self-contact geometry and gates: bit-equal (the same float32 operations
    in the same order; the window lookup selects the corners the JAX
    one-hot contractions pick);
  - merged rows in float32: 1e-6 of the largest magnitude (the pivot part
    is a selection, the −[pt]× part a signed copy: both exact; the normal
    rows sum three products in another order);
  - the 4-D oracles: 1e-5 of the largest magnitude (einsum sums in
    another order); the merged assembly against the 4-D one within 2e-4 of
    the LHS's scale, as tests/test_engine.py:520 holds JAX's;
  - from_smpl_npz: bit-equal but the PD gains, within 1e-6 relative (the
    body mass is summed in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.kinematics import body_model as jbm
from emloco_tpu.ops import quat as jq
from emloco_tpu.physics import EngineConfig as JEngineConfig
from emloco_tpu.physics import reduced as JR
from emloco_tpu.physics import terrain as JT
from emloco_tpu_torch import convert
from emloco_tpu_torch.kinematics import body_model as tbm
from emloco_tpu_torch.physics import EngineConfig
from emloco_tpu_torch.physics import reduced as TR
from emloco_tpu_torch.physics import terrain as TT

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "smpl_fixture.npz")
TABLES = ("capsule", "mesh", "self")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


def folded_local(n):
    names = jbm.BODY_NAMES
    j_sh, j_el = names.index("L_Shoulder") - 1, names.index("L_Elbow") - 1
    target = jnp.zeros((n, 23, 3)).at[:, j_sh, 0].set(-2.2)
    target = target.at[:, j_el, 1].set(1.2)
    loc = jq.identity_like((n, jbm.NUM_BODIES))
    loc = loc.at[:, j_sh + 1].set(jq.exp_map_to_quat(target[:, j_sh]))
    return loc.at[:, j_el + 1].set(jq.exp_map_to_quat(target[:, j_el]))


@pytest.fixture(scope="module")
def pose():
    """Folded-arm humanoids (the third with varied betas) with random
    velocities, in both packages; also the SMPL-fixture bodies."""
    n = 3
    betas = np.zeros((n, 16), np.float32)
    betas[2] = np.random.RandomState(1).randn(16) * 0.5
    jmodel = JR.build_model(jbm.build_body_params(jnp.asarray(betas)))
    rng = np.random.RandomState(11)
    root = jnp.asarray([[0.0, 0.0, 1.0]] * n)
    st = JR.kinematic_state(jmodel, JR.default_tree(), root,
                            jq.identity_like((n,)), folded_local(n))
    st = st.replace(u=jnp.asarray(rng.randn(n, 75).astype(np.float32) * 0.7))
    st = JR.refresh_cache(jmodel, st, JR.default_tree())
    sbetas = np.zeros((2, 10), np.float32)
    sbetas[1, 0], sbetas[1, 1] = 2.0, -2.0
    jsmpl = JR.build_model(jbm.from_smpl_npz(FIXTURE, jnp.asarray(sbetas)))
    return dict(jmodel=jmodel, jstate=st, jsmpl=jsmpl, sbetas=sbetas,
                tmodel=convert.model(np_tree(jmodel), "cpu"),
                tstate=convert.physics_state(np_tree(st), "cpu"),
                tsmpl=convert.model(np_tree(jsmpl), "cpu"))


@pytest.mark.parametrize("table", TABLES)
def test_merged_point_statics_match_jax(table):
    """The three tables' statics bit-equal to JAX's, and the port's index
    form (_table_statics) the same selection as the one-hot OH."""
    for a, b in zip(TR._merged_point_statics(table),
                    JR._merged_point_statics(table)):
        np.testing.assert_array_equal(a, np.asarray(b))
    E1C, OH, _, _, ISELC = TR._merged_point_statics(table)
    s = TR._table_statics(table, torch.device("cpu"))
    np.testing.assert_array_equal(s["iselc"].numpy(), ISELC)
    sel = np.zeros_like(OH)
    if table == "self":
        sel[np.arange(len(OH)), s["row_a"].numpy()] += 1.0
        sel[np.arange(len(OH)), s["row_b"].numpy()] -= 1.0
        np.testing.assert_array_equal(s["eps"].numpy(), JR._SELF_EPS)
        np.testing.assert_array_equal(s["onehot"].numpy(), JR._SELF_ONEHOT)
    else:
        sel[np.arange(len(OH)), s["row"].numpy()] = 1.0
        ones = {"capsule": JR._CONTACT_ONEHOT, "mesh": JR._MESH_ONEHOT}
        np.testing.assert_array_equal(s["onehot"].numpy(), ones[table])
    np.testing.assert_array_equal(sel, OH)
    assert (TR.NC, TR.NC_MESH, TR.NSELF) == (JR.NC, JR.NC_MESH, JR.NSELF)


def test_self_rows_leave_the_block_arrow_pattern():
    """Six pairs span two limbs (the wrist-hip and the leg-leg pairs): their
    rows fill entries the block-arrow kernels never read, so the port
    solves self-contact densely."""
    assert TR.SELF_ROWS_FIT_ARROW is False
    assert not TR._arrow_exact(EngineConfig(self_contact=True))
    assert TR._arrow_exact(EngineConfig(mesh_contacts=True))
    assert not TR._batch_major(EngineConfig(self_contact=True,
                                            batch_major_solver=True))


@pytest.mark.parametrize("speculative", [False, True])
def test_self_contact_matches_jax(pose, speculative):
    """Geometry, gates and merged rows of the self pairs on the folded-arm
    pose: the arm's pairs interpenetrate."""
    jm, js, tm, ts = pose["jmodel"], pose["jstate"], pose["tmodel"], \
        pose["tstate"]
    geo_j = JR._self_contact_geometry(jm, js.body_x, js.body_q)
    geo_t = TR._self_contact_geometry(tm, ts.body_x, ts.body_q)
    for a, b in zip(geo_t, geo_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(geo_t[3].max()) > 0.08              # genuinely folded in
    cfg_j, cfg_t = JEngineConfig(), EngineConfig()
    gates_j = JR._self_contact_gates(jm, js.body_x, js.body_q, js.body_v,
                                     js.body_w, cfg_j, speculative)
    gates_t = TR._self_contact_gates(tm, ts.body_x, ts.body_q, ts.body_v,
                                     ts.body_w, cfg_t, speculative)
    for a, b in zip(gates_t, gates_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x, q = js.body_x, js.body_q
    piv = jnp.concatenate(
        [x[:, :1], x[:, 1:] + jq.rotate(q[:, 1:], jm.anchor_c[:, 1:])], 1)
    _, _, t2m = JR._build_rows_merged(jm, x, q, piv)
    rows_j, pts_j = JR._self_contact_rows_merged(
        jm, x, q, js.body_v, js.body_w, t2m, cfg_j, speculative)
    rows_t, pts_t = TR._self_contact_rows_merged(
        tm, ts.body_x, ts.body_q, ts.body_v, ts.body_w,
        torch.as_tensor(np.array(t2m)), cfg_t, speculative)
    for a, b in zip(rows_t, rows_j):
        rel_close(a, b, 1e-6)
    for a, b in zip(pts_t, pts_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bodies", ["template", "smpl"])
def test_mesh_ground_geometry_matches_jax(pose, bodies):
    """The mesh colliders' world points (the (N, 14, 6, 3) points rotated
    by (N, 14, 1, 4) quaternions) on a beta-varied batch and on the
    SMPL-fixture bodies, and their merged rows."""
    jm, tm = ((pose["jmodel"], pose["tmodel"]) if bodies == "template"
              else (pose["jsmpl"], pose["tsmpl"]))
    n = jm.num_envs
    st = JR.kinematic_state(jm, JR.default_tree(),
                            jnp.asarray([[0.0, 0.0, 1.0]] * n),
                            jq.identity_like((n,)), folded_local(n))
    tst = convert.physics_state(np_tree(st), "cpu")
    cfg_j, cfg_t = JEngineConfig(mesh_contacts=True), \
        EngineConfig(mesh_contacts=True)
    pts_j, rad_j, body_j = JR._ground_geometry(jm, st.body_x, st.body_q,
                                               cfg_j)
    pts_t, rad_t, body_t = TR._ground_geometry(tm, tst.body_x, tst.body_q,
                                               cfg_t)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(rad_t.numpy(), np.asarray(rad_j))
    np.testing.assert_array_equal(body_t.numpy(), body_j)
    assert pts_t.shape == (n, TR.NC_MESH, 3)
    x, q = st.body_x, st.body_q
    piv = jnp.concatenate(
        [x[:, :1], x[:, 1:] + jq.rotate(q[:, 1:], jm.anchor_c[:, 1:])], 1)
    _, _, t2m = JR._build_rows_merged(jm, x, q, piv)
    Gc_j = JR._point_rows_merged(pts_j, "mesh", t2m)
    Gc_t = TR._point_rows_merged(pts_t, "mesh",
                                 torch.as_tensor(np.array(t2m)))
    rel_close(Gc_t, Gc_j, 1e-6)


def test_four_d_oracles_match_jax(pose):
    """_build_jacobians, _mass_matrix_from_jac, _point_jacobians,
    _self_pair_jacobians, _self_contact_rows, _assemble_lhs and
    _assemble_rhs against the JAX engine's."""
    jm, js, tm, ts = pose["jmodel"], pose["jstate"], pose["tmodel"], \
        pose["tstate"]
    x, q = js.body_x, js.body_q
    piv = jnp.concatenate(
        [x[:, :1], x[:, 1:] + jq.rotate(q[:, 1:], jm.anchor_c[:, 1:])], 1)
    tpiv = torch.as_tensor(np.array(piv))
    jout = JR._build_jacobians(jm, x, q, piv)
    tout = TR._build_jacobians(tm, ts.body_x, ts.body_q, tpiv)
    for a, b in zip(tout, jout):
        rel_close(a, b, 1e-5)
    Jv4, W4, term2 = tout
    rel_close(TR._mass_matrix_from_jac(tm, Jv4, W4),
              JR._mass_matrix_from_jac(jm, *jout[:2]), 1e-5)
    cfg = JEngineConfig()
    pts, _, gb = JR._ground_geometry(jm, x, q, cfg)
    Jc_j = JR._point_jacobians(pts, gb, jout[2])
    Jc_t = TR._point_jacobians(torch.as_tensor(np.array(pts)), gb, term2)
    rel_close(Jc_t, Jc_j, 1e-5)
    rows_j, _ = JR._self_contact_rows(jm, x, q, js.body_v, js.body_w,
                                      jout[2], cfg, True)
    rows_t, _ = TR._self_contact_rows(tm, ts.body_x, ts.body_q, ts.body_v,
                                      ts.body_w, term2, EngineConfig(), True)
    for a, b in zip(rows_t, rows_j):
        rel_close(a, b, 1e-5)
    rng = np.random.RandomState(5)
    n, C, K = 3, Jc_t.shape[1], TR.NSELF
    nrm = rng.randn(n, C + K, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    wn = np.abs(rng.randn(n, C + K)).astype(np.float32)
    wt = 0.5 * np.abs(rng.randn(n, C + K)).astype(np.float32)
    diag = (np.abs(rng.randn(n, 75)) + 0.1).astype(np.float32)
    Jc_all_j = jnp.concatenate([Jc_j, rows_j[0]], 1)
    Jn_j = jnp.einsum("nci,ncij->ncj", jnp.asarray(nrm), Jc_all_j)
    Jc_all_t = torch.cat([Jc_t, rows_t[0]], 1)
    Jn_t = torch.einsum("nci,ncij->ncj", torch.as_tensor(nrm), Jc_all_t)
    rel_close(TR._assemble_lhs(tm, Jv4, W4, torch.as_tensor(diag),
                               torch.as_tensor(wn), torch.as_tensor(wt),
                               Jn_t, Jc_all_t),
              JR._assemble_lhs(jm, *jout[:2], jnp.asarray(diag),
                               jnp.asarray(wn), jnp.asarray(wt), Jn_j,
                               Jc_all_j), 1e-5)
    f_lin = rng.randn(n, 24, 3).astype(np.float32)
    Q = rng.randn(n, 75).astype(np.float32)
    rel_close(TR._assemble_rhs(tm, Jv4, W4, ts.body_q, ts.body_v, ts.body_w,
                               torch.as_tensor(f_lin), 0.01,
                               torch.as_tensor(Q)),
              JR._assemble_rhs(jm, *jout[:2], q, js.body_v, js.body_w,
                               jnp.asarray(f_lin), 0.01, jnp.asarray(Q)),
              1e-5)


@pytest.mark.parametrize("table", ["capsule", "mesh"])
def test_merged_assembly_matches_4d(pose, table):
    """tests/test_engine.py:520 on the port alone: merged rows equal the
    4-D rows, and the merged LHS, RHS and contact force over the ground
    table plus the self pairs (arbitrary weights) equal the 4-D
    assembly's."""
    tm, ts = pose["tmodel"], pose["tstate"]
    x, q = ts.body_x, ts.body_q
    n = x.shape[0]
    piv = torch.cat([x[:, :1], x[:, 1:] + TR.quat.rotate(
        q[:, 1:], tm.anchor_c[:, 1:])], 1)
    Jv4, W4, term2 = TR._build_jacobians(tm, x, q, piv)
    G, W, t2m = TR._build_rows_merged(tm, x, q, piv, torch.float32)
    rel_close(G.reshape(n, 24, 3, 72), Jv4[..., 3:], 1e-6)
    rel_close(W.reshape(n, 24, 3, 72), W4[..., 3:], 1e-6)
    rel_close(t2m.reshape(n, 24, 3, 72), term2, 1e-6)
    cfg = EngineConfig(mesh_contacts=table == "mesh")
    pts, _, body = TR._ground_geometry(tm, x, q, cfg)
    C = pts.shape[1]
    Jc = TR._point_jacobians(pts, body, term2)
    Gc = TR._point_rows_merged(pts, table, t2m)
    rel_close(Gc.reshape(n, C, 3, 72), Jc[..., 3:], 1e-6)
    cA, cB, _, _ = TR._self_contact_geometry(tm, x, q)
    K = cA.shape[1]
    Jcs = TR._self_pair_jacobians(cA, cB, term2)
    Gcs = TR._point_rows_merged(torch.stack([cA, cB], 2), "self", t2m)
    rel_close(Gcs.reshape(n, K, 3, 72), Jcs[..., 3:], 1e-6)
    assert float(Jcs[..., :3].abs().max()) == 0.0

    g = torch.Generator().manual_seed(7)

    def unit(*shape):
        v = torch.randn(shape, generator=g)
        return v / v.norm(dim=-1, keepdim=True)

    nrm, nrm_s = unit(n, C, 3), unit(n, K, 3)
    # wn ≥ wt, so that the √w form applies too
    wt, wt_s = torch.rand((n, C), generator=g), torch.rand((n, K), generator=g)
    wn = wt + torch.rand((n, C), generator=g)
    wn_s = wt_s + torch.rand((n, K), generator=g)
    diag = torch.rand((n, 75), generator=g) + 0.1
    f_lin = torch.randn((n, 24, 3), generator=g)
    Q_rest = torch.randn((n, 75), generator=g)
    kpen = torch.rand((n, C + K), generator=g)
    Jn = torch.einsum("nci,ncij->ncj", nrm, Jc)
    Jns = torch.einsum("nci,ncij->ncj", nrm_s, Jcs)
    Jn_a = TR._normal_rows_merged(nrm, Gc)
    Jn_sa = TR._normal_rows_merged(nrm_s, Gcs)
    rel_close(Jn_a, Jn[..., 3:], 1e-6)
    rel_close(Jn_sa, Jns[..., 3:], 1e-6)
    At_o = TR._assemble_lhs(tm, Jv4, W4, diag, torch.cat([wn, wn_s], 1),
                            torch.cat([wt, wt_s], 1), torch.cat([Jn, Jns], 1),
                            torch.cat([Jc, Jcs], 1))
    rhs_o = TR._assemble_rhs(tm, Jv4, W4, q, ts.body_v, ts.body_w, f_lin,
                             0.01, Q_rest)
    ground, selfrows = (Gc, Jn_a, nrm, wn, wt), (Gcs, Jn_sa, wn_s, wt_s)
    for sqrt_gram in (True, False):
        At_m, rhs_m = TR._assemble_lhs_rhs(
            tm, G, W, q, ts.body_v, ts.body_w, f_lin, 0.01, Q_rest, diag,
            ground, selfrows, table, sqrt_gram=sqrt_gram)
        rel_close(At_m, At_o, 2e-4)
        rel_close(rhs_m, rhs_o, 2e-4)
    Q_o = torch.einsum("nc,ncj->nj", kpen, torch.cat([Jn, Jns], 1))
    Q_m = TR._q_contact_merged(kpen[:, :C], nrm, kpen,
                               torch.cat([Jn_a, Jn_sa], 1))
    rel_close(Q_m, Q_o, 1e-5)


@pytest.fixture(scope="module")
def grid():
    rng = np.random.RandomState(3)
    h = rng.uniform(-0.3, 0.3, (64, 80)).astype(np.float32)
    args = (h, 0.1, (-3.2, -4.0), np.zeros((1, 2), np.float32))
    return JT.make_heightfield(*args), TT.make_heightfield(*args,
                                                           device="cpu")


def test_terrain_patch_matches_jax_and_global(grid):
    """tests/test_engine.py:742-797: the window lookup bit-equal to JAX's
    and to the global lookup for roots over the whole grid, borders
    included (the window's start clamped into [0, H-1-s]); `oob` flags a
    query outside the window and nothing inside it."""
    jhf, thf = grid
    rng = np.random.RandomState(3)
    rng.uniform(-0.3, 0.3, (64, 80))                     # the heights' draw
    N, C = 16, 28
    root = rng.uniform([-3.2, -4.0], [3.2, 4.0], (N, 2)).astype(np.float32)
    pts = (root[:, None] + rng.uniform(-1.2, 1.2, (N, C, 2))).astype(
        np.float32)
    root[0], root[1] = (-3.2, -4.0), (3.2, 4.0)          # both corners
    patch_j, xb_j, yb_j = JT.corner_patch(jhf, jnp.asarray(root), 32)
    patch_t, xb_t, yb_t = TT.corner_patch(thf, torch.as_tensor(root), 32)
    np.testing.assert_array_equal(patch_t.numpy(), np.asarray(patch_j))
    np.testing.assert_array_equal(xb_t.numpy(), np.asarray(xb_j))
    np.testing.assert_array_equal(yb_t.numpy(), np.asarray(yb_j))
    assert xb_t.min() == 0 and xb_t.max() == 63 - 32
    assert yb_t.min() == 0 and yb_t.max() == 79 - 32
    h_j, n_j, oob_j = JT.height_and_normal_at_patch(
        jhf, patch_j, xb_j, yb_j, jnp.asarray(pts), return_oob=True)
    h_t, n_t, oob_t = TT.height_and_normal_at_patch(
        thf, patch_t, xb_t, yb_t, torch.as_tensor(pts), return_oob=True)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(oob_t.numpy(), np.asarray(oob_j))
    h_g, n_g = TT.height_and_normal_at(thf, torch.as_tensor(pts))
    inside = ~oob_t
    assert bool(inside.any())
    np.testing.assert_array_equal(h_t[inside].numpy(), h_g[inside].numpy())
    np.testing.assert_array_equal(n_t[inside].numpy(), n_g[inside].numpy())
    # a root mid-grid, one query 2.5 m away: inside the grid, outside the
    # window's ~1.6 m half-extent
    root_c = torch.tensor([[0.0, 0.0]])
    pts_c = torch.tensor([[[0.1, 0.1], [2.5, 0.0]]])
    patch_c, xb_c, yb_c = TT.corner_patch(thf, root_c, 32)
    _, _, oob_c = TT.height_and_normal_at_patch(thf, patch_c, xb_c, yb_c,
                                                pts_c, return_oob=True)
    np.testing.assert_array_equal(oob_c.numpy(), [[False, True]])


def test_poles_generator_matches_jax():
    for kw in (dict(), dict(num_poles=7, radius=0.3, height=1.5,
                            rng=np.random.RandomState(4))):
        jkw = dict(kw, rng=np.random.RandomState(4)) if kw else kw
        np.testing.assert_array_equal(TT.gen_poles((60, 50), 0.1, **kw),
                                      JT.gen_poles((60, 50), 0.1, **jkw))
    assert TT._GENERATORS.keys() == JT._GENERATORS.keys()
    types = ("random_uniform", "poles", "stairs")
    t = TT.generate_mixed_terrain(map_length=3.0, num_tiles=3,
                                  proportions=(0.3, 0.4, 0.3), types=types,
                                  seed=2, device="cpu")
    j = JT.generate_mixed_terrain(map_length=3.0, num_tiles=3,
                                  proportions=(0.3, 0.4, 0.3), types=types,
                                  seed=2)
    np.testing.assert_array_equal(t.heights.numpy(), np.asarray(j.heights))
    assert float(t.heights.max()) == 2.0                 # a pole stands
    # the same walkable cells; the JAX package's C++ helper lists them in
    # another order and rounds x·cell + origin in float32
    # (tests/test_torch_ops_kinematics.py::test_mixed_terrain_matches_jax)
    a, b = np.asarray(j.spawnable_xy), t.spawnable_xy.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b[np.lexsort(b.T)], a[np.lexsort(a.T)],
                               rtol=0, atol=1e-6)


def test_from_smpl_npz_matches_jax(pose):
    """Offsets, capsules, masses and the fitted colliders of the fixture at
    two betas (the template and a shifted one)."""
    t = tbm.from_smpl_npz(FIXTURE, pose["sbetas"], device="cpu")
    j = pose["jsmpl"].params
    for f in ("local_offsets", "capsule_radius", "capsule_half",
              "capsule_axis", "capsule_start", "mesh_points",
              "mesh_point_radius", "mass", "inertia", "height_offset",
              "betas", "joint_limit", "torque_limit"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("kp", "kd"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-6)
    assert t.mesh_points.shape == (2, 24, tbm.MESH_K, 3)
    # the default colliders are the capsule-axis spheres; the fitted ones
    # are not
    plain = tbm.build_body_params(pose["sbetas"], device="cpu")
    assert float((t.mesh_points - plain.mesh_points).abs().max()) > 0.01
