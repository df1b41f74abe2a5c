"""emloco_tpu_torch.physics against emloco_tpu.physics: kinematic state,
step-start assembly and `reduced.step` for one and three control steps.

On the CPU the JAX engine solves with jnp.linalg.cholesky (its non-Pallas
branch) and the port with its plain block-arrow factor: both exact
factorizations, so the two differ only by float32 rounding (sums in another
order) — and, with bfloat16 Jacobian rows (the default), by a row entry that
lands on the other bf16 neighbour, a 2^-8 relative step. Tolerances:
  float32 rows: 1e-4 of each quantity's largest magnitude, 1e-5 m on poses;
  bf16 rows:    one bf16 ulp, 2^-8, of the largest magnitude, 1e-4 m on poses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.kinematics import body_model as jbm
from emloco_tpu.ops import quat as jq
from emloco_tpu.physics import EngineConfig as JEngineConfig
from emloco_tpu.physics import generate_mixed_terrain
from emloco_tpu.physics import reduced as JR
from emloco_tpu.physics.terrain import height_at
from emloco_tpu_torch import convert
from emloco_tpu_torch.physics import EngineConfig
from emloco_tpu_torch.physics import reduced as TR

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 6
TOL = {False: dict(rel=1e-4, pos=1e-5), True: dict(rel=2.0 ** -8, pos=1e-4)}


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


@pytest.fixture(scope="module")
def world():
    """Randomly posed, moving humanoids touching down on mixed terrain."""
    rng = np.random.RandomState(0)
    betas = (rng.randn(N, 16) * 0.5).astype(np.float32)
    params = jbm.build_body_params(jnp.asarray(betas))
    jmodel = JR.build_model(params)
    jterr = generate_mixed_terrain(map_length=4.0, num_tiles=2,
                                   difficulty=0.5)
    table = np.asarray(jterr.spawnable_xy)
    xy = table[rng.choice(len(table), N)]
    z = (np.asarray(height_at(jterr, jnp.asarray(xy)))
         + np.asarray(params.height_offset) - 0.01)
    root = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    lr = jq.exp_map_to_quat(jnp.asarray(
        rng.randn(N, 24, 3).astype(np.float32) * 0.15))
    vel = [jnp.asarray(rng.randn(*s).astype(np.float32) * k)
           for s, k in (((N, 3), 0.3), ((N, 3), 0.3), ((N, 23, 3), 0.5))]
    jstate = JR.kinematic_state(jmodel, JR.default_tree(), jnp.asarray(root),
                                lr[:, 0], lr, *vel)
    target = (rng.randn(N, 23, 3) * 0.3).astype(np.float32)
    return dict(
        jmodel=jmodel, jterr=jterr, jstate=jstate, target=target,
        tmodel=convert.model(np_tree(jmodel), "cpu"),
        tterr=convert.heightfield(np_tree(jterr), "cpu"),
        tstate=convert.physics_state(np_tree(jstate), "cpu"),
        kin_args=[np.array(a) for a in (root, lr[:, 0], lr, *vel)])


def test_kinematic_state_matches_jax(world):
    ts = TR.kinematic_state(world["tmodel"], TR.default_tree(),
                            *map(torch.as_tensor, world["kin_args"]))
    for f in ("root_pos", "root_rot", "joint_rot", "u", "body_x", "body_q",
              "body_v", "body_w", "contact_force"):
        rel_close(getattr(ts, f), getattr(world["jstate"], f), 1e-5)
    for fn in ("body_frame_state", "joint_state"):
        for a, b in zip(getattr(TR, fn)(world["tmodel"], ts),
                        getattr(JR, fn)(world["jmodel"], world["jstate"])):
            rel_close(a, b, 1e-5)


@pytest.mark.parametrize("rows_bf16", [False, True])
def test_step_start_assembly_matches_jax(world, rows_bf16):
    """Merged rows, LHS (env-last, √w Gram) and RHS of the first substep."""
    jcfg, tcfg = (JEngineConfig(rows_bf16=rows_bf16),
                  EngineConfig(rows_bf16=rows_bf16))
    jout = JR._contact_and_jacobians(world["jmodel"], world["jterr"],
                                     world["jstate"], jcfg)
    tout = TR._contact_and_jacobians(world["tmodel"], world["tterr"],
                                     world["tstate"], tcfg)
    (jG, jW, jground, _, _, jnrm, jact, jdt, jpen, jdiag, *_) = jout
    (tG, tW, tground, _, tnrm, tact, tdt, tpen, tdiag, *_) = tout
    tol = TOL[rows_bf16]["rel"]
    for a, b in ((tG, jG), (tW, jW), (tnrm, jnrm), (tact, jact),
                 (tpen, jpen), (tdiag, jdiag), (tdt, jdt)):
        rel_close(a.float(), np.asarray(b, np.float32), tol)
    for a, b in zip(tground, jground):
        rel_close(a.float(), np.asarray(b, np.float32), tol)
    jA = JR._assemble_lhs_merged(world["jmodel"], jG, jW, jdiag, jground,
                                 None, "capsule", sqrt_gram=True)
    tA = TR._assemble_lhs_merged(world["tmodel"], tG, tW, tdiag, tground)
    assert tA.shape == (TR.NU, TR.NU, N)
    rel_close(tA, jA, tol)


@pytest.mark.parametrize("rows_bf16", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_step_matches_jax(world, steps, rows_bf16):
    jcfg, tcfg = (JEngineConfig(rows_bf16=rows_bf16),
                  EngineConfig(rows_bf16=rows_bf16))
    js, ts = world["jstate"], world["tstate"]
    tgt = world["target"]
    for _ in range(steps):
        js = JR.step(world["jmodel"], world["jterr"], js, jnp.asarray(tgt),
                     jcfg)
        ts = TR.step(world["tmodel"], world["tterr"], ts,
                     torch.as_tensor(tgt), tcfg)
    tol = TOL[rows_bf16]
    assert np.abs(np.asarray(js.contact_force)).max() > 100.0  # in contact
    for f in ("root_pos", "body_x"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=tol["pos"])
    for f in ("root_rot", "joint_rot", "body_q", "u", "body_v", "body_w",
              "contact_force"):
        rel_close(getattr(ts, f), getattr(js, f), tol["rel"])


CONFIG_FIELDS = (
    "control_dt", "n_substeps", "gravity", "static_friction",
    "dynamic_friction", "linear_damping", "angular_damping",
    "contact_stiffness", "contact_damping", "friction_vel_ref",
    "max_friction_damping", "self_contact", "mesh_contacts",
    "max_depenetration", "max_linear_velocity", "max_angular_velocity",
    "blocked_solver", "tgs_step", "rows_bf16", "terrain_patch",
    "batch_major_solver", "gram_kernel", "sqrt_gram")


def test_engine_config_defaults_match_jax():
    j, t = JEngineConfig(), EngineConfig()
    for f in CONFIG_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.substep_dt == j.substep_dt


@pytest.mark.parametrize("field,value", [
    ("batch_major_solver", True), ("tgs_step", False),
    ("blocked_solver", False), ("n_substeps", 1), ("gram_kernel", True),
    ("sqrt_gram", False), ("self_contact", True), ("mesh_contacts", True),
    ("terrain_patch", 32)])
def test_engine_config_takes_ported_branches(field, value):
    """The solver, assembly and contact branches the port runs construct,
    with JAX's values in every other field."""
    j, t = JEngineConfig(**{field: value}), EngineConfig(**{field: value})
    for f in CONFIG_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.substep_dt == j.substep_dt


@pytest.mark.parametrize("precision", ["ieee", "tf32"])
def test_step_runs_full_f32_and_restores_caller_precision(world, monkeypatch,
                                                          precision):
    """The step's matmuls run in full float32 whatever the caller chose,
    and the caller's setting comes back afterwards."""
    matmul = torch.backends.cuda.matmul
    seen = []
    inner = TR._tgs_step

    def spy(*args):
        seen.append(matmul.fp32_precision)
        return inner(*args)

    monkeypatch.setattr(TR, "_tgs_step", spy)
    prev = matmul.fp32_precision
    matmul.fp32_precision = precision
    try:
        TR.step(world["tmodel"], world["tterr"], world["tstate"],
                torch.as_tensor(world["target"]), EngineConfig())
        assert seen == ["ieee"]
        assert matmul.fp32_precision == precision
    finally:
        matmul.fp32_precision = prev
