"""The port's config-built world (emloco_tpu_torch/cli/run.py
`_build_world`) on the CPU against the JAX CLI's for each task (the JAX
betas fed in), with the reference-format trajectory bank and motion pickle
read by both packages; the world's defaults and the bank formats."""
import pickle

import jax
import numpy as np
import pytest
import torch

from emloco_tpu.cli import run as JRUN
from emloco_tpu.envs import getup as jgetup
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.utils import config as JC
from emloco_tpu_torch.cli import run as RUN
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.prediction import export
from emloco_tpu_torch.utils import config as TC

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

WORLD = ["env.num_envs=4", "env.sensor_res=8", "env.num_amp_obs_steps=3",
         "terrain.map_length=2.0", "terrain.num_tiles=2", "seed=3"]
TASKS = {"terrain": [], "hand": ["task=hand"],
         "getup": ["task=getup", "env.fall_gen_steps=2"]}


def close(got, want, rtol=4e-6, atol=2e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A motion pickle in the reference's format (two motions of one length,
    so that the JAX package's eager ops compile once, one with a 10-value
    beta) and a trajectory bank as the reference's dict of per-scene (V, 3)
    arrays."""
    d = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    motions = {}
    for i, (F, nb, fps) in enumerate(((20, 16, 30.0), (20, 10, 25.0))):
        motions[f"m{i}"] = dict(
            pose_aa=(rng.randn(F, 72) * 0.2).astype(np.float64),
            root_trans_offset=np.cumsum(rng.rand(F, 3) * 0.03, 0)
            + [0, 0, 0.9],
            beta=rng.randn(nb) * 0.5, fps=fps)
    bank = {f"scene_{k}": np.concatenate(
        [np.cumsum(rng.randn(101, 2) * 0.05, 0), rng.rand(101, 1)], 1)
        for k in range(5)}
    paths = {"motions": str(d / "motions.pkl"), "bank": str(d / "bank.pkl")}
    for key, obj in (("motions", motions), ("bank", bank)):
        with open(paths[key], "wb") as f:
            pickle.dump(obj, f)
    return paths, bank


def test_load_reference_pkl_matches_jax(data):
    paths, _ = data
    j = jml.load_reference_pkl(paths["motions"])
    t = tml.load_reference_pkl(paths["motions"], device="cpu")
    for f in ("local_rot", "root_pos", "root_vel", "root_ang_vel", "key_pos",
              "betas", "fps", "length_starts", "num_frames", "durations",
              "weights"):
        close(getattr(t, f), getattr(j, f))
    close(t.dof_vel, j.dof_vel, rtol=1e-5, atol=1e-5)
    assert t.betas.shape == (2, 16) and not t.betas[1, 10:].any()
    one = tml.load_reference_pkl(paths["motions"], max_motions=1,
                                 device="cpu")
    assert one.num_motions == 1


@pytest.mark.parametrize("task", sorted(TASKS))
def test_build_world_matches_jax(task, data, monkeypatch):
    paths, bank = data
    over = [*WORLD, *TASKS[task], f"motions={paths['motions']}",
            f"real_traj_pkl={paths['bank']}"]
    if task == "getup":
        # the fall bank compiles the JAX engine; the worlds are compared
        # here, the bank in test_torch_env_variants.py
        monkeypatch.setattr(jgetup.PedestrianTerrainGetupEnv,
                            "_generate_fall_states", lambda self, key: None)
    jcfg, tcfg = JC.load_config(None, over), TC.load_config(None, over)
    jenv = JRUN._build_world(jcfg)
    betas = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (4, 16))
                       * 0.3)
    tenv = RUN._build_world(tcfg, "cpu", betas=betas)
    assert type(tenv).__name__ == type(jenv).__name__
    jt, tt = jenv.terrain, tenv.terrain
    np.testing.assert_array_equal(tt.heights.numpy(), np.asarray(jt.heights))
    np.testing.assert_array_equal(tt.corner_tex.numpy(),
                                  np.asarray(jt.corner_tex))
    assert (tt.cell, tt.origin) == (jt.cell, jt.origin)
    # the same walkable cells; JAX's C++ table rounds in float32 (§C)
    a, b = np.asarray(jt.spawnable_xy), tt.spawnable_xy.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b[np.lexsort(b.T)], a[np.lexsort(a.T)],
                               rtol=0, atol=1e-6)
    want = np.stack(list(bank.values()))[..., :2].astype(np.float32)
    np.testing.assert_array_equal(tenv.real_traj_bank.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jenv.real_traj_bank), want)
    jl, tl = jenv.motion_lib, tenv.motion_lib
    for f in ("local_rot", "root_pos", "key_pos", "betas", "num_frames",
              "durations", "weights"):
        close(getattr(tl, f), getattr(jl, f))
    jp, tp = jenv.params, tenv.params
    np.testing.assert_array_equal(tp.betas.numpy(), np.asarray(jp.betas))
    for f in ("local_offsets", "capsule_radius", "capsule_half", "mass",
              "inertia", "kp", "kd", "torque_limit", "joint_limit",
              "height_offset", "mesh_points", "mesh_point_radius"):
        close(getattr(tp, f), getattr(jp, f))
    assert tenv.cfg == tcfg.env


def test_world_defaults_and_bank_formats(tmp_path, data):
    """Betas drawn from the seed (the same on every call), the synthetic
    bank and motions without files, the bank export's format, and a joblib
    file refused with a clear error."""
    cfg = TC.load_config(None, [*WORLD, "engine.mesh_contacts=true"])
    env = RUN._build_world(cfg, "cpu")
    want = RUN.draw_betas(4, 3)
    assert want.shape == (4, 16) and 0.15 < want.std() < 0.45
    np.testing.assert_array_equal(env.params.betas.numpy(), want)
    np.testing.assert_array_equal(RUN.draw_betas(4, 3), want)
    # mesh contacts fit the colliders to the SMPL fixture
    assert env.params.mesh_points.shape[2] > 0
    assert env.real_traj_bank.shape == (256, 101, 2)
    assert env.motion_lib.num_motions == 6
    waypoints = np.cumsum(np.random.RandomState(1).randn(3, 13, 2) * 0.4,
                          1)
    path = str(tmp_path / "export.pkl")
    trajs = export.export_traj_bank(waypoints, path,
                                    init_poses=np.zeros((3, 24, 3)))
    np.testing.assert_array_equal(
        RUN.load_real_traj_bank(path, "cpu").numpy(),
        trajs.astype(np.float32))
    joblib = pytest.importorskip("joblib")
    for compress in (3, 0):
        bad = str(tmp_path / f"bank_{compress}.pkl")
        joblib.dump({"a": waypoints[0]}, bad, compress=compress)
        with pytest.raises(ValueError, match="joblib|compressed"):
            RUN.load_real_traj_bank(bad, "cpu")
