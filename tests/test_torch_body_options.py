"""The body options of the port against emloco_tpu's: `to_mjcf`
(kinematics/body_model.py) writes the JAX package's string byte for byte
for the same bodies (the JAX `BodyParams` carried over by
convert.body_params), at zero betas and at betas drawn from N(0, 0.3²);
`PedestrianTerrainEnv(…, betas=)` builds its bodies from the betas, and
`params` wins when both are given, also in the hand env and under a
two-rank env-axis split; `ValuePoseNet.traj_size` is JAX's.
"""
import dataclasses
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.kinematics import body_model as jbm
from emloco_tpu.learning.networks import ValuePoseNet as JValuePoseNet
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.envs.hand_task import PedestrianTerrainHandEnv
from emloco_tpu_torch.kinematics import body_model as tbm
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning.networks import ValuePoseNet
from emloco_tpu_torch.parallel import mesh as pmesh
from emloco_tpu_torch.physics import generate_mixed_terrain

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 4
SMALL = dict(num_envs=N, sensor_res=8, episode_length=48,
             num_amp_obs_steps=5)


def draw_betas(kind):
    if kind == "zero":
        return np.zeros((N, 16), np.float32)
    return (0.3 * np.random.default_rng(0).normal(size=(N, 16))
            ).astype(np.float32)


@pytest.mark.parametrize("env_idx", (0, N - 1))
@pytest.mark.parametrize("kind", ("zero", "random"))
def test_to_mjcf_is_the_jax_string(kind, env_idx):
    jparams = jbm.build_body_params(jnp.asarray(draw_betas(kind)))
    params = convert.body_params(jax.tree.map(np.asarray, jparams), "cpu")
    xml = tbm.to_mjcf(params, env_idx)
    assert xml == jbm.to_mjcf(jparams, env_idx)
    root = ET.fromstring(xml)
    assert root.tag == "mujoco"
    assert len(root.findall(".//body")) == 24
    assert len(root.findall(".//joint")) == 69   # 23 joints × 3 hinges
    assert len(root.findall(".//motor")) == 69


def test_to_mjcf_of_the_ports_bodies():
    """The port's own bodies from the same betas, under another model name:
    the JAX package's string for its bodies."""
    params = tbm.build_body_params(draw_betas("random"), device="cpu")
    jparams = jbm.build_body_params(jnp.asarray(draw_betas("random")))
    xml = tbm.to_mjcf(params, 1, "a")
    assert ET.fromstring(xml).get("model") == "a"
    assert xml == jbm.to_mjcf(jparams, 1, "a")


@pytest.fixture(scope="module")
def world():
    terrain = generate_mixed_terrain(map_length=6.0, num_tiles=2,
                                     difficulty=0.5, device="cpu")
    lib = tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                     device="cpu")
    return terrain, lib


def params_equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(tbm.BodyParams))


@pytest.mark.parametrize("env_cls", (PedestrianTerrainEnv,
                                     PedestrianTerrainHandEnv))
def test_env_betas(world, env_cls):
    """`betas=` builds the same bodies as params=build_body_params(betas);
    `params` overrides `betas`; zero betas stay the default."""
    cfg = EnvConfig(**SMALL)
    betas = draw_betas("random")
    built = tbm.build_body_params(betas, device="cpu")
    zero = tbm.build_body_params(draw_betas("zero"), device="cpu")
    from_betas = env_cls(cfg, *world, device="cpu", betas=betas)
    assert params_equal(from_betas.params, built)
    assert params_equal(
        env_cls(cfg, *world, device="cpu", betas=torch.from_numpy(betas)
                ).params, built)
    assert params_equal(env_cls(cfg, *world, params=zero, device="cpu",
                                betas=betas).params, zero)
    assert params_equal(env_cls(cfg, *world, device="cpu").params, zero)


def test_env_betas_under_a_mesh(world):
    """Under a two-rank split each rank keeps its rows of the bodies built
    from the whole env axis's betas, as it keeps its rows of `params`."""
    cfg = EnvConfig(**SMALL)
    betas = draw_betas("random")
    built = tbm.build_body_params(betas, device="cpu")
    for rank in range(2):
        mesh = pmesh.Mesh(rank, 2, "cpu")
        env = PedestrianTerrainEnv(cfg, *world, device="cpu", mesh=mesh,
                                   betas=betas)
        rows = mesh.block(N)
        assert params_equal(env.params,
                            built.map_tensors(lambda t: t[rows]))


@pytest.mark.parametrize("waypoints", (13, 5))
def test_traj_size(waypoints):
    net = ValuePoseNet(num_waypoints=waypoints, device="cpu")
    assert net.traj_size == JValuePoseNet(num_waypoints=waypoints).traj_size
    assert net.fc1.in_features == net.traj_size + 72 + 2
