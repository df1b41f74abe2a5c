"""The port's sensor and crowd observation functions against emloco_tpu's
(envs/observations.py): the fan and forward-square sensor grids, the
`SENSOR_GRIDS` table and `grid_flip_perm` bit for bit; `velocity_map_obs`,
`group_obs` (groups too small for 5 neighbours pad with zeros; neighbours
beyond 10 m are zeroed) and `group_velocity_map_obs` with people inside the
footprints, within 1e-5 of the largest magnitude, on inputs made from a
seed with numpy over a mixed terrain.

Both packages compute the same float32 operations in the same order; a
sensor point within rounding of a terrain cell edge or of a footprint box
edge could read the other side on the other package, which these seeds do
not meet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import observations as jobs
from emloco_tpu.physics import generate_mixed_terrain as jgen
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import observations as tobs

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

REL = 1e-5
SHAPES = ("square", "fov", "square_fov")


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


@pytest.fixture(scope="module")
def terrain():
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    hf = convert.heightfield(jax_tree(jterr), "cpu")
    lo = np.asarray(hf.origin) + 2.0
    hi = lo + np.asarray(hf.shape) * hf.cell - 4.0
    return jterr, hf, lo, hi


def jax_tree(x):
    return jax.tree.map(np.asarray, x)


def random_quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def both(*arrays):
    """(the arrays as jnp, the arrays as tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.as_tensor(np.array(a)) for a in arrays])


@pytest.mark.parametrize("shape", SHAPES)
def test_sensor_grids_bit_equal(shape):
    want = jobs.SENSOR_GRIDS[shape](2.0, 8)
    got = tobs.SENSOR_GRIDS[shape](2.0, 8)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert set(tobs.SENSOR_GRIDS) == set(jobs.SENSOR_GRIDS)


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_flip_perm_bit_equal(shape):
    grid = jobs.SENSOR_GRIDS[shape](2.0, 8)
    perm = tobs.grid_flip_perm(grid)
    np.testing.assert_array_equal(perm, jobs.grid_flip_perm(grid))
    np.testing.assert_array_equal(perm[perm], np.arange(len(grid)))


def test_grid_flip_perm_refuses_an_asymmetric_grid():
    with pytest.raises(ValueError):
        tobs.grid_flip_perm(np.array([[0.0, 0.1], [0.0, 0.5]], np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_velocity_map_obs_matches_jax(terrain, shape):
    jterr, hf, lo, hi = terrain
    rng = np.random.default_rng(1)
    n = 8
    root = rng.uniform(lo, hi, (n, 2)).astype(np.float32)
    head = np.concatenate([root + rng.normal(0, 0.1, (n, 2)),
                           rng.uniform(1.4, 1.8, (n, 1))], -1)
    head = head.astype(np.float32)
    rot = random_quats(rng, n)
    vel = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    grid = jobs.SENSOR_GRIDS[shape](2.0, 8)
    (jh, jr, jc, jv), (th, tr, tc, tv) = both(head, rot, root, vel)
    want = jobs.velocity_map_obs(jterr, jh, jr, jc, grid, jv)
    got = tobs.velocity_map_obs(hf, th, tr, tc, torch.as_tensor(grid), tv)
    assert got.shape == (n, len(grid) * 3)
    rel_close(got, want, REL)


def crowd(rng, n, spread, lo, hi, group_size):
    """Bodies of `n` people in groups of `group_size`, each group within
    `spread` m of its center: body positions around the root, velocities,
    root rotations."""
    G = n // group_size
    centers = rng.uniform(lo, hi, (G, 2))
    root_xy = (np.repeat(centers, group_size, 0)
               + rng.uniform(-spread, spread, (n, 2)))
    root = np.concatenate([root_xy, rng.uniform(0.8, 1.0, (n, 1))], -1)
    body = root[:, None] + rng.normal(0, 0.3, (n, 24, 3))
    body[:, 0] = root
    vel = rng.normal(0, 1.0, (n, 24, 3))
    return (body.astype(np.float32), vel.astype(np.float32),
            random_quats(rng, n))


@pytest.mark.parametrize("n,group_size,spread", [
    (8, 4, 1.0),       # 3 neighbours: pads 2
    (12, 6, 1.0),      # 5 neighbours
    (12, 12, 9.0),     # some neighbours beyond 10 m are zeroed
    (4, 2, 0.5),       # 1 neighbour: pads 4
])
def test_group_obs_matches_jax(terrain, n, group_size, spread):
    _, _, lo, hi = terrain
    rng = np.random.default_rng(n + group_size)
    body, vel, rot = crowd(rng, n, spread, lo, hi, group_size)
    (jb, jv, jr), (tb, tv, tr) = both(body, vel, rot)
    want = jobs.group_obs(jb, jv, jr, group_size)
    got = tobs.group_obs(tb, tv, tr, group_size)
    assert got.shape == (n, 5 * 11 * 3)
    rel_close(got, want, REL)
    if spread > 5:
        assert (np.asarray(want) == 0).any()
    if group_size - 1 < 5:
        k = group_size - 1
        np.testing.assert_array_equal(got[:, k * 30:150].numpy(), 0.0)
        np.testing.assert_array_equal(got[:, 150 + 3 * k:].numpy(), 0.0)


@pytest.mark.parametrize("shape,n,group_size", [
    ("square", 8, 4), ("fov", 8, 8), ("square_fov", 6, 3),
    ("square", 4, 2)])
def test_group_velocity_map_obs_matches_jax(terrain, shape, n, group_size):
    jterr, hf, lo, hi = terrain
    rng = np.random.default_rng(7 + n)
    body, vel, rot = crowd(rng, n, 1.2, lo, hi, group_size)
    root, root_vel = body[:, 0], vel[:, 0]
    head = root + np.array([0.0, 0.0, 0.7], np.float32)
    grid = jobs.SENSOR_GRIDS[shape](2.0, 16)
    (jh, jr, jc, jp, jv), (th, tr, tc, tp, tv) = both(
        head, rot, root[:, :2].copy(), root, root_vel)
    want = jobs.group_velocity_map_obs(jterr, jh, jr, jc, grid, jp, jv,
                                       group_size)
    got = tobs.group_velocity_map_obs(hf, th, tr, tc, torch.as_tensor(grid),
                                      tp, tv, group_size)
    assert got.shape == (n, len(grid) * 3)
    rel_close(got, want, REL)
    # people stand inside some footprints: +1.7 m on those points
    plain = tobs.velocity_map_obs(hf, th, tr, tc, torch.as_tensor(grid), tv)
    stamped = (got.reshape(n, -1, 3)[..., 0]
               < plain.reshape(n, -1, 3)[..., 0] - 1.0)
    assert bool(stamped.any())
