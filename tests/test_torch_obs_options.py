"""The observation options of the port against emloco_tpu's
(envs/observations.py): `remove_base_rot`, and `humanoid_obs_max`,
`amp_obs`, `location_obs` and `group_obs` (groups of 8) under every
(root_height_obs, upright) pair, the first two with and without betas and
limb weights, on N = 32 random body states made from a seed with numpy.

Both packages compute the same float32 operations in the same order:
within 1e-5 of the largest |value|.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import observations as jobs
from emloco_tpu_torch.envs import observations as tobs

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 32
REL = 1e-5
GROUP = 8
PAIRS = list(itertools.product((False, True), (False, True)))
EXTRAS = ("none", "betas", "limb", "both")


def rel_close(actual, desired, rel=REL):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    assert actual.shape == desired.shape
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


def rand_quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def rand_body_state(rng, n=N, joints=24):
    """As tests/test_obs_parity.py:_rand_body_state makes them."""
    pos = rng.normal(size=(n, joints, 3)).astype(np.float32)
    pos[..., 2] += 1.0
    rot = rand_quats(rng, (n, joints))
    vel = rng.normal(size=(n, joints, 3)).astype(np.float32)
    ang = rng.normal(size=(n, joints, 3)).astype(np.float32)
    return pos, rot, vel, ang


def extras(rng, which):
    """(betas, limb weights) of the case `which`; None where left out."""
    betas = rng.normal(size=(N, 17)).astype(np.float32)
    limb = rng.normal(size=(N, 10)).astype(np.float32)
    return (betas if which in ("betas", "both") else None,
            limb if which in ("limb", "both") else None)


def both(*arrays):
    """(the arrays as jnp, the arrays as tensors); None stays None."""
    return ([None if a is None else jnp.asarray(a) for a in arrays],
            [None if a is None else torch.from_numpy(a) for a in arrays])


def test_remove_base_rot():
    q = rand_quats(np.random.default_rng(0), (N, 24))
    (jq,), (tq,) = both(q)
    rel_close(tobs.remove_base_rot(tq), jobs.remove_base_rot(jq))


@pytest.mark.parametrize("which", EXTRAS)
@pytest.mark.parametrize("root_h,upright", PAIRS)
def test_humanoid_obs_max(root_h, upright, which):
    rng = np.random.default_rng(1)
    j, t = both(*rand_body_state(rng), *extras(rng, which))
    kw = dict(root_height_obs=root_h, upright=upright)
    want = jobs.humanoid_obs_max(*j[:4], betas=j[4], limb_weights=j[5], **kw)
    got = tobs.humanoid_obs_max(*t[:4], betas=t[4], limb_weights=t[5], **kw)
    rel_close(got, want)
    assert got.shape[1] == (tobs.SELF_OBS_DIM + root_h
                            + 11 * (t[4] is not None)
                            + 10 * (t[5] is not None))


@pytest.mark.parametrize("which", EXTRAS)
@pytest.mark.parametrize("root_h,upright", PAIRS)
def test_amp_obs(root_h, upright, which):
    rng = np.random.default_rng(2)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    inputs = (f32(N, 3), rand_quats(rng, (N,)), f32(N, 3), f32(N, 3),
              f32(N, 23, 3), f32(N, 23, 3), f32(N, 4, 3),
              *extras(rng, which))
    j, t = both(*inputs)
    kw = dict(root_height_obs=root_h, upright=upright)
    want = jobs.amp_obs(*j[:7], betas=j[7], limb_weights=j[8], **kw)
    got = tobs.amp_obs(*t[:7], betas=t[7], limb_weights=t[8], **kw)
    rel_close(got, want)
    assert got.shape[1] == (tobs.AMP_OBS_DIM + root_h
                            + 11 * (t[7] is not None)
                            + 10 * (t[8] is not None))


@pytest.mark.parametrize("upright", (False, True))
def test_location_obs(upright):
    rng = np.random.default_rng(3)
    root_pos = rng.normal(size=(N, 3)).astype(np.float32)
    samples = (root_pos[:, None]
               + rng.normal(size=(N, 10, 3)).astype(np.float32))
    j, t = both(root_pos, rand_quats(rng, (N,)), samples)
    rel_close(tobs.location_obs(*t, upright=upright),
              jobs.location_obs(*j, upright=upright))


@pytest.mark.parametrize("upright", (False, True))
def test_group_obs(upright):
    """Groups of 8 people within a few metres, so that every neighbour
    counts and none lies beyond max_dist."""
    rng = np.random.default_rng(4)
    pos, rot, vel, _ = rand_body_state(rng)
    j, t = both(pos, vel, rand_quats(rng, (N,)))
    rel_close(tobs.group_obs(*t, GROUP, upright=upright),
              jobs.group_obs(*j, GROUP, upright=upright))


def test_remove_base_rot_is_the_product():
    """The written-out product equals quat.mul(q, conj(base)) bit for bit,
    and the base itself goes to the identity."""
    from emloco_tpu_torch.ops import quat
    q = torch.from_numpy(rand_quats(np.random.default_rng(5), (N, 24)))
    base_conj = torch.tensor([-0.5, -0.5, -0.5, 0.5])
    assert torch.equal(tobs.remove_base_rot(q), quat.mul(q, base_conj))
    assert torch.equal(tobs.remove_base_rot(torch.full((4,), 0.5)),
                       torch.tensor([0.0, 0.0, 0.0, 1.0]))
