"""No run loads JAX or the JAX package (top-level names compared whole:
the port's own name begins with the JAX package's), and the plain
reference loads nothing of the port."""
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, run_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "emloco_tpu"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(tiny, cell):
    mods = run_tiny(tiny, "tiny_" + cell)["modules"]
    assert not {m.split(".")[0] for m in mods} & FORBIDDEN
    assert "emloco_tpu_torch" in {m.split(".")[0] for m in mods}


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import sys, torch
sys.path.insert(0, {ROOT!r})
from port_bench import weights
from port_bench.reference import compare, optim, policy, solve, transmotion, valuenet
p = weights.make(valuenet.param_spec(13), 0, "cpu")
s = dict(wp=torch.randn(5, 13, 2), pose=torch.randn(5, 24, 3),
         vel=torch.randn(5, 2), target=torch.rand(5), valid=torch.ones(5))
vc = dict(lr=1e-3, warmup_steps=100, total_steps=25000, weight_decay=1e-4)
valuenet.train(p, vc, [s, s])
A = torch.eye(6)[..., None].repeat(1, 1, 3) * 2
solve.resolve_gap(A, torch.ones(6, 3), torch.full((6, 3), 0.5))
from port_bench.reference import humanoid, world
b = world.bodies(world.betas(2, 0), "cpu")
g = humanoid.Ground(*world.heights(0, map_length=1.0, num_tiles=1), "cpu")
q = torch.tensor([0.0, 0.0, 0.0, 1.0])
s = humanoid.refresh(b, dict(
    root_pos=torch.tensor([[0.0, 0.0, 1.0]] * 2), root_rot=q.repeat(2, 1),
    joint_rot=q.repeat(2, 23, 1), u=torch.zeros(2, 75)))
e = dict(n_substeps=2, control_dt=1 / 30, gravity=-9.81,
         contact_stiffness=240000.0, contact_damping=2000.0,
         friction_vel_ref=0.05, static_friction=1.0, dynamic_friction=1.0,
         max_depenetration=0.02, max_friction_damping=4000.0,
         linear_damping=0.05, angular_damping=0.05, max_linear_velocity=50.0,
         max_angular_velocity=60.0)
env = dict(dt=1 / 30, num_traj_samples=15, traj_sample_timestep=0.4,
           episode_dur=11.2, sensor_extent=2.0, sensor_res=32,
           height_meas_scale=5.0, location_coefficient=1.0,
           power_coefficient=5e-4)
subs, o, r = humanoid.control_step(b, g, s, torch.zeros(2, 69),
                                   torch.zeros(2, 8, 3),
                                   torch.zeros(2, dtype=torch.long), env, e)
assert o.shape == (2, 1422) and torch.isfinite(o).all()
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"emloco_tpu_torch", "emloco_tpu", "jax", "jaxlib", "flax"}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
