"""The port's contact variants of the engine against the JAX engine's step:
self-contact, the mesh colliders, the terrain window, self + mesh on
implicit substeps, and the `gram_kernel` Gram with self-contact.

Each configuration runs one three-step rollout in both packages from the
world of tests/test_torch_physics.py (randomly posed, moving humanoids
touching down on mixed terrain; in two of them the legs cross, so their
self pairs interpenetrate) and is compared after step 1 and step 3 under
that file's tolerances (bf16 rows: 2⁻⁸ of each quantity's largest
magnitude, 1e-4 m on poses). On the CPU the JAX engine solves with
jnp.linalg.cholesky, the whole LHS; with self-contact so does the port
(the dense kernel's plain version), because six pairs fill entries outside
the block-arrow pattern (test_torch_contacts.py).

As in tests/test_torch_engine_paths.py, the `gram_kernel` configuration is
held against the JAX step with `sqrt_gram=False`, the Gram the kernel
computes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.physics import EngineConfig as JEngineConfig
from emloco_tpu.physics import reduced as JR
from emloco_tpu_torch.physics import EngineConfig
from emloco_tpu_torch.physics import linalg
from emloco_tpu_torch.physics import reduced as TR
from test_torch_physics import TOL, rel_close, world  # noqa: F401

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

CONFIGS = {
    "self_contact": dict(self_contact=True),
    "mesh": dict(mesh_contacts=True),
    "terrain_patch": dict(terrain_patch=32),
    "self_mesh_implicit": dict(self_contact=True, mesh_contacts=True,
                               tgs_step=False),
    "gram_self": dict(gram_kernel=True, self_contact=True),
}
JAX = {name: {**kw, "sqrt_gram": False} for name, kw in CONFIGS.items()
       if kw.get("gram_kernel")}
STEPS = (1, 3)
# kernel launches per control step on the card (the wrappers' calls here)
WRAPPER_CALLS = {
    "self_contact": {"cholesky_solve_soa_t": 2},
    "mesh": {"cholesky_factor_blocked_t": 1, "cholesky_resolve_blocked_t": 2},
    "terrain_patch": {"cholesky_factor_blocked_t": 1,
                      "cholesky_resolve_blocked_t": 2},
    "self_mesh_implicit": {"cholesky_solve_soa_t": 2},
    "gram_self": {"gram_diag": 1, "to_env_last": 1,
                  "cholesky_solve_soa_t": 2},
    "gram_mesh": {"gram_diag": 1, "to_env_last": 1,
                  "cholesky_factor_blocked_t": 1,
                  "cholesky_resolve_blocked_t": 2},
    "self_batch_major": {"cholesky_solve_soa_t": 2},
}


@pytest.fixture(scope="module")
def rollouts(world):
    """name → {steps: (JAX state, port state)}, each rollout run once."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = CONFIGS[name]
            jcfg = JEngineConfig(**JAX.get(name, kw))
            tcfg = EngineConfig(**kw)
            js, ts = world["jstate"], world["tstate"]
            tgt = world["target"]
            out = {}
            for k in range(1, max(STEPS) + 1):
                js = JR.step(world["jmodel"], world["jterr"], js,
                             jnp.asarray(tgt), jcfg)
                ts = TR.step(world["tmodel"], world["tterr"], ts,
                             torch.as_tensor(tgt), tcfg)
                if k in STEPS:
                    out[k] = (js, ts)
            cache[name] = out
        return cache[name]

    return get


def test_world_has_interpenetrating_self_pairs(world):
    ts = world["tstate"]
    pen = TR._self_contact_geometry(world["tmodel"], ts.body_x, ts.body_q)[3]
    assert int((pen > 0).sum()) >= 1


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_contact_configuration_matches_jax(rollouts, name, steps):
    js, ts = rollouts(name)[steps]
    tol = TOL[True]
    assert np.abs(np.asarray(js.contact_force)).max() > 100.0  # in contact
    for f in ("root_pos", "body_x"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=tol["pos"])
    for f in ("root_rot", "joint_rot", "body_q", "u", "body_v", "body_w",
              "contact_force"):
        rel_close(getattr(ts, f), getattr(js, f), tol["rel"])


@pytest.mark.parametrize("name", list(WRAPPER_CALLS))
def test_contact_configuration_calls_its_solvers(world, monkeypatch, name):
    """Each variant reaches exactly these solver wrappers: the block-arrow
    factor and resolves, or with self-contact the dense solve each substep
    (also under `batch_major_solver`, which then stays env-last)."""
    kw = {"gram_mesh": dict(gram_kernel=True, mesh_contacts=True),
          "self_batch_major": dict(self_contact=True,
                                   batch_major_solver=True)}.get(
        name, CONFIGS.get(name))
    calls = dict.fromkeys(linalg.LAUNCHES, 0)
    for fn in calls:
        inner = getattr(linalg, fn)

        def spy(*a, _fn=fn, _inner=inner, **k):
            calls[_fn] += 1
            return _inner(*a, **k)

        monkeypatch.setattr(linalg, fn, spy)
        if hasattr(TR, fn):
            monkeypatch.setattr(TR, fn, spy)
    st = TR.step(world["tmodel"], world["tterr"], world["tstate"],
                 torch.as_tensor(world["target"]), EngineConfig(**kw))
    assert bool(torch.isfinite(st.u).all())
    want = dict.fromkeys(linalg.LAUNCHES, 0)
    want.update(WRAPPER_CALLS[name])
    assert calls == want
