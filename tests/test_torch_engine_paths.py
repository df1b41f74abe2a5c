"""The port's engine configurations against the JAX engine's: the fully
re-assembled implicit substeps (`tgs_step=False`, `n_substeps=1`), the dense
solver, the batch-major layout, and the LHS assembly's two-operand Gram
(`sqrt_gram=False`, or a weak contact whose weights can go negative) and
`gram_kernel` Gram.

Each configuration runs one three-step rollout in both packages from the
world of tests/test_torch_physics.py (randomly posed, moving humanoids
touching down on mixed terrain) and is compared after step 1 and step 3
under that file's tolerances (`TOL`, bf16 or float32 rows). On the CPU the
JAX engine solves these branches with jnp.linalg.cholesky + cho_solve and
lays the system out batch-major whenever `batch_major_solver` is set; the
port takes the Pallas side of the JAX rule (batch-major only with the
block-arrow solver) and its plain kernels clamp pivots. On these SPD systems
all of them are exact factorizations, so they differ by float32 rounding.

On the CPU the JAX engine never runs its gram branch (`gram_kernel and
use_pallas`): with `gram_kernel=True` it assembles the √w Gram, which rounds
√w∘R to bf16 and, over three steps of these stiff contacts, drifts from the
two-operand Gram by more than one bf16 ulp. The Gram kernel computes the
two-operand Gram (tests/test_engine.py:889 holds it to that einsum; under
jit XLA forms w∘R in float32 there, as the kernel does), so the port's gram
configurations are held against the JAX step with `sqrt_gram=False` (JAX
below), at the same tolerance.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.physics import EngineConfig as JEngineConfig
from emloco_tpu.physics import reduced as JR
from emloco_tpu_torch.kinematics import body_model as tbm
from emloco_tpu_torch.ops import quat as tq
from emloco_tpu_torch.physics import EngineConfig, make_heightfield
from emloco_tpu_torch.physics import linalg
from emloco_tpu_torch.physics import reduced as TR
from emloco_tpu_torch.rollout import build_bench
from test_torch_physics import TOL, rel_close, world  # noqa: F401

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

CONFIGS = {
    "implicit": dict(tgs_step=False),
    "one_substep": dict(n_substeps=1),
    "implicit_dense": dict(tgs_step=False, blocked_solver=False),
    "tgs_batch_major": dict(batch_major_solver=True),
    "implicit_batch_major": dict(tgs_step=False, batch_major_solver=True),
    "implicit_f32_rows": dict(tgs_step=False, rows_bf16=False),
    "gram": dict(gram_kernel=True),
    "gram_batch_major": dict(gram_kernel=True, batch_major_solver=True),
    "gram_implicit": dict(gram_kernel=True, tgs_step=False),
    "two_operand": dict(sqrt_gram=False),
    "weak_contact": dict(contact_stiffness=1000.0, max_friction_damping=1e5),
}
# the JAX step a configuration is held against, where it is not the same
JAX = {name: {**kw, "sqrt_gram": False} for name, kw in CONFIGS.items()
       if kw.get("gram_kernel")}
STEPS = (1, 3)


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


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_configuration_matches_jax(rollouts, name, steps):
    js, ts = rollouts(name)[steps]
    tol = TOL[CONFIGS[name].get("rows_bf16", True)]
    assert np.abs(np.asarray(js.contact_force)).max() > 100.0  # in contact
    for f in ("root_pos", "body_x"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=tol["pos"])
    for f in ("root_rot", "joint_rot", "body_q", "u", "body_v", "body_w",
              "contact_force"):
        rel_close(getattr(ts, f), getattr(js, f), tol["rel"])


# kernel launches per control step of each configuration on the card (the
# CPU path launches none; the dispatch is checked through the wrappers)
WRAPPER_CALLS = {
    "implicit": {"cholesky_solve_blocked_t": 2},
    "one_substep": {"cholesky_solve_blocked_t": 1},
    "implicit_dense": {"cholesky_solve_soa_t": 2},
    "tgs_batch_major": {"to_env_last": 1, "cholesky_factor_blocked_t": 1,
                        "cholesky_resolve_blocked": 2},
    "implicit_batch_major": {"to_env_last": 2,
                             "cholesky_solve_blocked_t": 2},
    "gram": {"gram_diag": 1, "to_env_last": 1,
             "cholesky_factor_blocked_t": 1, "cholesky_resolve_blocked_t": 2},
    "gram_batch_major": {"gram_diag": 1, "to_env_last": 1,
                         "cholesky_factor_blocked_t": 1,
                         "cholesky_resolve_blocked": 2},
    "gram_implicit": {"gram_diag": 2, "to_env_last": 2,
                      "cholesky_solve_blocked_t": 2},
    "gram_implicit_dense": {"gram_diag": 2, "to_env_last": 2,
                            "cholesky_solve_soa_t": 2},
    "two_operand": {"cholesky_factor_blocked_t": 1,
                    "cholesky_resolve_blocked_t": 2},
    "default": {"cholesky_factor_blocked_t": 1,
                "cholesky_resolve_blocked_t": 2},
    "batch_major_dense": {"cholesky_factor_blocked_t": 1,
                          "cholesky_resolve_blocked_t": 2},
}


@pytest.mark.parametrize("name", list(WRAPPER_CALLS))
def test_engine_configuration_calls_its_solvers(world, monkeypatch, name):
    """Each configuration reaches exactly the solver wrappers of its JAX
    branch, as often as the JAX step does; `batch_major_solver` without the
    block-arrow solver is the env-last TGS step, as on a TPU."""
    kw = {"default": {},
          "batch_major_dense": dict(batch_major_solver=True,
                                    blocked_solver=False),
          "gram_implicit_dense": dict(gram_kernel=True, tgs_step=False,
                                      blocked_solver=False)}.get(
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
    TR.step(world["tmodel"], world["tterr"], world["tstate"],
            torch.as_tensor(world["target"]), EngineConfig(**kw))
    want = dict.fromkeys(linalg.LAUNCHES, 0)
    want.update(WRAPPER_CALLS[name])
    assert calls == want


def test_tgs_step_matches_full_substeps():
    """Port of tests/test_engine.py::test_tgs_step_matches_full_substeps on
    the port alone: over a 1 s PD-driven rollout of two standing humanoids
    on flat ground, the TGS step stays within 5 cm of fully re-assembled
    substeps and both stay standing."""
    n = 2
    model = TR.build_model(tbm.build_body_params(torch.zeros((n, 16)),
                                                 device="cpu"))
    terrain = make_heightfield(np.zeros((200, 200), np.float32), 0.1,
                               (-10.0, -10.0), np.zeros((1, 2), np.float32),
                               device="cpu")
    z = model.params.height_offset[:, None]
    st0 = TR.kinematic_state(
        model, TR.default_tree(),
        torch.cat([torch.zeros((n, 2)), z], -1), tq.identity_like((n,)),
        tq.identity_like((n, tbm.NUM_BODIES)))
    target = torch.zeros((n, 23, 3))
    target[:, 0, 0] = 0.3
    target[:, 4, 0] = -0.4
    cfg_tgs = EngineConfig(n_substeps=2, tgs_step=True)
    cfg_full = dataclasses.replace(cfg_tgs, tgs_step=False)
    s_t, s_f = st0, st0
    for _ in range(30):
        s_t = TR.step(model, terrain, s_t, target, cfg_tgs)
        s_f = TR.step(model, terrain, s_f, target, cfg_full)
    assert torch.isfinite(s_t.body_x).all()
    dx = (s_t.body_x - s_f.body_x).abs().max().item()
    assert dx < 0.05, f"TGS diverged from full substeps by {dx:.3f} m"
    assert s_t.root_pos[:, 2].min().item() > 0.5


def test_bench_rollout_runs_each_configuration():
    """The bench rollout at 2 envs on the CPU under every configuration:
    `build_bench(engine=...)` and `Rollout.with_engine` (same terrain,
    motion library and actor) give the same control step, and it is
    finite."""
    base = build_bench(num_envs=2, device="cpu")
    for kw in CONFIGS.values():
        eng = EngineConfig(**kw)
        r = base.with_engine(eng)
        assert r.cfg.engine == eng and r.actor is base.actor
        env, env0 = r.env, base.env
        for a, b in ((env.terrain.heights, env0.terrain.heights),
                     (env.motion_lib.root_pos, env0.motion_lib.root_pos)):
            assert a.data_ptr() == b.data_ptr()             # shared, no copy
        st, out, o, mu = r.control_step(
            r.env.reset(torch.Generator().manual_seed(0)))
        assert all(bool(torch.isfinite(t).all())
                   for t in (o, mu, out.obs, out.reward, st.physics.u))
    fresh = build_bench(num_envs=2, device="cpu", engine=eng)
    st_f, out_f, _, _ = fresh.control_step(
        fresh.env.reset(torch.Generator().manual_seed(0)))
    torch.testing.assert_close(out_f.obs, out.obs, rtol=0, atol=0)
    torch.testing.assert_close(st_f.physics.u, st.physics.u, rtol=0, atol=0)
