"""The port's crowd configuration against the benchmark's plain reference
(`port_bench/reference/crowd.py`), on the CPU at a small size: 8 envs in
groups of 4 (3 people each and 2 zero-padded), sensor_res 8, the
published channel widths (convs 16-32-32, pointnet 32-64-64), the world
and the agent built through the entry as the benchmark's `crowd_train`
driver builds them, with its seeded weights.

Compared: the crowd observation and the stamped velocity map from the
reset state, and from a state whose people all stand beyond 10 m; the
mirror of the observation; the actor, critic and task-value heads; one
PPO + AMP minibatch's loss and gradients in float64 at 1e-10 (float32
gradients part at ReLU and max-pool kinks, ROADMAP.md's hazard), the
padded people tying in the max-pool. Also: the cell's spawn stamps people
into most envs' sensors; the cell's files load as `core.run_cell` loads
them; the program's crowd spans and host counters.
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from emloco_tpu_torch.envs import observations as obs_mod  # noqa: E402
from emloco_tpu_torch.learning import networks  # noqa: E402
from emloco_tpu_torch.utils import profiling  # noqa: E402
from port_bench import core, pacer  # noqa: E402
from port_bench.reference import crowd, humanoid, world  # noqa: E402

torch.set_num_threads(1)

CELL = "pacer_crowd.train"
SEED = 2**31 + 4242
RES = 8
TINY = {"env": {"num_envs": 8, "group_size": 4, "sensor_res": RES,
                "group_spawn_spread": 2.0},
        "amp": {"horizon": 4, "num_minibatches": 2, "mini_epochs": 1,
                "amp_batch_size": 8, "amp_replay_size": 64},
        "terrain": {"num_tiles": 2}}
REL = 1e-5          # float32 observations, the same arithmetic in order
F64 = 1e-10


def _driver():
    return core.load_module("drivers", "crowd_train")


def _ctx(run, widths=None, seed=SEED):
    wl = dict(core.load_json("workloads", CELL), traffic={"run": run})
    cfg = core.load_json("configs", "pacer_crowd")
    cfg["widths"] = dict(cfg["widths"], **(widths or {}))
    dev = torch.device("cpu")
    return core.Context(cell=CELL, workload=wl, config=cfg, seed=seed,
                        device=dev, spans=core.Spans(False, dev))


def rel_close(a, b, rel):
    a, b = a.double(), b.double()
    scale = max(float(b.abs().max()), 1e-6)
    assert float((a - b).abs().max()) <= rel * scale, \
        float((a - b).abs().max()) / scale


@pytest.fixture(scope="module")
def tiny():
    drv = _driver()
    ctx = _ctx(TINY, {"sensor_res": RES, "task_obs": 30 + 3 * RES * RES
                      + 165})
    cfg, agent, ts, d, s = drv.build(ctx)
    w = drv.world_of(cfg, s)
    b = world.bodies(world.betas(w["num_envs"], w["seed"]), "cpu")
    h, cell, origin = world.heights(w["terrain_seed"], **w["terrain"])
    ground = humanoid.Ground(h, cell, origin, "cpu")
    return dict(cfg=cfg, agent=agent, ts=ts, d=d, w=w, b=b, ground=ground)


def _state(es):
    return {k: v.clone() for k, v in pacer._state(es.physics).items()}


def _ref_obs(t, es, s=None):
    s = _state(es) if s is None else s
    return crowd.observe(t["b"], t["ground"], s, es.traj_verts,
                         es.progress, t["w"]["env"])


def test_reference_world_is_the_programs(tiny):
    env = tiny["agent"].env
    assert torch.equal(env.terrain.heights.cpu(), tiny["ground"].h)
    assert tiny["w"]["env"]["group_size"] == 4


def test_crowd_observation_and_stamped_map(tiny):
    env, es = tiny["agent"].env, tiny["ts"].env_state
    prog, ref = env.observe(es), _ref_obs(tiny, es)
    S = env.cfg.self_obs_dim
    T, P = 2 * env.cfg.num_traj_samples, 3 * RES * RES
    assert prog.shape == ref.shape == (8, S + T + P + 165)
    for lo, hi in ((0, S + T), (S + T, S + T + P), (S + T + P, None)):
        rel_close(prog[:, lo:hi], ref[:, lo:hi], REL)
    # the groups of 4 see 3 people and pad 2; someone is stamped
    people = ref[:, -165:]
    assert people[:, 90:150].abs().max() == 0 and people[:, 159:].abs(
    ).max() == 0
    assert people[:, :90].abs().max() > 0
    s = _state(es)
    pos, grot, _, _ = humanoid.pivot_frame(tiny["b"], s)
    assert crowd.stamped_share(pos, grot[:, 0], s["body_v"][:, 0], 4,
                               tiny["w"]["env"]) > 0


def test_people_beyond_range_read_zero(tiny):
    """Every person 20 m from the others: the crowd observation is zero and
    nothing is stamped, in the program and in the reference."""
    env, es = tiny["agent"].env, tiny["ts"].env_state
    from emloco_tpu_torch.envs.pedestrian_terrain import body_frame_state
    pos, rot, vel, _ = body_frame_state(env.model, es.physics)
    shift = torch.zeros_like(pos)
    shift[..., 0] = 20.0 * torch.arange(8.0)[:, None]
    pos = pos + shift
    gsz = env.cfg.obs_group_size
    go = obs_mod.group_obs(pos, es.physics.body_v, rot[:, 0], gsz)
    assert go.abs().max() == 0
    rgo = crowd.crowd_obs(pos, es.physics.body_v[:, 0], pos[:, 0],
                          rot[:, 0], gsz)
    assert rgo.abs().max() == 0
    head, root, v0 = pos[:, env._head], pos[:, 0], es.physics.body_v[:, 0]
    vm = obs_mod.group_velocity_map_obs(
        env.terrain, head, rot[:, 0], root[:, :2], env.sensor_grid, root,
        v0, gsz, env.cfg.height_meas_scale)
    plain = obs_mod.velocity_map_obs(env.terrain, head, rot[:, 0],
                                     root[:, :2], env.sensor_grid, v0,
                                     env.cfg.height_meas_scale)
    rvm = crowd.velocity_map(tiny["ground"], head, root[:, :2], rot[:, 0],
                             v0, root[:, :2], v0, gsz, tiny["w"]["env"])
    # no stamp: the heights are the plain map's, the velocities its too
    # but for the rotation's rounding
    assert torch.equal(vm[:, 0::3], plain[:, 0::3])
    rel_close(vm, plain, REL)
    rel_close(vm, rvm, REL)


def test_mirror(tiny):
    env, es = tiny["agent"].env, tiny["ts"].env_state
    prog = env.observe(es)
    ref = crowd.mirror(tiny["b"], _state(es), _ref_obs(tiny, es),
                       tiny["w"]["env"])
    rel_close(env.observe_flipped_from(prog), ref, REL)
    # a mirror is an involution on the task part
    S = env.cfg.self_obs_dim
    twice = crowd.mirror(tiny["b"], _state(es), ref, tiny["w"]["env"])
    assert torch.equal(twice[:, S:], _ref_obs(tiny, es)[:, S:])


def _f64(tree):
    return {k: v.detach().double() for k, v in tree.items()}


@pytest.mark.parametrize("head", ["actor", "critic", "task_value"])
def test_heads(tiny, head):
    agent, d = tiny["agent"], tiny["d"]
    p = _f64(tiny["ts"].params)
    o = agent.env.observe(tiny["ts"].env_state).double()
    got = agent._apply(p, head, o)
    ref = crowd.heads(p, d, o, actor=head == "actor",
                      critic=head == "critic",
                      task_value=head == "task_value")
    want = {"actor": "mu", "critic": "v", "task_value": "tv"}[head]
    got = got[0] if head == "actor" else got
    rel_close(got, ref[want], F64)


def _minibatch(tiny, masks):
    agent = tiny["agent"]
    env, es = agent.env, tiny["ts"].env_state
    g = torch.Generator().manual_seed(11)
    o = env.observe(es).double()
    amp = agent.amp_dim
    mu = agent._apply(_f64(tiny["ts"].params), "actor", o)[0].detach()
    action = mu + 0.05 * torch.randn(mu.shape, generator=g,
                                     dtype=torch.float64)
    mb = dict(obs_n=o, flip_obs_n=env.observe_flipped_from(o),
              action=action,
              logp=agent._logp(mu, torch.exp(tiny["ts"].params[
                  "log_sigma"].double()), action)
              + 0.1 * torch.randn(8, generator=g, dtype=torch.float64),
              adv=torch.randn(8, generator=g, dtype=torch.float64),
              ret_n=torch.randn(8, generator=g, dtype=torch.float64),
              ret_01=torch.rand(8, generator=g, dtype=torch.float64),
              amp_n=torch.randn(8, amp, generator=g, dtype=torch.float64))
    demo = torch.randn(4, amp, generator=g, dtype=torch.float64)
    replay = torch.randn(4, amp, generator=g, dtype=torch.float64)
    m = None
    if masks:
        step = env.cfg.amp_obs_per_step
        steps = env.cfg.num_amp_obs_steps
        m = tuple(obs_mod.amp_dropout_mask(
            obs_mod.amp_dropout_draw(g, r), steps, step).double()
            for r in (4, 4, 4))
    return mb, demo, replay, m


@pytest.mark.parametrize("masks", [False, True])
def test_minibatch_loss_and_gradients_float64(tiny, masks):
    """The zero-padded people tie in the max-pool (raw observations, not
    normalized): the program routes each tie to one entry, the reference
    splits it, and the weight gradients agree."""
    agent, d = tiny["agent"], tiny["d"]
    p = _f64(tiny["ts"].params)
    mb, demo, replay, m = _minibatch(tiny, masks)
    people = mb["obs_n"][:, -165:]
    assert people[:, 90:150].abs().max() == 0          # the tie
    total, _, grads = agent._loss_and_grads(p, mb, demo, replay, m)
    ac = {k: getattr(tiny["cfg"].amp, k) for k in (
        "e_clip", "actor_coef", "critic_coef", "bounds_coef", "disc_coef",
        "tv_coef", "sym_coef", "motion_sym_loss", "disc_logit_reg",
        "disc_grad_penalty", "disc_weight_decay")}
    q = {k: v.clone().requires_grad_() for k, v in p.items()}
    ref = crowd.minibatch_loss(q, d, ac, mb, demo, replay, m)
    rg = dict(zip(q, torch.autograd.grad(ref, list(q.values()))))
    ref = float(ref.detach())
    assert abs(float(total) - ref) <= F64 * abs(ref)
    top = max(float(g.abs().max()) for g in rg.values())
    for k in rg:
        assert float((grads[k] - rg[k]).abs().max()) <= F64 * top, k
    assert float(rg["point_net.0.weight"].abs().max()) > 0
    assert float(rg["cnn.0.weight"].abs().max()) > 0


def test_cell_spawn_stamps_most_envs():
    """Two of the cell's groups of 100, spawned within ±8 m of their
    centres on its terrain: most envs see someone in their sensor."""
    drv = _driver()
    _, agent, ts, _, s = drv.build(_ctx(
        {"env": {"num_envs": 200}, "amp": {"amp_replay_size": 64}}))
    assert agent.env.cfg.obs_group_size == 100
    st = _state(ts.env_state)
    b = world.bodies(world.betas(200, pacer.seeds(SEED)["world"]), "cpu")
    pos, grot, _, _ = humanoid.pivot_frame(b, st)
    cfg = core.load_json("configs", "pacer_crowd")["run"]["env"]
    share = crowd.stamped_share(pos, grot[:, 0], st["body_v"][:, 0], 100,
                                dict(cfg, sensor_extent=2.0))
    assert share > 0.5, share


def test_cell_files_load_as_the_harness_loads_them():
    bench = core.benchmark()
    entry = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert entry["chips"] == 1 and entry["config"] == "pacer_crowd"
    wl = core.load_json("workloads", CELL)
    cfg = core.load_json("configs", wl["config"])
    conf = next(c for c in bench["configs"] if c["name"] == "pacer_crowd")
    assert conf["file"] == "port_bench/configs/pacer_crowd.json"
    assert conf["reduced"] == ["group_size"]
    assert cfg["run"]["env"]["group_size"] == 100
    assert 1600 % cfg["run"]["env"]["group_size"] == 0
    assert cfg["widths"]["task_obs"] == 30 + 3 * 32 * 32 + 165
    drv = core.load_module("drivers", wl["driver"]).Driver()
    assert callable(drv.setup) and callable(drv.check)
    for m in (core.cell_metrics(bench, CELL, "end_to_end")
              + core.cell_metrics(bench, CELL, "per_layer")):
        read = core.load_module("metrics", m["name"]).read
        # a record with nothing to read: no raise
        rec = core.Record(setup_s=1.0, window_s=1.0, units=0,
                          work_per_unit={}, flops_per_unit=0.0,
                          spans=core.Spans(False, torch.device("cpu")),
                          profile=None, counts={})
        read(rec)
    names = {m["name"] for m in core.cell_metrics(bench, CELL, "per_layer")}
    assert {"crowd_obs_ms.crowd", "crowd_obs_roofline.crowd",
            "conv_ms.crowd", "mfu.env", "step_idle_ms.env"} <= names
    assert set(wl["limits"]) >= {"obs_gap", "flip_gap", "loss_gap",
                                 "change_gap", "state_gap"}


def test_crowd_spans_and_counters(tiny):
    env, es = tiny["agent"].env, tiny["ts"].env_state
    obs_mod.reset_crowd_counts()
    networks.reset_conv_counts()
    with profiling.recording() as recs:
        o = env.observe(es)
        tiny["agent"]._apply(tiny["ts"].params, "actor", o)
    names = [r[0] for r in recs]
    for n in ("env.group_obs", "env.velocity_map", "policy.cnn",
              "policy.pointnet"):
        assert n in names, n
    assert obs_mod.CROWD_COUNTS == {"group_obs_calls": 1, "group_obs_rows": 8,
                                    "velocity_map_calls": 1,
                                    "velocity_map_rows": 8}
    assert networks.CONV_ENCODER == {"calls": 1, "rows": 8}


def test_metric_readers_on_a_synthetic_trace():
    """The roofline reads the device time inside the benchmark's crowd
    spans; the conv time reads cuDNN's kernels inside the update span."""
    ops = [("elementwise_kernel", 100, 30),             # inside crowd span
           ("elementwise_kernel", 400, 50),             # outside
           ("sm80_xmma_fprop_implicit_gemm_f32_cudnn", 1_000, 200),
           ("void wgrad_alg0_engine_NHWC<float>", 1_300, 300),
           ("void cudnn::detail::dgrad_engine<float>", 1_700, 100),
           ("cutlass_80_simt_sgemm_128x256", 1_900, 500),
           ("void wgrad_alg0_engine_NHWC<float>", 5_000, 900)]  # rollout
    spans = [("crowd.group_obs", 90, 200), ("update", 900, 3_000)]
    prof = core.Profile(ops=ops, spans=spans, start_ns=0, end_ns=6_000)
    rec = core.Record(setup_s=1.0, window_s=1.0, units=1, work_per_unit={},
                      flops_per_unit=0.0,
                      spans=core.Spans(False, torch.device("cpu")),
                      profile=prof, counts={"minibatches": 2,
                                            "crowd_obs": {"bytes": 3350}})
    roof = core.load_module("metrics", "crowd_obs_roofline.crowd").read(rec)
    assert roof == pytest.approx(100.0 * 1e-9 / 30e-9)
    conv = core.load_module("metrics", "conv_ms.crowd").read(rec)
    assert conv == pytest.approx((200 + 300 + 100) * 1e-6 / 2)
