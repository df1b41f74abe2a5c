"""The program's spans (`utils.profiling.annotate`): off they touch no
profiler and record nothing; on (inside `recording()` or a torch.profiler
session) they nest, lie inside their `emloco:` profiler ranges, and count
the work of a training epoch, a LocoVal epoch and a predictor step, whose
results stay bit-equal with recording on or off.

The card test holds the shared clock on the card: in one profiled control
step each block-arrow factor kernel starts at or after the
`physics.factor` span that launched it. It needs neither jax nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_tracing.py -k on_card
"""
import os
import re
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning import AMPSeptValueNet
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
from emloco_tpu_torch.learning.networks import ValuePoseNet
from emloco_tpu_torch.learning.value_train import (LocoValTrainer,
                                                   ValueTrainConfig)
from emloco_tpu_torch.physics import generate_mixed_terrain
from emloco_tpu_torch.prediction.model import TransMotionConfig
from emloco_tpu_torch.prediction.train import (PredictorTrainer,
                                               PredictTrainConfig)
from emloco_tpu_torch.utils import profiling as TP

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 4
SMALL = dict(num_envs=N, sensor_res=8, episode_length=48,
             num_amp_obs_steps=3)
WIDTHS = dict(mlp_units=(32, 16), task_units=(16, 8), value_units=(15, 6),
              disc_units=(24, 12))
AMP = AMPConfig(horizon=4, num_minibatches=2, mini_epochs=2,
                amp_batch_size=8, amp_replay_size=24)
PREDICTOR = dict(nhid=16, nhead=2, dim_ff=32, nlayers_local=2,
                 nlayers_global=1, nmode=3)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "jta_all_cues_fixture.ndjson")
# a span's host interval lies within its profiler range, on one clock
CLOCK_NS = 100_000


def names(recs):
    return [r[0] for r in recs]


def children(recs, i):
    return [r for r in recs if r[3] == i]


def agent_on(device="cpu"):
    env = PedestrianTerrainEnv(
        EnvConfig(**SMALL),
        generate_mixed_terrain(map_length=4.0, num_tiles=2, difficulty=0.5,
                               device=device),
        tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                   device=device), device=device)
    agent = AMPAgent(env, AMP)
    agent.net = AMPSeptValueNet(
        env.cfg.num_actions, env.cfg.self_obs_dim,
        env.cfg.num_traj_samples * 2, env.cfg.task_obs_dim, agent.amp_dim,
        **WIDTHS, device=device)
    return agent


def assert_tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_off_touches_no_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("an off span opened a profiler range")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = TP.records()
    n = len(before)
    with TP.annotate("env.step"):
        with TP.annotate("physics.step"):
            x = torch.ones(3).sum()
    assert float(x) == 3.0
    assert TP.records() is before and len(before) == n
    assert TP.annotate("a") is TP.annotate("b")


def test_recording_nests_spans():
    with TP.recording() as recs:
        with TP.annotate("trainer.update"):
            with TP.annotate("trainer.loss_and_grads"):
                pass
            with TP.annotate("trainer.optimizer"):
                with TP.annotate("trainer.minibatch_draw"):
                    pass
        with TP.annotate("trainer.rollout"):
            pass
    assert recs is TP.records()
    assert names(recs) == ["trainer.update", "trainer.loss_and_grads",
                           "trainer.optimizer", "trainer.minibatch_draw",
                           "trainer.rollout"]
    assert [r[3] for r in recs] == [None, 0, 0, 2, None]
    for name, t0, t1, parent in recs:
        assert t0 <= t1
        if parent is not None:
            assert recs[parent][1] <= t0 and t1 <= recs[parent][2]
    with TP.annotate("after"):
        pass
    assert len(TP.records()) == 5        # the block has closed: off again


def test_a_profiler_session_records_within_its_ranges():
    a = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TP.annotate("predictor.step"):
            for _ in range(3):
                with TP.annotate("predictor.forward"):
                    (a @ a).sum()
    recs = list(TP.records())
    assert names(recs) == ["predictor.step"] + ["predictor.forward"] * 3
    assert [r[3] for r in recs] == [None, 0, 0, 0]
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(TP.PREFIX) and \
                e.device_type() == DeviceType.CPU:
            ranges.setdefault(e.name()[len(TP.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in ranges:
        ranges[name].sort()
    seen = {}
    for name, t0, t1, _ in recs:
        k = seen.get(name, 0)
        seen[name] = k + 1
        r0, r1 = ranges[name][k]
        assert r0 - CLOCK_NS <= t0 <= t1 <= r1 + CLOCK_NS, (name, t0 - r0,
                                                            r1 - t1)
    with profile(activities=[ProfilerActivity.CPU]):
        assert TP.records() == []
        with TP.annotate("env.step"):
            pass
    assert names(TP.records()) == ["env.step"]


def test_profiler_sessions_followed_where_torch_has_the_hooks():
    calls = []
    hooks = types.SimpleNamespace(
        _run_on_profiler_start=lambda: calls.append("start"),
        _run_on_profiler_stop=lambda: calls.append("stop"))
    assert TP._follow_profiler_sessions(hooks)
    start = hooks._run_on_profiler_start
    assert TP._follow_profiler_sessions(hooks)       # wrapped once
    assert hooks._run_on_profiler_start is start
    hooks._run_on_profiler_start()
    with TP.annotate("env.step"):
        pass
    hooks._run_on_profiler_stop()
    with TP.annotate("env.observe"):
        pass
    assert calls == ["start", "stop"]
    assert names(TP.records()) == ["env.step"]
    # a torch without them: spans record inside recording() alone
    assert not TP._follow_profiler_sessions(types.SimpleNamespace())
    assert not TP._follow_profiler_sessions(types.SimpleNamespace(
        _run_on_profiler_start=None, _run_on_profiler_stop=None))


def test_train_epoch_spans_count_its_work():
    agent = agent_on()
    ts_off, _ = agent.train_epoch(agent.init(0))
    with TP.recording() as recs:
        ts_on, m = agent.train_epoch(agent.init(0))
    assert float(m["nonfinite_grad"]) == 0.0
    assert_tree_equal(ts_on.params, ts_off.params)
    assert_tree_equal(ts_on.opt_state.mu, ts_off.opt_state.mu)
    assert torch.equal(ts_on.replay_amp, ts_off.replay_amp)
    steps = [i for i, r in enumerate(recs) if r[0] == "env.step"]
    assert len(steps) == AMP.horizon
    for i in steps:
        assert names(children(recs, i)).count("physics.step") == 1
        assert recs[recs[i][3]][0] == "trainer.rollout"
    opt = [r for r in recs if r[0] == "trainer.optimizer"]
    assert len(opt) == AMP.mini_epochs * AMP.num_minibatches
    assert all(recs[r[3]][0] == "trainer.update" for r in opt)
    top = [r[0] for r in recs if r[3] is None]
    assert top == ["trainer.rollout", "trainer.prepare", "trainer.update"]
    assert {"policy.actor", "policy.critic", "policy.disc_reward",
            "env.reward", "env.ends", "env.auto_reset", "env.observe",
            "physics.contacts", "physics.assemble", "physics.factor",
            "physics.solve", "physics.integrate", "trainer.minibatch_draw",
            "trainer.loss_and_grads"} <= set(names(recs))
    assert all(t1 is not None for _, _, t1, _ in recs)


def test_locoval_epoch_spans_count_its_work():
    agent = agent_on()
    vcfg = ValueTrainConfig(horizon=4, step_to_pred=2)

    def epoch():
        tr = LocoValTrainer(agent, ValuePoseNet(device="cpu"), vcfg)
        return tr.train_epoch(tr.init(agent.init(0), 1))
    ts_off, _ = epoch()
    with TP.recording() as recs:
        ts_on, _ = epoch()
    assert_tree_equal(ts_on.vnet_params, ts_off.vnet_params)
    assert torch.equal(ts_on.cum_reward, ts_off.cum_reward)
    steps = [i for i, r in enumerate(recs) if r[0] == "env.step"]
    assert len(steps) == vcfg.horizon
    for i in steps:
        assert names(children(recs, i)).count("physics.step") == 1
        assert recs[recs[i][3]][0] == "locoval.collect"
    assert names(recs).count("locoval.latch") == vcfg.horizon
    assert names(recs).count("policy.actor") == vcfg.horizon
    assert names(recs).count("locoval.update") == 1
    # the collect observes before each step, and the step observes again
    assert names(recs).count("env.observe") == 2 * vcfg.horizon


def test_predictor_step_spans_count_its_work():
    from emloco_tpu_torch.prediction import data as tdata

    vnet = ValuePoseNet(device="cpu")
    vp = {k: v.detach().clone() for k, v in vnet.named_parameters()}

    def step():
        tr = PredictorTrainer(
            TransMotionConfig(**PREDICTOR),
            PredictTrainConfig(lr=1e-3, use_value_loss=True), vnet=vnet,
            device="cpu")
        return tr.train_step(tr.init(0, vnet_params=vp), *batch)
    batch = next(tdata.NdjsonScenes(FIXTURE, max_people=3, seed=0)
                 .batches(2, 1))
    ts_off, _ = step()
    with TP.recording() as recs:
        ts_on, _ = step()
    assert_tree_equal(ts_on.params, ts_off.params)
    assert names([r for r in recs if r[3] is None]) == ["predictor.step"]
    assert names(children(recs, 0)) == ["predictor.upload",
                                        "predictor.forward",
                                        "predictor.value_loss",
                                        "predictor.backward",
                                        "predictor.optimizer"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_factor_kernels_start_inside_their_spans_on_card(cuda):
    from emloco_tpu_torch import rollout
    ro = rollout.build_bench(num_envs=64, device=cuda)
    state = ro.env.reset(torch.Generator(device=cuda).manual_seed(0))
    state = ro.control_step(state)[0]                  # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ro.control_step(state)
        torch.cuda.synchronize()
    spans = [r for r in TP.records() if r[0] == "physics.factor"]
    kernel = re.compile(r"(^|[^A-Za-z0-9_])factor_kernel")
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results
                    .events() if e.device_type() == DeviceType.CUDA
                    and kernel.search(e.name()))
    assert len(spans) == len(starts) == 1
    for (_, t0, _, _), k0 in zip(spans, starts):
        assert k0 >= t0, (k0 - t0)
