"""The minibatch's loss and gradients as one CUDA graph
(`AMPAgent._loss_and_grads`, `utils/cuda_graph.py`), on the CPU.

On the CPU the call stays eager and counts `eager` only. The dispatch is
held with the device test answering "on the card" and a stand-in for
`cuda_graph.Captured` that runs the function it was given: a mesh's split
and a hooked network stay eager; every other call captures once per key
and replays, inside the spans `trainer.loss_graph_capture` and
`trainer.loss_graph_replay`. The key separates masks from none, the sept
and sept_cnn networks, dtypes, row counts, configs and precisions. Last,
the benchmark's reader `loss_graph_share.train` on known spans. The graph
itself runs on the card only (`chip_smoke.py`'s `loss_graph` phase).
"""
import dataclasses
import os
import sys
import time

import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning import amp_agent
from emloco_tpu_torch.learning.amp_agent import (AMPAgent, AMPConfig,
                                                 MinibatchSplit, build_net)
from emloco_tpu_torch.physics import generate_mixed_terrain
from emloco_tpu_torch.utils import cuda_graph, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from port_bench import core  # noqa: E402

torch.set_num_threads(1)

WIDTHS = dict(mlp_units=(32, 16), task_units=(16, 8), value_units=(15, 6),
              disc_units=(24, 12))
MB, DEMO, HALF = 16, 8, 4          # minibatch, demo and replay rows
SPANS = ("trainer.loss_and_grads", "trainer.loss_graph_capture",
         "trainer.loss_graph_replay")


@pytest.fixture(scope="module")
def env():
    return PedestrianTerrainEnv(
        EnvConfig(num_envs=4, sensor_res=8, episode_length=48,
                  num_amp_obs_steps=3),
        generate_mixed_terrain(map_length=4.0, num_tiles=2, difficulty=0.5,
                               device="cpu"),
        tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                   device="cpu"), device="cpu")


def make_agent(env, network="sept", **cfg):
    agent = AMPAgent(env, AMPConfig(amp_replay_size=16, **cfg))
    agent.net = build_net(env.cfg, env.task_obs_dim, agent.amp_dim, network,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu", **WIDTHS)
    return agent


def inputs(agent, rows=MB, dtype=torch.float32, masks=True, seed=0):
    """(params, minibatch, demo, replay, masks) at `rows` minibatch rows."""
    gen = torch.Generator().manual_seed(seed)
    A, obs, amp = agent.env.cfg.num_actions, agent.env.obs_dim, agent.amp_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen).to(dtype)
    params = {k: v.detach().to(dtype)
              for k, v in agent.net.named_parameters()}
    mb = dict(obs_n=normal(rows, obs), flip_obs_n=normal(rows, obs),
              action=normal(rows, A), logp=normal(rows) - 50.0,
              adv=normal(rows), ret_n=normal(rows),
              ret_01=torch.rand(rows, generator=gen).to(dtype),
              amp_n=normal(rows, amp))
    m = (tuple((torch.rand((r, amp), generator=gen) > 0.3).to(dtype)
               for r in (min(HALF, rows), HALF, DEMO)) if masks else None)
    return params, mb, normal(DEMO, amp), normal(HALF, amp), m


def key(agent, params, mb, demo, replay, masks):
    leaves, _ = tree_flatten((params, mb, demo, replay, masks or ()))
    return agent._loss_graph_key(params, mb, leaves)


def equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


class FakeCaptured:
    """Stands in for a captured graph on the CPU: runs the function it was
    given on each call; `made` lists the captures."""
    made: list = []

    def __init__(self, fn, leaves, spec, counters=()):
        self.fn, self.spec = fn, spec
        FakeCaptured.made.append(self)

    def __call__(self, leaves):
        return self.fn(*tree_unflatten(leaves, self.spec))


@pytest.fixture
def on_card(monkeypatch):
    """The device test answering "on the card", the stand-in capture, and
    zeroed counters."""
    FakeCaptured.made = []
    monkeypatch.setattr(amp_agent, "_on_card", lambda x: True)
    monkeypatch.setattr(cuda_graph, "Captured", FakeCaptured)
    amp_agent.reset_loss_graph_counts()
    return FakeCaptured.made


def test_cpu_calls_stay_eager(env):
    agent = make_agent(env)
    args = inputs(agent)
    amp_agent.reset_loss_graph_counts()
    with profiling.recording() as recs:
        out = agent._loss_and_grads(*args)
        agent._loss_and_grads(*args[:4], None)
    assert amp_agent.LOSS_GRAPH == dict(captures=0, replays=0, eager=2)
    assert [r[0] for r in recs if r[0] in SPANS] == [SPANS[0]] * 2
    assert not agent._loss_graphs
    assert equal(out, agent._compute_loss_and_grads(*args))


def test_split_and_hooks_stay_eager(env, on_card):
    agent = make_agent(env)
    args = inputs(agent)
    whole = MinibatchSplit(rollout=HALF, mb=MB, agent=2 * HALF, demo=DEMO,
                           param_terms=True)
    out = agent._loss_and_grads(*args, split=whole)
    assert equal(out, agent._compute_loss_and_grads(*args))
    handle = agent.net.actor_mlp[0].register_forward_hook(
        lambda *a: None)
    try:
        agent._loss_and_grads(*args)
    finally:
        handle.remove()
    handle = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda *a: None)
    try:
        agent._loss_and_grads(*args)
    finally:
        handle.remove()
    assert (on_card, amp_agent.LOSS_GRAPH) == (
        [], dict(captures=0, replays=0, eager=3))
    agent._loss_and_grads(*args)
    assert amp_agent.LOSS_GRAPH == dict(captures=1, replays=1, eager=3)


def test_a_capture_a_key_and_a_replay_a_call(env, on_card):
    agent = make_agent(env)
    args = inputs(agent)
    with profiling.recording() as recs:
        out = agent._loss_and_grads(*args)
        again = agent._loss_and_grads(*inputs(agent, seed=1))
        agent._loss_and_grads(*args[:4], None)
        agent._loss_and_grads(*inputs(agent, rows=MB // 2))
        agent._loss_and_grads(*args)
    assert amp_agent.LOSS_GRAPH == dict(captures=3, replays=5, eager=0)
    assert len(on_card) == len(agent._loss_graphs) == 3
    assert equal(out, agent._compute_loss_and_grads(*args))
    assert not equal(out, again)
    names = [r[0] for r in recs]
    assert [names.count(n) for n in SPANS] == [5, 3, 5]
    for name, _, _, parent in recs:
        if name in SPANS[1:]:
            assert recs[parent][0] == SPANS[0]


@pytest.mark.parametrize("change", ["masks", "rows", "dtype", "network",
                                    "config", "precision",
                                    "cudnn_deterministic"])
def test_the_key_separates(env, change):
    agent = make_agent(env)
    base = key(agent, *inputs(agent))
    assert key(agent, *inputs(agent, seed=2)) == base
    other = agent
    kw = {}
    if change == "masks":
        kw["masks"] = False
    elif change == "rows":
        kw["rows"] = MB // 2
    elif change == "dtype":
        kw["dtype"] = torch.float64
    elif change == "network":
        # another net object of the same structure, then the conv net
        assert key(make_agent(env), *inputs(agent)) != base
        other = make_agent(env, network="sept_cnn")
    elif change == "config":
        other.cfg = dataclasses.replace(agent.cfg, motion_sym_loss=False)
    prec = torch.backends.cuda.matmul.fp32_precision
    det = torch.backends.cudnn.deterministic
    if change == "precision":
        torch.backends.cuda.matmul.fp32_precision = (
            "tf32" if prec == "ieee" else "ieee")
    elif change == "cudnn_deterministic":
        torch.backends.cudnn.deterministic = not det
    try:
        assert key(other, *inputs(other, **kw)) != base
    finally:
        torch.backends.cuda.matmul.fp32_precision = prec
        torch.backends.cudnn.deterministic = det


def test_the_sept_cnn_loss_dispatches_alike(env, on_card):
    """The conv network through the stand-in: its own capture, the eager
    numbers."""
    agent = make_agent(env, network="sept_cnn")
    args = inputs(agent)
    assert equal(agent._loss_and_grads(*args),
                 agent._compute_loss_and_grads(*args))
    assert amp_agent.LOSS_GRAPH == dict(captures=1, replays=1, eager=0)


def record(spans):
    """A run's record whose profiled unit holds the program spans
    `spans` (names, each (name, children)), recorded for real."""
    with profiling.recording():
        t0 = time.time_ns()
        for name, inner in spans:
            with profiling.annotate(name):
                for child in inner:
                    with profiling.annotate(child):
                        pass
        t1 = time.time_ns()
    prof = core.Profile(ops=[("k", t0, 1)], spans=[], start_ns=t0,
                        end_ns=t1)
    return core.Record(setup_s=1.0, window_s=1.0, units=1,
                       work_per_unit={}, flops_per_unit=0.0, spans=None,
                       profile=prof, counts={})


@pytest.mark.parametrize("spans, want", [
    ([(SPANS[0], [SPANS[2]])] * 3, 100.0),
    ([(SPANS[0], [SPANS[1], SPANS[2]])] + [(SPANS[0], [SPANS[2]])] * 3,
     100.0),
    ([(SPANS[0], [SPANS[2]]), (SPANS[0], [])], 50.0),
    ([(SPANS[0], [])] * 2, 0.0),
    ([("trainer.optimizer", [])], None),
])
def test_loss_graph_share_reader(spans, want):
    read = core.load_module("metrics", "loss_graph_share.train").read
    rec = record(spans)
    assert read(rec) == want
    rec.profile = None
    assert read(rec) is None


@pytest.mark.requires_cuda
@pytest.mark.parametrize("network", ["sept", "sept_cnn"])
def test_graph_matches_eager_on_card(env, network):
    """Three updates in turn on the card, the loss graphed and eager from
    the same state, cuDNN's deterministic algorithms on: one capture, a
    replay a call, bit-equal losses, gradients and parameters, and the
    first call's outputs untouched by the later replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        agent = make_agent(env, network=network)
        batches = [tree_map(lambda t: t.to("cuda"), inputs(agent, seed=s))
                   for s in range(3)]
        runs = []
        amp_agent.reset_loss_graph_counts()
        for call in (agent._loss_and_grads, agent._compute_loss_and_grads):
            params = batches[0][0]
            opt = agent.tx.init(params)
            run = []
            for _, mb, demo, replay, masks in batches:
                out = call(params, mb, demo, replay, masks)
                if not run:
                    first = tree_map(torch.clone, out)
                params, opt, _ = agent._apply_grads(params, opt, out[2])
                run.append((out, params))
            runs.append(run)
            # what the first call returned, after the later calls
            assert equal(run[0][0], first)
        assert equal(runs[0], runs[1])
        assert amp_agent.LOSS_GRAPH == dict(captures=1, replays=3, eager=0)
    finally:
        torch.backends.cudnn.deterministic = det
