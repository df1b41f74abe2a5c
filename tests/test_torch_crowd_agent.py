"""The port's crowd agent against emloco_tpu's: every head of AMPSeptCNNNet
(the conv encoder over the 8×8×3 velocity-map image) and of
AMPSeptValueNet, both with the people pointnet over the crowd observation,
in float32 and under `hidden_bf16`; `query_value_gradient`; the refusals of the network choice; the `train`
entry point with the crowd overrides. 4 envs in one group, sensor_res 8, 3
AMP steps, network widths of a few dozen.

Tolerances: float32 heads and query_value_gradient 1e-5 of each output's
largest magnitude; bfloat16 heads 2^-6 of it (each bf16 layer rounds its
product and its bias sum to 8 bits, in other sum orders on the two
packages).

The crowd agent's update against JAX's is in
tests/test_torch_crowd_update.py (its JAX compile alone takes 25 s).
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import EnvConfig as JEnvConfig
from emloco_tpu.envs import PedestrianTerrainEnv as JEnv
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.learning.amp_agent import AMPAgent as JAgent
from emloco_tpu.learning.amp_agent import AMPConfig as JAMPConfig
from emloco_tpu.learning.networks import AMPSeptCNNNet as JCNN
from emloco_tpu.learning.networks import AMPSeptValueNet as JNet
from emloco_tpu.learning.running_norm import RunningNorm as JRunningNorm
from emloco_tpu.physics import generate_mixed_terrain as jgen
from emloco_tpu_torch import convert, train
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning.amp_agent import (AMPAgent, AMPConfig,
                                                 build_net)
from test_torch_crowd_env import jx, to_jax_state

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 4
CROWD = dict(num_envs=N, sensor_res=8, episode_length=48,
             num_amp_obs_steps=3, group_obs=True, group_size=4,
             velocity_map=True)
WIDTHS = dict(mlp_units=(32, 16), task_units=(16, 8), value_units=(15, 6),
              disc_units=(24, 12))
F32_REL, BF16_REL = 1e-5, 2.0 ** -6
HEADS = ("actor", "critic", "disc", "task_value")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


def jax_net(cfg, network, bf16):
    kw = dict(num_actions=cfg.num_actions, self_obs_dim=cfg.self_obs_dim,
              traj_obs_dim=cfg.num_traj_samples * 2,
              task_obs_dim=cfg.task_obs_dim, people_obs_dim=5 * 11 * 3,
              hidden_bf16=bf16, **WIDTHS)
    if network == "sept_cnn":
        return JCNN(sensor_res=cfg.sensor_res, sensor_channels=3, **kw)
    return JNet(**kw)


def to_flax(sd):
    """A port state_dict as flax params: `cnn.0.weight` → `cnn_0` kernel,
    Linear weights transposed to (in, out), Conv2d's OIHW to HWIO."""
    out = {"log_sigma": jnp.asarray(sd["log_sigma"].numpy())}
    for key, w in sd.items():
        if not key.endswith(".weight"):
            continue
        layer = key[:-len(".weight")]
        w = w.detach().numpy()
        w = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
        out[layer.replace(".", "_")] = {
            "kernel": jnp.asarray(w),
            "bias": jnp.asarray(sd[f"{layer}.bias"].detach().numpy())}
    return {"params": out}


@pytest.fixture(scope="module")
def world():
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    lib = tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                     device="cpu")
    jlib = jml.MotionLib(**{f.name: jx(getattr(lib, f.name))
                            for f in dataclasses.fields(lib)})
    jcfg, cfg = JEnvConfig(**CROWD), EnvConfig(**CROWD)
    jenv = JEnv(jcfg, jterr, jlib)
    env = PedestrianTerrainEnv(cfg, convert.heightfield(np_tree(jterr),
                                                        "cpu"),
                               lib, device="cpu")
    amp_dim = cfg.num_amp_obs_steps * cfg.amp_obs_per_step
    return dict(jenv=jenv, env=env, jcfg=jcfg, cfg=cfg, amp_dim=amp_dim)


@pytest.fixture(scope="module")
def nets(world):
    """(flax net, its params, the port net with them) by (network, bf16):
    the port's initialization carried to flax (whose own init compiles for
    longer than every test here), checked against the structure and shapes
    of flax's init."""
    out = {}
    cfg, amp_dim = world["cfg"], world["amp_dim"]
    o = jnp.zeros((1, cfg.obs_dim))
    a = jnp.zeros((1, amp_dim))
    for seed, network in enumerate(("sept_cnn", "sept")):
        sd = build_net(cfg, cfg.task_obs_dim, amp_dim, network,
                       generator=torch.Generator().manual_seed(seed),
                       device="cpu", **WIDTHS).state_dict()
        params = to_flax(sd)
        like = jax.eval_shape(jax_net(cfg, network, False).init,
                              jax.random.PRNGKey(1), o, a)
        assert (jax.tree.structure(like) == jax.tree.structure(params))
        assert all(x.shape == y.shape for x, y in zip(
            jax.tree.leaves(like), jax.tree.leaves(params)))
        for bf16 in (False, True):
            tnet = build_net(cfg, cfg.task_obs_dim, amp_dim, network, bf16,
                             device="cpu", **WIDTHS)
            tnet.load_state_dict(convert.agent_state_dict(np_tree(params)))
            out[network, bf16] = (jax_net(cfg, network, bf16), params, tnet)
    return out


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("network", ["sept_cnn", "sept"])
def test_heads_match_jax(world, nets, network, bf16, head):
    net, params, tnet = nets[network, bf16]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(
        (9, world["amp_dim"] if head == "disc"
         else world["cfg"].obs_dim)).astype(np.float32)
    want = net.apply(params, jnp.asarray(x), method=getattr(net, head))
    with torch.no_grad():
        got = tnet(t_(x), method=head)
    if head != "actor":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        rel_close(g, w, BF16_REL if bf16 else F32_REL)


@pytest.mark.parametrize("network", ["sept_cnn", "sept"])
def test_port_init_has_flax_layout(world, nets, network):
    """The port's own initialization: flax's parameter names, shapes and
    zero biases; the pointnet's max-pool is invariant to the people's
    order."""
    _, params, tnet = nets[network, False]
    cfg = world["cfg"]
    fresh = build_net(cfg, cfg.task_obs_dim, world["amp_dim"], network,
                      device="cpu", **WIDTHS)
    sd, jsd = fresh.state_dict(), convert.agent_state_dict(np_tree(params))
    assert sd.keys() == jsd.keys()
    assert all(sd[k].shape == jsd[k].shape for k in sd)
    assert all(float(sd[k].abs().max()) == 0 for k in sd
               if k.endswith(".bias"))
    people = torch.randn(3, 165)
    perm = [2, 0, 4, 1, 3]
    shuffled = torch.cat([people[:, :150].reshape(3, 5, 30)[:, perm]
                          .reshape(3, 150),
                          people[:, 150:].reshape(3, 5, 3)[:, perm]
                          .reshape(3, 15)], -1)
    with torch.no_grad():
        torch.testing.assert_close(tnet._people_feat(shuffled),
                                   tnet._people_feat(people))


def _agents(world, **kw):
    jagent = JAgent(world["jenv"], JAMPConfig(**kw))
    jagent.net = jax_net(world["jcfg"], kw["network"], False)
    agent = AMPAgent(world["env"], AMPConfig(**kw))
    cfg = world["cfg"]
    agent.net = build_net(cfg, cfg.task_obs_dim, agent.amp_dim,
                          kw["network"], device="cpu", **WIDTHS)
    return jagent, agent


def test_query_value_gradient_matches_jax(world, nets):
    """The critic's value under hypothetical trajectories and its gradient
    with respect to them, through the normalized spliced observation."""
    jagent, agent = _agents(world, network="sept_cnn", amp_replay_size=16)
    env = world["env"]
    st = env.reset(torch.Generator().manual_seed(2))
    js = to_jax_state(st, jax.random.PRNGKey(0))
    o = env.observe(st)
    params = nets["sept_cnn", False][1]
    jnorm = JRunningNorm.create(o.shape[1]).update(jx(o))
    S = env.cfg.num_traj_samples
    traj = (np.random.default_rng(1).normal(0, 1.5, (N, S, 3))
            + st.physics.root_pos[:, None].numpy()).astype(np.float32)

    def jq(p, norm, state, tr):
        return jagent.query_value_gradient(
            types.SimpleNamespace(params=p, obs_norm=norm), state, tr)

    jv, jg = jax.jit(jq)(params, jnorm, js, jnp.asarray(traj))
    ts = types.SimpleNamespace(
        params=convert.agent_state_dict(np_tree(params)),
        obs_norm=convert.running_norm(np_tree(jnorm), "cpu"))
    v, g = agent.query_value_gradient(ts, st, torch.as_tensor(traj))
    assert v.shape == (N,) and g.shape == (N, S, 3)
    rel_close(v, jv, F32_REL)
    rel_close(g, jg, F32_REL)
    assert float(g.abs().max()) > 0


def test_network_choice_refusals(world):
    cfg = EnvConfig(num_envs=4, sensor_res=8, sensor_shape="fov")
    with pytest.raises(ValueError, match="sept_cnn needs the square"):
        build_net(cfg, cfg.task_obs_dim, 30, "sept_cnn", device="cpu",
                  **WIDTHS)
    env = PedestrianTerrainEnv(cfg, world["env"].terrain,
                               world["env"].motion_lib, device="cpu")
    with pytest.raises(ValueError, match="sept_cnn needs the square"):
        AMPAgent(env, AMPConfig(network="sept_cnn", amp_replay_size=8))


def test_unknown_network_raises():
    with pytest.raises(ValueError, match="unknown network"):
        AMPConfig(network="mlp")


def test_train_entry_point_crowd_on_cpu(capsys):
    """One crowd epoch through the entry point at full network width: the
    conv encoder over the velocity-map image, the pointnet, bfloat16 hidden
    layers and every perturbation; finite metrics."""
    args = ["--epochs", "1", "--num-envs", "2", "--device", "cpu",
            "amp.horizon=2", "amp.num_minibatches=2", "amp.mini_epochs=1",
            "amp.amp_batch_size=4", "amp.amp_replay_size=8",
            "env.sensor_res=8", "env.num_amp_obs_steps=3",
            "amp.network=sept_cnn", "amp.hidden_bf16=true",
            "env.group_obs=true", "env.group_size=2",
            "env.velocity_map=true", "env.hard_negative=true",
            "env.obs_noise_std=0.05", "env.action_noise_std=0.05",
            "env.push_interval=1", "env.projectile_interval=1"]
    ts = train.main(args)
    import json
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["epoch"] == 1 and line["nonfinite_grad"] == 0.0
    assert all(math.isfinite(v) for v in line.values()
               if isinstance(v, float))
    assert any(k.startswith("cnn.") for k in ts.params)
    assert ts.params["point_net.0.weight"].shape == (32, 33)
    assert math.isclose(float(ts.env_state.motion_weights.sum()), 1.0,
                        rel_tol=1e-6)
