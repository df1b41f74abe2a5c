"""The training path's pieces of emloco_tpu_torch against emloco_tpu: the
mirror (actions, body state, self obs, task obs), the AMP dropout mask, the
demo AMP windows, the critic / disc / task-value heads, `denormalize` and
GAE, at 4 envs, sensor_res 8, 3 AMP steps and network widths of a few
dozen.

jax.random cannot be reproduced in torch, so every comparison feeds both
packages the same inputs and the same draws: the dropout mask is built from
JAX's own uniform draw, the demo windows from JAX's motion ids and times.
The mirrors are signed permutations, bit-equal; float32 work in the same
order (heads, demo windows, GAE) is held to 1e-5 of the largest magnitude.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import EnvConfig as JEnvConfig
from emloco_tpu.envs import PedestrianTerrainEnv as JEnv
from emloco_tpu.envs import observations as jobs
from emloco_tpu.kinematics import motion_lib as jml
from emloco_tpu.learning.amp_agent import AMPAgent as JAgent
from emloco_tpu.learning.amp_agent import AMPConfig as JAMPConfig
from emloco_tpu.learning.networks import AMPSeptValueNet as JNet
from emloco_tpu.learning.running_norm import RunningNorm as JRunningNorm
from emloco_tpu.physics import generate_mixed_terrain as jgen
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.envs import observations as tobs
from emloco_tpu_torch.learning import AMPSeptValueNet
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 4
SMALL = dict(num_envs=N, sensor_res=8, episode_length=48,
             num_amp_obs_steps=3)
WIDTHS = dict(mlp_units=(32, 16), task_units=(16, 8), value_units=(15, 6),
              disc_units=(24, 12))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def rel_close(actual, desired, rel):
    desired = np.asarray(desired, np.float64)
    actual = np.asarray(actual, np.float64)
    np.testing.assert_allclose(actual, desired, rtol=0,
                               atol=rel * max(np.abs(desired).max(), 1e-6))


def bit_equal(actual, desired):
    np.testing.assert_array_equal(np.asarray(actual), np.asarray(desired))


def jax_net(cfg):
    return JNet(num_actions=cfg.num_actions, self_obs_dim=cfg.self_obs_dim,
                traj_obs_dim=cfg.num_traj_samples * 2,
                task_obs_dim=cfg.task_obs_dim, **WIDTHS)


def port_net(cfg, amp_dim):
    return AMPSeptValueNet(cfg.num_actions, cfg.self_obs_dim,
                           cfg.num_traj_samples * 2, cfg.task_obs_dim,
                           amp_dim, **WIDTHS, device="cpu")


@pytest.fixture(scope="module")
def world():
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    jlib = jml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0)
    jcfg = JEnvConfig(**SMALL)
    jenv = JEnv(jcfg, jterr, jlib)
    cfg = EnvConfig(**SMALL)
    env = PedestrianTerrainEnv(
        cfg, convert.heightfield(np_tree(jterr), "cpu"),
        convert.motion_lib(np_tree(jlib), "cpu"), device="cpu")
    amp_dim = cfg.num_amp_obs_steps * cfg.amp_obs_per_step
    # the mirrors are signed permutations: any float32 obs exercises them
    jo = jnp.asarray(np.random.default_rng(9).standard_normal(
        (N, jcfg.obs_dim)).astype(np.float32))
    return dict(jenv=jenv, jo=jo, env=env, jcfg=jcfg, cfg=cfg,
                amp_dim=amp_dim)


@pytest.fixture(scope="module")
def heads(world):
    jcfg, amp_dim = world["jcfg"], world["amp_dim"]
    net = jax_net(jcfg)
    params = net.init(jax.random.PRNGKey(1), world["jo"],
                      jnp.zeros((N, amp_dim)))
    tnet = port_net(world["cfg"], amp_dim)
    tnet.load_state_dict(convert.agent_state_dict(np_tree(params)))
    return net, params, tnet


def test_mirror_tables_match_jax():
    bit_equal(tobs.MIRROR_BODY, jobs.MIRROR_BODY)
    bit_equal(tobs.MIRROR_ACTION, jobs.MIRROR_ACTION)
    for dim in (tobs.SELF_OBS_DIM, tobs.SELF_OBS_DIM + 11,
                tobs.SELF_OBS_DIM + 21):
        idx, sign = tobs.build_self_obs_flip(dim)
        jidx, jsign = jobs.build_self_obs_flip(dim)
        bit_equal(idx, jidx)
        bit_equal(sign, jsign)
    with pytest.raises(ValueError):
        tobs.build_self_obs_flip(tobs.SELF_OBS_DIM + 5)


def test_flip_actions_and_body_state_bit_equal():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 69)).astype(np.float32)
    bit_equal(tobs.flip_actions(t_(a)), jobs.flip_actions(jnp.asarray(a)))
    state = [rng.standard_normal((5, 24, k)).astype(np.float32)
             for k in (3, 4, 3, 3)]
    ours = tobs.flip_body_state(*(t_(x) for x in state))
    theirs = jobs.flip_body_state(*(jnp.asarray(x) for x in state))
    for o, t in zip(ours, theirs):
        bit_equal(o, t)


def test_observe_flipped_from_bit_equal(world):
    jo = world["jo"]
    bit_equal(world["env"].observe_flipped_from(t_(jo)),
              world["jenv"].observe_flipped_from(jo))


def test_feature_space_flip_matches_state_flip_in_port(world):
    """The port's feature-space mirror equals its state-based oracle on
    states with real motion, as tests/test_sensor_variants.py:185 pins it
    in JAX (atol 2e-4)."""
    env = world["env"]
    st = env.reset(torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    for _ in range(3):
        a = (torch.rand((N, env.cfg.num_actions), generator=gen) - 0.5) * 0.8
        st, _ = env.step(st, a)
    torch.testing.assert_close(env.observe_flipped_from(env.observe(st)),
                               env.observe_flipped(st), rtol=0, atol=2e-4)


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.9])
def test_amp_dropout_mask_from_jax_draw_bit_equal(rate):
    key = jax.random.PRNGKey(3)
    B, steps, per = 7, 3, 206
    u = jax.random.uniform(key, (B, len(jobs.DOF_SUBSET_JOINTS)))
    m = tobs.amp_dropout_mask(t_(u), steps, per, rate)
    bit_equal(m, jobs.amp_dropout_mask(key, B, steps, per, rate))
    assert tobs.amp_dropout_draw(torch.Generator(), B).shape == u.shape


def test_demo_amp_obs_from_jax_draws(world):
    jenv, env = world["jenv"], world["env"]
    key, n = jax.random.PRNGKey(5), 6
    k1, k2 = jax.random.split(key)
    lib = jenv.motion_lib
    mids = jml.sample_motions(lib, k1, n)
    trunc = jenv.cfg.dt * (jenv.cfg.num_amp_obs_steps - 1)
    t0 = jml.sample_time(lib, k2, mids, truncate_time=trunc) + trunc
    ours = env.amp_obs_demo(t_(mids).long(), t_(t0))
    rel_close(ours, jenv.fetch_amp_obs_demo(key, n), 1e-5)
    mids2, t02 = env.sample_amp_demo(torch.Generator().manual_seed(0), 50)
    assert bool((t02 >= trunc).all())
    assert bool((t02 <= env.motion_lib.durations[mids2] + 1e-6).all())
    assert env.fetch_amp_obs_demo(torch.Generator(), n).shape == (
        n, world["amp_dim"])


def test_hard_negative_update_is_identity(world):
    st = world["env"].reset(torch.Generator().manual_seed(0))
    assert world["env"].apply_hard_negative_update(st) is st


@pytest.mark.parametrize("head", ["actor", "critic", "disc", "task_value"])
def test_heads_match_jax(heads, world, head):
    net, params, tnet = heads
    rng = np.random.default_rng(1)
    x = rng.standard_normal(
        (9, world["amp_dim"] if head == "disc"
         else world["jcfg"].obs_dim)).astype(np.float32)
    want = net.apply(params, jnp.asarray(x), method=getattr(net, head))
    with torch.no_grad():
        got = tnet(t_(x), method=head)
    for g, w in zip(*((got, want) if head == "actor" else ((got,),
                                                            (want,)))):
        rel_close(g, w, 1e-5)


def test_all_heads_call_and_init(heads, world):
    net, params, tnet = heads
    rng = np.random.default_rng(2)
    o = rng.standard_normal((3, world["jcfg"].obs_dim)).astype(np.float32)
    a = rng.standard_normal((3, world["amp_dim"])).astype(np.float32)
    want = net.apply(params, jnp.asarray(o), jnp.asarray(a))
    with torch.no_grad():
        got = tnet(t_(o), t_(a))
    for g, w in zip(got, want):
        rel_close(g, w, 1e-5)
    # the port's own initialization: flax's shapes and scales
    fresh = port_net(world["cfg"], world["amp_dim"])
    sd = fresh.state_dict()
    jsd = convert.agent_state_dict(np_tree(params))
    assert sd.keys() == jsd.keys()
    for k in sd:
        assert sd[k].shape == jsd[k].shape, k
    bound = 1 / np.sqrt(WIDTHS["disc_units"][-1])
    assert float(sd["disc_logits.weight"].abs().max()) <= bound
    assert float(sd["value_logits.weight"].abs().max()) <= 1 / np.sqrt(6)
    assert all(float(sd[k].abs().max()) == 0 for k in sd
               if k.endswith(".bias"))


def test_denormalize_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, 5)).astype(np.float32) * 3 + 1
    jn = JRunningNorm.create(5).update(jnp.asarray(x))
    tn = convert.running_norm(np_tree(jn), "cpu")
    y = rng.standard_normal((7, 5)).astype(np.float32)
    rel_close(tn.denormalize(t_(y)), jn.denormalize(jnp.asarray(y)), 1e-6)


def _epoch_inputs(world, T, seed, **kw):
    """A JAX and a port agent with identical small nets, params, norms and
    reward weights, and a (T, N) rollout batch with done steps, as numpy.
    The JAX TrainState is a namespace of the fields compute_gae and the
    epoch's pool assembly read (the JAX init would reset the env, a quarter
    minute of compiling)."""
    jcfg, cfg, amp_dim = world["jcfg"], world["cfg"], world["amp_dim"]
    kw = dict(dict(horizon=T, amp_replay_size=16), **kw)
    jagent = JAgent(world["jenv"], JAMPConfig(**kw))
    jagent.net = jax_net(jcfg)
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(f32)

    batch = dict(
        obs=normal(T, N, jcfg.obs_dim, scale=2.0, shift=1.0),
        flip_obs=normal(T, N, jcfg.obs_dim, scale=2.0, shift=1.0),
        action=normal(T, N, jcfg.num_actions), logp=normal(T, N),
        amp_obs=normal(T, N, amp_dim, scale=3.0, shift=-1.0),
        reward=normal(T, N), value=normal(T, N),
        reward_raw=rng.random((T, N, 2)).astype(f32),
        done=rng.random((T, N)) < 0.3)
    last_obs = normal(N, jcfg.obs_dim)
    jts = types.SimpleNamespace(
        params=jagent.net.init(jax.random.PRNGKey(2), jnp.asarray(last_obs),
                               jnp.asarray(batch["amp_obs"][0])),
        amp_norm=JRunningNorm.create(amp_dim).update(
            jnp.asarray(batch["amp_obs"][0])),
        obs_norm=JRunningNorm.create(jcfg.obs_dim).update(
            jnp.asarray(last_obs) * 2 + 1),
        value_norm=JRunningNorm.create(1).update(
            jnp.asarray(normal(9, 1, scale=4.0, shift=2.0))),
        task_reward_w=jnp.float32(0.5), disc_reward_w=jnp.float32(0.5))

    agent = AMPAgent(world["env"], AMPConfig(**kw))
    agent.net = port_net(cfg, amp_dim)
    ts = agent.init(0)
    ts = ts.replace(params=convert.agent_state_dict(np_tree(jts.params)),
                    **{k: convert.running_norm(np_tree(getattr(jts, k)),
                                               "cpu")
                       for k in ("obs_norm", "amp_norm", "value_norm")})
    return jagent, jts, agent, ts, batch, last_obs


@pytest.mark.parametrize("normalize_value", [True, False])
def test_compute_gae_matches_jax(world, normalize_value):
    """GAE over a (T, N) batch with done steps, from identical params,
    norms and inputs."""
    jagent, jts, agent, ts, batch, last_obs = _epoch_inputs(
        world, 5, 6, normalize_value=normalize_value)
    keys = ("amp_obs", "reward", "value", "done")
    want = jagent.compute_gae(jts, {k: jnp.asarray(batch[k]) for k in keys},
                              jnp.asarray(last_obs))
    with torch.no_grad():
        got = agent.compute_gae(ts, {k: t_(batch[k]) for k in keys},
                                t_(last_obs))
    assert batch["done"].any()
    for g, w in zip(got, want):
        rel_close(g, w, 1e-5)


@pytest.mark.parametrize("ring, ptr", [(24, 20), (12, 5)])
def test_prepare_matches_jax(world, monkeypatch, ring, ptr):
    """The epoch's pools (`prepare`) against train_epoch's own ops in JAX,
    run one by one (amp_agent.py:421-496): GAE, the norms updated after the
    rollout and the pools normalized with them, ret_n clipped at 1e6,
    ret_01, the advantages over the population std, the replay ring's
    insert (a wrap at ring 24; a subset at ring 12, below T·N = 20) and
    its draw below the fill, and the demo windows. The port's own replay
    draws are fed to JAX; JAX's demo draws are fed to the port."""
    T, nmb, B = 5, 2, 6
    jagent, jts, agent, ts, batch, last_obs = _epoch_inputs(
        world, T, 7, amp_replay_size=ring, num_minibatches=nmb,
        amp_batch_size=B)
    amp_dim, TN, half = world["amp_dim"], T * N, B // 2
    ring0 = np.random.default_rng(8).standard_normal(
        (ring, amp_dim)).astype(np.float32)
    ts = ts.replace(replay_amp=t_(ring0), replay_ptr=ptr, replay_filled=ptr,
                    rng=torch.Generator().manual_seed(3))
    # JAX's demo draws, fed to the port
    jenv, env = world["jenv"], world["env"]
    key, n_demo = jax.random.PRNGKey(11), nmb * B
    k1, k2 = jax.random.split(key)
    mids = jml.sample_motions(jenv.motion_lib, k1, n_demo)
    trunc = jenv.cfg.dt * (jenv.cfg.num_amp_obs_steps - 1)
    t0 = jml.sample_time(jenv.motion_lib, k2, mids, truncate_time=trunc)
    monkeypatch.setattr(env, "sample_amp_demo",
                        lambda gen, n, motion_weights=None: (
                            t_(mids).long(), t_(t0 + trunc)))

    got_ts, pools = agent.prepare(ts, {k: t_(v) for k, v in batch.items()},
                                  t_(last_obs))

    # the port's replay draws, in its documented order
    gen = torch.Generator().manual_seed(3)
    n_new = min(TN, ring)
    src = (torch.randperm(TN, generator=gen)[:n_new].numpy() if TN > ring
           else np.arange(n_new))
    filled = min(ptr + n_new, ring)
    ridx = torch.randint(0, filled, (nmb * half,), generator=gen).numpy()

    # train_epoch's ops in JAX, one by one
    cfg = jagent.cfg
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    advs, returns, comb, disc_r = jagent.compute_gae(jts, jb,
                                                     jnp.asarray(last_obs))

    def flat(x):
        return x.reshape((TN,) + x.shape[2:])

    obs_f, amp_f, ret_f = flat(jb["obs"]), flat(jb["amp_obs"]), flat(returns)
    obs_norm = jts.obs_norm.update(obs_f)
    amp_norm = jts.amp_norm.update(amp_f)
    value_norm = jts.value_norm.update(ret_f[:, None])
    adv_f = flat(advs)
    ring1 = jnp.asarray(ring0).at[(ptr + jnp.arange(n_new)) % ring].set(
        amp_f[src])
    want = dict(
        obs_n=obs_norm.normalize(obs_f),
        flip_obs_n=obs_norm.normalize(flat(jb["flip_obs"])),
        action=flat(jb["action"]), logp=flat(jb["logp"]),
        adv=(adv_f - adv_f.mean()) / (jnp.std(adv_f) + 1e-8),
        ret_n=value_norm.normalize(ret_f[:, None], clip=1e6)[:, 0],
        ret_01=jnp.clip((ret_f - cfg.min_cum_reward)
                        / (cfg.max_cum_reward - cfg.min_cum_reward), 0, 1),
        amp_n=amp_norm.normalize(amp_f))
    assert pools["data"].keys() == want.keys()
    for k, w in want.items():
        rel_close(pools["data"][k], w, 1e-5)
    rel_close(pools["demo"], amp_norm.normalize(
        jenv.fetch_amp_obs_demo(key, n_demo)).reshape(nmb, B, -1), 1e-5)
    rel_close(pools["replay"], amp_norm.normalize(ring1[ridx]).reshape(
        nmb, half, -1), 1e-5)
    stats = dict(task_reward=jb["reward"].mean(), disc_reward=disc_r.mean(),
                 combined_reward=comb.mean(),
                 episode_done_frac=jb["done"].mean(),
                 loc_reward=jb["reward_raw"][..., 0].mean(),
                 power_reward=jb["reward_raw"][..., 1].mean())
    assert pools["stats"].keys() == stats.keys()
    for k, w in stats.items():
        rel_close(pools["stats"][k], w, 1e-5)
    for name, w in (("obs_norm", obs_norm), ("amp_norm", amp_norm),
                    ("value_norm", value_norm)):
        for f in ("mean", "var", "count"):
            rel_close(getattr(getattr(got_ts, name), f), getattr(w, f), 1e-5)
    bit_equal(got_ts.replay_amp, ring1)
    assert (got_ts.replay_ptr, got_ts.replay_filled) == (
        (ptr + n_new) % ring, filled)
