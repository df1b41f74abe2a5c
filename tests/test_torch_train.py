"""The port's PPO + AMP update and training epoch against emloco_tpu: one
`_update_minibatch` from identical parameters, optimizer state, minibatch
and dropout masks, from a fresh optimizer state and again from the JAX
state after one step; the nonfinite guard; one port `train_epoch` on the
CPU; the `train` entry point. 4 envs,
sensor_res 8, 3 AMP steps, network widths of a few dozen (`agent.net`
replaced before `init` in both packages).

The JAX update returns no gradients; its first moments do: from a moment m
before the step and m' after it, the clipped gradient is (m' − b1·m)/(1 − b1)
with optax adam's default b1 = 0.9.
Tolerances: each loss term 1e-4 of its magnitude, each gradient leaf 1e-4
of its largest |g|, each parameter's update within 1e-3 × lr per entry:
the port's step against optax's step on the port's own gradients from the
same state, on every entry, and against JAX's whole update on every entry
whose gradient stands clear of the gradient tolerance. Below it Adam's
first step, lr·g/(|g| + 1e-8), follows the last bits of a gradient that is
a cancellation (an entry of 1.18e-7 against JAX's 1.16e-7, 1.3e-8 of the
leaf's largest |g|, moves that step by 1.5e-3 × lr).

`test_update_on_card_matches_cpu` (marked requires_cuda) holds one update
on the card against the same update on the CPU with those tolerances; it
needs neither jax nor the JAX package.
"""
import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax
    from emloco_tpu.envs import EnvConfig as JEnvConfig
    from emloco_tpu.envs import PedestrianTerrainEnv as JEnv
    from emloco_tpu.envs import observations as jobs
    from emloco_tpu.kinematics import motion_lib as jml
    from emloco_tpu.learning.amp_agent import AMPAgent as JAgent
    from emloco_tpu.learning.amp_agent import AMPConfig as JAMPConfig
    from emloco_tpu.learning.networks import AMPSeptValueNet as JNet
    from emloco_tpu.physics import generate_mixed_terrain as jgen
except ModuleNotFoundError:      # only the card test can run without jax
    jax = None
from emloco_tpu_torch import convert, train
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning import AMPSeptValueNet
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
from emloco_tpu_torch.physics import generate_mixed_terrain

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 4
SMALL = dict(num_envs=N, sensor_res=8, episode_length=48,
             num_amp_obs_steps=3)
WIDTHS = dict(mlp_units=(32, 16), task_units=(16, 8), value_units=(15, 6),
              disc_units=(24, 12))
MB, DEMO, HALF = 16, 8, 4          # minibatch, demo and replay rows
LOSS_REL, GRAD_REL, UPDATE_LR = 1e-4, 1e-4, 1e-3
OPTAX_B1 = 0.9                     # optax.adam's default, as the JAX agent's
TERMS = ("a_loss", "c_loss", "b_loss", "d_loss", "grad_pen", "tv_loss",
         "total")


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def small_net(cfg, amp_dim, device="cpu"):
    return AMPSeptValueNet(cfg.num_actions, cfg.self_obs_dim,
                           cfg.num_traj_samples * 2, cfg.task_obs_dim,
                           amp_dim, **WIDTHS, device=device)


def port_env(device="cpu"):
    return PedestrianTerrainEnv(
        EnvConfig(**SMALL),
        generate_mixed_terrain(map_length=4.0, num_tiles=2, difficulty=0.5,
                               device=device),
        tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                   device=device), device=device)


def minibatch(obs_dim, amp_dim, actor, seed):
    """A minibatch in the pools' layout, as numpy: normalized obs and
    flipped obs, actions drawn around the actor's μ, logp near theirs,
    advantages and returns; demo and replay blocks."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(f32)

    obs_n = np.clip(normal(MB, obs_dim), -5, 5)
    mu, sigma = actor(obs_n)
    eps = normal(*mu.shape)
    action = (mu + sigma * eps).astype(f32)
    logp = ((-0.5 * eps ** 2 - np.log(sigma)
             - 0.5 * np.log(2 * np.pi)).sum(-1) + normal(MB, scale=0.1))
    mb = dict(obs_n=obs_n, flip_obs_n=np.clip(normal(MB, obs_dim), -5, 5),
              action=action, logp=logp.astype(f32), adv=normal(MB),
              ret_n=normal(MB), ret_01=rng.random(MB).astype(f32),
              amp_n=normal(MB, amp_dim))
    return mb, normal(DEMO, amp_dim), normal(HALF, amp_dim)


def assert_update_close(port, ref, ref_step, lr):
    """`port` and `ref` are (params before, params after, clipped grads,
    loss terms) of the two updates; `ref_step` is the reference optimizer's
    params after a step on the port's own gradients from the same state.
    The port's step must be the reference optimizer's on every entry; the
    two updates must agree on every entry whose gradient stands clear of the
    gradient tolerance (below it the gradient's sign is rounding, and
    Adam's step, about lr·g/(|g| + 1e-8) on the first, follows it)."""
    (p0, p1, g, m), (rp0, rp1, rg, rm) = port, ref
    for k in TERMS:
        want = float(rm[k])
        assert abs(float(m[k]) - want) <= LOSS_REL * max(abs(want), 1e-6), (
            k, float(m[k]), want)
    for k in rp0:
        gk, rgk = np.asarray(g[k], np.float64), np.asarray(rg[k], np.float64)
        gtol = GRAD_REL * max(np.abs(rgk).max(), 1e-12)
        np.testing.assert_allclose(gk, rgk, rtol=0, atol=gtol,
                                   err_msg=f"gradient of {k}")
        new = np.asarray(p1[k], np.float64)
        np.testing.assert_allclose(new, np.asarray(ref_step[k], np.float64),
                                   rtol=0, atol=UPDATE_LR * lr,
                                   err_msg=f"optimizer step of {k}")
        du = new - np.asarray(p0[k], np.float64)
        rdu = (np.asarray(rp1[k], np.float64)
               - np.asarray(rp0[k], np.float64))
        clear = np.abs(rgk) >= gtol
        np.testing.assert_allclose(du[clear], rdu[clear], rtol=0,
                                   atol=UPDATE_LR * lr,
                                   err_msg=f"update of {k}")


def to_flax(sd, like):
    """A port state_dict in the layout of the flax params `like`."""
    out = {}
    for name, layer in like["params"].items():
        if name == "log_sigma":
            out[name] = jnp.asarray(sd[name].numpy())
            continue
        head, _, idx = name.rpartition("_")
        key = f"{head}.{idx}" if idx.isdigit() else name
        out[name] = {"kernel": jnp.asarray(sd[f"{key}.weight"].numpy().T),
                     "bias": jnp.asarray(sd[f"{key}.bias"].numpy())}
    return {"params": out}


@pytest.fixture(scope="module")
def jworld():
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    jlib = jml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0)
    jenv = JEnv(JEnvConfig(**SMALL), jterr, jlib)
    env = PedestrianTerrainEnv(
        EnvConfig(**SMALL), convert.heightfield(np_tree(jterr), "cpu"),
        convert.motion_lib(np_tree(jlib), "cpu"), device="cpu")
    return jenv, env


def _agents(jworld, **kw):
    jenv, env = jworld
    jagent = JAgent(jenv, JAMPConfig(**kw))
    cfg = jenv.cfg
    jagent.net = JNet(num_actions=cfg.num_actions,
                      self_obs_dim=cfg.self_obs_dim,
                      traj_obs_dim=cfg.num_traj_samples * 2,
                      task_obs_dim=cfg.task_obs_dim, **WIDTHS)
    agent = AMPAgent(env, AMPConfig(**kw))
    agent.net = small_net(env.cfg, agent.amp_dim)
    return jagent, agent


@pytest.mark.parametrize("amp_dropout", [False, True])
def test_update_minibatch_matches_jax(jworld, amp_dropout):
    """Two steps: from a fresh optimizer state, then from the JAX state
    after the first, converted. With dropout, JAX's own masks are fed to
    the port."""
    jagent, agent = _agents(jworld, amp_dropout=amp_dropout,
                            amp_replay_size=16)
    jcfg = jagent.env.cfg
    obs_dim, amp_dim = jagent.env.obs_dim, jagent.amp_dim
    p0 = jagent.net.init(jax.random.PRNGKey(1), jnp.zeros((1, obs_dim)),
                         jnp.zeros((1, amp_dim)))
    o0 = jagent.tx.init(p0)

    def actor(o):
        mu, sigma = jagent.net.apply(p0, jnp.asarray(o),
                                     method=jagent.net.actor)
        return np.asarray(mu), np.asarray(sigma)

    update = jax.jit(jagent._update_minibatch)
    optax_step = jax.jit(lambda g, o, p: optax.apply_updates(
        p, jagent.tx.update(g, o, p)[0]))
    lr = jagent.cfg.lr
    params, opt = p0, o0
    tparams = convert.agent_state_dict(np_tree(p0))
    topt = agent.tx.init(tparams)
    for step, key in enumerate(jax.random.split(jax.random.PRNGKey(2), 2)):
        mb, demo, replay = minibatch(obs_dim, amp_dim, actor, seed=step)
        jmb = {k: jnp.asarray(v) for k, v in mb.items()}
        p1, o1, jm = update(params, opt, jmb, jnp.asarray(demo),
                            jnp.asarray(replay), key)
        assert float(jm["nonfinite_grad"]) == 0.0
        masks = None
        if amp_dropout:
            ks = jax.random.split(key, 3)
            masks = tuple(
                t_(jobs.amp_dropout_mask(k, r, jcfg.num_amp_obs_steps,
                                         jcfg.amp_obs_per_step,
                                         jagent.cfg.amp_dropout_rate))
                for k, r in zip(ks, (HALF, HALF, DEMO)))
        tmb = {k: t_(v) for k, v in mb.items()}
        _, tm, tg = agent._loss_and_grads(tparams, tmb, t_(demo),
                                          t_(replay), masks)
        tp1, topt1, tm2 = agent._update_minibatch(tparams, topt, tmb,
                                                  t_(demo), t_(replay),
                                                  masks)
        assert float(tm2["nonfinite_grad"]) == 0.0
        # JAX's clipped gradient from its first moments
        m0 = convert.adam_state(np_tree(opt), "cpu").mu
        m1 = convert.adam_state(np_tree(o1), "cpu").mu
        b1 = OPTAX_B1
        jg = {k: (m1[k].double() - b1 * m0[k].double()) / (1 - b1)
              for k in m1}
        jm = dict(jm)
        jp0, jp1 = (convert.agent_state_dict(np_tree(p))
                    for p in (params, p1))
        step_ref = convert.agent_state_dict(np_tree(
            optax_step(to_flax(tg, params), opt, params)))
        assert_update_close((tparams, tp1, agent.tx.clip(tg), tm2),
                            (jp0, jp1, jg, jm), step_ref, lr)
        for k, v in tm.items():
            assert float(v) == float(tm2[k]), k
        # the next step starts from JAX's state, converted
        params, opt = p1, o1
        tparams = jp1
        topt = convert.adam_state(np_tree(o1), "cpu")
        assert int(topt.count) == step + 1
        torch.testing.assert_close(topt1.count, topt.count)


def test_nonfinite_update_guard():
    """A NaN advantage leaves parameters and optimizer state bit-equal and
    counts the minibatch, with finite metrics (the JAX package's
    tests/test_learning.py:348 on the port)."""
    env = port_env()
    agent = AMPAgent(env, AMPConfig(amp_replay_size=16))
    agent.net = small_net(env.cfg, agent.amp_dim)
    ts = agent.init(0)

    def actor(o):
        with torch.no_grad():
            mu, sigma = agent.net(t_(o), method="actor")
        return mu.numpy(), sigma.numpy()

    mb, demo, replay = minibatch(env.obs_dim, agent.amp_dim, actor, seed=3)
    tmb = {k: t_(v) for k, v in mb.items()}
    masks = (None if not agent.cfg.amp_dropout else tuple(
        torch.ones((r, agent.amp_dim)) for r in (HALF, HALF, DEMO)))
    p1, o1, m1 = agent._update_minibatch(ts.params, ts.opt_state, tmb,
                                         t_(demo), t_(replay), masks)
    assert float(m1["nonfinite_grad"]) == 0.0
    assert any(not torch.equal(p1[k], ts.params[k]) for k in p1)
    assert int(o1.count) == 1

    tmb["adv"] = tmb["adv"].clone()
    tmb["adv"][0] = float("nan")
    p2, o2, m2 = agent._update_minibatch(ts.params, ts.opt_state, tmb,
                                         t_(demo), t_(replay), masks)
    assert float(m2["nonfinite_grad"]) == 1.0
    assert all(math.isfinite(float(v)) for v in m2.values())
    for k in ts.params:
        assert torch.equal(p2[k], ts.params[k]), k
        assert torch.equal(o2.mu[k], ts.opt_state.mu[k]), k
        assert torch.equal(o2.nu[k], ts.opt_state.nu[k]), k
    assert torch.equal(o2.count, ts.opt_state.count)


def test_train_epoch_on_cpu():
    """Two port epochs at horizon 4, 2 minibatches, 2 mini-epochs: finite
    metrics, parameters moved, norms advanced by T·N rows, and the replay
    ring's pointer and fill as computed by hand (16 rows into a ring of 24:
    16 / 16, then 8 / 24)."""
    env = port_env()
    cfg = AMPConfig(horizon=4, num_minibatches=2, mini_epochs=2,
                    amp_batch_size=8, amp_replay_size=24)
    agent = AMPAgent(env, cfg)
    agent.net = small_net(env.cfg, agent.amp_dim)
    ts0 = agent.init(0)
    p0 = {k: v.clone() for k, v in ts0.params.items()}
    TN = cfg.horizon * N
    ts, m = agent.train_epoch(ts0)
    assert set(m) == {*TERMS, "nonfinite_grad", "task_reward",
                      "disc_reward", "combined_reward", "episode_done_frac",
                      "loc_reward", "power_reward"}
    assert all(math.isfinite(float(v)) for v in m.values()), m
    assert float(m["nonfinite_grad"]) == 0.0
    assert (ts.replay_ptr, ts.replay_filled, ts.epoch) == (16, 16, 1)
    for name in ("obs_norm", "amp_norm", "value_norm"):
        assert math.isclose(float(getattr(ts, name).count), 1e-4 + TN,
                            rel_tol=1e-6), name
    assert int(ts.opt_state.count) == cfg.mini_epochs * cfg.num_minibatches
    assert any(not torch.equal(ts.params[k], p0[k]) for k in p0)
    assert all(bool(torch.isfinite(v).all()) for v in ts.params.values())
    assert bool((ts.replay_amp[:16] != 0).any(-1).all())
    assert bool((ts.replay_amp[16:] == 0).all())
    ts, m = agent.train_epoch(ts)
    assert all(math.isfinite(float(v)) for v in m.values()), m
    assert (ts.replay_ptr, ts.replay_filled, ts.epoch) == (8, 24, 2)
    assert math.isclose(float(ts.obs_norm.count), 1e-4 + 2 * TN,
                        rel_tol=1e-6)


def test_replay_insert_takes_a_subset_when_the_ring_is_smaller():
    env = port_env()
    cfg = AMPConfig(horizon=4, num_minibatches=2, mini_epochs=1,
                    amp_batch_size=8, amp_replay_size=12)
    agent = AMPAgent(env, cfg)
    agent.net = small_net(env.cfg, agent.amp_dim)
    ts = agent.init(1)
    ts, batch, last = agent.rollout(ts)
    ts, pools = agent.prepare(ts, batch, last)
    assert (ts.replay_ptr, ts.replay_filled) == (0, 12)
    rows = batch["amp_obs"].reshape(16, -1)
    # every ring row is a distinct rollout row
    match = (ts.replay_amp[:, None] == rows[None]).all(-1)
    assert bool((match.sum(1) >= 1).all())
    assert len({int(i) for i in match.float().argmax(1)}) == 12
    assert pools["demo"].shape == (2, 8, agent.amp_dim)
    assert pools["replay"].shape == (2, 4, agent.amp_dim)


def test_train_entry_point_on_cpu(capsys, monkeypatch):
    """One tiny epoch at full network width through the entry point; and
    no card taken without one unless the CPU is asked for."""
    args = ["--epochs", "1", "--num-envs", "2", "amp.horizon=2",
            "amp.num_minibatches=2", "amp.mini_epochs=1",
            "amp.amp_batch_size=4", "amp.amp_replay_size=8",
            "env.sensor_res=8", "env.num_amp_obs_steps=3"]
    ts = train.main(args + ["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"epoch": 1' in line and '"d_loss"' in line
    assert (ts.epoch, ts.replay_filled) == (1, 4)
    with pytest.raises(SystemExit):
        train.main(["amp.nonsense=1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args)


@pytest.mark.requires_cuda
def test_update_on_card_matches_cpu():
    """One update (loss terms, gradients, parameters) on the card against
    the CPU from the same state, minibatch and masks, with dropout on and
    from a nonzero optimizer state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    env = port_env()
    agent = AMPAgent(env, AMPConfig(amp_replay_size=16))
    agent.net = small_net(env.cfg, agent.amp_dim)
    ts = agent.init(0)

    def actor(o):
        with torch.no_grad():
            mu, sigma = agent.net(t_(o), method="actor")
        return mu.numpy(), sigma.numpy()

    gen = torch.Generator().manual_seed(4)
    mb, demo, replay = minibatch(env.obs_dim, agent.amp_dim, actor, seed=5)
    masks = tuple((torch.rand((r, agent.amp_dim), generator=gen) > 0.3)
                  .float() for r in (HALF, HALF, DEMO))
    args = ({k: t_(v) for k, v in mb.items()}, t_(demo), t_(replay), masks)
    # a nonzero optimizer state: one step first
    params, opt, _ = agent._update_minibatch(ts.params, ts.opt_state, *args)
    results = []
    for dev in ("cpu", "cuda"):
        def to(x):
            return x.to(dev)
        p = {k: to(v) for k, v in params.items()}
        o = opt.to(dev)
        a = ({k: to(v) for k, v in args[0].items()}, to(args[1]),
             to(args[2]), tuple(to(m) for m in masks))
        total, terms, grads = agent._loss_and_grads(p, *a)
        p1, _, _ = agent._apply_grads(p, o, grads)
        terms["total"] = total
        results.append(tuple({k: v.cpu() for k, v in d.items()}
                             for d in (p, p1, agent.tx.clip(grads), terms,
                                       grads)))
    # the CPU optimizer's step on the card's gradients
    step_ref, _, _ = agent._apply_grads(params, opt, results[1][4])
    assert_update_close(results[1][:4], results[0][:4], step_ref,
                        agent.cfg.lr)

