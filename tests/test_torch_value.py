"""The port's LocoVal function and its trainer against emloco_tpu:
ValuePoseNet, rotate_normalization and embodied_motion_loss from converted
parameters; the port's init against flax's tree; the warm-up cosine
schedule and one AdamW update against optax (from a fresh state and from
JAX's state after 3 steps, carried across through convert); the return
latching with both packages' env and policy replaced by one scripted fake;
one real `_collect` on a small world (4 envs, sensor_res 8, episode 48, 3
AMP steps, network widths of a few dozen).

Tolerances, set from float32 arithmetic before any run: the net and the
rotation 1e-6 absolute (values and coordinates of order 1); the loss and
its gradient 1e-5 of their magnitude; the schedule 1e-6 relative (optax
evaluates its cosine in float32 as the port does); one update: the loss
1e-6 of its magnitude, each gradient leaf 1e-5 of its largest |g|, the
optimizer's step from the same gradients and state 1e-5 × lr_t per entry,
and the whole update 1e-3 × lr_t per entry where the gradient stands clear
of its tolerance (Adam's first step, lr·g/(|g| + 1e-8), follows the sign
of a gradient that is a cancellation); the latching equal, float32 to
1e-6; the real rollout's targets one bf16 ulp (2⁻⁸) of their largest
magnitude, the step's tolerance in tests/test_torch_env.py.

`test_update_on_card_matches_cpu` (marked requires_cuda) holds one update
on the card against the CPU; it needs neither jax nor the JAX package.
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax
    from flax import struct as jstruct
    from emloco_tpu.envs import EnvConfig as JEnvConfig
    from emloco_tpu.envs import PedestrianTerrainEnv as JEnv
    from emloco_tpu.envs import traj_gen as jtg
    from emloco_tpu.kinematics import motion_lib as jml
    from emloco_tpu.learning.amp_agent import AMPAgent as JAgent
    from emloco_tpu.learning.amp_agent import AMPConfig as JAMPConfig
    from emloco_tpu.learning.amp_agent import TrainState as JTrainState
    from emloco_tpu.learning.networks import AMPSeptValueNet as JNet
    from emloco_tpu.learning.networks import ValuePoseNet as JValuePoseNet
    from emloco_tpu.learning.networks import \
        embodied_motion_loss as j_embodied_motion_loss
    from emloco_tpu.learning.networks import \
        rotate_normalization as j_rotate_normalization
    from emloco_tpu.learning.running_norm import RunningNorm as JRunningNorm
    from emloco_tpu.learning.value_train import LocoValTrainer as JTrainer
    from emloco_tpu.learning.value_train import \
        ValueTrainConfig as JValueTrainConfig
    from emloco_tpu.learning.value_train import \
        ValueTrainState as JValueTrainState
    from emloco_tpu.physics import generate_mixed_terrain as jgen
except ModuleNotFoundError:      # only the card test can run without jax
    jax = None
from emloco_tpu_torch import convert
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.learning import AMPSeptValueNet, ValuePoseNet
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
from emloco_tpu_torch.learning.networks import (embodied_motion_loss,
                                                rotate_normalization)
from emloco_tpu_torch.learning.value_train import (AdamW, LocoValTrainer,
                                                   ValueTrainConfig,
                                                   ValueTrainState)
from emloco_tpu_torch.struct import TensorStruct

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

N = 4
SMALL = dict(num_envs=N, sensor_res=8, episode_length=48,
             num_amp_obs_steps=3)
WIDTHS = dict(mlp_units=(32, 16), task_units=(16, 8), value_units=(15, 6),
              disc_units=(24, 12))
NET_ABS, LOSS_REL, SCHED_REL = 1e-6, 1e-5, 1e-6
UPD_LOSS_REL, UPD_GRAD_REL, STEP_LR, UPDATE_LR = 1e-6, 1e-5, 1e-5, 1e-3
BF16 = 2.0 ** -8
HORIZON, STEP_TO_PRED = 8, 5
COUNTS = (0, 1, 50, 99, 100, 101, 12_000, 24_999, 25_000, 30_000)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def vnet_inputs(B, W, seed):
    """(wp, pose, vel) as float32 numpy: walks from the origin, poses of a
    body's size; trajectory 0's first segment has x1 = 0 and trajectory
    1's x1 = 5e-11, both under rotate_normalization's 1e-10."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0.4, 0.3, (B, W, 2))
    steps[:, 0] = 0.0
    wp = np.cumsum(steps, 1)
    wp[0, 1, 0] = 0.0
    wp[1:2, 1, 0] = 5e-11
    pose = rng.normal(0.0, 0.4, (B, 24, 3))
    vel = rng.normal(0.0, 1.0, (B, 2))
    return tuple(x.astype(np.float32) for x in (wp, pose, vel))


def port_vnet(jparams, **kw):
    vnet = ValuePoseNet(**kw, device="cpu")
    vnet.load_state_dict(convert.valuenet_state_dict(np_tree(jparams)))
    return vnet


@pytest.mark.parametrize("num_waypoints", [13, 5])
@pytest.mark.parametrize("use_pose,use_vel", [(True, True), (True, False),
                                              (False, True), (False, False)])
def test_value_pose_net_matches_jax(use_pose, use_vel, num_waypoints):
    kw = dict(use_pose=use_pose, use_vel=use_vel,
              num_waypoints=num_waypoints)
    wp, pose, vel = vnet_inputs(16, num_waypoints, seed=1)
    jnet = JValuePoseNet(**kw)
    jp = jnet.init(jax.random.PRNGKey(2), wp, pose, vel)
    want = np.asarray(jnet.apply(jp, wp, pose, vel))
    with torch.no_grad():
        got = port_vnet(jp, **kw)(t_(wp), t_(pose), t_(vel)).numpy()
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=0, atol=NET_ABS)


@pytest.mark.parametrize("with_pose_vel", [True, False])
def test_rotate_normalization_matches_jax(with_pose_vel):
    wp, pose, vel = vnet_inputs(16, 13, seed=3)
    if not with_pose_vel:
        pose = vel = None
    want = j_rotate_normalization(wp, pose, vel)
    got = rotate_normalization(t_(wp), None if pose is None else t_(pose),
                               None if vel is None else t_(vel))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=NET_ABS)


def test_embodied_motion_loss_and_grad_match_jax():
    """The loss and its gradient with respect to the trajectories and to
    every parameter, against jax.grad."""
    wp, pose, vel = vnet_inputs(32, 13, seed=4)
    jnet = JValuePoseNet()
    jp = jnet.init(jax.random.PRNGKey(5), wp, pose, vel)
    jloss, (jg_traj, jg_p) = jax.value_and_grad(
        lambda traj, p: j_embodied_motion_loss(jnet.apply, p, traj, pose,
                                               vel),
        argnums=(0, 1))(jnp.asarray(wp), jp)
    vnet = port_vnet(jp)
    traj = t_(wp).requires_grad_()
    loss = embodied_motion_loss(vnet, traj, t_(pose), t_(vel))
    names = [k for k, _ in vnet.named_parameters()]
    grads = torch.autograd.grad(loss, [traj, *vnet.parameters()])
    assert abs(loss.item() - float(jloss)) <= LOSS_REL * abs(float(jloss))
    jg = convert.valuenet_state_dict(np_tree(jg_p))
    for name, g, want in [("traj", grads[0], np.asarray(jg_traj))] + [
            (k, g, jg[k].numpy()) for k, g in zip(names, grads[1:])]:
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=LOSS_REL * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(use_pose=False, use_vel=False,
                                             num_waypoints=5)])
def test_init_matches_flax_tree(kw):
    """Shapes (transposed), zero biases, kernels inside the xavier bound
    and spread across it, drawn from the generator passed."""
    jnet = JValuePoseNet(**kw)
    W = jnet.num_waypoints
    jp = np_tree(jnet.init(jax.random.PRNGKey(0), *vnet_inputs(1, W, 0)))
    want = convert.valuenet_state_dict(jp)
    gen = torch.Generator().manual_seed(7)
    vnet = ValuePoseNet(**kw, generator=gen, device="cpu")
    sd = vnet.state_dict()
    assert set(sd) == set(want)
    again = ValuePoseNet(**kw, generator=torch.Generator().manual_seed(7),
                         device="cpu").state_dict()
    for k, v in sd.items():
        assert v.shape == want[k].shape, k
        assert torch.equal(v, again[k]), k
        if k.endswith(".bias"):
            assert not v.any(), k
            assert not want[k].any(), k
            continue
        bound = math.sqrt(6.0 / sum(v.shape))
        assert float(v.abs().max()) <= bound, k
        assert float(v.abs().max()) > 0.5 * bound, k
        assert float(want[k].abs().max()) <= bound * (1 + 1e-6), k


@pytest.mark.parametrize("count", COUNTS)
def test_schedule_matches_optax(count):
    cfg = ValueTrainConfig()
    sched = optax.warmup_cosine_decay_schedule(
        cfg.lr * 0.1, cfg.lr, cfg.warmup_steps, cfg.total_steps,
        cfg.lr * 0.01)
    tx = AdamW(cfg.lr, cfg.warmup_steps, cfg.total_steps, cfg.weight_decay)
    want = float(sched(jnp.asarray(count, jnp.int32)))
    got = tx.learning_rate(torch.tensor(count, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= SCHED_REL * want, (float(got), want)
    if count == 0:
        assert math.isclose(want, 0.1 * cfg.lr, rel_tol=1e-6)


def samples(M, seed, W=13):
    """One epoch's samples as numpy, with about half of `valid` zero."""
    rng = np.random.default_rng(seed)
    wp, pose, vel = vnet_inputs(M, W, seed)
    f32 = np.float32
    return dict(wp=wp, pose=pose, vel=vel,
                target=rng.random(M).astype(f32),
                valid=(rng.random(M) < 0.5).astype(f32),
                inv=(rng.random(M) < 0.3).astype(f32))


def jax_update(jtr):
    """JAX train_epoch's update lines (value_train.py:135-145)."""
    def update(params, opt, s):
        def loss_fn(p):
            pred = jtr.vnet.apply(p, s["wp"], s["pose"], s["vel"])
            se = (pred - s["target"]) ** 2 * s["valid"]
            return se.sum() / jnp.maximum(s["valid"].sum(), 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt1 = jtr.tx.update(grads, opt, params)
        return loss, grads, optax.apply_updates(params, updates), opt1
    return jax.jit(update)


def assert_update_close(port, ref, step_ref, lr_t):
    """`port` and `ref`: (params before, params after, gradients, loss) of
    the two updates; `step_ref`: the reference optimizer's params after a
    step on the port's own gradients from the same state."""
    (p0, p1, g, loss), (rp0, rp1, rg, rloss) = port, ref
    assert abs(float(loss) - float(rloss)) <= UPD_LOSS_REL * abs(
        float(rloss)), (float(loss), float(rloss))
    for k in rp0:
        gk, rgk = (np.asarray(x, np.float64) for x in (g[k], rg[k]))
        gtol = UPD_GRAD_REL * max(np.abs(rgk).max(), 1e-12)
        np.testing.assert_allclose(gk, rgk, rtol=0, atol=gtol,
                                   err_msg=f"gradient of {k}")
        new = np.asarray(p1[k], np.float64)
        np.testing.assert_allclose(new, np.asarray(step_ref[k], np.float64),
                                   rtol=0, atol=STEP_LR * lr_t,
                                   err_msg=f"optimizer step of {k}")
        du = new - np.asarray(p0[k], np.float64)
        rdu = (np.asarray(rp1[k], np.float64)
               - np.asarray(rp0[k], np.float64))
        clear = np.abs(rgk) >= gtol
        np.testing.assert_allclose(du[clear], rdu[clear], rtol=0,
                                   atol=UPDATE_LR * lr_t,
                                   err_msg=f"update of {k}")


@pytest.mark.parametrize("warm_steps", [0, 3])
def test_vnet_update_matches_jax(warm_steps):
    """One AdamW step of the port's trainer against JAX's tx.update on the
    same samples, from a fresh state or from JAX's state after
    `warm_steps` steps (moments and count carried across through
    convert)."""
    jtr = JTrainer(SimpleNamespace(env=None), JValuePoseNet())
    update = jax_update(jtr)
    s0 = samples(1, 0)
    params = jtr.vnet.init(jax.random.PRNGKey(3), s0["wp"], s0["pose"],
                           s0["vel"])
    opt = jtr.tx.init(params)
    for i in range(warm_steps):
        _, _, params, opt = update(params, opt, samples(64, 10 + i))
    s = samples(64, 20)
    jloss, jg, jp1, jopt1 = update(params, opt, s)

    tr = LocoValTrainer(SimpleNamespace(env=None), ValuePoseNet(device="cpu"))
    tp0 = convert.valuenet_state_dict(np_tree(params))
    topt = convert.adam_state(np_tree(opt), "cpu",
                              convert.valuenet_state_dict)
    assert int(topt.count) == warm_steps
    loss, grads = tr._loss_and_grads(tp0, {k: t_(v) for k, v in s.items()})
    tp1, topt1 = tr.tx.update(grads, topt, tp0)
    lr_t = float(tr.tx.learning_rate(topt.count))
    # optax's step on the port's gradients from the same state
    flax_g = convert.valuenet_params(grads)
    upd, _ = jtr.tx.update(flax_g, opt, params)
    step_ref = convert.valuenet_state_dict(np_tree(
        optax.apply_updates(params, upd)))
    assert_update_close(
        (tp0, tp1, grads, loss),
        (tp0, convert.valuenet_state_dict(np_tree(jp1)),
         convert.valuenet_state_dict(np_tree(jg)), jloss),
        step_ref, lr_t)
    jst = convert.adam_state(np_tree(jopt1), "cpu",
                             convert.valuenet_state_dict)
    assert int(topt1.count) == int(jst.count) == warm_steps + 1
    for k in jst.mu:
        for a, b in ((topt1.mu[k], jst.mu[k]), (topt1.nu[k], jst.nu[k])):
            np.testing.assert_allclose(
                a.numpy(), b.numpy(), rtol=0,
                atol=UPD_GRAD_REL * max(float(b.abs().max()), 1e-20))


# ---------------------------------------------------------------------------
# the latching, with the env and the policy scripted
# ---------------------------------------------------------------------------

T_S = 8           # the scripted horizon


def script():
    """Per-step arrays for 4 envs over 8 steps, with step_to_pred 5:
    env 0 is done at step 2 (mid-horizon) and its next episode latches at
    progress 4; env 1 latches at step_to_pred (step 4) and falls right
    after, at step 5; env 2 starts already latched and is inverted, done at
    step 6 without latching again (the done clears its flag), its next
    episode not inverted; env 3 is inverted, never done, and latches at
    step_to_pred."""
    rng = np.random.default_rng(0)
    done = np.zeros((T_S, N), bool)
    done[2, 0] = done[5, 1] = done[6, 2] = True
    progress = np.zeros((T_S + 1, N), np.int32)
    progress[0] = (0, 0, 3, 0)
    for t in range(T_S):
        progress[t + 1] = np.where(done[t], 0, progress[t] + 1)
    inverted = np.zeros((T_S + 1, N), bool)
    inverted[:, 3] = True
    inverted[:7, 2] = True                  # its next episode is not
    f32 = np.float32
    return dict(
        reward=rng.random((T_S, N)).astype(f32),
        disc=rng.random((T_S, N)).astype(f32) * 2,
        done=done, progress=progress, inverted=inverted,
        wp=rng.normal(size=(T_S + 1, N, 13, 2)).astype(f32),
        pose=rng.normal(size=(T_S + 1, N, 24, 3)).astype(f32),
        vel=rng.normal(size=(T_S + 1, N, 2)).astype(f32),
        cum0=np.array([0.5, 1.0, 3.0, 2.0], f32),
        factor0=np.array([1.0, 0.99 ** 3, 1.0, 0.99], f32),
        already0=np.array([False, False, True, False]))


if jax is not None:
    @jstruct.dataclass
    class JFakeState:
        t: jnp.ndarray
        waypoint_traj: jnp.ndarray
        init_pose: jnp.ndarray
        init_vel: jnp.ndarray
        inverted: jnp.ndarray
        progress: jnp.ndarray

    @jstruct.dataclass
    class JFakeOut:
        reward: jnp.ndarray
        done: jnp.ndarray
        amp_obs: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class FakeState(TensorStruct):
    t: torch.Tensor
    waypoint_traj: torch.Tensor
    init_pose: torch.Tensor
    init_vel: torch.Tensor
    inverted: torch.Tensor
    progress: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FakeOut(TensorStruct):
    reward: torch.Tensor
    done: torch.Tensor
    amp_obs: torch.Tensor


def scripted(arr, xp, state_cls, out_cls):
    """(initial state, observe, policy, step, disc reward) reading `arr`
    (numpy arrays converted by `xp`) by the state's step counter; the disc
    reward travels in the step output's amp_obs."""
    a = {k: xp(v) for k, v in arr.items()}

    def state_at(t):
        return dict(waypoint_traj=a["wp"][t], init_pose=a["pose"][t],
                    init_vel=a["vel"][t], inverted=a["inverted"][t],
                    progress=a["progress"][t])

    def observe(state):
        return a["reward"][0][:, None] * 0

    def policy(params, obs_norm, obs, key):
        return (obs,)

    def step(state, action):
        t = state.t
        new = state.replace(t=t + 1, **state_at(t + 1))
        return new, out_cls(reward=a["reward"][t], done=a["done"][t],
                            amp_obs=a["disc"][t][:, None])

    def disc_reward(params, amp_norm, amp_obs):
        return amp_obs[:, 0]

    return (state_cls(t=xp(np.int32(0)), **state_at(0)), observe, policy,
            step, disc_reward)


@pytest.fixture(scope="module")
def jworld():
    """The small world in both packages, with the synthetic real-path bank
    and half of the real paths heading-inverted."""
    jterr = jgen(map_length=6.0, num_tiles=2, difficulty=0.5)
    jlib = jml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0)
    jbank = jtg.synthetic_real_bank(num_paths=32)
    jcfg = JEnvConfig(**SMALL)
    jcfg = jcfg.replace(traj=jcfg.traj.replace(heading_inversion_prob=0.5))
    jenv = JEnv(jcfg, jterr, jlib, real_traj_bank=jbank)
    cfg = EnvConfig(**SMALL)
    cfg = dataclasses.replace(cfg, traj=dataclasses.replace(
        cfg.traj, heading_inversion_prob=0.5))
    env = PedestrianTerrainEnv(
        cfg, convert.heightfield(np_tree(jterr), "cpu"),
        convert.motion_lib(np_tree(jlib), "cpu"),
        real_traj_bank=convert.tensor(jbank, "cpu"), device="cpu")
    jagent = JAgent(jenv, JAMPConfig(amp_replay_size=16))
    jagent.net = JNet(num_actions=jcfg.num_actions,
                      self_obs_dim=jcfg.self_obs_dim,
                      traj_obs_dim=jcfg.num_traj_samples * 2,
                      task_obs_dim=jcfg.task_obs_dim, **WIDTHS)
    agent = AMPAgent(env, AMPConfig(amp_replay_size=16))
    agent.net = AMPSeptValueNet(
        cfg.num_actions, cfg.self_obs_dim, cfg.num_traj_samples * 2,
        cfg.task_obs_dim, agent.amp_dim, **WIDTHS, device="cpu")
    return jagent, agent


def test_latching_matches_jax_on_a_scripted_env(jworld, monkeypatch):
    """Both packages' `_collect` with the env's observe and step, the
    policy and the disc reward replaced by one scripted fake: the samples
    and the carried accumulator, discount and latch flags equal."""
    jagent, agent = jworld
    arr = script()
    vcfg = dict(horizon=T_S, step_to_pred=STEP_TO_PRED)
    js0, *jfns = scripted(arr, jnp.asarray, JFakeState, JFakeOut)
    ps0, *pfns = scripted(arr, torch.as_tensor, FakeState, FakeOut)
    for (env, ag), (observe, policy, step, disc) in (
            ((jagent.env, jagent), jfns), ((agent.env, agent), pfns)):
        monkeypatch.setattr(env, "observe", observe)
        monkeypatch.setattr(env, "step", step)
        monkeypatch.setattr(ag, "_policy", policy)
        monkeypatch.setattr(ag, "_disc_reward", disc)
    jtr = JTrainer(jagent, JValuePoseNet(), JValueTrainConfig(**vcfg))
    jpol = JTrainState(params=None, opt_state=None, obs_norm=None,
                       amp_norm=None, value_norm=None, env_state=js0,
                       replay_amp=None, replay_ptr=None, replay_filled=None,
                       key=None, epoch=None)
    jts = JValueTrainState(
        policy=jpol, vnet_params=None, vnet_opt=None,
        cum_reward=jnp.asarray(arr["cum0"]),
        disc_factor=jnp.asarray(arr["factor0"]),
        already_latched=jnp.asarray(arr["already0"]),
        key=jax.random.PRNGKey(0), epoch=jnp.zeros((), jnp.int32))
    jts1, js = jtr._collect(jts)

    tr = LocoValTrainer(agent, ValuePoseNet(device="cpu"),
                        ValueTrainConfig(**vcfg))
    pol = agent.init(0).replace(env_state=ps0)
    ts = ValueTrainState(
        policy=pol, vnet_params={}, vnet_opt=None,
        cum_reward=t_(arr["cum0"]), disc_factor=t_(arr["factor0"]),
        already_latched=t_(arr["already0"]), rng=torch.Generator(),
        epoch=0)
    ts1, s = tr._collect(ts)

    valid = np.asarray(js["valid"]).reshape(T_S, N)
    # the script's latches: env 2 never (already latched until its done)
    assert valid.sum(0).tolist() == [2, 1, 0, 1]
    for k in ("wp", "pose", "vel", "valid", "inv"):
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    np.testing.assert_allclose(s["target"].numpy(), np.asarray(js["target"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts1.cum_reward.numpy(),
                               np.asarray(jts1.cum_reward), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts1.disc_factor.numpy(),
                               np.asarray(jts1.disc_factor), rtol=1e-6)
    np.testing.assert_array_equal(ts1.already_latched.numpy(),
                                  np.asarray(jts1.already_latched))
    assert int(ts1.policy.env_state.t) == T_S


def test_collect_matches_jax(jworld, monkeypatch):
    """One real `_collect` of 8 steps with step_to_pred 5 from the JAX
    trainer's fresh episodes (converted), both policies returning the
    actor mean: the LocoVal inputs equal, `valid` and `inv` exact, the
    targets within the step's tolerance. No env may reset inside the
    horizon: the two packages' reset draws cannot match."""
    jagent, agent = jworld
    jenv = jagent.env
    jparams = jax.jit(jagent.net.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, jenv.obs_dim)),
                                       jnp.zeros((1, jagent.amp_dim)))

    def jpolicy(params, obs_norm, obs, key):
        return (jagent.net.apply(params, obs_norm.normalize(obs),
                                 method=jagent.net.actor)[0],)

    def policy(params, obs_norm, obs, gen):
        return (agent._apply(params, "actor", obs_norm.normalize(obs))[0],)

    monkeypatch.setattr(jagent, "_policy", jpolicy)
    monkeypatch.setattr(agent, "_policy", policy)
    # the reset compiled whole, as train_epoch runs it
    monkeypatch.setattr(jenv, "reset", jax.jit(jenv.reset))
    vcfg = dict(horizon=HORIZON, step_to_pred=STEP_TO_PRED)
    jtr = JTrainer(jagent, JValuePoseNet(), JValueTrainConfig(**vcfg))
    jpol = JTrainState(params=jparams, opt_state=None,
                       obs_norm=JRunningNorm.create(jenv.obs_dim),
                       amp_norm=JRunningNorm.create(jagent.amp_dim),
                       value_norm=None, env_state=None, replay_amp=None,
                       replay_ptr=None, replay_filled=None, key=None,
                       epoch=None)
    jts = jtr.init(jpol, jax.random.PRNGKey(1))
    jts1, js = jtr._collect(jts)
    assert (np.asarray(jts1.policy.env_state.progress) == HORIZON).all(), (
        "an env reset inside the horizon")

    tr = LocoValTrainer(agent, ValuePoseNet(device="cpu"),
                        ValueTrainConfig(**vcfg))
    ts = tr.init(agent.init(0), 1)
    pol = ts.policy.replace(
        params=convert.agent_state_dict(np_tree(jparams)),
        obs_norm=convert.running_norm(np_tree(jpol.obs_norm), "cpu"),
        amp_norm=convert.running_norm(np_tree(jpol.amp_norm), "cpu"),
        env_state=convert.env_state(np_tree(jts.policy.env_state),
                                    torch.Generator().manual_seed(0), "cpu"))
    ts1, s = tr._collect(ts.replace(policy=pol))

    assert s["wp"].shape == (HORIZON * N, 13, 2)
    for k in ("wp", "pose", "vel", "valid", "inv"):
        np.testing.assert_array_equal(s[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    assert s["valid"].sum() == N       # every env latches at step_to_pred
    target = np.asarray(js["target"], np.float64)
    np.testing.assert_allclose(s["target"].numpy(), target, rtol=0,
                               atol=BF16 * np.abs(target).max())
    np.testing.assert_array_equal(ts1.already_latched.numpy(),
                                  np.asarray(jts1.already_latched))
    cum = np.asarray(jts1.cum_reward, np.float64)
    np.testing.assert_allclose(ts1.cum_reward.numpy(), cum, rtol=0,
                               atol=BF16 * np.abs(cum).max())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.requires_cuda
def test_update_on_card_matches_cpu():
    """One valuenet update (loss, gradients, parameters) on the card
    against the CPU from the same state after 3 CPU steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    tr = LocoValTrainer(SimpleNamespace(env=None), ValuePoseNet(
        generator=torch.Generator().manual_seed(0), device="cpu"))
    params = {k: v.detach().clone() for k, v in tr.vnet.named_parameters()}
    opt = tr.tx.init(params)
    for i in range(3):
        s = {k: t_(v) for k, v in samples(256, 30 + i).items()}
        _, g = tr._loss_and_grads(params, s)
        params, opt = tr.tx.update(g, opt, params)
    s = {k: t_(v) for k, v in samples(4096, 40).items()}
    runs = {}
    for dev in ("cpu", "cuda"):
        tr.vnet.to(dev)
        p = {k: v.to(dev) for k, v in params.items()}
        loss, g = tr._loss_and_grads(p, {k: v.to(dev) for k, v in s.items()})
        p1, _ = tr.tx.update(g, opt.to(dev), p)
        runs[dev] = (loss.cpu(), {k: v.cpu() for k, v in g.items()},
                     {k: v.cpu() for k, v in p1.items()})
    tr.vnet.to("cpu")
    (lc, gc, pc), (lg, gg, pg) = runs["cpu"], runs["cuda"]
    step_ref, _ = tr.tx.update(gg, opt, params)
    lr_t = float(tr.tx.learning_rate(opt.count))
    assert_update_close((params, pg, gg, lg), (params, pc, gc, lc), step_ref,
                        lr_t)
