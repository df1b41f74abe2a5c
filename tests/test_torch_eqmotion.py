"""The port's compact EqMotion against emloco_tpu/prediction/eqmotion.py on
the CPU: hidden 16, hid_channel 8, 3 modes, batch 3 of 3 agents.

The JAX parameters come across through `convert.eqmotion_state_dict`
(flax's automatic names), and both packages see the same batch. The
forward within 1e-5 of the largest |output|; one train step with the EmLoco
loss (`all` and `wta`) from a fresh optimizer: loss terms within 1e-5 of
their magnitude, each gradient leaf within 1e-5 of its largest |g| (JAX's
gradient read from its first moment, m' / (1 − b1) with optax adam's b1 =
0.9), the updated parameters within 1e-5 where the gradient stands clear
of its tolerance; `mode_values`, `vis_dict` and `evaluate` within 1e-5,
the filter at a threshold no value lies within 1e-4 of. The synthetic
domains' batch functions take JAX's own draws; ETH-UCY windows are bit-equal.

`test_train_step_on_card_matches_cpu` (marked requires_cuda) holds one
train step with the EmLoco loss on the card against the CPU in float64;
it needs neither jax nor the JAX package.
"""
import pathlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax
    from emloco_tpu.kinematics import motion_lib as jml
    from emloco_tpu.learning.networks import ValuePoseNet as JVnet
    from emloco_tpu.prediction import eqmotion as JE
    from emloco_tpu.utils import checkpoint as jckpt
except ModuleNotFoundError:      # only the card test can run without jax
    jax = None
from emloco_tpu_torch import convert
from emloco_tpu_torch.learning.networks import ValuePoseNet
from emloco_tpu_torch.prediction import eqmotion as TE
from emloco_tpu_torch.utils import checkpoint as ckpt

ROOT = pathlib.Path(__file__).resolve().parents[1]
ETH = str(ROOT / "tests" / "data" / "ethucy_fixture.txt")
SMALL = dict(hidden_nf=16, hid_channel=8, n_layers=2, nmode=3)
B, A, LR, W = 3, 3, 1e-3, 0.5
REL = 1e-5
OPTAX_B1 = 0.9


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def world():
    """The JAX model, params, valuenet and batch; the port's trainer
    pieces from them."""
    past, future = (jnp.asarray(x.numpy()) for x in TE.synthetic_eth_batch(
        torch.Generator().manual_seed(0), batch=B, agents=A))
    jcfg = JE.EqMotionConfig(**SMALL)
    params = jax.jit(JE.EqMotion(jcfg).init).lower(
        jax.random.PRNGKey(1), past).compile(
        compiler_options=FAST_COMPILE)(jax.random.PRNGKey(1), past)
    jv = JVnet(use_pose=False, use_vel=True)
    vp = jv.init(jax.random.PRNGKey(2), jnp.zeros((1, 13, 2)), None,
                 jnp.zeros((1, 2)))
    return dict(past=past, future=future, jcfg=jcfg, params=params, jv=jv,
                vp=vp, sd=convert.eqmotion_state_dict(np_tree(params)),
                tvp=convert.valuenet_state_dict(np_tree(vp)))


# XLA:CPU compiles the JAX train step several times faster at optimization
# level 0; the values agree to rounding, which the tolerances absorb
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def fast(fn, *args):
    """fn(*args) under jax.jit, compiled at XLA optimization level 0 (run
    eagerly, the JAX batch functions compile every primitive on its own)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def port_trainer(mode="all", vnet=True, device="cpu"):
    return TE.EqMotionTrainer(
        TE.EqMotionConfig(**SMALL), lr=LR,
        vnet=ValuePoseNet(use_pose=False, use_vel=True, device=device)
        if vnet else None, valueloss_w=W if vnet else 0.0,
        value_loss_mode=mode, device=device)


def test_forward_and_names_match_jax(world):
    tr = port_trainer(vnet=False)
    tr.model.load_state_dict(world["sd"], strict=True)
    want = fast(JE.EqMotion(world["jcfg"]).apply, world["params"],
                world["past"])
    got = tr.predict(world["sd"], t_(world["past"]))
    assert got.shape == (B, A, 3, 12, 2)
    rel_close(got.numpy(), want)
    back = convert.eqmotion_params(world["sd"])
    jax.tree.map(np.testing.assert_array_equal, np_tree(world["params"]),
                 back)


@pytest.mark.parametrize("mode", ["all", "wta"])
def test_train_step_matches_jax(world, mode):
    jt = JE.EqMotionTrainer(world["jcfg"], lr=LR, vnet=world["jv"],
                            valueloss_w=W, value_loss_mode=mode)
    jts, _ = jt.init(jax.random.PRNGKey(1), world["past"])
    jts = jts.replace(params=world["params"],
                      opt_state=jt.tx.init(world["params"]))
    args = (jts, world["vp"], world["past"], world["future"])
    step = JE.EqMotionTrainer.train_step.lower(jt, *args).compile(
        compiler_options=FAST_COMPILE)
    jts1, jaux = step(*args)
    tr = port_trainer(mode)
    ts, tvp = tr.init(0, vnet_params=world["tvp"])
    ts = ts.replace(params=world["sd"], opt_state=tr.tx.init(world["sd"]))
    past, future = t_(world["past"]), t_(world["future"])
    total, aux, grads = tr.loss_and_grads(ts.params, tvp, past, future)
    ts1, aux1 = tr.train_step(ts, tvp, past, future)
    for k in ("wta", "value_loss"):
        want = float(jaux[k])
        assert abs(float(aux[k]) - want) <= REL * max(abs(want), 1e-6), k
        assert float(aux1[k]) == float(aux[k])
    assert float(aux["value_loss"]) > 0.0
    mu = convert.eqmotion_state_dict(np_tree(jts1.opt_state[0].mu))
    jp1 = convert.eqmotion_state_dict(np_tree(jts1.params))
    for k, g in grads.items():
        jg = mu[k].double() / (1 - OPTAX_B1)
        tol = REL * max(jg.abs().max().item(), 1e-12)
        assert (g.double() - jg).abs().max().item() <= tol, k
        clear = jg.abs() >= tol
        du = (ts1.params[k].double() - jp1[k].double())[clear]
        assert du.numel() == 0 or du.abs().max().item() <= REL, k
    assert int(ts1.opt_state.count) == 1 and ts1.step == 1
    for k, v in world["tvp"].items():
        assert torch.equal(tvp[k], v), k


def test_values_vis_dict_and_evaluate_match_jax(world):
    jt = JE.EqMotionTrainer(world["jcfg"], vnet=world["jv"], valueloss_w=W)
    tr = port_trainer()
    past, future, params = world["past"], world["future"], world["params"]
    jpred = jt.predict(params, past)[:, 0]
    jvals = np.asarray(jt.mode_values(world["vp"], past, jpred))
    tpred = tr.predict(world["sd"], t_(past))[:, 0]
    tvals = tr.mode_values(world["tvp"], t_(past), tpred)
    rel_close(tvals.numpy(), jvals)
    # a threshold between two values with no value within 1e-4 of it
    v = np.sort(jvals.reshape(-1))
    gaps = np.diff(v)
    i = int(np.argmax(gaps))
    assert gaps[i] > 2e-4
    thr = float(0.5 * (v[i] + v[i + 1]))
    jvis = jt.vis_dict(params, past, future, vnet_params=world["vp"])
    tvis = tr.vis_dict(world["sd"], t_(past), t_(future),
                       vnet_params=world["tvp"])
    assert sorted(jvis) == sorted(tvis)
    for k in jvis:
        rel_close(tvis[k], jvis[k])
    jev = jt.evaluate(params, past, future, vnet_params=world["vp"],
                      threshold=thr)
    tev = tr.evaluate(world["sd"], t_(past), t_(future),
                      vnet_params=world["tvp"], threshold=thr)
    assert sorted(jev) == sorted(tev)
    for k, want in jev.items():
        assert abs(tev[k] - want) <= REL * max(abs(want), 1e-6), k


def test_ethucy_windows_bit_equal():
    for path in (ETH, f"{ETH},{ETH}"):
        jp, jf = JE.ethucy_windows(path)
        tp, tf = TE.ethucy_windows(path)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tf, jf)
        assert tp.dtype == jp.dtype == np.float32
    # the static dummies of short scenes
    assert (tp[:, 1:, -1] - tp[:, :1, -1] >= 1e3).any()
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(3),
                                             jp.shape[0]))
    jb = list(JE.ethucy_batches(jp, jf, 7, jax.random.PRNGKey(3)))
    tb = list(TE.ethucy_batches(tp, tf, 7, perm=perm, device="cpu"))
    assert len(jb) == len(tb) == jp.shape[0] // 7
    for (a, b), (c, d) in zip(jb, tb):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
        np.testing.assert_array_equal(d.numpy(), np.asarray(b))


def jax_lib(lib):
    """The port's motion library as the JAX package's MotionLib (the two
    build it alike; the JAX build compiles for several seconds)."""
    return jml.MotionLib(**{f: jnp.asarray(getattr(lib, f).numpy())
                            for f in jml.MotionLib.__dataclass_fields__})


@pytest.mark.parametrize("domain", ["eth", "nbody", "h36m", "md17_chain",
                                    "md17_aspirin"])
def test_synthetic_batch_from_jax_draws(domain):
    """Each domain's batch function on JAX's own draws (split from the key
    as the JAX function splits it) against the JAX function."""
    key = jax.random.PRNGKey(4)
    if domain == "eth":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        s = (2, 3, 1)
        draws = dict(
            speed=jax.random.uniform(k1, s, minval=0.3, maxval=1.8),
            heading0=jax.random.uniform(k2, s, minval=-np.pi, maxval=np.pi),
            curv=jax.random.normal(k3, s) * 0.1,
            offset=jax.random.uniform(k4, (2, 3, 1, 2), minval=-5,
                                      maxval=5))
        want = fast(lambda k: JE.synthetic_eth_batch(k, batch=2, agents=3),
                    key)
        got = TE.eth_batch({k: t_(v) for k, v in draws.items()})
    elif domain == "nbody":
        k1, k2 = jax.random.split(key)
        x0 = jax.random.normal(k1, (2, 5, 3))
        v0 = jax.random.normal(k2, (2, 5, 3)) * 0.5
        want = fast(lambda k: JE.synthetic_nbody_batch(k, batch=2), key)
        got = TE.nbody_batch(t_(x0), t_(v0))
    elif domain == "h36m":
        lib = TE.h36m_library("cpu")
        jlib = jax_lib(lib)
        k1, k2 = jax.random.split(key)
        ids = jml.sample_motions(jlib, k1, 2)
        t0 = jml.sample_time(jlib, k2, ids, truncate_time=20 / 25.0)
        want = fast(lambda k, lib: JE.synthetic_h36m_batch(k, batch=2,
                                                           lib=lib),
                    key, jlib)
        got = TE.h36m_batch(lib, t_(ids).long(), t_(t0))
        assert got[0].shape == (2, 24, 10, 3)
    else:
        structure = (TE.load_md17_structure() if domain == "md17_aspirin"
                     else None)
        if structure is not None:
            np.testing.assert_array_equal(structure,
                                          JE.load_md17_structure())
        k1, k2, k3 = jax.random.split(key, 3)
        d = (jax.random.normal(k1, (2, 4)),
             jax.random.normal(k2, (2, 13, 3)),
             jax.random.normal(k3, (2, 13, 3)))
        want = fast(lambda k: JE.synthetic_md17_batch(
            k, batch=2, past=6, future=4, structure=structure), key)
        got = TE.md17_batch(tuple(t_(x) for x in d), past=6, future=4,
                            structure=structure)
    for g, w in zip(got, want):
        rel_close(g.numpy(), w)


def test_safe_arccos_gradient_finite_at_one():
    cos = torch.tensor([1.0, -1.0, 0.3, 1.0 + 1e-7], requires_grad=True)
    out = TE._safe_arccos(cos)
    g, = torch.autograd.grad(out.sum(), cos)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.arccos(np.clip([1, -1, 0.3, 1], -1, 1)),
                               atol=1e-6)
    jg = jax.grad(lambda c: JE._safe_arccos(c).sum())(
        jnp.asarray(cos.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5)


def test_apply_decay_staircase_crossed():
    """Adam with the --apply-decay staircase (×0.8 every 2 steps here)
    against optax.adam(exponential_decay(staircase=True)) over 3 steps."""
    sched = optax.exponential_decay(5e-4, 2, 0.8, staircase=True)
    tx = optax.adam(sched)
    port = TE.Adam(5e-4, 2, 0.8)
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    jstate, tstate = tx.init(p), port.init({"w": t_(p["w"])})
    jp, tp = p, {"w": t_(p["w"])}
    for i in range(3):
        g = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
        assert float(port.learning_rate(tstate.count)) == pytest.approx(
            float(sched(i)), rel=1e-6)
        u, jstate = tx.update(g, jstate)
        jp = optax.apply_updates(jp, u)
        tp, tstate = port.update({"w": t_(g["w"])}, tstate, tp)
        np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=0, atol=1e-7)
    assert float(port.learning_rate(tstate.count)) == pytest.approx(
        5e-4 * 0.8, rel=1e-6)


def test_e2_equivariance(world):
    tr = port_trainer(vnet=False)
    past = t_(world["past"])
    pred = tr.predict(world["sd"], past)
    ang = 0.7
    R = torch.tensor([[np.cos(ang), -np.sin(ang)],
                      [np.sin(ang), np.cos(ang)]], dtype=torch.float32)
    pred_rot = tr.predict(world["sd"], torch.einsum("ij,batj->bati", R, past))
    np.testing.assert_allclose(
        torch.einsum("ij,bamtj->bamti", R, pred).numpy(), pred_rot.numpy(),
        atol=2e-3)
    shift = torch.tensor([3.0, -2.0])
    np.testing.assert_allclose((pred + shift).numpy(),
                               tr.predict(world["sd"], past + shift).numpy(),
                               atol=2e-3)


def test_checkpoint_both_ways(world, tmp_path):
    jm = JE.EqMotion(world["jcfg"])
    tr = port_trainer(vnet=False)
    path = str(tmp_path / "port" / "eqmotion.ckpt")
    tr.save_checkpoint(path, world["sd"], {"cfg": str(tr.cfg)})
    tree, meta = jckpt.load_pytree(path)
    assert meta["cfg"] == str(world["jcfg"])
    want = tr.predict(world["sd"], t_(world["past"])).numpy()
    rel_close(np.asarray(jm.apply(tree["params"], world["past"])), want)
    path = str(tmp_path / "jax" / "eqmotion.ckpt")
    jckpt.save_pytree(path, {"params": world["params"]},
                      metadata={"cfg": str(world["jcfg"])})
    tree, _ = ckpt.load_pytree(path)
    got = tr.predict(tr.params_from(tree["params"]), t_(world["past"]))
    rel_close(got.numpy(), jm.apply(world["params"], world["past"]))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["all", "wta"])
def test_train_step_on_card_matches_cpu(mode):
    """One train step with the EmLoco loss on the card and on the CPU from
    the same parameters and batch, in float64: loss terms 1e-5, gradients
    1e-5 of each leaf's largest |g|, the update 1e-5 where the gradient
    stands clear."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    past, future = TE.synthetic_eth_batch(gen, batch=B, agents=A)
    vnet = ValuePoseNet(use_pose=False, use_vel=True,
                        generator=torch.Generator().manual_seed(1),
                        device="cpu")
    vp = {k: v.detach().double() for k, v in vnet.named_parameters()}
    params = port_trainer(vnet=False).init(0)[0].params
    runs = {}
    for dev in ("cpu", "cuda"):
        tr = port_trainer(mode, device=dev)
        tr.vnet.double()
        tr.model.double()
        p = {k: v.to(dev, torch.float64) for k, v in params.items()}
        ts = TE.EqMotionTrainState(params=p, opt_state=tr.tx.init(p),
                                   step=0)
        v = {k: x.to(dev) for k, x in vp.items()}
        b = [x.to(dev, torch.float64) for x in (past, future)]
        _, aux, grads = tr.loss_and_grads(ts.params, v, *b)
        ts1, _ = tr.train_step(ts, v, *b)
        runs[dev] = dict(aux={k: float(x) for k, x in aux.items()},
                         grads={k: x.cpu() for k, x in grads.items()},
                         p1={k: x.cpu() for k, x in ts1.params.items()})
    cpu, card = runs["cpu"], runs["cuda"]
    for k, v in cpu["aux"].items():
        assert abs(card["aux"][k] - v) <= REL * max(abs(v), 1e-6), k
    for k, g in cpu["grads"].items():
        tol = REL * max(g.abs().max().item(), 1e-12)
        assert (card["grads"][k] - g).abs().max().item() <= tol, k
        clear = g.abs() >= tol
        du = (card["p1"][k] - cpu["p1"][k])[clear]
        assert du.numel() == 0 or du.abs().max().item() <= REL, k
