"""The port's architecture-exact EqMotion against
emloco_tpu/prediction/eqmotion_full.py on the CPU: nf 16, 12 channels, 2
layers.

EqMotionFull on the h36m domain (24 joints as nodes in 3-D, agent tokens,
one mode) and EqMotionFullEth (5 modes, a pad dummy among the agents)
against the JAX forward within 1e-5 of the largest |output|, the JAX
parameters carried by `convert.eqmotion_full_state_dict`; one
EqMotionFullTrainer step and one EqMotionTrainer step with the full model
against JAX (loss within 1e-5, each gradient leaf within 1e-4 of its
largest |g|, read from optax adam's first moment); the pad dummy's
placement leaves the ego's prediction bit-equal; the port's state_dict
through the JAX package's `transplant_from_torch` gives back the JAX
params exactly; a state_dict with the reference's dead per-layer coord_mlp
keys loads strictly once they are dropped.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from emloco_tpu.prediction import eqmotion as JE
from emloco_tpu.prediction import eqmotion_full as JF
from emloco_tpu_torch import convert
from emloco_tpu_torch.prediction import eqmotion as TE
from emloco_tpu_torch.prediction import eqmotion_full as TF

REL = 1e-5
# gradients: 1e-4 of each leaf's largest |g|, the predictor's train-step
# tolerance (tests/test_torch_predictor_train.py); float32 roundings differ
# between XLA's and torch's kernels and the full model's DCT, two MLP stacks
# a layer and the reflection gate carry them further than the compact
# model's (the agent token's gradient parts at 1.4e-5 on this batch)
GRAD_REL = 1e-4
OPTAX_B1 = 0.9
H36M = dict(past=6, future=5, nf=16, channels=12, n_layers=2, n_agent=24,
            add_agent_token=True)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def fast(fn, *args):
    """fn(*args) compiled as one program at XLA optimization level 0
    (eagerly, flax compiles every primitive on its own)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def jit_init(module, seed, *args):
    return fast(module.init, jax.random.PRNGKey(seed),
                *(jnp.asarray(a) for a in args))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


def grads_close(grads, jmu, to_sd):
    """Each port gradient leaf within GRAD_REL of its largest |g| of JAX's,
    read from the first moment after one step from zero."""
    mu = to_sd(np_tree(jmu))
    assert sorted(mu) == sorted(grads)
    for k, g in grads.items():
        jg = mu[k].double() / (1 - OPTAX_B1)
        tol = GRAD_REL * max(jg.abs().max().item(), 1e-12)
        assert (g.double() - jg).abs().max().item() <= tol, k


@pytest.fixture(scope="module")
def h36m():
    """Joint trajectories of the h36m domain (the port's gait library),
    the JAX params of EqMotionFull and the port's trainer on them."""
    past, future = TE.synthetic_h36m_batch(torch.Generator().manual_seed(0),
                                           batch=2, past=6, future=5)
    cfg = JF.EqMotionFullConfig(**H36M)
    jtr = JF.EqMotionFullTrainer(cfg, lr=1e-3)
    params = jit_init(jtr.model, 0, *(x.numpy() for x in
                                      TF.EqMotionFullTrainer.featurize(past)))
    opt = jtr.tx.init(params)
    tr = TF.EqMotionFullTrainer(TF.EqMotionFullConfig(**H36M), lr=1e-3,
                                device="cpu")
    return dict(past=past, future=future, jtr=jtr, params=params, opt=opt,
                tr=tr, sd=convert.eqmotion_full_state_dict(
                    np_tree(params)))


@pytest.fixture(scope="module")
def eth():
    """An ETH batch whose agent 2 is a static pad dummy, and the JAX
    EqMotionFullEth params at 5 modes."""
    past, future = TE.synthetic_eth_batch(torch.Generator().manual_seed(1),
                                          batch=3, agents=3)
    past[:, 2] = past[:, 0, -1:] + 1000.0
    future[:, 2] = past[:, 2, -1:]
    cfg = JF.eth_full_config(nmode=5, channels=12)
    cfg = JF.EqMotionFullConfig(**{**cfg.__dict__, "nf": 16, "n_layers": 2})
    jm = JF.EqMotionFullEth(cfg)
    params = jit_init(jm, 2, past.numpy())
    model = TF.EqMotionFullEth(TF.EqMotionFullConfig(**cfg.__dict__),
                               device="cpu")
    sd = convert.eqmotion_full_state_dict(np_tree(params))
    model.load_state_dict(sd, strict=True)
    return dict(past=past, future=future, cfg=cfg, jm=jm, params=params,
                model=model, sd=sd)


def test_h36m_forward_matches_jax(h36m):
    jpast = jnp.asarray(h36m["past"].numpy())
    want, wcats = fast(h36m["jtr"].predict, h36m["params"], jpast)
    got, cats = h36m["tr"].predict(h36m["sd"], h36m["past"])
    assert got.shape == (2, 24, 5, 3) and len(cats) == 2
    rel_close(got.numpy(), want)
    rel_close(cats[0].numpy(), wcats[0])


def test_eth_forward_matches_jax(eth):
    want = fast(eth["jm"].apply, eth["params"],
                jnp.asarray(eth["past"].numpy()))
    with torch.no_grad():
        got = eth["model"](eth["past"])
    assert got.shape == (3, 3, 5, 12, 2)
    rel_close(got.numpy(), want)


def test_full_trainer_step_matches_jax(h36m):
    jtr = h36m["jtr"]
    args = (h36m["params"], h36m["opt"], jnp.asarray(h36m["past"].numpy()),
            jnp.asarray(h36m["future"].numpy()))
    step = jax.jit(jtr.train_step).lower(*args).compile(
        compiler_options=FAST_COMPILE)
    jp1, jopt1, jloss = step(*args)
    tr = h36m["tr"]
    loss, grads = tr.loss_and_grads(h36m["sd"], h36m["past"],
                                    h36m["future"])
    assert abs(float(loss) - float(jloss)) <= REL * abs(float(jloss))
    grads_close(grads, jopt1[0].mu, convert.eqmotion_full_state_dict)
    p1, opt1, loss1 = tr.train_step(h36m["sd"], tr.tx.init(h36m["sd"]),
                                    h36m["past"], h36m["future"])
    assert float(loss1) == float(loss) and int(opt1.count) == 1


def test_eqmotion_trainer_with_full_model_matches_jax(eth):
    jt = JE.EqMotionTrainer(JE.EqMotionConfig(nmode=5), model=eth["jm"],
                            lr=1e-3)
    jts = JE.EqMotionTrainState(params=eth["params"],
                                opt_state=jt.tx.init(eth["params"]),
                                key=jax.random.PRNGKey(2),
                                step=jnp.zeros((), jnp.int32))
    args = (jts, None, jnp.asarray(eth["past"].numpy()),
            jnp.asarray(eth["future"].numpy()))
    step = JE.EqMotionTrainer.train_step.lower(jt, *args).compile(
        compiler_options=FAST_COMPILE)
    jts1, jaux = step(*args)
    tr = TE.EqMotionTrainer(TE.EqMotionConfig(nmode=5), lr=1e-3,
                            model=eth["model"], device="cpu")
    _, aux, grads = tr.loss_and_grads(eth["sd"], None, eth["past"],
                                      eth["future"])
    want = float(jaux["wta"])
    assert abs(float(aux["wta"]) - want) <= REL * abs(want)
    assert float(aux["value_loss"]) == 0.0
    grads_close(grads, jts1.opt_state[0].mu, convert.eqmotion_full_state_dict)
    ts, _ = tr.init(0)
    ts1, _ = tr.train_step(ts.replace(params=eth["sd"],
                                      opt_state=tr.tx.init(eth["sd"])),
                           None, eth["past"], eth["future"])
    assert all(torch.isfinite(v).all() for v in ts1.params.values())


def test_pad_dummy_placement_bit_equal(eth):
    p2 = eth["past"].clone()
    p3 = eth["past"].clone()
    p3[:, 2] = p3[:, 0, -1:] + 2000.0
    with torch.no_grad():
        a = eth["model"](p2)
        b = eth["model"](p3)
    assert torch.equal(a[:, 0], b[:, 0])
    assert torch.isfinite(a).all()


def test_transplant_round_trip(h36m, eth):
    for cfg, sd, params in (
            (JF.EqMotionFullConfig(**H36M), h36m["sd"], h36m["params"]),
            (eth["cfg"], {k[len("core."):]: v for k, v in eth["sd"].items()},
             {"params": eth["params"]["params"]["core"]})):
        back = JF.transplant_from_torch({k: v.numpy() for k, v in sd.items()},
                                        cfg)
        jax.tree.map(np.testing.assert_array_equal, np_tree(params), back)
        jax.tree.map(np.testing.assert_array_equal, np_tree(params),
                     convert.eqmotion_full_params(sd))
    back = convert.eqmotion_full_params(eth["sd"])
    jax.tree.map(np.testing.assert_array_equal, np_tree(eth["params"]), back)


def test_reference_state_dict_with_dead_keys_loads(h36m):
    """The reference builds a coord_mlp in every layer and never calls it;
    its state_dict carries the keys. They are dropped by name, then the
    load is strict."""
    sd = dict(h36m["sd"])
    c = H36M["channels"]
    for i in range(H36M["n_layers"]):
        sd[f"gcl_{i}.coord_mlp.0.weight"] = torch.zeros(c, c)
        sd[f"gcl_{i}.coord_mlp.0.bias"] = torch.zeros(c)
        sd[f"gcl_{i}.coord_mlp.2.weight"] = torch.zeros(1, c)
    model = TF.EqMotionFull(TF.EqMotionFullConfig(**H36M), device="cpu")
    with pytest.raises(RuntimeError, match="coord_mlp"):
        model.load_state_dict(sd, strict=True)
    kept = TF.drop_dead_keys(sd)
    assert sorted(kept) == sorted(h36m["sd"])
    model.load_state_dict(kept, strict=True)
    with torch.no_grad():
        got, _ = model(*TF.EqMotionFullTrainer.featurize(h36m["past"]))
    want, _ = h36m["tr"].predict(h36m["sd"], h36m["past"])
    assert torch.equal(got, want)
