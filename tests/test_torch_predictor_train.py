"""The port's predictor trainer against emloco_tpu/prediction on the CPU:
three train steps with the EmLoco loss through a frozen LocoVal net
(traj_noise_std 0 and 0.05; lr_decay_epochs 2, so the third step takes
the decayed rate), each from JAX's parameters and optimizer state with
JAX's own noise and masking draws fed at dropout 0; and the presets
against configs/*.yaml. One small configuration: nhid 16, 2 local + 1
global layers, 2 heads, 3 modes, batch 2 of the JTA fixture's windows
padded to 3 people (tests/test_torch_predictor_eval.py holds evaluation,
predictor files and the entry points on it).

The JAX step returns no gradients; its first moments do: from a moment m
before the step and m' after it, the clipped gradient is (m' − b1·m)/(1 −
b1) with optax adam's b1 = 0.9. Tolerances: loss terms 1e-4 of their
magnitude, gradient leaves 1e-4 of their largest |g|, the port's step
within 1e-3 × lr_t of optax's step on the port's own gradients on every
entry, and of JAX's whole update where the gradient stands clear of its
tolerance; the LocoVal parameters bit-equal before and after.

`test_train_step_on_card_matches_cpu` (marked requires_cuda) holds one
train step and predict on the card against the CPU with the smoke's
`predictor_reference` tolerances; it needs neither jax nor the JAX package.
"""
import pathlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import optax
    import yaml
    from emloco_tpu.learning.networks import ValuePoseNet as JVnet
    from emloco_tpu.prediction.model import TransMotionConfig as JCfg
    from emloco_tpu.prediction.train import PredictorTrainer as JTrainer
    from emloco_tpu.prediction.train import PredictTrainConfig as JPCfg
    from emloco_tpu.prediction.train import PredictTrainState as JState
except ModuleNotFoundError:      # only the card test can run without jax
    jax = None
from emloco_tpu_torch import convert
from emloco_tpu_torch.learning.networks import ValuePoseNet
from emloco_tpu_torch.prediction import data as tdata
from emloco_tpu_torch.prediction.model import TransMotionConfig, mask_draws
from emloco_tpu_torch.prediction.presets import PRESETS, configs
from emloco_tpu_torch.prediction.train import (PredictorTrainer,
                                               PredictTrainConfig,
                                               TrainDraws)

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = str(ROOT / "tests" / "data" / "jta_all_cues_fixture.ndjson")
SMALL = dict(nhid=16, nhead=2, dim_ff=32, nlayers_local=2, nlayers_global=1,
             nmode=3, dropout=0.0)
TRAIN = dict(use_value_loss=True, lr=1e-3, lr_decay_epochs=2, lr_decay=0.1)
N = 3
WINDOWS = ([0, 1], [2, 3], [1, 2])            # the three steps' batches
LOSS_REL, GRAD_REL, UPDATE_LR = 1e-4, 1e-4, 1e-3
OPTAX_B1 = 0.9
AUX = ("traj_loss", "value_loss", "total")
YAML = {"jta": "jta_predictor.yaml", "jrdb": "jrdb_predictor.yaml",
        "lstm": "jta_lstm.yaml"}


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def scenes(seed=0):
    return tdata.NdjsonScenes(FIXTURE, max_people=N, seed=seed)


def port_trainer(traj_noise_std=0.0, device="cpu"):
    cfg = PredictTrainConfig(**TRAIN, traj_noise_std=traj_noise_std)
    return PredictorTrainer(TransMotionConfig(**SMALL), cfg,
                            vnet=ValuePoseNet(device=device), device=device)


@pytest.fixture(scope="module")
def vnets():
    """The JAX ValuePoseNet and its parameters; the port's state_dict."""
    jv = JVnet(use_pose=True, use_vel=True)
    vp = jv.init(jax.random.PRNGKey(5), jnp.zeros((1, 13, 2)),
                 jnp.zeros((1, 24, 3)), jnp.zeros((1, 2)))
    return jv, vp, convert.valuenet_state_dict(np_tree(vp))


@pytest.fixture(scope="module")
def start(vnets):
    """The port's trainer and state from seed 0 at traj_noise_std 0, and
    its parameters in the flax layout."""
    tt = port_trainer()
    ts = tt.init(0, vnet_params=vnets[2])
    return tt, ts, jax.tree.map(jnp.asarray, tt.flax_params(ts.params))


def jax_state(jt, params, vp):
    return JState(params=params, opt_state=jt.tx.init(params),
                  vnet_params=vp, key=jax.random.PRNGKey(3),
                  step=jnp.zeros((), jnp.int32))


# XLA:CPU compiles the JAX train step in about 28 s on one core at its
# default optimization level and in about 9 s at level 0; the values agree
# to rounding, which the tolerances absorb
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """`fn` (a jitted function) lowered for `args` and compiled fast."""
    return fn.lower(*args).compile(compiler_options=FAST_COMPILE)


_DRAWS = {}


def jax_draws(jt, jts, batch, cfg):
    """The noise and masking draws JAX's train_step makes from jts.key:
    the normal from its fourth split key, the eight uniforms from the key
    flax's make_rng("mask") gives the top-level module for the second."""
    B = batch.obs.shape[0]
    shapes = tuple(tuple(d.shape) for d in mask_draws(
        torch.Generator().manual_seed(0), cfg, B, N))
    noise_shape = batch.obs[..., 0:1, :2].shape

    def draw(key, params):
        _, k_mask, _, k_noise = jax.random.split(key, 4)
        rng = jt.model.apply(params, rngs={"mask": k_mask},
                             method=lambda m: m.make_rng("mask"))
        return (jax.random.normal(k_noise, noise_shape, jnp.float32),
                [jax.random.uniform(k, s)
                 for k, s in zip(jax.random.split(rng, 8), shapes)])

    if shapes not in _DRAWS:
        _DRAWS[shapes] = compiled(jax.jit(draw), jts.key, jts.params)
    noise, masks = _DRAWS[shapes](jts.key, jts.params)
    return TrainDraws(noise=t_(noise), masks=[t_(m) for m in masks])


def grad_tolerance(grads: dict) -> dict:
    """Each leaf's gradient tolerance: GRAD_REL of its largest |g|, save
    the attention key projections' biases, whose gradient is zero (the
    softmax over keys ignores a shift common to every key) and whose
    entries are rounding: GRAD_REL of the largest |g| of every leaf."""
    top = max(g.abs().max().item() for g in grads.values())
    return {k: GRAD_REL * max(top if k.endswith("attn.key.bias")
                              else g.abs().max().item(), 1e-12)
            for k, g in grads.items()}


def close_update(p0, p1, grads, rp1, rgrads, step_ref, lr_t):
    """The gradient, step and update gates of the module docstring; all
    trees are state_dicts."""
    tols = grad_tolerance(rgrads)
    for k in p0:
        g = rgrads[k].double()
        gtol = tols[k]
        assert (grads[k].double() - g).abs().max().item() <= gtol, k
        assert ((p1[k].double() - step_ref[k].double()).abs().max().item()
                <= UPDATE_LR * lr_t), k
        clear = g.abs() >= gtol
        du = (p1[k] - p0[k]).double()[clear]
        rdu = (rp1[k] - p0[k]).double()[clear]
        if du.numel():
            assert (du - rdu).abs().max().item() <= UPDATE_LR * lr_t, k


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_train_steps_match_jax(vnets, start, noise):
    jv, vp, tvp = vnets
    _, ts_init, params = start
    tt = port_trainer(noise)
    jt = JTrainer(JCfg(**SMALL), JPCfg(**TRAIN, traj_noise_std=noise),
                  vnet=jv)
    jts = jax_state(jt, params, vp)
    ds = scenes()
    step = compiled(JTrainer.train_step, jt, jts, *ds.window_batch(
        WINDOWS[0]))
    optax_step = compiled(jax.jit(lambda g, o, p: optax.apply_updates(
        p, jt.tx.update(g, o, p)[0])), jts.params, jts.opt_state,
        jts.params)
    to_sd = convert.transmotion_state_dict
    vnet_before = {k: v.clone() for k, v in tvp.items()}
    for i, idx in enumerate(WINDOWS):
        batch = ds.window_batch(idx)
        draws = jax_draws(jt, jts, batch, tt.mcfg)
        jts1, jaux = step(jts, *batch)
        ts0 = ts_init.replace(
            params=to_sd(np_tree(jts.params)),
            opt_state=convert.adam_state(np_tree(jts.opt_state), "cpu",
                                         state_dict=to_sd))
        _, _, grads = tt.loss_and_grads(ts0, *tt.tensors(batch),
                                        draws=draws)
        ts1, aux = tt.train_step(ts0, *batch, draws=draws)
        for k in AUX:
            want = float(jaux[k])
            assert abs(float(aux[k]) - want) <= LOSS_REL * max(abs(want),
                                                               1e-6), k
        assert float(aux["value_loss"]) > 0.0
        m0 = convert.adam_state(np_tree(jts.opt_state), "cpu", to_sd).mu
        m1 = convert.adam_state(np_tree(jts1.opt_state), "cpu", to_sd).mu
        jg = {k: (m1[k].double() - OPTAX_B1 * m0[k].double())
              / (1 - OPTAX_B1) for k in m1}
        step_ref = to_sd(np_tree(optax_step(
            jax.tree.map(jnp.asarray, tt.flax_params(grads)),
            jts.opt_state, jts.params)))
        lr_t = TRAIN["lr"] * TRAIN["lr_decay"] ** (i // 2)
        assert float(tt.tx.learning_rate(ts0.opt_state.count)) == \
            pytest.approx(lr_t, rel=1e-6)
        close_update(ts0.params, ts1.params, tt.tx.clip(grads),
                     to_sd(np_tree(jts1.params)), jg, step_ref, lr_t)
        assert int(ts1.opt_state.count) == i + 1 and ts1.step == 1
        for k, v in vnet_before.items():
            assert torch.equal(ts1.vnet_params[k], v), k
        jts = jts1


@pytest.mark.parametrize("preset", sorted(YAML))
def test_presets_match_configs(preset):
    with open(ROOT / "configs" / YAML[preset]) as f:
        raw = yaml.safe_load(f)
    for section in ("model", "predict"):
        assert PRESETS[preset][section] == raw[section], section
    mcfg, pcfg = configs(preset, ["model.nmode=2", "predict.lr=0.5"])
    jm = dict(raw["model"], nmode=2)
    assert all(getattr(mcfg, k) == v for k, v in jm.items())
    assert pcfg.lr == 0.5 and pcfg.lr_decay == raw["predict"]["lr_decay"]


@pytest.mark.requires_cuda
def test_train_step_on_card_matches_cpu():
    """One train step with the EmLoco loss (dropout 0.1, noise 0.05, the
    draws made on the CPU) on the card and on the CPU from the same
    parameters and batch, in float64 as the smoke's predictor_reference
    (in float32 ReLU decisions within rounding of zero may part the
    devices): loss terms 1e-4, gradients 1e-4 of each leaf's largest |g|,
    the update 1e-3 × lr where the gradient stands clear; then float32
    predict within 1e-4 of the largest |output|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    vnet = ValuePoseNet(generator=torch.Generator().manual_seed(1),
                        device="cpu")
    vp = {k: v.detach().clone() for k, v in vnet.named_parameters()}
    batch = scenes().window_batch([0, 1])
    mcfg = TransMotionConfig(**{**SMALL, "dropout": 0.1})
    cfg = PredictTrainConfig(**TRAIN, traj_noise_std=0.05)
    params = PredictorTrainer(mcfg, cfg, device="cpu").init(0).params

    def to(x, dev):
        return x.to(dev, torch.float64) if x.is_floating_point() \
            else x.to(dev)

    runs = {}
    for dev in ("cpu", "cuda"):
        tt = PredictorTrainer(mcfg, cfg, vnet=ValuePoseNet(device=dev),
                              device=dev)
        ts = tt.init(0, vnet_params={k: to(v, dev) for k, v in vp.items()})
        ts = ts.replace(params={k: to(v, dev) for k, v in params.items()},
                        opt_state=ts.opt_state.map_tensors(
                            lambda x: to(x, dev)))
        b = tdata.SceneBatch(*(to(x, dev) for x in tt.tensors(batch)))
        ts = ts.replace(rng=torch.Generator().manual_seed(9))
        total, aux, grads = tt.loss_and_grads(ts, *b)
        p1, _ = tt.tx.update(grads, ts.opt_state, ts.params)
        pred = tt.predict({k: v.to(dev) for k, v in params.items()},
                          batch.obs, batch.padding_mask)
        runs[dev] = dict(
            p1={k: v.cpu() for k, v in p1.items()},
            grads={k: v.cpu() for k, v in grads.items()},
            aux={k: float(v) for k, v in aux.items()}, pred=pred.cpu())
    cpu, card = runs["cpu"], runs["cuda"]
    for k, v in cpu["aux"].items():
        assert abs(card["aux"][k] - v) <= LOSS_REL * max(abs(v), 1e-6), k
    lr = TRAIN["lr"]
    tols = grad_tolerance(cpu["grads"])
    for k, g in cpu["grads"].items():
        assert (card["grads"][k] - g).abs().max().item() <= tols[k], k
        clear = g.abs() >= tols[k]
        du = (card["p1"][k] - cpu["p1"][k])[clear]
        assert du.numel() == 0 or du.abs().max().item() <= UPDATE_LR * lr, k
    want = cpu["pred"]
    assert (card["pred"] - want).abs().max().item() <= \
        1e-4 * want.abs().max().item()
