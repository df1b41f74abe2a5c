"""The port's prediction modules against emloco_tpu/prediction on the CPU:
the metrics (1e-6) and the LocoVal filter (bit-equal, with a row no mode
passes); synthetic scenes from one seed (1e-5 of each field's magnitude;
the gait FK runs in torch on one side and XLA on the other); the JTA
fixture's ndjson windows (bit-equal); the LocoVal inputs; TransMotion's
eval forward for the JTA and JRDB streams at limit_obs 0, 3 and 9 and its
train-time masking with JAX's own uniforms fed (1e-4 of the largest
|output|, from the JAX parameters converted); dropout; the LSTM; and the
weight conversions both ways. One small configuration: nhid 16, 2 local +
1 global layers, 2 heads, 3 modes, 3 people, batch 2.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from emloco_tpu.prediction import data as jdata
from emloco_tpu.prediction import metrics as jM
from emloco_tpu.prediction.lstm import LSTMPredictor as JLSTM
from emloco_tpu.prediction.model import TransMotion as JTM
from emloco_tpu.prediction.model import TransMotionConfig as JCfg
from emloco_tpu_torch import convert
from emloco_tpu_torch.prediction import data as tdata
from emloco_tpu_torch.prediction import metrics as tM
from emloco_tpu_torch.prediction.lstm import LSTMPredictor
from emloco_tpu_torch.prediction.model import (TransMotion,
                                               TransMotionConfig, dropout,
                                               mask_draws)

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = str(ROOT / "tests" / "data" / "jta_all_cues_fixture.ndjson")
SMALL = dict(nhid=16, nhead=2, dim_ff=32, nlayers_local=2, nlayers_global=1,
             nmode=3, dropout=0.0)
STREAMS = {"jta": {}, "jrdb": dict(use_3dbb=False, use_2dpose=False)}
B, N = 2, 3
FWD_REL = 1e-4


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scenes():
    """One batch of 2 scenes of 3 people from seed 0 in each package."""
    return (jdata.SyntheticScenes(num_people=N, seed=0).batch(B),
            tdata.SyntheticScenes(num_people=N, seed=0).batch(B))


def close(got, want, rel):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((4, 12, 5, 2)).astype(np.float32)
    gt = rng.standard_normal((4, 12, 2)).astype(np.float32)
    j, t = (jnp.asarray(pred), jnp.asarray(gt)), (t_(pred), t_(gt))
    close(tM.mse_loss(t[0][:, :, 0], t[1]), jM.mse_loss(j[0][:, :, 0], j[1]),
          1e-6)
    close(tM.mse_loss_multi(*t), jM.mse_loss_multi(*j), 1e-6)
    ja, ta = jM.ade_fde(*j), tM.ade_fde(*t)
    assert ja.keys() == ta.keys()
    for k in ja:
        close(ta[k], ja[k], 1e-6)
    close(tM.des(t[0][:, :, 0], t[1]), jM.des(j[0][:, :, 0], j[1]), 1e-6)
    close(tM.initial_yaw_error(t[0][:, :, 0], t[1]),
          jM.initial_yaw_error(j[0][:, :, 0], j[1]), 1e-6)
    jp = jM.motion_primitives(jdata.prepend_origin(j[1]))
    tp = tM.motion_primitives(tdata.prepend_origin(t[1]))
    for k in jp:
        close(tp[k], jp[k], 1e-6)
    assert tM.chi2_histogram_distance(tp["speed"], tp["acc"]) == \
        jM.chi2_histogram_distance(jp["speed"], jp["acc"])


def test_locoval_filter_bit_equal_with_fallback():
    """Row 1 has no mode at the threshold: its argmax is kept alone; a tie
    at the threshold counts as kept."""
    values = np.array([[0.9, 0.2, 0.7, 0.71],
                       [0.1, 0.5, 0.3, 0.69],
                       [0.7, 0.7, 0.1, 0.0]], np.float32)
    pred = np.zeros((3, 12, 4, 2), np.float32)
    want = np.asarray(jM.locoval_filter(jnp.asarray(pred),
                                        jnp.asarray(values), 0.7))
    got = tM.locoval_filter(t_(pred), t_(values), 0.7).numpy()
    assert np.array_equal(got, want)
    assert got[1].tolist() == [False, False, False, True]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_scenes_match_jax(scenes):
    jb, tb = scenes
    for name, j, t in zip(tdata.SceneBatch._fields, jb, tb):
        assert np.asarray(t).dtype == np.asarray(j).dtype, name
        close(t, j, 1e-5)
    assert np.array_equal(tb.padding_mask, jb.padding_mask)


def test_ndjson_scenes_bit_equal():
    jd = jdata.NdjsonScenes(FIXTURE, seed=3)
    td = tdata.NdjsonScenes(FIXTURE, seed=3)
    assert len(jd) == len(td)
    for _ in range(2):
        jb, tb = jd.batch(5), td.batch(5)
        for name, j, t in zip(tdata.SceneBatch._fields, jb, tb):
            assert np.array_equal(np.asarray(t), np.asarray(j)), name
    js = jdata.read_ndjson_scenes(FIXTURE)
    ts = tdata.read_ndjson_scenes(FIXTURE)
    assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(js, ts))


def test_ndjson_writer_round_trip(tmp_path, scenes):
    """write_ndjson_all_cues → read_ndjson_scenes_all_cues gives each
    package's reader the same scenes (the writer rounds to 4 decimals)."""
    sc = tdata.SyntheticScenes(num_people=2, seed=1)
    path = str(tmp_path / "s.ndjson")
    tdata.write_ndjson_all_cues(path, [sc.scene() for _ in range(2)])
    jr = jdata.read_ndjson_scenes_all_cues(path)
    tr = tdata.read_ndjson_scenes_all_cues(path)
    assert len(jr) == len(tr) == 2
    for a, b in zip(jr, tr):
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_locoval_inputs_and_origin(scenes):
    raw = np.random.default_rng(1).standard_normal(
        (3, 21, 2, 49, 4)).astype(np.float32)
    for j3 in (24, 22):
        jp, jv = jdata.extract_locoval_inputs(raw, num_3dpose=j3)
        tp, tv = tdata.extract_locoval_inputs(raw, num_3dpose=j3)
        assert np.array_equal(tp, jp) and np.array_equal(tv, jv)
    traj = raw[:, :12, 0, 0, :2]
    got = tdata.prepend_origin(t_(traj)).numpy()
    assert np.array_equal(got, np.asarray(jdata.prepend_origin(
        jnp.asarray(traj))))


# ---------------------------------------------------------------------------
# TransMotion and the LSTM
# ---------------------------------------------------------------------------

def same_layout(tree, like):
    """`tree` (numpy) has the structure and leaf shapes of `like`."""
    assert jax.tree.structure(tree) == jax.tree.structure(like)
    assert [np.shape(a) for a in jax.tree.leaves(tree)] == \
        [tuple(b.shape) for b in jax.tree.leaves(like)]


@pytest.fixture(scope="module")
def models(scenes):
    """For each stream set: the JAX module and its jitted apply, the flax
    parameters converted from the port's seeded init (in the layout of the
    JAX module's own init), the port module."""
    jb = scenes[0]
    out = {}
    for name, extra in STREAMS.items():
        jm = JTM(JCfg(**SMALL, **extra))
        tm = TransMotion(TransMotionConfig(**SMALL, **extra), device="cpu",
                         generator=torch.Generator().manual_seed(0))
        p = convert.transmotion_params(tm.state_dict(), SMALL["nhead"])
        same_layout(p, jax.eval_shape(
            jm.init, {"params": jax.random.PRNGKey(0)}, jnp.asarray(jb.obs),
            jnp.asarray(jb.padding_mask)))
        out[name] = (jm, jax.jit(jm.apply, static_argnames="train"),
                     jax.tree.map(jnp.asarray, p), tm)
    return out


def _padded(batch):
    """The batch with person 2 of scene 1 absent (padding mask and tokens)."""
    obs = batch.obs.copy()
    mask = batch.padding_mask.copy()
    obs[1, :, 2] = 0.0
    mask[1, 2] = False
    return obs, mask


@pytest.mark.parametrize("limit_obs", [0, 3, 9])
@pytest.mark.parametrize("streams", sorted(STREAMS))
def test_transmotion_eval_forward(models, scenes, streams, limit_obs):
    _, apply, p, tm = models[streams]
    obs, mask = _padded(scenes[0])
    want = np.asarray(apply(p, jnp.asarray(obs), jnp.asarray(mask),
                            limit_obs=limit_obs))
    with torch.no_grad():
        got = tm(t_(obs), t_(mask), limit_obs=limit_obs).numpy()
    assert got.shape == (B, 21, SMALL["nmode"], 2)
    close(got, want, FWD_REL)


@pytest.mark.parametrize("streams", sorted(STREAMS))
def test_transmotion_train_masking_with_jax_draws(models, scenes, streams):
    """Train mode at dropout 0: the port fed JAX's eight uniforms (rebuilt
    from the key flax's make_rng("mask") gives the top-level module, split
    in 8) gives JAX's output; its own draws give another."""
    jm, _, p, tm = models[streams]
    cfg = tm.cfg
    obs, mask = _padded(scenes[0])
    k_mask = jax.random.PRNGKey(7)
    want = np.asarray(jm.apply(p, jnp.asarray(obs), jnp.asarray(mask),
                               train=True, rngs={"mask": k_mask}))
    rng = jm.apply(p, rngs={"mask": k_mask},
                   method=lambda m: m.make_rng("mask"))
    shapes = [tuple(d.shape) for d in mask_draws(
        torch.Generator().manual_seed(0), cfg, B, N)]
    draws = [t_(jax.random.uniform(k, s))
             for k, s in zip(jax.random.split(rng, 8), shapes)]
    with torch.no_grad():
        got = tm(t_(obs), t_(mask), train=True, draws=draws).numpy()
        own = tm(t_(obs), t_(mask), train=True,
                 gen=torch.Generator().manual_seed(1)).numpy()
    close(got, want, FWD_REL)
    assert np.abs(own - want).max() > 1e-3 * np.abs(want).max()


def test_dropout_identity_in_eval_and_scaled_in_train():
    x = torch.arange(1.0, 4097.0).reshape(64, 64)
    assert torch.equal(dropout(x, 0.1, False, None), x)
    y = dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / 0.9)
    assert 0.85 < kept.float().mean().item() < 0.95
    tm = TransMotion(TransMotionConfig(**{**SMALL, "dropout": 0.5}),
                     device="cpu",
                     generator=torch.Generator().manual_seed(0))
    obs = torch.randn((B, 9, N, 49, 4), generator=torch.Generator()
                      .manual_seed(2))
    mask = torch.ones((B, N), dtype=torch.bool)
    with torch.no_grad():
        a, b = tm(obs, mask), tm(obs, mask)
        draws = mask_draws(torch.Generator().manual_seed(3), tm.cfg, B, N)
        c = tm(obs, mask, train=True, draws=draws,
               gen=torch.Generator().manual_seed(4))
        d = tm(obs, mask, train=True, draws=draws,
               gen=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.equal(c, d)
    assert not torch.equal(a, c)


def test_lstm_forward_matches_jax(scenes):
    jb = scenes[0]
    cfg = dict(arch="lstm", nhid=8, nmode=3, output_scale=0.1)
    jm = JLSTM(JCfg(**cfg))
    tm = LSTMPredictor(TransMotionConfig(**cfg), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():      # out_proj starts at zero: move it off
        tm.out_proj.weight.normal_(0.0, 0.3,
                                   generator=torch.Generator().manual_seed(1))
    p = convert.lstm_params(tm.state_dict())
    same_layout(p, jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  jnp.asarray(jb.obs),
                                  jnp.asarray(jb.padding_mask)))
    apply = jax.jit(jm.apply)
    for lim in (0, 4):
        want = np.asarray(apply(p, jnp.asarray(jb.obs),
                                jnp.asarray(jb.padding_mask),
                                limit_obs=lim))
        with torch.no_grad():
            got = tm(t_(jb.obs), t_(jb.padding_mask), limit_obs=lim).numpy()
        assert got.shape == (B, 21, 3, 2)
        close(got, want, FWD_REL)
    sd = convert.lstm_state_dict(p)
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())


@pytest.mark.parametrize("streams", sorted(STREAMS))
def test_transmotion_params_round_trip(models, streams):
    """flax tree (in the JAX init's layout, `models`) → state_dict → flax
    tree is the identity on every leaf."""
    _, _, p, tm = models[streams]
    sd = convert.transmotion_state_dict(np_tree(p))
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    back = convert.transmotion_params(sd, SMALL["nhead"])
    assert jax.tree.structure(back) == jax.tree.structure(np_tree(p))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(back), jax.tree.leaves(np_tree(p))))


def test_port_init_families():
    """The port's own init: zero biases, unit LayerNorm scales, embeddings
    of std ≈ 0.02, lecun-normal kernels of std ≈ 1/√fan_in, from an
    explicit generator (the same seed gives the same weights)."""
    def make(seed):
        return TransMotion(TransMotionConfig(**SMALL), device="cpu",
                           generator=torch.Generator().manual_seed(seed))
    a, b = make(5).state_dict(), make(5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["local.0.ff1.bias"].abs().max()) == 0.0
    assert torch.equal(a["local.0.norm1.weight"], torch.ones(16))
    assert abs(float(a["pe_3dpose"].std()) - 0.02) < 0.003
    w = a["local.0.ff1.weight"]                   # (32, 16): fan_in 16
    assert abs(float(w.std()) - 0.25) < 0.05
