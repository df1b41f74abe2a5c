"""The optimizer step of the agent and the predictors, `fused_adam.clip_adam`.

On the CPU: its plain version is the step as `ClipAdam.update`,
`ClipAdamDecay.update` and `AMPAgent._apply_grads` wrote it before the
kernel (`adam_directions` after optax's clip, times −lr or −lr_t, the
nonfinite guard's selects), bit for bit, at the agent's 29 and TransMotion's
162 leaf shapes at small widths, from a nonzero count and across a step of
the rate's decay; the inputs stay as they were; the guard drops the whole
step; the kernel's launch counter stays 0; the flat outputs' layout.

Marked requires_cuda (no jax needed): the kernel against its plain version
run on the card, float32 and float64: bit-equal where the clip does not
engage; where it does, the plain version's step at a norm within NORM_ULP
ulp of its own (the norm's sum runs in another order), bit for bit; the
guard keeps the old state and count bit for bit; without it a nonfinite
gradient gives what the plain version gives; two runs bit-equal; one fused
step per minibatch of `train_epoch` and per `train_step`.
"""
import dataclasses
import math
import pathlib

import pytest
import torch

from emloco_tpu_torch.learning import AMPSeptValueNet, fused_adam
from emloco_tpu_torch.learning.amp_agent import (AdamState, ClipAdam,
                                                 adam_directions)
from emloco_tpu_torch.prediction.model import TransMotion
from emloco_tpu_torch.prediction.presets import configs
from emloco_tpu_torch.prediction.train import ClipAdamDecay

torch.set_num_threads(1)

WIDTHS = dict(mlp_units=(32, 16), task_units=(16, 8), value_units=(15, 6),
              disc_units=(24, 12))
MAX_NORM, LR = 1.0, 1e-3
DECAY = (2, 0.1)                  # transition_steps, rate: decays at 2, 4
NORM_ULP = 16                     # the norm's sum in another order


def agent_shapes(**kw):
    net = AMPSeptValueNet(69, 30, 20, 50, 40, **WIDTHS, **kw, device="cpu")
    return {k: v.shape for k, v in net.named_parameters()}


def predictor_shapes():
    mcfg, _ = configs("jta")
    net = TransMotion(dataclasses.replace(mcfg, nhid=16, nhead=2, dim_ff=32),
                      device="cpu")
    return {k: v.shape for k, v in net.named_parameters()}


SHAPES = {"agent": agent_shapes, "predictor": predictor_shapes}
# ragged sizes (tails shorter than a 16-byte vector) and an empty leaf
RAGGED = {"a": (3,), "b": (5, 7), "c": (0,), "d": (1,), "e": (4, 9, 3)}


def state(shapes, gen, scale, count=3, dtype=torch.float32, device="cpu"):
    """(grads of global norm about `scale`, params, AdamState at `count`
    with moments as a few earlier steps leave them)."""
    def draw(shape, s=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64) * s
                ).to(device, dtype)

    n = sum(math.prod(s) for s in shapes.values())
    grads = {k: draw(s, scale / math.sqrt(n)) for k, s in shapes.items()}
    params = {k: draw(s) for k, s in shapes.items()}
    mu = {k: draw(s, 1e-2) for k, s in shapes.items()}
    nu = {k: draw(s, 1e-3).abs() for k, s in shapes.items()}
    count = torch.tensor(count, dtype=torch.int32, device=device)
    return grads, params, AdamState(count=count, mu=mu, nu=nu)


def old_step(grads, params, st, rate, guard):
    """The step as the optimizers wrote it before the kernel: optax's clip,
    `adam_directions`, p + u·(−rate), and `_apply_grads`'s selects."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    keep = norm < MAX_NORM
    clipped = {k: torch.where(keep, g, g / norm * MAX_NORM)
               for k, g in grads.items()}
    step = (-rate(st.count) if callable(rate) else -rate)
    new, u = adam_directions(clipped, st)
    p = {k: params[k] + u[k] * step for k in u}
    if not guard:
        return p, new
    finite = torch.stack([torch.isfinite(g).all()
                          for g in grads.values()]).all()

    def sel(a, b):
        return {k: torch.where(finite, a[k], b[k]) for k in b}

    return sel(p, params), AdamState(
        count=torch.where(finite, new.count, st.count),
        mu=sel(new.mu, st.mu), nu=sel(new.nu, st.nu))


def assert_equal(a: dict, b: dict, what=""):
    assert list(a) == list(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("scale", [0.3, 30.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("mode", ["constant", "decay", "guard"])
@pytest.mark.parametrize("net", sorted(SHAPES))
def test_plain_is_the_old_step(net, mode, scale):
    """Four steps from count 3 (the decayed rate steps at count 4) through
    the optimizers' own methods, against the old step."""
    shapes = SHAPES[net]()
    if mode == "decay":
        tx = ClipAdamDecay(MAX_NORM, LR, *DECAY)
        rate = tx.learning_rate
    else:
        tx, rate = ClipAdam(MAX_NORM, LR), LR
    gen = torch.Generator().manual_seed(len(shapes))
    grads, params, st = state(shapes, gen, scale)
    ref_p, ref_st = params, st
    for _ in range(4):
        if mode == "guard":
            params, st, finite = tx.step(grads, st, params, guard=True)
            assert bool(finite)
        else:
            params, st = tx.update(grads, st, params)
        ref_p, ref_st = old_step(grads, ref_p, ref_st, rate, mode == "guard")
        assert_equal(params, ref_p, "params")
        assert_equal(st.mu, ref_st.mu, "mu")
        assert_equal(st.nu, ref_st.nu, "nu")
        assert st.count.dtype == torch.int32
        assert torch.equal(st.count, ref_st.count)
        grads = {k: g.flip(0) if g.dim() else g for k, g in grads.items()}
    assert int(st.count) == 7


def test_inputs_unchanged():
    shapes = SHAPES["predictor"]()
    grads, params, st = state(shapes, torch.Generator().manual_seed(1), 30.0)
    before = [{k: v.clone() for k, v in d.items()}
              for d in (grads, params, st.mu, st.nu)]
    count = st.count.clone()
    p, c, mu, nu, finite = fused_adam.clip_adam(
        grads, params, st.count, st.mu, st.nu, MAX_NORM, LR, DECAY, True)
    for d, b in zip((grads, params, st.mu, st.nu), before):
        assert_equal(d, b)
    assert torch.equal(st.count, count)
    assert bool(finite) and int(c) == int(count) + 1
    assert not any(torch.equal(p[k], params[k]) for k in params)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_guard_drops_the_whole_step(bad):
    """One nonfinite entry in one leaf: under the guard parameters, moments
    and count come back as they were and finite is False; without it the
    step runs on, as the old step did."""
    shapes = SHAPES["agent"]()
    grads, params, st = state(shapes, torch.Generator().manual_seed(2), 0.3)
    k0 = list(grads)[5]
    grads[k0] = grads[k0].clone()
    grads[k0].view(-1)[3] = bad
    p, c, mu, nu, finite = fused_adam.clip_adam(
        grads, params, st.count, st.mu, st.nu, MAX_NORM, LR, guard=True)
    assert not bool(finite)
    assert_equal(p, params)
    assert_equal(mu, st.mu)
    assert_equal(nu, st.nu)
    assert torch.equal(c, st.count)
    p, c, mu, nu, finite = fused_adam.clip_adam(
        grads, params, st.count, st.mu, st.nu, MAX_NORM, LR)
    ref_p, ref_st = old_step(grads, params, st, LR, guard=False)
    assert not bool(finite) and int(c) == 4
    for k in p:
        for a, b in ((p[k], ref_p[k]), (mu[k], ref_st.mu[k]),
                     (nu[k], ref_st.nu[k])):
            assert torch.equal(a.isnan(), b.isnan()), k
            assert torch.equal(a.nan_to_num(), b.nan_to_num()), k
    assert all(bool(v.isnan().all()) for v in p.values()) == (
        bad != bad)


def test_no_launches_on_the_cpu():
    fused_adam.reset_launch_counts()
    shapes = SHAPES["agent"]()
    grads, params, st = state(shapes, torch.Generator().manual_seed(3), 30.0)
    ClipAdam(MAX_NORM, LR).update(grads, st, params)
    ClipAdamDecay(MAX_NORM, LR, *DECAY).step(grads, st, params, guard=True)
    assert fused_adam.LAUNCHES == {"clip_adam": 0}


def test_hidden_bf16_keeps_float32_leaves():
    """The kernel takes one dtype: the bf16 network's leaves stay float32
    (its layers cast their operands), as the default network's do."""
    assert {v.dtype for v in AMPSeptValueNet(
        69, 30, 20, 50, 40, **WIDTHS, hidden_bf16=True,
        device="cpu").parameters()} == {torch.float32}


def test_wrapper_refuses_mixed_dtypes_and_a_zero_transition():
    shapes = SHAPES["agent"]()
    grads, params, st = state(shapes, torch.Generator().manual_seed(4), 0.3)
    k0 = list(grads)[0]
    with pytest.raises(TypeError, match="dtype"):
        fused_adam.clip_adam({**grads, k0: grads[k0].double()}, params,
                             st.count, st.mu, st.nu, MAX_NORM, LR)
    with pytest.raises(ValueError, match="transition_steps"):
        fused_adam.clip_adam(grads, params, st.count, st.mu, st.nu,
                             MAX_NORM, LR, (0, 0.5))


def test_the_parameters_device_chooses_the_path():
    """Leaves off the CPU go to the kernel's path even where the count is on
    the CPU, and that path refuses a count on another device than the
    leaves' (the meta device stands in for the card here)."""
    shapes = SHAPES["agent"]()
    grads, params, st = state(shapes, torch.Generator().manual_seed(5), 0.3)

    def meta(d):
        return {k: v.to("meta") for k, v in d.items()}

    with pytest.raises(ValueError, match="the count too"):
        fused_adam.clip_adam(meta(grads), meta(params), st.count,
                             meta(st.mu), meta(st.nu), MAX_NORM, LR)
    assert fused_adam.LAUNCHES == {"clip_adam": 0}


def test_kernel_path_refuses_more_leaves_than_its_table(monkeypatch):
    monkeypatch.setattr(fused_adam, "_plan", lambda: (4, 512))
    shapes = {k: (3,) for k in "abcde"}
    grads, params, st = state(shapes, torch.Generator().manual_seed(6), 0.3,
                              device="meta")
    with pytest.raises(ValueError, match="at most 4 leaves, got 5"):
        fused_adam.clip_adam(grads, params, st.count, st.mu, st.nu,
                             MAX_NORM, LR)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_flat_layout(dtype):
    """Each leaf's view starts on a 16-byte boundary in a span of the flat
    buffer no other leaf's overlaps, with the leaf's shape, in each of the
    three buffers, under the parameters' names and order."""
    shapes = {**SHAPES["agent"](), **RAGGED, "f": (3,), "g": (5, 7)}
    size = torch.empty((), dtype=dtype).element_size()
    sizes, n_row, offsets, total, stacks, place = fused_adam._layout(
        tuple(torch.Size(s) for s in shapes.values()), size)
    assert sizes == [math.prod(s) for s in shapes.values()]
    assert (n_row == sizes).all() and (offsets * size % 16 == 0).all()
    span = sorted(zip(offsets, offsets + n_row))
    assert all(a[1] <= b[0] for a, b in zip(span, span[1:]))
    assert span[-1][1] <= total
    flat = torch.arange(3 * total, dtype=dtype)
    out = fused_adam._views(flat, list(shapes), total, stacks, place)
    for j, d in enumerate(out):
        assert list(d) == list(shapes)
        for (k, s), o, n in zip(shapes.items(), offsets, sizes):
            assert d[k].shape == torch.Size(s) and d[k].is_contiguous()
            assert torch.equal(d[k].reshape(-1),
                               flat[j * total + o:j * total + o + n])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def norm_ulp(out, grads, params, st, decay, guard):
    """The kernel's step `out` is the plain version's on the gradients
    clipped at a norm within 2 ulp of the norm summed in float64: that
    norm's distance in ulp from the plain version's own float32 or float64
    sum's (None where no such norm gives `out` bit for bit)."""
    dtype = next(iter(grads.values())).dtype
    plain = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    exact = torch.sqrt(sum((g * g).double().sum()
                           for g in grads.values()).to(dtype))
    far = torch.full_like(exact, math.inf)
    cands, up, down = [exact], exact, exact
    for _ in range(2):
        up, down = torch.nextafter(up, far), torch.nextafter(down, -far)
        cands += [up, down]
    for c in cands:
        keep = c < MAX_NORM
        at_c = {k: torch.where(keep, g, g / c * MAX_NORM)
                for k, g in grads.items()}
        ref = fused_adam.clip_adam_plain(at_c, params, st.count, st.mu,
                                         st.nu, math.inf, LR, decay, guard)
        if all(torch.equal(a[k], b[k]) for a, b in
               zip((out[0], out[2], out[3]), (ref[0], ref[2], ref[3]))
               for k in a):
            spacing = torch.nextafter(plain, far) - plain
            return ((c - plain).abs() / spacing).item()
    return None


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["constant", "decay"])
@pytest.mark.parametrize("net", sorted(SHAPES))
def test_kernel_bit_equal_to_plain_on_card(net, mode, dtype):
    """Clip not engaged, counts 0 to 5 (the decayed rate steps at 2 and 4),
    guard on and off: parameters, moments, count and finite bit-equal."""
    dev = card()
    shapes = {**SHAPES[net](), **RAGGED}
    gen = torch.Generator().manual_seed(11)
    for count in range(6):
        for guard in (False, True):
            grads, params, st = state(shapes, gen, 0.3, count, dtype, dev)
            args = (grads, params, st.count, st.mu, st.nu, MAX_NORM, LR,
                    DECAY if mode == "decay" else None, guard)
            k = fused_adam.clip_adam(*args)
            p = fused_adam.clip_adam_plain(*args)
            for a, b in zip((k[0], k[2], k[3]), (p[0], p[2], p[3])):
                assert_equal(a, b, (count, guard))
            assert torch.equal(k[1], p[1]) and torch.equal(k[4], p[4])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_reads_misaligned_and_decayed_leaves_on_card(dtype):
    """Gradients as views 1 element off a 16-byte boundary (the mesh's
    all-reduce hands out such views), and a rate that decays every 25 steps
    at counts 24, 25, 49, 50: bit-equal to plain."""
    dev = card()
    shapes = {**SHAPES["agent"](), **RAGGED}
    gen = torch.Generator().manual_seed(12)
    for count in (24, 25, 49, 50):
        grads, params, st = state(shapes, gen, 0.3, count, dtype, dev)
        n = sum(g.numel() for g in grads.values())
        flat = torch.empty(n + 1, dtype=dtype, device=dev)
        views, i = {}, 1
        for k, g in grads.items():
            views[k] = flat[i:i + g.numel()].view(g.shape)
            views[k].copy_(g)
            i += g.numel()
        args = (views, params, st.count, st.mu, st.nu, MAX_NORM, LR,
                (25, 0.5), True)
        k = fused_adam.clip_adam(*args)
        p = fused_adam.clip_adam_plain(*args)
        for a, b in zip((k[0], k[2], k[3]), (p[0], p[2], p[3])):
            assert_equal(a, b, count)
        assert torch.equal(k[1], p[1])


@pytest.mark.requires_cuda
def test_kernel_reads_strided_leaves_on_card():
    """A conv weight's gradient in channels-last layout (as cuDNN returns
    it), a transposed gradient and a strided first moment: bit-equal to
    plain, and the new leaves in the parameters' row-major layout."""
    dev = card()
    shapes = {"conv": (16, 3, 3, 3), "w": (24, 12), "b": (12,), **RAGGED}
    grads, params, st = state(shapes, torch.Generator().manual_seed(15),
                              0.3, 3, torch.float32, dev)
    grads["conv"] = grads["conv"].to(memory_format=torch.channels_last)
    grads["w"] = grads["w"].t().contiguous().t()
    mu = dict(st.mu, w=torch.empty((12, 24), device=dev).copy_(
        st.mu["w"].t()).t())
    assert not any(t.is_contiguous() for t in (grads["conv"], grads["w"],
                                               mu["w"]))
    args = (grads, params, st.count, mu, st.nu, MAX_NORM, LR, DECAY, True)
    k = fused_adam.clip_adam(*args)
    p = fused_adam.clip_adam_plain(*args)
    for a, b in zip((k[0], k[2], k[3]), (p[0], p[2], p[3])):
        assert_equal(a, b)
        assert all(v.is_contiguous() for v in a.values())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("net", sorted(SHAPES))
def test_kernel_clipped_within_ulp_and_deterministic_on_card(net, dtype):
    """Clip engaged (norm about 30): the kernel's step is the plain
    version's at a norm within NORM_ULP ulp of the plain version's norm,
    bit for bit, and two runs of the kernel are bit-equal."""
    dev = card()
    shapes = {**SHAPES[net](), **RAGGED}
    grads, params, st = state(shapes, torch.Generator().manual_seed(13),
                              30.0, 5, dtype, dev)
    args = (grads, params, st.count, st.mu, st.nu, MAX_NORM, LR, DECAY, True)
    out, again = fused_adam.clip_adam(*args), fused_adam.clip_adam(*args)
    for a, b in zip((out[0], out[2], out[3]), (again[0], again[2],
                                                again[3])):
        assert_equal(a, b, "again")
    assert bool(out[4]) and int(out[1]) == 6
    ulp = norm_ulp(out, grads, params, st, DECAY, True)
    assert ulp is not None and ulp <= NORM_ULP, ulp


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_nonfinite_on_card(dtype, bad):
    """A planted nonfinite gradient: under the guard the old state and
    count bit for bit and finite False; without it what the plain version
    gives, NaN for NaN."""
    dev = card()
    shapes = {**SHAPES["predictor"](), **RAGGED}
    grads, params, st = state(shapes, torch.Generator().manual_seed(14),
                              0.3, 5, dtype, dev)
    k0 = list(grads)[7]
    grads[k0].view(-1)[2] = bad
    p, c, mu, nu, finite = fused_adam.clip_adam(
        grads, params, st.count, st.mu, st.nu, MAX_NORM, LR, DECAY, True)
    assert not bool(finite)
    assert_equal(p, params)
    assert_equal(mu, st.mu)
    assert_equal(nu, st.nu)
    assert torch.equal(c, st.count)
    args = (grads, params, st.count, st.mu, st.nu, MAX_NORM, LR, DECAY,
            False)
    k = fused_adam.clip_adam(*args)
    pl = fused_adam.clip_adam_plain(*args)
    assert torch.equal(k[1], pl[1]) and torch.equal(k[4], pl[4])
    for a, b in zip((k[0], k[2], k[3]), (pl[0], pl[2], pl[3])):
        for key in a:
            assert torch.equal(a[key].isnan(), b[key].isnan()), key
            assert torch.equal(a[key].nan_to_num(), b[key].nan_to_num()), key


@pytest.mark.requires_cuda
def test_kernel_refuses_more_leaves_than_its_table_on_card():
    dev = card()
    cap = fused_adam._plan()[0]
    shapes = {f"w{i}": (3,) for i in range(cap + 1)}
    grads, params, st = state(shapes, torch.Generator().manual_seed(7), 0.3,
                              device=dev)
    with pytest.raises(ValueError, match=f"at most {cap} leaves"):
        fused_adam.clip_adam(grads, params, st.count, st.mu, st.nu,
                             MAX_NORM, LR)
    less = {k: v for k, v in list(grads.items())[:cap]}
    out = fused_adam.clip_adam(less, {k: params[k] for k in less}, st.count,
                               {k: st.mu[k] for k in less},
                               {k: st.nu[k] for k in less}, MAX_NORM, LR)
    assert int(out[1]) == int(st.count) + 1 and bool(out[4])


@pytest.mark.requires_cuda
def test_one_fused_step_per_minibatch_and_train_step_on_card():
    dev = card()
    from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
    from emloco_tpu_torch.kinematics import motion_lib as tml
    from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
    from emloco_tpu_torch.physics import generate_mixed_terrain
    from emloco_tpu_torch.prediction import data as tdata
    from emloco_tpu_torch.prediction.model import TransMotionConfig
    from emloco_tpu_torch.prediction.train import (PredictorTrainer,
                                                   PredictTrainConfig)

    env = PedestrianTerrainEnv(
        EnvConfig(num_envs=4, sensor_res=8, episode_length=48,
                  num_amp_obs_steps=3),
        generate_mixed_terrain(map_length=4.0, num_tiles=2, difficulty=0.5,
                               device=dev),
        tml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                   device=dev), device=dev)
    cfg = AMPConfig(horizon=4, num_minibatches=2, mini_epochs=3,
                    amp_batch_size=8, amp_replay_size=24)
    agent = AMPAgent(env, cfg)
    ts = agent.init(0)
    fused_adam.reset_launch_counts()
    ts, m = agent.train_epoch(ts)
    torch.cuda.synchronize()
    assert fused_adam.LAUNCHES["clip_adam"] == 6
    assert int(ts.opt_state.count) == 6 and float(m["nonfinite_grad"]) == 0

    small = dict(nhid=16, nhead=2, dim_ff=32, nlayers_local=2,
                 nlayers_global=1, nmode=3, dropout=0.0)
    tt = PredictorTrainer(TransMotionConfig(**small),
                          PredictTrainConfig(lr_decay_epochs=2), device=dev)
    pts = tt.init(0)
    scenes = tdata.NdjsonScenes(str(pathlib.Path(__file__).parent / "data"
                                    / "jta_all_cues_fixture.ndjson"),
                                max_people=3, seed=0)
    fused_adam.reset_launch_counts()
    for w in ([0, 1], [2, 3], [1, 2]):
        pts, _ = tt.train_step(pts, *scenes.window_batch(w))
    torch.cuda.synchronize()
    assert fused_adam.LAUNCHES["clip_adam"] == 3
    assert int(pts.opt_state.count) == 3
    assert all(bool(torch.isfinite(v).all()) for v in pts.params.values())
