"""The port's two-operand and `gram_kernel` LHS assembly against the JAX
engine's: the merged rows with their weights, the gram_diag kernel's plain
version, and the √w / two-operand guard.

The merged rows are built from the same JAX Jacobians in both packages, so
they agree exactly. The plain gram_diag is held against the Pallas kernel run
as the JAX package's own tests run it on the CPU (interpret=True) within
1e-5 of the largest magnitude, as tests/test_engine.py:925-928 holds the
kernel to the float32 einsum (XLA sums in another order), and against a
float64 gold within 1e-4, as tests/test_engine.py:917 does: w∘R is formed in
float32, where the product of two bf16 values is exact, as the JAX kernel
forms it in interpret mode and as the JAX step's two-operand einsum does
under jit. For bf16 rows that plain output is symmetric to the bit (each
term is an exact product of three bf16 values), the premise of the
kernel's mirror; for float32 rows it is not.

The CUDA kernel cannot run here; the tests marked requires_cuda hold it
against the plain version on a card and skip without one.
`test_gram_diag_kernel_bit_equal_to_plain_on_card` needs neither jax nor
the JAX package, so it also runs where jax is not installed (see
tests/test_torch_linalg.py).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from emloco_tpu.physics import EngineConfig as JEngineConfig
    from emloco_tpu.physics import pallas_linalg as PL
    from emloco_tpu.physics import reduced as JR
    from test_torch_physics import world  # noqa: F401
except ModuleNotFoundError:      # only the card tests can run without jax
    jnp = None
from emloco_tpu_torch.kinematics import body_model as tbm
from emloco_tpu_torch.ops import quat as tq
from emloco_tpu_torch.physics import EngineConfig, flat_terrain, linalg
from emloco_tpu_torch.physics import reduced as TR

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

C = TR.NU
STAGED = C + (-C) % 16                    # to_env_last's staging rows, 80


def _t(a):
    """A JAX array as a torch tensor of the same dtype (bf16 kept)."""
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.as_tensor(np.array(a))


def _jax_rows(world, rows_bf16):
    """The JAX step-start Jacobians, ground rows and diagonal."""
    out = JR._contact_and_jacobians(world["jmodel"], world["jterr"],
                                    world["jstate"],
                                    JEngineConfig(rows_bf16=rows_bf16))
    G, W, ground, diag = out[0], out[1], out[2], out[9]
    return G, W, ground, diag


@pytest.mark.parametrize("rows_bf16", [False, True])
def test_merged_rows_match_jax(world, rows_bf16):
    """Both forms of the merged rows from the same Jacobians: the
    two-operand (R, wv) and the √w rows with unit weights, exactly."""
    G, W, ground, _ = _jax_rows(world, rows_bf16)
    tG, tW = _t(G), _t(W)
    tground = tuple(_t(a) for a in ground)
    jR, jw = JR._merged_rows(world["jmodel"], G, W, ground, None, "capsule")
    tR, tw = TR._merged_rows(world["tmodel"], tG, tW, tground)
    rdt = torch.bfloat16 if rows_bf16 else torch.float32
    assert tR.dtype == tw.dtype == rdt
    assert tR.shape == (6, 72 + 72 + TR.RC + TR.NC, C)     # 256 rows
    np.testing.assert_array_equal(tR.float().numpy(),
                                  np.asarray(jR, np.float32))
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw, np.float32))
    jS, jone = JR._merged_rows(world["jmodel"], G, W, ground, None,
                               "capsule", weight_fn=jnp.sqrt)
    tS, tone = TR._merged_rows(world["tmodel"], tG, tW, tground,
                               weight_fn=torch.sqrt)
    np.testing.assert_array_equal(tS.float().numpy(),
                                  np.asarray(jS, np.float32))
    assert bool((tone == 1).all()) and tone.dtype == rdt


@pytest.fixture(scope="module")
def gram_cases(world):
    """name → ((R, w, d) as JAX arrays, the Pallas kernel's output in
    interpret mode): the real bf16 rows of the world (6 envs, padded to 8
    inside Pallas) and random float32 rows at a non-divisible env count (5
    envs in blocks of 4)."""
    G, W, ground, diag = _jax_rows(world, True)
    R, w = JR._merged_rows(world["jmodel"], G, W, ground, None, "capsule")
    d = diag.astype(jnp.float32)
    rng = np.random.RandomState(1)
    Rr = rng.randn(5, 40, C).astype(np.float32)
    wr = rng.rand(5, 40).astype(np.float32)
    dr = rng.rand(5, C).astype(np.float32)
    return {
        "real_bf16": ((R, w, d), np.asarray(
            PL.gram_diag(R, w, d, block_envs=8, interpret=True))),
        "random_f32": ((jnp.asarray(Rr), jnp.asarray(wr), jnp.asarray(dr)),
                       np.asarray(PL.gram_diag(
                           jnp.asarray(Rr), jnp.asarray(wr), jnp.asarray(dr),
                           block_envs=4, interpret=True))),
    }


@pytest.mark.parametrize("case", ["real_bf16", "random_f32"])
def test_plain_gram_diag_matches_pallas(gram_cases, case):
    args, want = gram_cases[case]
    got = linalg.gram_diag(*map(_t, args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", ["real_bf16", "random_f32"])
def test_plain_gram_diag_matches_f64_gold(gram_cases, case):
    args, _ = gram_cases[case]
    R, w, d = (np.asarray(a, np.float64) for a in args)
    gold = (np.einsum("nmc,nmd->ncd", w[..., None] * R, R)
            + np.eye(C)[None] * d[:, :, None])
    got = linalg.gram_diag(*map(_t, args)).numpy()
    assert np.abs(got - gold).max() < 1e-4


@pytest.mark.parametrize("case", ["real_bf16", "random_f32"])
def test_staged_gram_then_relayout_is_the_env_last_gram(gram_cases, case):
    """The env-last composition of the engine: gram_diag emits the
    relayout's 80-row staging shape (its pad rows NaN in the plain version)
    and to_env_last crops it to 75, exactly the batch-major Gram moved
    env-last."""
    R, w, d = map(_t, gram_cases[case][0])
    A = linalg.gram_diag(R, w, d)
    staged = linalg.gram_diag(R, w, d, out_rows=STAGED)
    assert staged.shape == (R.shape[0], STAGED, C)
    assert bool(torch.isnan(staged[:, C:]).all())
    torch.testing.assert_close(staged[:, :C], A, rtol=0, atol=0)
    At = linalg.to_env_last(staged, out_rows=C)
    torch.testing.assert_close(At, A.permute(1, 2, 0), rtol=0, atol=0)


def _random_rows(n, m, c, dtype, scale, seed):
    """Rows with 70% zero entries at `scale`, signed weights, and a
    diagonal, from numpy, in the row dtype (diag float32)."""
    rng = np.random.RandomState(seed)
    R = scale * rng.randn(n, m, c) * (rng.rand(n, m, c) > 0.7)
    w = rng.randn(n, m)
    d = rng.rand(n, c)
    return (torch.as_tensor(R, dtype=torch.float32).to(dtype),
            torch.as_tensor(w, dtype=torch.float32).to(dtype),
            torch.as_tensor(d, dtype=torch.float32))


@pytest.mark.parametrize("case", ["real_bf16", "scale_1e-3", "scale_1",
                                  "scale_1e3"])
def test_plain_gram_diag_is_bit_symmetric_on_bf16_rows(gram_cases, case):
    """The premise of the kernel's mirror: with bf16 rows every term
    R[m, c] w[m] R[m, d] is exact in float32, so (c, d) and (d, c) sum the
    same terms in the same order and agree to the bit."""
    if case == "real_bf16":
        R, w, d = map(_t, gram_cases[case][0])
    else:
        R, w, d = _random_rows(8, 256, C, torch.bfloat16,
                               float(case.split("_")[1]), 41)
    assert R.dtype == torch.bfloat16
    A = linalg.gram_diag_plain(R, w, d)
    assert bool((A != 0).any())
    assert torch.equal(A, A.transpose(1, 2))


def test_plain_gram_diag_is_not_symmetric_on_float32_rows():
    """Float32 rows round each product rw[m, c]·R[m, d], so the two orders
    of a pair differ: their kernel sums every entry, not a triangle."""
    R, w, d = _random_rows(8, 256, C, torch.float32, 1.0, 42)
    A = linalg.gram_diag_plain(R, w, d)
    asym = (A != A.transpose(1, 2)).sum().item()
    assert asym > 0.1 * C * (C - 1) * 8


def test_gram_diag_checks_its_inputs():
    R = torch.randn(3, 8, C)
    w, d = torch.rand(3, 8), torch.rand(3, C)
    linalg.reset_launch_counts()
    linalg.gram_diag(R, w, d, out_rows=STAGED)
    assert set(linalg.LAUNCHES.values()) == {0}          # plain, no kernel
    bad = [
        (TypeError, (R.double(), w.double(), d)),
        (TypeError, (R.bfloat16(), w, d)),               # w not R's dtype
        (TypeError, (R, w, d.bfloat16())),
        (ValueError, (R[0], w, d)),
        (ValueError, (R, w[:, :7], d)),
        (ValueError, (R, w, d[:, :74])),
        (ValueError, (R.transpose(1, 2).contiguous().transpose(1, 2), w, d)),
        (ValueError, (torch.randn(3, 8, 81), w, torch.rand(3, 81))),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            linalg.gram_diag(*args)
    with pytest.raises(ValueError):
        linalg.gram_diag(R, w, d, out_rows=C - 1)


def test_sqrt_gram_matches_two_operand():
    """Port of the ground-row part of
    tests/test_engine.py::test_sqrt_gram_matches_two_operand on the port
    alone: the √w LHS and the two-operand LHS agree to bf16 rounding (and
    the gram_diag LHS with the two-operand one to float32 rounding), 40-step
    trajectories of standing humanoids agree to the rounding budget, and
    the static guard rejects configurations where wn − wt can go negative."""
    n = 4
    model = TR.build_model(tbm.build_body_params(torch.zeros((n, 16)),
                                                 device="cpu"))
    terrain = flat_terrain(extent=20.0, cell=0.1, device="cpu")
    st0 = TR.kinematic_state(
        model, TR.default_tree(),
        torch.cat([torch.zeros((n, 2)), model.params.height_offset[:, None]],
                  -1),
        tq.identity_like((n,)), tq.identity_like((n, tbm.NUM_BODIES)))
    (G, W, ground, *rest) = TR._contact_and_jacobians(model, terrain, st0,
                                                      EngineConfig())
    diag = rest[5]
    with TR._full_f32_matmul():
        ref = TR._assemble_lhs_merged(model, G, W, diag, ground,
                                      sqrt_gram=False)
        sym = TR._assemble_lhs_merged(model, G, W, diag, ground,
                                      sqrt_gram=True)
        gram = TR._assemble_lhs_merged(model, G, W, diag, ground, gram=True)
    scale = ref.abs().max().item()
    assert (sym - ref).abs().max().item() < 0.01 * scale     # bf16 rounding
    assert (gram - ref).abs().max().item() < 1e-5 * scale    # f32 rounding
    tgt = torch.zeros((n, 23, 3))
    sA, sB = st0, st0
    for _ in range(40):
        sA = TR.step(model, terrain, sA, tgt, EngineConfig(sqrt_gram=False))
        sB = TR.step(model, terrain, sB, tgt, EngineConfig(sqrt_gram=True))
    assert (sA.root_pos - sB.root_pos).abs().max().item() < 1e-3
    assert (sA.u - sB.u).abs().max().item() < 0.05
    # static guard, as in the JAX engine: the default holds strictly; a
    # weaker normal weight falls back to the two-operand form, and so does
    # exact equality (dt·k_n + d_n = 0.25·8000 + 2000 = 4000)
    for kw, ok in ((dict(sqrt_gram=True), True),
                   (dict(sqrt_gram=True, contact_stiffness=1000.0,
                         max_friction_damping=1e5), False),
                   (dict(sqrt_gram=False), False),
                   (dict(control_dt=0.5, contact_stiffness=8000.0,
                         max_friction_damping=4000.0), False)):
        assert TR._sqrt_gram_ok(EngineConfig(**kw)) is ok
        assert JR._sqrt_gram_ok(JEngineConfig(**kw)) is ok


# --------------------------------------------------------------------------
# on the card: the kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["real_bf16", "random_f32"])
def test_gram_diag_kernel_matches_plain_on_card(gram_cases, case, cuda):
    """bf16 rows: exact products, one rounding per sum, so the kernel's
    fused multiply-add gives the plain version's bits; float32 rows: the
    same product and sum roundings (-fmad=false). Rows :75 of the staged
    output likewise; the pad rows are not compared."""
    R, w, d = (_t(a).to(cuda) for a in gram_cases[case][0])
    linalg.reset_launch_counts()
    A = linalg.gram_diag(R, w, d)
    staged = linalg.gram_diag(R, w, d, out_rows=STAGED)
    torch.cuda.synchronize()
    assert linalg.LAUNCHES["gram_diag"] == 2
    plain = linalg.gram_diag_plain(R, w, d)
    torch.testing.assert_close(A, plain, rtol=0, atol=0)
    torch.testing.assert_close(staged[:, :C], plain, rtol=0, atol=0)


# the card test's inputs: kind -> (row dtype, M, C, R 2 bytes off a 16-byte
# boundary); M = 255 and the offset R take the kernel's plain-load path
CARD_KINDS = {"bf16": (torch.bfloat16, 256, C, False),
              "float32": (torch.float32, 256, C, False),
              "bf16_m255": (torch.bfloat16, 255, C, False),
              "bf16_c73": (torch.bfloat16, 256, 73, False),
              "bf16_offset": (torch.bfloat16, 256, C, True)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 37, 4093])
@pytest.mark.parametrize("kind", list(CARD_KINDS))
def test_gram_diag_kernel_bit_equal_to_plain_on_card(n, kind, cuda):
    """One CTA, a ragged last CTA, and a full card; bf16 rows with signed
    weights and zeros (the lower triangle summed and mirrored), float32 rows
    (every entry summed), and shapes the bulk copies cannot take. Batch-major
    and staged output, each one launch, bit-equal to the plain version."""
    dtype, m, c, offset = CARD_KINDS[kind]
    R, w, d = (t.to(cuda) for t in _random_rows(n, m, c, dtype, 1.0, 43))
    if offset:
        buf = torch.empty(R.numel() + 1, dtype=dtype, device=cuda)
        R = buf[1:].view(R.shape).copy_(R)
        assert R.data_ptr() % 16 == 2
    plain = linalg.gram_diag_plain(R, w, d)
    staged_rows = c + (-c) % 16
    linalg.reset_launch_counts()
    A = linalg.gram_diag(R, w, d)
    torch.cuda.synchronize()
    assert linalg.LAUNCHES["gram_diag"] == 1
    staged = linalg.gram_diag(R, w, d, out_rows=staged_rows)
    torch.cuda.synchronize()
    assert linalg.LAUNCHES["gram_diag"] == 2
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(A, plain, **exact)
    torch.testing.assert_close(staged[:, :c], plain, **exact)
