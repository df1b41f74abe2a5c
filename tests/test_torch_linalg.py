"""The port's block-arrow Cholesky factor and resolve.

The plain PyTorch versions are held against the Pallas kernels run as the
JAX package's own tests run them on the CPU (interpret=True), on real
assembled LHS matrices and on a random block-arrow SPD batch. Both do the
same float32 operations in the same column order; XLA may reassociate or
fuse a multiply-add where PyTorch rounds each step, so they agree to
rounding: 1e-5 of the largest magnitude (a few ulps, amplified only by the
system's conditioning, which is below ~1e3 for these matrices).

The CUDA kernels cannot run here; the tests marked requires_cuda hold them
against the plain versions on a card and skip without one. The `*_bit_equal_
to_plain_on_card` tests need neither jax nor the JAX package, so they also
run where jax is not installed, without the test harness's conftest (which
imports jax):

    python -m pytest --noconftest tests/test_torch_linalg.py \
        tests/test_torch_solvers.py -k bit_equal_to_plain_on_card
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from emloco_tpu.kinematics import body_model as jbm
    from emloco_tpu.ops import quat as jq
    from emloco_tpu.physics import EngineConfig as JEngineConfig
    from emloco_tpu.physics import pallas_linalg as PL
    from emloco_tpu.physics import reduced as JR
    from emloco_tpu.physics.terrain import flat_terrain
except ModuleNotFoundError:      # only the card tests can run without jax
    jnp = None
from emloco_tpu_torch.physics import linalg
from emloco_tpu_torch.physics import reduced as TR

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

ARROW = (TR._ARROW_CHUNKS, TR._ARROW_LIMBS, TR._ARROW_S)
RTOL = 1e-5
PATTERN = linalg.arrow_pattern(TR._ARROW_LIMBS, TR._ARROW_S, TR.NU)
OUTSIDE = np.tril(~PATTERN)              # lower, new order, never updated


def assert_rel_close(actual, desired, rtol=RTOL):
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    scale = np.abs(desired).max()
    np.testing.assert_allclose(actual, desired, rtol=0, atol=rtol * scale)


def _jax_lhs_rest_pose(n):
    """A real LHS built as tests/test_engine.py builds it for the Pallas
    exactness check: standing humanoids on flat ground."""
    params = jbm.build_body_params(jnp.zeros((n, 16)))
    model = JR.build_model(params)
    terrain = flat_terrain(extent=20.0, cell=0.1)
    z = params.height_offset[:, None]
    root = jnp.concatenate([jnp.zeros((n, 2)), z], -1)
    st = JR.kinematic_state(model, JR.default_tree(), root,
                            jq.identity_like((n,)),
                            jq.identity_like((n, jbm.NUM_BODIES)))
    (G, W, ground, selfrows, *rest) = JR._contact_and_jacobians(
        model, terrain, st, JEngineConfig())
    table, diag = rest[-1], rest[5]
    return (JR._assemble_lhs_merged(model, G, W, diag, ground, selfrows,
                                    table) + 1e-6 * jnp.eye(JR.NU)[:, :, None])


def _jax_lhs_moving(n):
    """The default √w-Gram LHS of randomly posed, moving humanoids whose
    feet are in and near contact."""
    rng = np.random.RandomState(11)
    params = jbm.build_body_params(jnp.asarray(
        rng.randn(n, 16).astype(np.float32) * 0.5))
    model = JR.build_model(params)
    terrain = flat_terrain(extent=20.0, cell=0.1)
    lr = jq.exp_map_to_quat(jnp.asarray(
        rng.randn(n, 24, 3).astype(np.float32) * 0.2))
    root = jnp.concatenate([jnp.asarray(rng.randn(n, 2) * 0.5, jnp.float32),
                            params.height_offset[:, None] - 0.02], -1)
    st = JR.kinematic_state(
        model, JR.default_tree(), root, lr[:, 0], lr,
        jnp.asarray(rng.randn(n, 3).astype(np.float32)),
        jnp.asarray(rng.randn(n, 3).astype(np.float32)),
        jnp.asarray(rng.randn(n, 23, 3).astype(np.float32)))
    cfg = JEngineConfig()
    (G, W, ground, selfrows, *rest) = JR._contact_and_jacobians(
        model, terrain, st, cfg)
    table, diag = rest[-1], rest[5]
    return (JR._assemble_lhs_merged(model, G, W, diag, ground, selfrows,
                                    table, sqrt_gram=True)
            + 1e-8 * jnp.eye(JR.NU)[:, :, None])


def _random_arrow_spd(n, seed):
    """Pᵀ(L0 L0ᵀ)P with L0 random lower in the block-arrow pattern; env 0's
    first pivot (1e-14) is below the clamp."""
    rng = np.random.RandomState(seed)
    M = TR.NU
    keep = linalg.arrow_pattern(TR._ARROW_LIMBS, TR._ARROW_S, M)
    L0 = 0.1 * rng.randn(M, M, n) * keep[:, :, None]
    L0[np.arange(M), np.arange(M)] = 0.5 + rng.rand(M, n)
    L0[0, 0, 0] = 1e-7
    A_new = np.einsum("ikn,jkn->ijn", L0, L0)
    perm = linalg._plan(*ARROW)[0]
    A = np.empty_like(A_new)
    A[perm[:, None], perm[None, :]] = A_new
    return A.astype(np.float32)


@pytest.fixture(scope="module")
def systems():
    rng = np.random.RandomState(12)
    out = {}
    for name, A in (("rest_pose", _jax_lhs_rest_pose(4)),
                    ("moving", _jax_lhs_moving(4)),
                    ("random_spd", _random_arrow_spd(4, 13))):
        A = np.array(A, np.float32)
        b = rng.randn(TR.NU, A.shape[-1]).astype(np.float32)
        L_pl = PL.cholesky_factor_blocked_t(jnp.asarray(A), *ARROW,
                                            interpret=True)
        x_pl = PL.cholesky_resolve_blocked_t(L_pl, jnp.asarray(b), *ARROW,
                                             interpret=True)
        out[name] = (A, b, np.asarray(L_pl), np.asarray(x_pl))
    return out


@pytest.fixture(scope="module")
def nan_outside(systems):
    """Per case: the Pallas resolve of the Pallas factor with NaN in every
    entry outside the block-arrow pattern (the upper triangle included), at
    the shapes `systems` traced."""
    out = {}
    for name, (_, b, L_pl, _) in systems.items():
        L_nan = np.where(PATTERN[:, :, None], L_pl, np.float32(np.nan))
        out[name] = np.asarray(PL.cholesky_resolve_blocked_t(
            jnp.asarray(L_nan), jnp.asarray(b), *ARROW, interpret=True))
    return out


def test_arrow_blocks_match_jax():
    assert TR._arrow_blocks() == JR._arrow_blocks()
    assert ARROW == (JR._ARROW_CHUNKS, JR._ARROW_LIMBS, JR._ARROW_S)
    assert TR._ARROW_LIMBS == ((0, 12), (12, 24), (24, 30), (30, 45),
                               (45, 60))


@pytest.mark.parametrize("case", ["rest_pose", "moving", "random_spd"])
def test_plain_factor_matches_pallas(systems, case):
    """L in permuted order. The Pallas kernel leaves Schur-complement
    scratch above the diagonal; the port's factor is lower triangular, so
    the upper triangle is compared with zero and the lower with Pallas."""
    A, _, L_pl, _ = systems[case]
    L = linalg.cholesky_factor_blocked_t(torch.as_tensor(A), *ARROW).numpy()
    lower = np.tril(np.ones((TR.NU, TR.NU), bool))[:, :, None]
    assert_rel_close(np.where(lower, L, 0.0), np.where(lower, L_pl, 0.0))
    assert not np.any(np.where(lower, 0.0, L))


@pytest.mark.parametrize("case", ["rest_pose", "moving", "random_spd"])
def test_plain_resolve_matches_pallas(systems, case):
    A, b, _, x_pl = systems[case]
    L = linalg.cholesky_factor_blocked_t(torch.as_tensor(A), *ARROW)
    x = linalg.cholesky_resolve_blocked_t(L, torch.as_tensor(b), *ARROW)
    assert_rel_close(x.numpy(), x_pl)


@pytest.mark.parametrize("case", ["rest_pose", "moving", "random_spd"])
def test_resolve_reads_only_the_pattern(systems, nan_outside, case):
    """NaN in every entry of L outside the block-arrow pattern changes
    neither the plain resolve nor the Pallas one (run on its own factor) by
    a bit: both read only the pattern, the contract the resolve kernel's
    packed gather rests on."""
    A, b, L_pl, x_pl = systems[case]
    L = linalg.cholesky_factor_blocked_t(torch.as_tensor(A), *ARROW)
    L_nan = L.masked_fill(~torch.as_tensor(PATTERN)[:, :, None], np.nan)
    b = torch.as_tensor(b)
    torch.testing.assert_close(
        linalg.cholesky_resolve_blocked_t(L_nan, b, *ARROW),
        linalg.cholesky_resolve_blocked_t(L, b, *ARROW), rtol=0, atol=0)
    np.testing.assert_array_equal(nan_outside[case], x_pl)


def test_plain_solve_is_a_solution():
    """x solves A x = b for the well-posed envs (all but the clamped one)."""
    A = _random_arrow_spd(6, 14)
    b = np.random.RandomState(15).randn(TR.NU, 6).astype(np.float32)
    L = linalg.cholesky_factor_blocked_t(torch.as_tensor(A), *ARROW)
    x = linalg.cholesky_resolve_blocked_t(L, torch.as_tensor(b), *ARROW)
    x = x.numpy().astype(np.float64)
    for e in range(1, 6):
        r = A[:, :, e].astype(np.float64) @ x[:, e] - b[:, e]
        assert np.abs(r).max() < 1e-4 * np.abs(b[:, e]).max()


def test_wrappers_check_their_inputs():
    A = torch.as_tensor(_random_arrow_spd(2, 16))
    with pytest.raises(TypeError):
        linalg.cholesky_factor_blocked_t(A.double(), *ARROW)
    with pytest.raises(ValueError):
        linalg.cholesky_factor_blocked_t(A[:74, :74], *ARROW)
    with pytest.raises(ValueError):
        linalg.cholesky_factor_blocked_t(A.transpose(0, 1), *ARROW)
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    with pytest.raises(ValueError):
        linalg.cholesky_resolve_blocked_t(L, torch.zeros(TR.NU, 3), *ARROW)
    with pytest.raises(TypeError):
        linalg.cholesky_resolve_blocked_t(
            L, torch.zeros(TR.NU, 2, dtype=torch.float64), *ARROW)


def test_cpu_path_launches_no_kernel():
    linalg.reset_launch_counts()
    A = torch.as_tensor(_random_arrow_spd(2, 17))
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    linalg.cholesky_resolve_blocked_t(L, torch.zeros(TR.NU, 2), *ARROW)
    assert linalg.LAUNCHES == dict.fromkeys(linalg.LAUNCHES, 0)
    assert {"cholesky_factor_blocked_t",
            "cholesky_resolve_blocked_t"} <= set(linalg.LAUNCHES)


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["rest_pose", "moving", "random_spd"])
def test_kernels_match_plain_on_card(systems, case, cuda):
    """Same operations in the same order, no multiply-add contraction: the
    kernels reproduce the plain versions bit for bit."""
    A, b, _, _ = systems[case]
    A, b = torch.as_tensor(A, device=cuda), torch.as_tensor(b, device=cuda)
    linalg.reset_launch_counts()
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    x = linalg.cholesky_resolve_blocked_t(L, b, *ARROW)
    torch.cuda.synchronize()
    want = dict.fromkeys(linalg.LAUNCHES, 0)
    want.update(cholesky_factor_blocked_t=1, cholesky_resolve_blocked_t=1)
    assert linalg.LAUNCHES == want
    L_p = linalg.factor_blocked_plain(A, *ARROW)
    torch.testing.assert_close(L, L_p, rtol=0, atol=0)
    torch.testing.assert_close(
        x, linalg.resolve_blocked_plain(L_p, b, *ARROW), rtol=0, atol=0)


# --------------------------------------------------------------------------
# lower entries outside the block-arrow pattern
# --------------------------------------------------------------------------


def _off_pattern(A, seed):
    """A plus symmetric noise on the entries outside the block-arrow pattern
    (new order), in A's old order; the entries inside keep their bits."""
    n = A.shape[-1]
    noise = (0.01 * np.random.RandomState(seed).randn(TR.NU, TR.NU, n)
             * OUTSIDE[:, :, None])
    noise = noise + noise.transpose(1, 0, 2)
    perm = linalg._plan(*ARROW)[0]
    B = np.array(A, np.float64)
    B[perm[:, None], perm[None, :]] += noise
    return B.astype(np.float32)


def _permuted(A):
    perm = linalg._plan(*ARROW)[0]
    return A[perm[:, None], perm[None, :]]


@pytest.mark.parametrize("case", ["rest_pose", "moving", "random_spd"])
def test_factor_passes_entries_outside_the_pattern_through(systems, case):
    """The factor of a matrix that is not zero outside the block-arrow
    pattern, the function the card's kernel is held to bit for bit: L's
    lower entries outside the pattern are the permuted A's (no column step
    updates them, in the Pallas kernel neither), and inside the pattern L
    is the factor of A without them, bit for bit."""
    A = systems[case][0]
    A2 = _off_pattern(A, 18)
    L = linalg.cholesky_factor_blocked_t(torch.as_tensor(A), *ARROW).numpy()
    L2 = linalg.cholesky_factor_blocked_t(torch.as_tensor(A2),
                                          *ARROW).numpy()
    keep, out = PATTERN[:, :, None], OUTSIDE[:, :, None]
    np.testing.assert_array_equal(np.where(keep, L2, 0), np.where(keep, L, 0))
    np.testing.assert_array_equal(np.where(out, L2, 0),
                                  np.where(out, _permuted(A2), 0))
    L2_pl = np.asarray(PL.cholesky_factor_blocked_t(jnp.asarray(A2), *ARROW,
                                                    interpret=True))
    lower = np.tril(np.ones((TR.NU, TR.NU), bool))[:, :, None]
    assert_rel_close(np.where(lower, L2, 0.0), np.where(lower, L2_pl, 0.0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 37, 4093])
@pytest.mark.parametrize("kind", ["clamped_pivot", "nan", "off_pattern"])
def test_factor_kernel_bit_equal_to_plain_on_card(n, kind, cuda):
    """One block or a ragged last block; env 0's first pivot lies below the
    clamp; a NaN on a diagonal passes through as in the plain version;
    entries outside the pattern are copied through untouched."""
    A = _random_arrow_spd(n, 31)
    if kind == "nan":
        A[3, 3, n - 1] = np.nan
    if kind == "off_pattern":
        A = _off_pattern(A, 34)
        want = np.where(OUTSIDE[:, :, None], _permuted(A), 0)
    A = torch.as_tensor(A, device=cuda)
    linalg.reset_launch_counts()
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    torch.cuda.synchronize()
    assert linalg.LAUNCHES["cholesky_factor_blocked_t"] == 1
    torch.testing.assert_close(L, linalg.factor_blocked_plain(A, *ARROW),
                               rtol=0, atol=0, equal_nan=True)
    assert L[0, 0, 0].item() == pytest.approx(1e-6)      # √(1e-12)
    assert L[..., n - 1].isnan().any() == (kind == "nan")
    if kind == "off_pattern":
        np.testing.assert_array_equal(
            np.where(OUTSIDE[:, :, None], L.cpu().numpy(), 0), want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 37, 4093])
@pytest.mark.parametrize("kind", ["clamped_pivot", "nan",
                                  "nan_outside_pattern"])
def test_resolve_kernel_bit_equal_to_plain_on_card(n, kind, cuda):
    """One block or a ragged last block; env 0's first pivot was clamped; a
    NaN on a diagonal of A passes through the factor and the resolve as in
    the plain versions; NaN in L outside the pattern is never read. The
    resolve of the factor is the fused solve, bit for bit."""
    A = _random_arrow_spd(n, 38)
    if kind == "nan":
        A[3, 3, n - 1] = np.nan
    A = torch.as_tensor(A, device=cuda)
    b = torch.as_tensor(np.random.RandomState(39).randn(TR.NU, n)
                        .astype(np.float32), device=cuda)
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    if kind == "nan_outside_pattern":
        L = L.masked_fill(~torch.as_tensor(PATTERN, device=cuda)[:, :, None],
                          np.nan)
    linalg.reset_launch_counts()
    x = linalg.cholesky_resolve_blocked_t(L, b, *ARROW)
    torch.cuda.synchronize()
    want = dict.fromkeys(linalg.LAUNCHES, 0)
    want["cholesky_resolve_blocked_t"] = 1
    assert linalg.LAUNCHES == want
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(
        x, linalg.resolve_blocked_plain(L, b, *ARROW), **exact)
    torch.testing.assert_close(
        x, linalg.cholesky_solve_blocked_t(A, b, *ARROW), **exact)
    assert x[:, n - 1].isnan().any() == (kind == "nan")
