"""The port's fused block-arrow solve, batch-major resolve, dense Cholesky
solve and env-last relayout, with the compositions built on them.

The plain PyTorch versions are held against the Pallas kernels run as the
JAX package's own tests run them on the CPU (interpret=True), on the real
assembled LHS of standing and of moving humanoids and on a random
block-arrow SPD batch, under tests/test_torch_linalg.py's tolerance: 1e-5 of
the largest magnitude (XLA may sum or fuse in another order than PyTorch,
which rounds each step; a few ulps, amplified only by the conditioning).
The three cases go through each Pallas kernel as one 12-env batch, so each
kernel is traced once. Between the port's own entry points the operations
are the same, so fused vs split and batch-major vs env-last agree bit for
bit, as the JAX kernels do (tests/test_engine.py:836-839).

The CUDA kernels cannot run here; the tests marked requires_cuda hold them
against the plain versions on a card and skip without one (the
`*_bit_equal_to_plain_on_card` ones also run without jax: see
tests/test_torch_linalg.py).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from emloco_tpu.physics import pallas_linalg as PL
except ModuleNotFoundError:      # only the card tests can run without jax
    jnp = None
from emloco_tpu_torch.physics import linalg
from emloco_tpu_torch.physics import reduced as TR
from test_torch_linalg import (ARROW, PATTERN, _jax_lhs_moving,
                               _jax_lhs_rest_pose, _off_pattern,
                               _random_arrow_spd, assert_rel_close)

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

CASES = ("rest_pose", "moving", "random_spd")
E = 4                                   # envs per case
M = TR.NU
# relayout inputs (N, X, Y) and out_rows: the solver's (N, 75, 75); the
# (N, 80, 75) staging shape a Gram producer hands over, cropped to 75; a
# crop to fewer rows inside the Pallas kernel's last 16-row block
RELAYOUTS = {"square": (75, None), "staged": (80, 75), "cropped": (75, 70)}


def _cases(out, name):
    """Slice the env axis of a 12-env batch back to one case."""
    k = CASES.index(name)
    return out[..., k * E:(k + 1) * E]


@pytest.fixture(scope="module")
def pallas():
    """Each Pallas kernel in interpret mode, once, on the three cases side
    by side: A (75, 75, 12), b (75, 12) and their outputs."""
    rng = np.random.RandomState(21)
    A = np.concatenate([np.array(f, np.float32) for f in (
        _jax_lhs_rest_pose(E), _jax_lhs_moving(E),
        _random_arrow_spd(E, 22))], axis=-1)
    b = rng.randn(M, 3 * E).astype(np.float32)
    L = linalg.factor_blocked_plain(torch.as_tensor(A), *ARROW).numpy()
    out = dict(A=A, b=b, L=L)
    out["x_fused"] = np.asarray(PL.cholesky_solve_blocked_t(
        jnp.asarray(A), jnp.asarray(b), *ARROW, interpret=True))
    # A with noise on its entries outside the block-arrow pattern
    out["A_off"] = _off_pattern(A, 28)
    out["x_fused_off"] = np.asarray(PL.cholesky_solve_blocked_t(
        jnp.asarray(out["A_off"]), jnp.asarray(b), *ARROW, interpret=True))
    out["x_soa"] = np.asarray(PL.cholesky_solve_soa_t(
        jnp.asarray(A), jnp.asarray(b), interpret=True))
    # the batch-major resolve takes the port's factor: the Pallas kernel
    # reads only its lower triangle, which is where the two factors agree
    out["x_bm"] = np.asarray(PL.cholesky_resolve_blocked(
        jnp.asarray(L), jnp.asarray(b.T), *ARROW, interpret=True))
    relay = {}
    for name, (X, rows) in RELAYOUTS.items():
        R = rng.randn(3 * E, X, M).astype(np.float32)
        relay[name] = (R, rows, np.asarray(PL.to_env_last(
            jnp.asarray(R), out_rows=rows, interpret=True)))
    out["relayout"] = relay
    return out


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", CASES)
def test_plain_fused_solve_matches_pallas(pallas, case):
    A, b = _cases(pallas["A"], case), _cases(pallas["b"], case)
    x = linalg.cholesky_solve_blocked_t(_t(A), _t(b), *ARROW)
    assert_rel_close(x.numpy(), _cases(pallas["x_fused"], case))


@pytest.mark.parametrize("case", CASES)
def test_fused_solve_reads_only_the_pattern(pallas, case):
    """A's entries outside the block-arrow pattern change neither the plain
    fused solve nor the Pallas one by a bit: both read only the pattern, the
    contract the fused kernel's packed gather rests on."""
    A, b = _cases(pallas["A"], case), _t(_cases(pallas["b"], case))
    A_off = _cases(pallas["A_off"], case)
    assert not np.array_equal(A_off, A)
    torch.testing.assert_close(
        linalg.cholesky_solve_blocked_t(_t(A_off), b, *ARROW),
        linalg.cholesky_solve_blocked_t(_t(A), b, *ARROW), rtol=0, atol=0)
    np.testing.assert_array_equal(_cases(pallas["x_fused_off"], case),
                                  _cases(pallas["x_fused"], case))


@pytest.mark.parametrize("case", CASES)
def test_plain_batch_major_resolve_matches_pallas(pallas, case):
    L, b = _cases(pallas["L"], case), _cases(pallas["b"], case)
    x = linalg.cholesky_resolve_blocked(_t(L), _t(b.T), *ARROW)
    assert x.shape == (E, M)
    assert_rel_close(x.numpy(), _cases(pallas["x_bm"].T, case).T)


@pytest.mark.parametrize("case", CASES)
def test_plain_dense_solve_matches_pallas(pallas, case):
    A, b = _cases(pallas["A"], case), _cases(pallas["b"], case)
    x = linalg.cholesky_solve_soa_t(_t(A), _t(b))
    assert_rel_close(x.numpy(), _cases(pallas["x_soa"], case))


@pytest.mark.parametrize("name", list(RELAYOUTS))
def test_plain_to_env_last_matches_pallas(pallas, name):
    R, rows, want = pallas["relayout"][name]
    out = linalg.to_env_last(_t(R), out_rows=rows)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), want)


def test_to_env_last_crops_any_number_of_rows():
    """1 ≤ out_rows ≤ X keeps rows :out_rows. (The Pallas kernel, run in
    interpret mode, returns other rows for a crop that ends before its last
    16-row block, e.g. 75 → 40, where its clipped output blocks overwrite
    valid ones; no caller crops that far. The port follows the definition.)"""
    R = torch.randn((3, 75, M), generator=torch.Generator().manual_seed(27))
    for rows in (1, 8, 40, 64, 75):
        out = linalg.to_env_last(R, out_rows=rows)
        assert out.shape == (rows, M, 3)
        torch.testing.assert_close(out, R[:, :rows].permute(1, 2, 0),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_fused_solve_equals_factor_then_resolve(pallas, case):
    A, b = _t(_cases(pallas["A"], case)), _t(_cases(pallas["b"], case))
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    torch.testing.assert_close(
        linalg.cholesky_solve_blocked_t(A, b, *ARROW),
        linalg.cholesky_resolve_blocked_t(L, b, *ARROW), rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_batch_major_equals_env_last(pallas, case):
    """The batch-major entry points and compositions return the env-last
    solutions, transposed, to the bit."""
    A, b = _t(_cases(pallas["A"], case)), _t(_cases(pallas["b"], case))
    A_bm, b_bm = A.permute(2, 0, 1).contiguous(), b.T.contiguous()
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    x = linalg.cholesky_resolve_blocked_t(L, b, *ARROW)
    L_bm = linalg.cholesky_factor_blocked(A_bm, *ARROW)
    torch.testing.assert_close(L_bm, L, rtol=0, atol=0)
    torch.testing.assert_close(
        linalg.cholesky_resolve_blocked(L_bm, b_bm, *ARROW), x.T,
        rtol=0, atol=0)
    torch.testing.assert_close(
        linalg.cholesky_solve_blocked(A_bm, b_bm, *ARROW), x.T,
        rtol=0, atol=0)
    torch.testing.assert_close(
        linalg.cholesky_solve_soa(A_bm, b_bm),
        linalg.cholesky_solve_soa_t(A, b).T, rtol=0, atol=0)


@pytest.mark.parametrize("case", CASES)
def test_compositions_match_pallas(pallas, case):
    """cholesky_solve_blocked and cholesky_solve_soa, batch-major in and
    out, against the env-last Pallas kernels they compose."""
    A, b = _t(_cases(pallas["A"], case)), _t(_cases(pallas["b"], case))
    A_bm, b_bm = A.permute(2, 0, 1).contiguous(), b.T.contiguous()
    assert_rel_close(linalg.cholesky_solve_blocked(A_bm, b_bm, *ARROW),
                     _cases(pallas["x_fused"], case).T)
    assert_rel_close(linalg.cholesky_solve_soa(A_bm, b_bm),
                     _cases(pallas["x_soa"], case).T)


def test_dense_solve_is_a_solution():
    """x solves A x = b for the well-posed envs (all but the clamped one),
    also for a matrix with no block-arrow structure."""
    rng = np.random.RandomState(23)
    X = rng.randn(M, M, 3).astype(np.float32)
    dense = np.einsum("ikn,jkn->ijn", X, X) + 10 * np.eye(M)[:, :, None]
    A = np.concatenate([_random_arrow_spd(4, 24), dense], -1)
    A = A.astype(np.float32)
    b = rng.randn(M, 7).astype(np.float32)
    x = linalg.cholesky_solve_soa_t(_t(A), _t(b)).numpy().astype(np.float64)
    for e in range(1, 7):
        r = A[:, :, e].astype(np.float64) @ x[:, e] - b[:, e]
        assert np.abs(r).max() < 1e-4 * np.abs(b[:, e]).max()


def test_wrappers_check_their_inputs():
    A = _t(_random_arrow_spd(2, 25))
    b = torch.zeros(M, 2)
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    with pytest.raises(TypeError):
        linalg.cholesky_solve_blocked_t(A.double(), b, *ARROW)
    with pytest.raises(ValueError):
        linalg.cholesky_solve_blocked_t(A, torch.zeros(M, 3), *ARROW)
    with pytest.raises(ValueError):
        linalg.cholesky_solve_blocked_t(A[:74, :74], b[:74], *ARROW)
    with pytest.raises(ValueError):
        linalg.cholesky_solve_soa_t(A.transpose(0, 1), b)
    with pytest.raises(ValueError):
        linalg.cholesky_solve_soa_t(A[:, :74], b)
    with pytest.raises(TypeError):
        linalg.cholesky_solve_soa_t(A, b.double())
    with pytest.raises(ValueError):
        linalg.cholesky_resolve_blocked(L, b, *ARROW)        # env-last b
    with pytest.raises(ValueError):
        linalg.cholesky_resolve_blocked(L, torch.zeros(M, 2).T, *ARROW)
    R = torch.zeros(2, 80, M)
    for rows in (0, 81):
        with pytest.raises(ValueError):
            linalg.to_env_last(R, out_rows=rows)
    with pytest.raises(ValueError):
        linalg.to_env_last(R[0])
    with pytest.raises(ValueError):
        linalg.to_env_last(R.transpose(1, 2))
    with pytest.raises(TypeError):
        linalg.to_env_last(R.to(torch.bfloat16))


def test_cpu_path_launches_no_kernel():
    linalg.reset_launch_counts()
    A = _t(_random_arrow_spd(2, 26))
    b = torch.zeros(M, 2)
    A_bm = A.permute(2, 0, 1).contiguous()
    linalg.cholesky_solve_blocked_t(A, b, *ARROW)
    linalg.cholesky_solve_soa_t(A, b)
    L = linalg.cholesky_factor_blocked(A_bm, *ARROW)
    linalg.cholesky_resolve_blocked(L, b.T.contiguous(), *ARROW)
    linalg.cholesky_solve_blocked(A_bm, b.T.contiguous(), *ARROW)
    linalg.cholesky_solve_soa(A_bm, b.T.contiguous())
    assert set(linalg.LAUNCHES.values()) == {0}


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", CASES)
def test_solver_kernels_match_plain_on_card(pallas, case, cuda):
    """Same operations in the same order, no multiply-add contraction: each
    kernel reproduces its plain version bit for bit."""
    A = torch.as_tensor(_cases(pallas["A"], case), device=cuda).contiguous()
    b = torch.as_tensor(_cases(pallas["b"], case), device=cuda).contiguous()
    A_bm, b_bm = A.permute(2, 0, 1).contiguous(), b.T.contiguous()
    linalg.reset_launch_counts()
    x_f = linalg.cholesky_solve_blocked_t(A, b, *ARROW)
    x_d = linalg.cholesky_solve_soa_t(A, b)
    A_t = linalg.to_env_last(A_bm)
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    x_bm = linalg.cholesky_resolve_blocked(L, b_bm, *ARROW)
    torch.cuda.synchronize()
    assert linalg.LAUNCHES == {
        "cholesky_factor_blocked_t": 1, "cholesky_resolve_blocked_t": 0,
        "cholesky_solve_blocked_t": 1, "cholesky_resolve_blocked": 1,
        "cholesky_solve_soa_t": 1, "to_env_last": 1, "gram_diag": 0,
        "gram_dual": 0, "gram_dual_batched": 0}
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(
        x_f, linalg.solve_blocked_plain(A, b, *ARROW), **exact)
    torch.testing.assert_close(x_d, linalg.solve_soa_plain(A, b), **exact)
    torch.testing.assert_close(A_t, A, **exact)
    torch.testing.assert_close(
        x_bm, linalg.resolve_blocked_bm_plain(L, b_bm, *ARROW), **exact)
    torch.testing.assert_close(x_bm, x_f.T, **exact)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", list(RELAYOUTS))
def test_to_env_last_kernel_matches_plain_on_card(pallas, name, cuda):
    R, rows, _ = pallas["relayout"][name]
    R = torch.as_tensor(R, device=cuda)
    torch.testing.assert_close(linalg.to_env_last(R, out_rows=rows),
                               linalg.to_env_last_plain(R, rows),
                               rtol=0, atol=0)


# --------------------------------------------------------------------------
# on the card: the dense solve kernel, bit for bit
# --------------------------------------------------------------------------

def _dense_spd(n, seed):
    """X Xᵀ + 10 I, X standard normal: SPD with every entry nonzero."""
    X = np.random.RandomState(seed).randn(n, M, M)
    A = X @ X.transpose(0, 2, 1) + 10 * np.eye(M)
    return np.ascontiguousarray(A.transpose(1, 2, 0)).astype(np.float32)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 37, 4093])
@pytest.mark.parametrize("kind", ["clamped_pivot", "nan", "dense"])
def test_dense_solve_kernel_bit_equal_to_plain_on_card(n, kind, cuda):
    """One block or a ragged last block; env 0's first pivot lies below the
    clamp; a NaN on a diagonal passes through as in the plain version; a
    dense SPD matrix updates every entry of the triangle."""
    A = _dense_spd(n, 35) if kind == "dense" else _random_arrow_spd(n, 32)
    if kind == "nan":
        A[3, 3, n - 1] = np.nan
    A = torch.as_tensor(A, device=cuda)
    b = torch.as_tensor(np.random.RandomState(33).randn(M, n)
                        .astype(np.float32), device=cuda)
    linalg.reset_launch_counts()
    x = linalg.cholesky_solve_soa_t(A, b)
    torch.cuda.synchronize()
    assert linalg.LAUNCHES["cholesky_solve_soa_t"] == 1
    torch.testing.assert_close(x, linalg.solve_soa_plain(A, b), rtol=0,
                               atol=0, equal_nan=True)
    assert x[:, n - 1].isnan().any() == (kind == "nan")


# --------------------------------------------------------------------------
# on the card: the fused solve kernel, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 37, 4093])
@pytest.mark.parametrize("kind", ["clamped_pivot", "nan", "off_pattern"])
def test_fused_solve_kernel_bit_equal_to_plain_on_card(n, kind, cuda):
    """One block or a ragged last block; env 0's first pivot lies below the
    clamp; a NaN on a diagonal passes through as in the plain version;
    entries outside the pattern are never read. The fused solve is the
    factor then the resolve, bit for bit."""
    A = _random_arrow_spd(n, 36)
    if kind == "nan":
        A[3, 3, n - 1] = np.nan
    if kind == "off_pattern":
        A = _off_pattern(A, 37)
    A = torch.as_tensor(A, device=cuda)
    b = torch.as_tensor(np.random.RandomState(40).randn(M, n)
                        .astype(np.float32), device=cuda)
    linalg.reset_launch_counts()
    x = linalg.cholesky_solve_blocked_t(A, b, *ARROW)
    torch.cuda.synchronize()
    want = dict.fromkeys(linalg.LAUNCHES, 0)
    want["cholesky_solve_blocked_t"] = 1
    assert linalg.LAUNCHES == want
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(
        x, linalg.solve_blocked_plain(A, b, *ARROW), **exact)
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    torch.testing.assert_close(
        x, linalg.cholesky_resolve_blocked_t(L, b, *ARROW), **exact)
    assert x[:, n - 1].isnan().any() == (kind == "nan")


# --------------------------------------------------------------------------
# on the card: the batch-major resolve kernel, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("n", [1, 37, 4093])
@pytest.mark.parametrize("kind", ["clamped_pivot", "nan",
                                  "nan_outside_pattern"])
def test_batch_major_resolve_kernel_bit_equal_to_plain_on_card(n, kind,
                                                               cuda):
    """One block or a ragged last block; env 0's first pivot was clamped; a
    NaN on a diagonal of A passes through the factor and the resolve as in
    the plain versions; NaN in L outside the pattern is never read. The
    batch-major resolve is the env-last one transposed, bit for bit."""
    A = _random_arrow_spd(n, 44)
    if kind == "nan":
        A[3, 3, n - 1] = np.nan
    A = torch.as_tensor(A, device=cuda)
    b = torch.as_tensor(np.random.RandomState(45).randn(n, M)
                        .astype(np.float32), device=cuda)
    L = linalg.cholesky_factor_blocked_t(A, *ARROW)
    if kind == "nan_outside_pattern":
        L = L.masked_fill(~torch.as_tensor(PATTERN, device=cuda)[:, :, None],
                          np.nan)
    linalg.reset_launch_counts()
    x = linalg.cholesky_resolve_blocked(L, b, *ARROW)
    torch.cuda.synchronize()
    want = dict.fromkeys(linalg.LAUNCHES, 0)
    want["cholesky_resolve_blocked"] = 1
    assert linalg.LAUNCHES == want
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(
        x, linalg.resolve_blocked_bm_plain(L, b, *ARROW), **exact)
    torch.testing.assert_close(
        x, linalg.cholesky_resolve_blocked_t(L, b.T.contiguous(), *ARROW).T,
        **exact)
    assert x[n - 1].isnan().any() == (kind == "nan")
