"""The port of scripts/gram_kernel_probe.py against the JAX probe: the plain
version of its two kernels (gram_dual, gram_dual_batched) against the Pallas
kernels run in interpret mode, as the JAX package's own tests run Pallas on
the CPU, the wrappers' CPU path and input checks, and the probe's own CPU
run.

Tolerance against Pallas, per entry: both sides sum the same M exact float32
products of two bf16 values, in different orders, each within (M−1)·2⁻²⁴ of
the sum of |products|; at M ≤ 304 the two together stay under
608·2⁻²⁴ < 2⁻¹⁴ of (|Rt|·|R|)_cd. Against a float64 gold one such sum:
2⁻¹⁵, plus one rounding of the diagonal's add. The CUDA kernels sum on the
tensor cores in their own order; the test marked requires_cuda holds them to
2⁻¹³ of the same sum (as chip_smoke.py does) and skips without a card.
It needs neither jax nor the JAX package, so it also runs where jax is not
installed, without the test harness's conftest (which imports jax):

    python -m pytest --noconftest tests/test_torch_gram_probe.py -k on_card

The JAX probe has no package and sets M, C and its size at import; it is
loaded from its file, and its gram_dual reads M from the module, so the
engine-row case sets M to the rows' 256.
"""
import contextlib
import importlib.util
import io
import json
import pathlib
import re

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from emloco_tpu.physics import EngineConfig as JEngineConfig
    from emloco_tpu.physics import reduced as JR
    from test_torch_physics import world  # noqa: F401
except ModuleNotFoundError:      # only the card test can run without jax
    jnp = None
from emloco_tpu_torch.physics import linalg
from emloco_tpu_torch.scripts import gram_kernel_probe as probe

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PROBE = ROOT / "scripts" / "gram_kernel_probe.py"
M, C = probe.M, probe.C


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location("jax_gram_kernel_probe",
                                                  JAX_PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    """A JAX array as a torch tensor of the same dtype (bf16 kept)."""
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.as_tensor(np.array(a))


def _jax_operands(n, seed):
    """(Rt, R, d) as the JAX probe's main makes them, from a numpy seed."""
    rng = np.random.RandomState(seed)
    R = jnp.asarray(rng.randn(n, M, C), jnp.bfloat16)
    w = jnp.asarray(rng.rand(n, M), jnp.bfloat16)
    d = jnp.asarray(rng.rand(n, C), jnp.float32)
    return jnp.swapaxes(w[..., None] * R, 1, 2), R, d, w


def _abs_sum(Rt, R, d):
    """(|Rt|·|R|)_cd in float64, and |d_c|·δ_cd."""
    Rt, R, d = (np.asarray(a, np.float64) for a in (Rt, R, d))
    eye = np.eye(R.shape[-1])
    return (np.einsum("ncm,nmd->ncd", np.abs(Rt), np.abs(R)),
            eye[None] * np.abs(d)[:, :, None])


def _assert_within(got, want, bound):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    worst = (err - bound).max()
    assert worst <= 0, f"max excess {worst:.3g} (max err {err.max():.3g})"


def _hold_to_pallas(jprobe, Rt, R, d, block_envs):
    """Plain version vs both Pallas kernels (2⁻¹⁴) and vs a float64 gold
    (2⁻¹⁵ of the sum plus one rounding of the diagonal's add)."""
    got = linalg.gram_dual_plain(_t(Rt), _t(R), _t(d)).numpy()
    absum, absd = _abs_sum(Rt, R, d)
    for kernel in (jprobe.gram_dual, jprobe.gram_dual_batched):
        want = np.asarray(kernel(Rt, R, d, block_envs=block_envs,
                                 interpret=True))
        assert want.shape == got.shape
        _assert_within(got, want, 2.0 ** -14 * absum)
    Rt64, R64, d64 = (np.asarray(a, np.float64) for a in (Rt, R, d))
    gold = (np.einsum("ncm,nmd->ncd", Rt64, R64)
            + np.eye(R64.shape[-1])[None] * d64[:, :, None])
    _assert_within(got, gold, 2.0 ** -15 * (absum + absd))


def test_plain_gram_dual_matches_pallas(jprobe):
    """(a) The probe's shapes: 16 envs, M = 304, C = 75, blocks of 8."""
    Rt, R, d, _ = _jax_operands(16, seed=1)
    _hold_to_pallas(jprobe, Rt, R, d, block_envs=8)


def test_plain_gram_dual_matches_pallas_on_engine_rows(jprobe, world,
                                                       monkeypatch):
    """(b) The engine's bf16 merged rows of the test world (6 envs,
    M = 256), Rt = (w∘R in bf16)ᵀ, blocks of 3."""
    out = JR._contact_and_jacobians(world["jmodel"], world["jterr"],
                                    world["jstate"],
                                    JEngineConfig(rows_bf16=True))
    R, w = JR._merged_rows(world["jmodel"], out[0], out[1], out[2], None,
                           "capsule")
    assert R.dtype == w.dtype == jnp.bfloat16
    Rt = jnp.swapaxes(w[..., None] * R, 1, 2)
    monkeypatch.setattr(jprobe, "M", R.shape[1])
    _hold_to_pallas(jprobe, Rt, R, out[9].astype(jnp.float32), block_envs=3)


def test_wrappers_run_plain_on_cpu_and_check_inputs():
    """(c) On CPU tensors both wrappers are the plain version and launch
    nothing; bad operands raise, naming the argument."""
    g = torch.Generator().manual_seed(0)
    R = torch.randn((8, 40, C), generator=g).bfloat16()
    Rt = (torch.rand((8, 40), generator=g).bfloat16()[..., None]
          * R).transpose(1, 2).contiguous()
    d = torch.rand((8, C), generator=g)
    want = linalg.gram_dual_plain(Rt, R, d)
    linalg.reset_launch_counts()
    for fn, kw in ((linalg.gram_dual, {}),
                   (linalg.gram_dual, {"block_envs": 4}),
                   (linalg.gram_dual_batched, {}),
                   (linalg.gram_dual_batched, {"block_envs": 2})):
        torch.testing.assert_close(fn(Rt, R, d, **kw), want, rtol=0, atol=0)
    assert set(linalg.LAUNCHES.values()) == {0}
    assert probe.gram_dual is linalg.gram_dual
    wide = torch.zeros((8, 40, 81), dtype=torch.bfloat16)
    bad = [
        (ValueError, "block_envs", (Rt, R, d), {"block_envs": 3}),
        (ValueError, "block_envs", (Rt, R, d), {"block_envs": 0}),
        (ValueError, "at most", (wide.transpose(1, 2).contiguous(), wide,
                                 torch.rand(8, 81)), {}),
        (ValueError, "R must", (Rt, R[:, :39].contiguous(), d), {}),
        (ValueError, "Rt must", (Rt[0], R, d), {}),
        (ValueError, "diag must", (Rt, R, d[:, :74]), {}),
        (ValueError, "R must be contiguous",
         (Rt, R.transpose(1, 2).contiguous().transpose(1, 2), d), {}),
        (TypeError, "Rt must be bfloat16", (Rt.float(), R, d), {}),
        (TypeError, "R must be bfloat16", (Rt, R.float(), d), {}),
        (TypeError, "diag must be float32", (Rt, R, d.double()), {}),
    ]
    for fn in (linalg.gram_dual, linalg.gram_dual_batched):
        for exc, msg, args, kw in bad:
            with pytest.raises(exc, match=msg):
                fn(*args, **kw)
    with pytest.raises(ValueError, match="block_envs"):
        linalg.gram_dual_batched(*(t.repeat(8, 1, 1) for t in (Rt, R)),
                                 d.repeat(8, 1), block_envs=128)


@pytest.mark.parametrize("fn", [linalg.gram_dual, linalg.gram_dual_batched])
def test_wrappers_take_any_block_that_divides_the_envs(fn):
    """(c') Both wrappers take any block_envs in [1, N] that divides N: the
    batched kernel goes through the block in rounds of two envs (one at a
    time for an odd block), so it has no cap of its own (the first design's
    one warp per env capped it at 32); 0, more than N and a non-divisor
    raise."""
    g = torch.Generator().manual_seed(1)
    R = torch.randn((64, 24, 9), generator=g).bfloat16()
    Rt = (torch.rand((64, 24), generator=g).bfloat16()[..., None]
          * R).transpose(1, 2).contiguous()
    d = torch.rand((64, 9), generator=g)
    want = linalg.gram_dual_plain(Rt, R, d)
    linalg.reset_launch_counts()
    for block in (1, 2, 8, 32, 64):
        torch.testing.assert_close(fn(Rt, R, d, block_envs=block), want,
                                   rtol=0, atol=0)
    torch.testing.assert_close(fn(Rt[:63], R[:63], d[:63], block_envs=63),
                               want[:63], rtol=0, atol=0)
    assert set(linalg.LAUNCHES.values()) == {0}
    for block, msg in ((0, r"\[1, 64\]"), (65, r"\[1, 64\]"),
                       (128, r"\[1, 64\]"), (3, "not a multiple"),
                       (48, "not a multiple")):
        with pytest.raises(ValueError, match=msg):
            fn(Rt, R, d, block_envs=block)


def test_probe_check_run_matches_the_jax_probe(jprobe):
    """(d) The CPU check prints the JAX probe's variants in its order, then
    the two error lines; its operands are the JAX probe's bit for bit (no
    double rounding of float64 → bf16) and its kernel_dual output is held
    to the Pallas kernel's as in (a)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = probe.main(["--check", "--device", "cpu"])
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert lines[0]["device"] == "cpu" and lines[0]["num_envs"] == 64
    names = re.findall(r'out\["(\w+)"\]', JAX_PROBE.read_text())
    assert len(names) == 10
    assert [ln["variant"] for ln in lines[1:11]] == names
    assert all(ln["ms"] > 0 for ln in lines[1:11])
    assert [(ln["variant"], sorted(ln)) for ln in lines[11:]] == [
        (n, ["max_abs_err_vs_einsum", "variant"])
        for n in ("kernel_at_b", "kernel_dual")]
    assert list(res["ms"]) == names
    Rt, R, d, w = _jax_operands(64, seed=0)
    ops = res["operands"]
    for name, ja in (("R", R), ("w", w), ("d", d), ("Rt", Rt)):
        assert ops[name].dtype == _t(ja).dtype
        assert torch.equal(ops[name], _t(ja)), name
    want = np.asarray(jprobe.gram_dual(Rt, R, d, interpret=True))
    _assert_within(res["out"]["kernel_dual"].numpy(), want,
                   2.0 ** -14 * _abs_sum(Rt, R, d)[0])
    for name in ("kernel_dual_batched8", "kernel_dual_batched32"):
        assert torch.equal(res["out"][name], res["out"]["kernel_dual"])


# --------------------------------------------------------------------------
# on the card: the kernels against their plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# (n, m, c, offset), against the ring's chunks of 32 rows of R (kKr) and
# 160 columns of Rt (kKa): the probe's M = 304, 9.5 chunks of R (a half
# last one) and 2 of Rt (160 + 144); M = 37 at C = 75 and at C = 1, not a
# multiple of 8 (plain loads for both operands, a zero-filled last k16
# step); C = 17 at M = 40, a chunk of R and a quarter; M = 8 and 16, shorter
# than one chunk of R (8 ends in a partial k16 step); M = 48, one chunk of R
# and a half; M = 304 at C = 80 (every tensor-core warp's 16 rows full) and
# at C = 75 with Rt and R one element past a 16-byte boundary (plain loads);
# M = 64 at C = 1 (one tensor-core warp with one row, bulk copies); N = 8,
# one block of 8 envs, on the engine's M = 256 (8 chunks of R, 2 of Rt)
CARD_CASES = [(64, 304, 75, 0), (32, 37, 75, 0), (8, 40, 17, 0),
              (32, 8, 75, 0), (32, 16, 75, 0), (32, 48, 75, 0),
              (32, 304, 80, 0), (32, 304, 75, 1), (32, 64, 1, 0),
              (32, 37, 1, 0), (8, 256, 75, 0)]


def _unaligned(t, offset):
    """A contiguous copy of t whose data starts `offset` elements into its
    storage (offset 1: 2 bytes past a 16-byte boundary)."""
    if not offset:
        return t.contiguous()
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = flat[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,m,c,offset", CARD_CASES)
def test_gram_dual_kernels_match_plain_on_card(cuda, n, m, c, offset):
    """(e) Both kernels at 1, 8 and 32 (or N) envs a block within 2⁻¹³ of
    the sum of |products| (plus the diagonal's rounding) of the plain
    version, bit-equal to each other at every block size, finite, each
    launch counted; the cases cover the ring's edges (CARD_CASES)."""
    g = torch.Generator().manual_seed(n + m + c + offset)
    R = torch.randn((n, m, c), generator=g).bfloat16()
    w = torch.rand((n, m), generator=g).bfloat16()
    Rt = _unaligned((w[..., None] * R).transpose(1, 2).to(cuda), offset)
    R = _unaligned(R.to(cuda), offset)
    d = torch.rand((n, c), generator=g).to(cuda)
    assert (Rt.data_ptr() % 16 == 0) == (R.data_ptr() % 16 == 0) == (
        offset == 0)
    blocks = sorted({1, min(8, n), min(32, n)})
    linalg.reset_launch_counts()
    dual = linalg.gram_dual(Rt, R, d, block_envs=blocks[-1])
    others = [fn(Rt, R, d, block_envs=b) for b in blocks
              for fn in (linalg.gram_dual, linalg.gram_dual_batched)]
    torch.cuda.synchronize()
    assert linalg.LAUNCHES["gram_dual"] == len(blocks) + 1
    assert linalg.LAUNCHES["gram_dual_batched"] == len(blocks)
    assert bool(torch.isfinite(dual).all())
    for o in others:
        torch.testing.assert_close(o, dual, rtol=0, atol=0)
    plain = linalg.gram_dual_plain(Rt, R, d)
    bound = 2.0 ** -13 * (torch.bmm(Rt.abs().double(), R.abs().double())
                          + torch.diag_embed(d.abs().double()))
    assert bool(((dual.double() - plain.double()).abs() <= bound).all())
