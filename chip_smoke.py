#!/usr/bin/env python3
"""Smoke run of emloco_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its elapsed seconds:
  1. build    — nvcc builds the kernels' library into build/ (plain C
                interface, loaded with ctypes)
  2. card     — the card's name and power limit from nvidia-smi
  3. kernels  — both block-arrow Cholesky kernels against their plain
                PyTorch versions on a real assembled LHS at 4,096 envs and
                on a random block-arrow SPD batch with a clamped and a
                near-singular pivot; kernel, plain and library times
  4. main     — the rollout step at the bench configuration (4,096 envs,
                sensor_res 32, 15 AMP steps, episode length 168): observe →
                normalize → actor → env.step for a few control steps, with
                the kernels' launch counts read around it
  5. reference — one step at 8 envs on the card against the same step on
                the CPU (the port's plain path)
  6. solver_kernels — the fused block-arrow solve, the batch-major resolve,
                the dense Cholesky solve and the env-last relayout against
                their plain versions on the same two inputs at 4,096 envs
                (the relayout also on the (N, 80, 75) staging shape cropped
                to 75); the fused solve against factor + resolve and the
                batch-major resolve against the env-last one, bit for bit
  7. solver_times — those four kernels' times, their plain versions' and a
                PyTorch call's that computes the same function
  8. paths    — each solver configuration of the engine (implicit substeps,
                one substep, dense solver, batch-major TGS, batch-major
                implicit) at the bench configuration: one warm-up and 2
                control steps each, launch counts read around the 2 steps
  9. reference_implicit — one 8-env step on the card against the CPU for
                `tgs_step=False` and for `batch_major_solver=True`
then the kernels' summary line and, last, the device line. Any failed check
raises and the script exits non-zero. Without a CUDA device it exits 2 and
runs nothing.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

T0 = time.time()

NUM_ENVS = 4096
MAIN_STEPS = 4
PATH_STEPS = 2
# the engine's solver configurations beside the default, and the kernels
# each launches per control step (n_substeps = 2 unless stated)
PATHS = (
    ("implicit", dict(tgs_step=False), {"cholesky_solve_blocked_t": 2}),
    ("one_substep", dict(n_substeps=1), {"cholesky_solve_blocked_t": 1}),
    ("implicit_dense", dict(tgs_step=False, blocked_solver=False),
     {"cholesky_solve_soa_t": 2}),
    ("tgs_batch_major", dict(batch_major_solver=True),
     {"to_env_last": 1, "cholesky_factor_blocked_t": 1,
      "cholesky_resolve_blocked": 2}),
    ("implicit_batch_major", dict(tgs_step=False, batch_major_solver=True),
     {"to_env_last": 2, "cholesky_solve_blocked_t": 2}),
)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor-core f32 FLOP/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
# Kernel vs plain version: both do the same float32 operations in the same
# order (the library is built without multiply-add contraction), so they
# should agree to the last bit; 1e-5 of the largest magnitude leaves room for
# a few ulps and nothing more.
KERNEL_RTOL = 1e-5
# Whole step on the card vs on the CPU: matmul sums run in another order, and
# a Jacobian row entry that rounds to the other bfloat16 neighbour moves by
# 2^-8 of its size; one bfloat16 ulp (0.4%) of each quantity's magnitude.
STEP_RTOL = 2.0 ** -8


def emit(phase, **kw):
    print(json.dumps({"phase": phase, "t": round(time.time() - T0, 3), **kw}),
          flush=True)


def rel_err(a, b):
    """(max |a − b|, that over max |b|) — b is the reference."""
    err = (a.double() - b.double()).abs().max().item()
    return err, err / max(b.double().abs().max().item(), 1e-30)


def time_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_arrow_spd(n, arrow, pattern, gen, dev):
    """A = Pᵀ (L0 L0ᵀ) P with L0 random lower in the block-arrow pattern
    (new order), so A is SPD with exact zeros outside the pattern. Env 0's
    first pivot is 1e-14, below the kernel's clamp; env 1 has a pivot that
    cancels to about 1e-6."""
    import torch
    from emloco_tpu_torch.physics import linalg
    chunks, limbs, s_lo = arrow
    perm = torch.as_tensor(linalg._plan(chunks, limbs, s_lo)[0],
                           dtype=torch.long, device=dev)
    M = perm.numel()
    mask = torch.as_tensor(pattern, dtype=torch.float32, device=dev)
    # off-diagonals N(0, 0.1²): a random triangular factor with unit-scale
    # entries is exponentially ill-conditioned in its size
    L0 = (0.1 * torch.randn((M, M, n), generator=gen, device=dev)
          * mask[:, :, None])
    d = torch.arange(M, device=dev)
    L0[d, d] = 0.5 + torch.rand((M, n), generator=gen, device=dev)
    L0[0, 0, 0] = 1e-7
    L0[5, 5, 1] = 1e-3
    A_new = torch.einsum("ikn,jkn->ijn", L0, L0)
    A = torch.empty_like(A_new)
    A[perm[:, None], perm[None, :]] = A_new
    return A.contiguous()


def arrow_work(pattern):
    """Per-env flops of the factor and of one resolve, and the in-pattern
    entries of L, counted on the block-arrow pattern."""
    M = pattern.shape[0]
    offdiag = int(pattern.sum()) - M
    factor = 0
    for k in range(M):
        rows = [i for i in range(k + 1, M) if pattern[i, k]]
        r = len(rows)
        factor += 1 + r + r * (r + 1)          # sqrt, r divides, r(r+1)/2 FMS
    resolve = 2 * (2 * offdiag + M)            # two sweeps
    return factor, resolve, int(pattern.sum())


KERNELS = (   # summary key, kernel, CUDA source, line of the TPU kernel
    ("factor", "cholesky_factor_blocked_t", "block_arrow_cholesky.cu", 303),
    ("resolve", "cholesky_resolve_blocked_t", "block_arrow_cholesky.cu", 334),
    ("solve", "cholesky_solve_blocked_t", "block_arrow_solve.cu", 258),
    ("resolve_bm", "cholesky_resolve_blocked", "block_arrow_solve.cu", 450),
    ("solve_soa", "cholesky_solve_soa_t", "dense_cholesky.cu", 62),
    ("to_env_last", "to_env_last", "to_env_last.cu", 380),
)


def card_vs_cpu(phase, cfg, env, gen, **extra):
    """One step of an 8-env copy of `env` (config `cfg`) on the card and on
    the CPU from the same reset state and actions; fails past STEP_RTOL."""
    import torch
    from emloco_tpu_torch.envs import PedestrianTerrainEnv
    small = dataclasses.replace(cfg, num_envs=8)
    dev, cpu = env.device, torch.device("cpu")
    env_g = PedestrianTerrainEnv(small, env.terrain, env.motion_lib,
                                 device=dev)
    env_c = PedestrianTerrainEnv(small, env.terrain.to(cpu),
                                 env.motion_lib.to(cpu), device=cpu)
    st_g = env_g.reset(torch.Generator(device=dev).manual_seed(3))
    st_c = st_g.to(cpu).replace(rng=torch.Generator().manual_seed(3))
    act = 0.3 * torch.randn((8, small.num_actions), generator=gen,
                            device=dev)
    st_g, out_g = env_g.step(st_g, act)
    st_c, out_c = env_c.step(st_c, act.cpu())
    keep = ~(out_g.done.cpu() | out_c.done)
    checks = {}
    for name, a, c in (("u", st_g.physics.u, st_c.physics.u),
                       ("body_x", st_g.physics.body_x, st_c.physics.body_x),
                       ("obs", out_g.obs, out_c.obs),
                       ("reward", out_g.reward, out_c.reward)):
        checks[name] = rel_err(a.cpu()[keep], c[keep])[1]
    emit(phase, **extra, envs_compared=int(keep.sum()), max_rel_err=checks,
         tolerance_rel=STEP_RTOL)
    if int(keep.sum()) == 0 or not max(checks.values()) <= STEP_RTOL:
        raise SystemExit(f"card and CPU disagree on one step ({extra}): "
                         f"{checks}")


def solver_kernels(cases, arrow):
    """Kernels 3, 5, 6 and 7 against their plain versions on each case;
    the fused solve against factor + resolve and the batch-major resolve
    against the env-last one, bit for bit. Returns the max abs errors."""
    import torch
    from emloco_tpu_torch.physics import linalg
    errs = dict.fromkeys(("solve", "resolve_bm", "solve_soa", "to_env_last"),
                         0.0)
    for name, (A, b) in cases.items():
        N, M = A.shape[-1], A.shape[0]
        A_bm = A.permute(2, 0, 1).contiguous()
        b_bm = b.T.contiguous()
        # the (N, 80, 75) staging shape, its 5 pad rows NaN: the crop must
        # drop them
        staged = torch.cat([A_bm, torch.full((N, 5, M), float("nan"),
                                             device=A.device)], 1)
        L = linalg.cholesky_factor_blocked_t(A, *arrow)
        x_split = linalg.cholesky_resolve_blocked_t(L, b, *arrow)
        outs = {
            "solve": (linalg.cholesky_solve_blocked_t(A, b, *arrow),
                      linalg.solve_blocked_plain(A, b, *arrow)),
            "resolve_bm": (linalg.cholesky_resolve_blocked(L, b_bm, *arrow),
                           linalg.resolve_blocked_bm_plain(L, b_bm, *arrow)),
            "solve_soa": (linalg.cholesky_solve_soa_t(A, b),
                          linalg.solve_soa_plain(A, b)),
            "to_env_last": (linalg.to_env_last(A_bm),
                            linalg.to_env_last_plain(A_bm)),
            "to_env_last_staged": (linalg.to_env_last(staged, out_rows=M),
                                   linalg.to_env_last_plain(staged, M)),
        }
        torch.cuda.synchronize()
        report, bad = {}, []
        for key, (k, p) in outs.items():
            e, r = rel_err(k, p)
            finite = bool(torch.isfinite(k).all())
            report[key] = dict(max_abs_err=e, max_rel_err=r, finite=finite,
                               bit_equal=bool(torch.equal(k, p)))
            if not (finite and r <= KERNEL_RTOL):
                bad.append(key)
            base = key.replace("_staged", "")
            errs[base] = max(errs[base], e)
        fused = bool(torch.equal(outs["solve"][0], x_split))
        bm = bool(torch.equal(outs["resolve_bm"][0], x_split.T))
        emit("solver_kernels", case=name, num_envs=N,
             tolerance_rel=KERNEL_RTOL, kernels=report,
             fused_equals_factor_then_resolve=fused,
             batch_major_equals_env_last=bm)
        if bad or not (fused and bm):
            raise SystemExit(f"solver kernels disagree on {name}: {bad}, "
                             f"fused = split {fused}, bm = env-last {bm}")
    return errs


def solver_times(A, b, L, arrow):
    """ms of kernels 3, 6, 7 and 5 (20 launches), of their plain versions
    (3 calls) and of a PyTorch call that computes the same function."""
    import torch
    from emloco_tpu_torch.physics import linalg
    A_bm = A.permute(2, 0, 1).contiguous()
    b_bm = b.T.contiguous()
    b3 = b_bm[:, :, None]
    L_bm = torch.linalg.cholesky(A_bm)

    def library_solve():
        return torch.cholesky_solve(b3, torch.linalg.cholesky(A_bm))

    return {
        "solve": dict(
            ms=time_ms(lambda: linalg.cholesky_solve_blocked_t(A, b, *arrow),
                       20),
            plain_ms=time_ms(lambda: linalg.solve_blocked_plain(A, b, *arrow),
                             3),
            library_ms=time_ms(library_solve, 20)),
        "resolve_bm": dict(
            ms=time_ms(lambda: linalg.cholesky_resolve_blocked(L, b_bm,
                                                               *arrow), 20),
            plain_ms=time_ms(
                lambda: linalg.resolve_blocked_bm_plain(L, b_bm, *arrow), 3),
            library_ms=time_ms(lambda: torch.cholesky_solve(b3, L_bm), 20)),
        "solve_soa": dict(
            ms=time_ms(lambda: linalg.cholesky_solve_soa_t(A, b), 20),
            plain_ms=time_ms(lambda: linalg.solve_soa_plain(A, b), 3),
            library_ms=time_ms(library_solve, 20)),
        "to_env_last": dict(
            ms=time_ms(lambda: linalg.to_env_last(A_bm), 20),
            plain_ms=time_ms(lambda: linalg.to_env_last_plain(A_bm), 3),
            library_ms=time_ms(lambda: A_bm.permute(1, 2, 0).contiguous(),
                               20)),
    }


def drive_path(rollout, name, engine, per_step, card):
    """The bench rollout under another engine configuration: one warm-up,
    then PATH_STEPS control steps with the launch counts read around them.
    Fails unless the counts are `per_step` × PATH_STEPS (every other kernel
    0) and everything is finite."""
    import torch
    from emloco_tpu_torch.physics import EngineConfig, linalg
    r = rollout.with_engine(EngineConfig(**engine))
    dev = r.env.device
    state = r.env.reset(torch.Generator(device=dev).manual_seed(0))
    state, _, _, _ = r.control_step(state)             # warm-up
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    finite = True
    for _ in range(PATH_STEPS):
        state, out, o, mu = r.control_step(state)
        finite &= bool(torch.isfinite(o).all() and torch.isfinite(mu).all())
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = dict(linalg.LAUNCHES)
    ph = state.physics
    finite &= all(bool(torch.isfinite(v).all()) for v in (
        ph.u, ph.body_x, ph.body_q, ph.body_v, ph.body_w, ph.contact_force,
        out.obs, out.reward))
    want = dict.fromkeys(launches, 0)
    want.update({k: n * PATH_STEPS for k, n in per_step.items()})
    emit("paths", path=name, engine=engine, steps=PATH_STEPS,
         num_envs=NUM_ENVS, seconds=round(dt, 4),
         env_steps_per_s=NUM_ENVS * PATH_STEPS / dt, card=card,
         launches=launches, finite=finite,
         mean_reward=out.reward.mean().item())
    if launches != want:
        raise SystemExit(f"path {name}: launch counts {launches}, "
                         f"expected {want}")
    if not finite:
        raise SystemExit(f"path {name} produced non-finite values")
    return launches


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device, nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from emloco_tpu_torch import build
    from emloco_tpu_torch.physics import EngineConfig, linalg
    from emloco_tpu_torch.physics import reduced as R
    from emloco_tpu_torch.rollout import build_bench

    dev = torch.device("cuda")
    # the actor's float32 GEMMs in full float32, not TF32 (the physics step
    # sets this for itself)
    torch.backends.cuda.matmul.fp32_precision = "ieee"

    # 1. build --------------------------------------------------------------
    t = time.time()
    lib_path, log = build.build()
    build.load()
    emit("build", seconds=round(time.time() - t, 3),
         library=os.path.relpath(lib_path),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln])

    # 2. card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))

    # the env at the bench configuration (its reset state feeds phase 3)
    t = time.time()
    rollout = build_bench(NUM_ENVS, dev)
    cfg, env = rollout.cfg, rollout.env
    state = env.reset(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    emit("setup", seconds=round(time.time() - t, 3), num_envs=NUM_ENVS,
         obs_dim=cfg.obs_dim)

    # 3. kernels against their plain versions -------------------------------
    arrow = (R._ARROW_CHUNKS, R._ARROW_LIMBS, R._ARROW_S)
    pattern = linalg.arrow_pattern(R._ARROW_LIMBS, R._ARROW_S, R.NU)
    gen = torch.Generator(device=dev).manual_seed(2)
    (G, W, ground, *_rest) = R._contact_and_jacobians(
        env.model, env.terrain, state.physics, cfg.engine)
    diag = _rest[5]
    A_real = (R._assemble_lhs_merged(env.model, G, W, diag, ground)
              + 1e-8 * torch.eye(R.NU, device=dev)[:, :, None]).contiguous()
    cases = {
        "real_lhs": (A_real, torch.randn((R.NU, NUM_ENVS), generator=gen,
                                         device=dev)),
        "random_spd": (random_arrow_spd(NUM_ENVS, arrow, pattern, gen, dev),
                       torch.randn((R.NU, NUM_ENVS), generator=gen,
                                   device=dev)),
    }
    errs = {"factor": 0.0, "resolve": 0.0}
    for name, (A, b) in cases.items():
        L_k = linalg.cholesky_factor_blocked_t(A, *arrow)
        L_p = linalg.factor_blocked_plain(A, *arrow)
        x_k = linalg.cholesky_resolve_blocked_t(L_k, b, *arrow)
        x_p = linalg.resolve_blocked_plain(L_p, b, *arrow)
        torch.cuda.synchronize()
        eL, rL = rel_err(L_k, L_p)
        ex, rx = rel_err(x_k, x_p)
        finite = bool(torch.isfinite(L_k).all() and torch.isfinite(x_k).all())
        emit("kernels", case=name, factor_max_abs_err=eL,
             factor_max_rel_err=rL, resolve_max_abs_err=ex,
             resolve_max_rel_err=rx, tolerance_rel=KERNEL_RTOL,
             factor_bit_equal=bool(torch.equal(L_k, L_p)),
             resolve_bit_equal=bool(torch.equal(x_k, x_p)), finite=finite)
        if not finite or rL > KERNEL_RTOL or rx > KERNEL_RTOL:
            raise SystemExit(f"kernel disagrees with its plain version "
                             f"on {name}: factor {rL:.3g}, resolve {rx:.3g}")
        errs["factor"] = max(errs["factor"], eL)
        errs["resolve"] = max(errs["resolve"], ex)

    A, b = cases["real_lhs"]
    L = linalg.cholesky_factor_blocked_t(A, *arrow)
    A_bm = A.permute(2, 0, 1).contiguous()
    L_bm = torch.linalg.cholesky(A_bm)
    b_bm = b.T.contiguous()[:, :, None]
    times = {
        "factor": dict(
            ms=time_ms(lambda: linalg.cholesky_factor_blocked_t(A, *arrow),
                       20),
            plain_ms=time_ms(lambda: linalg.factor_blocked_plain(A, *arrow),
                             3),
            library_ms=time_ms(lambda: torch.linalg.cholesky(A_bm), 20)),
        "resolve": dict(
            ms=time_ms(lambda: linalg.cholesky_resolve_blocked_t(L, b, *arrow),
                       20),
            plain_ms=time_ms(
                lambda: linalg.resolve_blocked_plain(L, b, *arrow), 3),
            library_ms=time_ms(lambda: torch.cholesky_solve(b_bm, L_bm), 20)),
    }
    f_flops, r_flops, n_pattern = arrow_work(pattern)
    M = R.NU
    # least bytes each function must move: the factor reads A's in-pattern
    # lower triangle and writes the dense L; the resolve reads L's in-pattern
    # lower triangle and b, and writes x
    bounds = {
        "factor": ((n_pattern + M * M) * 4 * NUM_ENVS, f_flops * NUM_ENVS),
        "resolve": ((n_pattern + 2 * M) * 4 * NUM_ENVS, r_flops * NUM_ENVS),
    }
    emit("kernel_times", card=card, **{k: v for k, v in times.items()},
         bytes={k: v[0] for k, v in bounds.items()},
         flops={k: v[1] for k, v in bounds.items()})

    # 4. main path ----------------------------------------------------------
    state, _, _, _ = rollout.control_step(state)   # warm-up
    torch.cuda.synchronize()
    linalg.reset_launch_counts()
    t = time.time()
    finite = True
    for _ in range(MAIN_STEPS):
        state, out, o, mu = rollout.control_step(state)
        finite &= bool(torch.isfinite(o).all() and torch.isfinite(mu).all())
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = dict(linalg.LAUNCHES)
    ph = state.physics
    finite &= all(bool(torch.isfinite(v).all()) for v in (
        ph.u, ph.body_x, ph.body_q, ph.contact_force, out.reward))
    shapes_ok = (tuple(out.obs.shape) == (NUM_ENVS, cfg.obs_dim)
                 and tuple(out.amp_obs.shape)
                 == (NUM_ENVS, cfg.num_amp_obs_steps * cfg.amp_obs_per_step))
    emit("main", steps=MAIN_STEPS, num_envs=NUM_ENVS, seconds=round(dt, 4),
         env_steps_per_s=NUM_ENVS * MAIN_STEPS / dt, card=card,
         launches=launches, finite=finite, shapes_ok=shapes_ok,
         mean_reward=out.reward.mean().item(),
         done_frac=out.done.float().mean().item())
    want = dict.fromkeys(launches, 0)
    want.update({"cholesky_factor_blocked_t": MAIN_STEPS,
                 "cholesky_resolve_blocked_t":
                     MAIN_STEPS * cfg.engine.n_substeps})
    if launches != want:
        raise SystemExit(f"launch counts {launches}, expected {want}")
    if not (finite and shapes_ok):
        raise SystemExit("main path produced non-finite values or wrong "
                         "shapes")

    # 5. reference: one step at 8 envs, card vs CPU -------------------------
    card_vs_cpu("reference", cfg, env, gen)

    # 6. the solver kernels against their plain versions --------------------
    errs.update(solver_kernels(cases, arrow))

    # 7. their times --------------------------------------------------------
    times.update(solver_times(A, b, L, arrow))
    dense = np.tril(np.ones((M, M), bool))
    d_factor, d_resolve, n_dense = arrow_work(dense)
    bounds.update({
        "solve": ((n_pattern + 2 * M) * 4 * NUM_ENVS,
                  (f_flops + r_flops) * NUM_ENVS),
        "resolve_bm": ((n_pattern + 2 * M) * 4 * NUM_ENVS,
                       r_flops * NUM_ENVS),
        "solve_soa": ((n_dense + 2 * M) * 4 * NUM_ENVS,
                      (d_factor + d_resolve) * NUM_ENVS),
        "to_env_last": (2 * M * M * 4 * NUM_ENVS, 0),
    })
    emit("solver_times", card=card,
         **{k: times[k] for k in ("solve", "resolve_bm", "solve_soa",
                                  "to_env_last")},
         bytes={k: v[0] for k, v in bounds.items()},
         flops={k: v[1] for k, v in bounds.items()})

    # 8. the engine's other solver paths ------------------------------------
    by_path = {"main": launches}
    for name, kw, per_step in PATHS:
        by_path[name] = drive_path(rollout, name, kw, per_step, card)

    # 9. reference on the implicit and batch-major paths --------------------
    for kw in (dict(tgs_step=False), dict(batch_major_solver=True)):
        card_vs_cpu("reference_implicit",
                    dataclasses.replace(cfg, engine=EngineConfig(**kw)), env,
                    gen, engine=kw)

    # summary ---------------------------------------------------------------
    kernels = []
    for key, name, source, line in KERNELS:
        nbytes, nflops = bounds[key]
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = nflops / F32_FLOP_S * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"emloco_tpu_torch/csrc/{source}",
            "replaces": f"emloco_tpu/physics/pallas_linalg.py:{line}",
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()
                                 if c[name]},
            "max_abs_err": errs[key], "ms": times[key]["ms"],
            "plain_ms": times[key]["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": times[key]["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
