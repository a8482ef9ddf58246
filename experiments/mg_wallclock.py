"""Multigrid wall-clock benchmark: full solves of D x = b.

    CGNE       CG on D^H D               (the baseline every stack runs;
                                          2 D-applies per iteration)
    MG-FGCR    flexible GCR on D, right-preconditioned by the chiral
               multigrid V-cycle (models.multigrid.mg_preconditioner_d;
               2*smooth_steps + 3 D-applies per iteration)
    HPCG       (--hermitian) pcg on D^H D with the Chebyshev-smoothed
               symmetric two-grid cycle — measured SLOWER than CGNE in
               D-applies at every 4^4 config swept (iter cut 3.4-12.5x
               never beats the 7-19x per-iteration cost; the squared
               spectrum is too dense near zero), kept for the record.

Everything runs as ONE jitted lax.while_loop (no per-iteration
dispatch), multi-RHS (``cols=True``) — the production deployment mode.
Setup (prolongator + coarse LU) is timed separately: it is amortized
over the many solves of an HMC trajectory / analysis campaign.

Measured (CPU, 4^4, c128, mass sweep, K=4 ss=4): MG-FGCR reaches the
CGNE answer with 2.2-2.8x fewer D-applies (mass -1.93..-1.98).  Seconds
on the card: not measured.

Usage:  python experiments/mg_wallclock.py [--cpu] [--lat 8 8 8 8]
            [--mass -0.58] [--ncols 8] [--tol 1e-5] [--smooth 4]
            [--K 4] [--hermitian]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

p = argparse.ArgumentParser()
p.add_argument("--cpu", action="store_true")
p.add_argument("--lat", type=int, nargs=4, default=[8, 8, 8, 8])
p.add_argument("--mass", type=float, default=-0.58)
p.add_argument("--ncols", type=int, default=8)
p.add_argument("--tol", type=float, default=1e-5)
p.add_argument("--smooth", type=int, default=4)
p.add_argument("--restart", type=int, default=8)
p.add_argument("--K", type=int, default=4)
p.add_argument("--setup-iters", type=int, default=8)
p.add_argument("--maxiter", type=int, default=20000)
p.add_argument("--layout", default="aos", choices=["aos", "soa"])
p.add_argument("--hermitian", action="store_true",
               help="also run the Chebyshev-smoothed Hermitian pcg")
p.add_argument("--cheby", type=int, default=4)
args = p.parse_args()

if args.cpu:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
if args.cpu:
    jax.config.update("jax_platforms", "cpu")
from superbblas_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax.numpy as jnp
import numpy as np

from superbblas_tpu import cplx
from superbblas_tpu.models import wilson_operator, apply_wilson
from superbblas_tpu.models.wilson import apply_wilson_dagger
from superbblas_tpu.models.multigrid import (
    _A_normal, build_prolongator, build_prolongator_chiral, coarse_matrix,
    mg_preconditioner_d, symmetric_two_grid_preconditioner)
from superbblas_tpu.solvers import cg, fgcr, pcg

lat = tuple(args.lat)
dt = jnp.complex64 if not args.cpu else jnp.complex128
op = wilson_operator(lat, mass=args.mass, key=3, dtype=dt,
                     layout=args.layout)
if args.layout == "soa":
    # fields stay in the canonical AoS order; _level_apply routes the
    # matvec through the SoA stencil with layout conversion at the
    # boundary, so the WHOLE benchmark (CGNE + MG smoothing/residuals)
    # rides the hot path
    from superbblas_tpu.models.multigrid import _level_apply
    from superbblas_tpu.models.wilson import adjoint_operator

    op_h = adjoint_operator(op)
    D = lambda u: _level_apply(op, u, normal=False)
    Dh = lambda u: _level_apply(op_h, u, normal=False)
else:
    D = lambda u: apply_wilson(op, u)
    Dh = lambda u: apply_wilson_dagger(op, u)
A = lambda u: _A_normal(op, u)
rng = np.random.default_rng(11)
shape = lat + (4, 3, args.ncols)
fdt = jnp.float32 if not args.cpu else jnp.float64
b = cplx.CArray(jnp.asarray(rng.standard_normal(shape), fdt),
                jnp.asarray(rng.standard_normal(shape), fdt))

print(f"lat={lat} mass={args.mass} ncols={args.ncols} tol={args.tol} "
      f"smooth={args.smooth} K={args.K} layout={args.layout} "
      f"platform={jax.devices()[0].platform}", flush=True)

# ---- setup (amortized; timed per stage) ----
t0 = time.perf_counter()
P = build_prolongator_chiral(op, K=args.K, setup_iters=args.setup_iters)
jax.block_until_ready(P.re)
t_prol = time.perf_counter() - t0
t0 = time.perf_counter()
A_c = coarse_matrix(op, P, normal=False)
jax.block_until_ready(A_c.re)
t_gal = time.perf_counter() - t0
t0 = time.perf_counter()
M = mg_preconditioner_d(op, P, A_c=A_c, smooth_steps=args.smooth)
t_lu = time.perf_counter() - t0
t_setup = t_prol + t_gal + t_lu
print(f"setup: {t_setup:.1f}s (chiral prolongator 2K={2 * args.K} "
      f"{t_prol:.1f}s + Galerkin {t_gal:.1f}s + LU {t_lu:.1f}s)",
      flush=True)


def timed(make):
    jitted = jax.jit(make)
    r = jitted(b)                      # compile + first run
    jax.block_until_ready(r[0].re)
    t0 = time.perf_counter()
    r = jitted(b)
    jax.block_until_ready(r[0].re)
    return r, time.perf_counter() - t0


(xc, rsc, itc), t_cgne = timed(
    lambda bb: cg(A, Dh(bb), tol=args.tol, maxiter=args.maxiter, cols=True))
print(f"CGNE     : {int(itc):5d} iters ({2 * int(itc):6d} D) "
      f"{t_cgne:8.2f}s", flush=True)

(xm, rsm, itm), t_mg = timed(
    lambda bb: fgcr(D, bb, M=M, tol=args.tol, maxiter=args.maxiter,
                    restart=args.restart, cols=True))
dmg = int(itm) * (2 * args.smooth + 3)
err = float(jnp.max(jnp.abs(xm.re - xc.re)) + jnp.max(jnp.abs(xm.im - xc.im)))
print(f"MG-FGCR  : {int(itm):5d} iters ({dmg:6d} D) {t_mg:8.2f}s   "
      f"vs CGNE err {err:.2e}", flush=True)

out = {"lat": lat, "mass": args.mass, "ncols": args.ncols,
       "smooth": args.smooth, "K": args.K, "tol": args.tol,
       "cgne_iters": int(itc), "cgne_s": round(t_cgne, 3),
       "mg_iters": int(itm), "mg_s": round(t_mg, 3),
       "setup_s": round(t_setup, 2),
       "setup_prolongator_s": round(t_prol, 2),
       "setup_galerkin_s": round(t_gal, 2), "setup_lu_s": round(t_lu, 2),
       "d_apply_cut": round(2 * int(itc) / max(dmg, 1), 2),
       "wallclock_speedup": round(t_cgne / t_mg, 3)}

if args.hermitian:
    t0 = time.perf_counter()
    Ph = build_prolongator(op, K=args.K, setup_iters=args.setup_iters)
    Ach = coarse_matrix(op, Ph)
    Mh = symmetric_two_grid_preconditioner(op, Ph, Ach,
                                           cheby_degree=args.cheby)
    print(f"hermitian setup: {time.perf_counter() - t0:.1f}s", flush=True)
    (xh, rsh, ith), t_h = timed(
        lambda bb: pcg(A, Mh, Dh(bb), tol=args.tol, maxiter=args.maxiter,
                       cols=True))
    print(f"HPCG d={args.cheby}: {int(ith):5d} iters {t_h:8.2f}s", flush=True)
    out["hpcg_iters"] = int(ith)
    out["hpcg_s"] = round(t_h, 3)

print(json.dumps(out), flush=True)
