"""Two-grid (aggregation multigrid) preconditioning for lattice operators.

The algebraic-multigrid setup lattice-QCD production stacks run on top of
libraries like the reference (its multigrid consumers coarsen the Dirac
operator onto the `coarse_operator` regime; PRIMME supplies the
near-null vectors):

  1. **near-null setup** — smooth K random vectors with Richardson
     iterations of A = D^H D (damps high modes, leaves the near-kernel);
  2. **aggregation** — block the lattice into 2^4 site aggregates and
     block-orthonormalize the vectors within each aggregate (batched QR)
     to form the prolongator P (fine dof x K per aggregate);
  3. **Galerkin coarse operator** A_c = P^H A P, materialized densely by
     one batched operator apply to all coarse basis columns;
  4. **two-grid cycle** M r = smoother + P A_c^{-1} P^H r, used as a
     preconditioner (error propagation (I - M A) contracts the
     low modes the smoother cannot).

Everything runs on the engine's own primitives: the stencil matvec for
the fine operator, batched contractions for restriction/prolongation,
and the dense layer for the coarse solve.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import cplx
from ..bsr import BSROperator
from ..labels import volume
from .wilson import _inner, apply_wilson, apply_wilson_dagger

__all__ = ["build_prolongator", "coarse_matrix", "coarse_bsr_operator",
           "two_grid_preconditioner", "symmetric_two_grid_preconditioner",
           "two_grid_error_contraction", "chebyshev_smoother",
           "build_hierarchy", "vcycle_preconditioner",
           "build_prolongator_chiral", "mg_preconditioner_d"]


def _blk_shape(op: BSROperator) -> Tuple[int, ...]:
    """Canonical per-site block shape: (KD, BD) for Kronecker operators
    (Wilson: (4, 3)), (BD,) for plain stencils (coarse BSR: (K,))."""
    if op.kron is not None:
        return (volume(op.kd), volume(op.bd))
    return (volume(op.bd),)


def _level_apply(op, x, normal: bool = True):
    """The level's Hermitian PD operator on canonical fields
    [*lat, *blk(, N)] (trailing column axis optional): A = D^H D at the
    fine level (``normal=True``); Galerkin coarse operators are already
    Hermitian PD and are applied directly (``normal=False``).  Scoped
    under the runtime tracker like every public op.

    SoA-layout operators (mode "stencil_soa") run the SoA hot path with
    AoS<->SoA layout conversion at the boundary, so the ENTIRE multigrid
    cycle (smoothing + residuals + setup) rides the hot path when the
    caller builds the operator with layout="soa"."""
    from ..bsr import _apply_stencil
    from ..utils.tracker import track
    from .wilson import adjoint_operator as _adj

    blk = _blk_shape(op)
    squeeze = x.ndim == 4 + len(blk)
    if squeeze:
        x = cplx.cmap(lambda a: a[..., None], x)
    with track("multigrid_apply", sync_on=None):
        if op.mode == "stencil_soa":
            if op.kron is None or len(blk) != 2:
                raise ValueError(
                    "SoA multigrid levels need a Kronecker (spin x "
                    "color) operator")
            from ..bsr import apply_stencil_soa
            from ..ops.stencil_pallas import aos_to_soa, soa_to_aos

            ki, bi = volume(op.ki), volume(op.bi)
            y = apply_stencil_soa(op, aos_to_soa(x, 4))
            if normal:
                y = apply_stencil_soa(_adj(op), y)
            y = soa_to_aos(y, 4, ki, bi)
        else:
            y = _apply_stencil(op, x)
            if normal:
                y = _apply_stencil(_adj(op), y)
    return cplx.cmap(lambda a: a[..., 0], y) if squeeze else y


def _A_normal(op, x):
    """Backward-compatible alias: the fine-level normal operator."""
    return _level_apply(op, x, normal=True)


def _aggregate(x: cplx.CArray, block: Tuple[int, ...], n_blk: int = 2):
    """[*lat, *blk(, N)] -> [*clat, dof(, N)], dof = prod(block)*prod(blk)
    (``n_blk`` = number of per-site block axes)."""
    def ag(v):
        lat = v.shape[:4]
        rest = v.shape[4:]
        c = [d // b for d, b in zip(lat, block)]
        v = v.reshape((c[0], block[0], c[1], block[1], c[2], block[2],
                       c[3], block[3]) + rest)
        v = jnp.moveaxis(v, (1, 3, 5, 7), (4, 5, 6, 7))
        dof = volume(block) * volume(rest[:n_blk])
        return v.reshape(tuple(c) + (dof,) + rest[n_blk:])
    return cplx.cmap(ag, x)


def _unaggregate(x: cplx.CArray, block: Tuple[int, ...], sc=(4, 3)):
    def ua(v):
        c = v.shape[:4]
        rest = v.shape[5:]
        v = v.reshape(c + tuple(block) + tuple(sc) + rest)
        v = jnp.moveaxis(v, (4, 5, 6, 7), (1, 3, 5, 7))
        lat = tuple(ci * b for ci, b in zip(c, block))
        return v.reshape(lat + tuple(sc) + rest)
    return cplx.cmap(ua, x)


def _block_cholqr(agg: cplx.CArray, passes: int = 2) -> cplx.CArray:
    """Batched thin QR of ``[*batch, dof, K]`` split-complex aggregate
    blocks, entirely ON DEVICE (CholeskyQR2): per pass form the K x K
    Gram G = A^H A by two batched GEMMs, Cholesky-factorize G = L L^H
    with a K-unrolled split-complex recurrence (K <= 16 here), and
    forward-substitute A <- A L^{-H}.  Two passes reach orthonormality at
    working precision for the well-conditioned smoothed-random bases the
    multigrid setup produces (cond(A) well under 1/sqrt(eps)); it keeps
    the setup on the device.  Reference analog: the distributed dense
    factorization layer (dense.h:504-569) the reference applies to such
    per-aggregate panels."""
    K = agg.shape[-1]

    def one_pass(q: cplx.CArray) -> cplx.CArray:
        qre, qim = q.re, q.im
        # Gram G[k,l] = sum_d conj(Q[d,k]) Q[d,l]  -> [*batch, K, K]
        gre = (jnp.einsum("...dk,...dl->...kl", qre, qre)
               + jnp.einsum("...dk,...dl->...kl", qim, qim))
        gim = (jnp.einsum("...dk,...dl->...kl", qre, qim)
               - jnp.einsum("...dk,...dl->...kl", qim, qre))
        # split-complex Cholesky G = L L^H, unrolled over the tiny K
        Lre = [[None] * K for _ in range(K)]
        Lim = [[None] * K for _ in range(K)]
        for j in range(K):
            s = gre[..., j, j]
            for k in range(j):
                s = s - (Lre[j][k] * Lre[j][k] + Lim[j][k] * Lim[j][k])
            d = jnp.sqrt(jnp.maximum(s, 1e-30))
            Lre[j][j] = d
            for i in range(j + 1, K):
                sre = gre[..., i, j]
                sim = gim[..., i, j]
                for k in range(j):
                    # subtract L[i,k] * conj(L[j,k])
                    sre = sre - (Lre[i][k] * Lre[j][k]
                                 + Lim[i][k] * Lim[j][k])
                    sim = sim - (Lim[i][k] * Lre[j][k]
                                 - Lre[i][k] * Lim[j][k])
                Lre[i][j] = sre / d
                Lim[i][j] = sim / d
        # forward substitution Q L^H = A:
        #   Q[:,j] = (A[:,j] - sum_{k<j} Q[:,k] conj(L[j,k])) / L[j,j]
        qn_re, qn_im = [], []
        for j in range(K):
            nre, nim = qre[..., j], qim[..., j]
            for k in range(j):
                a = Lre[j][k][..., None]
                b = Lim[j][k][..., None]
                nre = nre - (qn_re[k] * a + qn_im[k] * b)
                nim = nim - (qn_im[k] * a - qn_re[k] * b)
            d = Lre[j][j][..., None]
            qn_re.append(nre / d)
            qn_im.append(nim / d)
        return cplx.CArray(jnp.stack(qn_re, axis=-1),
                           jnp.stack(qn_im, axis=-1))

    q = agg
    for _ in range(passes):
        q = one_pass(q)
    return q


def build_prolongator(op: BSROperator, block=(2, 2, 2, 2), K: int = 4,
                      setup_iters: int = 8, key=0, normal: bool = True):
    """Near-null aggregation prolongator P: CArray [*clat, dof, K] with
    block-orthonormal columns (P^H P = I per aggregate).  Reference
    analog: the multigrid setup its consumers run over bsr_krylov
    applies (bsr.h:2353) with coarse operators in the create_bsr regime
    (bsr.h:2287)."""
    lat = tuple(op.dim_d)
    blk = _blk_shape(op)
    rng = np.random.default_rng(key)
    shape = lat + blk + (K,)
    v = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    # Richardson smoothing of the level operator toward the near-kernel
    def A(x):
        return _level_apply(op, x, normal)

    from ..solvers import power_iteration

    # ONE jitted program for the whole setup stage (power iteration +
    # setup_iters weighted-Richardson steps as a fori_loop + aggregation
    # + device CholeskyQR2): no per-op eager dispatch, and the fori_loop
    # keeps the compiled program one smoother body instead of
    # setup_iters unrolled stencil applies
    def _setup(v):
        lam, _ = power_iteration(A, cplx.cmap(lambda a: a[..., :1], v),
                                 iters=20)
        omega = 0.8 / jnp.maximum(lam, 1e-30)

        def body(_, v):
            av = A(v)
            return cplx.CArray(v.re - omega * av.re, v.im - omega * av.im)

        v = jax.lax.fori_loop(0, setup_iters, body, v)
        return _block_cholqr(_aggregate(v, block, n_blk=len(blk)))

    return jax.jit(_setup)(v)


def _prolong(P: cplx.CArray, c: cplx.CArray, block, sc=(4, 3)):
    """coarse [*clat, K(, N)] -> fine [*lat, *blk(, N)]."""
    x = cplx.cdot_general(
        P, c, dimension_numbers=(((5,), (4,)), ((0, 1, 2, 3), (0, 1, 2, 3))))
    return _unaggregate(x, block, sc)


def _restrict(P: cplx.CArray, x: cplx.CArray, block, n_blk: int = 2):
    """fine -> coarse: P^H x per aggregate."""
    ax = _aggregate(x, block, n_blk=n_blk)       # [*clat, dof(, N)]
    return cplx.cdot_general(
        cplx.conj(P), ax,
        dimension_numbers=(((4,), (4,)), ((0, 1, 2, 3), (0, 1, 2, 3))))


def coarse_matrix(op: BSROperator, P: cplx.CArray, block=(2, 2, 2, 2),
                  normal: bool = True):
    """Galerkin A_c = P^H (D^H D) P as a dense [M, M] split-complex pair
    (M = n_aggregates * K), built from ONE batched operator apply
    (bsr_krylov with the coarse basis as columns, bsr.h:2353)."""
    clat = P.shape[:4]
    K = P.shape[-1]
    M = volume(clat) * K

    blk = _blk_shape(op)
    eye = np.eye(M).reshape(clat + (K, M))
    basis = cplx.CArray(jnp.asarray(eye), jnp.zeros_like(jnp.asarray(eye)))

    # ONE jitted program, no per-op eager dispatch.  The operator rides
    # the closure (value-specialized kernels, CLAUDE.md); the O(vol*M)
    # basis rides as an ARGUMENT (closed-over arrays become HLO
    # constants).
    def _galerkin(P, basis):
        cols = _prolong(P, basis, block, sc=blk)           # [*lat,*blk,M]
        acols = _level_apply(op, cols, normal)
        return _restrict(P, acols, block, n_blk=len(blk))  # [*clat,K,M]

    r = jax.jit(_galerkin)(P, basis)
    return cplx.cmap(lambda a: a.reshape(M, M), r)


def two_grid_preconditioner(op: BSROperator, P: cplx.CArray, A_c: cplx.CArray,
                            block=(2, 2, 2, 2), omega: float = 0.0,
                            normal: bool = True):
    """M r ~ A^{-1} r: coarse correction through the dense coarse solve
    (the dense-layer regime, dense.h:1020-1160), plus an optional
    post-smoothing Richardson step of weight ``omega``."""
    M = A_c.shape[0]
    # factorize the constant coarse matrix ONCE (A_c is Hermitian PD, so
    # its real embedding is SPD): every preconditioner application then
    # costs a triangular solve, not a fresh O(M^3) factorization
    a2 = jnp.block([[A_c.re, -A_c.im], [A_c.im, A_c.re]])
    chol = jax.scipy.linalg.cho_factor(a2)
    clat = P.shape[:4]
    K = P.shape[-1]

    def A(x):
        # honor the level's normal flag: coarse Galerkin operators are
        # already Hermitian PD and must be smoothed DIRECTLY — smoothing
        # A_c^H A_c amplifies high coarse modes (|1 - omega*lambda^2|>1)
        return _level_apply(op, x, normal)

    blk = _blk_shape(op)

    def prec(r):
        rc = _restrict(P, r, block, n_blk=len(blk))
        # optional trailing column axis (multi-RHS): the dense coarse
        # solve batches all N columns through ONE cho_solve — the
        # K=ndir*Nc GEMMs and the triangular solves gain a factor-N
        # arithmetic intensity (the xgemm_batch_strided regime,
        # blas.h:662-812)
        tail = rc.re.shape[5:]
        flat = cplx.cmap(lambda a: a.reshape((M,) + tail), rc)
        sol2 = jax.scipy.linalg.cho_solve(
            chol, jnp.concatenate([flat.re, flat.im], axis=0))
        c = cplx.CArray(sol2[:M].reshape(clat + (K,) + tail),
                        sol2[M:].reshape(clat + (K,) + tail))
        x = _prolong(P, c, block, sc=blk)
        if omega:
            ax = A(x)
            x = cplx.CArray(x.re + omega * (r.re - ax.re),
                            x.im + omega * (r.im - ax.im))
        return x

    return prec


def chebyshev_smoother(A: Callable, lam_max: float, degree: int = 4,
                       theta: float = 30.0):
    """Degree-``degree`` Chebyshev smoother x = p(A) r targeting the band
    [lam_max/theta, lam_max] (the standard d-term recurrence).

    p is a polynomial in A with p > 0 on the band, so cycles built from
    it stay SPD for pcg — unlike a single Richardson step, it damps the
    WHOLE upper band per application, which is what unlocks multigrid on
    near-critical operators (measured on the 4^4 mass=-1.8 demo:
    Richardson V(1,1) pcg ~1.4x over plain CG; Chebyshev d=4 ~6.3x, d=6
    ~8.1x iteration reduction — experiments/mg_chebyshev.py).  Reference
    analog: the polynomial smoothers Chroma-class multigrid stacks run
    over bsr_krylov handles (bsr.h:2353)."""
    lo, hi = lam_max / theta, lam_max
    th = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = th / delta

    # Saad Alg. 12.1 / PETSc seeding: the FIRST direction is x1 = r/theta
    # itself; rho and the residual update stay inside the loop.  (The
    # round-2 review caught a mis-seeded variant whose error polynomial
    # missed the minimax bound — e.g. 0.557 vs the true 0.434 at d=4;
    # this form hits the Chebyshev bound exactly, verified in
    # tests/test_multigrid.py::test_chebyshev_smoother_minimax.)
    def smooth(r):
        rho = 1.0 / sigma
        x = cplx.CArray(r.re / th, r.im / th)
        d = x
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            ax = A(x)
            res = cplx.CArray(r.re - ax.re, r.im - ax.im)
            d = cplx.CArray(
                (rho * rho_new) * d.re + (2.0 * rho_new / delta) * res.re,
                (rho * rho_new) * d.im + (2.0 * rho_new / delta) * res.im)
            x = cplx.CArray(x.re + d.re, x.im + d.im)
            rho = rho_new
        return x

    return smooth


def symmetric_two_grid_preconditioner(op: BSROperator, P: cplx.CArray,
                                      A_c: cplx.CArray, block=(2, 2, 2, 2),
                                      omega: Optional[float] = None,
                                      normal: bool = True,
                                      cheby_degree: Optional[int] = None,
                                      cheby_theta: float = 30.0):
    """Symmetrized V(1,1) two-grid cycle usable as a pcg preconditioner.

    ``two_grid_preconditioner`` is a stationary-iteration operator: with
    omega=0 it is the (singular) pure coarse correction P A_c^{-1} P^H,
    and with omega>0 it post-smooths only, which makes it NON-symmetric —
    both break preconditioned CG (solvers.pcg requires an SPD M).  This
    variant wraps the coarse correction with the SAME smoother S on both
    sides (pre + post), which is symmetric and positive definite:

        x1 = S r;  x2 = x1 + P A_c^{-1} P^H (r - A x1)
        M r = x2 + S (r - A x2)

    The smoother is one Richardson step (weight ``omega``, defaulting to
    0.8 / lambda_max(A) by power iteration) or, with ``cheby_degree``
    set, a degree-d :func:`chebyshev_smoother` on
    [lambda_max/cheby_theta, lambda_max] — the configuration that
    reaches >=5x iteration reduction on the near-critical demo.
    Reference analog: the symmetrized multigrid preconditioners
    Chroma-style stacks run over bsr_krylov handles (bsr.h:2353)."""
    def A(x):
        return _level_apply(op, x, normal)

    lam = None
    if omega is None or cheby_degree is not None:
        from ..solvers import power_iteration

        rng = np.random.default_rng(0)
        shape = tuple(op.dim_d) + _blk_shape(op)
        probe = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                            jnp.asarray(rng.standard_normal(shape)))
        lam, _ = power_iteration(A, probe, iters=30)
        lam = float(lam)
        if omega is None:
            omega = 0.8 / lam

    if cheby_degree is not None:
        S = chebyshev_smoother(A, lam * 1.05, degree=cheby_degree,
                               theta=cheby_theta)
    else:
        def S(r):
            return cplx.CArray(omega * r.re, omega * r.im)

    coarse = two_grid_preconditioner(op, P, A_c, block, omega=0.0,
                                     normal=normal)

    def prec(r):
        x1 = S(r)
        r1 = cplx.CArray(r.re - A(x1).re, r.im - A(x1).im)
        c = coarse(r1)
        x2 = cplx.CArray(x1.re + c.re, x1.im + c.im)
        r2 = cplx.CArray(r.re - A(x2).re, r.im - A(x2).im)
        s2 = S(r2)
        return cplx.CArray(x2.re + s2.re, x2.im + s2.im)

    return prec


def two_grid_error_contraction(op: BSROperator, P, A_c, block=(2, 2, 2, 2),
                               omega: float = 0.0, key: int = 0,
                               normal: bool = True) -> float:
    """||(I - M A) e|| / ||e|| on a random error vector — the two-grid
    convergence factor (< 1 means the cycle contracts; the quality metric
    of the setup in bsr.h:2353-consuming multigrid stacks)."""
    rng = np.random.default_rng(key)
    shape = tuple(op.dim_d) + _blk_shape(op)
    e = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    def A(x):
        return _level_apply(op, x, normal)

    prec = two_grid_preconditioner(op, P, A_c, block, omega, normal=normal)
    corr = prec(A(e))
    e_new = cplx.CArray(e.re - corr.re, e.im - corr.im)
    return float(jnp.sqrt(_inner(e_new, e_new) / _inner(e, e)))


def build_prolongator_chiral(op: BSROperator, block=(2, 2, 2, 2),
                             K: int = 4, setup_iters: int = 8, key=0):
    """Chiral-doubled near-null prolongator for multigrid on the
    UNSQUARED operator D (the production lattice-QCD design: multigrid
    preconditions D directly inside a flexible outer solver — the
    squared D^H D's spectrum is too dense near zero for a fixed-size
    coarse space to pay, measured in experiments/mg_wallclock.py).

    K random vectors are smoothed toward the near-kernel (of D^H D —
    the right-singular space, which is D's near-kernel too), then each
    is SPLIT into its two chiralities before aggregation: gamma5 is
    diagonal (+1, +1, -1, -1) in the DeGrand-Rossi basis
    (wilson.gamma_matrices), so the split just zeroes spin halves.  The
    doubling makes the coarse space gamma5-compatible: P^H gamma5 P is
    again a diagonal +-1, and A_c = P^H D P inherits
    gamma5-Hermiticity — the structure that lets the coarse correction
    act on D's signed low modes instead of washing them out.  Returns
    CArray [*clat, dof, 2K] with block-orthonormal columns (the chiral
    halves have disjoint spin support, so QR never mixes them).
    Reference analog: the multigrid setup consumers run over bsr_krylov
    handles (bsr.h:2353) with coarse operators in the create_bsr regime
    (bsr.h:2287)."""
    lat = tuple(op.dim_d)
    blk = _blk_shape(op)
    if len(blk) != 2 or blk[0] != 4:
        raise ValueError("chiral doubling needs a 4-spinor operator")
    rng = np.random.default_rng(key)
    shape = lat + blk + (K,)
    v = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    def A(x):
        return _level_apply(op, x, normal=True)

    from ..solvers import power_iteration

    # chiral doubling: [..., 4, 3, K] -> [..., 4, 3, 2K] with the upper
    # (spins 0:2) and lower (spins 2:4) halves in separate columns
    def double(a):
        up = a.at[..., 2:, :, :].set(0.0)
        dn = a.at[..., :2, :, :].set(0.0)
        return jnp.concatenate([up, dn], axis=-1)

    # ONE jitted program: smoothing (fori_loop body, not setup_iters
    # unrolled applies) + chiral doubling + aggregation + device
    # CholeskyQR2 — the basis never leaves the device
    def _setup(v):
        lam, _ = power_iteration(A, cplx.cmap(lambda a: a[..., :1], v),
                                 iters=20)
        omega = 0.8 / jnp.maximum(lam, 1e-30)

        def body(_, v):
            av = A(v)
            return cplx.CArray(v.re - omega * av.re, v.im - omega * av.im)

        v = jax.lax.fori_loop(0, setup_iters, body, v)
        w = cplx.cmap(double, v)
        return _block_cholqr(_aggregate(w, block, n_blk=len(blk)))

    return jax.jit(_setup)(v)


def mg_preconditioner_d(op: BSROperator, P: cplx.CArray,
                        A_c: Optional[cplx.CArray] = None,
                        block=(2, 2, 2, 2), smooth_steps: int = 4):
    """V(1,1)-style multigrid cycle on the UNSQUARED operator D, for use
    as the flexible right preconditioner of :func:`solvers.fgcr` —
    the production QCD multigrid shape (outer flexible Krylov + MG on D;
    driven over bsr_krylov-class applies in reference terms, bsr.h:2353).

        x1 = S r;   x2 = x1 + P A_c^{-1} P^H (r - D x1)
        M r = x2 + S (r - D x2)

    The smoother S is ``smooth_steps`` un-restarted GCR steps on D (a
    residual-minimizing polynomial — safe for non-Hermitian D where
    Richardson needs spectral bounds that do not exist).  The coarse
    matrix A_c = P^H D P (gamma5-Hermitian but NOT Hermitian) is solved
    exactly through an LU of its real embedding, factorized once.
    Cost per application: 2 * smooth_steps + 2 fine D-applies + one
    coarse triangular solve.  Columns-batched: a trailing RHS axis rides
    every stage (multi-RHS mode).  Pass ``A_c`` to reuse a
    :func:`coarse_matrix` result (normal=False); built here otherwise.
    """
    from ..solvers import fgcr

    if A_c is None:
        A_c = coarse_matrix(op, P, block, normal=False)
    M = A_c.shape[0]
    # real embedding of the NON-Hermitian coarse matrix: LU, not Cholesky
    a2 = jnp.block([[A_c.re, -A_c.im], [A_c.im, A_c.re]])
    lu = jax.scipy.linalg.lu_factor(a2)
    clat = P.shape[:4]
    K2 = P.shape[-1]
    blk = _blk_shape(op)
    n_blk = len(blk)

    def D(x):
        return _level_apply(op, x, normal=False)

    def prec(r):
        has_cols = r.re.ndim == 4 + n_blk + 1

        def S(t):
            return fgcr(D, t, tol=0.0, maxiter=smooth_steps,
                        restart=smooth_steps, cols=has_cols)[0]

        x1 = S(r)
        dx1 = D(x1)
        r1 = cplx.CArray(r.re - dx1.re, r.im - dx1.im)
        rc = _restrict(P, r1, block, n_blk=n_blk)
        tail = rc.re.shape[5:]
        flat = cplx.cmap(lambda a: a.reshape((M,) + tail), rc)
        sol = jax.scipy.linalg.lu_solve(
            lu, jnp.concatenate([flat.re, flat.im], axis=0))
        c = cplx.CArray(sol[:M].reshape(clat + (K2,) + tail),
                        sol[M:].reshape(clat + (K2,) + tail))
        pc = _prolong(P, c, block, sc=blk)
        x2 = cplx.CArray(x1.re + pc.re, x1.im + pc.im)
        dx2 = D(x2)
        r2 = cplx.CArray(r.re - dx2.re, r.im - dx2.im)
        s2 = S(r2)
        return cplx.CArray(x2.re + s2.re, x2.im + s2.im)

    return prec


def coarse_bsr_operator(op: BSROperator, P: cplx.CArray,
                        block=(2, 2, 2, 2), normal: bool = True,
                        A_c: Optional[cplx.CArray] = None) -> BSROperator:
    """The Galerkin coarse operator as a TRUE coarse-lattice BSR stencil.

    A_c = P^H (D^H D) P over contiguous width->=2 aggregates is a regular
    coarse-lattice stencil with KxK dense blocks spanning the {0, +-1}^4
    displacement set (D^H D reaches 2 fine hops, whose bent paths couple
    corner aggregates) — exactly the ``coarse_operator``/create_bsr
    regime (bsr.h:2287).  Built by reading the dense Galerkin matrix off
    per coarse displacement, with a completeness check; enables recursive
    multilevel use of the whole BSR machinery on the coarse level.
    """
    from ..bsr import bsr_from_stencil

    if A_c is None:
        A_c = coarse_matrix(op, P, block, normal)
    clat = tuple(P.shape[:4])
    K = P.shape[-1]
    Vc = volume(clat)
    ac = np.asarray(A_c.re) + 1j * np.asarray(A_c.im)
    ac = ac.reshape(clat + (K,) + clat + (K,))

    # D^H D reaches 2 fine hops, so the coarse stencil spans the FULL
    # {0, +-1}^4 displacement set (corner couplings from bent 2-hop
    # paths) — still a regular stencil the BSR engine handles natively.
    import itertools as _it

    choices = []
    for mu in range(4):
        if clat[mu] == 1:
            choices.append((0,))
        elif clat[mu] == 2:
            choices.append((0, 1))     # +1 and -1 are the same neighbor
        else:
            choices.append((0, 1, -1))
    offsets = [off for off in _it.product(*choices)]
    nblk = len(offsets)
    blocks = np.zeros(clat + (nblk, K, K), dtype=complex)
    for k, off in enumerate(offsets):
        for c1 in np.ndindex(*clat):
            c2 = tuple((a + o) % d for a, o, d in zip(c1, off, clat))
            blocks[c1 + (k,)] = ac[c1 + (slice(None),) + c2]

    # verify nothing outside the stencil was dropped (structure check)
    total = float(np.abs(ac).sum())
    kept = float(np.abs(blocks).sum())
    if not np.isclose(total, kept, rtol=1e-8):
        raise ValueError(
            "Galerkin coarse operator is not nearest-neighbor on the "
            "coarse lattice (aggregate width < stencil reach?)")

    # numpy-backed parts: bsr_from_stencil attaches host caches so jit
    # programs closing over the coarse operator lower without a fetch
    return bsr_from_stencil(
        "xyztc", "xyztC", clat, {"c": K}, {"C": K}, offsets,
        cplx.CArray(blocks.real, blocks.imag),
    )


def build_hierarchy(op: BSROperator, levels: int = 2, block=(2, 2, 2, 2),
                    K: int = 4, setup_iters: int = 8, key=0):
    """Recursive multilevel setup (the stack reference consumers build
    over bsr_krylov handles, bsr.h:2353): returns 4-tuples
    [(op_l, P_l, A_c_l, block_l), ...] for l = 0..levels-1, where
    op_{l+1} = coarse_bsr_operator(op_l, P_l).  Level 0 targets the
    NORMAL operator D^H D; every coarse Galerkin operator is already
    Hermitian PD and deeper levels target it DIRECTLY (preconditioning
    A_c, not A_c^2 — the recursion would otherwise invert the square).
    The dense A_c of each level is computed once and shared with the
    coarse-operator extraction."""
    out = []
    cur = op
    for l in range(levels):
        normal = (l == 0)
        blk = tuple(min(b, d) for b, d in zip(block, cur.dim_d))
        kk = min(K, volume(_blk_shape(cur)))
        P = build_prolongator(cur, block=blk, K=kk,
                              setup_iters=setup_iters, key=key + l,
                              normal=normal)
        A_c = coarse_matrix(cur, P, blk, normal=normal)
        out.append((cur, P, A_c, blk, normal))
        if l + 1 < levels:
            cur = coarse_bsr_operator(cur, P, blk, normal=normal, A_c=A_c)
    return out


def vcycle_preconditioner(hierarchy, omegas=None,
                          cheby_degree: Optional[int] = None,
                          cheby_theta: float = 30.0):
    """Recursive V-cycle over a :func:`build_hierarchy` result: at each
    level a coarse correction (recursing until the dense bottom solve)
    plus a post-smooth — one Richardson step by default, or a degree-d
    :func:`chebyshev_smoother` per level with ``cheby_degree`` set (the
    configuration that pays on near-critical operators).  Reference
    analog: the multilevel preconditioner loops consumers drive over
    bsr_krylov handles (bsr.h:2353)."""
    from ..solvers import power_iteration

    # spectral estimation only when something below needs it: explicit
    # omegas with Richardson smoothing skip the (fine-matvec-heavy)
    # power iterations entirely
    lams = None
    if omegas is None or cheby_degree is not None:
        lams = []
        rng = np.random.default_rng(0)
        for (op_l, P_l, _, _, normal_l) in hierarchy:
            shape = tuple(op_l.dim_d) + _blk_shape(op_l)
            x0 = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                             jnp.asarray(rng.standard_normal(shape)))
            lam, _ = power_iteration(
                lambda u, o=op_l, nl=normal_l: _level_apply(o, u, nl),
                x0, iters=15)
            lams.append(float(lam))
    if omegas is None:
        omegas = [0.8 / l for l in lams]

    def make(level):
        op_l, P_l, A_c_l, blk_l, normal_l = hierarchy[level]
        if level + 1 >= len(hierarchy):
            # bottom: dense coarse solve (the only level that pays the
            # Cholesky factorization) — the requested smoother applies
            # HERE too (a 1-level hierarchy would otherwise silently
            # drop cheby_degree)
            if cheby_degree is None:
                return two_grid_preconditioner(op_l, P_l, A_c_l, blk_l,
                                               omega=omegas[level],
                                               normal=normal_l)
            base = two_grid_preconditioner(op_l, P_l, A_c_l, blk_l,
                                           omega=0.0, normal=normal_l)
            A_b = lambda u: _level_apply(op_l, u, normal_l)
            S_b = chebyshev_smoother(A_b, lams[level] * 1.05,
                                     degree=cheby_degree,
                                     theta=cheby_theta)

            def prec_bottom(r):
                x = base(r)
                ax = A_b(x)
                s = S_b(cplx.CArray(r.re - ax.re, r.im - ax.im))
                return cplx.CArray(x.re + s.re, x.im + s.im)
            return prec_bottom

        # replace the dense coarse solve by the next level's cycle:
        # x = P M_{l+1}(P^H r) + smoothing
        inner = make(level + 1)
        blk = _blk_shape(op_l)
        n_blk = len(blk)
        A_l = lambda u: _level_apply(op_l, u, normal_l)
        if cheby_degree is not None:
            S = chebyshev_smoother(A_l, lams[level] * 1.05,
                                   degree=cheby_degree, theta=cheby_theta)
        else:
            w = omegas[level]
            S = lambda r: cplx.CArray(w * r.re, w * r.im)

        def prec(r):
            rc = _restrict(P_l, r, blk_l, n_blk=n_blk)
            # rc lives on the coarse lattice with block (K,): the next
            # level's cycle approximates A_c^{-1} (the coarse operator
            # is applied DIRECTLY there, not through normal equations)
            c = inner(rc)
            x = _prolong(P_l, c, blk_l, sc=blk)
            res = r
            ax = A_l(x)
            s = S(cplx.CArray(res.re - ax.re, res.im - ax.im))
            return cplx.CArray(x.re + s.re, x.im + s.im)
        return prec

    return make(0)
