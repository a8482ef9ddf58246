"""Two-grid aggregation multigrid (models/multigrid.py).

Oracles are the defining algebraic properties: block-orthonormal
prolongator, Hermitian Galerkin coarse operator, EXACT elimination of
range(P) errors by one coarse correction, and a contraction factor < 1
with one smoothing step."""

import jax
import jax.numpy as jnp
import numpy as np

from superbblas_tpu import cplx
from superbblas_tpu.models import wilson_operator
from superbblas_tpu.models.multigrid import (
    _A_normal,
    _prolong,
    build_prolongator,
    coarse_matrix,
    two_grid_error_contraction,
    two_grid_preconditioner,
)
from superbblas_tpu.solvers import power_iteration


def setup(lat=(4, 4, 4, 4), mass=0.05, K=4):
    op = wilson_operator(lat, mass=mass, key=3, dtype=jnp.complex128)
    P = build_prolongator(op, K=K, setup_iters=10)
    A_c = coarse_matrix(op, P)
    return op, P, A_c


def test_two_grid_properties():
    op, P, A_c = setup()
    # block-orthonormal prolongator
    pm = np.asarray(P.re) + 1j * np.asarray(P.im)
    g = np.einsum("...di,...dj->...ij", np.conj(pm), pm)
    assert np.abs(g - np.eye(P.shape[-1])).max() < 1e-12
    # Hermitian Galerkin coarse operator
    ac = np.asarray(A_c.re) + 1j * np.asarray(A_c.im)
    assert np.abs(ac - ac.conj().T).max() < 1e-10

    # Galerkin exactness: errors in range(P) die in one coarse correction
    rng = np.random.default_rng(0)
    clat = P.shape[:4]
    c = cplx.CArray(jnp.asarray(rng.standard_normal(clat + (4,))),
                    jnp.asarray(rng.standard_normal(clat + (4,))))
    e = _prolong(P, c, (2, 2, 2, 2))
    prec = two_grid_preconditioner(op, P, A_c)
    corr = prec(_A_normal(op, e))
    rel = np.sqrt(float(jnp.sum((e.re - corr.re) ** 2
                                + (e.im - corr.im) ** 2))
                  / float(jnp.sum(e.re ** 2 + e.im ** 2)))
    assert rel < 1e-10, rel


def test_two_grid_contracts_with_smoothing():
    op, P, A_c = setup()
    rng = np.random.default_rng(1)
    lat = tuple(op.dim_d)
    x0 = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (4, 3))),
                     jnp.asarray(rng.standard_normal(lat + (4, 3))))
    lam, _ = power_iteration(lambda u: _A_normal(op, u), x0, iters=20)
    rho = two_grid_error_contraction(op, P, A_c, omega=float(0.8 / float(lam)))
    assert rho < 0.85, rho


def test_pcg_with_deflation_preconditioner():
    """pcg converges to the same solution as plain cg under the symmetric
    deflation preconditioner M = P A_c^{-1} P^H + c I.  (A spectral
    speed-up demo needs a near-critical gauge configuration — on tiny
    random/free fields the plain-CG spectrum is too clustered to lose;
    the MG quality metric here is the contraction-factor test above.)"""
    from superbblas_tpu.solvers import cg, pcg, power_iteration as pwr

    op, P, A_c = setup(mass=0.2)
    lat = tuple(op.dim_d)
    A = lambda u: _A_normal(op, u)
    rng = np.random.default_rng(2)
    b = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (4, 3))),
                    jnp.asarray(rng.standard_normal(lat + (4, 3))))
    lam, _ = pwr(A, b, iters=20)
    c = float(1.0 / float(lam))
    coarse_only = two_grid_preconditioner(op, P, A_c)

    def M(r):
        z = coarse_only(r)
        return cplx.CArray(z.re + c * r.re, z.im + c * r.im)

    x_p, rs_p, k_p = pcg(A, M, b, tol=1e-10, maxiter=500)
    x_c, rs_c, k_c = cg(A, b, tol=1e-10, maxiter=500)
    np.testing.assert_allclose(np.asarray(x_p.re), np.asarray(x_c.re),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(x_p.im), np.asarray(x_c.im),
                               atol=1e-7)


def test_coarse_bsr_operator_matches_dense_galerkin():
    """The Galerkin coarse operator IS a coarse-lattice BSR stencil: its
    bsr matvec equals the dense A_c matvec (and the structure check
    confirms no entries fall outside the nearest-neighbor pattern)."""
    from superbblas_tpu.models import apply_coarse
    from superbblas_tpu.models.multigrid import coarse_bsr_operator

    op, P, A_c = setup()
    cop = coarse_bsr_operator(op, P)
    clat = P.shape[:4]
    K = P.shape[-1]
    M = int(np.prod(clat)) * K
    rng = np.random.default_rng(0)
    c = cplx.CArray(jnp.asarray(rng.standard_normal(clat + (K, 1))),
                    jnp.asarray(rng.standard_normal(clat + (K, 1))))

    got = apply_coarse(cop, c)
    ac = np.asarray(A_c.re) + 1j * np.asarray(A_c.im)
    cv = (np.asarray(c.re) + 1j * np.asarray(c.im)).reshape(M)
    want = (ac @ cv).reshape(clat + (K, 1))
    np.testing.assert_allclose(np.asarray(got.re) + 1j * np.asarray(got.im),
                               want, atol=1e-10)


def test_multilevel_recursion():
    """The hierarchy recurses: fine Wilson -> coarse BSR -> coarser.
    Galerkin exactness holds at level 2 exactly as at level 1."""
    from superbblas_tpu.models.multigrid import (
        _blk_shape,
        coarse_bsr_operator,
    )

    # level 0 -> 1
    op0, P1, _ = setup(lat=(8, 8, 4, 4), mass=0.2, K=4)
    op1 = coarse_bsr_operator(op0, P1)
    assert op1.mode == "stencil" and _blk_shape(op1) == (4,)
    assert tuple(op1.dim_d) == (4, 4, 2, 2)

    # level 1 -> 2 through the SAME machinery
    P2 = build_prolongator(op1, block=(2, 2, 2, 2), K=2, setup_iters=6,
                           key=1)
    A_c2 = coarse_matrix(op1, P2)
    assert P2.shape[:4] == (2, 2, 1, 1)
    ac2 = np.asarray(A_c2.re) + 1j * np.asarray(A_c2.im)
    assert np.abs(ac2 - ac2.conj().T).max() < 1e-8

    # Galerkin exactness at level 2 (range(P2) error killed by the
    # level-2 coarse correction of the LEVEL-1 operator)
    rng = np.random.default_rng(3)
    c = cplx.CArray(jnp.asarray(rng.standard_normal(P2.shape[:4] + (2,))),
                    jnp.asarray(rng.standard_normal(P2.shape[:4] + (2,))))
    e = _prolong(P2, c, (2, 2, 2, 2), sc=(4,))
    prec2 = two_grid_preconditioner(op1, P2, A_c2)
    corr = prec2(_A_normal(op1, e))
    rel = np.sqrt(float(jnp.sum((e.re - corr.re) ** 2
                                + (e.im - corr.im) ** 2))
                  / float(jnp.sum(e.re ** 2 + e.im ** 2)))
    assert rel < 1e-9, rel


def test_coarse_level_smoothing_honors_normal_flag():
    """On a normal=False level (Galerkin coarse operator, already
    Hermitian PD) the post-smoothing step of two_grid_preconditioner must
    apply A_c ONCE — smoothing through A_c^H A_c (the hardcoded-normal
    regression) amplifies high coarse modes with |1 - omega*lambda^2|>1."""
    from superbblas_tpu.models import apply_coarse
    from superbblas_tpu.models.multigrid import (_restrict,
                                                 coarse_bsr_operator)

    op0, P1, _ = setup(lat=(4, 4, 4, 4), mass=0.2, K=4)
    op1 = coarse_bsr_operator(op0, P1)       # Hermitian PD coarse BSR
    P2 = build_prolongator(op1, block=(2, 2, 2, 2), K=2, setup_iters=6,
                           key=1, normal=False)
    A_c2 = coarse_matrix(op1, P2, normal=False)
    w = 0.3
    prec = two_grid_preconditioner(op1, P2, A_c2, omega=w, normal=False)

    clat1 = tuple(op1.dim_d)
    rng = np.random.default_rng(9)
    r = cplx.CArray(jnp.asarray(rng.standard_normal(clat1 + (4,))),
                    jnp.asarray(rng.standard_normal(clat1 + (4,))))
    got = prec(r)

    # manual reference: x = P A_c^{-1} P^H r ; out = x + w (r - A_c x)
    # with A_c applied ONCE via the independent coarse matvec
    rc = _restrict(P2, r, (2, 2, 2, 2), n_blk=1)
    M = A_c2.shape[0]
    ac = np.asarray(A_c2.re) + 1j * np.asarray(A_c2.im)
    rcv = (np.asarray(rc.re) + 1j * np.asarray(rc.im)).reshape(M)
    cv = np.linalg.solve(ac, rcv).reshape(P2.shape[:4] + (2,))
    c = cplx.CArray(jnp.asarray(cv.real), jnp.asarray(cv.imag))
    x = _prolong(P2, c, (2, 2, 2, 2), sc=(4,))
    ax = apply_coarse(op1, cplx.cmap(lambda a: a[..., None], x))
    ax = cplx.cmap(lambda a: a[..., 0], ax)
    want_re = np.asarray(x.re) + w * (np.asarray(r.re) - np.asarray(ax.re))
    want_im = np.asarray(x.im) + w * (np.asarray(r.im) - np.asarray(ax.im))
    np.testing.assert_allclose(np.asarray(got.re), want_re, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got.im), want_im, atol=1e-9)


def test_vcycle_contracts():
    """A 2-level V-cycle built by the recursive hierarchy contracts a
    random error (and runs end to end through both levels)."""
    from superbblas_tpu.models.multigrid import (
        build_hierarchy,
        vcycle_preconditioner,
    )

    op = wilson_operator((4, 4, 4, 4), mass=0.2, key=3,
                         dtype=jnp.complex128)
    h = build_hierarchy(op, levels=2, K=4, setup_iters=8)
    M = vcycle_preconditioner(h)

    rng = np.random.default_rng(5)
    shape = (4, 4, 4, 4, 4, 3)
    e = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))
    corr = M(_A_normal(op, e))
    e_new = cplx.CArray(e.re - corr.re, e.im - corr.im)
    rho = float(jnp.sqrt(jnp.sum(e_new.re ** 2 + e_new.im ** 2)
                         / jnp.sum(e.re ** 2 + e.im ** 2)))
    assert rho < 0.9, rho


def test_chebyshev_smoother_minimax():
    """The smoother's error polynomial |1 - t p(t)| must hit the TRUE
    Chebyshev minimax bound 1/cosh(d*acosh(sigma)) on the band — the
    mis-seeded recurrence a review caught missed it (0.557 vs 0.434 at
    d=4)."""
    from superbblas_tpu.models.multigrid import chebyshev_smoother

    lam, theta = 1.0, 30.0
    lo, hi = lam / theta, lam
    ts = np.linspace(lo, hi, 2001)
    for degree in (2, 4, 6):
        A = lambda v: cplx.CArray(jnp.asarray(ts) * v.re,
                                  jnp.asarray(ts) * v.im)
        S = chebyshev_smoother(A, lam, degree=degree, theta=theta)
        x = S(cplx.CArray(jnp.ones(len(ts)), jnp.zeros(len(ts))))
        err = np.abs(1.0 - ts * np.asarray(x.re)).max()
        sigma = (hi + lo) / (hi - lo)
        bound = 1.0 / np.abs(np.cosh(degree * np.arccosh(sigma)))
        np.testing.assert_allclose(err, bound, rtol=1e-6,
                                   err_msg=f"degree {degree}")


def test_vcycle_chebyshev_contracts_harder():
    """The Chebyshev-smoothed V-cycle contracts a random error at least
    as fast as the Richardson one (and strictly runs the cheby path)."""
    from superbblas_tpu.models.multigrid import (
        build_hierarchy,
        vcycle_preconditioner,
    )

    op = wilson_operator((4, 4, 4, 4), mass=0.2, key=3,
                         dtype=jnp.complex128)
    h = build_hierarchy(op, levels=2, K=4, setup_iters=8)
    rng = np.random.default_rng(5)
    shape = (4, 4, 4, 4, 4, 3)
    e = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    def rho_of(M):
        corr = M(_A_normal(op, e))
        en = cplx.CArray(e.re - corr.re, e.im - corr.im)
        return float(jnp.sqrt(jnp.sum(en.re ** 2 + en.im ** 2)
                              / jnp.sum(e.re ** 2 + e.im ** 2)))

    rho_rich = rho_of(vcycle_preconditioner(h))
    rho_cheb = rho_of(vcycle_preconditioner(h, cheby_degree=4))
    assert rho_cheb < 0.9 and rho_cheb <= rho_rich * 1.05, \
        (rho_cheb, rho_rich)


def test_vcycle_single_level_honors_cheby():
    """Review regression: a 1-level hierarchy must still apply the
    requested Chebyshev smoother (it was silently dropped at the bottom
    level), contracting markedly harder than Richardson."""
    from superbblas_tpu.models.multigrid import (
        build_hierarchy,
        vcycle_preconditioner,
    )

    op = wilson_operator((4, 4, 4, 4), mass=0.2, key=3,
                         dtype=jnp.complex128)
    h = build_hierarchy(op, levels=1, K=4, setup_iters=8)
    rng = np.random.default_rng(7)
    shape = (4, 4, 4, 4, 4, 3)
    e = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    def rho_of(M):
        corr = M(_A_normal(op, e))
        en = cplx.CArray(e.re - corr.re, e.im - corr.im)
        return float(jnp.sqrt(jnp.sum(en.re ** 2 + en.im ** 2)
                              / jnp.sum(e.re ** 2 + e.im ** 2)))

    rho_rich = rho_of(vcycle_preconditioner(h))
    rho_cheb = rho_of(vcycle_preconditioner(h, cheby_degree=6))
    assert rho_cheb < 0.6 * rho_rich, (rho_cheb, rho_rich)


def test_vcycle_on_sharded_fields():
    """The whole cycle (restrict/coarse solve/prolong/smooth) is plain
    jax ops on global arrays, so it runs unchanged on GSPMD-sharded
    operands and matches the unsharded result."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from superbblas_tpu import parallel as par
    from superbblas_tpu.models.multigrid import (
        _level_apply,
        build_hierarchy,
        vcycle_preconditioner,
    )

    op = wilson_operator((8, 4, 4, 4), mass=0.2, key=3,
                         dtype=jnp.complex128)
    h = build_hierarchy(op, levels=2, K=4, setup_iters=6)
    M = vcycle_preconditioner(h)

    rng = np.random.default_rng(7)
    shape = (8, 4, 4, 4, 4, 3)
    r = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))
    want = M(r)

    mesh = par.make_mesh({"x": 8})
    r_sh = jax.device_put(
        r, NamedSharding(mesh, P("x", None, None, None, None, None)))
    got = M(r_sh)
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                               atol=1e-10)


def test_symmetric_two_grid_pcg_near_critical():
    """The symmetrized V(1,1) cycle is an SPD preconditioner: pcg with it
    must converge to the plain-cg solution AND in fewer iterations on a
    near-critical configuration (mass ~ -1.8 with fully random links is
    deep in the slow-CG regime for this 4^4 field; the plain
    two_grid_preconditioner is singular at omega=0 and non-symmetric at
    omega>0, so pcg breaks down with it — the regression this guards)."""
    from superbblas_tpu.models.multigrid import (
        symmetric_two_grid_preconditioner)
    from superbblas_tpu.solvers import cg, pcg

    op = wilson_operator((4, 4, 4, 4), mass=-1.8, key=3,
                         dtype=jnp.complex128)
    A = lambda u: _A_normal(op, u)
    rng = np.random.default_rng(11)
    lat = tuple(op.dim_d)
    b = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (4, 3))),
                    jnp.asarray(rng.standard_normal(lat + (4, 3))))
    x, _, it = cg(A, b, tol=1e-7, maxiter=4000)

    P = build_prolongator(op, K=8, setup_iters=30)
    A_c = coarse_matrix(op, P)
    M = symmetric_two_grid_preconditioner(op, P, A_c)
    xp, _, itp = pcg(A, M, b, tol=1e-7, maxiter=4000)

    num = float(jnp.sum((xp.re - x.re) ** 2 + (xp.im - x.im) ** 2))
    den = float(jnp.sum(x.re ** 2 + x.im ** 2))
    assert num / den < 1e-10, num / den
    assert int(itp) < int(it), (int(itp), int(it))

    # Chebyshev-smoothed cycle: the production configuration — >=3x
    # iteration reduction on the near-critical demo (measured ~5.5x at
    # d=4 theta=30; experiments/mg_chebyshev.py)
    Mc = symmetric_two_grid_preconditioner(op, P, A_c, cheby_degree=4,
                                           cheby_theta=30.0)
    xc2, _, itc = pcg(A, Mc, b, tol=1e-7, maxiter=4000)
    num = float(jnp.sum((xc2.re - x.re) ** 2 + (xc2.im - x.im) ** 2))
    assert num / den < 1e-10, num / den
    assert int(itc) * 3 <= int(it), (int(itc), int(it))


def test_mg_on_unsquared_operator():
    """Multigrid on D itself (chiral-doubled prolongator + LU coarse
    solve + GCR smoothing) inside flexible GCR: converges to the CGNE
    answer with several-fold fewer operator applies — the production
    deployment shape.  Reference analog: the multigrid preconditioner
    loops consumers drive over bsr_krylov handles (bsr.h:2353)."""
    from superbblas_tpu.models import apply_wilson
    from superbblas_tpu.models.wilson import apply_wilson_dagger
    from superbblas_tpu.models.multigrid import (
        build_prolongator_chiral, coarse_matrix, mg_preconditioner_d,
        _A_normal)
    from superbblas_tpu.solvers import cg, fgcr

    lat = (4, 4, 4, 4)
    op = wilson_operator(lat, mass=-1.8, key=3, dtype=jnp.complex128)
    rng = np.random.default_rng(1)
    N = 2
    b = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (4, 3, N))),
                    jnp.asarray(rng.standard_normal(lat + (4, 3, N))))
    D = lambda u: apply_wilson(op, u)

    P = build_prolongator_chiral(op, K=4, setup_iters=8)
    # chiral structure: the doubled coarse space is gamma5-compatible —
    # P^H gamma5 P must be diag(+1 x K, -1 x K) per aggregate
    g5p = cplx.cmap(
        lambda a: jnp.concatenate([a[..., :a.shape[-2] // 2, :],
                                   -a[..., a.shape[-2] // 2:, :]], axis=-2),
        P)  # gamma5 acts as +1 on the first half of the aggregated dof
    # NOTE: aggregation interleaves (block sites, spin, color); gamma5 on
    # aggregated dof is NOT a contiguous half-split, so check instead the
    # defining property through the fine operator: columns 0..K-1 have
    # upper-spin support only, K..2K-1 lower-spin only, verified after
    # un-aggregation.
    from superbblas_tpu.models.multigrid import _unaggregate
    K2 = P.shape[-1]
    K = K2 // 2
    cols = _unaggregate(
        cplx.cmap(lambda a: a.reshape(a.shape[:4] + (a.shape[4], K2)), P),
        (2, 2, 2, 2))   # [*lat, 4, 3, 2K]
    up = np.abs(np.asarray(cols.re[..., 2:, :, :K])).max()
    dn = np.abs(np.asarray(cols.re[..., :2, :, K:])).max()
    assert up < 1e-12 and dn < 1e-12, (up, dn)

    Ac = coarse_matrix(op, P, normal=False)
    M = mg_preconditioner_d(op, P, Ac, smooth_steps=4)
    xm, rs, itm = fgcr(D, b, M=M, tol=1e-9, maxiter=400, restart=8,
                       cols=True)
    xn, _, itn = cg(lambda u: _A_normal(op, u), apply_wilson_dagger(op, b),
                    tol=1e-9, maxiter=20000, cols=True)
    err = float(jnp.max(jnp.abs(xm.re - xn.re))
                + jnp.max(jnp.abs(xm.im - xn.im)))
    assert err < 1e-5, err
    # D-apply economy: outer(1) + cycle(2*ss + 2) per iteration vs
    # CGNE's 2 per iteration — require a real multiple
    assert int(itm) * 11 * 2 < 2 * int(itn), (int(itm), int(itn))


def test_fgcr_unpreconditioned_matches_bicgstab_answer():
    """fgcr without a preconditioner solves general non-Hermitian
    systems (restarted GCR); answers match the Wilson solve."""
    from superbblas_tpu.models import apply_wilson
    from superbblas_tpu.solvers import bicgstab, fgcr

    lat = (4, 4, 4, 4)
    op = wilson_operator(lat, mass=0.2, key=3, dtype=jnp.complex128)
    rng = np.random.default_rng(4)
    b = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (4, 3, 1))),
                    jnp.asarray(rng.standard_normal(lat + (4, 3, 1))))
    D = lambda u: apply_wilson(op, u)
    xg, rsg, _ = fgcr(D, b, tol=1e-9, maxiter=500, restart=12)
    xb, _, _ = bicgstab(D, b, tol=1e-10, maxiter=500)
    err = float(jnp.max(jnp.abs(xg.re - xb.re))
                + jnp.max(jnp.abs(xg.im - xb.im)))
    assert err < 1e-6, err


def test_level_apply_soa_matches_aos():
    """_level_apply routes SoA-layout operators through the SoA stencil
    with layout conversion at the boundary — the whole multigrid cycle
    rides the hot path.  Both layouts of the same links
    must agree (normal and plain applies)."""
    import jax.numpy as jnp

    from superbblas_tpu import cplx
    from superbblas_tpu.models import wilson_operator
    from superbblas_tpu.models.multigrid import _level_apply

    lat = (2, 2, 8, 128)
    from superbblas_tpu.models.wilson import random_su3_links
    rng = np.random.default_rng(5)
    links = random_su3_links(rng, lat)
    op_a = wilson_operator(lat, mass=-1.0, links=links,
                           dtype=jnp.complex64)
    op_s = wilson_operator(lat, mass=-1.0, links=links,
                           dtype=jnp.complex64, layout="soa")
    x = cplx.CArray(
        jnp.asarray(rng.standard_normal(lat + (4, 3, 2)), jnp.float32),
        jnp.asarray(rng.standard_normal(lat + (4, 3, 2)), jnp.float32))
    for normal in (False, True):
        ya = _level_apply(op_a, x, normal=normal)
        ys = _level_apply(op_s, x, normal=normal)
        np.testing.assert_allclose(np.asarray(ys.re), np.asarray(ya.re),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(np.asarray(ys.im), np.asarray(ya.im),
                                   rtol=2e-3, atol=2e-3)


def test_block_cholqr_matches_host_qr_column_space():
    """The device CholeskyQR2 (`_block_cholqr`) must produce per-block
    orthonormal columns spanning EXACTLY the input column space — the
    oracle is np.linalg.qr through the projector Q Q^H, which is basis-
    independent.  Includes a poorly-scaled input (columns spread over 6
    orders of magnitude) to exercise the two-pass correction."""
    from superbblas_tpu.models.multigrid import _block_cholqr

    rng = np.random.default_rng(7)
    B, dof, K = 5, 48, 8
    a = rng.standard_normal((B, dof, K)) + 1j * rng.standard_normal(
        (B, dof, K))
    # poorly scaled columns: cond(A) ~ 1e6, still within CholeskyQR2
    # range at f64
    a = a * np.logspace(0, -6, K)[None, None, :]
    q = _block_cholqr(cplx.CArray(jnp.asarray(a.real), jnp.asarray(a.imag)))
    qm = np.asarray(q.re) + 1j * np.asarray(q.im)
    # orthonormal per block
    g = np.einsum("bdi,bdj->bij", np.conj(qm), qm)
    assert np.abs(g - np.eye(K)).max() < 1e-10
    # same column space as the host QR (projector oracle)
    q_host = np.linalg.qr(a)[0]
    p_dev = np.einsum("bdi,bei->bde", qm, np.conj(qm))
    p_host = np.einsum("bdi,bei->bde", q_host, np.conj(q_host))
    assert np.abs(p_dev - p_host).max() < 1e-8
