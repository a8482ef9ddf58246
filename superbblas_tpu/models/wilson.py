"""Wilson-Dirac lattice operator: the flagship workload.

The reference library exists to serve lattice-QCD codes (Chroma/PRIMME);
its canonical benchmark is the Dirac-like nearest-neighbor BSR operator
with spin (x) color blocks (tests/bsr.cpp:104-152 builds exactly this
shape).  Here we construct a physically-structured Wilson operator

    D x (s) = (m + 4 r) x(s)
              - 1/2 sum_mu [ (r - gamma_mu) (x) U_mu(s)      x(s + mu)
                           + (r + gamma_mu) (x) U_mu(s-mu)^H x(s - mu) ]

as a Kronecker-factored BSR operator (spin factors shared across sites,
per-site SU(3)-like color links) — the exact structure
``create_kron_bsr`` (bsr.h:2302-2336) exists for — and provide a CG
solver whose iteration is the "training step" analog: one halo-exchanged
stencil matvec plus psum-reduced inner products.

Complex data is carried split (cplx.CArray): links/gammas are generated
host-side in numpy and stored as (re, im) pairs.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import cplx
from ..bsr import BSROperator, bsr_from_stencil, bsr_krylov
from ..labels import volume

NS = 4  # spin components
NC = 3  # colors


def _seed_from_key(key) -> int:
    """Shared PRNG-key/int -> numpy seed conversion for the model
    constructors (accepts None, python/numpy ints, and jax PRNG keys)."""
    if key is None:
        return 0
    if isinstance(key, (int, np.integer)):
        return int(key)
    if hasattr(key, "dtype"):
        return int(np.asarray(jax.random.key_data(key)).ravel()[-1])
    return int(key)


def gamma_matrices() -> np.ndarray:
    """Euclidean gamma matrices (DeGrand-Rossi basis), numpy [4, 4, 4]."""
    g = np.zeros((4, NS, NS), dtype=np.complex128)
    g[0] = [[0, 0, 0, 1j], [0, 0, 1j, 0], [0, -1j, 0, 0], [-1j, 0, 0, 0]]
    g[1] = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]
    g[2] = [[0, 0, 1j, 0], [0, 0, 0, -1j], [-1j, 0, 0, 0], [0, 1j, 0, 0]]
    g[3] = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]]
    return g


def random_su3_links(rng: np.random.Generator, lat_dims) -> np.ndarray:
    """Random unitary gauge links U[mu, *lat, 3, 3] (host-side QR of a
    Gaussian; U(3) rather than SU(3), fine for benchmarks)."""
    shape = (len(lat_dims),) + tuple(lat_dims) + (NC, NC)
    a = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    q, r = np.linalg.qr(a)
    d = np.einsum("...ii->...i", r)
    q = q * (d / np.abs(d)).conj()[..., None, :]
    return q


def wilson_operator(
    lat_dims: Tuple[int, ...],
    mass: float = 0.1,
    r: float = 1.0,
    key=None,
    dtype=jnp.complex64,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
    storage_dtype=None,
) -> BSROperator:
    """Build the Wilson operator as a split-complex Kron-BSR stencil.

    Labels: lattice "xyzt"[:nd], spin "S" (kron factor), color "c"/"C".
    ``dtype`` picks precision: complex64 -> float32 parts, complex128 ->
    float64 parts.  ``layout="soa"`` builds the lattice-minor hot layout
    whose matvec runs in the SoA stencil (ops/stencil_pallas.py), the
    production path; apply_wilson then takes SoA operands
    [ncols, 12, *lat].

    ``storage_dtype=jnp.bfloat16`` stores the link blocks bf16 (the
    stencil converts loads and accumulates in f32), halving the link
    traffic of a bandwidth-bound matvec.  Pair with
    solvers.refined_solve for full-precision answers.  The spin factors
    stay f32 (trace-time constants).
    """
    nd = len(lat_dims)
    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)  # [mu, *lat, c, c] complex128
    g = gamma_matrices()
    eye_s = np.eye(NS, dtype=np.complex128)
    eye_c = np.broadcast_to(np.eye(NC, dtype=np.complex128),
                            tuple(lat_dims) + (NC, NC))

    offsets = [(0,) * nd]
    spin_factors = [(mass + r * nd) * eye_s]
    color_blocks = [eye_c]
    for mu in range(nd):
        fwd = [0] * nd
        fwd[mu] = 1
        offsets.append(tuple(fwd))
        spin_factors.append(-0.5 * (r * eye_s - g[mu]))
        color_blocks.append(links[mu])
        bwd = [0] * nd
        bwd[mu] = -1
        offsets.append(tuple(bwd))
        spin_factors.append(-0.5 * (r * eye_s + g[mu]))
        # U_mu(s - mu)^H : shift the link field then conjugate-transpose
        shifted = np.roll(links[mu], 1, axis=mu)
        color_blocks.append(np.swapaxes(shifted, -1, -2).conj())

    part_dt = np.float32 if dtype == jnp.complex64 else np.float64
    blocks = np.stack(color_blocks, axis=nd).astype(np.complex128)
    kron = np.stack(spin_factors, axis=0)
    lat_labels = "xyzt"[:nd]
    op = bsr_from_stencil(
        lat_labels + "Sc", lat_labels + "SC",
        lat_dims, {"c": NC}, {"C": NC},
        offsets,
        cplx.CArray(blocks.real.astype(part_dt),
                    blocks.imag.astype(part_dt)),
        kron=cplx.CArray(kron.real.astype(part_dt),
                         kron.imag.astype(part_dt)),
        kron_i={"S": NS}, kron_d={"S": NS},
        layout=layout,
    )
    if storage_dtype is not None:
        from ..bsr import bsr_cast_storage

        op = bsr_cast_storage(op, storage_dtype)
    return op


def apply_wilson(op: BSROperator, x) -> Union[jax.Array, cplx.CArray]:
    """y = D x.

    AoS operators take x shaped [*lat, NS, NC, ncols] (CArray or
    complex); SoA operators (layout='soa') take [ncols, NS*NC, *lat]
    CArrays and run the Pallas stencil kernel."""
    if op.mode == "stencil_soa":
        from ..bsr import apply_stencil_soa

        return apply_stencil_soa(op, x)
    nd = len(op.dim_d)
    ox = "xyzt"[:nd] + "SCn"
    return bsr_krylov(1.0, op, x, ox)


def _adjoint_blocks(op: BSROperator, a):
    """Direction k's adjoint block is A_k(s - o_k)^H: transpose each
    block and shift it by +o_k (the caller conjugates)."""
    if op.mode == "stencil_soa":          # [ndir, bi*bd, *lat]
        bi, bd = volume(op.bi), volume(op.bd)
        ndir, FB, lat = a.shape[0], a.shape[1], a.shape[2:]
        a = jnp.swapaxes(a.reshape((ndir, bi, bd) + lat), 1, 2)
        rows = [_roll_by(a[k], op.offsets[k], first_axis=2)
                for k in range(ndir)]
        return jnp.stack(rows, 0).reshape((ndir, FB) + lat)
    nd = len(op.dim_d)                    # [*lat, ndir, BI, BD]
    ah = jnp.swapaxes(a, -1, -2)
    rows = [_roll_by(ah[(slice(None),) * nd + (k,)], op.offsets[k],
                     first_axis=0) for k in range(op.ndir)]
    return jnp.stack(rows, axis=nd)


def _roll_by(a, off, first_axis):
    for ax, o in enumerate(off):
        if o % a.shape[first_axis + ax]:
            a = jnp.roll(a, o, axis=first_axis + ax)
    return a


def _adjoint_any(op: BSROperator) -> BSROperator:
    if cplx.is_carray(op.blocks):
        blocks_adj = cplx.conj(cplx.cmap(
            lambda a: _adjoint_blocks(op, a), op.blocks))
    else:
        blocks_adj = _adjoint_blocks(op, op.blocks)
    kron_adj = None
    if op.kron is not None:
        def kron_h(k):
            kh = cplx.cmap(lambda v: jnp.swapaxes(v, -1, -2), k)
            return cplx.conj(kh)
        if not cplx.is_carray(op.kron):
            kron_adj = jnp.swapaxes(op.kron, -1, -2)
        elif _is_traced(op.kron):
            kron_adj = kron_h(op.kron)
        else:
            # concrete spin factors stay concrete even mid-trace, so the
            # adjoint's stencil body keeps its trace-time factorization
            with jax.ensure_compile_time_eval():
                kron_adj = kron_h(op.kron)
    return dataclasses.replace(
        op, blocks=blocks_adj, kron=kron_adj,
        offsets=tuple(tuple(-o for o in off) for off in op.offsets))


def _is_traced(tree) -> bool:
    return any(isinstance(leaf, jax.core.Tracer)
               for leaf in jax.tree_util.tree_leaves(tree))


#: id(op) -> (weak reference to op, its adjoint); entries leave with op
_ADJOINTS: dict = {}


def adjoint_operator(op: BSROperator) -> BSROperator:
    """The conjugate-transposed stencil operator: direction k's adjoint
    has offset -o_k and block A_k(s - o_k)^H.

    Memoized per concrete operator in a weak side table, so the solver
    applies that ask for D^H on every trace build it once; traced
    operators (passed through a jit boundary) get a per-trace adjoint."""
    if _is_traced(op):
        return _adjoint_any(op)
    key = id(op)
    hit = _ADJOINTS.get(key)
    if hit is not None and hit[0]() is op:
        return hit[1]
    # concrete operator: construct eagerly even when called mid-trace so
    # the memoized adjoint holds arrays, not trace-scoped values
    with jax.ensure_compile_time_eval():
        adj = _adjoint_any(op)
    _ADJOINTS[key] = (weakref.ref(op, lambda _: _ADJOINTS.pop(key, None)),
                      adj)
    return adj


def apply_wilson_dagger(op: BSROperator, x):
    """y = D^H x."""
    return apply_wilson(adjoint_operator(op), x)


def _inner(a, b):
    """Re <a, b> = sum(a.re*b.re + a.im*b.im) — psum-reduced when sharded."""
    if cplx.is_carray(a):
        return cplx.inner_real(a, b)
    return jnp.sum(jnp.conj(a) * b).real


def _zeros_like(x):
    return cplx.cmap(jnp.zeros_like, x) if cplx.is_carray(x) else jnp.zeros_like(x)


def _axpy(alpha, x, y):
    """y + alpha * x for real traced alpha."""
    if cplx.is_carray(x):
        return cplx.add(y, cplx.CArray(alpha * x.re, alpha * x.im))
    return y + alpha.astype(x.dtype) * x


def cg_step(op: BSROperator, state):
    """One CG-on-normal-equations iteration (the 'training step' for the
    multi-chip dry run): stencil matvec (halo collective-permutes when
    sharded) + axpys + psum inner products."""
    x, rr, p, rs = state
    op_h = adjoint_operator(op)
    ap = apply_wilson(op_h, apply_wilson(op, p))
    alpha = rs / jnp.maximum(_inner(p, ap), 1e-30)
    x = _axpy(alpha, p, x)
    rr = _axpy(-alpha, ap, rr)
    rs_new = _inner(rr, rr)
    beta = rs_new / jnp.maximum(rs, 1e-30)
    if cplx.is_carray(rr):
        p = cplx.add(rr, cplx.CArray(beta * p.re, beta * p.im))
    else:
        p = rr + beta.astype(rr.dtype) * p
    return (x, rr, p, rs_new)


def cg_solve(
    op: BSROperator,
    b,
    n_iters: int = 10,
    tol: float = 0.0,
):
    """Conjugate gradient on the normal equations D^H D x = D^H b.

    The iteration body is one jit-compiled lax.fori_loop — the per-step
    workload the reference benches in tests/bsr_hist.cpp.
    """
    rhs = apply_wilson_dagger(op, b)
    state = (_zeros_like(b), rhs, rhs, _inner(rhs, rhs))

    def body(_, s):
        return cg_step(op, s)

    x, rr, p, rs = jax.lax.fori_loop(0, n_iters, body, state)
    return x, rs


def twisted_mass_operator(
    lat_dims: Tuple[int, ...],
    mass: float = 0.1,
    mu: float = 0.05,
    r: float = 1.0,
    key=None,
    dtype=jnp.complex64,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
) -> BSROperator:
    """Twisted-mass Wilson operator D_tm = D_W + i mu gamma5 (x) 1.

    The twist term is site-local and spin-diagonal, so it folds into the
    center direction's Kronecker factor: the operator stays a single
    Kron-BSR stencil (same structure create_kron_bsr models,
    bsr.h:2302-2336) and runs unchanged through every engine path,
    including the SoA/Pallas kernel.
    """
    if len(lat_dims) != 4:
        raise ValueError("the gamma5 twist is defined on a 4D lattice")
    op = wilson_operator(lat_dims, mass=mass, r=r, key=key, dtype=dtype,
                         links=links, layout=layout)
    g = gamma_matrices()
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    tw = 1j * mu * g5

    def add_tw(kr):
        # center direction is index 0 in wilson_operator's construction
        re = kr.re.at[0].add(jnp.asarray(tw.real, kr.re.dtype))
        im = kr.im.at[0].add(jnp.asarray(tw.imag, kr.im.dtype))
        return cplx.CArray(re, im)

    return dataclasses.replace(op, kron=add_tw(op.kron))
