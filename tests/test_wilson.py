"""Wilson-Dirac flagship model tests (split-complex engine)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from superbblas_tpu import cplx
from superbblas_tpu import parallel as par
from superbblas_tpu.models import (
    apply_wilson,
    apply_wilson_dagger,
    cg_solve,
    cg_step,
    gamma_matrices,
    wilson_operator,
)

LAT = (4, 4, 2, 2)


@pytest.fixture(scope="module")
def op():
    return wilson_operator(LAT, mass=0.5, key=7, dtype=jnp.complex128)


def rand_x(seed, ncols=2):
    rng = np.random.default_rng(seed)
    shape = LAT + (4, 3, ncols)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))


def test_gamma_algebra():
    g = gamma_matrices()
    for mu in range(4):
        np.testing.assert_allclose(g[mu], g[mu].conj().T, atol=1e-14)
        for nu in range(4):
            anti = g[mu] @ g[nu] + g[nu] @ g[mu]
            want = 2.0 * np.eye(4) * (1 if mu == nu else 0)
            np.testing.assert_allclose(anti, want, atol=1e-14)


def test_wilson_free_field_constant_mode():
    """With unit links (free field), the constant spinor is an eigenvector
    with eigenvalue = mass (hopping cancels: -1/2[(r-g)+(r+g)] = -r per
    direction, central m+4r, 4 directions -> m)."""
    op = wilson_operator(LAT, mass=0.3, key=0, dtype=jnp.complex128)
    eye_c = np.broadcast_to(np.eye(3), LAT + (3, 3))
    unit = np.stack([eye_c] * op.ndir, axis=len(LAT))
    op_free = dataclasses.replace(
        op, blocks=cplx.CArray(jnp.asarray(unit), jnp.zeros(unit.shape)))
    x = np.ones(LAT + (4, 3, 1), dtype=np.complex128)
    y = apply_wilson(op_free, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), 0.3 * x, atol=1e-12)


def test_complex_in_complex_out(op):
    x = jnp.asarray(rand_x(1))
    y = apply_wilson(op, x)
    assert jnp.iscomplexobj(y)
    assert y.shape == x.shape


def test_split_matches_complex_path(op):
    """CArray input path gives the same numbers as complex input path."""
    x = rand_x(2)
    y_complex = np.asarray(apply_wilson(op, jnp.asarray(x)))
    y_split = apply_wilson(op, cplx.from_complex(x))
    assert cplx.is_carray(y_split)
    np.testing.assert_allclose(
        np.asarray(y_split.re) + 1j * np.asarray(y_split.im),
        y_complex, rtol=1e-10)


def test_dagger_is_adjoint(op):
    x = jnp.asarray(rand_x(1))
    y = jnp.asarray(rand_x(2))
    lhs = jnp.vdot(y, apply_wilson(op, x))
    rhs = jnp.vdot(apply_wilson_dagger(op, y), x)
    np.testing.assert_allclose(complex(lhs), complex(rhs), rtol=1e-10)


def test_cg_reduces_residual(op):
    b = cplx.from_complex(rand_x(3, ncols=1))
    x, rs = cg_solve(op, b, n_iters=25)
    res = apply_wilson_dagger(op, apply_wilson(op, x)) - \
        apply_wilson_dagger(op, b)
    num = float(jnp.sqrt(cplx.inner_real(res, res)))
    rhs = apply_wilson_dagger(op, b)
    den = float(jnp.sqrt(cplx.inner_real(rhs, rhs)))
    assert num / den < 1e-3, num / den


def test_cg_step_jits_with_op_as_pytree(op):
    b = cplx.from_complex(rand_x(4, ncols=1))
    rhs = apply_wilson_dagger(op, b)
    from superbblas_tpu.models.wilson import _inner, _zeros_like
    state = (_zeros_like(b), rhs, rhs, _inner(rhs, rhs))
    step = jax.jit(cg_step)
    s1 = step(op, state)
    s2 = step(op, s1)
    assert float(s2[3]) < float(state[3])


def test_sharded_wilson_matches_single_device(op):
    mesh = par.make_mesh({"x": 2, "y": 2, "n": 2})
    x = rand_x(5, ncols=2)
    want = np.asarray(apply_wilson(op, jnp.asarray(x)))
    spec = P("x", "y", None, None, None, None, "n")
    xd = jax.device_put(cplx.from_complex(x), NamedSharding(mesh, spec))
    blocks_d = jax.device_put(
        op.blocks, NamedSharding(mesh, P("x", "y", None, None, None, None)))
    op_d = dataclasses.replace(op, blocks=blocks_d)
    got = jax.jit(apply_wilson)(op_d, xd)
    np.testing.assert_allclose(
        np.asarray(got.re) + 1j * np.asarray(got.im), want, rtol=1e-10)


LAT_SOA = (2, 2, 8, 128)


def test_soa_wilson_matches_aos():
    """layout='soa' (Pallas-eligible SoA path, reference impl on CPU)
    gives the same numbers as the general AoS path."""
    from superbblas_tpu.ops.stencil_pallas import aos_to_soa, soa_to_aos

    op_a = wilson_operator(LAT_SOA, mass=0.4, key=3, dtype=jnp.complex64)
    op_s = wilson_operator(LAT_SOA, mass=0.4, key=3, dtype=jnp.complex64,
                           layout="soa")
    rng = np.random.default_rng(0)
    shape = LAT_SOA + (4, 3, 2)
    x = cplx.CArray(
        jnp.asarray(rng.standard_normal(shape), jnp.float32),
        jnp.asarray(rng.standard_normal(shape), jnp.float32),
    )
    y_aos = apply_wilson(op_a, x)
    x_soa = aos_to_soa(x, 4)
    y_soa = apply_wilson(op_s, x_soa)
    y_back = soa_to_aos(y_soa, 4, 4, 3)
    np.testing.assert_allclose(np.asarray(y_back.re), np.asarray(y_aos.re),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(y_back.im), np.asarray(y_aos.im),
                               rtol=2e-4, atol=2e-4)


def test_soa_adjoint_is_adjoint():
    op_s = wilson_operator(LAT_SOA, mass=0.4, key=5, dtype=jnp.complex64,
                           layout="soa")
    rng = np.random.default_rng(1)
    shape = (2, 12) + LAT_SOA
    def cr(seed):
        r = np.random.default_rng(seed)
        return cplx.CArray(
            jnp.asarray(r.standard_normal(shape), jnp.float32),
            jnp.asarray(r.standard_normal(shape), jnp.float32),
        )
    x, y = cr(2), cr(3)
    ax = apply_wilson(op_s, x)
    ahy = apply_wilson_dagger(op_s, y)
    lhs = float(cplx.inner_real(y, ax))
    rhs = float(cplx.inner_real(ahy, x))
    # imaginary parts too: Im<y, Ax> = Re<iy, Ax>... real part equality
    # over random vectors pins the adjoint in the split representation
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


def test_soa_cg_step_runs():
    op_s = wilson_operator(LAT_SOA, mass=0.4, key=6, dtype=jnp.complex64,
                           layout="soa")
    rng = np.random.default_rng(4)
    shape = (1, 12) + LAT_SOA
    b = cplx.CArray(
        jnp.asarray(rng.standard_normal(shape), jnp.float32),
        jnp.asarray(rng.standard_normal(shape), jnp.float32),
    )
    rhs = apply_wilson_dagger(op_s, b)
    from superbblas_tpu.models.wilson import _inner, _zeros_like
    state = (_zeros_like(b), rhs, rhs, _inner(rhs, rhs))
    s1 = cg_step(op_s, state)
    s2 = cg_step(op_s, s1)
    assert float(s2[3]) < float(state[3])


def test_wilson_storage_dtype_bf16():
    """storage_dtype=bf16 stores the links bf16; the matvec accumulates
    in f32 and matches the f32 operator to bf16 rounding."""
    from superbblas_tpu.models import apply_wilson

    lat = (4, 4, 8, 128)
    op32 = wilson_operator(lat, mass=0.1, key=0, dtype=jnp.complex64,
                           layout="soa")
    op16 = wilson_operator(lat, mass=0.1, key=0, dtype=jnp.complex64,
                           layout="soa", storage_dtype=jnp.bfloat16)
    assert op16.blocks.re.dtype == jnp.bfloat16
    rng = np.random.default_rng(0)
    shape = (2, 12) + lat
    x = cplx.CArray(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                    jnp.asarray(rng.standard_normal(shape), jnp.float32))
    x16 = cplx.CArray(x.re.astype(jnp.bfloat16), x.im.astype(jnp.bfloat16))
    y32 = apply_wilson(op32, x)
    y16 = apply_wilson(op16, x16)
    num = float(jnp.sqrt(jnp.sum(
        (y16.re.astype(jnp.float32) - y32.re) ** 2
        + (y16.im.astype(jnp.float32) - y32.im) ** 2)))
    den = float(jnp.sqrt(jnp.sum(y32.re ** 2 + y32.im ** 2)))
    assert num / den < 0.05, num / den   # ~bf16 rounding of operands


def test_bsr_krylov_accepts_soa_op():
    """The labeled bsr_krylov API converts layouts transparently."""
    from superbblas_tpu.bsr import bsr_krylov

    op_a = wilson_operator(LAT_SOA, mass=0.4, key=7, dtype=jnp.complex64)
    op_s = wilson_operator(LAT_SOA, mass=0.4, key=7, dtype=jnp.complex64,
                           layout="soa")
    rng = np.random.default_rng(5)
    shape = LAT_SOA + (4, 3, 2)
    x = cplx.CArray(
        jnp.asarray(rng.standard_normal(shape), jnp.float32),
        jnp.asarray(rng.standard_normal(shape), jnp.float32),
    )
    ya = bsr_krylov(1.0, op_a, x, "xyztSCn")
    ys = bsr_krylov(1.0, op_s, x, "xyztSCn")
    np.testing.assert_allclose(np.asarray(ys.re), np.asarray(ya.re),
                               rtol=2e-4, atol=2e-4)


def test_wilson_action_is_differentiable():
    """BEYOND-REFERENCE capability: jax.grad flows through the operator
    application, giving the gauge-force derivative d/dU Re<psi, D psi>
    of HMC for free (the reference is not differentiable; its consumers
    hand-code forces).  Verified against a finite difference."""
    from superbblas_tpu.bsr import BSROperator, bsr_krylov

    op = wilson_operator((4, 4, 2, 2), mass=0.2, key=1,
                         dtype=jnp.complex128)
    rng = np.random.default_rng(0)
    shape = (4, 4, 2, 2, 4, 3, 1)
    psi = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                      jnp.asarray(rng.standard_normal(shape)))

    def action(blocks):
        op2 = dataclasses.replace(op, blocks=blocks)
        dpsi = bsr_krylov(1.0, op2, psi, "xyztSCn")
        return jnp.sum(dpsi.re * psi.re + dpsi.im * psi.im)

    g = jax.grad(action)(op.blocks)
    assert bool(jnp.isfinite(g.re).all())
    eps = 1e-6
    idx = (1, 2, 0, 1, 3, 0, 1)
    bp = cplx.CArray(op.blocks.re.at[idx].add(eps), op.blocks.im)
    fd = float((action(bp) - action(op.blocks)) / eps)
    assert abs(fd - float(g.re[idx])) < 1e-4, (fd, float(g.re[idx]))


@pytest.mark.parametrize("layout", ["aos", "soa"])
def test_adjoint_then_rebuild(layout):
    """Taking the adjoint and then rebuilding the operator with new
    blocks must not hand back the old operator's adjoint."""
    import gc

    from superbblas_tpu.models import wilson as W

    op = wilson_operator((2, 2, 4, 8), mass=0.3, key=8, layout=layout)
    adj = W.adjoint_operator(op)
    assert W.adjoint_operator(op) is adj          # memoized
    op2 = dataclasses.replace(
        op, blocks=cplx.cmap(lambda a: 2.0 * a, op.blocks))
    adj2 = W.adjoint_operator(op2)
    assert adj2 is not adj
    np.testing.assert_allclose(np.asarray(adj2.blocks.re),
                               2.0 * np.asarray(adj.blocks.re))
    np.testing.assert_allclose(np.asarray(adj2.blocks.im),
                               2.0 * np.asarray(adj.blocks.im))
    # the side table lets go of an operator that is gone
    key = id(op2)
    del op2, adj2
    gc.collect()
    assert key not in W._ADJOINTS
