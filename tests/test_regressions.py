"""Regression cases (the reference's `known_issues` target,
tests/Makefile:126-132): bugs found on real hardware, pinned so they
stay fixed."""

import jax
import jax.numpy as jnp
import numpy as np

from superbblas_tpu import cplx, flags


def test_ndir_correct_for_soa_layout():
    """BSROperator.ndir read a lattice dimension for SoA-layout operators
    (blocks are [ndir, BI*BD, *lat], not [*lat, ndir, BI, BD]), inflating
    the benchmark flop model by 16/9 on the canonical lattice."""
    from superbblas_tpu.models import wilson_operator

    lat = (8, 8, 8, 128)
    aos = wilson_operator(lat, mass=0.1, key=0)
    soa = wilson_operator(lat, mass=0.1, key=0, layout="soa")
    assert aos.ndir == 9
    assert soa.ndir == 9
    assert aos.flops_per_matvec(8) == soa.flops_per_matvec(8)


def test_f32_matmul_precision_defaults_highest(monkeypatch):
    """f32 contractions must not run at reduced default precision (TF32
    on the GPU); the default must stay HIGHEST for reference parity."""
    assert flags.get_matmul_precision() == "highest"
    assert cplx.default_precision() == jax.lax.Precision.HIGHEST
    monkeypatch.setenv("SBT_MATMUL_PRECISION", "default")
    flags.clear_cache()
    try:
        assert cplx.default_precision() == jax.lax.Precision.DEFAULT
    finally:
        flags.clear_cache()


def test_spin_factorization_finds_wilson_rank2():
    """The kernel's compile-time spin-factor plan must keep detecting the
    rank-2 structure of the Wilson hopping factors (the half-spinor
    projection that halves color FLOPs) and reproduce K = R P exactly."""
    from superbblas_tpu.models import wilson_operator
    from superbblas_tpu.ops.stencil_pallas import _factor_kron

    op = wilson_operator((4, 4, 8, 128), mass=0.1, key=0, layout="soa")
    spec = _factor_kron(op.kron.re, op.kron.im)
    modes = [sp[0] for sp in spec]
    assert modes[0] == "direct" and all(m == "factored" for m in modes[1:])
    K = np.asarray(op.kron.re) + 1j * np.asarray(op.kron.im)
    for d, sp in enumerate(spec):
        if sp[0] != "factored":
            continue
        prows, rrows = sp[1], sp[2]
        rank = len(prows)
        P = np.zeros((rank, K.shape[2]), complex)
        for c, row in enumerate(prows):
            for (s, re, im) in row:
                P[c, s] = re + 1j * im
        R = np.zeros((K.shape[1], rank), complex)
        for r, row in enumerate(rrows):
            for (c, re, im) in row:
                R[r, c] = re + 1j * im
        np.testing.assert_allclose(R @ P, K[d], atol=1e-6)
        assert rank == 2


def test_yc1_boundary_rows():
    """Y-only stencil across the Y wrap (the boundary rows that once
    needed a special case) through the kernel in the interpreter."""
    from superbblas_tpu.ops import stencil_pallas as m

    rng = np.random.default_rng(0)
    lat = (2, 3, 4, 8)

    def carr(shape):
        return cplx.CArray(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                           jnp.asarray(rng.standard_normal(shape), jnp.float32))

    offs = [(0, 1, 0, 0), (0, -1, 0, 0)]
    blocks = carr((2, 4) + lat)
    x = carr((1, 2) + lat)
    y = m.stencil_matvec_soa(blocks, None, x, offs, 2, 2, interpret=True)
    r = m.stencil_matvec_soa_reference(blocks, None, x, offs, 2, 2)
    np.testing.assert_allclose(np.asarray(y.re), np.asarray(r.re),
                               atol=1e-4)
