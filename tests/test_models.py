"""Staggered / clover / even-odd model families.

Oracles are algebraic identities (the reference's dense.cpp style:
round-trips and structure checks) plus dense materializations on tiny
lattices.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from superbblas_tpu import cplx
from superbblas_tpu.models import (
    apply_clover,
    apply_staggered,
    apply_wilson,
    eo_solve,
    eta_phases,
    gamma_matrices,
    staggered_operator,
    wilson_clover_operator,
    wilson_operator,
)


def materialize(apply_fn, lat, blk_shape):
    """Dense matrix of a lattice operator by applying it to a basis batch.
    Returns [V*blk, V*blk] complex numpy (column j = A e_j)."""
    blk = int(np.prod(blk_shape))
    V = int(np.prod(lat))
    n = V * blk
    eye = np.eye(n).reshape(lat + tuple(blk_shape) + (n,))
    x = cplx.CArray(jnp.asarray(eye), jnp.zeros_like(jnp.asarray(eye)))
    y = apply_fn(x)
    out = np.asarray(y.re) + 1j * np.asarray(y.im)
    return out.reshape(n, n)


def test_eta_phases():
    eta = eta_phases((4, 4))
    assert (eta[0] == 1).all()                       # eta_0 = 1 always
    assert eta[1][1, 0] == -1 and eta[1][2, 0] == 1  # (-1)^x


def test_staggered_antihermitian_hopping():
    """D + D^H = 2m I (the hopping part is anti-Hermitian)."""
    lat, m = (4, 4), 0.25
    op = staggered_operator(lat, mass=m, key=1, dtype=jnp.complex128)
    D = materialize(lambda x: apply_staggered(op, x), lat, (3,))
    np.testing.assert_allclose(D + D.conj().T, 2 * m * np.eye(D.shape[0]),
                               atol=1e-12)


def test_staggered_matches_numpy_oracle():
    lat, m = (4, 2), 0.3
    rng = np.random.default_rng(3)
    from superbblas_tpu.models.wilson import random_su3_links

    links = random_su3_links(rng, lat)
    op = staggered_operator(lat, mass=m, links=links, dtype=jnp.complex128)
    eta = eta_phases(lat)
    x = rng.standard_normal(lat + (3, 2)) + 1j * rng.standard_normal(lat + (3, 2))

    y = np.zeros_like(x)
    for s in itertools.product(*[range(d) for d in lat]):
        y[s] = m * x[s]
        for mu in range(2):
            fwd = tuple((c + (1 if a == mu else 0)) % d
                        for a, (c, d) in enumerate(zip(s, lat)))
            bwd = tuple((c - (1 if a == mu else 0)) % d
                        for a, (c, d) in enumerate(zip(s, lat)))
            y[s] += 0.5 * eta[mu][s] * (links[mu][s] @ x[fwd]
                                        - links[mu][bwd].conj().T @ x[bwd])

    got = apply_staggered(op, cplx.from_complex(jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(got.re) + 1j * np.asarray(got.im),
                               y, rtol=1e-12, atol=1e-12)


def test_clover_blocks_hermitian():
    lat = (2, 2, 2, 2)
    op = wilson_clover_operator(lat, mass=0.1, c_sw=1.3, key=2,
                                dtype=jnp.complex128)
    blk = np.asarray(op.clover.blocks.re) + 1j * np.asarray(op.clover.blocks.im)
    blk = blk.reshape(-1, 12, 12)
    np.testing.assert_allclose(blk, np.swapaxes(blk, -1, -2).conj(),
                               atol=1e-12)


def test_clover_gamma5_hermiticity():
    """gamma5 D gamma5 = D^H holds for Wilson-clover (the defining
    symmetry; it requires the clover term to be built consistently)."""
    lat = (2, 2, 2, 2)
    op = wilson_clover_operator(lat, mass=0.15, c_sw=0.9, key=4,
                                dtype=jnp.complex128)
    D = materialize(lambda x: apply_clover(op, x), lat, (4, 3))
    g = gamma_matrices()
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    G5 = np.kron(np.eye(D.shape[0] // 12), np.kron(g5, np.eye(3)))
    np.testing.assert_allclose(G5 @ D @ G5, D.conj().T, atol=1e-10)


def test_clover_reduces_to_wilson():
    lat = (2, 2, 2, 2)
    rng = np.random.default_rng(0)
    from superbblas_tpu.models.wilson import random_su3_links

    links = random_su3_links(rng, lat)
    opc = wilson_clover_operator(lat, mass=0.1, c_sw=0.0, links=links,
                                 dtype=jnp.complex128)
    opw = wilson_operator(lat, mass=0.1, links=links, dtype=jnp.complex128)
    shape = lat + (4, 3, 2)
    x = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))
    yc = apply_clover(opc, x)
    yw = apply_wilson(opw, x)
    np.testing.assert_allclose(np.asarray(yc.re), np.asarray(yw.re),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(yc.im), np.asarray(yw.im),
                               atol=1e-12)


def test_eo_solve_residual():
    lat, m, r = (4, 4, 2, 2), 0.4, 1.0
    op = wilson_operator(lat, mass=m, r=r, key=5, dtype=jnp.complex128)
    rng = np.random.default_rng(8)
    shape = lat + (4, 3, 1)
    b = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    psi, _ = eo_solve(op, b, a=m + 4 * r, n_iters=60)
    res = apply_wilson(op, psi)
    dre = np.asarray(res.re) - np.asarray(b.re)
    dim_ = np.asarray(res.im) - np.asarray(b.im)
    rel = np.sqrt((dre ** 2 + dim_ ** 2).sum()
                  / (np.asarray(b.re) ** 2 + np.asarray(b.im) ** 2).sum())
    assert rel < 1e-8, rel


def test_coarse_operator_hermitian_and_sharded():
    """Coarse operator: Hermitian by construction; matvec agrees between
    dense numpy and the stencil path, replicated or lattice-sharded."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from superbblas_tpu import parallel as par
    from superbblas_tpu.models import apply_coarse, coarse_operator

    lat, nc = (4, 4), 8
    op = coarse_operator(lat, block_size=nc, mass=0.2, key=3,
                         dtype=jnp.complex128)
    D = materialize(lambda x: apply_coarse(op, x), lat, (nc,))
    np.testing.assert_allclose(D, D.conj().T, atol=1e-12)

    rng = np.random.default_rng(1)
    x = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (nc, 3))),
                    jnp.asarray(rng.standard_normal(lat + (nc, 3))))
    y0 = apply_coarse(op, x)
    mesh = par.make_mesh({"X": 4, "Y": 2})
    xs = jax.device_put(x, NamedSharding(mesh, P("X", "Y", None, None)))
    y1 = apply_coarse(op, xs)
    np.testing.assert_allclose(np.asarray(y1.re), np.asarray(y0.re),
                               atol=1e-12)


def test_multihost_mesh_single_process():
    from superbblas_tpu.parallel import make_multihost_mesh

    mesh = make_multihost_mesh({"x": 4, "n": 2})
    assert mesh.shape == {"x": 4, "n": 2}
    with pytest.raises(ValueError, match="device count"):
        make_multihost_mesh({"x": 16})


def test_cb_pack_unpack_roundtrip():
    from superbblas_tpu.models.eo_packed import cb_pack, cb_unpack

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((8, 4, 2, 6, 3)))  # lat (8,4,2,6)+1
    ae = cb_pack(a, 4, 0)
    ao = cb_pack(a, 4, 1)
    assert ae.shape == (4, 4, 2, 6, 3)
    back = cb_unpack(ae, ao, 4)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(a))


def test_packed_hopping_matches_masked():
    from superbblas_tpu.models import checkerboard_masks, wilson_operator
    from superbblas_tpu.models.eo_packed import (
        apply_hopping_packed,
        cb_pack,
        hopping_packed,
    )

    lat, m, r = (4, 4, 2, 2), 0.3, 1.0
    op = wilson_operator(lat, mass=m, r=r, key=7, dtype=jnp.complex128)
    rng = np.random.default_rng(1)
    shape = lat + (4, 3, 2)
    x = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))
    even, odd = checkerboard_masks(lat, 3)
    a = m + 4 * r

    # masked H_eo: P_e (D - aI) P_o x
    x_o = cplx.CArray(odd * x.re, odd * x.im)
    hx = cplx.add(apply_wilson(op, x_o), cplx.scale(-a, x_o))
    want = cplx.CArray(even * hx.re, even * hx.im)

    hop_e = hopping_packed(op, 0)
    got_packed = apply_hopping_packed(hop_e, cb_pack(x, 4, 1), 0)
    want_packed = cb_pack(want, 4, 0)
    np.testing.assert_allclose(np.asarray(got_packed.re),
                               np.asarray(want_packed.re), atol=1e-12)
    np.testing.assert_allclose(np.asarray(got_packed.im),
                               np.asarray(want_packed.im), atol=1e-12)


def test_eo_solve_packed_residual():
    from superbblas_tpu.models.eo_packed import eo_solve_packed

    lat, m, r = (4, 4, 2, 2), 0.4, 1.0
    op = wilson_operator(lat, mass=m, r=r, key=5, dtype=jnp.complex128)
    rng = np.random.default_rng(8)
    shape = lat + (4, 3, 1)
    b = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    psi, _ = eo_solve_packed(op, b, a=m + 4 * r, n_iters=60)
    res = apply_wilson(op, psi)
    rel = np.sqrt(
        ((np.asarray(res.re) - np.asarray(b.re)) ** 2
         + (np.asarray(res.im) - np.asarray(b.im)) ** 2).sum()
        / (np.asarray(b.re) ** 2 + np.asarray(b.im) ** 2).sum())
    assert rel < 1e-8, rel


def test_packed_soa_hopping_matches_aos():
    """SoA packed hopping (Pallas parity-select path; XLA fallback on
    CPU) equals the AoS packed hopping."""
    from superbblas_tpu.models.eo_packed import (
        apply_hopping_packed,
        apply_hopping_packed_soa,
        cb_pack,
        cb_pack_soa,
        cb_unpack_soa,
        hopping_packed,
        hopping_packed_soa,
    )
    from superbblas_tpu.ops.stencil_pallas import aos_to_soa, soa_to_aos

    lat = (4, 4, 8, 128)
    op_aos = wilson_operator(lat, mass=0.3, key=9, dtype=jnp.complex64)
    op_soa = wilson_operator(lat, mass=0.3, key=9, dtype=jnp.complex64,
                             layout="soa")
    rng = np.random.default_rng(2)
    xs = cplx.CArray(
        jnp.asarray(rng.standard_normal((2, 12) + lat), jnp.float32),
        jnp.asarray(rng.standard_normal((2, 12) + lat), jnp.float32))
    # AoS oracle: canonical [*lat, KD, BD, N]
    x_aos = soa_to_aos(xs, 4, 4, 3)  # [*lat, 4, 3, 2]
    hop_e = hopping_packed(op_aos, 0)
    want = apply_hopping_packed(hop_e, cb_pack(x_aos, 4, 1), 0)

    hop_e_soa = hopping_packed_soa(op_soa, 0)
    got_soa = apply_hopping_packed_soa(hop_e_soa, cb_pack_soa(xs, 1), 0)
    got = soa_to_aos(got_soa, 4, 4, 3)
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                               rtol=2e-4, atol=2e-4)


def test_cb_pack_soa_roundtrip():
    from superbblas_tpu.models.eo_packed import cb_pack_soa, cb_unpack_soa

    rng = np.random.default_rng(1)
    a = cplx.CArray(jnp.asarray(rng.standard_normal((2, 3, 4, 4, 2, 6))),
                    jnp.asarray(rng.standard_normal((2, 3, 4, 4, 2, 6))))
    ae, ao = cb_pack_soa(a, 0), cb_pack_soa(a, 1)
    back = cb_unpack_soa(ae, ao)
    np.testing.assert_array_equal(np.asarray(back.re), np.asarray(a.re))


def test_eo_solve_packed_soa_residual():
    from superbblas_tpu.models import eo_solve_packed_soa
    from superbblas_tpu.ops.stencil_pallas import aos_to_soa, soa_to_aos

    lat, m, r = (4, 4, 8, 128), 0.4, 1.0
    op = wilson_operator(lat, mass=m, r=r, key=5, dtype=jnp.complex64,
                         layout="soa")
    op_aos = wilson_operator(lat, mass=m, r=r, key=5, dtype=jnp.complex64)
    rng = np.random.default_rng(8)
    b = cplx.CArray(
        jnp.asarray(rng.standard_normal((1, 12) + lat), jnp.float32),
        jnp.asarray(rng.standard_normal((1, 12) + lat), jnp.float32))

    psi, _ = eo_solve_packed_soa(op, b, a=m + 4 * r, n_iters=200)
    psi_aos = soa_to_aos(psi, 4, 4, 3)
    b_aos = soa_to_aos(b, 4, 4, 3)
    res = apply_wilson(op_aos, psi_aos)
    rel = np.sqrt(
        ((np.asarray(res.re) - np.asarray(b_aos.re)) ** 2
         + (np.asarray(res.im) - np.asarray(b_aos.im)) ** 2).sum()
        / (np.asarray(b_aos.re) ** 2 + np.asarray(b_aos.im) ** 2).sum())
    assert rel < 2e-3, rel   # f32 CG on a 4^2x8x128 lattice


def test_staggered_packed_hopping():
    """The packed machinery is operator-generic: staggered (non-kron)
    hopping between packings matches the masked application."""
    from superbblas_tpu.models import checkerboard_masks
    from superbblas_tpu.models.eo_packed import (
        apply_hopping_packed,
        cb_pack,
        hopping_packed,
    )

    lat, m = (4, 4), 0.3
    op = staggered_operator(lat, mass=m, key=6, dtype=jnp.complex128)
    rng = np.random.default_rng(4)
    x = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (3, 2))),
                    jnp.asarray(rng.standard_normal(lat + (3, 2))))
    even, odd = checkerboard_masks(lat, 2)
    x_o = cplx.CArray(odd * x.re, odd * x.im)
    hx = cplx.add(apply_staggered(op, x_o), cplx.scale(-m, x_o))
    want = cb_pack(cplx.CArray(even * hx.re, even * hx.im), 2, 0)

    hop_e = hopping_packed(op, 0)
    got = apply_hopping_packed(hop_e, cb_pack(x, 2, 1), 0)
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                               atol=1e-12)


def test_worked_example_runs():
    """examples/wilson_workflow.py end-to-end on the test mesh."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "wilson_workflow.py")
    spec = importlib.util.spec_from_file_location("wilson_workflow", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rel = mod.main(lat=(4, 4, 2, 2), iters=60)
    assert rel < 1e-6


def test_twisted_mass_operator():
    """D_tm = D_W + i mu gamma5: verified against adding the twist term
    explicitly, and gamma5-hermiticity maps D_tm(mu) -> D_tm(-mu)^H."""
    from superbblas_tpu.models.wilson import twisted_mass_operator

    lat, m, mu = (2, 2, 2, 2), 0.2, 0.07
    rng = np.random.default_rng(0)
    from superbblas_tpu.models.wilson import random_su3_links

    links = random_su3_links(rng, lat)
    op_w = wilson_operator(lat, mass=m, links=links, dtype=jnp.complex128)
    op_tm = twisted_mass_operator(lat, mass=m, mu=mu, links=links,
                                  dtype=jnp.complex128)

    x = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (4, 3, 2))),
                    jnp.asarray(rng.standard_normal(lat + (4, 3, 2))))
    y_tm = apply_wilson(op_tm, x)
    y_w = apply_wilson(op_w, x)
    g = gamma_matrices()
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    xg = np.asarray(x.re) + 1j * np.asarray(x.im)
    tw = mu * 1j * np.einsum("st,...tcn->...scn", g5, xg)
    want = (np.asarray(y_w.re) + 1j * np.asarray(y_w.im)) + tw
    np.testing.assert_allclose(np.asarray(y_tm.re) + 1j * np.asarray(y_tm.im),
                               want, atol=1e-12)

    # gamma5 D_tm(mu) gamma5 = D_tm(-mu)^H
    D_p = materialize(lambda v: apply_wilson(op_tm, v), lat, (4, 3))
    op_tm_m = twisted_mass_operator(lat, mass=m, mu=-mu, links=links,
                                    dtype=jnp.complex128)
    D_m = materialize(lambda v: apply_wilson(op_tm_m, v), lat, (4, 3))
    G5 = np.kron(np.eye(D_p.shape[0] // 12), np.kron(g5, np.eye(3)))
    np.testing.assert_allclose(G5 @ D_p @ G5, D_m.conj().T, atol=1e-10)


def test_domain_wall_reduces_to_wilson_at_ls1():
    """Ls=1 DWF: both s5 wrap links land on the center, so D_dw equals
    the Wilson operator at mass (1 - M5 + m_f)."""
    from superbblas_tpu.models import apply_domain_wall, domain_wall_operator

    lat, M5, mf = (2, 2, 2, 2), 1.3, 0.07
    rng = np.random.default_rng(0)
    from superbblas_tpu.models.wilson import random_su3_links

    links = random_su3_links(rng, lat)
    dw = domain_wall_operator(lat, Ls=1, M5=M5, m_f=mf, links=links)
    w = wilson_operator(lat, mass=1.0 - M5 + mf, links=links,
                        dtype=jnp.complex128)
    x = cplx.CArray(jnp.asarray(rng.standard_normal((1,) + lat + (4, 3, 2))),
                    jnp.asarray(rng.standard_normal((1,) + lat + (4, 3, 2))))
    y_dw = apply_domain_wall(dw, x)
    y_w = apply_wilson(w, cplx.cmap(lambda a: a[0], x))
    np.testing.assert_allclose(np.asarray(y_dw.re[0]), np.asarray(y_w.re),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(y_dw.im[0]), np.asarray(y_w.im),
                               atol=1e-12)


def test_domain_wall_r5g5_hermiticity():
    """Gamma5 R5 D R5 Gamma5 = D^H — the defining DWF symmetry (R5
    reflects the fifth dimension)."""
    from superbblas_tpu.models import apply_domain_wall, domain_wall_operator

    lat, Ls = (2, 2, 2, 2), 4
    dw = domain_wall_operator(lat, Ls=Ls, M5=1.6, m_f=0.1, key=2)

    V = Ls * int(np.prod(lat))
    n = V * 12
    eye = np.eye(n).reshape((Ls,) + lat + (4, 3, n))
    x = cplx.CArray(jnp.asarray(eye), jnp.zeros_like(jnp.asarray(eye)))
    y = apply_domain_wall(dw, x)
    D = (np.asarray(y.re) + 1j * np.asarray(y.im)).reshape(n, n)

    g = gamma_matrices()
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    R5 = np.zeros((Ls, Ls))
    R5[np.arange(Ls), Ls - 1 - np.arange(Ls)] = 1.0
    S = np.kron(R5, np.kron(np.eye(int(np.prod(lat))),
                            np.kron(g5, np.eye(3))))
    np.testing.assert_allclose(S @ D @ S, D.conj().T, atol=1e-10)


def test_eo_packed_bf16_storage():
    """bf16-stored operators flow through the packed even-odd pipeline
    (hopping slices keep the storage dtype; the kernel accumulates f32):
    matches the f32 hopping to operand rounding."""
    from superbblas_tpu.bsr import bsr_cast_storage
    from superbblas_tpu.models import wilson_operator
    from superbblas_tpu.models.eo_packed import (apply_hopping_packed_soa,
                                                 cb_pack_soa,
                                                 hopping_packed_soa)

    lat = (4, 4, 8, 128)
    op = wilson_operator(lat, mass=0.1, key=0, dtype=jnp.complex64,
                         layout="soa")
    op16 = bsr_cast_storage(op, jnp.bfloat16)
    rng = np.random.default_rng(0)
    shape = (2, 12) + lat
    x = cplx.CArray(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                    jnp.asarray(rng.standard_normal(shape), jnp.float32))
    xe = cb_pack_soa(x, 0)
    xe16 = cplx.CArray(xe.re.astype(jnp.bfloat16),
                       xe.im.astype(jnp.bfloat16))
    hop = hopping_packed_soa(op, 1)
    hop16 = hopping_packed_soa(op16, 1)
    assert hop16.blocks.re.dtype == jnp.bfloat16
    y32 = apply_hopping_packed_soa(hop, xe, 1)
    y16 = apply_hopping_packed_soa(hop16, xe16, 1)
    num = float(jnp.sqrt(jnp.sum(
        (y16.re.astype(jnp.float32) - y32.re) ** 2
        + (y16.im.astype(jnp.float32) - y32.im) ** 2)))
    den = float(jnp.sqrt(jnp.sum(y32.re ** 2 + y32.im ** 2)))
    assert num / den < 0.05, num / den


def test_clover_soa_matches_aos():
    """layout='soa' clover: BOTH terms (Pallas Wilson kernel + the
    center-only 12x12 clover stencil) on the same SoA operand equal the
    AoS path."""
    from superbblas_tpu.models import apply_clover, wilson_clover_operator
    from superbblas_tpu.ops.stencil_pallas import aos_to_soa, soa_to_aos

    lat = (2, 2, 8, 128)
    op_a = wilson_clover_operator(lat, mass=0.3, c_sw=1.2, key=2,
                                  dtype=jnp.complex64)
    op_s = wilson_clover_operator(lat, mass=0.3, c_sw=1.2, key=2,
                                  dtype=jnp.complex64, layout="soa")
    assert op_s.hop.mode == "stencil_soa"
    assert op_s.clover.mode == "stencil_soa"
    rng = np.random.default_rng(0)
    shape = lat + (4, 3, 2)
    x = cplx.CArray(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                    jnp.asarray(rng.standard_normal(shape), jnp.float32))
    y_aos = apply_clover(op_a, x)
    y_soa = apply_clover(op_s, aos_to_soa(x, 4))
    y_back = soa_to_aos(y_soa, 4, 4, 3)
    np.testing.assert_allclose(np.asarray(y_back.re), np.asarray(y_aos.re),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(y_back.im), np.asarray(y_aos.im),
                               rtol=3e-4, atol=3e-4)


def test_clover_soa_kernel_interpret():
    """The 144-channel center-only clover configuration through the
    Pallas kernel in the interpreter (the oracle tests run the CPU XLA
    reference)."""
    from superbblas_tpu.bsr import apply_stencil_soa
    from superbblas_tpu.models import wilson_clover_operator
    from superbblas_tpu.ops.stencil_pallas import aos_to_soa

    lat = (2, 2, 4, 8)
    op = wilson_clover_operator(lat, mass=0.3, c_sw=1.2, key=2,
                                dtype=jnp.complex64, layout="soa")
    rng = np.random.default_rng(1)
    shape = lat + (4, 3, 1)
    x = aos_to_soa(cplx.CArray(
        jnp.asarray(rng.standard_normal(shape), jnp.float32),
        jnp.asarray(rng.standard_normal(shape), jnp.float32)), 4)
    want = apply_stencil_soa(op.clover, x)            # XLA reference
    got = apply_stencil_soa(op.clover, x, interpret=True)  # Pallas kernel
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                               rtol=2e-4, atol=2e-4)


def test_domain_wall_soa_matches_aos():
    """Domain-wall on the SoA hot path (Ls folded into the Pallas
    kernel's columns + elementwise s5 projector walls) equals the
    generic 5D AoS stencil."""
    from superbblas_tpu.models import apply_domain_wall, domain_wall_operator
    from superbblas_tpu.models.domain_wall import DomainWallSoAOperator

    lat = (2, 2, 8, 128)
    Ls = 4
    op_a = domain_wall_operator(lat, Ls=Ls, M5=1.8, m_f=0.1, key=5,
                                dtype=jnp.complex64)
    op_s = domain_wall_operator(lat, Ls=Ls, M5=1.8, m_f=0.1, key=5,
                                dtype=jnp.complex64, layout="soa")
    assert isinstance(op_s, DomainWallSoAOperator)

    rng = np.random.default_rng(0)
    n = 2
    shape_aos = (Ls,) + lat + (4, 3, n)
    x = rng.standard_normal(shape_aos).astype(np.float32)
    xi = rng.standard_normal(shape_aos).astype(np.float32)
    xC = cplx.CArray(jnp.asarray(x), jnp.asarray(xi))
    y_aos = apply_domain_wall(op_a, xC)

    # AoS [Ls, X, Y, Z, T, S, C, n] -> SoA [n, Ls, S*C, X, Y, Z, T]
    def to_soa(a):
        a = jnp.transpose(a, (7, 0, 5, 6, 1, 2, 3, 4))
        return a.reshape(n, Ls, 12, *lat)
    x_soa = cplx.cmap(to_soa, xC)
    y_soa = apply_domain_wall(op_s, x_soa)

    def from_soa(a):
        a = a.reshape(n, Ls, 4, 3, *lat)
        return jnp.transpose(a, (1, 4, 5, 6, 7, 2, 3, 0))
    y_back = cplx.cmap(from_soa, y_soa)
    np.testing.assert_allclose(np.asarray(y_back.re), np.asarray(y_aos.re),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(y_back.im), np.asarray(y_aos.im),
                               rtol=3e-4, atol=3e-4)
    assert op_s.flops_per_matvec(n) > 0


def test_mobius_reduces_to_shamir():
    """Moebius at b5=1, c5=0 IS Shamir: the 27-offset AoS stencil (the
    corner couplings vanish with c5=0) must equal domain_wall_operator's
    11-offset form on random operands."""
    from superbblas_tpu.models import (apply_domain_wall,
                                       domain_wall_operator,
                                       mobius_operator)
    from superbblas_tpu.models.wilson import random_su3_links

    lat = (2, 2, 2, 4)
    Ls = 4
    rng = np.random.default_rng(8)
    links = random_su3_links(rng, lat)
    dw = domain_wall_operator(lat, Ls=Ls, M5=1.7, m_f=0.08, links=links)
    mb = mobius_operator(lat, Ls=Ls, M5=1.7, m_f=0.08, b5=1.0, c5=0.0,
                         links=links)
    x = rng.standard_normal((Ls,) + lat + (4, 3, 2)) \
        + 1j * rng.standard_normal((Ls,) + lat + (4, 3, 2))
    y_dw = apply_domain_wall(dw, jnp.asarray(x))
    y_mb = apply_domain_wall(mb, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y_mb), np.asarray(y_dw),
                               rtol=1e-10, atol=1e-10)


def test_mobius_r5g5_adjoint_pair():
    """Moebius with c5 != 0 is NOT gamma5-R5-hermitian by itself (the
    D_W Lambda cross-term does not commute through P_-+ — this is why
    production codes implement Mdag explicitly); the true identity is
    that the two projector orderings are adjoint partners:
    (Gamma5 R5) D_right (Gamma5 R5) = D_left^H."""
    from superbblas_tpu.models import apply_domain_wall, mobius_operator
    from superbblas_tpu.models.wilson import gamma_matrices, random_su3_links

    lat, Ls = (2, 2, 2, 2), 4
    rng = np.random.default_rng(3)
    links = random_su3_links(rng, lat)
    kw = dict(Ls=Ls, M5=1.6, m_f=0.1, b5=1.4, c5=0.4, links=links)
    m_r = mobius_operator(lat, **kw)
    m_l = mobius_operator(lat, projector_side="left", **kw)

    V = Ls * int(np.prod(lat))
    n = V * 12
    eye = np.eye(n).reshape((Ls,) + lat + (4, 3, n))
    x = cplx.CArray(jnp.asarray(eye), jnp.zeros_like(jnp.asarray(eye)))

    def mat(op):
        y = apply_domain_wall(op, x)
        return (np.asarray(y.re) + 1j * np.asarray(y.im)).reshape(n, n)

    Dr, Dl = mat(m_r), mat(m_l)
    g = gamma_matrices()
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    R5 = np.zeros((Ls, Ls))
    R5[np.arange(Ls), Ls - 1 - np.arange(Ls)] = 1.0
    S = np.kron(R5, np.kron(np.eye(int(np.prod(lat))),
                            np.kron(g5, np.eye(3))))
    np.testing.assert_allclose(S @ Dr @ S, Dl.conj().T, atol=1e-10)
    # and the naive symmetry really is broken at c5 != 0
    assert np.abs(S @ Dr @ S - Dr.conj().T).max() > 1e-3


def test_mobius_soa_matches_aos():
    """Moebius on the SoA hot path — ONE Wilson kernel call via
    D_M = D_W(b5 x + c5 Hx) + x - Hx — equals the 27-offset AoS
    stencil."""
    from superbblas_tpu.models import apply_domain_wall, mobius_operator
    from superbblas_tpu.models.domain_wall import DomainWallSoAOperator
    from superbblas_tpu.models.wilson import random_su3_links

    lat = (2, 2, 8, 128)
    Ls = 4
    rng = np.random.default_rng(9)
    links = random_su3_links(rng, lat)
    op_a = mobius_operator(lat, Ls=Ls, M5=1.8, m_f=0.1, b5=1.5, c5=0.5,
                           links=links, dtype=jnp.complex64)
    op_s = mobius_operator(lat, Ls=Ls, M5=1.8, m_f=0.1, b5=1.5, c5=0.5,
                           links=links, dtype=jnp.complex64,
                           layout="soa")
    assert isinstance(op_s, DomainWallSoAOperator) and op_s.mobius

    n = 2
    shape_aos = (Ls,) + lat + (4, 3, n)
    x = rng.standard_normal(shape_aos).astype(np.float32)
    xi = rng.standard_normal(shape_aos).astype(np.float32)
    xC = cplx.CArray(jnp.asarray(x), jnp.asarray(xi))
    y_aos = apply_domain_wall(op_a, xC)

    def to_soa(a):
        a = jnp.transpose(a, (7, 0, 5, 6, 1, 2, 3, 4))
        return a.reshape(n, Ls, 12, *lat)
    x_soa = cplx.cmap(to_soa, xC)
    y_soa = apply_domain_wall(op_s, x_soa)

    def from_soa(a):
        a = a.reshape(n, Ls, 4, 3, *lat)
        return jnp.transpose(a, (1, 4, 5, 6, 7, 2, 3, 0))
    y_back = cplx.cmap(from_soa, y_soa)
    np.testing.assert_allclose(np.asarray(y_back.re), np.asarray(y_aos.re),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(y_back.im), np.asarray(y_aos.im),
                               rtol=3e-4, atol=3e-4)


def test_mobius_left_soa_matches_aos():
    """The LEFT (dagger-partner) projector ordering on the hot path:
    one kernel call via D_M x = b5 u + x + H(c5 u - x), u = D_W x."""
    from superbblas_tpu.models import apply_domain_wall, mobius_operator
    from superbblas_tpu.models.wilson import random_su3_links

    lat = (2, 2, 8, 128)
    Ls = 4
    rng = np.random.default_rng(13)
    links = random_su3_links(rng, lat)
    kw = dict(Ls=Ls, M5=1.8, m_f=0.1, b5=1.5, c5=0.5, links=links,
              dtype=jnp.complex64, projector_side="left")
    op_a = mobius_operator(lat, **kw)
    op_s = mobius_operator(lat, layout="soa", **kw)

    n = 2
    shape_aos = (Ls,) + lat + (4, 3, n)
    x = rng.standard_normal(shape_aos).astype(np.float32)
    xi = rng.standard_normal(shape_aos).astype(np.float32)
    xC = cplx.CArray(jnp.asarray(x), jnp.asarray(xi))
    y_aos = apply_domain_wall(op_a, xC)

    def to_soa(a):
        a = jnp.transpose(a, (7, 0, 5, 6, 1, 2, 3, 4))
        return a.reshape(n, Ls, 12, *lat)
    y_soa = apply_domain_wall(op_s, cplx.cmap(to_soa, xC))

    def from_soa(a):
        a = a.reshape(n, Ls, 4, 3, *lat)
        return jnp.transpose(a, (1, 4, 5, 6, 7, 2, 3, 0))
    y_back = cplx.cmap(from_soa, y_soa)
    np.testing.assert_allclose(np.asarray(y_back.re), np.asarray(y_aos.re),
                               rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(y_back.im), np.asarray(y_aos.im),
                               rtol=3e-4, atol=3e-4)


def test_mobius_cgne_solve_via_adjoint_pair():
    """Production-style Moebius solve: cgne needs D^H, which the
    adjoint-pair identity supplies as (Gamma5 R5) D_left (Gamma5 R5) —
    the residual of D_right x = b must converge, proving the dagger
    machinery is solver-usable end to end."""
    from superbblas_tpu.models import apply_domain_wall, mobius_operator
    from superbblas_tpu.models.wilson import gamma_matrices, random_su3_links
    from superbblas_tpu.solvers import cgne

    lat, Ls = (2, 2, 2, 4), 4
    rng = np.random.default_rng(19)
    links = random_su3_links(rng, lat)
    kw = dict(Ls=Ls, M5=1.4, m_f=0.3, b5=1.5, c5=0.5, links=links)
    Dr = mobius_operator(lat, **kw)
    Dl = mobius_operator(lat, projector_side="left", **kw)
    g = gamma_matrices()
    # g5 is real in this (chiral) basis; keep the split-complex parts real
    g5 = jnp.asarray(np.real(g[0] @ g[1] @ g[2] @ g[3]))

    def G(v):
        return cplx.cmap(
            lambda a: jnp.einsum("st,...tcn->...scn", g5, a[::-1]), v)

    A = lambda v: apply_domain_wall(Dr, v)
    Ah = lambda v: G(apply_domain_wall(Dl, G(v)))

    shape = (Ls,) + lat + (4, 3, 1)
    b = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))
    # adjoint consistency: <u, A v> == <Ah u, v>
    u = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))
    uc = np.asarray(u.re) + 1j * np.asarray(u.im)
    bc = np.asarray(b.re) + 1j * np.asarray(b.im)
    Av = A(b); Ahu = Ah(u)
    lhs = np.vdot(uc, np.asarray(Av.re) + 1j * np.asarray(Av.im))
    rhs = np.vdot(np.asarray(Ahu.re) + 1j * np.asarray(Ahu.im), bc)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)

    x, rs, it = cgne(A, Ah, b, tol=1e-10, maxiter=600)
    r = A(x)
    num = float(jnp.sum((r.re - b.re) ** 2 + (r.im - b.im) ** 2))
    den = float(jnp.sum(b.re ** 2 + b.im ** 2))
    assert num / den < 1e-8, (num / den, int(it))
