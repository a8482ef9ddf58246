"""BSR operator tests (reference analog: tests/bsr.cpp).

Strategy mirrors the reference: (1) all-ones fast check — with unit blocks
and x=1, every y element equals ndir * BD (tests/bsr.cpp:296-302); (2) a
dense-matrix numpy oracle; (3) kron-factored vs materialized equivalence;
(4) operator powers; (5) sharded-lattice execution.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from superbblas_tpu import bsr as B
from superbblas_tpu import parallel as par


def stencil_offsets(dim):
    """Self + one-hop neighbors in each direction with extent > 1 (the
    reference's max_neighbors construction, tests/bsr.cpp:104-152)."""
    offs = [tuple(0 for _ in dim)]
    for ax, d in enumerate(dim):
        if d == 1:
            continue
        for sgn in (1, -1):
            off = [0] * len(dim)
            off[ax] = sgn
            offs.append(tuple(off))
            if d <= 2:
                break
    return offs


def make_stencil_op(dim, BI, BD, dtype=np.float64, seed=0, ones=False,
                    kron=None):
    offs = stencil_offsets(dim)
    rng = np.random.default_rng(seed)
    shape = tuple(dim) + (len(offs), BI, BD)
    vals = np.ones(shape, dtype) if ones else rng.standard_normal(shape).astype(dtype)
    lat = "XY"[: len(dim)]
    op = B.bsr_from_stencil(
        lat + "s", lat + "s",
        dim, {"s": BI}, {"s": BD},
        offs, jnp.asarray(vals), kron=kron,
    )
    return op, vals, offs


def dense_oracle(dim, offs, vals, x):
    """y[site, i, n] = sum_k vals[site, k] @ x[site+off_k, :, n]."""
    y = np.zeros(tuple(dim) + (vals.shape[-2], x.shape[-1]), dtype=x.dtype)
    for site in itertools.product(*[range(d) for d in dim]):
        for k, off in enumerate(offs):
            nb = tuple((s + o) % d for s, o, d in zip(site, off, dim))
            y[site] += vals[site][k] @ x[nb]
    return y


def test_fast_check_all_ones():
    """x = 1, blocks = 1 -> every y element = ndir * BD."""
    dim = (4, 4)
    op, vals, offs = make_stencil_op(dim, 3, 3, ones=True)
    x = jnp.ones(dim + (3, 2))
    y = B.bsr_krylov(1.0, op, x, "XYsn")
    np.testing.assert_allclose(np.asarray(y), len(offs) * 3)


def test_stencil_matvec_matches_dense_oracle():
    dim = (4, 3)
    op, vals, offs = make_stencil_op(dim, 2, 3, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(dim + (3, 5))
    y = B.bsr_krylov(1.0, op, jnp.asarray(x), "XYsn")
    want = dense_oracle(dim, offs, vals, x)
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-12)


def test_alpha_beta():
    dim = (4, 4)
    op, vals, offs = make_stencil_op(dim, 2, 2, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(dim + (2, 3))
    y0 = rng.standard_normal(dim + (2, 3))
    got = B.bsr_krylov(2.0, op, jnp.asarray(x), "XYsn",
                       beta=-0.5, y=jnp.asarray(y0), oy="XYsn")
    want = 2.0 * dense_oracle(dim, offs, vals, x) - 0.5 * y0
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_label_permutation_roundtrip():
    """x given in a permuted order; y requested in a permuted order."""
    dim = (4, 3)
    op, vals, offs = make_stencil_op(dim, 2, 2, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal(dim + (2, 5))   # X Y s n
    xp = np.transpose(x, (3, 0, 2, 1))       # n X s Y
    got = B.bsr_krylov(1.0, op, jnp.asarray(xp), "nXsY", oy="YnsX")
    want = dense_oracle(dim, offs, vals, x)  # X Y i n
    want = np.transpose(want, (1, 3, 2, 0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_create_bsr_detects_stencil():
    """Reference-style ii/jj/values constructor lowers to the stencil path."""
    dim = (4, 4)
    offs = stencil_offsets(dim)
    nnz = len(offs)
    sites = list(itertools.product(*[range(d) for d in dim]))
    jj = np.zeros(dim + (nnz, 2), dtype=np.int64)
    for s in sites:
        for k, off in enumerate(offs):
            jj[s][k] = [(s[0] + off[0]) % dim[0], (s[1] + off[1]) % dim[1]]
    ii = np.full(dim, nnz)
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(dim + (nnz, 2, 2))
    op = B.create_bsr("XYs", (4, 4, 2), "XYc", (4, 4, 2),
                      (1, 1, 2), (1, 1, 2), ii, jj, jnp.asarray(vals))
    assert op.mode == "stencil"
    x = rng.standard_normal(dim + (2, 3))
    got = B.bsr_krylov(1.0, op, jnp.asarray(x), "XYcn")
    want = dense_oracle(dim, list(op.offsets), vals, x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_create_bsr_near_uniform_merges_to_stencil():
    """Irregular neighbor lists whose offset UNION is small are
    scatter-merged onto the fast stencil path (zero blocks where a row
    lacks an offset); pattern_merge=False forces the gather plan — both
    match the per-site oracle exactly."""
    dim = (4,)
    maxnnz = 2
    ii = np.array([2, 1, 2, 1])
    jj = np.zeros((4, maxnnz, 1), dtype=np.int64)
    jj[0, :, 0] = [0, 1]
    jj[1, :, 0] = [1, 0]      # second entry padded (ii=1)
    jj[2, :, 0] = [2, 3]
    jj[3, :, 0] = [3, 0]      # padded
    rng = np.random.default_rng(8)
    vals = rng.standard_normal((4, maxnnz, 2, 2))
    x = rng.standard_normal((4, 2, 3))
    want = np.zeros((4, 2, 3))
    for s in range(4):
        for k in range(int(ii[s])):
            want[s] += vals[s, k] @ x[jj[s, k, 0]]

    op = B.create_bsr("Xs", (4, 2), "Xc", (4, 2),
                      (1, 2), (1, 2), ii, jj, jnp.asarray(vals))
    assert op.mode == "stencil"          # union {0, +1} merges
    got = B.bsr_krylov(1.0, op, jnp.asarray(x), "Xcn")
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)

    opg = B.create_bsr("Xs", (4, 2), "Xc", (4, 2),
                       (1, 2), (1, 2), ii, jj, jnp.asarray(vals),
                       pattern_merge=False)
    assert opg.mode == "gather"
    gotg = B.bsr_krylov(1.0, opg, jnp.asarray(x), "Xcn")
    np.testing.assert_allclose(np.asarray(gotg), want, rtol=1e-12)


def test_create_bsr_duplicate_offsets_sum():
    """Two entries of one row pointing at the SAME neighbor accumulate
    into one stencil block (the scatter-add merge semantics)."""
    dim = (3,)
    ii = np.array([2, 1, 1])
    jj = np.zeros((3, 2, 1), dtype=np.int64)
    jj[0, :, 0] = [1, 1]      # duplicate neighbor
    jj[1, 0, 0] = 2
    jj[2, 0, 0] = 0
    rng = np.random.default_rng(14)
    vals = rng.standard_normal((3, 2, 2, 2))
    op = B.create_bsr("Xs", (3, 2), "Xc", (3, 2), (1, 2), (1, 2),
                      ii, jj, jnp.asarray(vals))
    assert op.mode == "stencil"
    x = rng.standard_normal((3, 2, 2))
    got = B.bsr_krylov(1.0, op, jnp.asarray(x), "Xcn")
    want = np.zeros((3, 2, 2))
    for s in range(3):
        for k in range(int(ii[s])):
            want[s] += vals[s, k] @ x[jj[s, k, 0]]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_create_bsr_truly_irregular_stays_gather():
    """When the offset union exceeds 2x max_nnz, the merge would blow up
    storage/compute — the gather plan is kept."""
    dim = (8,)
    ii = np.full(8, 2)
    jj = np.zeros((8, 2, 1), dtype=np.int64)
    for s in range(8):
        jj[s, 0, 0] = s
        jj[s, 1, 0] = (s * 3 + 1) % 8     # offsets vary per row: big union
    rng = np.random.default_rng(15)
    vals = rng.standard_normal((8, 2, 2, 2))
    op = B.create_bsr("Xs", (8, 2), "Xc", (8, 2), (1, 2), (1, 2),
                      ii, jj, jnp.asarray(vals))
    assert op.mode == "gather"
    x = rng.standard_normal((8, 2, 2))
    got = B.bsr_krylov(1.0, op, jnp.asarray(x), "Xcn")
    want = np.zeros((8, 2, 2))
    for s in range(8):
        for k in range(2):
            want[s] += vals[s, k] @ x[jj[s, k, 0]]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_kron_bsr_matches_materialized():
    """Kron operator equals the plain BSR with blocks kron(spin, color)."""
    dim = (4, 4)
    offs = stencil_offsets(dim)
    ndir = len(offs)
    KI = KD = 2   # spin
    CI = CD = 3   # color
    rng = np.random.default_rng(9)
    color = rng.standard_normal(dim + (ndir, CI, CD))
    spin = rng.standard_normal((ndir, KI, KD))

    kron_op = B.bsr_from_stencil(
        "XYSc", "XYSc", dim, {"c": CI}, {"c": CD}, offs,
        jnp.asarray(color), kron=jnp.asarray(spin),
        kron_i={"S": KI}, kron_d={"S": KD},
    )
    # materialized: block[si*CI+ci, sd*CD+cd] = spin[si,sd]*color[ci,cd]
    mats = np.einsum("kab,...kcd->...kacbd", spin, color).reshape(
        dim + (ndir, KI * CI, KD * CD)
    )
    plain_op = B.bsr_from_stencil(
        "XYz", "XYz", dim, {"z": KI * CI}, {"z": KD * CD}, offs,
        jnp.asarray(mats),
    )
    x = rng.standard_normal(dim + (KD, CD, 5))
    got = B.bsr_krylov(1.0, kron_op, jnp.asarray(x), "XYScn")
    xf = x.reshape(dim + (KD * CD, 5))
    want = B.bsr_krylov(1.0, plain_op, jnp.asarray(xf), "XYzn")
    np.testing.assert_allclose(
        np.asarray(got).reshape(np.asarray(want).shape),
        np.asarray(want), rtol=1e-12,
    )


def test_kron_bsr_nonuniform_structure():
    """General create_kron_bsr (bsr.h:2302-2336): site-dependent sparsity
    (an open-boundary operator — boundary rows lose their outward
    neighbor) with the kron factorization kept.  Oracle: the elementwise
    sum of kron(spin[k], color[site, k]) @ x[neighbor] over the VALID
    slots of each row; also cross-checked against the plain (gather)
    BSR of the materialized blocks."""
    dim = (5,)
    KI = KD = 2
    CI = CD = 3
    maxnnz = 3
    # open boundary: site 0 has no left neighbor, site 4 no right one
    ii = np.array([2, 3, 3, 3, 2])
    jj = np.zeros((5, maxnnz, 1), dtype=np.int64)
    for s in range(5):
        nbrs = [s] + [n for n in (s - 1, s + 1) if 0 <= n < 5]
        jj[s, :len(nbrs), 0] = nbrs
        jj[s, len(nbrs):, 0] = s          # padded slots
    rng = np.random.default_rng(12)
    color = rng.standard_normal((5, maxnnz, CI, CD))
    spin = rng.standard_normal((maxnnz, KI, KD))

    op = B.create_kron_bsr(
        "XSc", (5, KI, CI), "XSc", (5, KD, CD),
        (1, 1, CI), (1, 1, CD), (1, KI, 1), (1, KD, 1),
        ii, jj, jnp.asarray(color), jnp.asarray(spin),
    )
    assert op.mode == "gather" and op.kron is not None

    x = rng.standard_normal((5, KD, CD, 4))
    got = B.bsr_krylov(1.0, op, jnp.asarray(x), "XScn")

    want = np.zeros((5, KI, CI, 4))
    for s in range(5):
        for k in range(int(ii[s])):
            nb = int(jj[s, k, 0])
            want[s] += np.einsum("ab,cd,bdn->acn",
                                 spin[k], color[s, k], x[nb])
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)

    # cross-check: plain gather BSR of the materialized kron blocks
    mats = np.einsum("kab,skcd->skacbd", spin, color).reshape(
        (5, maxnnz, KI * CI, KD * CD))
    plain = B.create_bsr("Xz", (5, KI * CI), "Xz", (5, KD * CD),
                         (1, KI * CI), (1, KD * CD), ii, jj,
                         jnp.asarray(mats), pattern_merge=False)
    assert plain.mode == "gather"
    want2 = B.bsr_krylov(1.0, plain, jnp.asarray(
        x.reshape((5, KD * CD, 4))), "Xzn")
    np.testing.assert_allclose(
        np.asarray(got).reshape(np.asarray(want2).shape),
        np.asarray(want2), rtol=1e-12)

    # flop model covers both contraction stages
    assert op.flops_per_matvec(4, False) > 0


def test_kron_bsr_nonuniform_complex():
    """The irregular kron path on split-complex operands (the production
    dtype): equals the materialized complex oracle."""
    from superbblas_tpu import cplx

    dim = (4,)
    KI = KD = 2
    CI = CD = 2
    maxnnz = 2
    ii = np.array([1, 2, 2, 1])
    jj = np.zeros((4, maxnnz, 1), dtype=np.int64)
    jj[0, :, 0] = [0, 0]
    jj[1, :, 0] = [0, 2]
    jj[2, :, 0] = [2, 3]
    jj[3, :, 0] = [3, 3]
    rng = np.random.default_rng(13)
    color = rng.standard_normal((4, maxnnz, CI, CD)) \
        + 1j * rng.standard_normal((4, maxnnz, CI, CD))
    spin = rng.standard_normal((maxnnz, KI, KD)) \
        + 1j * rng.standard_normal((maxnnz, KI, KD))
    op = B.create_kron_bsr(
        "XSc", (4, KI, CI), "XSc", (4, KD, CD),
        (1, 1, CI), (1, 1, CD), (1, KI, 1), (1, KD, 1),
        ii, jj, cplx.from_complex(color), cplx.from_complex(spin))
    assert op.mode == "gather"
    x = rng.standard_normal((4, KD, CD, 3)) \
        + 1j * rng.standard_normal((4, KD, CD, 3))
    got = B.bsr_krylov(1.0, op, cplx.from_complex(x), "XScn")
    want = np.zeros((4, KI, CI, 3), dtype=complex)
    for s in range(4):
        for k in range(int(ii[s])):
            want[s] += np.einsum("ab,cd,bdn->acn",
                                 spin[k], color[s, k], x[int(jj[s, k, 0])])
    np.testing.assert_allclose(np.asarray(got.re) + 1j * np.asarray(got.im),
                               want, rtol=1e-12)


def test_operator_powers():
    """okr label: y_p = alpha * A^{p+1} x (bsr.h:2140-2247 semantics)."""
    dim = (4,)
    op, vals, offs = make_stencil_op(dim, 2, 2, seed=10)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 2, 3))
    got = B.bsr_krylov(2.0, op, jnp.asarray(x), "Xsn", oy="Xsnp", okr="p",
                       power=3)
    cur = x
    for p in range(3):
        cur = dense_oracle(dim, offs, vals, cur)
        np.testing.assert_allclose(np.asarray(got)[..., p], 2.0 * cur,
                                   rtol=1e-10, err_msg=f"power {p}")


def test_sharded_lattice_matvec():
    """Lattice axes sharded over the 8-device mesh: rolls become
    collective permutes; result must match the dense oracle exactly."""
    dim = (8, 8)
    op, vals, offs = make_stencil_op(dim, 2, 2, seed=12)
    rng = np.random.default_rng(13)
    x = rng.standard_normal(dim + (2, 3))
    mesh = par.make_mesh({"X": 4, "Y": 2})
    sx = NamedSharding(mesh, P("X", "Y", None, None))
    xd = jax.device_put(jnp.asarray(x), sx)
    op_sharded = dataclasses.replace(
        op, blocks=jax.device_put(
            op.blocks, NamedSharding(mesh, P("X", "Y", None, None, None))))
    fn = jax.jit(lambda xx: B.bsr_krylov(1.0, op_sharded, xx, "XYsn"))
    got = fn(xd)
    want = dense_oracle(dim, offs, vals, x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_sharded_gather_mode_matvec():
    """Gather-mode (irregular) operators on SHARDED operands: the
    jj_flat gather crosses shard boundaries, which GSPMD resolves with
    collectives — the distributed path for the general create_bsr regime
    (bsr.h:2189-2192 does this through MPI; here it is compiled).  Both
    plain and kron-factored gather operators must match the host oracle
    exactly."""
    dim = (8,)
    maxnnz = 3
    rng = np.random.default_rng(21)
    ii = np.array([2, 3, 1, 3, 2, 3, 1, 2])
    jj = np.zeros((8, maxnnz, 1), dtype=np.int64)
    for s in range(8):
        # irregular, deliberately non-local neighbors (cross-shard)
        nbrs = rng.choice(8, size=int(ii[s]), replace=False)
        jj[s, :len(nbrs), 0] = nbrs
        jj[s, len(nbrs):, 0] = s
    vals = rng.standard_normal((8, maxnnz, 2, 2))
    op = B.create_bsr("Xs", (8, 2), "Xc", (8, 2), (1, 2), (1, 2),
                      ii, jj, jnp.asarray(vals), pattern_merge=False)
    assert op.mode == "gather"

    mesh = par.make_mesh({"X": 8})
    x = rng.standard_normal((8, 2, 3))
    xd = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("X", None, None)))
    op_sh = dataclasses.replace(op, blocks=jax.device_put(
        op.blocks, NamedSharding(mesh, P("X", None, None, None))))
    got = jax.jit(lambda xx: B.bsr_krylov(1.0, op_sh, xx, "Xcn"))(xd)
    want = np.zeros((8, 2, 3))
    for s in range(8):
        for k in range(int(ii[s])):
            want[s] += vals[s, k] @ x[int(jj[s, k, 0])]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)

    # kron-factored irregular operator, sharded the same way
    KI = KD = 2
    color = rng.standard_normal((8, maxnnz, 2, 2))
    spin = rng.standard_normal((maxnnz, KI, KD))
    kop = B.create_kron_bsr("XSc", (8, KI, 2), "XSc", (8, KD, 2),
                            (1, 1, 2), (1, 1, 2), (1, KI, 1), (1, KD, 1),
                            ii, jj, jnp.asarray(color), jnp.asarray(spin))
    xk = rng.standard_normal((8, KD, 2, 3))
    xkd = jax.device_put(jnp.asarray(xk),
                         NamedSharding(mesh, P("X", None, None, None)))
    kop_sh = dataclasses.replace(kop, blocks=jax.device_put(
        kop.blocks, NamedSharding(mesh, P("X", None, None, None))))
    gotk = jax.jit(lambda xx: B.bsr_krylov(1.0, kop_sh, xx, "XScn"))(xkd)
    wantk = np.zeros((8, KI, 2, 3))
    for s in range(8):
        for k in range(int(ii[s])):
            wantk[s] += np.einsum("ab,cd,bdn->acn", spin[k], color[s, k],
                                  xk[int(jj[s, k, 0])])
    np.testing.assert_allclose(np.asarray(gotk), wantk, rtol=1e-12)


def test_preferred_layout():
    op, _, _ = make_stencil_op((4, 4), 2, 2)
    ox, oy = B.bsr_get_preferred_layout(op)
    assert ox.startswith("XY")
    assert "n" in ox and "n" in oy


def test_bsr_cast_storage_bf16():
    """bsr_cast_storage re-stores blocks bf16 for ANY operator family;
    the matvec accumulates f32 and matches to operand rounding."""
    dim = (4, 4)
    op, vals, offs = make_stencil_op(dim, 2, 3, seed=30)
    op16 = B.bsr_cast_storage(op, jnp.bfloat16)
    assert op16.blocks.dtype == jnp.bfloat16
    rng = np.random.default_rng(31)
    x = rng.standard_normal(dim + (3, 2)).astype(np.float32)
    y32 = B.bsr_krylov(1.0, op, jnp.asarray(x), "XYsn")
    y16 = B.bsr_krylov(1.0, op16, jnp.asarray(x, np.float32), "XYsn")
    rel = np.abs(np.asarray(y16, np.float32) - np.asarray(y32)).max() \
        / np.abs(np.asarray(y32)).max()
    assert rel < 0.02, rel


def test_open_boundary_wilson_runs_stencil_path():
    """The practical near-uniform case: an open-boundary (non-toroidal
    in t) Wilson-like operator — boundary rows lose an offset but the
    union stays the full stencil, so the operator runs the roll-based
    GEMM path with zeroed boundary blocks instead of the gather plan."""
    dim = (4, 6)
    full = [(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)]
    maxnnz = len(full)
    sites = list(itertools.product(range(dim[0]), range(dim[1])))
    ii = np.zeros(dim, dtype=np.int64)
    jj = np.zeros(dim + (maxnnz, 2), dtype=np.int64)
    rng = np.random.default_rng(20)
    vals = np.zeros(dim + (maxnnz, 2, 2))
    for s in sites:
        k = 0
        for off in full:
            t = (s[0] + off[0], s[1] + off[1])
            if not (0 <= t[1] < dim[1]):
                continue                   # OPEN boundary in axis 1
            jj[s][k] = [t[0] % dim[0], t[1]]
            vals[s][k] = rng.standard_normal((2, 2))
            k += 1
        ii[s] = k
    op = B.create_bsr("XYs", dim + (2,), "XYc", dim + (2,),
                      (1, 1, 2), (1, 1, 2), ii,
                      jj.reshape(dim + (maxnnz, 2)), jnp.asarray(vals))
    assert op.mode == "stencil" and len(op.offsets) == maxnnz
    x = rng.standard_normal(dim + (2, 3))
    got = B.bsr_krylov(1.0, op, jnp.asarray(x), "XYcn")
    want = np.zeros(dim + (2, 3))
    for s in sites:
        for k in range(int(ii[s])):
            want[s] += vals[s][k] @ x[tuple(jj[s][k])]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_soa_native_layout_zero_copy():
    """bsr_get_preferred_layout is mode-aware (SpMMAllowedLayout analog,
    bsr.h:255-260, 2395-2455): for SoA operators the preferred order is
    columns-outermost, and bsr_krylov fed fields in that order takes the
    zero-copy fast path — bit-identical to the AoS order (same kernel),
    with the boundary transposes gone from the lowered module."""
    from superbblas_tpu import cplx
    from superbblas_tpu.models import wilson_operator

    lat = (4, 4, 8, 128)
    op = wilson_operator(lat, mass=0.2, key=3, dtype=jnp.complex64,
                         layout="soa")
    px, py = B.bsr_get_preferred_layout(op)
    assert px == "n" + op.kron_d + op.blk_d + op.lat_d
    allowed = B.bsr_allowed_layouts(op)
    assert allowed["preferred"] == (px, py) and allowed["any_order"]

    rng = np.random.default_rng(0)
    shp_aos = lat + (4, 3, 2)
    x_aos = cplx.CArray(
        jnp.asarray(rng.standard_normal(shp_aos), jnp.float32),
        jnp.asarray(rng.standard_normal(shp_aos), jnp.float32))
    ox_aos = op.lat_d + op.kron_d + op.blk_d + "n"
    y_aos = B.bsr_krylov(1.0, op, x_aos, ox_aos)

    perm = [ox_aos.index(c) for c in px]
    x_soa = cplx.cmap(lambda a: jnp.transpose(a, perm), x_aos)
    y_soa = B.bsr_krylov(1.0, op, x_soa, px, oy=py)
    oy_def = op.lat_i + op.kron_i + op.blk_i + "n"
    perm_y = [py.index(c) for c in oy_def]
    y_back = cplx.cmap(lambda a: jnp.transpose(a, perm_y), y_soa)
    np.testing.assert_array_equal(np.asarray(y_back.re),
                                  np.asarray(y_aos.re))
    np.testing.assert_array_equal(np.asarray(y_back.im),
                                  np.asarray(y_aos.im))

    # okr powers ride the same fast path
    y_pow = B.bsr_krylov(1.0, op, x_soa, px, oy="p" + py, okr="p", power=2)
    y2 = B.bsr_krylov(1.0, op, y_soa, px, oy=py)
    np.testing.assert_allclose(np.asarray(y_pow.re[1]),
                               np.asarray(y2.re), atol=1e-4)

    # the boundary transposes are gone from the lowered module
    import jax as _jax
    n_fast = _jax.jit(lambda v: B.bsr_krylov(1.0, op, v, px, oy=py)) \
        .lower(x_soa).as_text().count("stablehlo.transpose")
    n_slow = _jax.jit(lambda v: B.bsr_krylov(1.0, op, v, ox_aos)) \
        .lower(x_aos).as_text().count("stablehlo.transpose")
    assert n_fast <= n_slow - 4, (n_fast, n_slow)
