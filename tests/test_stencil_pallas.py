"""SoA stencil kernel vs the einsum reference.

On the CPU the Pallas kernel runs in the interpreter; the ``card`` test
compiles it for the GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from superbblas_tpu import cplx
from superbblas_tpu.models import wilson_operator
from superbblas_tpu.ops import stencil_pallas as SP

LAT = (2, 4, 4, 8)


def offsets4():
    offs = [(0, 0, 0, 0)]
    for ax in range(4):
        for sgn in (1, -1):
            o = [0, 0, 0, 0]
            o[ax] = sgn
            offs.append(tuple(o))
    return offs


def crand(shape, seed, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    return cplx.CArray(
        jnp.asarray(rng.standard_normal(shape), dtype),
        jnp.asarray(rng.standard_normal(shape), dtype),
    )


def f32(c):
    return cplx.cmap(lambda a: a.astype(jnp.float32), c)


def rel_err(got, want):
    num = max(float(jnp.max(jnp.abs(g.astype(jnp.float32) - w)))
              for g, w in ((got.re, want.re), (got.im, want.im)))
    return num / max(float(jnp.max(jnp.abs(want.re))),
                     float(jnp.max(jnp.abs(want.im))))


@pytest.mark.parametrize("with_kron", [True, False])
def test_kernel_matches_reference(with_kron):
    offs = offsets4()
    bi = bd = 3
    ki = kd = 2 if with_kron else 1
    n = 2
    blocks = crand((len(offs), bi * bd) + LAT, 0)
    kron = crand((len(offs), ki, kd), 1) if with_kron else None
    x = crand((n, kd * bd) + LAT, 2)
    got = SP.stencil_matvec_soa(blocks, kron, x, offs, bi, bd, interpret=True)
    want = SP.stencil_matvec_soa_reference(blocks, kron, x, offs, bi, bd)
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got.im), np.asarray(want.im),
                               rtol=2e-4, atol=2e-4)


def test_soa_layout_roundtrip():
    n, kd, bd = 3, 4, 3
    x = crand(LAT + (kd, bd, n), 3)
    soa = SP.aos_to_soa(x, 4)
    assert soa.shape == (n, kd * bd) + LAT
    back = SP.soa_to_aos(soa, 4, kd, bd)
    np.testing.assert_array_equal(np.asarray(back.re), np.asarray(x.re))


@pytest.mark.parametrize("offs,lat,blk,ok", [
    (offsets4(), (32, 32, 32, 64), (3, 3, 4, 4), True),   # 32^3 x 64
    (offsets4(), (4, 4, 8, 16), (3, 3, 4, 4), True),      # T % 128 != 0
    (offsets4(), (3, 5, 7, 9), (3, 3, 4, 4), True),       # odd extents
    ([(0, 0, 0, 2)], (4, 4, 4, 8), (3, 3, 4, 4), False),  # offset 2
    ([(1, 1, 0, 0)], (4, 4, 4, 8), (3, 3, 4, 4), False),  # diagonal
    (offsets4(), (4, 4, 4), (3, 3, 1, 1), False),         # 3D lattice
    (offsets4(), (4, 4, 4, 8), (12, 12, 2, 2), False),    # block too big
    (offsets4(), (64, 64, 64, 128), (3, 3, 4, 4), True),  # sharded sizes
    (offsets4(), (256, 256, 256, 256), (3, 3, 4, 4), True),  # sizes: at run
])
def test_eligibility(offs, lat, blk, ok):
    assert SP.soa_eligible(offs, lat, *blk) is ok


def test_bf16_storage_path():
    """bf16-stored operands accumulate in f32; error ~ input rounding."""
    lat = (2, 4, 4, 8)
    offs = offsets4()
    b = crand((9, 9) + lat, 4)
    k = crand((9, 4, 4), 5)
    x = crand((2, 12) + lat, 6)
    ref = SP.stencil_matvec_soa_reference(b, k, x, offs, 3, 3)
    tob = lambda c: cplx.cmap(lambda a: a.astype(jnp.bfloat16), c)
    y = SP.stencil_matvec_soa(tob(b), k, tob(x), offs, 3, 3, interpret=True)
    assert y.re.dtype == jnp.bfloat16
    assert rel_err(y, ref) < 0.05


# the Wilson path in three precisions x packed parities x rhs/lattices:
# f32 and bf16-stored links against the reference on the same (upcast)
# values; bf16 fields against it up to one bf16 rounding of the output
PRECISIONS = {"f32": (jnp.float32, jnp.float32, 1e-5),
              "bf16-links": (jnp.bfloat16, jnp.float32, 1e-5),
              "bf16": (jnp.bfloat16, jnp.bfloat16, 1e-2)}


@pytest.mark.parametrize("n,lat", [(1, (4, 4, 8, 16)), (3, (4, 4, 4, 32))])
@pytest.mark.parametrize("packed_parity", [None, 0, 1])
@pytest.mark.parametrize("precision", sorted(PRECISIONS))
def test_wilson_path_matches_reference(precision, packed_parity, n, lat):
    from superbblas_tpu.bsr import apply_stencil_soa, bsr_cast_storage
    from superbblas_tpu.models.eo_packed import hopping_packed_soa

    links, fields, limit = PRECISIONS[precision]
    op = bsr_cast_storage(wilson_operator(lat, mass=0.1, key=1,
                                          layout="soa"), links)
    if packed_parity is not None:
        op = hopping_packed_soa(op, packed_parity)
        lat = (lat[0] // 2,) + lat[1:]
    x = crand((n, 12) + lat, 7, fields)
    got = apply_stencil_soa(op, x, interpret=True,
                            packed_parity=packed_parity)
    assert got.shape == (n, 12) + lat and got.re.dtype == fields
    with jax.default_matmul_precision("highest"):
        want = SP.stencil_matvec_soa_reference(
            f32(op.blocks), op.kron, f32(x), op.offsets, 3, 3,
            packed_parity=packed_parity)
    assert rel_err(got, want) <= limit


def test_traced_spin_factors_use_generic_body():
    """Spin factors passed through jit are tracers: the kernel falls back
    to the generic (unfactored) spin multiply and still agrees."""
    op = wilson_operator((2, 2, 4, 8), mass=0.1, key=2, layout="soa")
    x = crand((2, 12, 2, 2, 4, 8), 8)
    got = jax.jit(lambda k, v: SP.stencil_matvec_soa(
        op.blocks, k, v, op.offsets, 3, 3, interpret=True))(op.kron, x)
    want = SP.stencil_matvec_soa_reference(op.blocks, op.kron, x,
                                           op.offsets, 3, 3)
    assert rel_err(got, want) < 1e-5


def test_plain_path_off_gpu(monkeypatch):
    """Off the GPU, apply_stencil_soa runs the plain XLA reference and
    never the kernel."""
    from superbblas_tpu.bsr import apply_stencil_soa

    def no_kernel(*a, **k):
        raise AssertionError("kernel called off the GPU")

    monkeypatch.setattr(SP, "stencil_matvec_soa", no_kernel)
    op = wilson_operator((2, 2, 4, 8), mass=0.1, key=3, layout="soa")
    x = crand((1, 12, 2, 2, 4, 8), 9)
    got = apply_stencil_soa(op, x)
    want = SP.stencil_matvec_soa_reference(op.blocks, op.kron, x,
                                           op.offsets, 3, 3)
    np.testing.assert_array_equal(np.asarray(got.re), np.asarray(want.re))


@pytest.mark.card
def test_compiled_kernel_matches_reference(card):
    """The kernel as compiled for the card, at a production-like shape."""
    from superbblas_tpu.bsr import apply_stencil_soa

    lat = (16, 16, 16, 32)
    op = wilson_operator(lat, mass=0.1, key=4, layout="soa")
    x = crand((4, 12) + lat, 10)
    got = apply_stencil_soa(op, x)
    with jax.default_matmul_precision("highest"):
        want = SP.stencil_matvec_soa_reference(op.blocks, op.kron, x,
                                               op.offsets, 3, 3)
    assert rel_err(got, want) < 1e-5


def test_f64_operands_accumulate_in_f64():
    """f64 operators keep f64 sums in the kernel (no silent downcast;
    conftest enables x64)."""
    op = wilson_operator((2, 2, 4, 8), mass=0.1, key=5, layout="soa",
                         dtype=jnp.complex128)
    x = crand((1, 12, 2, 2, 4, 8), 11, jnp.float64)
    got = SP.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3,
                                interpret=True)
    want = SP.stencil_matvec_soa_reference(op.blocks, op.kron, x,
                                           op.offsets, 3, 3)
    assert got.re.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               rtol=1e-12, atol=1e-12)


# GSPMD: operands sharded over a 2x2 mesh inside jit.  The kernel's own
# partitioning rule must run it on the local shards (a halo exchange for
# a sharded lattice) and never gather an operand whole.
GSPMD_SPECS = {
    "x": ("a", None, None, None, None),
    "xy": ("a", "b", None, None, None),
    "rhs-x": ("b", None, None, None, "a"),
}


def _gspmd_apply(spec_name, packed_parity):
    import dataclasses

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from superbblas_tpu.bsr import apply_stencil_soa
    from superbblas_tpu.models.eo_packed import hopping_packed_soa

    lx, ly, lz, lt, rhs = GSPMD_SPECS[spec_name]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    lat = (8, 4, 4, 8)
    op = wilson_operator(lat, mass=0.1, key=6, layout="soa")
    if packed_parity is not None:
        op = hopping_packed_soa(op, packed_parity)
        lat = (4,) + lat[1:]
    x = crand((2, 12) + lat, 12)
    put = lambda c, spec: cplx.cmap(
        lambda a: jax.device_put(a, NamedSharding(mesh, P(*spec))), c)
    bs = put(op.blocks, (None, None, lx, ly, lz, lt))
    xs = put(x, (rhs, None, lx, ly, lz, lt))
    f = jax.jit(lambda b, v: apply_stencil_soa(
        dataclasses.replace(op, blocks=b), v, interpret=True,
        packed_parity=packed_parity))
    want = SP.stencil_matvec_soa_reference(op.blocks, op.kron, x, op.offsets,
                                           3, 3, packed_parity=packed_parity)
    return f, bs, xs, want


@pytest.mark.parametrize("spec_name,packed_parity", [
    ("x", None), ("xy", None), ("rhs-x", None), ("xy", 0), ("xy", 1)])
def test_gspmd_sharded_apply_partitions(spec_name, packed_parity):
    f, bs, xs, want = _gspmd_apply(spec_name, packed_parity)
    hlo = f.lower(bs, xs).compile().as_text()
    assert "all-gather" not in hlo
    assert "collective-permute" in hlo          # the halo exchange
    got = f(bs, xs)
    assert got.re.sharding.spec[2] == GSPMD_SPECS[spec_name][0]  # stays sharded
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("spec_name", ["z", "t"])
def test_gspmd_unsupported_sharding_raises(spec_name):
    """A lattice sharded over Z or T would need a gather: an error that
    names the sharded path, not a silent all-gather."""
    GSPMD_SPECS.setdefault("z", (None, None, "a", None, None))
    GSPMD_SPECS.setdefault("t", (None, None, None, "a", None))
    f, bs, xs, _ = _gspmd_apply(spec_name, None)
    with pytest.raises(Exception, match="apply_stencil_soa_sharded"):
        f.lower(bs, xs).compile()


def test_rhs_split_under_int32_limit(monkeypatch):
    """Right-hand sides beyond the kernel's int32 range run as several
    launches (here the limit is lowered to just fit the links, which
    leaves room for six rhs per launch)."""
    lat = (2, 2, 4, 8)
    op = wilson_operator(lat, mass=0.1, key=7, layout="soa")
    x = crand((16, 12) + lat, 13)
    monkeypatch.setattr(SP, "_MAX_ELEMS", 9 * 9 * 128)
    SP._partitioned.cache_clear()
    launches = []
    real = SP._pallas
    monkeypatch.setattr(SP, "_pallas", lambda st, pp, *a: (
        launches.append(a[4].shape[0]), real(st, pp, *a))[1])
    got = SP.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3,
                                interpret=True)
    SP._partitioned.cache_clear()
    assert launches == [6, 6, 4]
    want = SP.stencil_matvec_soa_reference(op.blocks, op.kron, x,
                                           op.offsets, 3, 3)
    assert rel_err(got, want) < 1e-5


def test_links_over_int32_limit_raise(monkeypatch):
    op = wilson_operator((2, 2, 4, 8), mass=0.1, key=8, layout="soa")
    x = crand((1, 12, 2, 2, 4, 8), 14)
    monkeypatch.setattr(SP, "_MAX_ELEMS", 1000)
    SP._partitioned.cache_clear()
    try:
        with pytest.raises(ValueError, match="shard the lattice"):
            SP.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3,
                                  interpret=True)
    finally:
        SP._partitioned.cache_clear()
