"""Core/halo overlapped stencil application (parallel/overlap.py).

Oracle: plain ``bsr_krylov`` on global arrays.  Also checks the
``just_local`` semantics against a zero-boundary numpy model (reference:
bsr.h:2353-2359 just_local skips all communication; tests/bsr.cpp:402-530
builds the core/halo split this module implements natively).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from superbblas_tpu import bsr as B
from superbblas_tpu import cplx
from superbblas_tpu import parallel as par
from superbblas_tpu.parallel.overlap import bsr_krylov_overlap

from test_bsr import make_stencil_op


@pytest.fixture(scope="module")
def mesh():
    return par.make_mesh({"X": 4, "Y": 2})


def test_overlap_matches_plain(mesh):
    dim = (16, 8)
    op, vals, offs = make_stencil_op(dim, 3, 2, seed=4)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dim + (2, 5)))

    ref = B.bsr_krylov(1.5, op, x, "XYsn")
    x_sh = jax.device_put(x, NamedSharding(mesh, P("X", "Y", None, None)))
    out = bsr_krylov_overlap(1.5, op, x_sh, "XYsn", mesh,
                             {"X": "X", "Y": "Y"})
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_overlap_beta_accumulate(mesh):
    dim = (8, 8)
    op, _, _ = make_stencil_op(dim, 2, 2, seed=9)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(dim + (2, 3)))
    y0 = jnp.asarray(rng.standard_normal(dim + (2, 3)))

    ref = B.bsr_krylov(2.0, op, x, "XYsn", beta=-1.0, y=y0)
    x_sh = jax.device_put(x, NamedSharding(mesh, P("X", "Y", None, None)))
    out = bsr_krylov_overlap(2.0, op, x_sh, "XYsn", mesh,
                             {"X": "X", "Y": "Y"}, beta=-1.0, y=y0)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)


def test_overlap_kron_wilson(mesh):
    from superbblas_tpu.models import wilson_operator

    lat = (8, 8, 2, 2)
    op = wilson_operator(lat, mass=0.2, key=1, dtype=jnp.complex128)
    rng = np.random.default_rng(5)
    shape = lat + (4, 3, 2)
    x = cplx.CArray(jnp.asarray(rng.standard_normal(shape)),
                    jnp.asarray(rng.standard_normal(shape)))

    ref = B.bsr_krylov(1.0, op, x, "xyztSCn")
    x_sh = jax.device_put(
        x, NamedSharding(mesh, P("X", "Y", None, None, None, None, None)))
    out = bsr_krylov_overlap(1.0, op, x_sh, "xyztSCn", mesh,
                             {"x": "X", "y": "Y"})
    np.testing.assert_allclose(np.asarray(out.re), np.asarray(ref.re),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(out.im), np.asarray(ref.im),
                               rtol=1e-10, atol=1e-10)


def test_just_local_drops_boundary_terms(mesh):
    """just_local applies only intra-shard connections: oracle is a numpy
    stencil where cross-boundary neighbor operands are zero."""
    dim = (16, 8)
    op, vals, offs = make_stencil_op(dim, 2, 2, seed=7)
    rng = np.random.default_rng(3)
    xn = rng.standard_normal(dim + (2, 3))

    # numpy oracle with zero fill across the 4x2 shard grid
    shard = (dim[0] // 4, dim[1] // 2)
    y = np.zeros(dim + (2, 3))
    for site in itertools.product(*[range(d) for d in dim]):
        for k, off in enumerate(offs):
            nb = tuple((s + o) % d for s, o, d in zip(site, off, dim))
            # crossing a shard boundary? (zero-shift per sharded axis)
            cross = any(
                (s + o < (s // sh) * sh) or (s + o >= (s // sh + 1) * sh)
                for s, o, sh in zip(site, off, shard))
            if cross:
                continue
            y[site] += vals[site][k] @ xn[nb]

    x_sh = jax.device_put(jnp.asarray(xn),
                          NamedSharding(mesh, P("X", "Y", None, None)))
    out = bsr_krylov_overlap(1.0, op, x_sh, "XYsn", mesh,
                             {"X": "X", "Y": "Y"}, just_local=True)
    np.testing.assert_allclose(np.asarray(out), y, rtol=1e-12, atol=1e-12)


def test_soa_sharded_matches_unsharded(mesh):
    """The sharded SoA hot path (halo-extend -> kernel -> crop) equals the
    unsharded application, incl. communication-avoiding powers."""
    from superbblas_tpu.bsr import apply_stencil_soa
    from superbblas_tpu.models import wilson_operator
    from superbblas_tpu.parallel import apply_stencil_soa_sharded

    lat = (8, 8, 8, 128)
    op = wilson_operator(lat, mass=0.2, key=1, dtype=jnp.complex64,
                         layout="soa")
    rng = np.random.default_rng(0)
    x = cplx.CArray(
        jnp.asarray(rng.standard_normal((2, 12) + lat), jnp.float32),
        jnp.asarray(rng.standard_normal((2, 12) + lat), jnp.float32))

    ref1 = apply_stencil_soa(op, x)
    ref2 = apply_stencil_soa(op, ref1)

    sh = NamedSharding(mesh, P(None, None, "X", "Y", None, None))
    xs = jax.device_put(x, sh)
    op_sh = dataclasses.replace(op, blocks=jax.device_put(op.blocks, sh))
    y1 = apply_stencil_soa_sharded(op_sh, xs, mesh, {"x": "X", "y": "Y"})
    np.testing.assert_allclose(np.asarray(y1.re), np.asarray(ref1.re),
                               rtol=1e-5, atol=1e-5)
    y2 = apply_stencil_soa_sharded(op_sh, xs, mesh, {"x": "X", "y": "Y"},
                                   power=2)
    np.testing.assert_allclose(np.asarray(y2.re), np.asarray(ref2.re),
                               rtol=1e-4, atol=1e-4)


def test_soa_sharded_bf16_storage():
    """bf16-stored operators run through the SHARDED SoA path (halo
    ppermute on bf16 payloads + the kernel's f32 accumulation) and match
    the f32 sharded result to operand rounding."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from superbblas_tpu import cplx
    from superbblas_tpu.bsr import bsr_cast_storage
    from superbblas_tpu.models import wilson_operator
    from superbblas_tpu.parallel import apply_stencil_soa_sharded

    lat = (8, 4, 8, 128)
    op = wilson_operator(lat, mass=0.2, key=0, dtype=jnp.complex64,
                         layout="soa")
    op16 = bsr_cast_storage(op, jnp.bfloat16)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("d",))
    spec = P(None, None, "d", None, None, None)
    rng = np.random.default_rng(0)
    shape = (2, 12) + lat
    x = cplx.CArray(jnp.asarray(rng.standard_normal(shape), jnp.float32),
                    jnp.asarray(rng.standard_normal(shape), jnp.float32))
    x16 = cplx.CArray(x.re.astype(jnp.bfloat16), x.im.astype(jnp.bfloat16))

    def put(o, v):
        o2 = dataclasses.replace(o, blocks=jax.device_put(
            o.blocks, NamedSharding(mesh, spec)))
        return o2, jax.device_put(v, NamedSharding(mesh, spec))

    op_sh, x_sh = put(op, x)
    op16_sh, x16_sh = put(op16, x16)
    y32 = apply_stencil_soa_sharded(op_sh, x_sh, mesh, {"x": "d"})
    y16 = apply_stencil_soa_sharded(op16_sh, x16_sh, mesh, {"x": "d"})
    num = float(jnp.sqrt(jnp.sum(
        (y16.re.astype(jnp.float32) - y32.re) ** 2
        + (y16.im.astype(jnp.float32) - y32.im) ** 2)))
    den = float(jnp.sqrt(jnp.sum(y32.re ** 2 + y32.im ** 2)))
    assert num / den < 0.05, num / den
