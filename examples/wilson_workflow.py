"""End-to-end worked example: the full superbblas_tpu user journey.

Build a Wilson-Dirac operator over random gauge links, solve D psi = b
with the packed even-odd preconditioned CG, checkpoint the solution in
the reference-compatible S3T format (shard-per-block parallel writes),
reload it into a DIFFERENT sharding, and verify the residual.

Run on the GPU(s):              python examples/wilson_workflow.py
Run on N virtual CPU devices:   SBT_EXAMPLE_CPU=8 python examples/wilson_workflow.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("SBT_EXAMPLE_CPU"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count="
          f"{os.environ['SBT_EXAMPLE_CPU']}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

import superbblas_tpu as sbt
from superbblas_tpu import cplx, storage
from superbblas_tpu.models import apply_wilson, eo_solve_packed, wilson_operator


def main(lat=(8, 8, 4, 4), mass=0.4, r=1.0, ncols=2, iters=60):
    rng = np.random.default_rng(0)

    # 1. the operator: split-complex Kron-BSR Wilson stencil
    op = wilson_operator(lat, mass=mass, r=r, key=1, dtype=jnp.complex128)

    # 2. a (possibly multi-device) mesh; shard the lattice x axis over
    # the largest device count that divides it
    ndev = len(jax.devices())
    k = max(d for d in range(1, ndev + 1) if lat[0] % d == 0 and d <= ndev)
    mesh = sbt.parallel.make_mesh({"x": k}, devices=jax.devices()[:k])
    shard = NamedSharding(mesh, P("x"))

    shape = lat + (4, 3, ncols)
    b = cplx.CArray(
        jax.device_put(jnp.asarray(rng.standard_normal(shape)), shard),
        jax.device_put(jnp.asarray(rng.standard_normal(shape)), shard))

    # 3. solve with the packed even-odd preconditioned CG
    psi, schur_rs = eo_solve_packed(op, b, a=mass + 4 * r, n_iters=iters)
    res = apply_wilson(op, psi)
    rel = float(jnp.sqrt(
        ((res.re - b.re) ** 2 + (res.im - b.im) ** 2).sum()
        / ((b.re ** 2 + b.im ** 2).sum())))
    print(f"eo-packed CG: relative residual {rel:.2e} after {iters} iters")

    # 4. checkpoint in the reference-compatible S3T format
    path = os.path.join(tempfile.mkdtemp(), "psi.s3t")
    psi_sharded = cplx.cmap(lambda a: jax.device_put(a, NamedSharding(
        mesh, P("x", *([None] * (a.ndim - 1))))), psi)
    sto = storage.create_storage(path, "xyztSCn", shape,
                                 dtype=np.complex128, checksum=2,
                                 metadata="wilson solution")
    storage.save_sharded(sto, psi_sharded, "xyztSCn")
    storage.close_storage(sto)
    print(f"checkpointed to {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, block CRC32s verified)")

    # 5. reload into a different sharding, verify identity
    sto2 = storage.open_storage(path, mode="r")
    storage.check_or_write_checksums(sto2)
    back = storage.load_sharded(
        sto2, NamedSharding(mesh, P(None, "x", *([None] * (len(shape) - 2)))))
    storage.close_storage(sto2)
    err = float(jnp.max(jnp.abs(back.re - psi.re))
                + jnp.max(jnp.abs(back.im - psi.im)))
    print(f"reload (resharded through the file): max err {err:.1e}")
    assert rel < 1e-6 and err == 0.0   # f32 CG floor without x64

    # 6. repartition the solution between reference-style partitions in
    # one call: GSPMD when the destination grid is expressible, the
    # explicit blocked-run collective path otherwise
    src_p = sbt.basic_partitioning("x", (lat[0],), (k,))
    dst_p = sbt.basic_partitioning("x", (lat[0],), (1,), nprocs=k)
    flat = psi.re.reshape(lat[0], -1)[:, 0]      # a 1-D slice for demo
    moved = sbt.parallel.redistribute_auto(flat, src_p, dst_p, order="x",
                                           mesh=mesh)
    print(f"redistribute_auto: on-master gather of {flat.shape} ok "
          f"({np.allclose(np.asarray(moved), np.asarray(flat))})")

    # 7. near-critical solves: the Chebyshev-smoothed symmetric two-grid
    # preconditioner (models.multigrid) cuts pcg iterations 5-8x on
    # ill-conditioned operators — see tests/test_multigrid.py and
    # experiments/mg_chebyshev.py for the full recipe.
    return rel


if __name__ == "__main__":
    main()
