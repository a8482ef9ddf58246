"""Worked example: the data-movement layer end to end.

Tour of the distribution toolkit on arbitrary (wrapped / uneven /
overlapping) partitions — everything the reference's `copy()` entry
does (dist.h:3534):

  1. grid -> uneven-grid redistribution (blocked-run plan + ragged
     collective),
  2. ONE-plan label-permuting + alpha-scaling + f32->f64-converting
     copy between irregular partitions (dummy_normalize_copy,
     dist.h:2455-2530 / the templated alpha copy, dist.h:3534-3583),
  3. the same plan with parity masks riding the copy-bandwidth boxes
     packer (mask-aware plans, dist.h:1852-1916),
  4. the global-array fast path: GSPMD device_put when the destination
     is NamedSharding-expressible.

Run on the GPU(s):              python examples/redistribution_tour.py
Run on N virtual CPU devices:   SBT_EXAMPLE_CPU=8 python examples/redistribution_tour.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("SBT_EXAMPLE_CPU"):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count="
          f"{os.environ['SBT_EXAMPLE_CPU']}")
import jax

if os.environ.get("SBT_EXAMPLE_CPU"):
    jax.config.update("jax_platforms", "cpu")
    # the f32 -> f64 conversion demo needs x64 (without it the
    # converting copy lands f32, which is also fine)
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from superbblas_tpu import parallel as par
from superbblas_tpu.parallel import Partition, redistribute as R


def main():
    n = min(len(jax.devices()), 8)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("p",))
    rng = np.random.default_rng(0)

    # -- 1. grid -> uneven grid ------------------------------------------
    dim = (6 * n, 10)
    src = par.basic_partitioning("xy", dim, (n, 1))
    dst = par.basic_partitioning("xy", dim, (1, min(n, 10)), nprocs=n)
    x = rng.standard_normal(dim).astype(np.float32)
    stack = jax.device_put(jnp.asarray(R.pack_global(x, src)),
                           NamedSharding(mesh, P("p", None, None)))
    out = R.redistribute_explicit(stack, src, dst, mesh)
    assert np.array_equal(R.unpack_global(np.asarray(out), dst), x)
    print(f"1. grid->uneven over {n} ranks: exact")

    # -- 2. one-plan permute + scale + convert ---------------------------
    dim_d = (dim[1], dim[0])                    # destination order "yx"
    boxes = tuple((tuple(int(rng.integers(0, d)) for d in dim_d),
                   tuple(int(rng.integers(1, d + 1)) for d in dim_d))
                  for _ in range(n))
    dst_t = Partition(dim=dim_d, boxes=boxes)   # wrapped + overlapping
    o2 = R.redistribute_auto(x, src, dst_t, order="xy", order_dst="yx",
                             mesh=mesh, alpha=0.5, out_dtype=np.float64)
    want = 0.5 * np.transpose(x, (1, 0)).astype(np.float64)
    cov = np.zeros(dim_d, bool)
    for f, s in dst_t.boxes:
        cov[np.ix_(*[np.arange(ff, ff + ss) % d
                     for ff, ss, d in zip(f, s, dim_d)])] = True
    got = np.asarray(o2)
    assert np.allclose(np.where(cov, got, 0), np.where(cov, want, 0),
                       atol=1e-6)
    print("2. one-plan permute+alpha+f32->f64 to irregular boxes: exact")

    # -- 3. masked, at boxes-packer speed --------------------------------
    mask = (np.add.outer(np.arange(dim[0]), np.arange(dim[1])) % 2) == 0
    plan = R.make_plan(src, dst, mask_src=mask, mask_dst=mask)
    assert plan.pack == "boxes" and plan.mask_mult
    o3 = R.redistribute_explicit(stack, src, dst, mesh,
                                 mask_src=mask, mask_dst=mask)
    back = R.unpack_global(np.asarray(o3), dst)
    assert np.array_equal(back, np.where(mask, x, 0))
    print("3. parity-masked copy on the boxes packer: exact")

    # -- 4. GSPMD fast path ----------------------------------------------
    s_dst = par.partition_sharding(dst, "xy")
    if s_dst is not None:
        o4 = R.redistribute_auto(x, src, dst, order="xy", mesh=mesh)
        assert np.array_equal(np.asarray(o4), x)
        print("4. GSPMD device_put fast path: exact")
    print("redistribution tour: ALL OK")


if __name__ == "__main__":
    main()
