"""Benchmark of the flagship hot paths on one card.

Prints one JSON line per path.  Each line carries the measured value,
the share of the card's published bound that applies to the path
(``roofline_share``, with ``bound`` naming it), and the device: JAX's
platform, kind and count plus ``nvidia-smi``'s name and power limit.
Peaks come from ``PEAKS`` (keyed by ``device_kind``); a device that is
not in the table is an error, so no number is ever scored against the
wrong card.

Paths (``--all`` adds the last five):
  dense_contraction_gflops          batched bf16 GEMM (local_contraction)
  bsr_wilson_matvec_gflops / _gbps  SoA Wilson matvec, f32
  bsr_wilson_matvec_bf16_gbps       bf16 links and bf16 fields
  permute_copy_bandwidth            label-reversal transpose (local_permute)
  unaligned_redistribution_bandwidth  gcd=1 box redistribution (1 rank)
  masked_redistribution_bandwidth   the same with parity masks
  gather_halo_matvec_gflops         gather-mode (irregular) matvec
  gather_halo_matvec_power2_gflops  the same at operator power 2
  bsr_wilson_matvec_bf16_storage_gbps  bf16 links, f32 fields
  eo_packed_hopping_gflops          packed even-odd hopping
  shift_redistribution_bandwidth    toroidal shift (halo-class move)
  explicit_redistribution_bandwidth  aligned shifted redistribution

Timing: each measurement chains the workload n times in one jitted
``lax.scan`` and takes (t(n2) - t(n1)) / (n2 - n1), median of repeats.
"""

import dataclasses
import json
import sys
import time

#: published dense peaks per device kind (NVIDIA H100 SXM5 data sheet:
#: bf16 989.4 TF/s dense, f32 66.9 TF/s, HBM3 3.35 TB/s)
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                              "hbm_bytes": 3.35e12},
}


def peaks_for(kind: str) -> dict:
    """The peak row of ``kind``; an unknown device is an error."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add a sourced row to bench.PEAKS")
    return PEAKS[kind]


def time_chained(make_fn, n1=100, n2=500):
    """Per-step time of a chained workload, from two chain lengths.

    ``make_fn(n)`` returns a callable that runs the step n times inside
    one jitted program and returns a scalar; the difference of the two
    medians cancels the fixed dispatch and fetch cost."""
    import statistics

    results = {}
    for n in (n1, n2):
        fn = make_fn(n)
        float(fn())  # compile + warm
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(fn())
            times.append(time.perf_counter() - t0)
        results[n] = statistics.median(times)
    return (results[n2] - results[n1]) / (n2 - n1)


def _scan_chain(step, x0, reduce, *fixed):
    """make_fn for time_chained: n applications of ``step(c, *fixed)``
    from x0.  The fixed operands enter the jitted chain as arguments, so
    none of them is baked into the program as a constant."""
    import jax

    def make_fn(n):
        def chained(v, *f):
            c, _ = jax.lax.scan(lambda c, _: (step(c, *f), ()), v, None,
                                length=n)
            return reduce(c)
        jitted = jax.jit(chained)
        return lambda: jitted(x0, *fixed)
    return make_fn


def bench_contraction():
    import jax
    import jax.numpy as jnp

    from superbblas_tpu import local_contraction

    T, A, B, C = 8, 1024, 1024, 1024
    key = jax.random.PRNGKey(0)
    x0 = jax.random.normal(key, (T, A, B), dtype=jnp.bfloat16)
    x1 = jax.random.normal(jax.random.fold_in(key, 1), (T, A, C),
                           dtype=jnp.bfloat16)
    step = lambda c, b: local_contraction(
        1.0, c, "tab", False, b, "tac", False, 0.0, None,
        "tbc").astype(x0.dtype)
    dt = time_chained(_scan_chain(
        step, x0, lambda c: jnp.sum(c.astype(jnp.float32)), x1), 100, 500)
    return 2 * T * A * B * C / dt / 1e9


def _wilson_field(lat, ncols, dtype):
    import jax
    import jax.numpy as jnp

    from superbblas_tpu import cplx

    k = jax.random.PRNGKey(1)
    shape = (ncols, 12) + lat
    return cplx.CArray(
        jax.random.normal(k, shape, jnp.float32).astype(dtype),
        jax.random.normal(jax.random.fold_in(k, 9), shape,
                          jnp.float32).astype(dtype))


def bench_bsr(lat=(8, 8, 16, 128), ncols=8, storage=None, x_dtype=None):
    """Wilson matvec on the SoA hot path.  ``storage`` is the link
    precision, ``x_dtype`` the field precision.  Returns (GFLOP/s, GB/s)
    under the dense-flop and one-pass-traffic models."""
    import jax.numpy as jnp

    from superbblas_tpu.models import apply_wilson, wilson_operator

    op = wilson_operator(lat, mass=0.1, key=0, dtype=jnp.complex64,
                         layout="soa", storage_dtype=storage)
    xdt = x_dtype if x_dtype is not None else jnp.float32
    x = _wilson_field(lat, ncols, xdt)
    n1, n2 = (40, 240) if ncols <= 4 else (20, 120)
    dt = time_chained(_scan_chain(
        lambda c, b: apply_wilson(dataclasses.replace(op, blocks=b), c), x,
        lambda c: jnp.sum(jnp.abs(c.re)), op.blocks), n1, n2)
    flops = op.flops_per_matvec(ncols, complex_dtype=True)
    memops = op.memops_per_matvec(ncols, itemsize=2 * jnp.dtype(xdt).itemsize)
    return flops / dt / 1e9, memops / dt / 1e9


def bench_copy(shape=(128, 64, 64, 128)):
    import jax
    import jax.numpy as jnp

    from superbblas_tpu import local_permute

    x = jax.random.normal(jax.random.PRNGKey(0), shape, dtype=jnp.float32)
    # the reversal is self-inverse; +1 defeats double-transpose folding
    dt = time_chained(_scan_chain(
        lambda c: local_permute(c, "xyzt", "tzyx") + 1.0, x, jnp.sum),
        50, 250)
    return 2 * x.size * 4 / dt / 1e9


def bench_eo_packed(lat=(8, 8, 16, 128), ncols=8):
    """Packed-checkerboard hopping (the even-odd solver's matvec)."""
    import jax.numpy as jnp

    from superbblas_tpu.models import wilson_operator
    from superbblas_tpu.models.eo_packed import (
        apply_hopping_packed_soa, cb_pack_soa, hopping_packed_soa)

    op = wilson_operator(lat, mass=0.1, key=0, dtype=jnp.complex64,
                         layout="soa")
    hop_o = hopping_packed_soa(op, 1)
    x = cb_pack_soa(_wilson_field(lat, ncols, jnp.float32), 0)
    dt = time_chained(_scan_chain(
        lambda c, b: apply_hopping_packed_soa(
            dataclasses.replace(hop_o, blocks=b), c, 1), x,
        lambda c: jnp.sum(jnp.abs(c.re)), hop_o.blocks), 20, 120)
    return hop_o.flops_per_matvec(ncols, complex_dtype=True) / dt / 1e9


def _bench_redist(dst_from, dim=(2048, 8192), masked=False, expect=None):
    """Explicit redistribution on one rank: a toroidally shifted full-box
    destination drives pack -> exchange -> unpack through a real plan.
    With one rank every piece is local, so this times pack and unpack,
    not the collective.  Returns GB/s (one read + one write)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from superbblas_tpu.parallel import Partition
    from superbblas_tpu.parallel.redistribute import (
        RedistributionPlan, _execute, _resolve_method)

    src = Partition(dim=dim, boxes=(((0, 0), dim),))
    dst = Partition(dim=dim, boxes=((dst_from, dim),))
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("p",))
    par = ((np.add.outer(np.arange(dim[0]), np.arange(dim[1])) % 2) == 0
           if masked else None)
    plan = RedistributionPlan(src, dst, "copy", mask_src=par, mask_dst=par)
    if expect is not None:
        assert expect(plan), (plan.block, plan.pack)
    method = _resolve_method("auto", mesh, "p")
    x = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(0), (1,) + dim, jnp.float32),
        NamedSharding(mesh, P("p", None, None)))
    dt = time_chained(_scan_chain(
        lambda c: _execute(plan, c, mesh, "p", method) + 1e-6, x, jnp.sum),
        20, 100)
    return 2 * x.size * 4 / dt / 1e9


def bench_redistribute(dim=(2048, 8192)):
    """Aligned shift: the wrap pieces share a fat common block."""
    return _bench_redist((dim[0] // 2, dim[1] // 4), dim)


def bench_redistribute_unaligned(dim=(2048, 8192)):
    """Box starts share no common divisor (gcd = 1): the "boxes" packer
    runs the seam-split pieces as static copies (dist.h:798-1010)."""
    return _bench_redist(
        (dim[0] // 2 - 1, 37), dim,
        expect=lambda p: p.block == 1 and p.pack == "boxes")


def bench_redistribute_masked(dim=(2048, 8192)):
    """The unaligned geometry with a parity mask on both ends, fused per
    piece (dist.h:944-970)."""
    return _bench_redist(
        (dim[0] // 2 - 1, 37), dim, masked=True,
        expect=lambda p: p.pack == "boxes" and p.mask_mult)


def bench_gather_halo(dim=(16, 8, 8, 32), nc=12, ncols=8):
    """Gather-mode matvec: a Wilson-like stencil plus one random extra
    neighbor per site within +-2 planes of X (defeats the near-uniform
    merge, so this IS the gather path), applied once and as power=2.
    Reference: the extended-domain BSR matvec, bsr.h:2020-2192.  Returns
    (GFLOP/s, GFLOP/s at power 2)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from superbblas_tpu import bsr as B
    from superbblas_tpu import cplx
    from superbblas_tpu.parallel import apply_gather_sharded

    rng = np.random.default_rng(0)
    nd = len(dim)
    offs = [(0,) * nd] + [
        tuple(s if a == mu else 0 for a in range(nd))
        for mu in range(nd) for s in (1, -1)]
    nnz = len(offs) + 1
    vol = int(np.prod(dim))
    grids = np.meshgrid(*[np.arange(d) for d in dim], indexing="ij")
    jj = np.zeros(dim + (nnz, nd), np.int64)
    for k, off in enumerate(offs):
        for a in range(nd):
            jj[..., k, a] = (grids[a] + off[a]) % dim[a]
    for a in range(nd):                      # the irregular extra row
        jj[..., nnz - 1, a] = rng.integers(0, dim[a], size=dim)
    jj[..., nnz - 1, 0] = (grids[0] + rng.integers(-2, 3, size=dim)) \
        % dim[0]
    ii = np.full(dim, nnz, np.int64)
    vals = rng.standard_normal(dim + (nnz, nc, nc)).astype(np.float32)
    op = B.create_bsr("xyzts", dim + (nc,), "xyztc", dim + (nc,),
                      (1,) * nd + (nc,), (1,) * nd + (nc,), ii, jj,
                      jnp.asarray(vals))
    assert op.mode == "gather", op.mode

    x = cplx.CArray(
        jax.random.normal(jax.random.PRNGKey(1), dim + (nc, ncols),
                          jnp.float32),
        jax.random.normal(jax.random.PRNGKey(2), dim + (nc, ncols),
                          jnp.float32))
    if len(jax.devices()) > 1:
        mesh = Mesh(np.asarray(jax.devices()), ("d",))
        axes = {c: ("d" if i == 0 else None) for i, c in enumerate("xyzt")}
        x = jax.device_put(
            x, NamedSharding(mesh, P("d", *([None] * (nd + 1)))))

        def apply(o, v, power):
            return apply_gather_sharded(o, v, mesh, axes, power=power)
    else:
        def apply(o, v, power):
            for _ in range(power):
                v = B.bsr_krylov(1.0, o, v, "xyztcn")
            return v
    # real blocks on complex fields: 4 * nnz * nc^2 * ncols flops per site
    flops = 4.0 * vol * nnz * nc * nc * ncols

    def run(power):
        def step(c, b):
            y = apply(dataclasses.replace(op, blocks=b), c, power)
            return cplx.CArray(y.re + 1e-6, y.im)
        return time_chained(_scan_chain(
            step, x, lambda c: jnp.sum(jnp.abs(c.re)), op.blocks), 10, 50)

    return flops / run(1) / 1e9, 2 * flops / run(2) / 1e9


def bench_shift(shape=(128, 64, 64, 128)):
    """Toroidal shift (the reference's tests/dist.cpp:303-330 benchmark);
    under a sharded mesh the same roll compiles to neighbor permutes."""
    import jax
    import jax.numpy as jnp

    x = jax.random.normal(jax.random.PRNGKey(0), shape, dtype=jnp.float32)
    dt = time_chained(_scan_chain(
        lambda c: jnp.roll(c, 1, axis=0) + 1.0, x, jnp.sum), 50, 250)
    return 2 * x.size * 4 / dt / 1e9


def main():
    import jax.numpy as jnp

    from superbblas_tpu.utils.compile_cache import enable_compile_cache
    from superbblas_tpu.utils.devinfo import (
        card_name_and_power, device_record)

    enable_compile_cache()
    device = device_record()
    peak = peaks_for(device["kind"])
    device["card"] = card_name_and_power()
    hbm, bf16 = peak["hbm_bytes"], peak["bf16_flops"]

    def emit(metric, value, unit, peak_value, bound):
        # values are GFLOP/s or GB/s; peaks are FLOP/s or B/s
        print(json.dumps({
            "metric": metric, "value": value, "unit": unit,
            "roofline_share": value * 1e9 / peak_value, "bound": bound,
            "device": device}), flush=True)

    emit("dense_contraction_gflops", bench_contraction(), "GFLOP/s",
         bf16, "bf16_flops")
    # the matvec is bandwidth-bound: score its one-pass traffic model
    gf, gb = bench_bsr()
    emit("bsr_wilson_matvec_gflops", gf, "GFLOP/s", peak["f32_flops"],
         "f32_flops")
    emit("bsr_wilson_matvec_gbps", gb, "GB/s", hbm, "hbm_bytes")
    _, gb16 = bench_bsr(storage=jnp.bfloat16, x_dtype=jnp.bfloat16)
    emit("bsr_wilson_matvec_bf16_gbps", gb16, "GB/s", hbm, "hbm_bytes")
    emit("permute_copy_bandwidth", bench_copy(), "GB/s", hbm, "hbm_bytes")
    emit("unaligned_redistribution_bandwidth",
         bench_redistribute_unaligned(), "GB/s", hbm, "hbm_bytes")
    emit("masked_redistribution_bandwidth", bench_redistribute_masked(),
         "GB/s", hbm, "hbm_bytes")
    gh, gh2 = bench_gather_halo()
    emit("gather_halo_matvec_gflops", gh, "GFLOP/s", peak["f32_flops"],
         "f32_flops")
    if "--all" not in sys.argv:
        return
    emit("gather_halo_matvec_power2_gflops", gh2, "GFLOP/s",
         peak["f32_flops"], "f32_flops")
    _, gbs = bench_bsr(storage=jnp.bfloat16)
    emit("bsr_wilson_matvec_bf16_storage_gbps", gbs, "GB/s", hbm,
         "hbm_bytes")
    emit("eo_packed_hopping_gflops", bench_eo_packed(), "GFLOP/s",
         peak["f32_flops"], "f32_flops")
    emit("shift_redistribution_bandwidth", bench_shift(), "GB/s", hbm,
         "hbm_bytes")
    emit("explicit_redistribution_bandwidth", bench_redistribute(), "GB/s",
         hbm, "hbm_bytes")


if __name__ == "__main__":
    main()
