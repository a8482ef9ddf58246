"""Smoke check of the main path on one NVIDIA GPU (or four with
``--four-cards``).

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --four-cards # the sharded matvec and solve
                                      # and the redistribution exchange

Phases on one card, all through the public entry points:

1. kernel: the SoA stencil path against ``stencil_matvec_soa_reference``
   on the Wilson operator at 32x32x32x64 with 12 right-hand sides, for
   the full matvec and the packed even-odd hopping terms, in three
   precisions (f32; bf16-stored links; bf16 links and fields);
2. solve: CGNE on D x = b (tolerance 1e-6), then the true residual of
   every column against the reference operator;
3. contraction: ``local_contraction`` in bf16 and split-complex f32;
4. checkpoint: ``storage.save_sharded`` / ``load_sharded`` of the gauge
   blocks, bit-exact.

References run under ``jax.default_matmul_precision("highest")`` (a
float32 product may otherwise run in TF32 on the card).  Any failed
check exits non-zero before the last line, which is a JSON record of
the device.  Without a GPU the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time

import numpy as np

LAT = (32, 32, 32, 64)
NRHS = 12
MASS = 0.1


class SmokeFailure(RuntimeError):
    pass


def check(name, value, limit):
    """Print a measured error beside its limit; fail when it is over."""
    ok = bool(np.isfinite(value)) and value <= limit
    print(f"[{'ok' if ok else 'FAIL'}] {name}: {value:.3e} (limit {limit:.0e})",
          flush=True)
    if not ok:
        raise SmokeFailure(f"{name}: {value} > {limit}")


def _rel_max(got, want):
    """max|got - want| / max|want| over both parts of CArrays."""
    import jax.numpy as jnp

    num = max(float(jnp.max(jnp.abs(g.astype(jnp.float32) - w)))
              for g, w in ((got.re, want.re), (got.im, want.im)))
    den = max(float(jnp.max(jnp.abs(w))) for w in (want.re, want.im))
    return num / den


def _field(key, shape, dtype):
    import jax

    from superbblas_tpu import cplx

    k1, k2 = jax.random.split(key)
    return cplx.CArray(jax.random.normal(k1, shape).astype(dtype),
                       jax.random.normal(k2, shape).astype(dtype))


def _f32(c):
    import jax.numpy as jnp

    from superbblas_tpu import cplx

    return cplx.cmap(lambda a: a.astype(jnp.float32), c)


def kernel_phase(op, key, lat=LAT, nrhs=NRHS):
    """The stencil path against the reference in three precisions, for
    the full matvec and the packed hopping onto each parity."""
    import jax
    import jax.numpy as jnp

    from superbblas_tpu.bsr import apply_stencil_soa, bsr_cast_storage
    from superbblas_tpu.models.eo_packed import hopping_packed_soa
    from superbblas_tpu.ops.stencil_pallas import stencil_matvec_soa_reference

    def reference(o, v, pp):
        with jax.default_matmul_precision("highest"):
            return jax.jit(lambda b, k, x: stencil_matvec_soa_reference(
                b, k, x, o.offsets, 3, 3, packed_parity=pp))(
                    _f32(o.blocks), o.kron, _f32(v))

    half = (lat[0] // 2,) + tuple(lat[1:])
    cases = (("f32", None, jnp.float32, 1e-5),
             ("bf16-links", jnp.bfloat16, jnp.float32, 1e-5),
             ("bf16", jnp.bfloat16, jnp.bfloat16, 1e-2))
    for name, links, fields, limit in cases:
        o = op if links is None else bsr_cast_storage(op, links)
        terms = [("matvec", o, None, lat)] + [
            (f"hopping parity {p}", hopping_packed_soa(o, p), p, half)
            for p in (0, 1)]
        for term, t_op, pp, t_lat in terms:
            x = _field(key, (nrhs, 12) + t_lat, fields)
            got = jax.jit(lambda bl, v: apply_stencil_soa(
                dataclasses.replace(t_op, blocks=bl), v,
                packed_parity=pp))(t_op.blocks, x)
            check(f"kernel {name} {term} max|dy|/max|y|",
                  _rel_max(got, reference(t_op, x, pp)), limit)


def solve_phase(op, key, lat=LAT, nrhs=NRHS, sharding=None):
    """CGNE on D x = b; returns the solution after checking the true
    residual of every column.  With ``sharding`` the right-hand side is
    placed so (the blocks of ``op`` are already), and GSPMD partitions
    the solve."""
    import jax
    import jax.numpy as jnp

    from superbblas_tpu import cplx, solvers
    from superbblas_tpu.models import adjoint_operator, apply_wilson
    from superbblas_tpu.ops.stencil_pallas import stencil_matvec_soa_reference

    b = _field(key, (nrhs, 12) + lat, jnp.float32)
    if sharding is not None:
        b = cplx.cmap(lambda a: jax.device_put(a, sharding), b)

    def solve(blocks, rhs):
        # the blocks enter as an argument (not a jit constant); the spin
        # factors stay trace-time constants for the stencil body
        o = dataclasses.replace(op, blocks=blocks)
        o_h = adjoint_operator(o)
        return solvers.cgne(lambda v: apply_wilson(o, v),
                            lambda v: apply_wilson(o_h, v),
                            rhs, tol=1e-6, maxiter=1000)

    t0 = time.perf_counter()
    compiled = jax.jit(solve).lower(op.blocks, b).compile()
    t_compile = time.perf_counter() - t0
    print(f"solve compile seconds: {t_compile:.2f}", flush=True)
    print(f"solve memory_analysis: {compiled.memory_analysis()}", flush=True)
    t0 = time.perf_counter()
    x, rs, iters = jax.block_until_ready(compiled(op.blocks, b))
    t_solve = time.perf_counter() - t0
    iters = int(iters)
    print(f"solve seconds: {t_solve:.3f}  CGNE iterations: {iters}",
          flush=True)
    if iters >= 1000:
        raise SmokeFailure("CGNE did not converge in 1000 iterations")

    with jax.default_matmul_precision("highest"):
        dx = jax.jit(lambda bl, k, v: stencil_matvec_soa_reference(
            bl, k, v, op.offsets, 3, 3))(op.blocks, op.kron, x)
    r = cplx.add(b, cplx.scale(-1.0, dx))
    norm = lambda c: jnp.sqrt(jnp.sum(c.re ** 2 + c.im ** 2,
                                      axis=tuple(range(1, c.re.ndim))))
    res = np.asarray(norm(r) / norm(b))
    print(f"true residuals |b - D x|/|b| per column: "
          f"{np.array2string(res, precision=3)}", flush=True)
    check("solve worst true residual", float(res.max()), 1e-4)
    return x


def contraction_phase(key):
    import jax
    import jax.numpy as jnp

    from superbblas_tpu import cplx, local_contraction

    T, A, B, C = 8, 1024, 1024, 1024
    k0, k1, k2 = jax.random.split(key, 3)
    x0 = jax.random.normal(k0, (T, A, B), jnp.bfloat16)
    x1 = jax.random.normal(k1, (T, A, C), jnp.bfloat16)
    got = jax.jit(lambda a, b: local_contraction(
        1.0, a, "tab", False, b, "tac", False, 0.0, None, "tbc"))(x0, x1)
    with jax.default_matmul_precision("highest"):
        want = jnp.einsum("tab,tac->tbc", x0.astype(jnp.float32),
                          x1.astype(jnp.float32))
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want))
                / jnp.max(jnp.abs(want)))
    check("contraction bf16 8x1024^3 rel err", err, 1e-2)

    shp0, shp1 = (4, 256, 192), (4, 256, 160)
    rng = np.random.default_rng(int(jax.random.randint(k2, (), 0, 2**30)))
    a = rng.standard_normal(shp0) + 1j * rng.standard_normal(shp0)
    b = rng.standard_normal(shp1) + 1j * rng.standard_normal(shp1)
    ca = cplx.CArray(jnp.asarray(a.real, jnp.float32),
                     jnp.asarray(a.imag, jnp.float32))
    cb = cplx.CArray(jnp.asarray(b.real, jnp.float32),
                     jnp.asarray(b.imag, jnp.float32))
    got = jax.jit(lambda u, v: local_contraction(
        1.0, u, "tab", True, v, "tac", False, 0.0, None, "tbc"))(ca, cb)
    want = np.einsum("tab,tac->tbc", a.conj(), b)
    got_c = np.asarray(got.re, np.float64) + 1j * np.asarray(got.im)
    check("contraction split-complex f32 rel err",
          float(np.max(np.abs(got_c - want)) / np.max(np.abs(want))), 1e-4)


def checkpoint_phase(op):
    import jax
    import jax.numpy as jnp

    from superbblas_tpu import storage as st

    blocks = op.blocks
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/gauge.s3t"
        t0 = time.perf_counter()
        sto = st.create_storage(path, "dcxyzt", blocks.shape,
                                dtype=np.complex64)
        st.save_sharded(sto, blocks, "dcxyzt")
        st.close_storage(sto)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        sto = st.open_storage(path, mode="r")
        back = st.load_sharded(sto, blocks.re.sharding)
        jax.block_until_ready(back)
        st.close_storage(sto)
        t_load = time.perf_counter() - t0
    same = all(bool(jnp.array_equal(g, w))
               for g, w in ((back.re, blocks.re), (back.im, blocks.im)))
    nbytes = 2 * blocks.re.nbytes
    print(f"checkpoint {nbytes / 1e9:.2f} GB: save {t_save:.2f} s, "
          f"load {t_load:.2f} s, bit-exact {same}", flush=True)
    if not same:
        raise SmokeFailure("checkpoint round trip is not bit-exact")


def four_card_phase(op, key, x_one, lat=LAT, nrhs=NRHS):
    """On a 1-D mesh of 4 cards with the lattice sharded over X: one
    matvec under GSPMD (the kernel's own partitioning: no all-gather)
    and through the explicit shard_map path, both against one card; the
    solve under GSPMD against the one-card solution; and the ragged and
    dense redistribution exchange against a host oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from superbblas_tpu import cplx
    from superbblas_tpu.models import apply_wilson
    from superbblas_tpu.parallel import apply_stencil_soa_sharded

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("d",))
    spec = NamedSharding(mesh, P(None, None, "d", None, None, None))
    put = lambda c: cplx.cmap(lambda a: jax.device_put(a, spec), c)
    one = lambda c: cplx.cmap(
        lambda a: jax.device_put(a, x_one.re.sharding), c)
    op_sh = dataclasses.replace(op, blocks=put(op.blocks))

    v = _field(jax.random.fold_in(key, 1), (nrhs, 12) + lat, jnp.float32)
    apply = jax.jit(lambda bl, u: apply_wilson(
        dataclasses.replace(op, blocks=bl), u))
    compiled = apply.lower(op_sh.blocks, put(v)).compile()
    gathers = compiled.as_text().count("all-gather")
    print(f"[{'ok' if gathers == 0 else 'FAIL'}] 4-card GSPMD matvec "
          f"all-gather ops: {gathers} (limit 0)", flush=True)
    if gathers:
        raise SmokeFailure("the sharded matvec gathers its operands")
    y_one = apply(op.blocks, v)
    check("4-card GSPMD vs 1-card matvec max|dy|/max|y|",
          _rel_max(one(compiled(op_sh.blocks, put(v))), y_one), 1e-5)
    y_sm = jax.jit(lambda bl, u: apply_stencil_soa_sharded(
        dataclasses.replace(op, blocks=bl), u, mesh, {"x": "d"}))(
            op_sh.blocks, put(v))
    check("4-card shard_map vs 1-card matvec max|dy|/max|y|",
          _rel_max(one(y_sm), y_one), 1e-5)
    del y_one, y_sm

    x4 = solve_phase(op_sh, key, lat, nrhs, sharding=spec)
    check("4-card vs 1-card solution max|dx|/max|x|",
          _rel_max(one(x4), x_one), 1e-4)
    exchange_phase(4)


def exchange_phase(n):
    """Ragged and dense explicit redistribution over n devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from superbblas_tpu.parallel import basic_partitioning
    from superbblas_tpu.parallel import redistribute as R

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("p",))
    dim = (2 * n, 6)
    src = basic_partitioning("xy", dim, (n, 1))
    dst = basic_partitioning("xy", dim, (1, min(n, 6)), nprocs=n)
    x = np.arange(np.prod(dim), dtype=np.float32).reshape(dim)
    stack = jax.device_put(jnp.asarray(R.pack_global(x, src)),
                           NamedSharding(mesh, P("p", None, None)))
    print(f"redistribution auto method on this mesh: "
          f"{R._resolve_method('auto', mesh, 'p')}", flush=True)
    for method in ("ragged", "dense"):
        out = R.redistribute_explicit(stack, src, dst, mesh, method=method)
        got = R.unpack_global(np.asarray(out), dst)
        ok = np.array_equal(got, x)
        print(f"[{'ok' if ok else 'FAIL'}] {method} redistribution over "
              f"{n} devices matches the host oracle", flush=True)
        if not ok:
            raise SmokeFailure(f"{method} redistribution mismatch")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded solve and exchange")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from superbblas_tpu.utils.compile_cache import enable_compile_cache
    from superbblas_tpu.utils.devinfo import (
        card_name_and_power, device_record)

    device = device_record()
    if device["platform"] != "gpu":
        print(f"no GPU found (JAX platform {device['platform']!r}); this "
              f"check runs only on an NVIDIA card", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if device["count"] < need:
        print(f"needs {need} GPUs, found {device['count']}", file=sys.stderr)
        return 2
    enable_compile_cache()
    print(card_name_and_power(), flush=True)   # name, power limit
    print(f"jax {jax.__version__}, devices: {jax.devices()}", flush=True)

    from superbblas_tpu.models import wilson_operator

    key = jax.random.PRNGKey(args.seed)
    k_kernel, k_solve, k_contract = jax.random.split(key, 3)
    t0 = time.perf_counter()
    op = wilson_operator(LAT, mass=MASS, key=args.seed, layout="soa")
    jax.block_until_ready(op.blocks)
    print(f"operator {LAT} built in {time.perf_counter() - t0:.2f} s "
          f"(links {2 * op.blocks.re.nbytes / 1e9:.2f} GB)", flush=True)
    try:
        if args.four_cards:
            x_one = solve_phase(op, k_solve)
            four_card_phase(op, k_solve, x_one)
        else:
            kernel_phase(op, k_kernel)
            solve_phase(op, k_solve)
            contraction_phase(k_contract)
            checkpoint_phase(op)
    except SmokeFailure as e:
        print(f"smoke check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
