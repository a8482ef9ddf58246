"""The SoA Wilson stencil on a GPU: the Pallas kernel against the same
per-site body left to XLA.

    python experiments/stencil_vs_xla.py [--lat 32 32 32 64] [--nrhs 12]

Both versions drive ``_matvec_body`` of ``ops/stencil_pallas.py``; the
XLA one finds each neighbour with ``jnp.roll``.  Each is timed as one
jitted ``fori_loop`` chain of ``--chain`` applies (best of ``--repeats``,
host clock around ``block_until_ready``), with f32 links and with
bf16-stored links, f32 fields.  The links enter every jitted program as
an argument.  Both are checked against the einsum reference at
``highest`` precision.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp

from superbblas_tpu import cplx
from superbblas_tpu.bsr import apply_stencil_soa, bsr_cast_storage
from superbblas_tpu.models import wilson_operator
from superbblas_tpu.ops.stencil_pallas import (
    _factor_kron, _matvec_body, stencil_matvec_soa_reference)
from superbblas_tpu.utils.compile_cache import enable_compile_cache
from superbblas_tpu.utils.devinfo import card_name_and_power


def xla_matvec(op, x):
    """The kernel's per-site body over whole lattice fields, neighbours by
    ``jnp.roll``: what XLA makes of the same arithmetic."""
    bi = bd = 3
    kron = op.kron
    KI, KD = kron.shape[1], kron.shape[2]
    acc = jnp.float32
    out = {}

    def shifted(d):
        off = op.offsets[d]

        @functools.cache
        def xs(f):
            def sh(a):
                a = a[:, f].astype(acc)
                for ax, o in enumerate(off):
                    if o:
                        a = jnp.roll(a, -o, axis=1 + ax)
                return a
            return sh(x.re), sh(x.im)
        return xs

    def bload(d, i, j):
        return (op.blocks.re[d, i * bd + j].astype(acc),
                op.blocks.im[d, i * bd + j].astype(acc))

    def store(sp, i, v):
        out[sp * bi + i] = v

    _matvec_body(shifted, bload, store,
                 lambda: jnp.zeros((x.shape[0],) + x.shape[2:], acc),
                 lambda d, a, b: (kron.re[d, a, b], kron.im[d, a, b]),
                 ndir=op.blocks.shape[0], BI=bi, BD=bd, KI=KI, KD=KD,
                 kfact=_factor_kron(kron.re, kron.im))
    part = lambda k: jnp.stack([out[r][k] for r in range(KI * bi)],
                               1).astype(x.dtype)
    return cplx.CArray(part(0), part(1))


def time_chain(apply, op, x, chain, repeats):
    """Best seconds per apply over ``repeats`` runs of a ``chain``-long
    jitted loop, and the first apply's output."""
    def run(blocks, v, n):
        o = dataclasses.replace(op, blocks=blocks)
        return jax.lax.fori_loop(0, n, lambda _, c: apply(o, c), v)

    f = jax.jit(run, static_argnums=2)
    t0 = time.perf_counter()
    y = jax.block_until_ready(f(op.blocks, x, 1))
    t_compile = time.perf_counter() - t0
    jax.block_until_ready(f(op.blocks, x, chain))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(f(op.blocks, x, chain))
        best = min(best, time.perf_counter() - t0)
    return best / chain, t_compile, y


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lat", type=int, nargs=4, default=(32, 32, 32, 64))
    ap.add_argument("--nrhs", type=int, default=12)
    ap.add_argument("--chain", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    enable_compile_cache()
    print(card_name_and_power(), flush=True)
    lat = tuple(args.lat)
    op32 = wilson_operator(lat, mass=0.1, key=0, layout="soa")
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    shape = (args.nrhs, 12) + lat
    x = cplx.CArray(jax.random.normal(k1, shape), jax.random.normal(k2, shape))
    kernel = lambda o, v: apply_stencil_soa(o, v)
    for links, op in (("f32", op32),
                      ("bf16-links", bsr_cast_storage(op32, jnp.bfloat16))):
        with jax.default_matmul_precision("highest"):
            want = jax.jit(lambda b, v: stencil_matvec_soa_reference(
                cplx.cmap(lambda a: a.astype(jnp.float32), b), op.kron, v,
                op.offsets, 3, 3))(op.blocks, x)
        den = float(jnp.maximum(jnp.max(jnp.abs(want.re)),
                                jnp.max(jnp.abs(want.im))))
        for name, apply in (("kernel", kernel), ("xla", xla_matvec)):
            dt, t_compile, y = time_chain(apply, op, x, args.chain,
                                          args.repeats)
            err = max(float(jnp.max(jnp.abs(y.re - want.re))),
                      float(jnp.max(jnp.abs(y.im - want.im)))) / den
            print(f"{name} {links} {lat} x {args.nrhs} rhs: "
                  f"{dt * 1e3:.3f} ms per apply (compile {t_compile:.1f} s, "
                  f"max|dy|/max|y| {err:.2e})", flush=True)


if __name__ == "__main__":
    main()
