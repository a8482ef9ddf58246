"""Coarse-grid (multigrid) lattice operator: big dense blocks.

Multigrid solvers for lattice QCD coarsen the Dirac operator onto a small
lattice with LARGE dense blocks (N_c = 2 x number of near-null vectors,
typically 24-64).  Structurally it is the plain BSR case with no
Kronecker factorization and no algebraic structure in the blocks — the
workload the reference's generic block-CSR backends exist for
(tests/bsr.cpp sweeps block sizes for exactly this reason).

This regime is the GEMM path of the stencil engine: with 32x32+ blocks
the stacked per-direction contraction in ``_apply_stencil`` is a
batched GEMM with K = ndir * N_c, unlike the bandwidth-bound 3x3/4x4
Wilson blocks.

The generated operator is gamma5-symmetric in the coarse sense
(A_{-k}(s + o_k) = A_k(s)^H), making it Hermitian up to the mass shift —
the property coarse operators inherit from fine-grid Galerkin coarsening.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import cplx
from ..bsr import BSROperator, bsr_from_stencil, bsr_krylov

__all__ = ["coarse_operator", "apply_coarse"]


def coarse_operator(
    lat_dims: Tuple[int, ...],
    block_size: int = 32,
    mass: float = 0.1,
    key=None,
    dtype=jnp.complex64,
) -> BSROperator:
    """Random Hermitian coarse operator: center m*I + sum of Hermitian-
    paired nearest-neighbor blocks (A_{-mu}(s+mu) = A_{+mu}(s)^H)."""
    nd = len(lat_dims)
    from .wilson import _seed_from_key

    rng = np.random.default_rng(_seed_from_key(key))
    nc = block_size

    def rand_blocks():
        a = (rng.standard_normal(tuple(lat_dims) + (nc, nc))
             + 1j * rng.standard_normal(tuple(lat_dims) + (nc, nc)))
        return a / np.sqrt(nc)

    eye = np.broadcast_to(np.eye(nc, dtype=np.complex128),
                          tuple(lat_dims) + (nc, nc))
    center = mass * eye + 0j
    # Hermitian site-local correction
    h = rand_blocks()
    center = center + 0.5 * (h + np.swapaxes(h, -1, -2).conj())

    offsets = [(0,) * nd]
    blocks = [center]
    for mu in range(nd):
        fwd = [0] * nd
        fwd[mu] = 1
        a = rand_blocks()
        offsets.append(tuple(fwd))
        blocks.append(a)
        bwd = [0] * nd
        bwd[mu] = -1
        offsets.append(tuple(bwd))
        # A_{-mu}(s) = A_{+mu}(s - mu)^H  -> overall Hermitian operator
        blocks.append(np.swapaxes(np.roll(a, 1, axis=mu), -1, -2).conj())

    part_dt = np.float32 if dtype == jnp.complex64 else np.float64
    vals = np.stack(blocks, axis=nd)
    lat_labels = "xyzt"[:nd]
    return bsr_from_stencil(
        lat_labels + "c", lat_labels + "C",
        lat_dims, {"c": nc}, {"C": nc},
        offsets,
        cplx.CArray(vals.real.astype(part_dt),
                    vals.imag.astype(part_dt)),
    )


def apply_coarse(op: BSROperator, x):
    """y = A x; x: [*lat, N_c, ncols] (CArray or complex)."""
    nd = len(op.dim_d)
    return bsr_krylov(1.0, op, x, "xyzt"[:nd] + "Cn")
