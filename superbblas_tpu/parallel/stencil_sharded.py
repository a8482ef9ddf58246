"""Sharded execution of the SoA stencil kernel in an explicit shard_map.

Under GSPMD the kernel partitions itself (``ops/stencil_pallas.py``:
one halo exchange per apply, X/Y lattice sharding).  This explicit form
is for callers that hold a mesh and want to control the exchange: one
``shard_map`` that

  1. ppermutes a halo shell of width = stencil radius along each sharded
     lattice axis (blocks and x),
  2. runs the kernel on the locally-extended block — its internal
     toroidal wraps are wrong only in the outermost shell, which is
     exactly the halo (the shell-contamination argument of
     parallel/powers.py),
  3. crops the exact core.

This composes with operator powers: pass ``power=p`` to exchange a
p-shell halo ONCE and apply the kernel p times locally (the
communication-avoiding okr scheme on the hot path).

Constraints: the kernel's lattice-shape rules apply to the *extended
local* block (4D lattice); only X and/or Y may be sharded.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec

from .. import cplx
from ..bsr import BSROperator
from ..labels import volume
from .halo import crop_halos, extend_local as _extend

__all__ = ["apply_stencil_soa_sharded"]


def apply_stencil_soa_sharded(
    op: BSROperator,
    x: cplx.CArray,
    mesh: Mesh,
    axes: Dict[str, Optional[str]],
    power: int = 1,
    interpret: bool = False,
):
    """y = A^power x on a lattice-sharded SoA operand through the stencil
    kernel (one halo exchange total).

    ``x``: CArray [n, KD*BD, X, Y, Z, T] sharded on lattice axes per
    ``axes`` (lattice label -> mesh axis; only the first two lattice
    axes may be sharded).  ``op`` must be an SoA-layout operator with the
    same sharding on its blocks.  Returns [n, KI*BI, X, Y, Z, T] with the
    input sharding.  ``interpret=True`` runs the kernel in the Pallas
    interpreter (the virtual-CPU-mesh validation path).
    """
    if op.mode != "stencil_soa":
        raise ValueError("requires an SoA-layout stencil operator")
    nlat = len(op.dim_d)
    radius = [max((abs(o[ax]) for o in op.offsets), default=0)
              for ax in range(nlat)]
    # SoA layout: lattice axes are the trailing nlat axes; array axis of
    # lattice axis k is (array.ndim - nlat + k)
    ax_names: Dict[int, int] = {}
    widths: Dict[int, int] = {}
    for k, c in enumerate(op.lat_d):
        nm = axes.get(c)
        if nm is None or mesh.shape[nm] == 1 or radius[k] == 0:
            continue
        if k >= 2:
            raise ValueError(
                "only the first two lattice axes (X, Y) may be sharded")
        if op.dim_d[k] % mesh.shape[nm]:
            raise ValueError(f"lattice axis {c!r} must divide evenly")
        w = power * radius[k]
        if w > op.dim_d[k] // mesh.shape[nm]:
            raise ValueError("halo width exceeds the local shard extent")
        ax_names[k] = nm
        widths[k] = w

    spec_lat = tuple(axes.get(c) for c in op.lat_d)
    spec_x = PartitionSpec(None, None, *spec_lat)
    spec_b = PartitionSpec(None, None, *spec_lat)

    nx_lead = 2  # [n|ndir, features] lead both operands

    def body(blocks_l, x_l):
        ax_arr_b = {nx_lead + k: nm for k, nm in ax_names.items()}
        w_arr = {nx_lead + k: widths[k] for k in widths}
        blocks_e = _extend(blocks_l, ax_arr_b, w_arr, mesh)
        x_e = _extend(x_l, ax_arr_b, w_arr, mesh)
        loc_dim = tuple(x_e.shape[2:])
        lop = BSROperator(
            oim=op.oim, odm=op.odm, lat_i=op.lat_i, lat_d=op.lat_d,
            blk_i=op.blk_i, blk_d=op.blk_d, dim_i=loc_dim, dim_d=loc_dim,
            bi=op.bi, bd=op.bd, mode="stencil_soa", blocks=blocks_e,
            offsets=op.offsets,
            kron=op.kron,
            kron_i=op.kron_i, kron_d=op.kron_d, ki=op.ki, kd=op.kd,
        )
        from ..bsr import apply_stencil_soa

        cur = x_e
        for _ in range(power):
            cur = apply_stencil_soa(lop, cur, interpret=interpret)

        return crop_halos(cur, w_arr)

    # the replicated spin factors are closed over, not passed: concrete
    # factors stay trace-time constants of the kernel body
    return shard_map(
        body, mesh=mesh,
        in_specs=(spec_b, spec_x),
        out_specs=spec_x,
        check_vma=False,
    )(op.blocks, x)
