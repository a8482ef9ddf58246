"""Core/halo split stencil application with comm/compute overlap.

The reference overlaps communication and computation by splitting the
lattice operator into a *core* operator (connections that stay inside the
local domain, applied with ``just_local`` so no messages are posted,
bsr.h:2353-2359) and a *halo* operator (connections crossing the domain
boundary, applied after the exchange completes) — the scheme built by
``create_lattice_split`` in the reference test driver
(tests/bsr.cpp:402-530).

Here the split happens inside one ``shard_map``:

  1. boundary slabs are posted with ``lax.ppermute`` — XLA lowers these
     to async collective-permute start/done pairs;
  2. the **core** contribution is one big stacked-GEMM stencil matvec in
     which cross-boundary neighbor operands are zero-filled instead of
     rolled — it has NO data dependence on the permutes, so the compiler
     schedules it between start and done (the overlap);
  3. the **halo** contribution adds, per crossing direction, the
     edge-slab micro-matvec against the received slab.

``just_local=True`` returns only step 2 — the exact analog of the
reference's ``just_local`` flag (operator applied to locally-available
data only).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec

from .. import cplx
from ..bsr import BSROperator, _apply_stencil, _idx, _reshape
from ..labels import check_order, volume
from ..ops.copy import _is_static, local_permute

__all__ = ["bsr_krylov_overlap"]


def _zshift(a, ax: int, o: int):
    """y[i] = a[i + o] with zero fill (no wraparound)."""
    L = a.shape[ax]
    pad_shape = a.shape[:ax] + (min(abs(o), L),) + a.shape[ax + 1:]
    zeros = jnp.zeros(pad_shape, a.dtype)
    if abs(o) >= L:
        return jnp.zeros_like(a)
    sl = [slice(None)] * a.ndim
    if o > 0:
        sl[ax] = slice(o, L)
        return jnp.concatenate([a[tuple(sl)], zeros], axis=ax)
    sl[ax] = slice(0, L + o)
    return jnp.concatenate([zeros, a[tuple(sl)]], axis=ax)


def _shift_core(x, off, nlat, zero_axes):
    """Neighbor-fetch shift for the core matvec: toroidal roll on local
    axes, zero-fill across shard boundaries."""

    def sh(a):
        for ax, o in enumerate(off):
            if ax in zero_axes:
                if o != 0:
                    a = _zshift(a, ax, o)
            elif o % a.shape[ax] != 0:
                a = jnp.roll(a, -o, axis=ax)
        return a

    return cplx.cmap(sh, x) if cplx.is_carray(x) else sh(x)


def _dir_contribution(op: BSROperator, blk_slab, xs_slab, k: int, nlat: int):
    """Contribution of direction k on an edge slab.

    blk_slab: [*slab, BI, BD]; xs_slab: [*slab, KD?, BD, N].
    Returns [*slab, KI?, BI, N] matching ``_apply_stencil``'s output."""
    from ..bsr import _acc_dtype

    if op.kron is None:
        y = cplx.cdot_general(
            blk_slab, xs_slab,
            dimension_numbers=(
                ((nlat + 1,), (nlat,)),
                (tuple(range(nlat)), tuple(range(nlat))),
            ),
            preferred_element_type=_acc_dtype(blk_slab.dtype),
        )
        return y.astype(xs_slab.dtype)
    t = cplx.cdot_general(
        blk_slab, xs_slab,
        dimension_numbers=(
            ((nlat + 1,), (nlat + 1,)),
            (tuple(range(nlat)), tuple(range(nlat))),
        ),
        preferred_element_type=_acc_dtype(blk_slab.dtype),
    ).astype(xs_slab.dtype)  # [*slab, BI, KD, N]
    yk = cplx.cbilinear(
        lambda kk, tt: jnp.einsum("ab,...ibn->...ian", kk, tt,
                                  precision=cplx.default_precision()),
        _idx(op.kron, k), t,
    )  # [*slab, BI, KI, N]
    sw = lambda v: jnp.swapaxes(v, nlat, nlat + 1)
    return cplx.cmap(sw, yk) if cplx.is_carray(yk) else sw(yk)


def bsr_krylov_overlap(
    alpha,
    op: BSROperator,
    x,
    ox: str,
    mesh: Mesh,
    axes: Dict[str, Optional[str]],
    beta=0.0,
    y=None,
    oy: Optional[str] = None,
    just_local: bool = False,
):
    """y = alpha * A x (+ beta * y) with an explicit core/halo split.

    Same semantics as ``bsr_krylov`` on a stencil operator whose sharded
    lattice axes are given by ``axes`` (label -> mesh axis name), but the
    collective-permute halo exchange is explicitly overlapped with the
    core matvec.  ``just_local=True`` skips the exchange entirely and
    returns only the core contribution (reference ``just_local``,
    bsr.h:2353-2359) — boundary-crossing neighbor terms are dropped.
    """
    if op.mode not in ("stencil", "gather"):
        raise ValueError("the overlap path runs on stencil or gather "
                         "operators; SoA operators have "
                         "apply_stencil_soa_sharded")
    check_order(ox)
    user_complex = (not cplx.is_carray(x)) and jnp.iscomplexobj(x)
    if user_complex:
        x = cplx.from_complex(x)
        if y is not None and not cplx.is_carray(y):
            y = cplx.from_complex(y)

    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    if oy is None:
        oy = op.lat_i + op.kron_i + op.blk_i + cols
    check_order(oy)

    canon_x = op.lat_d + op.kron_d + op.blk_d + cols
    xc = local_permute(x, ox, canon_x)
    nlat = len(op.dim_d)
    lat_shape = xc.shape[:nlat]
    KD = volume(op.kd) if op.kron is not None else 1
    BD = volume(op.bd)
    N = volume(xc.shape[nlat + len(op.kron_d) + len(op.blk_d):])
    xc = _reshape(xc, lat_shape + ((KD, BD, N) if op.kron is not None
                                   else (BD, N)))
    x_trail = (xc.re.ndim if cplx.is_carray(xc) else xc.ndim) - nlat

    if op.mode == "gather":
        # IRREGULAR operators: the halo-plan overlap executor (per-slot
        # core/crossing split; gather_sharded.apply_gather_overlap)
        if any(axes.get(c) is not None and mesh.shape[axes[c]] > 1
               for c in op.lat_d):
            from .gather_sharded import apply_gather_overlap

            yc = apply_gather_overlap(op, xc, mesh, axes,
                                      just_local=just_local)
        else:
            # unsharded: nothing crosses — just_local == the full apply
            from ..bsr import _apply_gather, _apply_gather_kron

            fn = _apply_gather_kron if op.kron is not None else _apply_gather
            yc = fn(op, xc)
        return _finish_overlap(op, x, ox, oy, cols, alpha, beta, y, yc,
                               user_complex)

    radius = [max((abs(o[ax]) for o in op.offsets), default=0)
              for ax in range(nlat)]
    ax_names: Dict[int, str] = {}
    for ax, c in enumerate(op.lat_d):
        nm = axes.get(c)
        if nm is None or mesh.shape[nm] == 1 or radius[ax] == 0:
            continue
        if op.dim_d[ax] % mesh.shape[nm]:
            raise ValueError(
                f"lattice axis {c!r} must divide evenly over mesh axis {nm!r}")
        if radius[ax] > op.dim_d[ax] // mesh.shape[nm]:
            raise ValueError("stencil radius exceeds the local shard extent")
        ax_names[ax] = nm
    for off in op.offsets:
        crossing = [ax for ax in ax_names if off[ax] != 0]
        if len(crossing) > 1:
            raise NotImplementedError(
                "corner-crossing stencil directions (offsets along two "
                "sharded axes) are not supported by the overlap path")

    spec_lat = tuple(axes.get(c) for c in op.lat_d)
    spec_x = PartitionSpec(*spec_lat, *([None] * x_trail))
    spec_b = PartitionSpec(*spec_lat, None, None, None)
    spec_out = PartitionSpec(*spec_lat, *([None] * x_trail))

    def body(blocks_l, kron_l, xc_l):
        loc_dim = tuple(xc_l.shape[:nlat])
        lop = BSROperator(
            oim=op.oim, odm=op.odm, lat_i=op.lat_i, lat_d=op.lat_d,
            blk_i=op.blk_i, blk_d=op.blk_d, dim_i=loc_dim, dim_d=loc_dim,
            bi=op.bi, bd=op.bd, mode="stencil", blocks=blocks_l,
            offsets=op.offsets,
            kron=kron_l if op.kron is not None else None,
            kron_i=op.kron_i, kron_d=op.kron_d, ki=op.ki, kd=op.kd,
        )
        zero_axes = set(ax_names)

        # 1. post boundary slabs (async collective-permute)
        halos = {}
        if not just_local:
            for ax, nm in ax_names.items():
                w = radius[ax]
                n = mesh.shape[nm]
                L = loc_dim[ax]

                def slab(a, lo, hi, ax=ax):
                    sl = [slice(None)] * a.ndim
                    sl[ax] = slice(lo, hi)
                    return a[tuple(sl)]

                fwd = [(i, (i + 1) % n) for i in range(n)]
                bwd = [(i, (i - 1) % n) for i in range(n)]
                pp = lambda v, perm, nm=nm: jax.lax.ppermute(v, nm, perm)
                cm = (lambda f, v: cplx.cmap(f, v)) if cplx.is_carray(xc_l) \
                    else (lambda f, v: f(v))
                # next shard's low edge (for +ax directions) ...
                high_halo = cm(lambda a: pp(slab(a, 0, w), bwd), xc_l)
                # ... previous shard's high edge (for -ax directions)
                low_halo = cm(lambda a: pp(slab(a, L - w, L), fwd), xc_l)
                halos[ax] = (low_halo, high_halo)

        # 2. core matvec: no dependence on the permutes
        core = _apply_stencil(
            lop, xc_l,
            shift=lambda v, off, nl: _shift_core(v, off, nl, zero_axes))
        if just_local:
            return core

        # 3. halo contributions per crossing direction
        for k, off in enumerate(op.offsets):
            crossing = [ax for ax in ax_names if off[ax] != 0]
            if not crossing:
                continue
            ax = crossing[0]
            s = off[ax]
            w = radius[ax]
            L = loc_dim[ax]
            low_halo, high_halo = halos[ax]

            def hal_slice(a, ax=ax, s=s, w=w):
                sl = [slice(None)] * a.ndim
                sl[ax] = slice(0, s) if s > 0 else slice(w + s, w)
                return a[tuple(sl)]

            hal = (cplx.cmap(hal_slice, high_halo if s > 0 else low_halo)
                   if cplx.is_carray(xc_l)
                   else hal_slice(high_halo if s > 0 else low_halo))
            # remaining (local) components of the offset apply to the slab
            off_rest = tuple(0 if a == ax else o for a, o in enumerate(off))
            if any(off_rest):
                def roll_rest(a):
                    for a2, o in enumerate(off_rest):
                        if o % a.shape[a2] != 0:
                            a = jnp.roll(a, -o, axis=a2)
                    return a
                hal = cplx.cmap(roll_rest, hal) if cplx.is_carray(hal) \
                    else roll_rest(hal)

            slab_sl = [slice(None)] * nlat
            slab_sl[ax] = slice(L - s, L) if s > 0 else slice(0, -s)
            blk_slab = _idx(blocks_l, tuple(slab_sl) + (k,))
            contrib = _dir_contribution(lop, blk_slab, hal, k, nlat)
            idx = tuple(slab_sl)
            if cplx.is_carray(core):
                core = cplx.cmap(lambda c, t: c.at[idx].add(t),
                                 core, contrib)
            else:
                core = core.at[idx].add(contrib)
        return core

    kron_in = op.kron if op.kron is not None else jnp.zeros((0,))
    yc = shard_map(
        body, mesh=mesh,
        in_specs=(spec_b, PartitionSpec(), spec_x),
        out_specs=spec_out,
        check_vma=False,
    )(op.blocks, kron_in, xc)

    return _finish_overlap(op, x, ox, oy, cols, alpha, beta, y, yc,
                           user_complex)


def _finish_overlap(op, x, ox, oy, cols, alpha, beta, y, yc, user_complex):
    """Shared tail: reshape the canonical [*lat_i, KI?, BI, N] result to
    the user's oy labels, scale, accumulate beta*y, restore complex."""
    ki_shape = tuple(op.ki) if op.kron is not None else ()
    shape = tuple(op.dim_i) + ki_shape + tuple(op.bi) + tuple(
        x.shape[ox.index(c)] for c in cols)
    canon_y = op.lat_i + op.kron_i + op.blk_i + cols
    out = local_permute(_reshape(yc, shape), canon_y, oy)
    if not (_is_static(alpha) and alpha == 1):
        out = cplx.scale(alpha, out)
    if y is not None and not (_is_static(beta) and beta == 0):
        out = cplx.add(out, cplx.scale(beta, y))
    return cplx.to_complex(out) if user_complex else out
