"""Packed checkerboard (even-odd) layout: half-lattice hopping applies.

`even_odd.py` implements the Schur solve with parity *masks* — correct,
but every matvec still runs over the full lattice (2x wasted compute).
This module stores each parity as a **packed half-lattice array**
(x-axis halved: site (x, r...) -> (x // 2, r...)) and applies the
hopping term directly between packings:

  * directions along the packed axis become a parity-dependent choice
    between the unshifted and the rolled operand (the classic
    even-odd x-packing trick),
  * all other directions are plain rolls (the x index is unchanged).

Everything reuses the stencil engine: `_apply_stencil` with a custom
neighbor-fetch shift.  Requires a one-hot +-1 stencil with an even
X extent (Wilson/staggered shapes).

Reference analog: superbblas consumers drive bsr_krylov on half-lattice
partitions for exactly this scheme; `make_hole`/mask partitions
(dist.h:3745) are its partition-level counterpart.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import cplx
from ..bsr import BSROperator, _apply_stencil, _reshape
from ..labels import volume
from .even_odd import schur_cg
from .wilson import _axpy, _inner, _zeros_like, adjoint_operator

__all__ = ["cb_pack", "cb_unpack", "hopping_packed", "apply_hopping_packed",
           "eo_solve_packed", "cb_pack_soa", "cb_unpack_soa",
           "hopping_packed_soa", "apply_hopping_packed_soa",
           "eo_solve_packed_soa"]


def _rest_parity(lat_dims, trailing: int):
    """(y+z+t) % 2 mask shaped [1, Y, Z, T] + [1]*trailing."""
    rest = lat_dims[1:]
    coords = np.meshgrid(*[np.arange(d) for d in rest], indexing="ij")
    par = sum(coords) % 2 if coords else np.zeros((), np.int64)
    return jnp.asarray(
        np.asarray(par).reshape((1,) + tuple(rest) + (1,) * trailing))


def cb_pack(a, nlat: int, parity: int):
    """[X, *rest, ...] -> packed [X/2, *rest, ...] holding the sites with
    (x + sum(rest)) % 2 == parity."""
    def pk(v):
        rest_par = _rest_parity(v.shape[:nlat], v.ndim - nlat)
        ev = v[0::2]
        od = v[1::2]
        # x parity on the kept sites: (parity - rest_par) mod 2
        want_odd = (parity + rest_par) % 2 == 1
        return jnp.where(want_odd, od, ev)
    return cplx.cmap(pk, a) if cplx.is_carray(a) else pk(a)


def cb_unpack(a_even, a_odd, nlat: int):
    """Inverse of cb_pack for both parities -> full [X, *rest, ...]."""
    def up(ae, ao):
        rest_par = _rest_parity((2 * ae.shape[0],) + ae.shape[1:nlat],
                                ae.ndim - nlat)
        odd_is_odd = (1 + rest_par) % 2 == 1   # odd-parity array holds odd x?
        ev = jnp.where(odd_is_odd == 0, ao, ae)   # x even slots
        od = jnp.where(odd_is_odd == 1, ao, ae)   # x odd slots
        out = jnp.stack([ev, od], axis=1)
        return out.reshape((2 * ae.shape[0],) + ae.shape[1:])
    if cplx.is_carray(a_even):
        return cplx.CArray(up(a_even.re, a_odd.re), up(a_even.im, a_odd.im))
    return up(a_even, a_odd)


def _check_one_hot(offsets):
    for off in offsets:
        nz = [o for o in off if o]
        if nz and (len(nz) != 1 or abs(nz[0]) != 1):
            raise ValueError(
                f"packed checkerboarding requires one-hot +-1 stencil "
                f"offsets, got {off}")


def hopping_packed(op: BSROperator, to_parity: int) -> BSROperator:
    """The hopping (center excluded) operator packed onto ``to_parity``
    image sites: blocks [X/2, *rest, ndir-?, BI, BD]."""
    if op.mode != "stencil":
        raise ValueError("packed checkerboarding needs an AoS stencil op")
    if op.dim_d[0] % 2:
        raise ValueError("X extent must be even")
    _check_one_hot(op.offsets)
    nlat = len(op.dim_d)
    keep = [k for k, off in enumerate(op.offsets) if any(off)]
    idx = (slice(None),) * nlat + (jnp.asarray(keep),)
    hop_blocks = (cplx.cmap(lambda v: v[idx], op.blocks)
                  if cplx.is_carray(op.blocks) else op.blocks[idx])
    hop_blocks = cb_pack(hop_blocks, nlat, to_parity)
    kron = None
    if op.kron is not None:
        kidx = jnp.asarray(keep)
        kron = (cplx.cmap(lambda v: v[kidx], op.kron)
                if cplx.is_carray(op.kron) else op.kron[kidx])
    dim = (op.dim_d[0] // 2,) + tuple(op.dim_d[1:])
    return BSROperator(
        oim=op.oim, odm=op.odm, lat_i=op.lat_i, lat_d=op.lat_d,
        blk_i=op.blk_i, blk_d=op.blk_d, dim_i=dim, dim_d=dim,
        bi=op.bi, bd=op.bd, mode="stencil", blocks=hop_blocks,
        offsets=tuple(op.offsets[k] for k in keep),
        kron=kron, kron_i=op.kron_i, kron_d=op.kron_d, ki=op.ki, kd=op.kd,
    )


def apply_hopping_packed(hop: BSROperator, x_from, to_parity: int):
    """y_to = H x_from between packings (x_from lives on the opposite
    parity).  x_from: [X/2, *rest, KD?, BD, N] canonical operand."""
    nlat = len(hop.dim_d)
    lat_full = (2 * hop.dim_d[0],) + tuple(hop.dim_d[1:])
    sample = x_from.re if cplx.is_carray(x_from) else x_from
    rest_par = _rest_parity(lat_full, sample.ndim - nlat)
    # x parity of the IMAGE site: (to_parity + rest_par) % 2
    img_x_odd = (to_parity + rest_par) % 2 == 1

    def shift(v, off, nl):
        def sh(a):
            ax = next(i for i, o in enumerate(off) if o)
            s = off[ax]
            if ax == 0:
                plus = jnp.roll(a, -1, axis=0)    # packed +1
                minus = jnp.roll(a, 1, axis=0)
                if s > 0:
                    # neighbor xh' = xh + [image x odd]
                    return jnp.where(img_x_odd, plus, a)
                # neighbor xh' = xh - [image x even]
                return jnp.where(img_x_odd, a, minus)
            return jnp.roll(a, -s, axis=ax)
        return cplx.cmap(sh, v) if cplx.is_carray(v) else sh(v)

    return _apply_stencil(hop, x_from, shift=shift)


def eo_solve_packed(op: BSROperator, b, a: float, n_iters: int = 50):
    """Even-odd preconditioned solve with packed half-lattice arrays
    (the production variant of even_odd.eo_solve: matvecs run on X/2
    arrays, no masked waste).  Same contract as eo_solve."""
    nlat = len(op.dim_d)
    cols_shape = (b.re if cplx.is_carray(b) else b).shape[nlat:]
    # canonicalize b to [*lat, KD?, BD, N]-style packed halves
    KD = volume(op.kd) if op.kron is not None else 1
    BD = volume(op.bd)
    N = volume(cols_shape) // (KD * BD)
    bc = _reshape(b, tuple(op.dim_d) + ((KD, BD, N) if op.kron is not None
                                        else (BD, N)))
    b_e = cb_pack(bc, nlat, 0)
    b_o = cb_pack(bc, nlat, 1)

    hop_e = hopping_packed(op, 0)          # -> even
    hop_o = hopping_packed(op, 1)          # -> odd
    op_h = adjoint_operator(op)
    hop_e_h = hopping_packed(op_h, 0)
    hop_o_h = hopping_packed(op_h, 1)

    def Dhat(v_e):
        t_o = apply_hopping_packed(hop_o, v_e, 1)
        t_e = apply_hopping_packed(hop_e, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    def Dhat_h(v_e):
        t_o = apply_hopping_packed(hop_o_h, v_e, 1)
        t_e = apply_hopping_packed(hop_e_h, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    rhs = cplx.add(b_e, cplx.scale(-1.0 / a,
                                   apply_hopping_packed(hop_e, b_o, 0)))

    psi_e, rs = schur_cg(Dhat, Dhat_h, rhs, n_iters)
    psi_o = cplx.scale(1.0 / a, cplx.add(
        b_o, cplx.scale(-1.0, apply_hopping_packed(hop_o, psi_e, 1))))
    full = cb_unpack(psi_e, psi_o, nlat)
    return _reshape(full, tuple(op.dim_d) + cols_shape), rs


# ---------------------------------------------------------------------------
# SoA (Pallas hot path) packed checkerboarding
# ---------------------------------------------------------------------------


def _rest_par_np(rest):
    coords = np.meshgrid(*[np.arange(d) for d in rest], indexing="ij")
    return (sum(coords) % 2) if coords else np.zeros((), np.int64)


def cb_pack_soa(a: cplx.CArray, parity: int) -> cplx.CArray:
    """SoA layout [n|ndir, F, X, *rest]: keep sites with
    (x + sum(rest)) % 2 == parity, halving X (array axis 2)."""
    def pk(v):
        rest = v.shape[3:]
        rp = jnp.asarray(_rest_par_np(rest).reshape((1, 1, 1) + tuple(rest)))
        ev, od = v[:, :, 0::2], v[:, :, 1::2]
        return jnp.where((parity + rp) % 2 == 1, od, ev)
    return cplx.cmap(pk, a)


def cb_unpack_soa(a_even: cplx.CArray, a_odd: cplx.CArray) -> cplx.CArray:
    def up(e, o):
        rest = e.shape[3:]
        rp = jnp.asarray(_rest_par_np(rest).reshape((1, 1, 1) + tuple(rest)))
        ev = jnp.where(rp == 1, o, e)
        od = jnp.where(rp == 0, o, e)
        out = jnp.stack([ev, od], axis=3)
        return out.reshape(e.shape[:2] + (2 * e.shape[2],) + tuple(rest))
    return cplx.CArray(up(a_even.re, a_odd.re), up(a_even.im, a_odd.im))


def hopping_packed_soa(op: BSROperator, to_parity: int) -> BSROperator:
    """SoA-layout hopping operator packed onto ``to_parity`` image sites;
    its matvec runs in the Pallas kernel with the parity-select X shift
    (stencil_matvec_soa(..., packed_parity=to_parity))."""
    if op.mode != "stencil_soa":
        raise ValueError("needs an SoA-layout stencil operator")
    if op.dim_d[0] % 2:
        raise ValueError("X extent must be even")
    _check_one_hot(op.offsets)
    keep = [k for k, off in enumerate(op.offsets) if any(off)]
    kidx = jnp.asarray(keep)
    blocks = cb_pack_soa(cplx.cmap(lambda v: v[kidx], op.blocks), to_parity)
    kron = (cplx.cmap(lambda v: v[kidx], op.kron)
            if op.kron is not None else None)
    dim = (op.dim_d[0] // 2,) + tuple(op.dim_d[1:])
    return BSROperator(
        oim=op.oim, odm=op.odm, lat_i=op.lat_i, lat_d=op.lat_d,
        blk_i=op.blk_i, blk_d=op.blk_d, dim_i=dim, dim_d=dim,
        bi=op.bi, bd=op.bd, mode="stencil_soa", blocks=blocks,
        offsets=tuple(op.offsets[k] for k in keep),
        kron=kron, kron_i=op.kron_i, kron_d=op.kron_d, ki=op.ki, kd=op.kd,
    )


def apply_hopping_packed_soa(hop: BSROperator, x_from: cplx.CArray,
                             to_parity: int,
                             interpret=False) -> cplx.CArray:
    """y_to = H x_from between SoA packings through the Pallas kernel."""
    from ..bsr import apply_stencil_soa

    return apply_stencil_soa(hop, x_from, interpret=interpret,
                             packed_parity=to_parity)


def eo_solve_packed_soa(op: BSROperator, b_soa: cplx.CArray, a: float,
                        n_iters: int = 50):
    """Even-odd preconditioned solve on the SoA hot path.

    ``op``: SoA-layout operator; ``b_soa``: [n, KD*BD, X, *rest].
    The Schur CG matvecs run as x-halved SoA stencil applies.
    Returns (psi in SoA layout, Schur residual)."""
    if op.mode != "stencil_soa":
        raise ValueError("needs an SoA-layout operator")
    b_e = cb_pack_soa(b_soa, 0)
    b_o = cb_pack_soa(b_soa, 1)

    hop_e = hopping_packed_soa(op, 0)
    hop_o = hopping_packed_soa(op, 1)
    op_h = adjoint_operator(op)
    hop_e_h = hopping_packed_soa(op_h, 0)
    hop_o_h = hopping_packed_soa(op_h, 1)

    def Dhat(v_e):
        t_o = apply_hopping_packed_soa(hop_o, v_e, 1)
        t_e = apply_hopping_packed_soa(hop_e, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    def Dhat_h(v_e):
        t_o = apply_hopping_packed_soa(hop_o_h, v_e, 1)
        t_e = apply_hopping_packed_soa(hop_e_h, t_o, 0)
        return cplx.add(cplx.scale(a, v_e), cplx.scale(-1.0 / a, t_e))

    rhs = cplx.add(b_e, cplx.scale(
        -1.0 / a, apply_hopping_packed_soa(hop_e, b_o, 0)))

    psi_e, rs = schur_cg(Dhat, Dhat_h, rhs, n_iters)
    psi_o = cplx.scale(1.0 / a, cplx.add(
        b_o, cplx.scale(-1.0, apply_hopping_packed_soa(hop_o, psi_e, 1))))
    return cb_unpack_soa(psi_e, psi_o), rs
