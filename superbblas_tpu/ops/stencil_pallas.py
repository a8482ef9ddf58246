"""Nearest-neighbor block stencils (Wilson-type) in the SoA layout.

This is the hot kernel of the framework: the BSR lattice-operator matvec
(reference: the SpMM backends of bsr.h:281-1190 and the kron variant
bsr.h:398-451) in a **structure-of-arrays layout**:

    x       [n, KD*BD, X, Y, Z, T]      (lattice minor: consecutive sites
    blocks  [ndir, BI*BD, X, Y, Z, T]    are consecutive addresses)
    kron    [ndir, KI, KD]               (spin factors, shared by all sites)
    y       [n, KI*BI, X, Y, Z, T]

Every per-site contraction then becomes a broadcast multiply-add over
unit-stride site vectors.  Per direction the spin (kron) rotation runs
first (ki*kd scalar combinations, folded at trace time by
:func:`_factor_kron`) and then the color block multiply — the
3-then-2 contraction order that mirrors the flop saving of the
reference's kron path.  Complex arithmetic is split (re, im) throughout.

Two implementations share one contract:

* :func:`stencil_matvec_soa` — a Pallas kernel on the Triton route, the
  path on a GPU.  One program owns a block of consecutive sites and
  loops over the right-hand sides; each neighbor is a gather at a
  wrapped flat offset (X/Y planes by a scalar stride, Z/T by index
  arithmetic), and all 8 directions are fused into one pass.  On an
  H100 it beat the same per-site body left to XLA (``jnp.roll`` shifts)
  3.7x at 32^3x64 x 12 rhs (PERF.md).
* :func:`stencil_matvec_soa_reference` — an independent einsum
  formulation: the contract the kernel is tested against, and the path
  off the GPU.

Mixed precision: operands may be stored bf16; loads are converted and
all arithmetic accumulates in f32 (f64 for f64 operands).  The output
dtype is the field dtype.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.custom_partitioning import custom_partitioning
from jax.experimental.pallas import triton as pltriton
from jax.sharding import NamedSharding, PartitionSpec

from .. import cplx
from ..labels import volume

__all__ = ["stencil_matvec_soa", "stencil_matvec_soa_reference",
           "soa_eligible", "aos_to_soa", "soa_to_aos"]


def _factor_kron(kre, kim):
    """Per-direction compile-time spin-factor plan, or None for tracers.

    For a CONCRETE kron factor the scalar entries become Python constants
    folded into the kernel (zeros vanish, +-1/+-i become adds), and rank-
    deficient factors are split K_d = R_d P_d so the color multiply runs
    on rank(K_d) spin slots — the half-spinor projection trick (Wilson
    hopping factors r +- gamma_mu have rank 2 at r = 1, halving the color
    FLOPs).  Reference analog: the CSR classification of kron blocks,
    bsr.h:106-247."""
    if isinstance(kre, jax.core.Tracer) or isinstance(kim, jax.core.Tracer):
        return None
    K = np.asarray(kre).astype(np.float64) + 1j * np.asarray(kim)
    ndir, KI, KD = K.shape

    def rows_of(M, tol=1e-12):
        return tuple(
            tuple((s, float(M[r, s].real), float(M[r, s].imag))
                  for s in range(M.shape[1]) if abs(M[r, s]) > tol)
            for r in range(M.shape[0]))

    specs = []
    for d in range(ndir):
        Kd = K[d]
        idx = []
        for r in range(KI):
            cand = Kd[idx + [r]]
            if np.linalg.matrix_rank(cand, tol=1e-9) > len(idx):
                idx.append(r)
        rank = len(idx)
        if 0 < rank < KI:
            P = Kd[idx]
            R = Kd @ np.linalg.pinv(P)
            R[np.abs(R) < 1e-10] = 0.0
            # snap near-integers (gamma algebra produces exact +-1/+-i)
            R = np.where(np.abs(R - np.round(R.real) - 1j * np.round(R.imag))
                         < 1e-9, np.round(R.real) + 1j * np.round(R.imag), R)
            if np.allclose(R @ P, Kd, atol=1e-10):
                specs.append(("factored", rows_of(P), rows_of(R)))
                continue
        specs.append(("direct", rows_of(Kd)))
    return tuple(specs)


def _axis_of(off) -> Tuple[int, int]:
    """(axis, sign) of a one-hot +-1 offset; (-1, 0) for the center."""
    nz = [(ax, o) for ax, o in enumerate(off) if o != 0]
    if not nz:
        return -1, 0
    if len(nz) != 1 or abs(nz[0][1]) != 1:
        raise ValueError(f"stencil kernel requires one-hot +-1 offsets, got {off}")
    return nz[0]


#: flat int32 offsets index every operand inside the kernel: per device,
#: the links must stay below 2**31 elements (64^3 x 128 sites and more
#: therefore need a sharded lattice), and the right-hand sides are split
#: into calls that each stay below it
_MAX_ELEMS = 2 ** 31 - 1


def soa_eligible(offsets, dim_lat, bi, bd, ki, kd) -> bool:
    """Whether a stencil can use the SoA layout: a 4D lattice, one-hot
    +-1 offsets and at most 16x16 complex entries per block (the per-site
    body is unrolled).  Any lattice extent works: neighbors are found by
    index arithmetic, so no extent has to match a tile.  Sizes are checked
    where the kernel runs, on the shapes each device holds."""
    if len(dim_lat) != 4:
        return False
    try:
        for off in offsets:
            _axis_of(off)
    except ValueError:
        return False
    return volume((bi, bd, ki, kd)) <= 16 * 16


def _smul(c, v):
    if c == 1.0:
        return v
    if c == -1.0:
        return -v
    return c * v


def _cacc(acc, cre, cim, xr, xi):
    """acc += (cre + i cim) * (xr + i xi) with the scalar constants folded
    at kernel-build time: zeros vanish, +-1 become adds/negations (the
    gamma-matrix entries are all 0, +-1, +-i)."""
    if cre == 0.0 and cim == 0.0:
        return acc
    if cim == 0.0:
        tre, tim = _smul(cre, xr), _smul(cre, xi)
    elif cre == 0.0:
        tre, tim = _smul(-cim, xi), _smul(cim, xr)
    else:
        tre = _smul(cre, xr) - _smul(cim, xi)
        tim = _smul(cre, xi) + _smul(cim, xr)
    if acc is None:
        return (tre, tim)
    return (acc[0] + tre, acc[1] + tim)


def _matvec_body(shifted, bload, store, zero_like, kron_at,
                 *, ndir, BI, BD, KI, KD, kfact):
    """The per-site stencil math, direction by direction.

    ``shifted(d)`` -> ``xs(f)`` giving the (re, im) f32 operand of
    feature f = spin * BD + color at the direction-d neighbor;
    ``bload(d, i, j)`` -> (re, im) color-block entry; ``store(sp, i,
    (re, im))`` writes an output row; ``zero_like()`` supplies a zero for
    structurally-empty rows; ``kron_at(d, a, b)`` -> (re, im) spin-factor
    entry, used only when ``kfact`` is None (traced spin factors)."""

    acc = [[None] * BI for _ in range(KI)]

    def color_rows(d, zrows):
        t = [None] * BI
        for i in range(BI):
            for j in range(BD):
                if zrows[j] is None:
                    continue
                br, bi_ = bload(d, i, j)
                zre, zim = zrows[j]
                tre = zre * br - zim * bi_
                tim = zre * bi_ + zim * br
                t[i] = (tre, tim) if t[i] is None else (t[i][0] + tre,
                                                        t[i][1] + tim)
        return t

    def add_rows(sp, rows):
        for i, t in enumerate(rows):
            if t is not None:
                acc[sp][i] = t if acc[sp][i] is None else (
                    acc[sp][i][0] + t[0], acc[sp][i][1] + t[1])

    for d in range(ndir):
        xs = shifted(d)

        def spin_row(entries, j):
            z = None
            for (sidx, cre, cim) in entries:
                z = _cacc(z, cre, cim, *xs(sidx * BD + j))
            return z

        spec = None if kfact is None else kfact[d]
        if spec is None:
            for sp in range(KI):
                zrows = []
                for j in range(BD):
                    z = None
                    for sidx in range(KD):
                        kr, ki_ = kron_at(d, sp, sidx)
                        xr, xi = xs(sidx * BD + j)
                        tre = kr * xr - ki_ * xi
                        tim = kr * xi + ki_ * xr
                        z = (tre, tim) if z is None else (z[0] + tre,
                                                          z[1] + tim)
                    zrows.append(z)
                add_rows(sp, color_rows(d, zrows))
        elif spec[0] == "direct":
            rows = spec[1]
            for sp in range(KI):
                add_rows(sp, color_rows(
                    d, [spin_row(rows[sp], j) for j in range(BD)]))
        else:
            prows, rrows = spec[1], spec[2]
            tslots = [color_rows(d, [spin_row(prows[c], j)
                                     for j in range(BD)])
                      for c in range(len(prows))]
            for sp in range(KI):
                for (c, cre, cim) in rrows[sp]:
                    for i in range(BI):
                        t = tslots[c][i]
                        if t is not None:
                            acc[sp][i] = _cacc(acc[sp][i], cre, cim,
                                               t[0], t[1])

    zero = None
    for sp in range(KI):
        for i in range(BI):
            if acc[sp][i] is None:
                if zero is None:
                    zero = zero_like()
                acc[sp][i] = (zero, zero)
            store(sp, i, acc[sp][i])


# ---------------------------------------------------------------------------
# Pallas kernel (Triton route)
# ---------------------------------------------------------------------------

#: sites per program (a power of two) and warps per program: one site
#: per thread keeps the ~100 live f32 values of the unrolled Wilson body
#: in registers
_BLOCK = 128
_NUM_WARPS = 4


def _kernel(kr_ref, ki_ref, b_re, b_im, x_re, x_im, o_re, o_im,
            *, offsets, dims, BI, BD, KI, KD, n, block, kfact,
            packed_parity, acc):
    X, Y, Z, T = dims
    V = X * Y * Z * T
    F, KO, FB = KD * BD, KI * BI, BI * BD
    strides = (Y * Z * T, Z * T, T, 1)
    s = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    coords = (s // strides[0], (s // T // Z) % Y, (s // T) % Z, s % T)

    def neighbor(d):
        ax, sgn = _axis_of(offsets[d])
        if ax == -1:
            return s
        c, L = coords[ax], dims[ax]
        if ax == 0 and packed_parity is not None:
            # packed checkerboard: the image site's x parity decides
            # whether the X neighbor is the same packed slot or the next
            odd = (packed_parity + coords[1] + coords[2] + coords[3]) % 2
            step = odd if sgn > 0 else odd - 1
        else:
            step = sgn
        return s + ((c + step + L) % L - c) * strides[ax]

    nbr = [neighbor(d) for d in range(len(offsets))]

    def kron_at(d, a, b):
        k = (d * KI + a) * KD + b
        return kr_ref[k], ki_ref[k]

    @pl.loop(0, n)
    def _(col):
        def shifted(d):
            base = col * F * V + nbr[d]

            @functools.cache      # each feature is loaded at most once
            def xs(f):
                return (pltriton.load(x_re.at[base + f * V]).astype(acc),
                        pltriton.load(x_im.at[base + f * V]).astype(acc))
            return xs

        @functools.cache
        def bload(d, i, j):
            off = (d * FB + i * BD + j) * V + s
            return (pltriton.load(b_re.at[off]).astype(acc),
                    pltriton.load(b_im.at[off]).astype(acc))

        def store(sp, i, v):
            off = (col * KO + sp * BI + i) * V + s
            pltriton.store(o_re.at[off], v[0].astype(o_re.dtype))
            pltriton.store(o_im.at[off], v[1].astype(o_im.dtype))

        _matvec_body(shifted, bload, store,
                     lambda: jnp.zeros((block,), acc), kron_at,
                     ndir=len(offsets), BI=BI, BD=BD, KI=KI, KD=KD,
                     kfact=kfact)


class _Static(NamedTuple):
    """What the kernel body is specialised on (hashable)."""
    offsets: Tuple[Tuple[int, ...], ...]
    bi: int
    bd: int
    ki: int
    kd: int
    kfact: Optional[tuple]
    packed_parity: Optional[int]
    acc: np.dtype
    interpret: bool


def stencil_matvec_soa(
    blocks: cplx.CArray,            # [ndir, BI*BD, X, Y, Z, T]
    kron: Optional[cplx.CArray],    # [ndir, KI, KD] or None
    x: cplx.CArray,                 # [n, KD*BD, X, Y, Z, T]
    offsets: Sequence[Tuple[int, ...]],
    bi: int, bd: int,
    interpret: bool = False,
    packed_parity: Optional[int] = None,
) -> cplx.CArray:
    """y[n, KI*BI, X, Y, Z, T] = stencil matvec in SoA layout, as one
    Pallas kernel on the Triton route (``interpret=True`` runs it in the
    Pallas interpreter, which is how the CPU tests reach it).

    Operands sharded over several devices are partitioned by the kernel's
    own rule (:func:`_partition`): the right-hand sides split freely, a
    lattice sharded over X and/or Y gets a halo exchange, and any other
    sharding is an error, never a silent all-gather."""
    ndir = blocks.shape[0]
    # sums run in f32 for f32/bf16 operands, in f64 for f64 ones
    acc = jnp.promote_types(jnp.promote_types(x.dtype, blocks.dtype),
                            jnp.float32)
    if kron is None:
        kron = cplx.CArray(jnp.ones((ndir, 1, 1)), jnp.zeros((ndir, 1, 1)))
    kron = cplx.cmap(lambda a: a.astype(acc), kron)
    st = _Static(
        offsets=tuple(tuple(int(v) for v in o) for o in offsets),
        bi=bi, bd=bd, ki=kron.shape[1], kd=kron.shape[2],
        kfact=_factor_kron(kron.re, kron.im), packed_parity=packed_parity,
        acc=np.dtype(acc), interpret=bool(interpret))
    assert blocks.shape[1] == bi * bd and x.shape[1] == st.kd * bd
    o_re, o_im = _partitioned(st)(kron.re, kron.im, blocks.re, blocks.im,
                                  x.re, x.im)
    return cplx.CArray(o_re, o_im)


def _pallas(st, packed_parity, kr, ki, br, bim, xr, xi):
    """One kernel launch on device-local operands."""
    ndir = br.shape[0]
    dims = tuple(br.shape[2:])
    V = volume(dims)
    n = xr.shape[0]
    KO = st.ki * st.bi
    # the largest power of two up to _BLOCK that divides the volume:
    # programs tile the sites exactly, so no lane needs a mask
    block = math.gcd(V, _BLOCK)
    kern = functools.partial(
        _kernel, offsets=st.offsets, dims=dims, BI=st.bi, BD=st.bd,
        KI=st.ki, KD=st.kd, n=n, block=block, kfact=st.kfact,
        packed_parity=packed_parity, acc=st.acc)
    flat = lambda a: a.reshape(-1)
    out = jax.ShapeDtypeStruct((n * KO * V,), xr.dtype)
    o_re, o_im = pl.pallas_call(
        kern,
        grid=(V // block,),
        out_shape=(out, out),
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        cost_estimate=pl.CostEstimate(
            flops=4 * 2 * n * V * ndir * (st.ki * st.kd * st.bd
                                          + st.bi * st.bd),
            bytes_accessed=(br.nbytes + xr.nbytes) * 2
            + 2 * n * KO * V * xr.dtype.itemsize,
            transcendentals=0),
        interpret=st.interpret,
        name="sbt_stencil_soa",
    )(flat(kr), flat(ki), flat(br), flat(bim), flat(xr), flat(xi))
    shape = (n, KO) + dims
    return o_re.reshape(shape), o_im.reshape(shape)


def _local_apply(st, packed_parity, kr, ki, br, bim, xr, xi):
    """The kernel on one device's operands, the right-hand sides split so
    that every flat index of a launch fits int32."""
    V = volume(br.shape[2:])
    if br.shape[0] * br.shape[1] * V > _MAX_ELEMS:
        raise ValueError(
            f"{br.shape[2:]} lattice sites on one device exceed the stencil "
            f"kernel's int32 indexing of the links; shard the lattice over "
            f"more devices")
    per = _MAX_ELEMS // (max(xr.shape[1], st.ki * st.bi) * V)
    n = xr.shape[0]
    outs = [_pallas(st, packed_parity, kr, ki, br, bim,
                    xr[c:c + per], xi[c:c + per]) for c in range(0, n, per)]
    if len(outs) == 1:
        return outs[0]
    return tuple(jnp.concatenate(p, axis=0) for p in zip(*outs))


# ---------------------------------------------------------------------------
# GSPMD partitioning: without a rule, XLA would gather every sharded
# operand whole onto each device before the kernel (it cannot see inside a
# pallas_call)
# ---------------------------------------------------------------------------

#: operands (kron re/im, blocks re/im, x re/im) -> outputs (y re/im)
_RULE = ("p q r, p q r, d f x y z t, d f x y z t, n g x y z t, n g x y z t"
         " -> n h x y z t, n h x y z t")


def _spec_of(sharding, ndim):
    spec = tuple(sharding.spec) + (None,) * ndim
    return tuple(s[0] if isinstance(s, tuple) and len(s) == 1 else s
                 for s in spec[:ndim])


def _plan(st, mesh, arg_shapes):
    """(lattice spec, rhs spec, {array axis: (mesh axis, halo width)})
    for sharded operands, or None when every operand is replicated;
    raises for a sharding the kernel cannot run on without a gather."""
    shardings = [a.sharding for a in arg_shapes]
    if all(s.is_fully_replicated for s in shardings):
        return None
    b_spec = _spec_of(shardings[2], 6)
    x_spec = _spec_of(shardings[4], 6)
    lat = x_spec[2:]
    halos = {}
    ok = (all(isinstance(s, NamedSharding) for s in shardings[2:])
          and b_spec[:2] == (None, None) and x_spec[1] is None
          and b_spec[2:] in (lat, (None,) * 4)
          and shardings[3] == shardings[2] and shardings[5] == shardings[4]
          and lat[2:] == (None, None))
    for k in (0, 1):
        nm = lat[k]
        if not ok or nm is None:
            continue
        if not isinstance(nm, str):     # one lattice axis over many mesh axes
            ok = False
            break
        local = arg_shapes[4].shape[2 + k] // mesh.shape[nm]
        w = max(abs(o[k]) for o in st.offsets)
        # the packed parity of an extended Y block is static only for
        # even local Y extents
        ok = w <= local and not (k == 1 and st.packed_parity is not None
                                 and local % 2)
        if mesh.shape[nm] > 1:
            halos[2 + k] = (nm, w)
    if not ok:
        raise ValueError(
            f"the SoA stencil kernel partitions over the right-hand sides "
            f"and over lattice X/Y only; got links sharded as {b_spec} and "
            f"the field as {x_spec}.  Reshard the operands, or call "
            f"parallel.apply_stencil_soa_sharded.")
    return lat, x_spec[0], halos


def _partition(st, mesh, arg_shapes, result_shape):
    plan = _plan(st, mesh, arg_shapes)
    if plan is None:
        return (mesh, functools.partial(_local_apply, st, st.packed_parity),
                tuple(r.sharding for r in result_shape),
                tuple(a.sharding for a in arg_shapes))
    lat, rhs, halos = plan
    sh = lambda *spec: NamedSharding(mesh, PartitionSpec(*spec))
    x_sh = sh(rhs, None, *lat)
    args = (sh(), sh(), sh(None, None, *lat), sh(None, None, *lat),
            x_sh, x_sh)

    def lower(kr, ki, br, bim, xr, xi):
        from ..parallel.halo import crop_halos, extend_local

        names = {ax: nm for ax, (nm, _) in halos.items()}
        widths = {ax: w for ax, (_, w) in halos.items()}
        pp = st.packed_parity
        if names:
            br, bim, xr, xi = (extend_local(a, names, widths, mesh)
                               for a in (br, bim, xr, xi))
            if pp is not None and 3 in widths:
                pp = (pp + widths[3]) % 2   # local Y starts w sites early
        out = _local_apply(st, pp, kr, ki, br, bim, xr, xi)
        return tuple(crop_halos(o, widths) for o in out)

    return mesh, lower, (x_sh, x_sh), args


@functools.lru_cache(maxsize=None)
def _partitioned(st: _Static):
    """The kernel as a jitted custom-partitioned call: on one device it is
    the plain launch; across devices GSPMD calls :func:`_partition`."""
    @custom_partitioning
    def apply(kr, ki, br, bim, xr, xi):
        return _local_apply(st, st.packed_parity, kr, ki, br, bim, xr, xi)

    apply.def_partition(
        partition=functools.partial(_partition, st), sharding_rule=_RULE)
    return jax.jit(apply)


# ---------------------------------------------------------------------------
# Reference
# ---------------------------------------------------------------------------

def stencil_matvec_soa_reference(blocks, kron, x, offsets, bi, bd,
                                 packed_parity=None):
    """Independent einsum formulation with the same SoA signature: the
    contract every implementation is tested against.  ``packed_parity``
    selects the checkerboard-packed X-shift semantics (see
    models/eo_packed.py)."""
    ndir = blocks.shape[0]
    if kron is None:
        kron = cplx.CArray(jnp.ones((ndir, 1, 1), blocks.dtype),
                           jnp.zeros((ndir, 1, 1), blocks.dtype))
    KI, KD = kron.shape[1], kron.shape[2]
    n = x.shape[0]
    lat = x.shape[2:]
    if packed_parity is not None:
        rest = lat[1:]
        coords = np.meshgrid(*[np.arange(d) for d in rest], indexing="ij")
        m = ((packed_parity + sum(coords)) % 2 == 1)
        img_x_odd = jnp.asarray(m.reshape((1, 1, 1) + tuple(rest)))

    def roll(v, off):
        def r(a):
            for ax, o in enumerate(off):
                if o % (lat[ax] if packed_parity is None or ax != 0
                        else 10 ** 9) != 0:
                    if packed_parity is not None and ax == 0:
                        sh = jnp.roll(a, -o, axis=3)
                        if o > 0:
                            a = jnp.where(img_x_odd, sh, a)
                        else:
                            a = jnp.where(img_x_odd, a, sh)
                    else:
                        a = jnp.roll(a, -o, axis=3 + ax)
            return a
        return cplx.cmap(r, v)

    y = None
    xs4 = cplx.cmap(lambda a: a.reshape((n, KD, bd) + lat), x)
    prec = cplx.default_precision()
    for d in range(ndir):
        xd = roll(xs4, offsets[d])
        kr = cplx.CArray(kron.re[d], kron.im[d])
        z = cplx.cbilinear(
            lambda K, V: jnp.einsum("ab,nbj...->naj...", K, V,
                                    precision=prec), kr, xd)
        blk = cplx.cmap(lambda a: a[d].reshape((bi, bd) + lat), blocks)
        t = cplx.cbilinear(
            lambda B, V: jnp.einsum("ij...,naj...->nai...", B, V,
                                    precision=prec), blk, z)
        y = t if y is None else cplx.add(y, t)
    # honor the kernel's output contract (out dtype = field dtype): the
    # f32 kron factor otherwise promotes a bf16 field to f32 here
    out_dt = x.re.dtype
    return cplx.cmap(
        lambda a: a.reshape((n, KI * bi) + lat).astype(out_dt), y)


def aos_to_soa(x: cplx.CArray, nlat: int) -> cplx.CArray:
    """[*lat, KD, BD, n] -> [n, KD*BD, *lat]."""
    def t(a):
        nd = a.ndim
        perm = (nd - 1, nd - 3, nd - 2) + tuple(range(nlat))
        a = jnp.transpose(a, perm)
        return a.reshape((a.shape[0], a.shape[1] * a.shape[2]) + a.shape[3:])
    return cplx.cmap(t, x)


def soa_to_aos(y: cplx.CArray, nlat: int, ki: int, bi: int) -> cplx.CArray:
    """[n, KI*BI, *lat] -> [*lat, KI, BI, n]."""
    def t(a):
        a = a.reshape((a.shape[0], ki, bi) + a.shape[2:])
        perm = tuple(range(3, 3 + nlat)) + (1, 2, 0)
        return jnp.transpose(a, perm)
    return cplx.cmap(t, y)
