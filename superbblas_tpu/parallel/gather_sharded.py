"""Halo-plan sharded execution of GATHER-mode BSR operators.

Under plain GSPMD the gather matvec's cross-shard ``jj_flat`` take
lowers to an all-reduce over the nnz-multiplied gathered array — on a
16x8x8x8 / nnz=10 probe that is ~80x the minimal halo bytes
(experiments/gather_traffic.py, round-3 VERDICT item 6).  The reference
runs general BSR through the same halo machinery as stencils: the
x-gather is a redistribution onto the extended domain
(bsr.h:2020-2192).  This module is that path here: a host-side plan
remaps every neighbor index into a halo-extended LOCAL frame, one
ppermute pair per sharded axis exchanges the boundary planes (corners
ride the sequential per-axis extension), and the gather runs entirely
shard-local.

Scope: operators whose neighbor lists stay within ``w_a`` planes of the
owning shard along every sharded lattice axis, with w_a <= the local
shard extent — bounded-offset irregularity (open boundaries, defects,
dislocations, random local couplings).  Unbounded operators raise;
route those through the replicated path.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from .. import cplx
from ..bsr import BSROperator, _apply_gather, _apply_gather_kron
from .halo import crop_halos as _crop
from .halo import extend_local as _extend

__all__ = ["make_gather_halo_plan", "apply_gather_sharded",
           "apply_gather_overlap"]

#: per-operator memo of (device index tensor, shard_mapped callable)
#: keyed on (id(op), sharded-axes signature, mesh, nblk, power,
#: all_powers) — a Krylov solver calls apply_gather_sharded once per
#: matvec, and rebuilding the O(voli*nnz*nd) host plan + re-uploading
#: jj + re-tracing the shard_map each iteration would dominate the
#: solve.  Entries die with the operator (weakref.finalize), so id()
#: recycling cannot alias; an LRU cap bounds the pinned device index
#: tensors for long-lived operators applied under many configurations.
_GATHER_CACHE: dict = {}
_GATHER_CACHE_MAX = 32
_FINALIZER_KEYS: set = set()     # keys with a live weakref.finalize
_DELEGATE = object()             # cache sentinel: route to the plain path


def _cache_get(key):
    hit = _GATHER_CACHE.get(key)
    if hit is not None:
        _GATHER_CACHE[key] = _GATHER_CACHE.pop(key)   # LRU refresh
    return hit


def _cache_put(op, key, value):
    if len(_GATHER_CACHE) >= _GATHER_CACHE_MAX:
        _GATHER_CACHE.pop(next(iter(_GATHER_CACHE)))
    _GATHER_CACHE[key] = value
    # one finalizer per key across rebuild-after-eviction cycles
    if key not in _FINALIZER_KEYS:
        _FINALIZER_KEYS.add(key)
        weakref.finalize(op, _evict, key)


def _evict(key):
    _GATHER_CACHE.pop(key, None)
    _FINALIZER_KEYS.discard(key)


def _sharded_axes(op: BSROperator, x, mesh: Mesh, axes, fname: str):
    """Shared executor preamble: the sharded lattice axes, their mesh
    names/sizes, and the operand's trailing-rank count."""
    if op.mode != "gather":
        raise ValueError("requires a gather-mode operator")
    sharded = [(i, axes[c]) for i, c in enumerate(op.lat_d)
               if axes.get(c) is not None and mesh.shape[axes[c]] > 1]
    if not sharded:
        raise ValueError(f"{fname}: no sharded lattice axis")
    ks = tuple(k for k, _ in sharded)
    nms = tuple(nm for _, nm in sharded)
    ns = tuple(mesh.shape[nm] for nm in nms)
    nlat = len(op.dim_d)
    nblk = (x.re.ndim if cplx.is_carray(x) else x.ndim) - nlat
    return ks, nms, ns, nlat, nblk


def _frame_geometry(op: BSROperator, ks, nms, ns, w):
    """Frame widths/extents and the extend/crop dicts from a plan's
    per-axis halo width(s)."""
    Ws = (int(w),) if np.isscalar(w) else tuple(int(v) for v in w)
    Ls = tuple(op.dim_d[k] // n for k, n in zip(ks, ns))
    loc_core = list(op.dim_d)
    loc_ext = list(op.dim_d)
    for k, L, W in zip(ks, Ls, Ws):
        loc_core[k] = L
        loc_ext[k] = L + 2 * W
    wdict = {k: W for k, W in zip(ks, Ws) if W}
    ndict = {k: nm for k, nm in zip(ks, nms) if wdict.get(k)}
    return Ws, Ls, tuple(loc_core), tuple(loc_ext), wdict, ndict


def _field_specs(op: BSROperator, ks, nms, nlat, nblk):
    """(field spec, blocks spec) for the shard_map in/out signatures."""
    spec_lat = tuple(nms[ks.index(i)] if i in ks else None
                     for i in range(nlat))
    spec_x = PartitionSpec(*spec_lat, *([None] * nblk))
    bnd = (op.blocks.re.ndim if cplx.is_carray(op.blocks)
           else op.blocks.ndim)
    bspec = PartitionSpec(*spec_lat, *([None] * (bnd - nlat)))
    return spec_x, bspec


def make_gather_halo_plan(op: BSROperator, lat_axis, nshards,
                          power: int = 1):
    """Host-side halo plan for one or more sharded lattice axes.

    ``lat_axis``/``nshards``: an int pair (one sharded axis) or
    equal-length tuples (multi-axis grids).  Returns ``(W, jj_local)``:
    ``W`` is the FRAME halo width per axis (int for int input, tuple
    for tuple input) and ``jj_local`` is int32
    [n_0, ..., n_{m-1}, rows, nnz]: per-shard neighbor indices remapped
    into the halo-extended local frame (each sharded axis extent
    local + 2*W_a, flattened C-order; the leading shard-grid axes are
    collapsed for single-axis input).  The analog of the reference's
    extended-domain index translation (bsr.h:2020-2116).

    ``power=1`` (one apply): rows = the shard's CORE sites only, and
    W_a is the max plane distance any core neighbor reaches outside
    its owner's slab.  ``power=p>1`` (communication-avoiding powers,
    the okr-powers analog of bsr.h:2109-2247 for irregular operators):
    rows = EVERY site of the extended frame, so the operator can be
    applied p times shard-locally after ONE widened exchange — outputs
    progressively invalidate inward and the core stays exact.  W_a is
    derived from the p-hop PLANE REACHABILITY of the core (per-axis
    plane-adjacency closure), NOT w*p: a halo row may legally couple
    far inside its own slab, so per-hop reach is unrelated to the
    off-slab width (a plain w*p frame silently corrupts the core —
    found by review).  A host-side validity iteration certifies every
    core-feeding row reads only in-frame, valid operands and raises
    otherwise; neighbors of certified-garbage rows are clamped to 0.
    """
    single = np.isscalar(lat_axis)
    ks = (int(lat_axis),) if single else tuple(int(a) for a in lat_axis)
    ns = (int(nshards),) if single else tuple(int(a) for a in nshards)
    if len(ks) != len(ns) or len(set(ks)) != len(ks):
        raise ValueError("lat_axis/nshards must pair distinct axes")
    dim = tuple(op.dim_d)
    if tuple(op.dim_i) != dim:
        raise ValueError("halo-plan gather requires a square operator")
    if power < 1:
        raise ValueError("power must be >= 1")
    for k, n in zip(ks, ns):
        if dim[k] % n:
            raise ValueError(f"lattice axis {k} must divide over {n}")
    Ls = [dim[k] // n for k, n in zip(ks, ns)]
    jj = np.asarray(op.jj_flat)                     # [voli, nnz]
    voli, nnz = jj.shape
    if op.row_counts is not None:
        # padded slots (>= row_counts) carry arbitrary indices with
        # ZEROED blocks — treat them as self-couplings so they neither
        # inflate the halo width nor fail the reach check (ragged
        # open-boundary/defect operators are this module's target)
        rc = np.asarray(op.row_counts).reshape(-1)
        jj = np.where(np.arange(nnz)[None, :] < rc[:, None],
                      jj, np.arange(voli, dtype=jj.dtype)[:, None])
    coords = np.stack(np.unravel_index(jj.reshape(-1), dim), axis=-1)
    coords = coords.reshape(voli, nnz, len(dim))
    sites = np.unravel_index(np.arange(voli), dim)

    # Per-axis FRAME width from p-hop plane reachability: adj[q0, q1] =
    # some site in plane q0 couples to plane q1; reach_p = planes the
    # core can touch through p hops.  The frame [rL-W, (r+1)L+W) must
    # contain reach_p — measured by the TWO-SIDED toroidal distance
    # (pos in [0, L) is core; outside, the plane is coverable from the
    # high side, pos - L + 1 planes past the slab, or the low side,
    # D - pos planes before it; the frame extends W both ways so each
    # plane needs only the cheaper side — wrapped-interval pitfall,
    # CLAUDE.md).  NOTE: per-hop reach is NOT bounded by the off-slab
    # width w (halo rows couple within their own slabs), so W != w*p.
    Ws = []
    for k, n, L in zip(ks, ns, Ls):
        D = dim[k]
        adj = np.zeros((D, D), bool)
        src = np.broadcast_to(sites[k][:, None], (voli, nnz))
        adj[src.reshape(-1), coords[..., k].reshape(-1)] = True
        W = 0
        for r in range(n):
            reach = np.zeros(D, bool)
            reach[r * L:(r + 1) * L] = True
            for _ in range(power):
                reach = reach | adj[reach].any(axis=0)
            pos = (np.nonzero(reach)[0] - r * L) % D
            need = np.where(pos < L, 0,
                            np.minimum(pos - L + 1, D - pos))
            W = max(W, int(need.max(initial=0)))
        if W > L:
            raise ValueError(
                f"gather couplings reach {W} planes past the shard "
                f"(axis {k}: local extent {L}, power {power}): the "
                "one-ppermute exchange cannot source them — use the "
                "replicated path or a lower power")
        Ws.append(W)

    exts = [L + 2 * W for L, W in zip(Ls, Ws)]
    ext_dim = list(dim)
    for k, e in zip(ks, exts):
        ext_dim[k] = e
    ext_dim = tuple(ext_dim)

    def remap(c, rs):
        """Map neighbor coords -> (ext-frame flat indices, in-frame
        mask) for shard rs; out-of-frame slots are clamped to 0 and
        marked False in the mask."""
        lc = [c[..., a] for a in range(len(dim))]
        ok = np.ones(c.shape[:-1], bool)
        for k, L, W, e in zip(ks, Ls, Ws, exts):
            lpos = (c[..., k] - (rs[ks.index(k)] * L - W)) % dim[k]
            ok &= lpos < e
            lc[k] = np.where(lpos >= e, 0, lpos)
        return np.ravel_multi_index(lc, ext_dim), ok

    grid = list(itertools.product(*[range(n) for n in ns]))
    if power == 1:
        # local flat order = global C-order restricted to the slab (the
        # restriction is an order-preserving bijection onto local C-order)
        rows = voli
        for n in ns:
            rows //= n
        jj_local = np.empty((len(grid), rows, nnz), dtype=np.int64)
        for gi, rs in enumerate(grid):
            sel = np.ones(voli, bool)
            for k, L, r in zip(ks, Ls, rs):
                sel &= (sites[k] >= r * L) & (sites[k] < (r + 1) * L)
            jj_local[gi], ok = remap(coords[sel], rs)
            if not ok.all():
                raise ValueError(
                    "neighbor outside the halo frame (plan width "
                    "miscomputed)")   # defensive: W bounds this
    else:
        # rows for the FULL extended frame, in frame C-order: take the
        # global per-site rows at the frame's global coordinates
        coords_g = coords.reshape(dim + (nnz, len(dim)))
        rows = voli
        for n, L, e in zip(ns, Ls, exts):
            rows = rows // (n * L) * e
        # core-row mask in frame C-order, shared by every shard
        fpos = np.unravel_index(np.arange(rows), ext_dim)
        core = np.ones(rows, bool)
        for k, L, W in zip(ks, Ls, Ws):
            core &= (fpos[k] >= W) & (fpos[k] < W + L)
        jj_local = np.empty((len(grid), rows, nnz), dtype=np.int64)
        for gi, rs in enumerate(grid):
            c = coords_g
            for k, L, W, e, r in zip(ks, Ls, Ws, exts, rs):
                gk = (r * L - W + np.arange(e)) % dim[k]  # frame -> global
                c = np.take(c, gk, axis=k)
            flat, ok = remap(c.reshape(-1, nnz, len(dim)), rs)
            # validity certification: valid_1 = reads only in-frame
            # (t=0 frame values are all exchanged-correct); valid_{t+1}
            # = that AND every operand row was valid_t.  Every core row
            # must be valid at t=power, else clamped garbage would feed
            # a kept output — raise instead of silently corrupting.
            ok_nb = ok.all(axis=1)
            valid = ok_nb.copy()
            for _ in range(power - 1):
                valid = ok_nb & valid[flat].all(axis=1)
            if not valid[core].all():
                raise ValueError(
                    "gather couplings escape the communication-avoiding "
                    f"frame within {power} applies (validity "
                    "certification failed) — use a lower power or the "
                    "replicated path")
            jj_local[gi] = flat
    jj_local = jj_local.reshape(ns + jj_local.shape[1:])
    w_out = Ws[0] if single else tuple(Ws)
    if int(jj_local.max(initial=0)) < np.iinfo(np.int32).max:
        jj_local = jj_local.astype(np.int32)
    return w_out, jj_local


def apply_gather_sharded(op: BSROperator, x, mesh: Mesh,
                         axes: Dict[str, Optional[str]],
                         plan: Optional[Tuple] = None,
                         power: int = 1, all_powers: bool = False):
    """y = A x for a GATHER-mode operator on a lattice-sharded operand
    through one explicit halo exchange per sharded axis (the reference's
    extended-domain BSR matvec, bsr.h:2020-2192) — instead of GSPMD's
    nnz-times-field all-reduce.

    ``x``: CArray in canonical AoS order [*lat, KD?, BD, N] sharded on
    one or more lattice axes per ``axes`` (lattice label -> mesh axis);
    ``op.blocks`` (and ``jj_flat``) may be replicated or sharded the
    same way — blocks are passed through the shard_map with the lattice
    spec.  Returns the input sharding.

    ``plan``: optional precomputed :func:`make_gather_halo_plan` result
    for the sharded axes (built with the SAME ``power`` and the same
    axis order as they appear in ``op.lat_d``).  Without it the plan,
    the device index tensor and the shard_mapped callable are all
    memoized per (operator, mesh, axes, power) — repeated applies (a
    Krylov solve) pay the host-side plan build and upload once, like
    the redistribution plan cache.

    ``power=p`` computes A^p x with ONE widened exchange per axis — the
    communication-avoiding okr-powers mode of the stencil paths
    (``bsr_krylov_ca``; reference bsr.h:2109-2247) for IRREGULAR
    operators: the operator rows (blocks + indices) of the halo sites
    are exchanged alongside the field, then p shard-local applies run
    on the extended frame, validity shrinking inward per apply.  The
    frame width comes from the p-hop plane REACHABILITY of the core
    (see :func:`make_gather_halo_plan`), and the plan certifies every
    core-feeding row — operators whose couplings outrun the local slab
    raise rather than silently corrupt.  ``all_powers=True`` returns
    [A x, ..., A^p x] stacked on a new leading axis (the s-step Krylov
    basis); otherwise just A^p x.  Each intermediate apply runs over
    the extended frame (a prod(ext_a/L_a) compute overhead vs the
    minimal trapezoid).
    """
    if power < 1:
        raise ValueError("power must be >= 1")
    ks, nms, ns, nlat, nblk = _sharded_axes(op, x, mesh, axes,
                                            "apply_gather_sharded")

    key = (id(op), ks, ns, mesh, nms, nblk, power, all_powers)
    hit = _cache_get(key) if plan is None else None
    if hit is not None:
        jj_dev, fn = hit
        return fn(op.blocks,
                  op.kron if op.kron is not None else jnp.zeros((0,)),
                  jj_dev, x)

    if plan is not None:
        w, jj_local = plan
    elif len(ks) == 1:
        w, jj_local = make_gather_halo_plan(op, ks[0], ns[0], power=power)
    else:
        w, jj_local = make_gather_halo_plan(op, ks, ns, power=power)
    # the plan returns FRAME halo widths (reach-based for power>1)
    (Ws, Ls, loc_core, loc_ext, wdict, ndict) = _frame_geometry(
        op, ks, nms, ns, w)
    spec_x, bspec = _field_specs(op, ks, nms, nlat, nblk)
    jj_local = np.asarray(jj_local).reshape(ns + np.asarray(jj_local).shape[-2:])
    jj_dev = jax.device_put(
        jnp.asarray(jj_local), NamedSharding(mesh, PartitionSpec(*nms)))
    jj_lead = len(ns)

    # the cached closure must NOT capture `op` (the cache entry would
    # keep it alive and the finalize-based eviction could never fire) —
    # lift the static metadata into locals
    meta = dict(oim=op.oim, odm=op.odm, lat_i=op.lat_i, lat_d=op.lat_d,
                blk_i=op.blk_i, blk_d=op.blk_d,
                dim_i=(loc_core if power == 1 else loc_ext),
                dim_d=loc_ext, bi=op.bi, bd=op.bd, mode="gather",
                offsets=op.offsets, kron_i=op.kron_i, kron_d=op.kron_d,
                ki=op.ki, kd=op.kd)
    has_kron = op.kron is not None

    def body(blocks_l, kron_l, jj_l, x_l):
        x_e = _extend(x_l, ndict, wdict, mesh) if wdict else x_l
        # powers apply the operator AT halo sites too: their rows
        # (per-site blocks) travel in the same exchange as the field
        b_e = (blocks_l if power == 1 or not wdict
               else _extend(blocks_l, ndict, wdict, mesh))
        lop = BSROperator(blocks=b_e, jj_flat=jj_l[(0,) * jj_lead],
                          kron=kron_l if has_kron else None, **meta)
        fn = _apply_gather_kron if has_kron else _apply_gather
        if power == 1:
            y = fn(lop, x_e)
            if not all_powers:
                return y
            return (cplx.CArray(y.re[None], y.im[None])
                    if cplx.is_carray(y) else y[None])
        outs = []
        cur = x_e
        for _ in range(power):
            # ext -> ext; the host-side validity certification in
            # make_gather_halo_plan guarantees every core-feeding row
            # reads only exchanged-correct operands at every apply
            cur = fn(lop, cur)
            outs.append(cur)
        if not all_powers:
            outs = outs[-1:]
        outs = [_crop(o, wdict) if wdict else o for o in outs]
        if not all_powers:
            return outs[0]
        if cplx.is_carray(outs[0]):
            return cplx.CArray(jnp.stack([o.re for o in outs]),
                               jnp.stack([o.im for o in outs]))
        return jnp.stack(outs)

    spec_out = PartitionSpec(None, *spec_x) if all_powers else spec_x
    fn = shard_map(
        body, mesh=mesh,
        in_specs=(bspec, PartitionSpec(),
                  PartitionSpec(*nms, None, None), spec_x),
        out_specs=spec_out, check_vma=False,
    )
    # a cache hit must not re-trace the body per call; pin the output
    # sharding so the full (un-normalized) spec survives the jit
    fn = jax.jit(fn, out_shardings=NamedSharding(mesh, spec_out))
    if plan is None:
        _cache_put(op, key, (jj_dev, fn))
    kron_in = op.kron if op.kron is not None else jnp.zeros((0,))
    return fn(op.blocks, kron_in, jj_dev, x)


def apply_gather_overlap(op: BSROperator, x, mesh: Mesh,
                         axes: Dict[str, Optional[str]],
                         just_local: bool = False):
    """y = A x for a GATHER-mode operator with an explicit core/halo
    split (the reference's create_lattice_split scheme applied to
    irregular operators; tests/bsr.cpp:402-530, just_local bsr.h:2359).

    The plan classifies every (row, slot) as CORE (neighbor inside the
    local slab) or CROSSING.  The core contribution gathers from the
    UN-extended local block — it has no data dependence on the posted
    ppermutes, so XLA schedules it between the collective-permute
    start/done pair (the overlap); the crossing contribution gathers
    from the halo-extended frame and adds in afterwards.  Each side
    masks the other's slots, so the dot runs twice over the slot axis
    (the gather-bound regime makes this cheap; the stencil overlap path
    splits per-direction instead and pays no extra FLOPs).

    ``just_local=True`` skips the exchange and returns only the core
    contribution (crossing terms dropped), like ``bsr_krylov_overlap``.
    Memoized per (operator, mesh, axes, just_local) like
    :func:`apply_gather_sharded`.
    """
    ks, nms, ns, nlat, nblk = _sharded_axes(op, x, mesh, axes,
                                            "apply_gather_overlap")

    key = (id(op), "overlap", ks, ns, mesh, nms, nblk, just_local)
    hit = _cache_get(key)
    if hit is not None:
        if hit[0] is _DELEGATE:
            # all-core plan (nothing crosses): the plain single-apply
            # path IS the overlap result — and has its own cache
            return apply_gather_sharded(op, x, mesh, axes)
        jj_dev, fn = hit
        return fn(op.blocks,
                  op.kron if op.kron is not None else jnp.zeros((0,)),
                  jj_dev, x)

    if len(ks) == 1:
        W, jj_local = make_gather_halo_plan(op, ks[0], ns[0])
    else:
        W, jj_local = make_gather_halo_plan(op, ks, ns)
    (Ws, Ls, loc_core, loc_ext, wdict, ndict) = _frame_geometry(
        op, ks, nms, ns, W)

    # classify slots: CORE = neighbor inside the local slab.  jj_local
    # holds ext-frame flat indices; recover per-axis frame coords and
    # derive (a) the local-slab flat index for core slots, (b) the mask.
    jj_arr = np.asarray(jj_local).astype(np.int64)
    fco = np.unravel_index(jj_arr, loc_ext)           # per-axis coords
    is_core = np.ones(jj_arr.shape, bool)
    for k, L, Wa in zip(ks, Ls, Ws):
        is_core &= (fco[k] >= Wa) & (fco[k] < Wa + L)
    if bool(is_core.all()):
        # nothing crosses: the crossing matvec would gather a full
        # frame of zero-masked blocks for no contribution — delegate to
        # the plain single-apply path, and MEMOIZE the decision so
        # repeated applies skip the host-side plan rebuild
        _cache_put(op, key, (_DELEGATE, None))
        return apply_gather_sharded(op, x, mesh, axes)
    lco = list(fco)
    for k, Wa in zip(ks, Ws):
        lco[k] = np.where(is_core, fco[k] - Wa, 0)
    jj_core = np.where(is_core, np.ravel_multi_index(lco, loc_core), 0)
    jj_halo = np.where(is_core, 0, jj_arr)
    pdt = (np.int32 if max(int(jj_arr.max(initial=0)), 1)
           < np.iinfo(np.int32).max else np.int64)
    # bundle: [*grid, rows, nnz, 3] = (core idx, halo idx, core mask)
    bundle = np.stack([jj_core.astype(pdt), jj_halo.astype(pdt),
                       is_core.astype(pdt)], axis=-1)
    jj_dev = jax.device_put(
        jnp.asarray(bundle), NamedSharding(mesh, PartitionSpec(*nms)))
    jj_lead = len(ns)

    spec_x, bspec = _field_specs(op, ks, nms, nlat, nblk)

    meta_core = dict(oim=op.oim, odm=op.odm, lat_i=op.lat_i,
                     lat_d=op.lat_d, blk_i=op.blk_i, blk_d=op.blk_d,
                     dim_i=loc_core, dim_d=loc_core, bi=op.bi, bd=op.bd,
                     mode="gather", offsets=op.offsets, kron_i=op.kron_i,
                     kron_d=op.kron_d, ki=op.ki, kd=op.kd)
    meta_halo = dict(meta_core, dim_d=loc_ext)
    has_kron = op.kron is not None

    def body(blocks_l, kron_l, jj_l, x_l):
        jj_b = jj_l[(0,) * jj_lead]
        jjc, jjh, mk = jj_b[..., 0], jj_b[..., 1], jj_b[..., 2]
        fn = _apply_gather_kron if has_kron else _apply_gather

        def masked_blocks(m):
            # zero the complementary slots INSIDE the blocks: the gather
            # matvec then needs no operand-side masking.  mask is
            # [rows, nnz] over [*lat, nnz, BI, BD] blocks.
            msk = m.reshape(tuple(loc_core) + (m.shape[-1], 1, 1))
            mul = lambda b: b * msk.astype(b.dtype)
            return cplx.cmap(mul, blocks_l) if cplx.is_carray(blocks_l) \
                else mul(blocks_l)

        kr = kron_l if has_kron else None
        core_op = BSROperator(blocks=masked_blocks(mk), jj_flat=jjc,
                              kron=kr, **meta_core)
        # 1. post the halos (async collective-permutes)
        x_e = (None if just_local else
               (_extend(x_l, ndict, wdict, mesh) if wdict else x_l))
        # 2. core matvec: depends only on x_l — overlaps the permutes
        y = fn(core_op, x_l)
        if just_local:
            return y
        # 3. crossing contributions from the extended frame
        halo_op = BSROperator(blocks=masked_blocks(1 - mk), jj_flat=jjh,
                              kron=kr, **meta_halo)
        yh = fn(halo_op, x_e)
        return cplx.add(y, yh)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(bspec, PartitionSpec(),
                  PartitionSpec(*nms, None, None, None), spec_x),
        out_specs=spec_x, check_vma=False,
    )
    fn = jax.jit(fn, out_shardings=NamedSharding(mesh, spec_x))
    _cache_put(op, key, (jj_dev, fn))
    kron_in = op.kron if op.kron is not None else jnp.zeros((0,))
    return fn(op.blocks, kron_in, jj_dev, x)
