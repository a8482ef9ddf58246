"""Block-sparse (BSR) lattice operators and their application (bsr_krylov).

JAX re-design of the reference's BSR engine
(``include/superbblas/bsr.h`` in eromero-vlc/superbblas).  The reference
stores a general block-CSR with *coordinate* column indices
(bsr.h:66-87), picks among MKL/cuSPARSE/hand-rolled SpMM backends, and
gathers halos through the MPI redistribution layer (bsr.h:2189-2192).

Here the dominant structure — a nearest-neighbor lattice stencil — is a
first-class citizen: when every image block row has the same set of
coordinate *offsets* (detected at construction from the reference-style
``ii``/``jj`` inputs), the operator is stored as one dense block tensor
per direction and the matvec becomes

    y = sum_k  blocks[..., k, :, :] @ roll(x, -offset_k)

i.e. a handful of large batched GEMMs on toroidally-shifted operands,
with no gather at all.  Under GSPMD-sharded lattice axes the rolls
compile to neighbor collective-permutes — the halo exchange of
the reference (ext_power partitions + redistribution) falls out of the
sharding.  Irregular operators keep a gather fallback.

The Kronecker-factored variant (create_kron_bsr, bsr.h:2302-2336) stores
spin factors [ndir, KI, KD] separate from color blocks [*lat, ndir, CI,
CD] and contracts them in two stages, exactly the flop-saving the
reference's kron path does (bsr.h:398-451).

Operator powers (the ``okr`` label, bsr.h:2140-2247) compute y_p =
A^{p+1} x for p = 0..power-1 with a static unrolled loop; XLA overlaps
the per-step collectives with compute.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import cplx
from .labels import Coor, check_order, volume
from .ops.copy import local_permute
from .utils.tracker import tracked as _tracked


def _idx(a, index):
    """Index/slice that works for plain arrays and split-complex CArray."""
    if cplx.is_carray(a):
        return cplx.cmap(lambda v: v[index], a)
    return a[index]


def _stack(arrs, axis):
    if cplx.is_carray(arrs[0]):
        return cplx.CArray(
            jnp.stack([a.re for a in arrs], axis=axis),
            jnp.stack([a.im for a in arrs], axis=axis),
        )
    return jnp.stack(arrs, axis=axis)


def _reshape(a, shape):
    if cplx.is_carray(a):
        return cplx.cmap(lambda v: v.reshape(shape), a)
    return a.reshape(shape)

__all__ = [
    "BSROperator",
    "create_bsr",
    "create_kron_bsr",
    "bsr_from_stencil",
    "bsr_cast_storage",
    "bsr_krylov",
    "bsr_get_preferred_layout",
    "bsr_allowed_layouts",
]


def bsr_cast_storage(op: "BSROperator", dtype) -> "BSROperator":
    """Re-store an operator's blocks in ``dtype`` (bf16 halves the block
    traffic of the bandwidth-bound stencil: kernels convert loads and
    accumulate in f32).  Kron factors stay in their original precision —
    they are trace-time constants of the stencil body.  Reference analog:
    the per-precision operator handles of create_bsr (bsr.h:2287,
    template_types.h:13-83)."""
    blocks = (cplx.cmap(lambda a: a.astype(dtype), op.blocks)
              if cplx.is_carray(op.blocks) else op.blocks.astype(dtype))
    return dataclasses.replace(op, blocks=blocks)


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class BSROperator:
    """A block-sparse lattice operator.

    Labels: ``oim`` = image labels (lattice labels then block labels),
    ``odm`` = domain labels.  ``lat_i``/``lat_d`` are the lattice (block
    grid) sub-orders; ``blk_i``/``blk_d`` the block sub-orders.  For the
    Kronecker variant, ``kron_i``/``kron_d`` are additional block labels
    whose factor is shared by all lattice sites.

    mode "stencil": ``blocks`` has shape [*lat_i, ndir, BI, BD] and
    ``offsets[k]`` is the lattice offset of direction k (domain - image).
    mode "gather": ``blocks`` has shape [*lat_i, nnz, BI, BD], ``jj_flat``
    holds flat domain-site indices [voli, nnz], and ``row_counts`` records
    per-row valid counts.
    mode "stencil_soa": structure-of-arrays hot layout — ``blocks`` is a
    split-complex CArray [ndir, BI*BD, *lat] and the matvec runs in the
    SoA stencil (ops/stencil_pallas.py); operands are SoA
    [ncols, KD*BD, *lat] CArrays.
    """

    oim: str
    odm: str
    lat_i: str
    lat_d: str
    blk_i: str
    blk_d: str
    dim_i: Coor          # lattice dims (image)
    dim_d: Coor          # lattice dims (domain)
    bi: Coor             # block dims (image), in blk_i order
    bd: Coor
    mode: str
    blocks: jax.Array
    offsets: Tuple[Coor, ...] = ()
    jj_flat: Optional[jax.Array] = None
    row_counts: Optional[jax.Array] = None   # [voli] per-row nnz (gather)
    kron: Optional[jax.Array] = None     # [ndir, KI, KD]
    kron_i: str = ""
    kron_d: str = ""
    ki: Coor = ()
    kd: Coor = ()

    @property
    def ndir(self) -> int:
        if self.mode == "stencil_soa":
            return self.blocks.shape[0]   # SoA layout [ndir, BI*BD, *lat]
        return self.blocks.shape[len(self.dim_i)]

    # -- pytree protocol: array leaves + hashable metadata, so operators
    # can be passed straight through jit / shard_map boundaries ----------
    def tree_flatten(self):
        # row_counts is DATA (a voli-long vector), not static metadata: as
        # aux it would be hashed into every jit compile-cache key (the
        # round-1 compile-cache liability on big lattices)
        children = (self.blocks, self.jj_flat, self.kron, self.row_counts)
        aux = (self.oim, self.odm, self.lat_i, self.lat_d, self.blk_i,
               self.blk_d, self.dim_i, self.dim_d, self.bi, self.bd,
               self.mode, self.offsets, self.kron_i,
               self.kron_d, self.ki, self.kd)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        blocks, jj_flat, kron, row_counts = children
        (oim, odm, lat_i, lat_d, blk_i, blk_d, dim_i, dim_d, bi, bd,
         mode, offsets, kron_i, kron_d, ki, kd) = aux
        return cls(
            oim=oim, odm=odm, lat_i=lat_i, lat_d=lat_d, blk_i=blk_i,
            blk_d=blk_d, dim_i=dim_i, dim_d=dim_d, bi=bi, bd=bd, mode=mode,
            blocks=blocks, offsets=offsets, jj_flat=jj_flat,
            row_counts=row_counts, kron=kron, kron_i=kron_i, kron_d=kron_d,
            ki=ki, kd=kd,
        )

    def flops_per_matvec(self, ncols: int, complex_dtype: bool = True) -> int:
        """FLOP model (reference keeps one per backend, bsr.h:329-372)."""
        mul = 8 if complex_dtype else 2
        voli = volume(self.dim_i)
        BI = volume(self.bi)
        BD = volume(self.bd)
        f = mul * voli * self.ndir * BI * BD * ncols
        if self.kron is not None:
            KI = volume(self.ki)
            KD = volume(self.kd)
            # stage 1 contracts color for each kd; stage 2 applies the
            # kron factor
            f = mul * voli * self.ndir * ncols * (BI * BD * KD + KI * KD * BI)
        return f

    def memops_per_matvec(self, ncols: int, itemsize: int) -> int:
        voli, vold = volume(self.dim_i), volume(self.dim_d)
        BI, BD = volume(self.bi), volume(self.bd)
        KI = volume(self.ki) if self.kron is not None else 1
        KD = volume(self.kd) if self.kron is not None else 1
        blocks_bytes = self.blocks.size * itemsize
        x_bytes = vold * BD * KD * ncols * itemsize
        y_bytes = voli * BI * KI * ncols * itemsize
        return blocks_bytes + x_bytes + y_bytes


def _split_labels(o: str, block: Sequence[int]) -> Tuple[str, str, Coor]:
    """Split full labels into (lattice labels, block labels) given the
    reference-style block extent vector (1 for lattice dims)."""
    lat = "".join(c for c, b in zip(o, block) if b == 1)
    blk = "".join(c for c, b in zip(o, block) if b > 1)
    bdim = tuple(b for b in block if b > 1)
    return lat, blk, bdim


def bsr_from_stencil(
    oim: str,
    odm: str,
    dim_lat: Sequence[int],
    block_i: dict,
    block_d: dict,
    offsets: Sequence[Coor],
    blocks: jax.Array,
    kron: Optional[jax.Array] = None,
    kron_i: Optional[dict] = None,
    kron_d: Optional[dict] = None,
    layout: str = "aos",
) -> BSROperator:
    """Direct constructor for a regular stencil operator.

    ``blocks``: [*lat, ndir, BI, BD] (flattened block dims).
    ``offsets``: per-direction lattice offsets (domain site = image site +
    offset, toroidal).
    ``layout``: "aos" (label-order axes, general) or "soa" (lattice-minor
    hot layout for ops/stencil_pallas.py — requires a 4D lattice with
    one-hot +-1 offsets, see ``soa_eligible``).
    """
    def to_device(a):
        return cplx.cmap(jnp.asarray, a) if cplx.is_carray(a) else a

    blocks = to_device(cplx.asarray(blocks))
    if kron is not None:
        kron = to_device(cplx.asarray(kron))
    if layout == "soa":
        from .ops.stencil_pallas import soa_eligible

        nlat = len(dim_lat)
        bi_v = volume(block_i.values())
        bd_v = volume(block_d.values())
        ki_v = volume((kron_i or {"_": 1}).values())
        kd_v = volume((kron_d or {"_": 1}).values())
        if not soa_eligible(offsets, dim_lat, bi_v, bd_v, ki_v, kd_v):
            raise ValueError("stencil not eligible for the SoA layout")
        if not cplx.is_carray(blocks):
            blocks = cplx.CArray(blocks, jnp.zeros_like(blocks))
        # [*lat, ndir, BI, BD] -> [ndir, BI*BD, *lat]
        perm = (nlat, nlat + 1, nlat + 2) + tuple(range(nlat))
        blocks = cplx.cmap(lambda a: jnp.transpose(a, perm).reshape(
            (a.shape[nlat], bi_v * bd_v) + tuple(dim_lat)), blocks)
    lat_i = "".join(c for c in oim if c not in block_i and c not in (kron_i or {}))
    lat_d = "".join(c for c in odm if c not in block_d and c not in (kron_d or {}))
    blk_i = "".join(c for c in oim if c in block_i)
    blk_d = "".join(c for c in odm if c in block_d)
    kron_i_s = "".join(c for c in oim if c in (kron_i or {}))
    kron_d_s = "".join(c for c in odm if c in (kron_d or {}))
    return BSROperator(
        oim=oim, odm=odm, lat_i=lat_i, lat_d=lat_d,
        blk_i=blk_i, blk_d=blk_d,
        dim_i=tuple(dim_lat), dim_d=tuple(dim_lat),
        bi=tuple(block_i[c] for c in blk_i),
        bd=tuple(block_d[c] for c in blk_d),
        mode="stencil_soa" if layout == "soa" else "stencil",
        blocks=blocks,
        offsets=tuple(tuple(int(v) for v in o) for o in offsets),
        kron=kron,
        kron_i=kron_i_s,
        kron_d=kron_d_s,
        ki=tuple(kron_i[c] for c in kron_i_s) if kron_i else (),
        kd=tuple(kron_d[c] for c in kron_d_s) if kron_d else (),
    )


def create_bsr(
    oim: str,
    dim_im: Sequence[int],
    odm: str,
    dim_dm: Sequence[int],
    block_im: Sequence[int],
    block_dm: Sequence[int],
    ii: np.ndarray,
    jj: np.ndarray,
    values: jax.Array,
    block_image_fast: bool = False,
    pattern_merge: bool = True,
) -> BSROperator:
    """Reference-parity constructor (create_bsr, bsr.h:2287-2320).

    * ``oim``/``dim_im``: image labels and extents (block dims included);
      ``block_im`` gives the block extent per label (1 on lattice dims).
    * ``ii``: [*lat_i] per-row nonzero counts (host numpy).
    * ``jj``: [*lat_i, max_nnz, nlat] absolute domain lattice coordinates
      of each nonzero block (host numpy; the reference uses
      component-relative coordinates, bsr.h:2277-2284 — global arrays have
      no components, so coordinates here are global).
    * ``values``: [*lat_i, max_nnz, BI, BD] blocks ([..., BD, BI] when
      ``block_image_fast``, mirroring the reference's blockImFast flag).

    Structure detection, fastest first:

    1. uniform stencil (same offsets in the same slots for every row) —
       the roll-based GEMM path;
    2. NEAR-uniform (``pattern_merge``): when the union of per-row
       offset patterns is small (<= 2x max_nnz), rows are scatter-merged
       into a union-pattern stencil with ZERO blocks where a row lacks
       an offset (duplicate offsets within a row sum) — open-boundary /
       defect operators run at full stencil speed instead of the gather
       path.  Disabled for the kron constructor, whose spin factors pair
       with slot INDICES (bsr.h:398-451), which merging would break;
    3. gather plan (truly irregular structure).
    """
    check_order(oim)
    check_order(odm)
    lat_i, blk_i, bi = _split_labels(oim, block_im)
    lat_d, blk_d, bd = _split_labels(odm, block_dm)
    dim_i = tuple(d for d, b in zip(dim_im, block_im) if b == 1)
    dim_d = tuple(d for d, b in zip(dim_dm, block_dm) if b == 1)
    nlat = len(dim_i)

    ii = np.asarray(ii).reshape(dim_i)
    jj = np.asarray(jj).reshape(dim_i + (-1, nlat))
    max_nnz = jj.shape[-2]
    values = cplx.asarray(values)
    if block_image_fast:
        values = (cplx.cmap(lambda v: jnp.swapaxes(v, -1, -2), values)
                  if cplx.is_carray(values) else jnp.swapaxes(values, -1, -2))
    values = _reshape(values, dim_i + (max_nnz, volume(bi), volume(bd)))

    uniform = bool((ii == ii.reshape(-1)[0]).all()) and int(ii.reshape(-1)[0]) == max_nnz
    offsets = None
    rel = None
    # rel is O(voli * max_nnz * nlat) host work — skip it when neither
    # consumer (uniform detection / pattern merge) can use it
    if dim_i == dim_d and (uniform or pattern_merge):
        site_coords = np.stack(
            np.meshgrid(*[np.arange(d) for d in dim_i], indexing="ij"), axis=-1
        )  # [*lat, nlat]
        rel = (jj - site_coords[..., None, :]) % np.asarray(dim_i)
        if uniform:
            # offsets[k] = (jj[site, k] - site) mod dim, same every row?
            first = rel.reshape(-1, max_nnz, nlat)[0]
            if (rel == first).all():
                offsets = [tuple(int(v) for v in first[k])
                           for k in range(max_nnz)]

    common = dict(
        oim=oim, odm=odm, lat_i=lat_i, lat_d=lat_d, blk_i=blk_i, blk_d=blk_d,
        dim_i=dim_i, dim_d=dim_d, bi=bi, bd=bd,
    )
    if offsets is not None:
        return BSROperator(mode="stencil", blocks=values,
                           offsets=tuple(offsets), **common)

    if pattern_merge and rel is not None:
        # NEAR-uniform: scatter-merge rows into the union offset pattern
        # (vectorized: offsets are encoded to scalar keys; np.unique
        # gives the union, searchsorted the per-entry slot)
        voli = volume(dim_i)
        rel_f = rel.reshape(voli, max_nnz, nlat).astype(np.int64)
        valid = (np.arange(max_nnz)[None, :]
                 < ii.reshape(-1)[:, None])          # [voli, max_nnz]
        strides = np.ones(nlat, dtype=np.int64)
        for a in range(nlat - 2, -1, -1):
            strides[a] = strides[a + 1] * dim_i[a + 1]
        keys = (rel_f * strides).sum(-1)             # [voli, max_nnz]
        uniq = np.unique(keys[valid]) if valid.any() else np.zeros(0, np.int64)
        P = len(uniq)
        if 0 < P <= 2 * max_nnz:
            pattern = [tuple(int(v) for v in np.unravel_index(k, dim_i))
                       for k in uniq]
            slot = np.searchsorted(uniq, keys)       # [voli, max_nnz]
            slot[~valid] = P                         # pad bucket
            BIv, BDv = volume(bi), volume(bd)
            flat_idx = jnp.asarray(
                (np.arange(voli)[:, None] * (P + 1) + slot).reshape(-1))

            def merge(v):
                big = jnp.zeros((voli * (P + 1), BIv, BDv), v.dtype)
                big = big.at[flat_idx].add(v.reshape(-1, BIv, BDv))
                return big.reshape(voli, P + 1, BIv, BDv)[:, :P].reshape(
                    dim_i + (P, BIv, BDv))

            merged = (cplx.cmap(merge, values) if cplx.is_carray(values)
                      else merge(values))
            return BSROperator(mode="stencil", blocks=merged,
                               offsets=tuple(pattern), **common)

    # gather fallback: flatten domain lattice coordinates to flat indices
    strides = np.ones(nlat, dtype=np.int64)
    for i in range(nlat - 2, -1, -1):
        strides[i] = strides[i + 1] * dim_d[i + 1]
    jj_flat = (jj % np.asarray(dim_d) * strides).sum(-1).reshape(-1, max_nnz)
    nnz_mask = (
        np.arange(max_nnz)[None, :] < ii.reshape(-1)[:, None]
    )
    # zero out padded blocks so the gather-matvec can ignore the mask
    mask_arr = jnp.asarray(
        nnz_mask.reshape(dim_i + (max_nnz, 1, 1)).astype(bool)
    )
    if cplx.is_carray(values):
        values = cplx.cmap(lambda v: jnp.where(mask_arr, v, 0), values)
    else:
        values = jnp.where(mask_arr, values, 0)
    return BSROperator(
        mode="gather", blocks=values,
        jj_flat=jnp.asarray(jj_flat),
        row_counts=jnp.asarray(ii.reshape(-1).astype(np.int32)), **common,
    )


def create_kron_bsr(
    oim: str,
    dim_im: Sequence[int],
    odm: str,
    dim_dm: Sequence[int],
    block_im: Sequence[int],
    block_dm: Sequence[int],
    kron_im: Sequence[int],
    kron_dm: Sequence[int],
    ii: np.ndarray,
    jj: np.ndarray,
    values: jax.Array,
    kron_values: jax.Array,
    block_image_fast: bool = False,
) -> BSROperator:
    """Kronecker-factored BSR (create_kron_bsr, bsr.h:2302-2336): each
    nonzero block is kron(spin factor, color block); spin factors depend
    only on the direction, color blocks on (site, direction).

    ``kron_im``/``kron_dm``: per-label kron-block extents (1 elsewhere).
    ``kron_values``: [ndir, KI, KD] ([ndir, KD, KI] if block_image_fast).
    """
    # build the non-kron part first (block labels exclude kron labels);
    # pattern merging is OFF: the spin factors pair with slot indices
    # (kron[k] applies to each row's k-th neighbor, bsr.h:398-451), a
    # correspondence union-merging would destroy
    base = create_bsr(
        "".join(c for c, k in zip(oim, kron_im) if k == 1),
        [d for d, k in zip(dim_im, kron_im) if k == 1],
        "".join(c for c, k in zip(odm, kron_dm) if k == 1),
        [d for d, k in zip(dim_dm, kron_dm) if k == 1],
        [b for b, k in zip(block_im, kron_im) if k == 1],
        [b for b, k in zip(block_dm, kron_dm) if k == 1],
        ii, jj, values, block_image_fast, pattern_merge=False,
    )
    kron_i = "".join(c for c, k in zip(oim, kron_im) if k > 1)
    kron_d = "".join(c for c, k in zip(odm, kron_dm) if k > 1)
    ki = tuple(k for k in kron_im if k > 1)
    kd = tuple(k for k in kron_dm if k > 1)
    kron_values = cplx.asarray(kron_values)
    kron_values = _reshape(kron_values,
                           (-1, volume(ki), volume(kd))
                           if not block_image_fast
                           else (-1, volume(kd), volume(ki)))
    if block_image_fast:
        kron_values = (cplx.cmap(lambda v: jnp.swapaxes(v, -1, -2),
                                 kron_values)
                       if cplx.is_carray(kron_values)
                       else jnp.swapaxes(kron_values, -1, -2))
    # Non-uniform (site-dependent) structure keeps the gather plan: the
    # spin factor of slot k applies to every row's k-th neighbor, exactly
    # the reference's per-nonzero kron indexing (bsr.h:398-451); rows
    # shorter than max_nnz have their color blocks zeroed, which nulls
    # the kron contribution too.
    return BSROperator(
        oim=oim, odm=odm, lat_i=base.lat_i, lat_d=base.lat_d,
        blk_i=base.blk_i, blk_d=base.blk_d,
        dim_i=base.dim_i, dim_d=base.dim_d, bi=base.bi, bd=base.bd,
        mode=base.mode, blocks=base.blocks, offsets=base.offsets,
        jj_flat=base.jj_flat, row_counts=base.row_counts,
        kron=kron_values, kron_i=kron_i, kron_d=kron_d, ki=ki, kd=kd,
    )


def bsr_get_preferred_layout(op: BSROperator) -> Tuple[str, str]:
    """Preferred x and y orderings for THIS operator's execution mode
    (bsr_get_preferred_layout, bsr.h:2395-2455): the order in which
    :func:`bsr_krylov` touches the field with ZERO data movement ('n'
    stands for the column labels the caller appends).

    * "stencil"/"gather" (AoS): lattice outermost, kron + block labels,
      columns innermost — the canonical order the local kernels consume.
    * "stencil_soa": columns OUTERMOST, then kron + block labels, then
      lattice — the structure-of-arrays hot layout; fields in this order
      enter the Pallas kernel by reshape alone (no transpose), while any
      other order pays one physical permutation per apply.
    """
    if op.mode == "stencil_soa":
        return ("n" + op.kron_d + op.blk_d + op.lat_d,
                "n" + op.kron_i + op.blk_i + op.lat_i)
    ox = op.lat_d + op.kron_d + op.blk_d + "n"
    oy = op.lat_i + op.kron_i + op.blk_i + "n"
    return ox, oy


def bsr_allowed_layouts(op: BSROperator) -> dict:
    """Which field layouts each execution mode runs and at what cost —
    the SpMMAllowedLayout negotiation analog (bsr.h:255-260, consumed by
    bsr_get_preferred_layout at bsr.h:2395-2455).  Unlike the reference's
    backends (MKL/cuSPARSE accept exactly one (x, y) combination and the
    caller must reorder), every mode here accepts ANY permutation — the
    engine inserts the reorder itself — so the contract is expressed as
    cost tiers rather than hard rejections:

      ``preferred``  the unique zero-copy (ox, oy) pair for this mode
      ``zero_copy``  all (ox, oy) pairs executed without data movement
                     (adjacent kron/block label merges are free reshapes)
      ``any_order``  True: other permutations are legal but pay one
                     physical transpose per side per apply
    """
    pref = bsr_get_preferred_layout(op)
    return {"mode": op.mode, "preferred": pref,
            "zero_copy": (pref,), "any_order": True}


def _roll_lat(x, offset, nlat):
    """Toroidal shift of the leading nlat lattice axes by -offset (bring
    the neighbor at +offset to each site).  Compiles to slice+concat and,
    over sharded axes, neighbor collective-permutes."""
    if cplx.is_carray(x):
        return cplx.cmap(lambda v: _roll_lat(v, offset, nlat), x)
    for ax, off in enumerate(offset):
        if off % x.shape[ax] != 0:
            x = jnp.roll(x, -off, axis=ax)
    return x


def _apply_stencil(op: BSROperator, xc: jax.Array, shift=None) -> jax.Array:
    """Core stencil matvec on canonical operands.

    xc: [*lat_d, KD, BD, N] (KD axis present only in kron mode).
    returns [*lat_i, KI, BI, N].

    ``shift(x, off, nlat)`` overrides the toroidal roll that fetches the
    neighbor operand (used by parallel/overlap.py to zero-fill across
    shard boundaries so the core matvec carries no collective).
    """
    if shift is None:
        shift = _roll_lat
    nlat = len(op.dim_d)
    ndir = op.ndir
    if op.kron is None:
        # y[..., i, n] = sum_k blocks[..., k, i, j] xs_k[..., j, n]
        # Stack shifted operands on a new contraction-adjacent axis and do
        # ONE batched GEMM with K = ndir*BD: bigger GEMM tiles than ndir
        # separate small GEMMs (reference loops directions, bsr.h:535-655).
        xs = _stack(
            [shift(xc, off, nlat) for off in op.offsets], axis=nlat
        )  # [*lat, ndir, BD, N]
        # [*lat, ndir, BI, BD] x [*lat, ndir, BD, N] -> sum over (ndir, BD)
        y = cplx.cdot_general(
            op.blocks, xs,
            dimension_numbers=(
                ((nlat, nlat + 2), (nlat, nlat + 1)),
                (tuple(range(nlat)), tuple(range(nlat))),
            ),
            preferred_element_type=_acc_dtype(op.blocks.dtype),
        )  # [*lat, BI, N]
        return y.astype(xc.dtype)

    # kron mode: xc [*lat, KD, BD, N]
    ys = None
    for k, off in enumerate(op.offsets):
        xs = shift(xc, off, nlat)                          # [*lat, KD, BD, N]
        blk = _idx(op.blocks, (slice(None),) * nlat + (k,))  # [*lat, BI, BD]
        # color contraction: [*lat, BI, BD] x [*lat, KD, BD, N]
        t = cplx.cdot_general(
            blk, xs,
            dimension_numbers=(
                ((nlat + 1,), (nlat + 1,)),
                (tuple(range(nlat)), tuple(range(nlat))),
            ),
            preferred_element_type=_acc_dtype(op.blocks.dtype),
        ).astype(xc.dtype)  # [*lat, BI, KD, N]
        # spin factor: kron[k] [KI, KD] applied on the KD axis
        yk = cplx.cbilinear(
            lambda kk, tt: jnp.einsum("ab,...ibn->...ian", kk, tt,
                                      precision=cplx.default_precision()),
            _idx(op.kron, k), t,
        )
        ys = yk if ys is None else cplx.add(ys, yk)        # [*lat, BI, KI, N]
    # reorder to [*lat, KI, BI, N]
    if cplx.is_carray(ys):
        return cplx.cmap(lambda v: jnp.swapaxes(v, nlat, nlat + 1), ys)
    return jnp.swapaxes(ys, nlat, nlat + 1)


def _apply_gather(op: BSROperator, xc: jax.Array) -> jax.Array:
    """General BSR matvec via gather (irregular neighbor lists).  xc:
    [*lat_d, BD, N] -> [*lat_i, BI, N]."""
    nlat = len(op.dim_d)
    BD, N = xc.shape[-2], xc.shape[-1]
    xf = _reshape(xc, (-1, BD, N))
    xg = _idx(xf, op.jj_flat)                 # [voli, nnz, BD, N]
    a = _reshape(op.blocks, (-1,) + op.blocks.shape[nlat:])  # [voli, nnz, BI, BD]
    y = cplx.cdot_general(
        a, xg,
        dimension_numbers=(((1, 3), (1, 2)), ((0,), (0,))),
        preferred_element_type=_acc_dtype(a.dtype),
    )  # [voli, BI, N]
    return _reshape(y, op.dim_i + (y.shape[-2], N)).astype(xc.dtype)


def _apply_gather_kron(op: BSROperator, xc: jax.Array) -> jax.Array:
    """Kronecker-factored matvec on IRREGULAR (gathered) neighbor lists —
    the general create_kron_bsr regime (bsr.h:2302-2336, kron kernels
    bsr.h:398-451): site-dependent sparsity (open boundaries, defects)
    with the two-stage color-then-spin contraction preserved.

    xc: [*lat_d, KD, BD, N] -> [*lat_i, KI, BI, N].
    """
    nlat = len(op.dim_d)
    KD, BD, N = xc.shape[-3], xc.shape[-2], xc.shape[-1]
    xf = _reshape(xc, (-1, KD, BD, N))
    xg = _idx(xf, op.jj_flat)                 # [voli, nnz, KD, BD, N]
    a = _reshape(op.blocks, (-1,) + op.blocks.shape[nlat:])  # [voli, nnz, BI, BD]
    # stage 1 (color): contract BD per (site, slot)
    t = cplx.cdot_general(
        a, xg,
        dimension_numbers=(((3,), (3,)), ((0, 1), (0, 1))),
        preferred_element_type=_acc_dtype(a.dtype),
    )  # [voli, nnz, BI, KD, N]
    # stage 2 (spin): kron[k, KI, KD] summed over (slot, KD); padded
    # slots carry zeroed color blocks, so they contribute nothing
    y = cplx.cdot_general(
        op.kron, t,
        dimension_numbers=(((0, 2), (1, 3)), ((), ())),
        preferred_element_type=_acc_dtype(a.dtype),
    )  # [KI, voli, BI, N]
    y = (cplx.cmap(lambda v: jnp.moveaxis(v, 0, 1), y)
         if cplx.is_carray(y) else jnp.moveaxis(y, 0, 1))
    return _reshape(y, op.dim_i + y.shape[1:]).astype(xc.dtype)


@_tracked("apply_stencil_soa",
          flops_fn=lambda out, op, x_soa, *a, **k:
          op.flops_per_matvec(x_soa.shape[0], True),
          memops_fn=lambda out, op, x_soa, *a, **k:
          op.memops_per_matvec(x_soa.shape[0], 8))
def apply_stencil_soa(op: BSROperator, x_soa: cplx.CArray,
                      interpret: bool = False,
                      packed_parity: Optional[int] = None) -> cplx.CArray:
    """Hot path: SoA stencil matvec.

    ``x_soa``: CArray [ncols, KD*BD, *lat]; returns [ncols, KI*BI, *lat].
    On a GPU it runs the Pallas kernel (ops/stencil_pallas.py); on other
    backends the plain XLA reference, unless ``interpret=True`` asks for
    the kernel in the Pallas interpreter (tests).  Sharded operands are
    partitioned by the kernel's own GSPMD rule: rhs and lattice X/Y
    sharding run shard-local with a halo exchange, and any other
    sharding raises instead of gathering the operands whole."""
    from .ops.stencil_pallas import (
        stencil_matvec_soa,
        stencil_matvec_soa_reference,
    )

    if op.mode != "stencil_soa":
        raise ValueError("operator was not built with layout='soa'")
    bi_v, bd_v = volume(op.bi), volume(op.bd)
    if interpret or jax.default_backend() == "gpu":
        return stencil_matvec_soa(op.blocks, op.kron, x_soa, op.offsets,
                                  bi_v, bd_v, interpret=interpret,
                                  packed_parity=packed_parity)
    return stencil_matvec_soa_reference(op.blocks, op.kron, x_soa,
                                        op.offsets, bi_v, bd_v,
                                        packed_parity=packed_parity)


def _acc_dtype(dt):
    if dt in (jnp.bfloat16.dtype, jnp.float16.dtype):
        return jnp.float32
    if dt == jnp.complex64.dtype:
        return jnp.complex64
    return dt


def _bsr_flops(out, alpha, op, x, ox, *a, **k):
    cols = "".join(c for c in ox if c not in op.lat_d + op.kron_d + op.blk_d)
    ncols = 1
    for c in cols:
        ncols *= x.shape[ox.index(c)]
    power = k.get("power", 1)
    return op.flops_per_matvec(ncols, cplx.is_carray(op.blocks)) * power


@_tracked("bsr_krylov", flops_fn=_bsr_flops)
def bsr_krylov(
    alpha,
    op: BSROperator,
    x: jax.Array,
    ox: str,
    beta=0.0,
    y: Optional[jax.Array] = None,
    oy: Optional[str] = None,
    okr: Optional[str] = None,
    power: int = 1,
) -> jax.Array:
    """Apply the operator: y = alpha * A x + beta * y (bsr_krylov,
    bsr.h:2353-2517).

    ``ox`` must contain the domain lattice labels, the (kron+) domain
    block labels, and any extra column labels.  ``oy`` likewise for the
    image side; when ``okr`` is given, ``oy`` additionally contains the
    power label and the result holds y_p = alpha * A^{p+1} x for p in
    [0, power) — the reference's communication-avoiding operator powers
    (bsr.h:2140-2247).
    """
    check_order(ox)
    # Complex-in/complex-out convenience: internally the engine always
    # runs split (cplx.CArray); merge back on return
    # when the caller handed us a complex array.
    user_complex = (not cplx.is_carray(x)) and jnp.iscomplexobj(x)
    if user_complex:
        x = cplx.from_complex(x)
        if y is not None and not cplx.is_carray(y):
            y = cplx.from_complex(y)
    cols = "".join(c for c in ox
                   if c not in op.lat_d + op.kron_d + op.blk_d)
    if oy is None:
        oy = op.lat_i + op.kron_i + op.blk_i + cols + (okr or "")
    check_order(oy)
    if okr is not None:
        if okr not in oy:
            raise ValueError(f"power label {okr!r} not in oy={oy!r}")
        if y is not None:
            power = y.shape[oy.index(okr)]
    oy_data = "".join(c for c in oy if c != okr)

    # SoA-native ZERO-COPY fast path (the bsr_get_preferred_layout
    # contract, bsr.h:2395-2455): when the caller's ox already matches
    # the SoA hot order (columns, kron+block labels, lattice), the field
    # enters the Pallas kernel by adjacent-axis reshape alone — no
    # transpose in, and none out when oy matches too.  Any other order
    # pays one physical permutation per side, as before.
    soa_native = (op.mode == "stencil_soa"
                  and ox == cols + op.kron_d + op.blk_d + op.lat_d)
    KD = volume(op.kd) if op.kron is not None else 1
    BD = volume(op.bd)
    if soa_native:
        from .ops.stencil_pallas import soa_to_aos

        xv = x if cplx.is_carray(x) else cplx.CArray(x, jnp.zeros_like(x))
        ncl = len(cols)
        col_shape = tuple(xv.re.shape[:ncl])
        lat_shape_d = tuple(
            xv.re.shape[ncl + len(op.kron_d) + len(op.blk_d):])
        Ncols = volume(col_shape)
        xc = cplx.cmap(
            lambda a: a.reshape((Ncols, KD * BD) + lat_shape_d), xv)
        ki_v = volume(op.ki) if op.kron is not None else 1
        bi_v = volume(op.bi)

        def apply_fn(o, v):
            return apply_stencil_soa(o, v)

        def to_user(yc):
            # yc [N, KI*BI, *lat_i] -> user oy_data order
            ki_shape = tuple(op.ki) if op.kron is not None else ()
            if oy_data == cols + op.kron_i + op.blk_i + op.lat_i:
                return cplx.cmap(lambda a: a.reshape(
                    col_shape + ki_shape + tuple(op.bi) + tuple(op.dim_i)),
                    yc)
            y_aos = soa_to_aos(yc, len(op.dim_i), ki_v, bi_v)
            shape = tuple(op.dim_i) + ki_shape + tuple(op.bi) + col_shape
            canon_y = op.lat_i + op.kron_i + op.blk_i + cols
            return local_permute(_reshape(y_aos, shape), canon_y, oy_data)
    else:
        # canonicalize x: [*lat_d, KD?, BD, N]
        canon_x = op.lat_d + op.kron_d + op.blk_d + cols
        xc = local_permute(x, ox, canon_x)
        nlat = len(op.dim_d)
        lat_shape = xc.shape[:nlat]
        Ncols = volume(xc.shape[nlat + len(op.kron_d) + len(op.blk_d):])
        if op.kron is not None:
            xc = _reshape(xc, lat_shape + (KD, BD, Ncols))
        else:
            xc = _reshape(xc, lat_shape + (BD, Ncols))

    if soa_native:
        pass
    elif op.mode == "stencil_soa":
        from .ops.stencil_pallas import aos_to_soa, soa_to_aos

        ki_v = volume(op.ki) if op.kron is not None else 1
        bi_v = volume(op.bi)

        def apply_fn(o, v):
            nl = len(o.dim_d)
            if o.kron is None:
                v = cplx.cmap(lambda a: a[..., None, :, :], v) \
                    if cplx.is_carray(v) else v[..., None, :, :]
            if not cplx.is_carray(v):
                v = cplx.CArray(v, jnp.zeros_like(v))
            y = soa_to_aos(apply_stencil_soa(o, aos_to_soa(v, nl)),
                           nl, ki_v, bi_v)
            if o.kron is None:
                y = cplx.cmap(lambda a: a[..., 0, :, :], y)
            return y
    elif op.mode == "stencil":
        apply_fn = _apply_stencil
    else:
        apply_fn = (_apply_gather_kron if op.kron is not None
                    else _apply_gather)

    if power > 1 and (volume(op.bi) != volume(op.bd) or op.dim_i != op.dim_d
                      or (op.kron is not None and volume(op.ki) != volume(op.kd))):
        raise ValueError(
            "operator powers require a square operator (image and domain "
            "structure must match, as in the reference okr path)"
        )
    outs = []
    cur = xc
    for _ in range(power):
        cur = apply_fn(op, cur)  # [*lat_i, KI?, BI, N]
        outs.append(cur)

    if not soa_native:
        def to_user(yc):
            # yc [*lat_i, KI?, BI, N] -> user oy_data order
            ki_shape = tuple(op.ki) if op.kron is not None else ()
            shape = tuple(op.dim_i) + ki_shape + tuple(op.bi) + tuple(
                x.shape[ox.index(c)] for c in cols
            )
            canon_y = op.lat_i + op.kron_i + op.blk_i + cols
            return local_permute(_reshape(yc, shape), canon_y, oy_data)

    from .ops.copy import _is_static

    def scale(t):
        return t if (_is_static(alpha) and alpha == 1) else cplx.scale(alpha, t)

    if okr is None:
        out = scale(to_user(outs[0]))
        if y is not None and not (_is_static(beta) and beta == 0):
            out = cplx.add(out, cplx.scale(beta, y))
        elif y is not None:
            out = out.astype(y.dtype)
        return cplx.to_complex(out) if user_complex else out

    stacked = _stack([scale(to_user(o)) for o in outs],
                     axis=oy.index(okr))
    if y is not None and not (_is_static(beta) and beta == 0):
        stacked = cplx.add(stacked, cplx.scale(beta, y))
    return cplx.to_complex(stacked) if user_complex else stacked
