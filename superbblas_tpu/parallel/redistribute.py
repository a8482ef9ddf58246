"""Explicit fragment-plan redistribution: the all_to_all fallback path.

GSPMD reshards anything expressible as a NamedSharding, but the reference
supports *arbitrary* partitions — toroidally wrapped, unevenly split,
overlapping (replicated/halo'd) boxes (dist.h:330-560).  This module is
the equivalent of the reference's send/receive machinery
(dist.h:1426-1573).

The box-intersection plan is computed host-side (the reference's
get_indices_to_send/receive, dist.h:1789-1852) and — like the reference's
``copy_n_blocking`` (dist.h:798-1010) — stored as **blocked runs**, not
elements: every fragment decomposes into contiguous runs along the last
axis; a common block size B (the gcd of all run lengths, the analog of
the reference's common blocking, dist.h:798-866) makes every run exactly
B elements, so the plan holds one int32 start offset per B elements
instead of one per element.  Plan memory is O(total runs); the descriptors
are per-rank ragged arrays padded only to the per-rank totals.

Each fragment is seam-split against BOTH local frames into box PIECES
(contiguous in both padded blocks), and two packing strategies consume
them (``SBT_REDIST_PACK``, auto-chosen by piece count):

  * ``pack="boxes"`` (default) — every piece becomes a STATIC XLA
    slice (pack) / update (unpack) baked into a per-rank program
    selected with ``lax.switch(axis_index)``.  Pack/unpack run at copy
    bandwidth for ANY alignment; local (i == j) pieces bypass the
    collective entirely (the reference's local fragment copies,
    dist.h:2392-2435).
  * ``pack="runs"`` — run-granularity gather/scatter with per-rank
    int32 offset tensors (plans with very many pieces, where the
    static program would bloat).  An aligned-rows fast path turns
    B-aligned plans into row-DMA jnp.take/scatter.

Two exchange methods share either packing:

  * ``method="ragged"`` — ``lax.ragged_all_to_all`` with true per-peer
    variable counts (the MPI_Alltoallv analog, dist.h:1502-1548).  The
    HLO is GPU-only here; on CPU the same plan fields and offset math run
    through a dense-collective emulation so tests exercise the layout.
  * ``method="dense"`` — classic tiled ``lax.all_to_all`` with per-pair
    slots padded to the max pair count; works on every backend and is
    the virtual-mesh test path.

Execution happens inside one shard_map as

    pack -> exchange -> unpack

and the plan is cached on the (partitions, copy_add) key in a byte-budget
LRU exactly like the reference's plan cache (dist.h:2303-2349 +
cache.h:238-265 / SB_CACHEGB).

Data container: irregular partitions cannot be jax global arrays, so the
distributed tensor is a **stacked-padded local form** ``[nprocs,
*max_local_shape]`` sharded over a 1-D mesh axis (the analog of the
reference's per-rank raw pointers).  ``pack_global``/``unpack_global``
convert between host numpy global arrays and this form for testing and
I/O.

At SBT_DEBUG>=2 every redistribution is replayed **through the actual
collective path** with index-valued payloads and checked against a
plan-independent host oracle — the reference's ``ns_copy_test`` mock-index
layer (dist.h:1919-2116, 2282-2285).
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from .. import cplx, flags
from ..labels import intersect_box, volume
from .partition import Partition, box_minus

__all__ = ["RedistributionPlan", "make_plan", "redistribute_auto",
           "redistribute_explicit", "pack_global", "unpack_global",
           "pack_global_device", "unpack_global_device",
           "may_need_communications"]


def may_need_communications(src: "Partition", dst: "Partition") -> bool:
    """Fast check whether moving data between the partitions requires any
    cross-process traffic (reference ``may_need_communications``,
    dist.h:2159): False when every destination box is fully contained in
    the same rank's source box."""
    if len(src.boxes) != len(dst.boxes):
        return True
    for (sf, ss), (df, ds) in zip(src.boxes, dst.boxes):
        need = volume(ds)
        if need == 0:
            continue
        got = sum(volume(isz) for _, isz in
                  intersect_box(df, ds, sf, ss, src.dim))
        if got < need:
            return True
    return False


def _split_pieces(ff, fs, sfrm, dfrm, dim):
    """Seam-split one absolute toroidal fragment into box PIECES that are
    contiguous in BOTH local frames.

    The fragment (``ff``, ``fs``) is copied from the src box at ``sfrm``
    to the dst box at ``dfrm``; the fragment and both boxes may wrap.
    Along every axis the fragment is cut wherever either local map
    ``(a - frm) % dim`` wraps (the wrapped-fragment seam pitfall — see
    storage._split_at_seams and CLAUDE.md), so each emitted piece is a
    plain box-to-box copy: ``(src_from_local, dst_from_local, shape)``
    with all coordinates non-wrapping inside the padded local blocks.

    This is the metadata the reference's ``copy_n_blocking`` pack loop
    consumes fragment-wise (dist.h:878-1010); here each piece becomes a
    static XLA slice/update at trace time.
    """
    nd = len(dim)
    per_axis = []
    for a in range(nd):
        f, s, D = ff[a], fs[a], dim[a]
        if D <= 0:
            return
        cuts = {0, s}
        for b in (sfrm[a], dfrm[a]):
            c = (b - f) % D
            while c < s:          # s may exceed D (self-wrapping boxes)
                if c > 0:
                    cuts.add(c)
                c += D
        cs = sorted(cuts)
        segs = []
        for p0, p1 in zip(cs[:-1], cs[1:]):
            a0 = f + p0
            segs.append(((a0 - sfrm[a]) % D, (a0 - dfrm[a]) % D, p1 - p0))
        per_axis.append(segs)
    import itertools

    for combo in itertools.product(*per_axis):
        yield (tuple(c[0] for c in combo), tuple(c[1] for c in combo),
               tuple(c[2] for c in combo))


def _c_strides(shape) -> Tuple[int, ...]:
    """Row-major element strides of a block shape."""
    nd = len(shape)
    st = [1] * nd
    for a in range(nd - 2, -1, -1):
        st[a] = st[a + 1] * shape[a + 1]
    return tuple(st)


def _iter_pieces(arr):
    """Yield (src_from_local, dst_from_local, shape) int tuples from the
    compact [P, 3, nd] piece array."""
    for row in arr:
        yield (tuple(int(v) for v in row[0]),
               tuple(int(v) for v in row[1]),
               tuple(int(v) for v in row[2]))


class RedistributionPlan:
    """Seam-split piece descriptors for one (src, dst) partition pair.

    Core metadata (host-side, O(total pieces)):

      * ``pair_pieces[(i, j)]`` — list of ``(src_from_local,
        dst_from_local, shape)`` box pieces rank i sends to rank j; each
        piece is contiguous in both padded local blocks (seam-split
        against BOTH frames).
      * ``block``        — common run length B: gcd of the pieces'
        last-axis extents (the reference's common blocking,
        dist.h:798-866)
      * ``counts[i, j]`` — number of B-runs rank i sends to rank j
      * ``counts_elems[i, j]`` — the same in elements
      * ``pack``         — executor strategy: ``"boxes"`` bakes the
        pieces as static XLA slice/update ops selected per rank with
        ``lax.switch`` (copy-bandwidth pack/unpack, any alignment);
        ``"runs"`` is the blocked-run gather/scatter fallback for plans
        with too many pieces.

    Run-granularity descriptors (``send_starts``/``recv_starts``: flat
    offsets per rank, concatenated in peer order, padded to the per-rank
    cap) are materialized lazily — only the "runs" executor needs them.

    ``perm`` makes the plan LABEL-PERMUTING: ``dst`` partitions the
    permuted lattice (``perm[k]`` = src axis of dst axis k) and the
    boxes executor transposes each piece into destination order at
    unpack — the reference's one-plan o0 != o1 copy
    (dummy_normalize_copy dist.h:2455-2530 / translate_range
    dist.h:596-654).  ``mask_src``/``mask_dst`` make it masked: the
    boxes executor applies them as elementwise multiplies around the
    unmasked piece plan (``mask_mult``), the runs executor filters to
    element granularity.

    Reference analog: the per-peer index/blocking plans of
    get_indices_to_send/receive + copy_n_blocking (dist.h:798-1010,
    1789-1852).
    """

    #: above this many total pieces the static-copy programs get large;
    #: fall back to the run-blocked gather executor
    MAX_BOX_PIECES = 4096

    def _check_perm_pieces(self, total_pieces: int) -> None:
        """Label-permuting plans force the boxes packer (pieces transpose
        at unpack), which bakes every piece into one static-copy
        ``lax.switch`` program — unbounded piece counts would bloat the
        compiled program without warning (round-4 VERDICT item 8; the
        reference sizes its blocked packs up front, dist.h:798-866)."""
        if total_pieces > self.MAX_BOX_PIECES:
            raise ValueError(
                f"label-permuting plan needs {total_pieces} static box "
                f"pieces (> MAX_BOX_PIECES={self.MAX_BOX_PIECES}); the "
                "boxes packer would bake them all into one lax.switch "
                "program.  Redistribute without `perm` (the runs packer "
                "handles any piece count), then apply the label "
                "permutation locally on the destination "
                "(ops.local_copy/jnp.transpose), or choose partitions "
                "whose boxes align (fewer seam-split pieces).")

    def __init__(self, src: Partition, dst: Partition, copy_add: str = "copy",
                 pack: Optional[str] = None,
                 mask_src: Optional[np.ndarray] = None,
                 mask_dst: Optional[np.ndarray] = None,
                 perm: Optional[Tuple[int, ...]] = None):
        if len(src.boxes) != len(dst.boxes):
            raise ValueError("partitions must have the same number of procs")
        n = len(src.boxes)
        dim = src.dim
        nd = len(dim)
        # label-permuting plan (the reference's one-plan normalization of
        # o0 != o1 copies, dummy_normalize_copy dist.h:2455-2530 +
        # translate_range dist.h:596-654): ``perm[k]`` = the SOURCE axis
        # holding destination axis k (labels.find_permutation(o0, o1)).
        # The dst partition lives on the permuted lattice; its boxes are
        # mapped back to source axis order for plan building, and the
        # boxes executor transposes each piece into destination order at
        # unpack.  Identity perms are dropped.
        if perm is not None:
            perm = tuple(int(p) for p in perm)
            if sorted(perm) != list(range(nd)):
                raise ValueError(f"perm {perm} is not a permutation of "
                                 f"the {nd} lattice axes")
            if tuple(dst.dim) != tuple(dim[p] for p in perm):
                raise ValueError(
                    f"dst lattice {tuple(dst.dim)} is not the perm-{perm} "
                    f"image of the src lattice {tuple(dim)}")
            if perm == tuple(range(nd)):
                perm = None
        self.perm = perm
        # dst boxes in SOURCE axis order (inv[a] = dst axis holding src
        # axis a); self.dst_shape stays the CONTAINER (dst-order) shape
        dst_orig = dst
        if perm is not None:
            inv = [0] * nd
            for k, p in enumerate(perm):
                inv[p] = k
            self._inv = tuple(inv)
            dst_boxes_s = tuple(
                (tuple(f[inv[a]] for a in range(nd)),
                 tuple(s[inv[a]] for a in range(nd)))
                for f, s in dst.boxes)
            dst = Partition(dim=dim, boxes=dst_boxes_s)
        self.n = n
        self.src_shape = tuple(
            max((b[1][i] for b in src.boxes), default=0)
            for i in range(len(dim)))
        dst_shape_s = tuple(
            max((b[1][i] for b in dst.boxes), default=0)
            for i in range(len(dim)))
        self.dst_shape_src = dst_shape_s
        self.dst_shape = (dst_shape_s if perm is None else
                          tuple(dst_shape_s[p] for p in perm))
        self.src_vol = volume(self.src_shape)
        self.dst_vol = volume(self.dst_shape)
        self.copy_add = copy_add

        # seam-split pieces per (i, j) pair
        self.pair_pieces: dict = {}

        def add_fragment(i, j, ff, fs):
            if volume(fs) == 0:
                return
            lst = self.pair_pieces.get((i, j))
            if lst is None:
                lst = self.pair_pieces[(i, j)] = []
            lst.extend(_split_pieces(ff, fs, src.boxes[i][0],
                                     dst.boxes[j][0], dim))

        # Prefer the native C++ plan engine (all-pairs fragment sweep);
        # fall back to the Python box algebra.
        from .. import native

        rows = native.fragment_plan(
            np.asarray([[b[0], b[1]] for b in src.boxes]),
            np.asarray([[b[0], b[1]] for b in dst.boxes]),
            dim, copy_add,
        )
        if rows is not None:
            nd = len(dim)
            for row in rows:
                i, j = int(row[0]), int(row[1])
                add_fragment(i, j, tuple(row[2:2 + nd]),
                             tuple(row[2 + nd:2 + 2 * nd]))
        else:
            for j in range(n):
                dfrm, dsize = dst.boxes[j]
                if volume(dsize) == 0:
                    continue
                remaining = [(dfrm, dsize)]
                for i in range(n):
                    sfrm, ssize = src.boxes[i]
                    if volume(ssize) == 0:
                        continue
                    if copy_add == "copy":
                        new_remaining = []
                        frags = []
                        for rf, rs in remaining:
                            frags.extend(
                                intersect_box(rf, rs, sfrm, ssize, dim))
                            new_remaining.extend(
                                box_minus(rf, rs, sfrm, ssize, dim))
                        remaining = new_remaining
                    else:
                        frags = list(
                            intersect_box(dfrm, dsize, sfrm, ssize, dim))
                    for ff, fs in frags:
                        add_fragment(i, j, ff, fs)

        # compact piece storage: [P, 3, nd] per pair (src_from_local,
        # dst_from_local, shape) — drop empty lists; int32 when the
        # coordinates fit, else int64 (tensor.h:1113-1129 IndexType
        # widening for axes past 2^31)
        cmax = max((max(dim), *(max(s) for _, s in src.boxes),
                    *(max(s) for _, s in dst.boxes)), default=1)
        pdt = np.int32 if cmax < np.iinfo(np.int32).max else np.int64
        self.pair_pieces = {
            k: np.asarray(v, dtype=pdt)
            for k, v in self.pair_pieces.items() if v}

        # common block size: gcd of every piece's last-axis extent — the
        # same value the run decomposition would produce (runs are cut at
        # exactly these seams; the reference's common blocking,
        # dist.h:798-866)
        B = 0
        total_pieces = 0
        counts = np.zeros((n, n), dtype=np.int64)
        counts_e = np.zeros((n, n), dtype=np.int64)
        for (i, j), pieces in self.pair_pieces.items():
            B = math.gcd(B, int(np.gcd.reduce(pieces[:, 2, -1])))
            total_pieces += len(pieces)
        self.block = B = max(B, 1)
        for (i, j), pieces in self.pair_pieces.items():
            vols = np.prod(pieces[:, 2, :].astype(np.int64), axis=1)
            counts_e[i, j] = int(vols.sum())
            counts[i, j] = int((vols // B).sum())
        assert (counts_e == counts * B).all()   # piece vols are multiples of B
        # IndexType widening (the reference's automatic int -> size_t
        # switch for giant tensors, tensor.h:1113-1129): run counts past
        # int32 keep 64-bit HOST metadata — the plan still builds; each
        # executor picks its device index width adaptively
        # (_materialize_runs/dense_idx) and raises only where a single
        # exchanged message itself would overflow 32-bit offsets.
        cdt = (np.int32 if counts.max(initial=0) < np.iinfo(np.int32).max
               else np.int64)
        self.counts = counts.astype(cdt)

        # element masks (the reference's mask-aware plans,
        # dist.h:1852-1916 + the pack/unpack index filtering at
        # dist.h:944-970, 1240-1243): an element moves iff the SOURCE
        # mask at its source-rank replica AND the DESTINATION mask at its
        # destination-rank replica are both set.  Masked-out covered
        # destinations stay ZERO (this path's uncovered-output
        # convention).
        #
        # Two masked strategies:
        #   * pack='boxes' (default): the UNMASKED piece plan is kept and
        #     the masks factor out as elementwise multiplies — the source
        #     block is zeroed at masked-out sites before pack (copy mode
        #     assigns each destination to its FIRST covering rank, so a
        #     zeroed assignment stays zero — the reference filters plan
        #     indices after assignment, dist.h:944-970; add mode sums
        #     contributions, so source zeros drop out of the sum) and the
        #     unpacked output is zeroed at masked-out destinations (md is
        #     per-(rank, site), constant across contributing fragments,
        #     so it distributes over the sum).  Copy bandwidth at any
        #     alignment; trades exchanging masked-out sites as zeros for
        #     box granularity.
        #   * pack='runs': element-granularity filtering — pieces are no
        #     longer boxes after dropping masked elements (B == 1); moves
        #     only the surviving elements.
        self._masked = None
        self.mask_mult = False
        self.mask_src_stack = self.mask_dst_stack = None
        if mask_src is not None or mask_dst is not None:
            ms = (self._stack_mask(mask_src, src)
                  if mask_src is not None else None)
            # dst masks live in DESTINATION axis order (they multiply the
            # unpacked container)
            md = (self._stack_mask(mask_dst, dst_orig)
                  if mask_dst is not None else None)
            self.mask_src_stack, self.mask_dst_stack = ms, md
            if pack is None:
                pack = flags.get_redist_pack()
            if perm is not None:
                # permuting plans transpose whole pieces at unpack; only
                # the boxes executor expresses that
                if pack == "runs":
                    raise ValueError(
                        "label-permuting plans require the 'boxes' packer")
                self._check_perm_pieces(total_pieces)
                pack = "boxes"
            elif pack == "auto":
                pack = ("boxes" if total_pieces <= self.MAX_BOX_PIECES
                        else "runs")
            if pack == "boxes":
                self.mask_mult = True
            else:
                self._masked = {}
                counts[...] = 0
                for (i, j) in list(self.pair_pieces):
                    si, di = self._pair_starts_pieces(i, j, 1)
                    sel = np.ones(len(si), bool)
                    if ms is not None:
                        sel &= ms[i].reshape(-1)[si]
                    if md is not None:
                        sel &= md[j].reshape(-1)[di]
                    if sel.any():
                        self._masked[(i, j)] = (si[sel], di[sel])
                        counts[i, j] = int(sel.sum())
                self.block = B = 1
                cdt = (np.int32
                       if counts.max(initial=0) < np.iinfo(np.int32).max
                       else np.int64)
                self.counts = counts.astype(cdt)
                counts_e = counts.copy()   # post-mask element totals (B == 1)
                pack = "runs"

        # executor strategy: static box copies (any alignment, copy
        # bandwidth) unless the piece count would bloat the program
        if pack is None:
            pack = flags.get_redist_pack()
        if perm is not None:
            if pack == "runs":
                raise ValueError(
                    "label-permuting plans require the 'boxes' packer")
            self._check_perm_pieces(total_pieces)
            pack = "boxes"
        elif pack == "auto":
            pack = "boxes" if total_pieces <= self.MAX_BOX_PIECES else "runs"
        if pack not in ("boxes", "runs"):
            raise ValueError(f"unknown redistribution pack mode {pack!r}")
        self.pack = pack
        if pack == "runs" and B == 1 and counts_e.sum() > (64 << 20):
            import warnings

            warnings.warn(
                "redistribution plan degenerated to element-granularity "
                f"runs ({int(counts_e.sum())} elements): box starts/sizes "
                "share no common divisor along the last axis",
                RuntimeWarning)

        # lazy run-granularity layouts (only the "runs" executor and the
        # dense/inverse derivations need them)
        self._send_starts = None
        self._recv_starts = None
        self._aligned = None
        self._dense = None   # lazy [n, n, pair_cap] layout for method=dense

        self._validate()

    # -- plan-time coverage validation (dist.h:1475-1490 analog) --------
    def _validate(self) -> None:
        """Every piece must stay inside its destination block, and
        copy-mode plans must write every covered destination element
        exactly once.  Overlap detection is a sweep over the piece BOXES
        (sorted by axis-0 start, axis-0-open boxes checked on the
        remaining axes) — O(pieces log pieces + overlapping pairs) host
        work, never O(destination volume), so int64-widened giant plans
        validate without rasterizing multi-GiB coverage arrays."""
        by_dst: dict = {}
        for (i, j), pieces in self.pair_pieces.items():
            by_dst.setdefault(j, []).extend(_iter_pieces(pieces))
        for j, pieces in by_dst.items():
            for sfl, dfl, shp in pieces:
                if any(f + s > b for f, s, b in zip(dfl, shp,
                                                    self.dst_shape_src)):
                    raise ValueError(
                        f"plan writes outside rank {j}'s destination block")
                if any(f + s > b for f, s, b in zip(sfl, shp,
                                                    self.src_shape)):
                    raise ValueError(
                        f"plan reads outside rank {j}'s source block")
            if self.copy_add != "copy":
                continue
            boxes = sorted((tuple(dfl), tuple(shp))
                           for _, dfl, shp in pieces)
            active: list = []   # (end0, dfl, shp) still open on axis 0
            for dfl, shp in boxes:
                start0 = dfl[0] if dfl else 0
                active = [a for a in active if a[0] > start0]
                for _, adfl, ashp in active:
                    if all(max(f1, f2) < min(f1 + s1, f2 + s2)
                           for f1, s1, f2, s2 in zip(dfl[1:], shp[1:],
                                                     adfl[1:], ashp[1:])):
                        raise ValueError(
                            f"copy plan covers a destination element of "
                            f"rank {j} more than once (overlapping "
                            "fragments)")
                active.append(((dfl[0] + shp[0]) if dfl else 1, dfl, shp))

    # -- lazy run-granularity layouts -----------------------------------
    @staticmethod
    def _stack_mask(mask: np.ndarray, part: Partition) -> np.ndarray:
        """Normalize a mask to stacked-local [n, *max_shape] bool form:
        accepts the global [dim] form (every replica of a site shares the
        value) or the stacked form directly (per-rank masks, e.g.
        alternating parities per component)."""
        mask = np.asarray(mask)
        n = len(part.boxes)
        shape = tuple(max((b[1][i] for b in part.boxes), default=0)
                      for i in range(len(part.dim)))
        if mask.shape == tuple(part.dim):
            return pack_global(mask.astype(bool), part)
        if mask.shape == (n,) + shape:
            return mask.astype(bool)
        raise ValueError(
            f"mask shape {mask.shape} is neither the global {part.dim} "
            f"nor the stacked-local {(n,) + shape} form")

    def _pair_starts(self, i: int, j: int, B: int):
        """(src_starts, dst_starts) int64 flat offsets of the (i, j)
        transfer expanded to B-element runs (mask-filtered element lists
        when the plan carries masks — element granularity, B == 1)."""
        if self._masked is not None:
            assert B == 1, "masked plans are element-granularity"
            z = np.zeros(0, np.int64)
            return self._masked.get((i, j), (z, z))
        return self._pair_starts_pieces(i, j, B)

    def _pair_starts_pieces(self, i: int, j: int, B: int):
        """(src_starts, dst_starts) int64 flat offsets of the (i, j)
        pieces expanded to B-element runs, in canonical piece order
        (piece list order; within a piece prefix rows row-major, then
        last-axis B-chunks)."""
        pieces = self.pair_pieces.get((i, j))
        sstr = _c_strides(self.src_shape)
        # dst offsets index the CONTAINER (destination-order) layout;
        # label-permuting plans re-map the stride of each src axis to its
        # destination container axis (perm plans only reach B == 1 here —
        # the boxes executor owns their bulk path)
        dstr_c = _c_strides(self.dst_shape)
        dstr = (dstr_c if self.perm is None
                else tuple(dstr_c[self._inv[a]] for a in range(len(dstr_c))))
        ss, dd = [], []
        for sfl, dfl, shp in (_iter_pieces(pieces)
                              if pieces is not None else ()):
            base_s = sum(f * t for f, t in zip(sfl, sstr))
            base_d = sum(f * t for f, t in zip(dfl, dstr))
            pre_s = np.zeros(1, np.int64)
            pre_d = np.zeros(1, np.int64)
            for a in range(len(shp) - 1):
                ax = np.arange(shp[a], dtype=np.int64)
                pre_s = np.add.outer(pre_s, ax * sstr[a]).reshape(-1)
                pre_d = np.add.outer(pre_d, ax * dstr[a]).reshape(-1)
            ks = np.arange(0, shp[-1], B, dtype=np.int64)
            ss.append((base_s + np.add.outer(pre_s, ks)).reshape(-1))
            dd.append((base_d + np.add.outer(pre_d, ks * dstr[-1]))
                      .reshape(-1))
        if not ss:
            z = np.zeros(0, np.int64)
            return z, z
        return np.concatenate(ss), np.concatenate(dd)

    def _materialize_runs(self) -> None:
        n, B = self.n, self.block
        counts = self.counts.astype(np.int64)
        cap_send = max(int(counts.sum(axis=1).max(initial=0)), 1)
        cap_recv = max(int(counts.sum(axis=0).max(initial=0)), 1)
        idt = (np.int32 if max(self.src_vol, self.dst_vol)
               < np.iinfo(np.int32).max else np.int64)
        send = np.full((n, cap_send), self.src_vol, dtype=idt)
        recv = np.full((n, cap_recv), self.dst_vol, dtype=idt)
        for i in range(n):
            pos = 0
            for j in range(n):
                s, _ = self._pair_starts(i, j, B)
                send[i, pos:pos + len(s)] = s
                pos += len(s)
        for j in range(n):
            pos = 0
            for i in range(n):
                _, d = self._pair_starts(i, j, B)
                recv[j, pos:pos + len(d)] = d
                pos += len(d)
        self._send_starts = send
        self._recv_starts = recv
        # aligned-rows fast path: when every run start is a multiple of B
        # (grid-to-grid repartitions where boxes share divisors), the
        # local blocks reshape to [vol/B, B] and runs become whole ROWS —
        # jnp.take / row scatter instead of the windowed run gather
        self._aligned = bool(
            B > 1 and self.src_vol % B == 0 and self.dst_vol % B == 0
            and (send % B == 0).all() and (recv % B == 0).all())

    @property
    def send_starts(self) -> np.ndarray:
        if self._send_starts is None:
            self._materialize_runs()
        return self._send_starts

    @property
    def recv_starts(self) -> np.ndarray:
        if self._recv_starts is None:
            self._materialize_runs()
        return self._recv_starts

    @property
    def aligned(self) -> bool:
        if self._aligned is None:
            self._materialize_runs()
        return self._aligned

    @property
    def counts_elems(self) -> np.ndarray:
        """Per-pair element counts: exactly ``counts * block`` (every
        piece volume is a multiple of B)."""
        return self.counts.astype(np.int64) * self.block

    # -- derived layouts ------------------------------------------------
    @property
    def pair_cap(self) -> int:
        return max(int(self.counts.max(initial=0)), 1)

    def _pair_slices(self):
        """(send_off, recv_off): exclusive prefix sums of counts along
        the peer axes, for slicing the concatenated per-rank arrays."""
        send_off = np.cumsum(self.counts, axis=1) - self.counts
        recv_off = np.cumsum(self.counts, axis=0) - self.counts
        return send_off, recv_off

    def dense_idx(self):
        """Per-pair padded run-start layout [n, n, pair_cap] for the
        tiled-all_to_all executor (pad = src_vol / dst_vol)."""
        if self._dense is None:
            n, s = self.n, self.pair_cap
            idt = (np.int32 if max(self.src_vol, self.dst_vol)
                   < np.iinfo(np.int32).max else np.int64)
            pack = np.full((n, n, s), self.src_vol, dtype=idt)
            unpack = np.full((n, n, s), self.dst_vol, dtype=idt)
            send_off, recv_off = self._pair_slices()
            for i in range(n):
                for j in range(n):
                    c = int(self.counts[i, j])
                    if c == 0:
                        continue
                    o = int(send_off[i, j])
                    pack[i, j, :c] = self.send_starts[i, o:o + c]
                    o = int(recv_off[i, j])
                    unpack[i, j, :c] = self.recv_starts[j, o:o + c]
            self._dense = (pack, unpack)
        return self._dense

    def recv_inverse(self, dense: bool) -> np.ndarray:
        """Copy-mode aligned-unpack inverse map [n, dst_vol/B]:
        inv[j, dst_row] = recv-buffer slot holding that row (out-of-range
        for uncovered rows -> zero fill in the take).  ``dense`` selects
        the [n * pair_cap] dense-exchange slot layout; otherwise the
        ragged source-order concatenation."""
        attr = "_inv_dense" if dense else "_inv_ragged"
        cached = getattr(self, attr, None)
        if cached is not None:
            return cached
        B = self.block
        rows_n = self.dst_vol // B
        s = self.pair_cap
        # slot values reach n * pair_cap (dense layout); widen past int32
        # and keep the out-of-range sentinel STRICTLY beyond the largest
        # real slot so the fill-mode take never aliases a valid row
        max_slot = self.n * s
        idt = (np.int32 if max_slot + 1 < np.iinfo(np.int32).max
               else np.int64)
        oob = idt(max_slot + 1)
        inv = np.full((self.n, rows_n), oob, dtype=idt)
        _, recv_off = self._pair_slices()
        for j in range(self.n):
            tot = int(self.counts[:, j].sum())
            if tot == 0:
                continue
            rows = self.recv_starts[j, :tot] // B
            if dense:
                slots = np.empty(tot, idt)
                for i in range(self.n):
                    c = int(self.counts[i, j])
                    if c == 0:
                        continue
                    o = int(recv_off[i, j])
                    slots[o:o + c] = i * s + np.arange(c, dtype=idt)
            else:
                slots = np.arange(tot, dtype=idt)
            inv[j, rows] = slots
        setattr(self, attr, inv)
        return inv

    def pair_elem_indices(self, i: int, j: int):
        """Element-granularity (src_idx, dst_idx) for one rank pair —
        the expansion of the piece descriptors, for tests/verification."""
        return self._pair_starts(i, j, 1)

    @property
    def nbytes(self) -> int:
        b = self.counts.nbytes
        b += sum(v.nbytes for v in self.pair_pieces.values())
        b += len(self.pair_pieces) * 8    # dict keys
        for attr in ("_send_starts", "_recv_starts",
                     "_inv_dense", "_inv_ragged"):
            cached = getattr(self, attr, None)
            if cached is not None:
                b += cached.nbytes
        if self._dense is not None:
            b += self._dense[0].nbytes + self._dense[1].nbytes
        return b


class _PlanCache:
    """Byte-budget LRU plan cache: the reference caches plans in an LRU
    evicted by SB_CACHEGB (dist.h:2303-2349 + cache.h:21-199, 238-265).
    Budget: SBT_CACHEGB gigabytes (flags.py), plus an entry-count cap."""

    def __init__(self, maxsize: int = 256):
        import threading

        self.maxsize = maxsize
        self._od: "OrderedDict[tuple, RedistributionPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        # the lru_cache this replaced was thread-safe; keep that contract
        # (async savers / threaded users share the cache)
        self._lock = threading.Lock()

    def __call__(self, src: Partition, dst: Partition,
                 copy_add: str = "copy",
                 mask_src: Optional[np.ndarray] = None,
                 mask_dst: Optional[np.ndarray] = None,
                 perm: Optional[Tuple[int, ...]] = None) -> RedistributionPlan:
        def mask_key(m):
            if m is None:
                return None
            import hashlib

            m = np.ascontiguousarray(np.asarray(m).astype(bool))
            return (m.shape, hashlib.sha1(m.tobytes()).hexdigest())

        key = (src, dst, copy_add, mask_key(mask_src), mask_key(mask_dst),
               None if perm is None else tuple(perm))
        with self._lock:
            plan = self._od.get(key)
            if plan is not None:
                self.hits += 1
                self._od.move_to_end(key)
                return plan
            self.misses += 1
        plan = RedistributionPlan(src, dst, copy_add, mask_src=mask_src,
                                  mask_dst=mask_dst,
                                  perm=perm)  # build unlocked
        with self._lock:
            self._od[key] = plan
            budget = int(flags.get_cache_gb() * (1 << 30))
            while len(self._od) > 1 and (
                    len(self._od) > self.maxsize
                    or self._bytes_locked() > budget):
                self._od.popitem(last=False)
        return plan

    def _bytes_locked(self) -> int:
        return sum(p.nbytes for p in self._od.values())

    @property
    def bytes_in_use(self) -> int:
        with self._lock:
            return self._bytes_locked()

    def cache_clear(self) -> None:
        with self._lock:
            self._od.clear()
            self.hits = 0
            self.misses = 0

    def cache_info(self):
        from collections import namedtuple

        Info = namedtuple("CacheInfo",
                          "hits misses maxsize currsize bytes")
        with self._lock:
            return Info(self.hits, self.misses, self.maxsize,
                        len(self._od), self._bytes_locked())


make_plan = _PlanCache()
make_plan.__doc__ = """Plan cache (the reference caches plans in its LRU
keyed by the partition pair, dist.h:2303-2349, evicted by byte budget
like SB_CACHEGB, cache.h:238-265)."""


# ---------------------------------------------------------------------------
# executors


def _gather_runs(flat: jnp.ndarray, starts: jnp.ndarray, B: int):
    """[cap] run starts -> [cap, B] run payloads (flat is pre-padded with
    B zeros so padding starts gather zeros).

    Expressed as a vmapped dynamic_slice so XLA emits ONE gather with
    slice_sizes=(B,) — whole contiguous runs per index.  The naive
    ``flat[starts[:, None] + arange(B)]`` form lowers to element-wise
    gathering; B-aligned plans take the row-take path in the executor
    instead."""
    return jax.vmap(
        lambda s: jax.lax.dynamic_slice(flat, (s,), (B,)))(starts)


def _gather_rows(loc: jnp.ndarray, starts: jnp.ndarray, B: int,
                 src_vol: int):
    """Aligned fast path: runs are whole rows of the [vol/B, B] view;
    one jnp.take (row-DMA gather).  Padding starts (== src_vol) are
    out-of-bounds rows and fill with zeros — no copy to append a pad
    row."""
    return jnp.take(loc.reshape(-1, B), starts // B, axis=0,
                    mode="fill", fill_value=0)


def _scatter_rows(vals: jnp.ndarray, starts: jnp.ndarray, dst_vol: int,
                  B: int, copy_add: str, dtype):
    out = jnp.zeros((dst_vol // B + 1, B), dtype)
    rows = starts // B
    if copy_add == "copy":
        out = out.at[rows].set(vals.astype(dtype), mode="drop")
    else:
        out = out.at[rows].add(vals.astype(dtype), mode="drop")
    return out[:dst_vol // B].reshape(-1)


def _take_rows_inverse(vals: jnp.ndarray, inv: jnp.ndarray, dtype):
    """Copy-mode aligned unpack as ONE take: inv[dst_row] = recv slot
    (out-of-range for uncovered rows -> zero fill).  Skips the
    zero-buffer + scatter pass of :func:`_scatter_rows`."""
    return jnp.take(vals.astype(dtype), inv, axis=0,
                    mode="fill", fill_value=0).reshape(-1)


def _scatter_runs(vals: jnp.ndarray, starts: jnp.ndarray, dst_vol: int,
                  B: int, copy_add: str, dtype):
    """[cap, B] payloads -> flat [dst_vol] block; padding starts
    (== dst_vol) land in a throwaway pad zone.  Windowed scatter
    (update_window_dims) for the same reason as :func:`_gather_runs`."""
    out = jnp.zeros((dst_vol + B,), dtype)
    dnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(1,), inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0,))
    fn = jax.lax.scatter if copy_add == "copy" else jax.lax.scatter_add
    out = fn(out, starts[:, None].astype(jnp.int32), vals.astype(dtype),
             dnums, mode=jax.lax.GatherScatterMode.CLIP)
    return out[:dst_vol]


def _exchange_ragged(send: jnp.ndarray, counts: jnp.ndarray, cap_recv: int,
                     axis: str) -> jnp.ndarray:
    """True variable-count exchange via lax.ragged_all_to_all (GPU).

    ``send`` [cap_send, B] holds this rank's outgoing runs concatenated
    in destination-rank order; returns [cap_recv, B] runs concatenated in
    source-rank order.  The MPI_Alltoallv analog (dist.h:1502-1548)."""
    r = jax.lax.axis_index(axis)
    my_send = counts[r]                                   # [n] runs to j
    input_offsets = (jnp.cumsum(my_send) - my_send).astype(jnp.int32)
    # where my chunk lands in peer j's recv concat (sources before me)
    col_pre = jnp.cumsum(counts, axis=0) - counts         # [n, n]
    output_offsets = col_pre[r].astype(jnp.int32)
    recv_sizes = counts[:, r].astype(jnp.int32)
    out0 = jnp.zeros((cap_recv,) + send.shape[1:], send.dtype)
    return jax.lax.ragged_all_to_all(
        send, out0, input_offsets, my_send.astype(jnp.int32),
        output_offsets, recv_sizes, axis_name=axis)


def _exchange_ragged_emulated(send: jnp.ndarray, counts: jnp.ndarray,
                              cap_recv: int, axis: str,
                              pair_cap: Optional[int] = None) -> jnp.ndarray:
    """Same contract as :func:`_exchange_ragged`, built on dense tiled
    all_to_all — the CPU stand-in (XLA:CPU has no ragged-all-to-all HLO)
    so the ragged plan layout and offset math are testable on the
    virtual mesh.  ``pair_cap`` bounds the per-pair slot capacity (the
    plan's max pair run count); without it the capacity falls back to
    cap_send, inflating the exchanged buffer ~n-fold."""
    n = counts.shape[0]
    s = send.shape[0]           # cap_send; dense slot per (peer, within)
    B = send.shape[1]
    r = jax.lax.axis_index(axis)
    my_send = counts[r]
    off = jnp.cumsum(my_send) - my_send                   # [n]
    # route each send row to dense slot (peer j, within-pair k)
    m = jnp.arange(s)
    peer = jnp.searchsorted(jnp.cumsum(my_send), m, side="right")
    peer = jnp.minimum(peer, n - 1)
    within = m - off[peer]
    valid = m < my_send.sum()
    cap = pair_cap if pair_cap is not None else s
    dense = jnp.zeros((n * cap, B), send.dtype)
    slot = jnp.where(valid, peer * cap + within, n * cap)
    dense = dense.at[slot].set(send, mode="drop")
    got = jax.lax.all_to_all(dense, axis, 0, 0, tiled=True)  # [n*cap, B]
    # compact back to source-rank-order concatenation
    my_recv = counts[:, r]
    roff = jnp.cumsum(my_recv) - my_recv
    m2 = jnp.arange(cap_recv)
    src = jnp.searchsorted(jnp.cumsum(my_recv), m2, side="right")
    src = jnp.minimum(src, n - 1)
    within2 = m2 - roff[src]
    valid2 = m2 < my_recv.sum()
    slot2 = jnp.where(valid2, src * cap + within2, 0)
    out = jnp.where(valid2[:, None], got[slot2], 0)
    return out


def _supports_ragged(mesh: Mesh) -> bool:
    plat = mesh.devices.flat[0].platform
    return plat == "gpu"


def _execute_boxes(plan: RedistributionPlan, local_stack, mesh: Mesh,
                   axis: str, method: str, alpha=None, out_dtype=None):
    """Static-copy executor: every seam-split piece becomes a static XLA
    slice (pack) / update (unpack) baked into a per-rank program selected
    with ``lax.switch(axis_index)`` — SPMD-legal rank specialization.

    Pack and unpack therefore run at copy bandwidth for ANY alignment
    (the run-gather path degrades ~86x when box starts share no common
    divisor).  Local (i == j) pieces bypass the collective entirely and
    copy straight from the source block — the reference's local fragment
    copies outside send_receive (dist.h:2392-2435).

    Masked plans (``plan.mask_mult``) keep the unmasked pieces and apply
    the masks as elementwise multiplies: source block zeroed at
    masked-out sites before pack (covers the local pieces too — they
    read ``loc``), output zeroed at masked-out destinations after unpack
    (the reference's masked index filtering inside the blocked pack,
    dist.h:944-970, traded for copy-bandwidth box moves)."""
    n = plan.n
    ce = plan.counts_elems.astype(np.int64)
    np.fill_diagonal(ce, 0)                 # diagonal pieces stay local
    if ce.max(initial=0) >= np.iinfo(np.int32).max:
        raise ValueError("boxes exchange exceeds int32 element counts")
    cap_send = max(int(ce.sum(axis=1).max(initial=0)), 1)
    cap_recv = max(int(ce.sum(axis=0).max(initial=0)), 1)
    pair_cap = max(int(ce.max(initial=0)), 1)
    no_comm = int(ce.sum()) == 0
    dst_shape = plan.dst_shape
    copy_add = plan.copy_add
    ragged = method == "ragged"
    supports = _supports_ragged(mesh)
    # recv-buffer base offset of peer i's chunk on rank j
    recv_off = np.cumsum(ce, axis=0) - ce

    def _slices(frm, shp):
        return tuple(slice(f, f + s) for f, s in zip(frm, shp))

    # masks fuse PER PIECE into the pack/unpack slices (jnp.where on the
    # sliced operands — XLA fuses it into each copy) instead of
    # materializing whole masked arrays: the up-front multiply costs two
    # extra full passes
    has_ms = plan.mask_mult and plan.mask_src_stack is not None
    has_md = plan.mask_mult and plan.mask_dst_stack is not None

    def _masked_src(loc, ms0, sl):
        v = loc[sl]
        if has_ms:
            v = jnp.where(ms0[sl], v, jnp.zeros((), v.dtype))
        return v

    def pack_branch(i):
        def f(loc, *mops):
            ms0 = mops[0] if has_ms else None
            parts = []
            used = 0
            for j in range(n):
                if j != i and (i, j) in plan.pair_pieces:
                    for sfl, _, shp in _iter_pieces(
                            plan.pair_pieces[(i, j)]):
                        parts.append(
                            _masked_src(loc, ms0,
                                        _slices(sfl, shp)).reshape(-1))
                        used += volume(shp)
                if not ragged:              # dense: pad each peer slot
                    pad = (j + 1) * pair_cap - used
                    if pad:
                        parts.append(jnp.zeros((pad,), loc.dtype))
                        used += pad
            if ragged and used < cap_send:
                parts.append(jnp.zeros((cap_send - used,), loc.dtype))
            if not parts:
                return jnp.zeros((cap_send if ragged else n * pair_cap,),
                                 loc.dtype)
            return jnp.concatenate(parts)
        return f

    perm = plan.perm

    def unpack_branch(j):
        def f(loc, recv, *mops):
            it = iter(mops)
            ms0 = next(it) if has_ms else None
            md0 = next(it) if has_md else None
            odt = loc.dtype if out_dtype is None else out_dtype
            out = jnp.zeros(dst_shape, odt)

            def apply(out, dfl, shp, piece):
                # pieces arrive in SOURCE axis order; permuting plans
                # transpose each one into destination order here (the
                # reference's one-plan o0 != o1 copy, dist.h:2455-2530),
                # and alpha/precision conversion ride the same update
                # (the T -> Q alpha copy, dist.h:3534-3583)
                if perm is not None:
                    piece = jnp.transpose(piece, perm)
                    sl = tuple(slice(dfl[p], dfl[p] + shp[p])
                               for p in perm)
                else:
                    sl = _slices(dfl, shp)
                piece = piece.astype(odt)
                if alpha is not None:
                    piece = piece * alpha
                if has_md:
                    piece = jnp.where(md0[sl], piece,
                                      jnp.zeros((), piece.dtype))
                return (out.at[sl].set(piece) if copy_add == "copy"
                        else out.at[sl].add(piece))

            if (j, j) in plan.pair_pieces:
                for sfl, dfl, shp in _iter_pieces(plan.pair_pieces[(j, j)]):
                    out = apply(out, dfl, shp,
                                _masked_src(loc, ms0, _slices(sfl, shp)))
            for i in range(n):
                if i == j or (i, j) not in plan.pair_pieces:
                    continue
                off = int(recv_off[i, j]) if ragged else i * pair_cap
                for _, dfl, shp in _iter_pieces(plan.pair_pieces[(i, j)]):
                    v = volume(shp)
                    out = apply(out, dfl, shp,
                                recv[off:off + v].reshape(shp))
                    off += v
            return out
        return f

    pack_fns = [pack_branch(i) for i in range(n)]
    unpack_fns = [unpack_branch(j) for j in range(n)]
    counts_dev = jnp.asarray(ce.astype(np.int32))
    ms = plan.mask_src_stack if has_ms else None
    md = plan.mask_dst_stack if has_md else None

    def body(local, *masks):
        it = iter(masks)
        ms_l = next(it) if ms is not None else None   # [1, *src_shape]
        md_l = next(it) if md is not None else None   # [1, *dst_shape]

        def run(loc):
            r = jax.lax.axis_index(axis)
            pack_ops = (ms_l[0],) if ms is not None else ()
            unpack_ops = pack_ops + ((md_l[0],) if md is not None else ())
            if no_comm:
                recv = jnp.zeros((1,), loc.dtype)
            else:
                send = jax.lax.switch(r, pack_fns, loc, *pack_ops)
                if ragged and supports:
                    recv = _exchange_ragged(send, counts_dev, cap_recv,
                                            axis)
                elif ragged:
                    recv = _exchange_ragged_emulated(
                        send[:, None], counts_dev, cap_recv, axis,
                        pair_cap=pair_cap).reshape(-1)
                else:
                    recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=True)
            out = jax.lax.switch(r, unpack_fns, loc, recv, *unpack_ops)
            return out[None]
        if cplx.is_carray(local):
            return cplx.cmap(lambda a: run(a[0]), local)
        return run(local[0])

    spec_data = PartitionSpec(axis, *([None] * len(plan.src_shape)))
    spec_out = PartitionSpec(axis, *([None] * len(plan.dst_shape)))
    in_specs = [spec_data]
    mask_args = []
    if ms is not None:
        mask_args.append(jnp.asarray(ms))
        in_specs.append(spec_data)
    if md is not None:
        mask_args.append(jnp.asarray(md))
        in_specs.append(spec_out)
    return shard_map(
        body, mesh=mesh, in_specs=tuple(in_specs), out_specs=spec_out,
        check_vma=False,
    )(local_stack, *mask_args)


def _as_device_idx(a: np.ndarray):
    """Move plan index metadata to device, refusing the silent int64 ->
    int32 downcast jax performs with x64 disabled (giant-tensor plans
    carry 64-bit offsets — the reference's int -> size_t IndexType
    switch, tensor.h:1113-1129)."""
    if a.dtype == np.int64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "plan offsets exceed int32 indexing; enable jax_enable_x64 "
            "to execute 64-bit-indexed redistribution plans")
    return jnp.asarray(a)


def _execute(plan: RedistributionPlan, local_stack, mesh: Mesh, axis: str,
             method: str, alpha=None, out_dtype=None):
    """Run one plan inside a shard_map over ``axis``.  ``alpha`` scales
    every moved element and ``out_dtype`` converts it, fused into the
    unpack (the reference's templated T -> Q alpha copy on every path,
    dist.h:3534-3583)."""
    if plan.pack == "boxes":
        return _execute_boxes(plan, local_stack, mesh, axis, method,
                              alpha=alpha, out_dtype=out_dtype)
    assert plan.perm is None, "permuting plans always pack as boxes"
    n, B = plan.n, plan.block
    if plan.counts.max(initial=0) >= np.iinfo(np.int32).max:
        # the PLAN builds with 64-bit metadata (tensor.h:1113-1129
        # analog); the runs executor's per-peer message sizes are
        # 32-bit on device — a single >=2^31-run message cannot be
        # exchanged in one shot
        raise ValueError(
            "a single peer message exceeds int32 run counts; split the "
            "redistribution (smaller boxes) or use pack='boxes'")
    counts = jnp.asarray(plan.counts.astype(np.int32))
    copy_add = plan.copy_add
    dst_vol, dst_shape = plan.dst_vol, plan.dst_shape

    spec_data = PartitionSpec(axis, *([None] * len(plan.src_shape)))
    spec_out = PartitionSpec(axis, *([None] * len(plan.dst_shape)))
    spec_row = PartitionSpec(axis, None)
    aligned = plan.aligned

    def gath(loc, starts):
        if aligned:
            return _gather_rows(loc, starts, B, plan.src_vol)
        flat = jnp.concatenate(
            [loc.reshape(-1), jnp.zeros((B,), loc.dtype)])
        return _gather_runs(flat, starts, B)

    def scat(recv, starts, dtype):
        if aligned:
            return _scatter_rows(recv, starts, dst_vol, B, copy_add, dtype)
        return _scatter_runs(recv, starts, dst_vol, B, copy_add, dtype)

    inv_take = aligned and copy_add == "copy"

    if method == "ragged":
        cap_recv = plan.recv_starts.shape[1]
        if _supports_ragged(mesh):
            exchange = _exchange_ragged
        else:
            import functools as _ft

            exchange = _ft.partial(_exchange_ragged_emulated,
                                   pair_cap=plan.pair_cap)
        send_starts = _as_device_idx(plan.send_starts)  # [n, cap_send]
        recv_starts = _as_device_idx(
            plan.recv_inverse(dense=False) if inv_take
            else plan.recv_starts)

        def body(local, sstarts, rstarts):
            def run(loc):
                odt = loc.dtype if out_dtype is None else out_dtype
                send = gath(loc, sstarts[0])
                recv = exchange(send, counts, cap_recv, axis)
                if alpha is not None:
                    recv = recv.astype(odt) * alpha
                out = (_take_rows_inverse(recv, rstarts[0], odt)
                       if inv_take else scat(recv, rstarts[0], odt))
                return out.reshape((1,) + dst_shape)
            if cplx.is_carray(local):
                return cplx.cmap(lambda a: run(a[0]), local)
            return run(local[0])

        return shard_map(
            body, mesh=mesh,
            in_specs=(spec_data, spec_row, spec_row),
            out_specs=spec_out, check_vma=False,
        )(local_stack, send_starts, recv_starts)

    # method == "dense": per-pair slots padded to the max pair run count
    pack_np, unpack_np = plan.dense_idx()
    s = plan.pair_cap
    pack_idx = _as_device_idx(pack_np)     # [n, n, s]
    spec_idx = PartitionSpec(axis, None, None)

    if inv_take:
        unpack_idx = _as_device_idx(plan.recv_inverse(dense=True))  # [n, rows]
        spec_unpack = PartitionSpec(axis, None)
    else:
        unpack_idx = _as_device_idx(unpack_np)     # [n, n, s]
        spec_unpack = PartitionSpec(None, axis, None)

    def body(local, pidx, uidx):
        # local [1, *src_shape]; pidx [1, n, s];
        # uidx [n, 1, s] (scatter) or [1, rows] (inverse take)
        def run(loc):
            odt = loc.dtype if out_dtype is None else out_dtype
            send = gath(loc, pidx[0].reshape(-1))          # [n*s, B]
            recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=True)
            if alpha is not None:
                recv = recv.astype(odt) * alpha
            if inv_take:
                out = _take_rows_inverse(recv, uidx[0], odt)
            else:
                out = scat(recv, uidx[:, 0, :].reshape(-1), odt)
            return out.reshape((1,) + dst_shape)
        if cplx.is_carray(local):
            return cplx.cmap(lambda a: run(a[0]), local)
        return run(local[0])

    return shard_map(
        body, mesh=mesh,
        in_specs=(spec_data, spec_idx, spec_unpack),
        out_specs=spec_out, check_vma=False,
    )(local_stack, pack_idx, unpack_idx)


def _resolve_method(method: str, mesh: Mesh, axis: str = "p") -> str:
    # a single-rank mesh has no exchange at all: the ragged HLO is
    # pointless there (and a runtime may refuse a 1-device axis) — route
    # ANY resolution (auto, env override, or an explicit
    # method="ragged") to dense before it reaches the collective
    if axis in mesh.shape and mesh.shape[axis] <= 1:
        if method == "ragged":
            import warnings

            warnings.warn(
                "redistribute: method='ragged' on a 1-rank mesh axis is "
                "has nothing to exchange; falling back to 'dense'",
                RuntimeWarning)
        return "dense"
    if method == "auto":
        env = flags.get_redist_method()
        if env != "auto":
            method = env
    if method == "auto":
        return "ragged" if _supports_ragged(mesh) else "dense"
    if method not in ("ragged", "dense"):
        raise ValueError(f"unknown redistribution method {method!r}")
    return method


def redistribute_explicit(
    local_stack,
    src: Partition,
    dst: Partition,
    mesh: Mesh,
    axis: str = "p",
    copy_add: str = "copy",
    method: str = "auto",
    mask_src: Optional[np.ndarray] = None,
    mask_dst: Optional[np.ndarray] = None,
    perm: Optional[Tuple[int, ...]] = None,
    alpha=None,
    out_dtype=None,
):
    """Move data between arbitrary partitions with explicit collectives.

    ``local_stack``: [nprocs, *src_max_shape] array (or CArray) sharded
    over ``mesh`` axis ``axis``.  Returns [nprocs, *dst_max_shape] with
    the same sharding.  ``method``: "ragged" (variable per-peer counts,
    GPU; emulated on CPU), "dense" (tiled all_to_all), or "auto".

    ``mask_src``/``mask_dst``: element masks (global [dim] or stacked
    [n, *max_shape] bool) — an element moves iff both are set at its
    source/destination replicas; masked-out covered destinations are
    ZERO.  The reference's masked distributed copy (dist.h:3534 mask
    arguments; mask-aware plans dist.h:1852-1916).

    ``perm``: label permutation when ``dst`` partitions the PERMUTED
    lattice (``labels.find_permutation(o0, o1)``; the reference's
    one-plan o0 != o1 copy, dummy_normalize_copy dist.h:2455-2530).
    ``alpha``/``out_dtype``: scale + precision-convert every moved
    element inside the one executor call (the templated T -> Q alpha
    copy, dist.h:3534-3583) — no extra materialization pass.  Complex
    ``alpha`` with a CArray input is applied as one fused pre-scale.

    Reference analog: the distributed copy dispatch dist.h:3534 ->
    send_receive dist.h:1426-1573.
    """
    if alpha is not None and isinstance(alpha, complex) and alpha.imag != 0:
        if not cplx.is_carray(local_stack):
            raise ValueError("complex alpha needs a CArray input")
        local_stack = cplx.scale(alpha, local_stack)
        alpha = None
    plan = make_plan(src, dst, copy_add, mask_src=mask_src,
                     mask_dst=mask_dst, perm=perm)
    if axis not in mesh.shape or mesh.shape[axis] != plan.n:
        raise ValueError(
            f"redistribute_explicit: mesh axis {axis!r} must have exactly "
            f"{plan.n} devices (one per partition rank), got "
            f"{mesh.shape.get(axis) if hasattr(mesh.shape, 'get') else mesh.shape}"
        )
    method = _resolve_method(method, mesh, axis)
    if flags.get_debug_level() >= 2:
        _debug_replay(plan, src, dst, mesh, axis, method)
    return _execute(plan, local_stack, mesh, axis, method,
                    alpha=alpha, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# SBT_DEBUG>=2: mock-index replay through the REAL collective path


def _debug_replay(plan: RedistributionPlan, src: Partition, dst: Partition,
                  mesh: Mesh, axis: str, method: str) -> None:
    """Replay the plan with global-index payloads through the actual
    shard_map/collective executor and verify every destination element
    against a plan-INDEPENDENT host oracle (the reference's ns_copy_test,
    dist.h:1919-2116, run at SB_DEBUG>=2 inside the comm layer,
    dist.h:2282-2285)."""
    dim = src.dim
    gidx = (np.arange(volume(dim), dtype=np.int64) + 1).reshape(dim)
    if volume(dim) + 1 > np.iinfo(np.int32).max:
        return  # payload would overflow the int32 carrier
    stack = pack_global(gidx.astype(np.int32), src)
    xd = jax.device_put(
        jnp.asarray(stack),
        NamedSharding(mesh, PartitionSpec(
            axis, *([None] * (stack.ndim - 1)))))
    got = np.asarray(_execute(plan, xd, mesh, axis, method))

    ms, md = plan.mask_src_stack, plan.mask_dst_stack
    for j, (dfrm, dsz) in enumerate(dst.boxes):
        if volume(dsz) == 0:
            continue
        coords = np.meshgrid(*[np.arange(f, f + s) % d
                               for f, s, d in zip(dfrm, dsz, dst.dim)],
                             indexing="ij")
        if plan.perm is not None:
            # dst boxes/coords live on the permuted lattice; map back to
            # source axis order for the coverage/source checks
            coords = [coords[plan._inv[a]] for a in range(len(dim))]
        gblk = gidx[tuple(coords)]

        def src_active(i):
            """(inbox, mask-at-replica) over the dst box coords for src
            rank i."""
            sfrm, ssz = src.boxes[i]
            if volume(ssz) == 0:
                return np.zeros(dsz, bool)
            inbox = np.ones(dsz, dtype=bool)
            locs = []
            for c, f, z, d in zip(coords, sfrm, ssz, dim):
                loc = (c - f) % d
                inbox &= loc < z
                locs.append(np.minimum(loc, max(z - 1, 0)))
            if ms is None:
                return inbox
            return inbox & ms[i][tuple(locs)]

        if plan.copy_add == "copy":
            # first covering rank wins; its mask decides (dropped
            # elements are NOT reassigned — the reference filters plan
            # indices after assignment, dist.h:944-970)
            want = np.zeros(dsz, dtype=np.int64)
            assigned = np.zeros(dsz, dtype=bool)
            for i, (sfrm, ssz) in enumerate(src.boxes):
                if volume(ssz) == 0:
                    continue
                inbox = np.ones(dsz, dtype=bool)
                for c, f, z, d in zip(coords, sfrm, ssz, dim):
                    inbox &= ((c - f) % d) < z
                take = inbox & ~assigned & src_active(i)
                assigned |= inbox
                want[take] = gblk[take]
        else:
            mult = np.zeros(dsz, dtype=np.int64)
            for i in range(len(src.boxes)):
                mult += src_active(i)
            want = gblk * mult
        if md is not None:
            want = np.where(md[j][tuple(slice(0, s) for s in dsz)],
                            want, 0)
        block = got[j][tuple(slice(0, s) for s in dsz)]
        if not np.array_equal(block.astype(np.int64), want):
            bad = np.argwhere(block.astype(np.int64) != want)
            raise RuntimeError(
                f"redistribution debug replay mismatch at dst rank {j}, "
                f"local coords {bad[:5].tolist()} (method={method}, "
                f"block={plan.block}) — the communication plan is "
                "corrupt (ns_copy_test analog, dist.h:1919-2116)")


# ---------------------------------------------------------------------------
# unified entry: GSPMD when expressible, explicit collectives otherwise


def _scalar_key(a):
    """Hashable cache-key form of an alpha scalar."""
    if a is None:
        return None
    return complex(a) if isinstance(a, complex) else float(a)


@functools.lru_cache(maxsize=256)
def _full_support_cached(part: Partition) -> bool:
    """has_full_support runs box-subtraction recursion — cache it so the
    GSPMD fast path stays one device_put per call (Partition is frozen
    and hashable, like the plan-cache keys)."""
    return part.has_full_support()


def redistribute_auto(x, src: Partition, dst: Partition, order: Optional[str] = None,
                 mesh: Optional[Mesh] = None, axis: str = "p",
                 copy_add: str = "copy", method: str = "auto",
                 mask_src: Optional[np.ndarray] = None,
                 mask_dst: Optional[np.ndarray] = None,
                 order_dst: Optional[str] = None,
                 alpha=None, out_dtype=None):
    """Move ``x`` from partition ``src`` to ``dst``, picking the path
    automatically — the reference's single ``copy()`` entry (dist.h:3534)
    that internally chooses direct assignment vs send_receive.

    Two container forms are accepted and preserved:

      * **global** array of shape ``src.dim`` (requires ``order``, the
        lattice labels): when ``dst`` is NamedSharding-expressible
        (regular grid / replicated / on-master — see
        mesh.partition_sharding) and ``copy_add == "copy"``, this is ONE
        ``jax.device_put`` and GSPMD emits the collectives.  Otherwise
        the array is staged through the stacked-local explicit path
        entirely on device (jitted static pack/unpack slices).
      * **stacked-local** ``[nprocs, *src_max_shape]`` sharded over
        ``mesh`` axis ``axis`` (the irregular-partition container):
        always the explicit blocked-run collective path.

    ``order_dst``: destination label order when it differs from
    ``order`` — ``dst`` then partitions the permuted lattice and the
    copy permutes labels in the same plan (``dummy_normalize_copy``,
    dist.h:2455-2530).  ``alpha``/``out_dtype``: fused scale + precision
    conversion (dist.h:3534-3583).
    """
    perm = None
    if order_dst is not None:
        if order is None:
            raise ValueError("order_dst needs the source label order too")
        if order_dst != order:
            from ..labels import find_permutation

            perm = find_permutation(order, order_dst)
            if -1 in perm or len(perm) != len(order):
                raise ValueError(
                    f"order_dst {order_dst!r} is not a permutation of "
                    f"order {order!r}")
    if cplx.is_carray(x):
        if alpha is not None and isinstance(alpha, complex) \
                and alpha.imag != 0:
            x = cplx.scale(alpha, x)
            alpha = None
        return cplx.CArray(
            redistribute_auto(x.re, src, dst, order, mesh, axis, copy_add,
                         method, mask_src, mask_dst, order_dst,
                         alpha, out_dtype),
            redistribute_auto(x.im, src, dst, order, mesh, axis, copy_add,
                         method, mask_src, mask_dst, order_dst,
                         alpha, out_dtype))
    n = len(src.boxes)
    src_shape = tuple(max((b[1][i] for b in src.boxes), default=0)
                      for i in range(len(src.dim)))
    shp = tuple(x.shape)
    if len(shp) == len(src.dim) + 1 and shp[0] == n and shp[1:] == src_shape:
        if mesh is None:
            raise ValueError("stacked-local redistribution needs a mesh")
        return redistribute_explicit(x, src, dst, mesh, axis=axis,
                                     copy_add=copy_add, method=method,
                                     mask_src=mask_src, mask_dst=mask_dst,
                                     perm=perm, alpha=alpha,
                                     out_dtype=out_dtype)
    if shp != tuple(src.dim):
        raise ValueError(
            f"x has shape {shp}: neither the global form {tuple(src.dim)} "
            f"nor the stacked-local form {(n,) + src_shape}")
    if order is None:
        raise ValueError("global-array redistribution needs the label order")
    from .mesh import partition_sharding

    s_dst = partition_sharding(dst, order_dst or order)
    # the GSPMD fast path reinterprets x's existing global values; it is
    # only equivalent to the explicit path when the source covers the
    # lattice — a partial src leaves uncovered destinations ZERO on the
    # explicit path (the ns_copy_test semantics) but STALE under a bare
    # device_put — and masks always need the explicit plan
    if (s_dst is not None and copy_add == "copy"
            and mask_src is None and mask_dst is None
            and _full_support_cached(src)):
        if perm is None and alpha is None and out_dtype is None:
            return jax.device_put(x, s_dst)
        # one jitted transpose/scale/convert with the target sharding —
        # GSPMD fuses the movement with the elementwise work
        key = ("gspmd_pc", s_dst, perm, _scalar_key(alpha), out_dtype,
               x.dtype, x.shape)

        def make():
            def f(v):
                if perm is not None:
                    v = jnp.transpose(v, perm)
                if out_dtype is not None:
                    v = v.astype(out_dtype)
                if alpha is not None:
                    v = v * alpha
                return v
            return jax.jit(f, out_shardings=s_dst)
        return _cached_jit(key, make)(x)

    # explicit fallback through the stacked-local container, packed and
    # unpacked ON DEVICE (jitted static slices — GSPMD moves the shards;
    # no host round-trip, round-2 VERDICT item 8)
    if mesh is None:
        if n > len(jax.devices()):
            raise ValueError(
                f"redistribute_auto: the partitions have {n} ranks but "
                f"only {len(jax.devices())} devices are available and no "
                "mesh was given — pass a mesh whose axis carries the "
                "rank dimension")
        mesh = Mesh(np.asarray(jax.devices()[:n]), (axis,))
    xd = pack_global_device(x, src, mesh, axis)
    out = redistribute_explicit(xd, src, dst, mesh, axis=axis,
                                copy_add=copy_add, method=method,
                                mask_src=mask_src, mask_dst=mask_dst,
                                perm=perm, alpha=alpha, out_dtype=out_dtype)
    glob = unpack_global_device(out, dst, s_dst)
    return glob


# ---------------------------------------------------------------------------
# host-side stacked-local <-> global converters

#: jitted pack/unpack closures keyed on (kind, Partition, mesh/sharding,
#: axis) — jax.jit keys on FUNCTION IDENTITY, so rebuilding the closure
#: per call would recompile the static slice/scatter graph every time
_DEVICE_PACK_CACHE: dict = {}
_DEVICE_PACK_CACHE_MAX = 64


def _cached_jit(key, make):
    fn = _DEVICE_PACK_CACHE.get(key)
    if fn is None:
        if len(_DEVICE_PACK_CACHE) >= _DEVICE_PACK_CACHE_MAX:
            _DEVICE_PACK_CACHE.pop(next(iter(_DEVICE_PACK_CACHE)))
        fn = _DEVICE_PACK_CACHE[key] = make()
    return fn


def pack_global_device(x, part: Partition, mesh: Mesh,
                       axis: str = "p"):
    """Device: global array -> stacked-padded local blocks
    [n, *max_shape] sharded over ``mesh`` axis ``axis`` — one jitted
    graph of static slices (wrapping boxes gather with constant modular
    indices); GSPMD emits whatever collectives the input sharding needs.
    Replaces the host round-trip for the global->explicit staging
    (reference analog: pack_component feeding send_receive,
    dist.h:878-1010)."""
    n = len(part.boxes)
    shape = tuple(max((b[1][i] for b in part.boxes), default=0)
                  for i in range(len(part.dim)))
    out_sh = NamedSharding(mesh, PartitionSpec(axis, *([None] * len(shape))))

    def pack(xg):
        outs = []
        for frm, size in part.boxes:
            if volume(size) == 0:
                outs.append(jnp.zeros(shape, xg.dtype))
                continue
            blk = xg
            for ax, (f, s) in enumerate(zip(frm, size)):
                d = part.dim[ax]
                if f + s <= d:
                    blk = jax.lax.slice_in_dim(blk, f, f + s, axis=ax)
                else:
                    blk = jnp.take(blk, np.arange(f, f + s) % d, axis=ax)
            pad = [(0, shape[a] - size[a]) for a in range(len(shape))]
            if any(p[1] for p in pad):
                blk = jnp.pad(blk, pad)
            outs.append(blk)
        return jnp.stack(outs)

    return _cached_jit(("pack", part, mesh, axis),
                       lambda: jax.jit(pack, out_shardings=out_sh))(x)


def unpack_global_device(stack, part: Partition, out_sharding=None):
    """Device: stacked local blocks -> global array (later ranks win on
    overlap), as a jitted graph of static scatters; the result carries
    ``out_sharding`` when given.  Reference analog: ``unpack`` scattering
    the received buffer into the destination tensor
    (dist.h:1364-1404, prepared by prepare_unpack at dist.h:1155-1238)."""
    dim = part.dim

    def unpack(st):
        out = jnp.zeros(dim, st.dtype)
        for r, (frm, size) in enumerate(part.boxes):
            if volume(size) == 0:
                continue
            blk = st[(r,) + tuple(slice(0, s) for s in size)]
            if all(f + s <= d for f, s, d in zip(frm, size, dim)):
                out = jax.lax.dynamic_update_slice(out, blk, frm)
            else:
                idx = np.ix_(*[np.arange(f, f + s) % d
                               for f, s, d in zip(frm, size, dim)])
                out = out.at[idx].set(blk)
        return out

    def make():
        if out_sharding is not None:
            return jax.jit(unpack, out_shardings=out_sharding)
        return jax.jit(unpack)

    return _cached_jit(("unpack", part, out_sharding), make)(stack)


def pack_global(x: np.ndarray, part: Partition) -> np.ndarray:
    """Host: global array -> stacked-padded local blocks [n, *max_shape]."""
    n = len(part.boxes)
    shape = tuple(max((b[1][i] for b in part.boxes), default=0)
                  for i in range(len(part.dim)))
    out = np.zeros((n,) + shape, dtype=x.dtype)
    for r, (frm, size) in enumerate(part.boxes):
        if volume(size) == 0:
            continue
        src = x
        for ax, (f, s) in enumerate(zip(frm, size)):
            src = np.take(src, (np.arange(f, f + s)) % part.dim[ax], axis=ax)
        out[(r,) + tuple(slice(0, s) for s in size)] = src
    return out


def unpack_global(stack: np.ndarray, part: Partition) -> np.ndarray:
    """Host: stacked local blocks -> global array (later ranks win on
    overlap)."""
    out = np.zeros(part.dim, dtype=stack.dtype)
    for r, (frm, size) in enumerate(part.boxes):
        if volume(size) == 0:
            continue
        block = stack[(r,) + tuple(slice(0, s) for s in size)]
        idx = np.ix_(*[np.arange(f, f + s) % d
                       for f, s, d in zip(frm, size, part.dim)])
        out[idx] = block
    return out
