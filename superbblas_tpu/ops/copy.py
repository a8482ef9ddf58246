"""Label-based local tensor copy / permute / scale / add.

Functional re-design of the reference's local copy engine
(``include/superbblas/tensor.h:963-1129`` + ``copy_n.h`` in
eromero-vlc/superbblas).  Instead of emitting gather/scatter index vectors
and dispatching hand-rolled kernels, we express the copy as a composition of
static slices, concatenations (toroidal wrap), transposes and in-place
``.at[]`` updates — all shapes are static, so XLA fuses the whole thing into
one (or a few, when the box wraps) copy kernels.

Semantics (matching the reference `local_copy`, tensor.h:1055-1129):

    y' = y;  y'[box1] = alpha * permute(x[box0])        (copy_add="copy")
    y' = y;  y'[box1] += alpha * permute(x[box0])       (copy_add="add")

where box0 = (from0, size0) over x's labels o0 (wrapping toroidally when
from0+size0 exceeds the extent), box1 starts at from1 and has size0's sizes
translated through the label permutation o0->o1.  Labels of o0 with extent
1 may be absent from o1 and vice versa.

Masks: optional host-side (numpy) masks on the full tensors.  Within the
copy box, the i-th nonzero-masked source element is copied to the i-th
nonzero-masked destination element (compaction pairing, exactly the
reference's `select`-based path, tensor.h:1021-1030).  Masks being host
metadata keeps shapes static under jit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import cplx
from ..labels import (
    check_isomorphic,
    check_order,
    find_permutation,
    reorder_coor,
    split_box,
    volume,
)

_STATIC_SCALARS = (int, float, complex, np.integer, np.floating, np.complexfloating)


def _is_static(alpha) -> bool:
    return isinstance(alpha, _STATIC_SCALARS)


def _extract_box(x, frm, size):
    """Slice a possibly-wrapping box out of ``x`` with static shapes."""
    for axis, (f, s, d) in enumerate(zip(frm, size, x.shape)):
        if s == d and f == 0:
            continue
        f = f % d if d > 0 else 0
        idx = [slice(None)] * x.ndim
        if f + s <= d:
            idx[axis] = slice(f, f + s)
            x = x[tuple(idx)]
        else:
            idx[axis] = slice(f, d)
            hi = x[tuple(idx)]
            idx[axis] = slice(0, s - (d - f))
            lo = x[tuple(idx)]
            x = jnp.concatenate([hi, lo], axis=axis)
    return x


def _permute_to(x_box, o0: str, o1: str):
    """Transpose/reshape a box with labels o0 into label order o1.

    Labels of o0 absent from o1 must have extent 1 (checked by the caller);
    labels of o1 absent from o0 become new length-1 axes.
    """
    # Drop size-1 axes whose labels are not in o1.
    keep = [i for i, c in enumerate(o0) if c in o1]
    dropped = [i for i, c in enumerate(o0) if c not in o1]
    if dropped:
        x_box = x_box.reshape([x_box.shape[i] for i in keep])
        o0 = "".join(o0[i] for i in keep)
    # Transpose kept axes into o1's relative order.
    order_in_o1 = [c for c in o1 if c in o0]
    perm = [o0.index(c) for c in order_in_o1]
    if perm != list(range(len(perm))):
        x_box = jnp.transpose(x_box, perm)
    # Insert length-1 axes for o1 labels not in o0.
    if len(order_in_o1) != len(o1):
        shape = []
        k = 0
        for c in o1:
            if c in o0:
                shape.append(x_box.shape[k])
                k += 1
            else:
                shape.append(1)
        x_box = x_box.reshape(shape)
    return x_box


def local_copy(
    alpha,
    x: jax.Array,
    o0: str,
    y: jax.Array,
    o1: str,
    from0: Optional[Sequence[int]] = None,
    size0: Optional[Sequence[int]] = None,
    from1: Optional[Sequence[int]] = None,
    copy_add: str = "copy",
    mask0: Optional[np.ndarray] = None,
    mask1: Optional[np.ndarray] = None,
) -> jax.Array:
    """Copy/add the box (from0, size0) of ``x`` into ``y`` at ``from1``.

    Returns the updated ``y`` (functional).  See module docstring for the
    full semantics.
    """
    check_order(o0)
    check_order(o1)
    if copy_add not in ("copy", "add"):
        raise ValueError(f"copy_add must be 'copy' or 'add', got {copy_add!r}")

    if cplx.is_carray(x) or cplx.is_carray(y):
        # Split-complex path: run the structural copy per part, mixing
        # parts only for a complex alpha.
        xc = x if cplx.is_carray(x) else cplx.CArray(x, jnp.zeros_like(x))
        yc = y if cplx.is_carray(y) else cplx.CArray(y, jnp.zeros_like(y))
        ar, ai = cplx._split_scalar(alpha)
        xs = cplx.scale(alpha, xc) if ai is not None else xc
        a_eff = 1 if ai is not None else alpha
        return cplx.CArray(
            local_copy(a_eff, xs.re, o0, yc.re, o1, from0, size0, from1,
                       copy_add, mask0, mask1),
            local_copy(a_eff, xs.im, o0, yc.im, o1, from0, size0, from1,
                       copy_add, mask0, mask1),
        )
    dim0 = tuple(x.shape)
    dim1 = tuple(y.shape)
    if len(dim0) != len(o0):
        raise ValueError(f"x has rank {len(dim0)} but o0={o0!r}")
    if len(dim1) != len(o1):
        raise ValueError(f"y has rank {len(dim1)} but o1={o1!r}")
    from0 = tuple(from0) if from0 is not None else (0,) * len(o0)
    size0 = tuple(size0) if size0 is not None else dim0
    from1 = tuple(from1) if from1 is not None else (0,) * len(o1)
    check_isomorphic(o0, size0, dim0, o1, dim1)
    if volume(size0) == 0:
        return y

    perm01 = find_permutation(o0, o1)
    size1 = reorder_coor(size0, perm01, blank=1)

    if mask0 is not None or mask1 is not None:
        return _masked_copy(
            alpha, x, o0, y, o1, from0, size0, from1, size1, copy_add, mask0, mask1
        )

    # Zero-fill shortcut: alpha == 0 with copy means "zero the box".
    if _is_static(alpha) and alpha == 0:
        if copy_add == "add":
            return y
        zeros = jnp.zeros(size1, dtype=y.dtype)
        return _write_box(y, from1, size1, zeros, "copy")

    src = _extract_box(x, from0, size0)
    src = _permute_to(src, o0, o1)
    if not (_is_static(alpha) and alpha == 1):
        src = src * alpha
    src = src.astype(y.dtype)
    return _write_box(y, from1, size1, src, copy_add)


def _write_box(y, from1, size1, src, copy_add):
    """Write ``src`` (shaped ``size1``) into ``y`` at ``from1``, splitting
    the destination box into contiguous fragments when it wraps."""
    full = all(f == 0 and s == d for f, s, d in zip(from1, size1, y.shape))
    if full:
        return src if copy_add == "copy" else y + src
    for offset, ffrom, fsize in split_box(from1, size1, y.shape):
        src_idx = tuple(slice(o, o + s) for o, s in zip(offset, fsize))
        dst_idx = tuple(slice(f, f + s) for f, s in zip(ffrom, fsize))
        piece = src[src_idx]
        if copy_add == "copy":
            y = y.at[dst_idx].set(piece)
        else:
            y = y.at[dst_idx].add(piece)
    return y


def _box_flat_indices(frm, size, dim) -> np.ndarray:
    """Row-major flat indices (into a dim-shaped array) of the elements of a
    possibly-wrapping box, in box scan order.  Host-side (numpy)."""
    axes = [ (np.arange(f, f + s) % d) for f, s, d in zip(frm, size, dim) ]
    grid = np.meshgrid(*axes, indexing="ij") if axes else []
    if not axes:
        return np.zeros((1,), dtype=np.int64)
    flat = np.zeros(tuple(size), dtype=np.int64)
    stride = 1
    strides = np.empty(len(dim), dtype=np.int64)
    for i in range(len(dim) - 1, -1, -1):
        strides[i] = stride
        stride *= dim[i]
    for g, s in zip(grid, strides):
        flat += g.astype(np.int64) * s
    return flat.reshape(-1)


def _masked_copy(alpha, x, o0, y, o1, from0, size0, from1, size1, copy_add,
                 mask0, mask1):
    """Compaction-pairing masked copy (reference tensor.h:1021-1030).

    Masks are host-side numpy arrays over the *full* tensors.  The i-th
    masked element of the source box (scanned in destination label order) is
    copied to the i-th masked element of the destination box.
    """
    dim0, dim1 = tuple(x.shape), tuple(y.shape)
    if mask0 is None:
        mask0 = np.ones(dim0, dtype=bool)
    if mask1 is None:
        mask1 = np.ones(dim1, dtype=bool)
    mask0 = np.asarray(mask0).astype(bool)
    mask1 = np.asarray(mask1).astype(bool)

    # Source box element flat indices, scanned in o1 (destination) order so
    # pairing matches the reference's common scan order.
    idx0 = _box_flat_indices(from0, size0, dim0).reshape(size0)
    # reorder the scan to o1 axis order
    perm10 = [o0.index(c) for c in o1 if c in o0]
    extra = [i for i, c in enumerate(o0) if c not in o1]
    idx0 = np.transpose(idx0, perm10 + extra).reshape(-1)
    m0 = mask0.reshape(-1)[idx0]
    src_sel = idx0[m0]

    idx1 = _box_flat_indices(from1, size1, dim1)
    m1 = mask1.reshape(-1)[idx1]
    dst_sel = idx1[m1]

    if src_sel.size != dst_sel.size:
        raise ValueError(
            f"masked copy: incompatible masks ({src_sel.size} source vs "
            f"{dst_sel.size} destination selected elements)"
        )
    if src_sel.size == 0:
        return y

    vals = x.reshape(-1)[jnp.asarray(src_sel)]
    if _is_static(alpha):
        if alpha == 0:
            vals = jnp.zeros_like(vals)
        elif alpha != 1:
            vals = vals * alpha
    else:
        vals = vals * alpha
    vals = vals.astype(y.dtype)
    yf = y.reshape(-1)
    dst_sel = jnp.asarray(dst_sel)
    if copy_add == "copy":
        yf = yf.at[dst_sel].set(vals, unique_indices=True)
    else:
        yf = yf.at[dst_sel].add(vals, unique_indices=True)
    return yf.reshape(y.shape)


def local_permute(x, o0: str, o1: str, dtype=None):
    """Return ``x`` with axes reordered from label order o0 to o1.
    Accepts plain arrays or split-complex cplx.CArray."""
    check_order(o0)
    check_order(o1)
    if cplx.is_carray(x):
        out = cplx.cmap(lambda v: _permute_to(v, o0, o1), x)
    else:
        out = _permute_to(x, o0, o1)
    if dtype is not None:
        out = out.astype(dtype)
    return out
