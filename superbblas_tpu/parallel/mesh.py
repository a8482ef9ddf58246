"""Partition <-> jax.sharding translation.

The reference moves data with explicit MPI plans derived from partition
boxes (dist.h).  Here a partition is realized as a
``jax.sharding.NamedSharding`` over a ``Mesh`` whose axis names are the
distributed lattice labels; XLA's GSPMD then materializes any
redistribution as ICI collectives.  This module does the translation and
builds meshes whose device order matches the reference's rank->box scan
(first distributed label slowest, dist.h:3416-3444).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..labels import volume
from .partition import Partition


def make_mesh(axis_sizes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """Create a Mesh with axes named by lattice labels.

    ``axis_sizes`` maps label -> number of shards, e.g. {"x": 2, "y": 4}.
    """
    if devices is None:
        devices = jax.devices()
    shape = tuple(axis_sizes.values())
    n = volume(shape)
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, only {len(devices)} available")
    arr = np.asarray(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_sizes.keys()))


def partition_sharding(
    part: Partition,
    order: str,
    devices: Optional[Sequence] = None,
    mesh: Optional[Mesh] = None,
) -> Optional[NamedSharding]:
    """NamedSharding equivalent of a regular grid partition, or None.

    Only grid partitions (the output of ``basic_partitioning`` without
    halo) map to GSPMD shardings; box starts must match GSPMD's
    even-chunk layout, i.e. every axis extent divisible by its grid size
    (uneven reference partitions put remainders on the first ranks, which
    GSPMD cannot express — callers fall back to the general path).

    Replicated partitions map to a fully-replicated sharding; a partition
    whose only nonempty box is rank 0's full box ("on master") maps to a
    SingleDeviceSharding.
    """
    if devices is None:
        devices = jax.devices()
    nd = len(part.dim)
    full = ((0,) * nd, part.dim)

    # On-master: one full box on rank 0, everyone else empty.
    nonempty = [i for i, b in enumerate(part.boxes) if volume(b[1]) > 0]
    if nonempty == [0] and part.boxes[0] == full:
        return jax.sharding.SingleDeviceSharding(devices[0])

    if part.is_replicated():
        if mesh is None:
            mesh = Mesh(np.asarray(devices), axis_names=("_r",))
        return NamedSharding(mesh, PartitionSpec())

    grid = part.grid_shape()
    if grid is None:
        return None
    for d, g in zip(part.dim, grid):
        if g > 1 and d % g != 0:
            return None

    if mesh is None:
        # Mesh axes in label order restricted to split axes; device order
        # must match the partition's rank scan.  basic_partitioning scans
        # with dist_labels first; we recover the scan order from the boxes
        # themselves: rank r's grid coordinate.
        axis_labels = [order[i] for i in range(nd) if grid[i] > 1]
        if not axis_labels:
            return NamedSharding(
                Mesh(np.asarray(devices[:1]), axis_names=("_r",)), PartitionSpec()
            )
        # determine rank -> grid coordinate from box starts
        starts = [
            sorted({b[0][i] for b in part.boxes}) for i in range(nd)
        ]
        coords = []
        for b in part.boxes[: volume(grid)]:
            coords.append(tuple(starts[i].index(b[0][i]) for i in range(nd) if grid[i] > 1))
        shape = tuple(g for g in grid if g > 1)
        arr = np.empty(shape, dtype=object)
        for r, c in enumerate(coords):
            arr[c] = devices[r]
        mesh = Mesh(arr, axis_names=tuple(axis_labels))

    spec = PartitionSpec(
        *[
            (order[i] if grid[i] > 1 and order[i] in mesh.axis_names else None)
            for i in range(nd)
        ]
    )
    return NamedSharding(mesh, spec)


def sharding_partition(sharding, shape) -> Partition:
    """Partition metadata (box per device) for an existing sharding —
    the inverse translation, used by storage manifests and debug checks."""
    boxes = []
    nd = len(shape)
    dev_map = sharding.devices_indices_map(tuple(shape))
    for dev in sorted(dev_map.keys(), key=lambda d: d.id):
        idx = dev_map[dev]
        frm, size = [], []
        for i, sl in enumerate(idx):
            start = sl.start or 0
            stop = sl.stop if sl.stop is not None else shape[i]
            frm.append(start)
            size.append(stop - start)
        boxes.append((tuple(frm), tuple(size)))
    return Partition(dim=tuple(shape), boxes=tuple(boxes))
