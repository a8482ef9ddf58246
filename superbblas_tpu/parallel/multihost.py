"""Multi-host setup: DCN-aware meshes and process initialization.

The reference distributes over MPI ranks (MpiComm, dist.h:126-138) and
leaves topology to mpirun.  Here multi-host means one jax process per
host, all local cards in one global mesh.  The cards of one host reach
each other all to all (NVLink), so inside a host the device order does
not matter; only the axis that crosses hosts does.  ``make_multihost_mesh``
orders devices process-major and puts the leading factor of the named
``dcn_axis`` across processes, with lattice labels as axis names like
``mesh.make_mesh``.

Single-process (tests, one host) the same helpers degrade gracefully to
the local device set.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize_distributed", "make_multihost_mesh"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the jax distributed runtime (the mpirun/MPI_Init analog).

    Pass the coordinator address, process count and id explicitly (no
    cluster is discovered).  Idempotent: safe to call when the
    runtime is already initialized or the job is single-process.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:
        if "already" in str(e).lower() or jax.process_count() == 1:
            return
        raise


def make_multihost_mesh(
    axis_sizes: Dict[str, int],
    dcn_axis: Optional[str] = None,
) -> Mesh:
    """Global mesh over ALL processes' devices with labeled axes.

    ``axis_sizes``: label -> extent (product must equal the global device
    count).  ``dcn_axis`` names the axis that crosses hosts (usually the
    data/domain-parallel one): its leading factor spans the processes,
    the analog of the reference putting the outermost lattice label on
    the node grid (dist.h:3265-3383).
    """
    names = list(axis_sizes.keys())
    shape = [axis_sizes[n] for n in names]
    n = int(np.prod(shape))
    if n != len(jax.devices()):
        raise ValueError(
            f"mesh volume {n} != global device count {len(jax.devices())}")
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    nproc = jax.process_count()
    if dcn_axis is None or nproc == 1:
        return Mesh(np.array(devs).reshape(shape), axis_names=tuple(names))
    if dcn_axis not in axis_sizes:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in axis_sizes")
    if axis_sizes[dcn_axis] % nproc:
        raise ValueError(
            f"dcn axis {dcn_axis!r} ({axis_sizes[dcn_axis]}) must be a "
            f"multiple of the process count ({nproc})")
    # process-major order: the dcn axis's leading factor crosses processes
    dcn_pos = names.index(dcn_axis)
    others = [axis_sizes[nm] for i, nm in enumerate(names) if i != dcn_pos]
    arr = np.array(devs).reshape((axis_sizes[dcn_axis],) + tuple(others))
    return Mesh(np.moveaxis(arr, 0, dcn_pos), axis_names=tuple(names))
