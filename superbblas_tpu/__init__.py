"""superbblas_tpu — a distributed tensor-algebra engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
superbblas C++ library (label-based tensor copy/permute/scale/add, einsum
contractions, block-sparse lattice operators, distributed dense solvers,
sharded storage), re-designed for XLA: GSPMD meshes instead of MPI,
dot_general/Pallas instead of hand-dispatched BLAS, ppermute halo exchange instead of
Ialltoallv.
"""

from . import aot, bsr, context, cplx, dense, flags, labels, models, native, parallel, solvers, storage, utils
from .bsr import (
    BSROperator,
    bsr_cast_storage,
    bsr_from_stencil,
    bsr_get_preferred_layout,
    bsr_krylov,
    create_bsr,
    create_kron_bsr,
)
from .dense import cholesky, gesm, inversion, trsm
from .labels import ContractionPlan
from .ops import local_contraction, local_copy, local_permute
from .parallel import (
    Partition,
    basic_partitioning,
    contraction,
    copy,
    make_hole,
    make_mesh,
    partition_sharding,
    partitioning_distributed_procs,
    reshard,
)

__version__ = "0.1.0"

__all__ = [
    "aot",
    "bsr",
    "context",
    "cplx",
    "dense",
    "native",
    "storage",
    "flags",
    "labels",
    "models",
    "parallel",
    "utils",
    "BSROperator",
    "bsr_cast_storage",
    "bsr_from_stencil",
    "bsr_get_preferred_layout",
    "bsr_krylov",
    "create_bsr",
    "create_kron_bsr",
    "ContractionPlan",
    "cholesky",
    "trsm",
    "gesm",
    "inversion",
    "solvers",
    "local_copy",
    "local_permute",
    "local_contraction",
    "Partition",
    "basic_partitioning",
    "contraction",
    "copy",
    "make_hole",
    "make_mesh",
    "partition_sharding",
    "partitioning_distributed_procs",
    "reshard",
]
