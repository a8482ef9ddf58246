"""Built-in verification utilities — the SBT_DEBUG ladder.

JAX re-creation of the reference's debug nets:
  * mock-index copy verification (dist.h:1919-2116): replay a copy with
    tensors whose values are global linear indices and compare against an
    independently computed truth;
  * numpy reference implementations usable as test oracles;
  * cross-process consistency (dist.h:708-737): XLA collectives cannot
    diverge (single traced program), so ``check_consistency`` validates
    metadata self-consistency locally — but HOST-side collective
    protocol (coordinated storage barriers) can diverge, and
    ``check_collective_consistency`` hashes call metadata across
    processes at SBT_DEBUG>=1 to catch it.
"""

from __future__ import annotations

import itertools

import numpy as np


def numpy_copy_reference(alpha, x, o0, y, o1, from0, size0, from1, copy_add):
    """Element-by-element toroidal reference copy (the oracle)."""
    out = np.array(y, copy=True)
    dim0, dim1 = x.shape, out.shape
    from0 = tuple(from0) if from0 is not None else (0,) * len(o0)
    size0 = tuple(size0) if size0 is not None else dim0
    from1 = tuple(from1) if from1 is not None else (0,) * len(o1)
    for rel in itertools.product(*[range(s) for s in size0]):
        c0 = tuple((f + r) % d for f, r, d in zip(from0, rel, dim0))
        c1 = tuple(
            (from1[j] + (rel[o0.index(c)] if c in o0 else 0)) % dim1[j]
            for j, c in enumerate(o1)
        )
        v = alpha * x[c0]
        if copy_add == "copy":
            out[c1] = v
        else:
            out[c1] += v
    return out


def numpy_contraction_reference(alpha, x0, o0, conj0, x1, o1, conj1, beta, r, o_r):
    a = np.conj(x0) if conj0 else x0
    b = np.conj(x1) if conj1 else x1
    out = alpha * np.einsum(f"{o0},{o1}->{o_r}", a, b)
    if r is not None and beta != 0:
        out = out + beta * np.asarray(r)
    return out


def verify_copy(shape0, o0, shape1, o1, from0, size0, from1, copy_add):
    """Mock-index verification (dist.h:1919-2116 semantics): run the real
    (compiled) copy on index-valued tensors and compare element-wise with
    the numpy oracle.  Raises on mismatch.  Triggered by SBT_DEBUG>=2 on
    every distributed copy."""
    import jax.numpy as jnp

    from ..ops.copy import local_copy

    x = np.arange(1, int(np.prod(shape0)) + 1, dtype=np.float64).reshape(shape0)
    y = -np.arange(1, int(np.prod(shape1)) + 1, dtype=np.float64).reshape(shape1)
    got = np.asarray(
        local_copy(
            1.0, jnp.asarray(x), o0, jnp.asarray(y), o1,
            from0=from0, size0=size0, from1=from1, copy_add=copy_add,
        )
    )
    want = numpy_copy_reference(1.0, x, o0, y, o1, from0, size0, from1, copy_add)
    if not np.array_equal(got, want):
        bad = np.argwhere(got != want)
        raise AssertionError(
            f"mock-index copy verification failed at {bad[:5].tolist()} "
            f"(and {max(len(bad) - 5, 0)} more)"
        )


def check_collective_consistency(tag, payload):
    """Cross-process agreement check for HOST-side collective protocol
    (barriers, coordinated storage writes) — the analog of the
    reference's ``check_consistency``, which hashes call metadata across
    MPI ranks at every collective entry (dist.h:708-737).

    XLA collectives cannot diverge (single traced program), but host-side
    coordination CAN: any code that branches a barrier schedule on
    locally-read state (file contents, wall clock, rng) desynchronizes
    the processes — exactly the ``save_sharded`` conditional-declare bug
    of round 4.  This net catches it at authoring time: every process
    hashes ``(tag, payload)``, the hashes are allgathered, and ALL
    processes raise together on any mismatch (an allgather, not a
    broadcast-and-compare, so no process is left hanging at the next
    barrier while another died).

    Enabled at ``SBT_DEBUG>=1`` by the coordinated-storage entry points;
    free single-process.  ``payload`` must repr deterministically
    (tuples of ints/strings — no sets/dicts with unstable order).
    """
    import jax

    if jax.process_count() <= 1:
        return
    import hashlib

    import numpy as np
    from jax.experimental import multihost_utils

    h = hashlib.sha256(repr((tag, payload)).encode()).digest()[:8]
    mine = np.frombuffer(h, dtype=np.uint64)
    allh = multihost_utils.process_allgather(mine)
    if not (allh == allh[0]).all():
        bad = [int(i) for i in range(len(allh)) if allh[i] != allh[0]]
        raise RuntimeError(
            f"cross-process divergence at collective entry {tag!r}: "
            f"processes {bad} disagree with process 0 on the call "
            f"metadata (local payload: {payload!r}).  A barrier schedule "
            "was branched on locally-divergent state; see "
            "storage._declare_coordinated for the protocol rules.")


def check_consistency(**metadata):
    """Validate that op metadata is self-consistent (labels unique, sizes
    positive).  The reference hashes metadata across MPI ranks
    (dist.h:708-737); in the JAX single-program model divergence cannot
    happen, so this reduces to local validation."""
    for key, val in metadata.items():
        if key.startswith("o") and isinstance(val, str):
            if len(set(val)) != len(val):
                raise ValueError(f"inconsistent metadata {key}={val!r}: repeated labels")
        if key.startswith("size") and val is not None:
            if any(int(s) < 0 for s in val):
                raise ValueError(f"inconsistent metadata {key}={val!r}: negative size")
