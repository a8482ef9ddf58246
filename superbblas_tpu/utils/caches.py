"""Cache management: the L2 cache-control surface of the reference.

The reference exposes ``clearCaches`` (alloc.h:440: drop the buffer cache
and the LRU metadata caches, e.g. to recover from allocation pressure)
and ``reportCacheUsage`` (performance.h:436-454).  Here the
corresponding caches are:

  * the redistribution plan LRU (parallel/redistribute.make_plan —
    the analog of the reference's cached message plans, dist.h:2303),
  * jax's jit/compilation caches (the analog of the cached permutation
    index vectors: compiled programs embed them),
  * XLA's device allocator (freed buffers are returned by jax GC;
    ``clear_caches`` also drops jax's internal ref-holders).
"""

from __future__ import annotations

import jax

__all__ = ["clear_caches", "report_cache_usage"]


def clear_caches() -> None:
    """Drop every library-level cache (clearCaches, alloc.h:440)."""
    from ..parallel.redistribute import make_plan

    make_plan.cache_clear()
    jax.clear_caches()


def report_cache_usage(out=None) -> dict:
    """Print + return cache statistics, including the plan cache's byte
    footprint against its SBT_CACHEGB budget (reportCacheUsage,
    performance.h:436-454 + cache.h:238-265)."""
    from .. import flags
    from ..parallel.redistribute import make_plan

    info = make_plan.cache_info()
    stats = {
        "redistribution_plans": {
            "entries": info.currsize,
            "hits": info.hits,
            "misses": info.misses,
            "max_entries": info.maxsize,
            "bytes": info.bytes,
            "budget_bytes": int(flags.get_cache_gb() * (1 << 30)),
        },
        "live_device_buffers": len(jax.live_arrays()),
    }
    lines = ["cache usage:"]
    rp = stats["redistribution_plans"]
    lines.append(
        f"  redistribution plans: {rp['entries']}/{rp['max_entries']} "
        f"entries, {rp['bytes']}/{rp['budget_bytes']} bytes, "
        f"{rp['hits']} hits / {rp['misses']} misses")
    lines.append(f"  live device arrays: {stats['live_device_buffers']}")
    print("\n".join(lines), file=out)
    return stats
