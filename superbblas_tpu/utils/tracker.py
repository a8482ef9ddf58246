"""Performance tracking: hierarchical call-path timing + roofline report.

JAX re-creation of the reference's tracker subsystem
(``include/superbblas/performance.h:196-431`` in eromero-vlc/superbblas):
RAII scopes build a "a/b/c" call path; each scope accumulates wall time,
call count, and flop/byte attributions; ``report_timings`` prints per-path
GFLOPS / GBYTES/s / arithmetic intensity.  Differences from the reference:

  * Scopes synchronize via ``jax.block_until_ready`` on request (the
    reference records GPU event pairs; XLA dispatch is async the same
    way) — pass the result arrays to ``Tracker.stop``/use ``track(...,
    sync_on=result)``.
  * Scopes also emit ``jax.profiler.TraceAnnotation`` ranges so the same
    instrumentation shows up in profiler traces (the reference's NVTX
    integration, performance.h:17-22).

Enabled by SBT_TRACK_TIME=1 (flags.py) or force=True; zero overhead when
disabled.  Memory accounting (performance.h:457-518) is approximated with
live-buffer statistics from the jax backend.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax

from .. import flags

__all__ = ["track", "tracked", "get_timings", "reset_timings",
           "report_timings", "report_memory_usage", "memory_snapshot",
           "check_for_memory_leaks"]


@dataclass
class _PathStats:
    calls: int = 0
    seconds: float = 0.0
    flops: float = 0.0
    memops: float = 0.0


_stats: Dict[str, _PathStats] = {}
_local = threading.local()
_lock = threading.Lock()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


@contextmanager
def track(name: str, flops: float = 0.0, memops: float = 0.0,
          sync_on=None, force: bool = False):
    """Track a scope under the hierarchical path of enclosing scopes.

    ``sync_on``: a pytree of jax arrays to block on before stopping the
    clock (otherwise only dispatch time is measured, as XLA is async).
    """
    if not (force or flags.get_track_time()):
        yield
        return
    stack = _stack()
    path = "/".join(stack + [name])
    stack.append(name)
    ann = jax.profiler.TraceAnnotation(name)
    ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        dt = time.perf_counter() - t0
        ann.__exit__(None, None, None)
        stack.pop()
        with _lock:
            st = _stats.setdefault(path, _PathStats())
            st.calls += 1
            st.seconds += dt
            st.flops += flops
            st.memops += memops


def tracked(name: str, flops_fn=None, memops_fn=None):
    """Decorator instrumenting a public op with a tracker scope.

    Zero overhead unless SBT_TRACK_TIME=1.  When enabled, the scope
    blocks on the op's outputs so the recorded time is execution, not
    dispatch (the reference records GPU event pairs the same way,
    performance.h:282-330).  ``flops_fn(out, *args, **kwargs)`` supplies
    the flop attribution."""
    import functools as _ft

    def deco(fn):
        @_ft.wraps(fn)
        def wrapper(*args, **kwargs):
            if flags.get_log_level() >= 1:
                flags.log(1, name)
            if not flags.get_track_time():
                return fn(*args, **kwargs)
            fl = mem = 0.0
            out = None
            # attribute flops under the SAME hierarchical path track()
            # times under (the enclosing-scope stack + this name) — a
            # bare-name bucket would misreport GFLOPS whenever ops nest
            # (e.g. multigrid calling bsr_krylov)
            path = "/".join(_stack() + [name])
            t = track(name)
            with t:
                out = fn(*args, **kwargs)
                jax.block_until_ready(out)
            if flops_fn is not None or memops_fn is not None:
                try:
                    fl = float(flops_fn(out, *args, **kwargs)) if flops_fn else 0.0
                    mem = float(memops_fn(out, *args, **kwargs)) if memops_fn else 0.0
                except Exception:
                    fl = mem = 0.0
                with _lock:
                    st = _stats.setdefault(path, _PathStats())
                    st.flops += fl
                    st.memops += mem
            return out
        return wrapper
    return deco


def get_timings() -> Dict[str, dict]:
    """Snapshot of the accumulated stats (performance.h:105 analog)."""
    with _lock:
        return {
            k: dict(calls=v.calls, seconds=v.seconds, flops=v.flops,
                    memops=v.memops)
            for k, v in _stats.items()
        }


def reset_timings() -> None:
    with _lock:
        _stats.clear()


def report_timings(out=None) -> str:
    """Per-call-path report: calls, time, GFLOPS, GBYTES/s, intensity
    (performance.h:364-431 analog).  Returns the formatted string and
    optionally writes it to ``out``."""
    lines = ["Timing of superbblas_tpu kernels:",
             f"{'path':40s} {'calls':>8s} {'time(s)':>10s} "
             f"{'GFLOPS':>10s} {'GBYTES/s':>10s} {'intensity':>10s}"]
    for path in sorted(get_timings()):
        st = get_timings()[path]
        t = max(st["seconds"], 1e-12)
        gf = st["flops"] / t / 1e9
        gb = st["memops"] / t / 1e9
        inten = st["flops"] / max(st["memops"], 1.0)
        lines.append(f"{path:40s} {st['calls']:8d} {st['seconds']:10.4f} "
                     f"{gf:10.1f} {gb:10.1f} {inten:10.2f}")
    txt = "\n".join(lines)
    if out is not None:
        print(txt, file=out)
    return txt


def report_memory_usage() -> dict:
    """Live device-buffer statistics (memory tracking analog,
    performance.h:457-518).  Per-device bytes of live jax arrays."""
    usage = {}
    for dev in jax.devices():
        try:
            ms = dev.memory_stats()
            if ms:
                usage[str(dev)] = {
                    "bytes_in_use": ms.get("bytes_in_use", 0),
                    "peak_bytes_in_use": ms.get("peak_bytes_in_use", 0),
                }
        except Exception:  # backends without memory_stats
            usage[str(dev)] = {}
    live = 0
    for arr in jax.live_arrays():
        live += arr.size * arr.dtype.itemsize
    usage["live_array_bytes"] = live
    return usage


def memory_snapshot() -> dict:
    """Live-array accounting snapshot for leak checking
    (getCpuMemUsed/getGpuMemUsed analog, performance.h:53-63)."""
    arrs = jax.live_arrays()
    return {
        "count": len(arrs),
        "bytes": int(sum(a.nbytes for a in arrs)),
    }


def check_for_memory_leaks(baseline: dict, tol_bytes: int = 0) -> None:
    """Raise if live device memory grew past the baseline snapshot
    (checkForMemoryLeaks, performance.h:497-518; the reference's tests
    call it at exit under SB_TRACK_MEM=1).  Call gc first if exactness
    matters — Python keeps arrays alive through cycles."""
    import gc

    gc.collect()
    now = memory_snapshot()
    grew = now["bytes"] - baseline["bytes"]
    if grew > tol_bytes:
        raise RuntimeError(
            f"memory leak: live array bytes grew by {grew} "
            f"({baseline['count']} -> {now['count']} arrays)")
