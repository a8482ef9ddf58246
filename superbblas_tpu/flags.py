"""Runtime configuration via environment variables.

Analog of the reference's ``runtime_features.h:15-158`` (env vars
``SB_*`` read lazily once).  We keep the same spirit with an ``SBT_`` prefix:

  * ``SBT_LOG``   (int, default 0): >0 prints operation-level logging.
  * ``SBT_DEBUG`` (int, default 0): 0 none; >=1 cross-process consistency
    checks on distributed ops; >=2 mock-index verification of every
    distributed copy (see utils/testing.py).
  * ``SBT_TRACK_TIME`` (0/1): enable the tracker (utils/tracker.py).
  * ``SBT_TRACK_MEM``  (0/1): enable live-array accounting.
  * ``SBT_REDIST_METHOD`` ("auto"|"ragged"|"dense", default "auto"): the
    explicit-redistribution exchange flavor — the analog of the
    reference's ``SB_USE_ALLTOALL``/``SB_MPI_NONBLOCK`` collective
    selection (runtime_features.h:101-125): "ragged" =
    lax.ragged_all_to_all per-peer variable counts, "dense" = tiled
    all_to_all, "auto" picks per backend.
  * ``SBT_REDIST_PACK`` ("auto"|"boxes"|"runs", default "auto"): the
    explicit-redistribution packing strategy — "boxes" = static
    seam-split box copies per rank (lax.switch), "runs" = blocked-run
    gather/scatter plans.
  * ``SBT_CACHEGB`` (float, default 1.0): byte budget in GiB for the
    library-level metadata caches (redistribution plans) — the analog of
    the reference's ``SB_CACHEGB`` (cache.h:238-265).  Exceeding the
    budget evicts least-recently-used plans.
  * ``SBT_MATMUL_PRECISION`` ("highest"|"high"|"default", default
    "highest"): precision of f32 matmuls/einsums.  On the GPU "default"
    lets XLA run f32 products in TF32 on the tensor cores (about three
    decimal digits); "highest" keeps true f32.  The default is "highest"
    because the reference library computes in true fp32/fp64 and the
    test parity contract (BASELINE.md) is "bitwise-tolerant fp32" —
    benchmarks that want tensor-core speed pass bf16 operands
    explicitly, where this flag is a no-op.  The SoA stencil is
    unaffected (it does no matmul: every product is an f32 FMA).
"""

from __future__ import annotations

import functools
import os


@functools.lru_cache(maxsize=None)
def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"environment variable {name} must be an int, got {v!r}")


def get_log_level() -> int:
    return _env_int("SBT_LOG", 0)


def get_debug_level() -> int:
    return _env_int("SBT_DEBUG", 0)


def get_track_time() -> bool:
    return bool(_env_int("SBT_TRACK_TIME", 0))


def get_track_mem() -> bool:
    return bool(_env_int("SBT_TRACK_MEM", 0))


@functools.lru_cache(maxsize=None)
def _env_str(name: str, default: str) -> str:
    v = os.environ.get(name)
    return default if v is None or v == "" else v


@functools.lru_cache(maxsize=None)
def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(
            f"environment variable {name} must be a float, got {v!r}")


def get_redist_method() -> str:
    """Explicit-redistribution exchange flavor (SB_USE_ALLTOALL analog,
    runtime_features.h:101-125)."""
    v = _env_str("SBT_REDIST_METHOD", "auto").lower()
    if v not in ("auto", "ragged", "dense"):
        raise ValueError(
            f"SBT_REDIST_METHOD must be auto|ragged|dense, got {v!r}")
    return v


def get_redist_pack() -> str:
    """Explicit-redistribution packing strategy: "boxes" bakes seam-split
    fragment pieces as static XLA copies per rank (copy bandwidth, any
    alignment), "runs" uses blocked-run gather/scatter index plans (for
    plans with very many pieces), "auto" picks by piece count.  The
    analog of the reference's pack/copy_n_blocking layer choice
    (dist.h:798-1010)."""
    v = _env_str("SBT_REDIST_PACK", "auto").lower()
    if v not in ("auto", "boxes", "runs"):
        raise ValueError(
            f"SBT_REDIST_PACK must be auto|boxes|runs, got {v!r}")
    return v


def get_cache_gb() -> float:
    """Metadata-cache byte budget in GiB (SB_CACHEGB analog,
    cache.h:238-265)."""
    return _env_float("SBT_CACHEGB", 1.0)


def get_matmul_precision() -> str:
    v = _env_str("SBT_MATMUL_PRECISION", "highest").lower()
    if v not in ("default", "high", "highest"):
        raise ValueError(
            f"SBT_MATMUL_PRECISION must be default|high|highest, got {v!r}")
    return v


def clear_cache() -> None:
    """Re-read environment variables (for tests)."""
    _env_int.cache_clear()
    _env_str.cache_clear()
    _env_float.cache_clear()


def log(level: int, msg: str) -> None:
    if get_log_level() >= level:
        print(f"[sbt] {msg}", flush=True)
