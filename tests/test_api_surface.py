"""API-surface contract: every advertised symbol exists and the
documented public inventory stays importable (the parity surface the
judge/API.md promise)."""

import importlib

import pytest

MODULES = [
    "superbblas_tpu",
    "superbblas_tpu.bsr",
    "superbblas_tpu.cplx",
    "superbblas_tpu.dense",
    "superbblas_tpu.flags",
    "superbblas_tpu.labels",
    "superbblas_tpu.solvers",
    "superbblas_tpu.storage",
    "superbblas_tpu.aot",
    "superbblas_tpu.context",
    "superbblas_tpu.models",
    "superbblas_tpu.models.multigrid",
    "superbblas_tpu.models.eo_packed",
    "superbblas_tpu.parallel",
    "superbblas_tpu.parallel.partition",
    "superbblas_tpu.parallel.redistribute",
    "superbblas_tpu.parallel.halo",
    "superbblas_tpu.parallel.overlap",
    "superbblas_tpu.parallel.powers",
    "superbblas_tpu.parallel.stencil_sharded",
    "superbblas_tpu.parallel.multihost",
    "superbblas_tpu.ops.copy",
    "superbblas_tpu.ops.contract",
    "superbblas_tpu.ops.reduce",
    "superbblas_tpu.ops.stencil_pallas",
    "superbblas_tpu.utils.compile_cache",
    "superbblas_tpu.utils",
    "superbblas_tpu.utils.tracker",
    "superbblas_tpu.utils.testing",
    "superbblas_tpu.utils.caches",
    "superbblas_tpu.native",
]


@pytest.mark.parametrize("modname", MODULES)
def test_all_symbols_exist(modname):
    mod = importlib.import_module(modname)
    for name in getattr(mod, "__all__", []):
        assert hasattr(mod, name), f"{modname}.__all__ lists missing {name}"


def test_reference_parity_inventory():
    """The reference's public API (SURVEY §2) has a named equivalent."""
    import superbblas_tpu as sbt

    inventory = {
        # tensor.h / dist.h
        "copy": sbt.parallel.copy,
        "contraction": sbt.parallel.contraction,
        "local_copy": sbt.local_copy,
        "local_contraction": sbt.local_contraction,
        "basic_partitioning": sbt.basic_partitioning,
        "partitioning_distributed_procs": sbt.partitioning_distributed_procs,
        "make_hole": sbt.make_hole,
        # bsr.h
        "create_bsr": sbt.create_bsr,
        "create_kron_bsr": sbt.create_kron_bsr,
        "bsr_krylov": sbt.bsr_krylov,
        "bsr_get_preferred_layout": sbt.bsr_get_preferred_layout,
        # dense.h
        "cholesky": sbt.cholesky,
        "trsm": sbt.trsm,
        "gesm": sbt.gesm,
        "inversion": sbt.inversion,
        # storage.h
        "create_storage": sbt.storage.create_storage,
        "open_storage": sbt.storage.open_storage,
        "append_blocks": sbt.storage.append_blocks,
        "save": sbt.storage.save,
        "load": sbt.storage.load,
        "check_or_write_checksums": sbt.storage.check_or_write_checksums,
        "close_storage": sbt.storage.close_storage,
        # platform.h / dist.h Request
        "createCpuContext": sbt.context.create_cpu_context,
        "createGpuContext": sbt.context.create_gpu_context,
        "wait": sbt.context.wait,
        # alloc.h / cache.h / performance.h
        "clearCaches": sbt.utils.clear_caches,
        "reportCacheUsage": sbt.utils.report_cache_usage,
        "getTimings": sbt.utils.get_timings,
        "resetTimings": sbt.utils.reset_timings,
        "reportTimings": sbt.utils.report_timings,
        "checkForMemoryLeaks": sbt.utils.check_for_memory_leaks,
    }
    for name, fn in inventory.items():
        assert callable(fn), name
