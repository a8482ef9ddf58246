"""Execution contexts and asynchrony: the platform layer.

The reference's L1 (platform.h) manages CPU/GPU contexts, streams,
causality and BLAS handles; in JAX those concerns collapse into jax's
device model and async dispatch.  This module provides the equivalents:

  * ``Context``            <-> Context{plat, device} (platform.h:757-816)
  * ``create_cpu_context`` / ``create_gpu_context``
  * ``make_sure``          <-> makeSure (copy a tensor to another context,
                                blas.h:813-845)
  * ``Request`` / ``wait`` <-> Request/wait (dist.h:54-61): XLA dispatch
    is asynchronous the same way the reference's streams are — every op
    returns immediately and ``wait`` blocks on completion.
  * stream fork/join (anabranch, blas.h:928-960) needs no user-visible
    equivalent: XLA schedules independent subgraphs concurrently; the
    ``concurrent`` context manager exists for API parity and profiling
    annotation only.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Optional

import jax

from . import cplx

__all__ = ["Context", "create_cpu_context", "create_gpu_context",
           "create_context", "make_sure", "Request", "wait", "concurrent"]


@dataclass(frozen=True)
class Context:
    """A compute placement handle (public Context, platform.h:757-780)."""

    platform: str
    device_index: int = 0

    @property
    def device(self):
        devs = [d for d in jax.devices(self.platform)]
        return devs[self.device_index]


def create_cpu_context() -> Context:
    return Context("cpu", 0)


def create_gpu_context(device: int = 0) -> Context:
    """GPU context (createGpuContext, platform.h:783-816)."""
    if not any(d.platform == "gpu" for d in jax.devices()):
        raise RuntimeError("no GPU platform available")
    return Context("gpu", device)


def create_context(device: int = 0) -> Context:
    """The GPU when there is one, else the default platform."""
    try:
        return create_gpu_context(device)
    except RuntimeError:
        return Context(jax.devices()[0].platform, device)


def make_sure(x, ctx: Context):
    """Return ``x`` resident on ``ctx`` (makeSure, blas.h:813-845)."""
    if cplx.is_carray(x):
        return cplx.cmap(lambda a: jax.device_put(a, ctx.device), x)
    return jax.device_put(x, ctx.device)


Request = Any  # any pytree of jax arrays doubles as an async handle


def wait(request: Request) -> Request:
    """Block until an async result is complete (wait, dist.h:56-61).

    Every superbblas_tpu op returns immediately with async arrays; pass
    the result (or any pytree containing it) here to synchronize.
    """
    return jax.block_until_ready(request)


@contextmanager
def concurrent(name: str = "concurrent"):
    """Fork/join scope for API parity with anabranch_begin/end
    (blas.h:928-960).  XLA already overlaps independent subgraphs; this
    adds a profiler annotation around the region."""
    with jax.profiler.TraceAnnotation(name):
        yield
