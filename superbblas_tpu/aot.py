"""Ahead-of-time compilation and executable export.

The reference ships a template-instantiation build system (L8:
superbblas_lib.h + src/tools/ctemplate + src/Makefile:42-100) that
pre-compiles every (operation x dtype) instantiation into a library so
consumers avoid recompilation.  The JAX equivalent of "template
pre-instantiation" is ahead-of-time XLA compilation: lower a jitted
function at concrete shapes/dtypes, serialize the StableHLO artifact, and
reload it later without tracing or compiling.

    exe = aot_compile(fn, example_args)        # compiled executable
    path = export_compiled(fn, example_args, "op.bin")
    fn2 = load_exported("op.bin")              # callable, no retrace
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import jax
from jax import export as jax_export

__all__ = ["aot_compile", "export_compiled", "load_exported"]


def aot_compile(fn: Callable, example_args: Sequence[Any]):
    """Lower + compile ``fn`` at the example arguments' shapes/dtypes.

    Returns the compiled executable (callable with matching arguments).
    """
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*example_args).compile()


def export_compiled(fn: Callable, example_args: Sequence[Any], path: str,
                    platforms: Sequence[str] = None) -> str:
    """Serialize the lowered function as a portable StableHLO artifact."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    shapes = jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), tuple(example_args)
    )
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    exported = jax_export.export(jitted, **kwargs)(*shapes)
    blob = exported.serialize()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    return path


def load_exported(path: str) -> Callable:
    """Reload a serialized artifact as a callable (no tracing)."""
    with open(path, "rb") as f:
        blob = f.read()
    exported = jax_export.deserialize(bytearray(blob))
    return exported.call
