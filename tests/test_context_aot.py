"""Context/async layer and AOT export tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from superbblas_tpu import aot, context
from superbblas_tpu import local_contraction


def test_context_and_make_sure():
    ctx = context.create_cpu_context()
    x = context.make_sure(jnp.ones((2, 2)), ctx)
    assert x.devices() == {ctx.device}


def test_wait_returns_value():
    y = jnp.ones((4,)) * 3
    out = context.wait(y)
    np.testing.assert_array_equal(np.asarray(out), 3 * np.ones(4))


def test_concurrent_scope_runs():
    with context.concurrent("fork"):
        a = jnp.ones((4,)).sum()
    assert float(a) == 4.0


def test_aot_compile_and_export(tmp_path):
    def f(a, b):
        return local_contraction(1.0, a, "ij", False, b, "jk", False,
                                 0.0, None, "ik")

    a = jnp.ones((4, 5))
    b = jnp.ones((5, 6))
    exe = aot.aot_compile(f, (a, b))
    np.testing.assert_allclose(np.asarray(exe(a, b)), np.asarray(f(a, b)))

    p = str(tmp_path / "op.bin")
    aot.export_compiled(f, (a, b), p)
    g = aot.load_exported(p)
    np.testing.assert_allclose(np.asarray(g(a, b)), np.asarray(f(a, b)))


def test_aot_export_carray_step(tmp_path):
    """CArray-signature functions (the flagship step) export/reload
    through jax.export (here the CPU reference path)."""
    import numpy as np

    from superbblas_tpu import cplx
    from superbblas_tpu.models import apply_wilson, wilson_operator

    lat = (4, 4, 2, 2)
    op = wilson_operator(lat, mass=0.1, key=0, dtype=jnp.complex128)
    rng = np.random.default_rng(0)
    x = cplx.CArray(jnp.asarray(rng.standard_normal(lat + (4, 3, 2))),
                    jnp.asarray(rng.standard_normal(lat + (4, 3, 2))))
    fn = lambda v: apply_wilson(op, v)
    want = fn(x)
    path = str(tmp_path / "step.bin")
    aot.export_compiled(fn, (x,), path)
    got = aot.load_exported(path)(x)
    np.testing.assert_allclose(np.asarray(got.re), np.asarray(want.re),
                               atol=1e-12)
