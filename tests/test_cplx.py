"""Split-complex (cplx.CArray) unit tests: the split-complex layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from superbblas_tpu import cplx, local_contraction, local_copy, local_permute


def crand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def as_np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def test_roundtrip():
    x = crand((3, 4))
    c = cplx.from_complex(x)
    np.testing.assert_allclose(as_np(c), x)
    np.testing.assert_allclose(np.asarray(cplx.to_complex(c)), x)


def test_scale_complex_alpha():
    x = crand((3, 4), 1)
    c = cplx.from_complex(x)
    a = 1.5 - 2.5j
    np.testing.assert_allclose(as_np(cplx.scale(a, c)), a * x, rtol=1e-12)


def test_karatsuba_dot_general_matches_numpy():
    a = crand((4, 5), 2)
    b = crand((5, 6), 3)
    got = cplx.cdot_general(
        cplx.from_complex(a), cplx.from_complex(b),
        dimension_numbers=(((1,), (0,)), ((), ())),
    )
    np.testing.assert_allclose(as_np(got), a @ b, rtol=1e-12)


def test_mixed_real_complex_dot():
    a = np.random.default_rng(4).standard_normal((4, 5))
    b = crand((5, 6), 5)
    got = cplx.cdot_general(
        jnp.asarray(a), cplx.from_complex(b),
        dimension_numbers=(((1,), (0,)), ((), ())),
    )
    np.testing.assert_allclose(as_np(got), a @ b, rtol=1e-12)


def test_local_contraction_carray_matches_complex():
    a = crand((3, 4, 5), 6)
    b = crand((3, 5, 6), 7)
    want = np.einsum("tab,tbc->tac", a.conj(), b) * (2 - 1j)
    got = local_contraction(2 - 1j, cplx.from_complex(a), "tab", True,
                            cplx.from_complex(b), "tbc", False,
                            0.0, None, "tac")
    assert cplx.is_carray(got)
    np.testing.assert_allclose(as_np(got), want, rtol=1e-12)


def test_local_contraction_carray_with_beta():
    a = crand((4, 5), 8)
    b = crand((5, 6), 9)
    r = crand((4, 6), 10)
    want = 0.5 * (a @ b) + (1 + 1j) * r
    got = local_contraction(0.5, cplx.from_complex(a), "ab", False,
                            cplx.from_complex(b), "bc", False,
                            1 + 1j, cplx.from_complex(r), "ac")
    np.testing.assert_allclose(as_np(got), want, rtol=1e-12)


def test_local_copy_carray():
    x = crand((6, 8), 11)
    y = crand((8, 10), 12)
    alpha = 0.5 + 2j
    got = local_copy(alpha, cplx.from_complex(x), "ab",
                     cplx.from_complex(y), "ba",
                     from0=(1, 2), size0=(4, 5), from1=(2, 3), copy_add="add")
    want = np.array(y)
    want[2:7, 3:7] += alpha * x[1:5, 2:7].T
    np.testing.assert_allclose(as_np(got), want, rtol=1e-12)


def test_local_permute_carray():
    x = crand((3, 4), 13)
    got = local_permute(cplx.from_complex(x), "ab", "ba")
    np.testing.assert_allclose(as_np(got), x.T)


def test_carray_through_jit():
    x = cplx.from_complex(crand((4, 4), 14))

    @jax.jit
    def f(c):
        return cplx.scale(2.0, c)

    out = f(x)
    np.testing.assert_allclose(as_np(out), 2 * as_np(x))


def test_inner_real():
    a = crand((5,), 15)
    b = crand((5,), 16)
    got = float(cplx.inner_real(cplx.from_complex(a), cplx.from_complex(b)))
    np.testing.assert_allclose(got, np.vdot(a, b).real, rtol=1e-12)
