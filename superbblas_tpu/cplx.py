"""Split-complex arrays: complex tensor algebra on real arithmetic.

XLA lowers complex dot_generals to four real ones.  The reference
library leans on vendor BLAS complex GEMMs (blas.h:662-812); the
equivalent here is an explicit split representation:

    CArray(re, im)   — a pytree of two same-shaped real arrays.

All superbblas_tpu ops (copy/contraction/BSR/dense) accept CArray
wherever they accept a jax.Array.  Contractions use the 3-multiplication
Karatsuba/Gauss decomposition

    (a+ib)(c+id): k1 = a(c+d), k2 = d(a+b), k3 = c(b-a)
                  re = k1 - k2, im = k1 + k3

cutting the multiplies 25% below XLA's own complex lowering.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "CArray", "asarray", "from_complex", "to_complex", "is_carray",
    "cmap", "conj", "scale", "add", "cbilinear", "cdot_general", "cmatmul",
    "inner_real",
]


class CArray(NamedTuple):
    """Complex tensor as (real, imaginary) parts.  A NamedTuple, hence a
    jax pytree: passes through jit/shard_map/scan transparently."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def dtype(self):
        return self.re.dtype

    @property
    def size(self):
        return self.re.size

    def astype(self, dt):
        return CArray(self.re.astype(dt), self.im.astype(dt))

    def __add__(self, other):
        return add(self, other)

    def __sub__(self, other):
        return add(self, scale(-1.0, other))

    def __mul__(self, other):
        return scale(other, self) if not isinstance(other, CArray) else _mul(self, other)

    def __rmul__(self, other):
        return scale(other, self)


# Allow CArray pytrees through jax.export (the AOT layer serializes
# lowered functions whose signatures carry CArrays)
try:
    jax.export.register_namedtuple_serialization(
        CArray, serialized_name="superbblas_tpu.cplx.CArray")
except (AttributeError, ValueError):
    pass


def is_carray(x) -> bool:
    return isinstance(x, CArray)


def from_complex(x) -> CArray:
    """Split a complex (numpy or jax) array; real inputs get zero imag."""
    if isinstance(x, CArray):
        return x
    if isinstance(x, np.ndarray) and np.iscomplexobj(x):
        rdt = np.float32 if x.dtype == np.complex64 else np.float64
        return CArray(jnp.asarray(x.real.astype(rdt)), jnp.asarray(x.imag.astype(rdt)))
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return CArray(jnp.real(x), jnp.imag(x))
    return CArray(x, jnp.zeros_like(x))


def asarray(x) -> Union[jax.Array, CArray]:
    """CArray for complex inputs, plain array otherwise."""
    if isinstance(x, CArray):
        return x
    if (isinstance(x, np.ndarray) and np.iscomplexobj(x)) or (
        hasattr(x, "dtype") and jnp.iscomplexobj(x)
    ):
        return from_complex(x)
    return jnp.asarray(x)


def to_complex(c) -> jax.Array:
    """Merge back to a complex jax array (host/CPU use only on backends
    without complex support)."""
    if not isinstance(c, CArray):
        return c
    cdt = jnp.complex64 if c.re.dtype == jnp.float32 else jnp.complex128
    return c.re.astype(cdt) + 1j * c.im.astype(cdt)


def cmap(f, *cs):
    """Apply a structural (linear, part-wise) function to both parts."""
    cs2 = [c if isinstance(c, CArray) else CArray(c, jnp.zeros_like(c)) for c in cs]
    return CArray(f(*[c.re for c in cs2]), f(*[c.im for c in cs2]))


def conj(c):
    if isinstance(c, CArray):
        return CArray(c.re, -c.im)
    return jnp.conj(c)


def _split_scalar(alpha):
    if isinstance(alpha, CArray):
        return alpha.re, alpha.im
    if isinstance(alpha, (complex, np.complexfloating)) or (
        hasattr(alpha, "dtype") and jnp.iscomplexobj(alpha)
    ):
        return jnp.real(alpha) if hasattr(alpha, "dtype") else alpha.real, \
               jnp.imag(alpha) if hasattr(alpha, "dtype") else alpha.imag
    return alpha, None


def scale(alpha, c):
    """alpha * c with real or complex alpha."""
    if not isinstance(c, CArray):
        if isinstance(alpha, CArray):
            return CArray(alpha.re * c, alpha.im * c)
        return alpha * c
    ar, ai = _split_scalar(alpha)
    if ai is None or (isinstance(ai, (int, float)) and ai == 0):
        return CArray(ar * c.re, ar * c.im)
    return CArray(ar * c.re - ai * c.im, ar * c.im + ai * c.re)


def add(a, b):
    if not isinstance(a, CArray) and not isinstance(b, CArray):
        return a + b
    a = a if isinstance(a, CArray) else CArray(a, jnp.zeros_like(a))
    b = b if isinstance(b, CArray) else CArray(b, jnp.zeros_like(b))
    return CArray(a.re + b.re, a.im + b.im)


def _mul(a: CArray, b: CArray) -> CArray:
    return CArray(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)


def cbilinear(f, a, b):
    """Lift a real bilinear kernel f(x, y) to split-complex operands via
    the 3-multiplication Gauss/Karatsuba scheme."""
    if not isinstance(a, CArray) and not isinstance(b, CArray):
        return f(a, b)
    if isinstance(a, CArray) and not isinstance(b, CArray):
        return CArray(f(a.re, b), f(a.im, b))
    if not isinstance(a, CArray) and isinstance(b, CArray):
        return CArray(f(a, b.re), f(a, b.im))
    k1 = f(a.re, b.re + b.im)
    k2 = f(a.re + a.im, b.im)
    k3 = f(a.im - a.re, b.re)
    out_dt = k1.dtype
    return CArray((k1 - k2).astype(out_dt), (k1 + k3).astype(out_dt))


def default_precision():
    """lax.Precision from SBT_MATMUL_PRECISION (see flags.py: "highest"
    by default so f32 contractions match the reference's true-fp32
    semantics instead of TF32 rounding on the GPU)."""
    from . import flags

    return {
        "default": jax.lax.Precision.DEFAULT,
        "high": jax.lax.Precision.HIGH,
        "highest": jax.lax.Precision.HIGHEST,
    }[flags.get_matmul_precision()]


def cdot_general(a, b, dimension_numbers, preferred_element_type=None,
                 precision=None):
    """dot_general over split-complex operands via 3 real dot_generals
    (Gauss/Karatsuba).  Falls back to plain dot_general when both operands
    are real arrays."""
    if precision is None:
        precision = default_precision()

    def dg(x, y):
        return jax.lax.dot_general(
            x, y, dimension_numbers,
            preferred_element_type=preferred_element_type,
            precision=precision)

    return cbilinear(dg, a, b)


def cmatmul(a, b, preferred_element_type=None):
    nd_a = a.ndim
    dims = (((nd_a - 1,), (max(b.ndim - 2, 0),)), ((), ()))
    return cdot_general(a, b, dims, preferred_element_type)


def inner_real(a, b):
    """Re <a, b> = sum(a.re*b.re + a.im*b.im) (works for plain arrays too)."""
    if isinstance(a, CArray) or isinstance(b, CArray):
        a = a if isinstance(a, CArray) else CArray(a, jnp.zeros_like(a))
        b = b if isinstance(b, CArray) else CArray(b, jnp.zeros_like(b))
        return jnp.sum(a.re * b.re) + jnp.sum(a.im * b.im)
    return jnp.sum(a * b)
