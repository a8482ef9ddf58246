"""Label-driven tensor contraction lowered to dot_general.

Functional re-design of the reference's contraction engine
(``include/superbblas/tensor.h:1271-1637`` in eromero-vlc/superbblas).  The
reference classifies labels into T (batch) / A (contracted) / B / C groups,
physically *reorders* both operands into a T-leading layout, and calls a
strided batched GEMM.  Here none of that reordering is needed: we hand
``lax.dot_general`` the label classification directly as
``dimension_numbers`` and let XLA fuse any layout changes into the matmul
epilogue — the planner emits index mappings, not copies.

Semantics (tensor.h:1459-1637 public contract):

    r = alpha * contraction(op0(x0), op1(x1)) + beta * r

where opN is optional element-wise conjugation, and labels are grouped as
  T: in x0, x1, r (batch) | A: x0&x1 (contracted) | B: x0&r | C: x1&r.
Every label must fall in a group ("unmatched dimensions" otherwise).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import cplx
from ..labels import ContractionPlan
from .copy import _is_static, local_permute


def _accum_type(dt):
    """Accumulation dtype: f32 for f32/bf16, else the input."""
    if dt in (jnp.bfloat16.dtype, jnp.float16.dtype, jnp.float32.dtype):
        return jnp.float32
    return dt


from ..utils.tracker import tracked as _tracked


@_tracked("local_contraction")
def local_contraction(
    alpha,
    x0: jax.Array,
    o0: str,
    conj0: bool,
    x1: jax.Array,
    o1: str,
    conj1: bool,
    beta,
    r: Optional[jax.Array],
    o_r: str,
    dimr: Optional[tuple] = None,
    dtype=None,
    precision=None,
) -> jax.Array:
    """Contract two labeled tensors; returns alpha * x0·x1 + beta * r.

    ``r`` may be None when beta == 0; then ``dimr``/``dtype`` give the output
    spec (defaulting to the deduced extents and the promoted input dtype).

    Operands may be split-complex ``cplx.CArray``s (the split complex
    representation); the contraction then runs as 3 real dot_generals
    (Gauss trick) instead of the 4 XLA's own complex lowering uses.
    """
    if r is not None:
        dimr = tuple(r.shape)
        dtype = r.dtype
    else:
        if not (_is_static(beta) and beta == 0):
            raise ValueError("contraction: r must be given unless beta == 0")
        if dimr is None:
            d = {**dict(zip(o0, x0.shape)), **dict(zip(o1, x1.shape))}
            dimr = tuple(d[c] for c in o_r)
        if dtype is None:
            dtype = jnp.promote_types(x0.dtype, x1.dtype)

    plan = ContractionPlan(o0, tuple(x0.shape), o1, tuple(x1.shape), o_r, dimr)

    if conj0 and (cplx.is_carray(x0) or jnp.iscomplexobj(x0)):
        x0 = cplx.conj(x0)
    if conj1 and (cplx.is_carray(x1) or jnp.iscomplexobj(x1)):
        x1 = cplx.conj(x1)

    out = cplx.cdot_general(
        x0,
        x1,
        dimension_numbers=plan.dot_general_dims(),
        preferred_element_type=_accum_type(jnp.promote_types(x0.dtype, x1.dtype)),
        precision=precision,
    )
    out = local_permute(out, plan.dot_general_out_order(), o_r)

    if not (_is_static(alpha) and alpha == 1):
        out = cplx.scale(alpha, out)
    out = out.astype(dtype)
    if r is not None and not (_is_static(beta) and beta == 0):
        if _is_static(beta) and beta == 1:
            out = cplx.add(out, r)
        else:
            out = cplx.add(out, cplx.scale(beta, r))
    return out
