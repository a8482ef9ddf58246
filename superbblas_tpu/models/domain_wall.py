"""Domain-wall fermions: a 5D stencil through the N-D BSR engine.

Shamir domain-wall fermions extend the Wilson operator with a fifth
dimension of extent Ls whose chiral-projector couplings have special
walls (the physical quark mass enters only through the boundary links):

    (D_dw psi)_{s} = (5 - M5) psi_s + D_W-hopping psi_s
                     - P_- psi_{s+1} - P_+ psi_{s-1}

with P_+- = (1 +- gamma5)/2 and the s5 wrap links scaled by -m_f.

Structurally this is exactly the engine's general stencil case: a 5D
toroidal lattice whose s5-direction blocks are SITE-DEPENDENT (the wall
links differ), so the operator is built as a plain (non-Kronecker)
stencil with full 12x12 spin(x)color blocks — the reference's generic
create_bsr regime (bsr.h:2287) at nlat = 5 (the engine's lattice rank is
arbitrary; only the Pallas SoA fast path is 4D-specific, so DWF runs the
AoS path).

The defining symmetry Gamma5 R5 D R5 Gamma5 = D^H (R5 reflects
s -> Ls-1-s) is the test oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import cplx
from ..bsr import BSROperator, bsr_from_stencil, bsr_krylov
from .wilson import NC, NS, gamma_matrices, random_su3_links

__all__ = ["domain_wall_operator", "apply_domain_wall",
           "mobius_operator", "DomainWallSoAOperator"]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class DomainWallSoAOperator:
    """Domain-wall operator in the SoA hot layout.

    The 4D hopping part is s5-INDEPENDENT (links broadcast over s), so
    folding Ls into the Pallas kernel's column axis runs it at the
    Wilson-kernel rate; the s5 chiral-projector couplings are a pure
    elementwise term.  In the engine's (chiral, DeGrand-Rossi) gamma
    basis g5 = diag(1,1,-1,-1), so P+- are 0/1 DIAGONAL and the s5 spin
    contraction collapses to per-channel weights — one fused elementwise
    multiply-add with mass walls.  Reference analog: the same
    decomposition consumers drive through two create_bsr handles
    (bsr.h:2287) — here one SoA stencil + an elementwise term.

    ``apply_domain_wall`` takes x as a CArray [ncols, Ls, 12, X, Y, Z, T].
    """

    wilson: BSROperator          # 4D SoA stencil (Shamir: mass = 1 - M5;
    Ls: int                      # Moebius: bare mass = -M5)
    m_f: float
    pp_diag: jax.Array           # [NS*NC] per-channel diag(P+) weights
    pm_diag: jax.Array
    #: Moebius coefficients (Brower-Neff-Orginos).  ``mobius=False`` is
    #: the legacy Shamir apply (b5=1, c5=0 with the +1 folded into the
    #: Wilson diagonal); ``mobius=True`` evaluates
    #:   D_M psi = D_W(b5 psi + c5 H psi) + psi - H psi,
    #: H psi|_s = P_- psi_{s+1} + P_+ psi_{s-1} (walls x -m_f) —
    #: ONE Wilson kernel call regardless of (b5, c5), so Moebius runs at
    #: Shamir cost on the hot path.
    b5: float = 1.0
    c5: float = 0.0
    mobius: bool = False
    #: which side the chiral projectors act from in the (c5 D_W - 1)
    #: Lambda term.  The two orderings are gamma5-R5 ADJOINT PARTNERS:
    #: D_right^H = (Gamma5 R5) D_left (Gamma5 R5) — neither is
    #: gamma5-R5-hermitian by itself for c5 != 0 (the D_W Lambda
    #: cross-term does not commute through P_-+), which is why
    #: production codes implement Mdag explicitly.
    projector_side: str = "right"

    # pytree protocol, like BSROperator: jit/device_put/tree_map work
    def tree_flatten(self):
        return (self.wilson, self.pp_diag, self.pm_diag), (
            self.Ls, self.m_f, self.b5, self.c5, self.mobius,
            self.projector_side)

    @classmethod
    def tree_unflatten(cls, aux, children):
        wilson, pp, pm = children
        Ls, m_f, b5, c5, mobius, side = aux
        return cls(wilson=wilson, Ls=Ls, m_f=m_f, pp_diag=pp, pm_diag=pm,
                   b5=b5, c5=c5, mobius=mobius, projector_side=side)

    @property
    def dim_d(self):
        return (self.Ls,) + tuple(self.wilson.dim_d)

    def flops_per_matvec(self, ncols: int, complex_dtype: bool = True) -> int:
        f = self.wilson.flops_per_matvec(ncols * self.Ls, complex_dtype)
        mul = 8 if complex_dtype else 2
        from ..labels import volume as _vol
        v4 = _vol(self.wilson.dim_d)
        # two projector applications: [NS, NS] x [NS] per (site, color, col)
        f += 2 * mul * v4 * self.Ls * NC * NS * NS * ncols
        if self.mobius:
            # the ALGORITHMIC extras of the one-kernel Moebius identity
            # (field combine b5 x + c5 Hx, then + x - Hx): ~10 real
            # flops per split-complex field element.  Deliberately NOT
            # the 27-offset dense-stencil equivalent — benchmarks must
            # never overstate TF/s (the test_regressions SoA-ndir
            # convention).
            f += 10 * v4 * self.Ls * NC * NS * ncols
        return f


def _chiral_proj_diag(P: np.ndarray, part_dt) -> jax.Array:
    """Per-channel weights of a DIAGONAL real chiral projector — the SoA
    fast path's requirement (g5 diagonal in the engine's DeGrand-Rossi
    basis); shared by the Shamir and Moebius builders."""
    if not (np.allclose(P, np.diag(np.diag(P)))
            and np.allclose(np.imag(P), 0)):
        raise NotImplementedError(
            "SoA domain-wall requires a gamma basis with diagonal real "
            "chiral projectors (g5 diagonal)")
    return jnp.asarray(np.repeat(np.diag(P).real, NC).astype(part_dt))


def _wilson_hop_blocks(links: np.ndarray, r: float, g) -> list:
    """Per-direction 4D Wilson hopping blocks [((sign, mu),
    [*lat, 12, 12])...] — one construction shared by every 5D builder
    (the sign/roll convention lives in exactly one place)."""
    lat_dims = links.shape[1:-2]
    out = []
    for mu in range(4):
        sp = -0.5 * (r * np.eye(NS) - g[mu])
        out.append(((1, mu), np.einsum(
            "st,...cd->...sctd", sp,
            links[mu]).reshape(tuple(lat_dims) + (12, 12))))
        sp = -0.5 * (r * np.eye(NS) + g[mu])
        shifted = np.roll(links[mu], 1, axis=mu)
        out.append(((-1, mu), np.einsum(
            "st,...cd->...sctd", sp,
            np.swapaxes(shifted, -1, -2).conj()
        ).reshape(tuple(lat_dims) + (12, 12))))
    return out


def domain_wall_operator(
    lat_dims: Tuple[int, ...],
    Ls: int = 8,
    M5: float = 1.8,
    m_f: float = 0.05,
    r: float = 1.0,
    key=None,
    dtype=jnp.complex128,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
):
    """Build D_dw on the 5D lattice (s5, x, y, z, t); labels "sxyztSc" /
    "sxyztSC" with the (S, c) pair as one dense 12x12 block.

    ``layout="soa"`` returns a :class:`DomainWallSoAOperator`: the 4D
    hopping runs the Pallas Wilson kernel with Ls folded into the column
    axis (same SoA-eligibility rules as Wilson), the s5 term runs as an
    elementwise projector apply.
    """
    nd = len(lat_dims)
    if nd != 4:
        raise ValueError("domain-wall fermions extend a 4D lattice")
    from .wilson import _seed_from_key

    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)

    if layout == "soa":
        from .wilson import wilson_operator

        g = gamma_matrices()
        g5 = g[0] @ g[1] @ g[2] @ g[3]
        Pp = (np.eye(NS) + g5) / 2.0
        Pm = (np.eye(NS) - g5) / 2.0
        part_dt = np.float32 if dtype == jnp.complex64 else np.float64
        w = wilson_operator(lat_dims, mass=1.0 - M5, r=r, dtype=dtype,
                            links=links, layout="soa")
        return DomainWallSoAOperator(wilson=w, Ls=Ls, m_f=float(m_f),
                                     pp_diag=_chiral_proj_diag(Pp, part_dt),
                                     pm_diag=_chiral_proj_diag(Pm, part_dt))
    g = gamma_matrices()
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    Pp = (np.eye(NS) + g5) / 2.0
    Pm = (np.eye(NS) - g5) / 2.0
    eyeC = np.eye(NC)

    def kron_sc(spin, color):
        return np.kron(spin, color)

    lat5 = (Ls,) + tuple(lat_dims)
    offsets = [(0, 0, 0, 0, 0)]
    blocks = [np.broadcast_to(kron_sc((4.0 * r + 1.0 - M5) * np.eye(NS),
                                      eyeC), lat5 + (12, 12)).copy()]
    # 4D Wilson hopping (s5-independent; links broadcast over s5)
    for (s4, mu), blk in _wilson_hop_blocks(links, r, g):
        off = [0] * 5
        off[1 + mu] = s4
        offsets.append(tuple(off))
        blocks.append(np.broadcast_to(blk, lat5 + (12, 12)).copy())
    # s5 hopping with mass walls
    bp = np.broadcast_to(kron_sc(-Pm, eyeC), lat5 + (12, 12)).copy()
    bp[Ls - 1] = kron_sc(m_f * Pm, eyeC)          # wrap s=Ls-1 -> 0
    offsets.append((1, 0, 0, 0, 0))
    blocks.append(bp)
    bm = np.broadcast_to(kron_sc(-Pp, eyeC), lat5 + (12, 12)).copy()
    bm[0] = kron_sc(m_f * Pp, eyeC)               # wrap s=0 -> Ls-1
    offsets.append((-1, 0, 0, 0, 0))
    blocks.append(bm)

    part_dt = np.float32 if dtype == jnp.complex64 else np.float64
    vals = np.stack(blocks, axis=5)
    return bsr_from_stencil(
        "sxyztSc", "sxyztSC",
        lat5, {"S": NS, "c": NC}, {"S": NS, "C": NC},
        offsets,
        cplx.CArray(vals.real.astype(part_dt),
                    vals.imag.astype(part_dt)),
    )


def mobius_operator(
    lat_dims: Tuple[int, ...],
    Ls: int = 8,
    M5: float = 1.8,
    m_f: float = 0.05,
    b5: float = 1.5,
    c5: float = 0.5,
    r: float = 1.0,
    key=None,
    dtype=jnp.complex128,
    links: Optional[np.ndarray] = None,
    layout: str = "aos",
    projector_side: str = "right",
):
    """Moebius domain-wall fermions (Brower-Neff-Orginos):

        D_M = (b5 D_W + 1) delta_{ss'} + (c5 D_W - 1) Lambda_{ss'},

    where D_W carries bare mass -M5 and ``Lambda psi|_s = P_- psi_{s+1}
    + P_+ psi_{s-1}`` with the s-wrap scaled by -m_f.  Shamir is the
    b5=1, c5=0 special case; b5 - c5 = 1 with b5 + c5 = alpha gives the
    scaled-Shamir kernels production codes run.

    ``projector_side``: "right" applies (c5 D_W - 1) AFTER the
    projection (the form above); "left" builds
    Lambda (c5 D_W - 1).  They are gamma5-R5 adjoint partners:
    D_right^H = (Gamma5 R5) D_left (Gamma5 R5) — build the other side
    to apply the dagger (tested identity; neither ordering is
    gamma5-R5-hermitian by itself for c5 != 0).

    ``layout="soa"``: the identity D_M psi = D_W(b5 psi + c5 Lambda psi)
    + psi - Lambda psi (right) / D_M psi = b5 u + psi + Lambda(c5 u -
    psi) with u = D_W psi (left) needs ONE Pallas Wilson-kernel call
    plus elementwise (diagonal-projector) terms — Moebius at Shamir
    cost.  ``layout="aos"``: the generic 5D stencil with 27 offsets
    (diagonal, 8 spatial, 2 axial, 16 CORNER (s +-1, mu +-1) couplings
    from c5 D_W Lambda) — the engine's arbitrary-offset regime
    (reference generic create_bsr handle, bsr.h:2287; no domain-wall
    exists in the reference itself).
    """
    if projector_side not in ("right", "left"):
        raise ValueError("projector_side must be 'right' or 'left'")
    nd = len(lat_dims)
    if nd != 4:
        raise ValueError("domain-wall fermions extend a 4D lattice")
    from .wilson import _seed_from_key

    rng = np.random.default_rng(_seed_from_key(key))
    if links is None:
        links = random_su3_links(rng, lat_dims)

    g = gamma_matrices()
    g5 = g[0] @ g[1] @ g[2] @ g[3]
    Pp = (np.eye(NS) + g5) / 2.0
    Pm = (np.eye(NS) - g5) / 2.0
    eyeC = np.eye(NC)
    part_dt = np.float32 if dtype == jnp.complex64 else np.float64

    if layout == "soa":
        from .wilson import wilson_operator

        w = wilson_operator(lat_dims, mass=-M5, r=r, dtype=dtype,
                            links=links, layout="soa")
        return DomainWallSoAOperator(wilson=w, Ls=Ls, m_f=float(m_f),
                                     pp_diag=_chiral_proj_diag(Pp, part_dt),
                                     pm_diag=_chiral_proj_diag(Pm, part_dt),
                                     b5=float(b5), c5=float(c5),
                                     mobius=True,
                                     projector_side=projector_side)

    # --- generic 5D AoS stencil, 27 offsets -----------------------------
    lat5 = (Ls,) + tuple(lat_dims)
    diag_w = 4.0 * r - M5                       # D_W diagonal (bare -M5)

    hops = _wilson_hop_blocks(links, r, g)
    PmC = np.kron(Pm, eyeC)
    PpC = np.kron(Pp, eyeC)
    # axial wall factors: +1 in the bulk, -m_f across the s wrap
    lam_p = np.ones(Ls)
    lam_p[Ls - 1] = -m_f
    lam_m = np.ones(Ls)
    lam_m[0] = -m_f

    offsets = [(0, 0, 0, 0, 0)]
    blocks = [np.broadcast_to((b5 * diag_w + 1.0) * np.eye(12),
                              lat5 + (12, 12)).copy()]
    for (s4, mu), blk in hops:                  # spatial: b5 * hop
        off = [0] * 5
        off[1 + mu] = s4
        offsets.append(tuple(off))
        blocks.append(np.broadcast_to(b5 * blk, lat5 + (12, 12)).copy())
    # axial: (c5 * diag_w - 1) * lambda_s * P -+
    for soff, lam, PC in ((1, lam_p, PmC), (-1, lam_m, PpC)):
        offsets.append((soff, 0, 0, 0, 0))
        blocks.append(np.einsum(
            "s,ij->sij", lam * (c5 * diag_w - 1.0),
            PC)[:, None, None, None, None].repeat(
                lat_dims[0], 1).repeat(lat_dims[1], 2).repeat(
                lat_dims[2], 3).repeat(lat_dims[3], 4))
    # corners: c5 * lambda_s * (hop_mu @ P) for "right" (project, then
    # hop) vs (P @ hop_mu) for "left" (hop, then project); all zero at
    # c5 == 0 (Shamir) — skip the 16 offsets entirely
    for soff, lam, PC in (() if c5 == 0 else
                          ((1, lam_p, PmC), (-1, lam_m, PpC))):
        for (s4, mu), blk in hops:
            off = [0] * 5
            off[0] = soff
            off[1 + mu] = s4
            offsets.append(tuple(off))
            if projector_side == "right":
                corner = c5 * np.einsum("...ij,jk->...ik", blk, PC)
            else:
                corner = c5 * np.einsum("ij,...jk->...ik", PC, blk)
            blocks.append(np.einsum(
                "s,...ij->s...ij", lam, corner))
    vals = np.stack([np.broadcast_to(b, lat5 + (12, 12))
                     for b in blocks], axis=5)
    return bsr_from_stencil(
        "sxyztSc", "sxyztSC",
        lat5, {"S": NS, "c": NC}, {"S": NS, "C": NC},
        offsets,
        cplx.CArray(vals.real.astype(part_dt),
                    vals.imag.astype(part_dt)),
    )


def apply_domain_wall(op, x):
    """y = D_dw x.

    AoS operators (BSROperator): x [Ls, *lat, NS, NC, ncols] (CArray or
    complex) — one bsr_krylov application (bsr.h:2353) at lattice rank 5.
    SoA operators (DomainWallSoAOperator): x CArray
    [ncols, Ls, 12, X, Y, Z, T] — the hopping runs the Pallas Wilson
    kernel with s folded into columns; the s5 projector term is
    elementwise with mass walls at the s wrap.
    """
    if isinstance(op, DomainWallSoAOperator):
        from ..bsr import apply_stencil_soa

        n, Ls = x.re.shape[0], op.Ls
        assert Ls == x.re.shape[1]
        rest = x.re.shape[2:]

        if op.mobius:
            # D_M psi = D_W(b5 psi + c5 H psi) + psi - H psi with
            # H psi|_s = P_- psi_{s+1} + P_+ psi_{s-1} (walls x -m_f):
            # ONE kernel call for any (b5, c5)
            lat = rest[1:]
            s_idx = jnp.arange(Ls)
            shape_c = (1, Ls, 1) + (1,) * len(lat)
            hp = jnp.where(s_idx == Ls - 1, -op.m_f, 1.0).reshape(shape_c)
            hm = jnp.where(s_idx == 0, -op.m_f, 1.0).reshape(shape_c)
            shape_f = (1, 1, rest[0]) + (1,) * len(lat)
            wp = op.pm_diag.reshape(shape_f)
            wm = op.pp_diag.reshape(shape_f)

            def H(a):
                return ((hp * wp) * jnp.roll(a, -1, axis=1)
                        + (hm * wm) * jnp.roll(a, 1, axis=1))

            def W5(v):
                yf = apply_stencil_soa(
                    op.wilson,
                    cplx.cmap(lambda a: a.reshape((n * Ls,) + rest), v))
                return cplx.cmap(lambda a: a.reshape((n, Ls) + rest), yf)

            if op.projector_side == "right":
                Hx = cplx.cmap(H, x)
                y = W5(cplx.CArray(op.b5 * x.re + op.c5 * Hx.re,
                                   op.b5 * x.im + op.c5 * Hx.im))
                return cplx.CArray(y.re + x.re - Hx.re,
                                   y.im + x.im - Hx.im)
            u = W5(x)      # left: D_M x = b5 u + x + H(c5 u - x)
            tr, ti = op.c5 * u.re - x.re, op.c5 * u.im - x.im
            return cplx.CArray(op.b5 * u.re + x.re + H(tr),
                               op.b5 * u.im + x.im + H(ti))

        xf = cplx.cmap(lambda a: a.reshape((n * Ls,) + rest), x)
        y = apply_stencil_soa(op.wilson, xf)
        y = cplx.cmap(lambda a: a.reshape((n, Ls) + rest), y)

        # s5 term: y_s += c^+_s (Pm x_{s+1}) + c^-_s (Pp x_{s-1}),
        # c^+ = -1 except m_f at the s = Ls-1 wall (wrap to 0),
        # c^- = -1 except m_f at the s = 0 wall (wrap to Ls-1).
        # Diagonal projectors (chiral basis) -> per-channel weights: one
        # fused elementwise multiply-add over the SoA field.
        lat = rest[1:]
        s_idx = jnp.arange(Ls)
        shape_c = (1, Ls, 1) + (1,) * len(lat)
        cp = jnp.where(s_idx == Ls - 1, op.m_f, -1.0).reshape(shape_c)
        cm = jnp.where(s_idx == 0, op.m_f, -1.0).reshape(shape_c)
        shape_f = (1, 1, rest[0]) + (1,) * len(lat)
        wp = op.pm_diag.reshape(shape_f)       # weights for x_{s+1}
        wm = op.pp_diag.reshape(shape_f)       # weights for x_{s-1}

        def term(a):
            ap = jnp.roll(a, -1, axis=1)
            am = jnp.roll(a, 1, axis=1)
            return (cp * wp) * ap + (cm * wm) * am

        return cplx.CArray(y.re + term(x.re), y.im + term(x.im))

    return bsr_krylov(1.0, op, x, "sxyztSCn")
