"""Structure-of-arrays 3x3 math on tensors.

A 3x3 matrix batch is a tuple of nine same-shaped component tensors in
row-major order (m00, m01, m02, m10, ..., m22), as in
``claymore_tpu/ops/soa3.py``.  These are the plain PyTorch forms of the
per-particle math; ``csrc/g2p2g.cu`` carries the same arithmetic per thread.

``svd3`` is the JAX package's pipeline step for step (cyclic Jacobi on
A^T A, compare-swap sort, Givens QR of A V, sign fix-up), so U and V agree
with it to roundoff wherever the singular vectors are unique; the one
deliberate difference is the Jacobi rotation at an exact diagonal tie
(``_jacobi_cs``).
"""

from __future__ import annotations

from typing import Tuple

import torch

Mat3 = Tuple[torch.Tensor, ...]  # 9 components, row-major

_EPS = 1e-12
_JACOBI_SWEEPS = 4


def identity_like(x: torch.Tensor) -> Mat3:
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    return (one, zero, zero, zero, one, zero, zero, zero, one)


def matmul(a: Mat3, b: Mat3) -> Mat3:
    (a00, a01, a02, a10, a11, a12, a20, a21, a22) = a
    (b00, b01, b02, b10, b11, b12, b20, b21, b22) = b
    return (
        a00 * b00 + a01 * b10 + a02 * b20,
        a00 * b01 + a01 * b11 + a02 * b21,
        a00 * b02 + a01 * b12 + a02 * b22,
        a10 * b00 + a11 * b10 + a12 * b20,
        a10 * b01 + a11 * b11 + a12 * b21,
        a10 * b02 + a11 * b12 + a12 * b22,
        a20 * b00 + a21 * b10 + a22 * b20,
        a20 * b01 + a21 * b11 + a22 * b21,
        a20 * b02 + a21 * b12 + a22 * b22,
    )


def transpose(a: Mat3) -> Mat3:
    (a00, a01, a02, a10, a11, a12, a20, a21, a22) = a
    return (a00, a10, a20, a01, a11, a21, a02, a12, a22)


def matmul_bt(a: Mat3, b: Mat3) -> Mat3:
    """a @ b^T"""
    return matmul(a, transpose(b))


def scale(a: Mat3, s) -> Mat3:
    return tuple(c * s for c in a)


def add_scaled_identity(a: Mat3, s) -> Mat3:
    (a00, a01, a02, a10, a11, a12, a20, a21, a22) = a
    return (a00 + s, a01, a02, a10, a11 + s, a12, a20, a21, a22 + s)


def trace(a: Mat3):
    return a[0] + a[4] + a[8]


def det(a: Mat3):
    (a00, a01, a02, a10, a11, a12, a20, a21, a22) = a
    return (
        a00 * (a11 * a22 - a12 * a21)
        - a01 * (a10 * a22 - a12 * a20)
        + a02 * (a10 * a21 - a11 * a20)
    )


def cofactor(a: Mat3) -> Mat3:
    """Cofactor matrix: a^{-T} = cofactor(a) / det(a)."""
    (a00, a01, a02, a10, a11, a12, a20, a21, a22) = a
    return (
        a11 * a22 - a12 * a21,
        a12 * a20 - a10 * a22,
        a10 * a21 - a11 * a20,
        a02 * a21 - a01 * a22,
        a00 * a22 - a02 * a20,
        a01 * a20 - a00 * a21,
        a01 * a12 - a02 * a11,
        a02 * a10 - a00 * a12,
        a00 * a11 - a01 * a10,
    )


def polar3(a: Mat3, iters: int = 5) -> Mat3:
    """Orthogonal polar factor R of ``a`` by Higham's determinant-scaled
    Newton iteration  X <- (eta X + (1/eta) X^{-T}) / 2,
    eta = |det X|^{-1/3}, with X^{-T} = cofactor(X)/det(X).

    For det(a) < 0 it converges to the det = -1 orthogonal factor (callers
    that need a rotation handle the sign, as FixedCorotated does).  Rows
    whose |det X| falls to the epsilon floor are held unchanged, so
    degenerate particles fail softly instead of exploding through eta."""
    x = a
    for _ in range(iters):
        c = cofactor(x)
        # det via the first-row cofactor expansion (c is already paid for)
        d = x[0] * c[0] + x[1] * c[1] + x[2] * c[2]
        ad = torch.clamp(torch.abs(d), min=_EPS)
        eta = torch.exp(torch.log(ad) * (-1.0 / 3.0))
        ci = torch.sign(d) / (eta * ad)                 # 1/(eta * det), signed
        degen = ad <= 2.0 * _EPS
        half = 0.5
        x = tuple(
            torch.where(degen, xk, half * (eta * xk + ci * ck))
            for xk, ck in zip(x, c)
        )
    return x


def u_diag_vt(u: Mat3, s0, s1, s2, v: Mat3) -> Mat3:
    """u @ diag(s) @ v^T"""
    (u00, u01, u02, u10, u11, u12, u20, u21, u22) = u
    (v00, v01, v02, v10, v11, v12, v20, v21, v22) = v
    return (
        u00 * s0 * v00 + u01 * s1 * v01 + u02 * s2 * v02,
        u00 * s0 * v10 + u01 * s1 * v11 + u02 * s2 * v12,
        u00 * s0 * v20 + u01 * s1 * v21 + u02 * s2 * v22,
        u10 * s0 * v00 + u11 * s1 * v01 + u12 * s2 * v02,
        u10 * s0 * v10 + u11 * s1 * v11 + u12 * s2 * v12,
        u10 * s0 * v20 + u11 * s1 * v21 + u12 * s2 * v22,
        u20 * s0 * v00 + u21 * s1 * v01 + u22 * s2 * v02,
        u20 * s0 * v10 + u21 * s1 * v11 + u22 * s2 * v12,
        u20 * s0 * v20 + u21 * s1 * v21 + u22 * s2 * v22,
    )


# --------------------------------------------------------------------------
# SVD
# --------------------------------------------------------------------------

def _jacobi_cs(app, aqq, apq):
    """Jacobi rotation zeroing apq.  At tau = 0 (app == aqq exactly, a tie
    that F near identity reaches) the rotation is the 45-degree one; the
    JAX package's ``jnp.sign(tau)`` gives no rotation there and leaves the
    pair undiagonalised (its U diag(s) V^T then misses A by up to 1e-1),
    so the port takes the sign as +1 at 0 and differs from it only there."""
    small = torch.abs(apq) < _EPS
    tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
    sign = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sign / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = torch.rsqrt(1.0 + t * t)
    return c, t * c


def _givens_cs(a, b):
    r = torch.sqrt(a * a + b * b)
    good = r > _EPS
    inv = torch.where(good, 1.0 / torch.clamp(r, min=_EPS), 0.0)
    c = torch.where(good, a * inv, 1.0)
    s = torch.where(good, -b * inv, 0.0)
    return c, s


def _rot_cols(v: Mat3, p: int, q: int, c, s) -> Mat3:
    """columns: v[:,p]' = c v[:,p] - s v[:,q]; v[:,q]' = s v[:,p] + c v[:,q]"""
    v = list(v)
    for r in range(3):
        vp, vq = v[3 * r + p], v[3 * r + q]
        v[3 * r + p] = c * vp - s * vq
        v[3 * r + q] = s * vp + c * vq
    return tuple(v)


def _rot_rows(m: Mat3, p: int, q: int, c, s) -> Mat3:
    """rows: m[p]' = c m[p] - s m[q]; m[q]' = s m[p] + c m[q]"""
    m = list(m)
    for col in range(3):
        mp, mq = m[3 * p + col], m[3 * q + col]
        m[3 * p + col] = c * mp - s * mq
        m[3 * q + col] = s * mp + c * mq
    return tuple(m)


def _cswap(e_hi, e_lo, v: Mat3, p: int, q: int):
    """Order two eigenvalues descending, permuting V's columns p and q and
    negating the one moving right so det(V) is kept.  Strict ``>``: ties
    (F = I) do not swap."""
    swap = e_lo > e_hi
    vl = list(v)
    for r in range(3):
        vp, vq = vl[3 * r + p], vl[3 * r + q]
        vl[3 * r + p] = torch.where(swap, vq, vp)
        vl[3 * r + q] = torch.where(swap, -vp, vq)
    return torch.where(swap, e_lo, e_hi), torch.where(swap, e_hi, e_lo), tuple(vl)


def svd3(a: Mat3):
    """Signed SVD: returns (u: Mat3, (s0, s1, s2), v: Mat3); U and V are
    proper rotations and s2 carries sign(det A)."""
    (a00, a01, a02, a10, a11, a12, a20, a21, a22) = a
    b00 = a00 * a00 + a10 * a10 + a20 * a20
    b11 = a01 * a01 + a11 * a11 + a21 * a21
    b22 = a02 * a02 + a12 * a12 + a22 * a22
    b01 = a00 * a01 + a10 * a11 + a20 * a21
    b02 = a00 * a02 + a10 * a12 + a20 * a22
    b12 = a01 * a02 + a11 * a12 + a21 * a22

    v = identity_like(b00)
    for _ in range(_JACOBI_SWEEPS):
        c, s = _jacobi_cs(b00, b11, b01)
        b00, b11 = (
            c * c * b00 - 2 * c * s * b01 + s * s * b11,
            s * s * b00 + 2 * c * s * b01 + c * c * b11,
        )
        b01 = torch.zeros_like(b01)
        b02, b12 = c * b02 - s * b12, s * b02 + c * b12
        v = _rot_cols(v, 0, 1, c, s)
        c, s = _jacobi_cs(b00, b22, b02)
        b00, b22 = (
            c * c * b00 - 2 * c * s * b02 + s * s * b22,
            s * s * b00 + 2 * c * s * b02 + c * c * b22,
        )
        b02 = torch.zeros_like(b02)
        b01, b12 = c * b01 - s * b12, s * b01 + c * b12
        v = _rot_cols(v, 0, 2, c, s)
        c, s = _jacobi_cs(b11, b22, b12)
        b11, b22 = (
            c * c * b11 - 2 * c * s * b12 + s * s * b22,
            s * s * b11 + 2 * c * s * b12 + c * c * b22,
        )
        b12 = torch.zeros_like(b12)
        b01, b02 = c * b01 - s * b02, s * b01 + c * b02
        v = _rot_cols(v, 1, 2, c, s)

    e0, e1, e2 = b00, b11, b22
    e0, e1, v = _cswap(e0, e1, v, 0, 1)
    e0, e2, v = _cswap(e0, e2, v, 0, 2)
    e1, e2, v = _cswap(e1, e2, v, 1, 2)

    # Givens QR of A V: U R = A V with R ~ diag(sigma)
    r = matmul(a, v)
    u = identity_like(b00)          # accumulates G3 G2 G1; U is its transpose
    for (i, j) in ((1, 0), (2, 0), (2, 1)):
        c, s = _givens_cs(r[3 * j + j], r[3 * i + j])
        r = _rot_rows(r, j, i, c, s)
        u = _rot_rows(u, j, i, c, s)
    u = list(transpose(u))
    s0, s1, s2 = r[0], r[4], r[8]

    # push the signs of the two largest sigmas into U's columns, pairwise
    # with the last column so det(U) stays +1
    for k in (0, 1):
        sign = torch.where((s0, s1)[k] < 0, -1.0, 1.0).to(s0.dtype)
        for rr in range(3):
            u[3 * rr + k] = u[3 * rr + k] * sign
            u[3 * rr + 2] = u[3 * rr + 2] * sign
        if k == 0:
            s0, s2 = s0 * sign, s2 * sign
        else:
            s1, s2 = s1 * sign, s2 * sign
    return tuple(u), (s0, s1, s2), v
