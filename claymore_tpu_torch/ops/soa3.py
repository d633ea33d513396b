"""Structure-of-arrays 3x3 math on tensors.

A 3x3 matrix batch is a tuple of nine same-shaped component tensors in
row-major order (m00, m01, m02, m10, ..., m22), as in
``claymore_tpu/ops/soa3.py``.  These are the plain PyTorch forms of the
per-particle math; ``csrc/g2p2g.cu`` carries the same arithmetic per thread.
Only what FixedCorotated needs is here; ``svd3`` comes with Sand/NACC.
"""

from __future__ import annotations

from typing import Tuple

import torch

Mat3 = Tuple[torch.Tensor, ...]  # 9 components, row-major

_EPS = 1e-12


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
