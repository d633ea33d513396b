"""Mesh -> signed-distance-grid generation (.obj -> .sdf).

Port of ``claymore_tpu/io/meshsdf.py``, host numpy as there (a set-up
step, not a kernel): a triangle mesh becomes the ``.sdf`` level set that
``io/sdf.py`` seeds particles from and ``SignedDistanceCollider``
collides against.  Exact point-triangle distances in a band around the
surface, closest-point propagation by 8-direction sweeping for the far
field, and the inside/outside sign from x-ray crossing parity at cell
centres.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront .obj reader: v / f records (polygons fanned into
    triangles, negative indices resolved).  Returns (verts [n,3] f64,
    tris [m,3] i64)."""
    verts, tris = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(tris, np.int64)


def _point_tri_dist_sq(p, a, b, c):
    """Squared distance from points p [n,3] to one triangle (a, b, c)
    (barycentric region clamping)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = ap @ ab
    d2 = ap @ ac
    bp = p - b
    d3 = bp @ ab
    d4 = bp @ ac
    cp = p - c
    d5 = cp @ ab
    d6 = cp @ ac

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = np.maximum(va + vb + vc, 1e-30)
    v = np.clip(vb / denom, 0.0, 1.0)
    w = np.clip(vc / denom, 0.0, 1.0)
    # face region candidate
    q_face = a + ab * v[:, None] + ac * w[:, None]

    # edge/vertex candidates (clamped projections on the three edges)
    def edge(p0, e, t_num, t_den):
        t = np.clip(t_num / np.maximum(t_den, 1e-30), 0.0, 1.0)
        return p0 + e * t[:, None]

    q_ab = edge(a, ab, d1, ab @ ab)
    q_ac = edge(a, ac, d2, ac @ ac)
    bc = c - b
    q_bc = edge(b, bc, np.einsum("nd,d->n", bp, bc), bc @ bc)

    inside = (va >= 0) & (vb >= 0) & (vc >= 0)
    d_face = np.einsum("nd,nd->n", p - q_face, p - q_face)
    d_edges = np.minimum.reduce([
        np.einsum("nd,nd->n", p - q, p - q) for q in (q_ab, q_ac, q_bc)
    ])
    return np.where(inside, np.minimum(d_face, d_edges), d_edges), np.where(
        (inside & (d_face <= d_edges))[:, None], q_face,
        np.stack([q_ab, q_ac, q_bc])[
            np.argmin(np.stack([
                np.einsum("nd,nd->n", p - q, p - q)
                for q in (q_ab, q_ac, q_bc)
            ]), axis=0),
            np.arange(len(p)),
        ],
    )


def mesh_to_sdf(
    verts: np.ndarray,
    tris: np.ndarray,
    dx: float,
    padding: int = 3,
    band: int = 2,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Triangle mesh -> (signed distances [ni,nj,nk], origin [3], dx).

    Grid covers the mesh AABB plus ``padding`` cells.  Exact distances are
    computed within ``band`` cells of each triangle; the far field is
    filled by 8-direction closest-point sweeping; sign comes from x-ray
    crossing parity at cell centers.
    """
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    lo = verts.min(axis=0) - padding * dx
    hi = verts.max(axis=0) + padding * dx
    dims = np.maximum(np.ceil((hi - lo) / dx).astype(np.int64) + 1, 2)
    ni, nj, nk = (int(d) for d in dims)
    origin = lo

    INF = 1e30
    dist = np.full((ni, nj, nk), INF)
    closest = np.zeros((ni, nj, nk, 3))

    # --- exact band distances per triangle (vectorized over its AABB) ---
    for t in range(len(tris)):
        a, b, c = verts[tris[t]]
        tlo = np.minimum(np.minimum(a, b), c)
        thi = np.maximum(np.maximum(a, b), c)
        i0 = np.maximum(((tlo - origin) / dx - band).astype(np.int64), 0)
        i1 = np.minimum(((thi - origin) / dx + band).astype(np.int64) + 1,
                        dims)
        if np.any(i0 >= i1):
            continue
        ii, jj, kk = np.meshgrid(
            np.arange(i0[0], i1[0]), np.arange(i0[1], i1[1]),
            np.arange(i0[2], i1[2]), indexing="ij")
        sub = (ii.ravel(), jj.ravel(), kk.ravel())
        p = origin + np.stack(sub, axis=1) * dx
        d2, q = _point_tri_dist_sq(p, a, b, c)
        d = np.sqrt(d2)
        better = d < dist[sub]
        dist[sub] = np.where(better, d, dist[sub])
        closest[sub] = np.where(better[:, None], q, closest[sub])

    # --- far field: closest-point propagation, 8 sweep directions ---
    cell = np.stack(np.meshgrid(
        np.arange(ni), np.arange(nj), np.arange(nk), indexing="ij"),
        axis=-1) * dx + origin

    def relax_from(si, sj, sk):
        """One pass: pull each cell's candidate closest point from the
        already-swept neighbor along each axis."""
        for axis, s in ((0, si), (1, sj), (2, sk)):
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            if s > 0:
                src[axis] = slice(0, -1)
                dst[axis] = slice(1, None)
            else:
                src[axis] = slice(1, None)
                dst[axis] = slice(0, -1)
            cand = closest[tuple(src)]
            d = np.linalg.norm(cell[tuple(dst)] - cand, axis=-1)
            better = d < dist[tuple(dst)]
            dist[tuple(dst)] = np.where(better, d, dist[tuple(dst)])
            closest[tuple(dst)] = np.where(better[..., None], cand,
                                           closest[tuple(dst)])

    for si in (+1, -1):
        for sj in (+1, -1):
            for sk in (+1, -1):
                relax_from(si, sj, sk)
    # a second round tightens diagonal propagation
    for si in (+1, -1):
        for sj in (+1, -1):
            for sk in (+1, -1):
                relax_from(si, sj, sk)

    # --- sign: x-ray crossing parity at cell centers ---
    cnt = np.zeros((ni + 1, nj, nk), np.int64)
    # irrational ray perturbation: a ray through a triangle EDGE is counted
    # by both adjacent triangles (parity breaks); nudging the ray lattice
    # off any mesh-aligned plane/diagonal makes edge hits measure-zero
    ey = np.arange(nj) * dx + origin[1] + 1e-5 * dx * np.sqrt(2.0)
    ez = np.arange(nk) * dx + origin[2] + 1e-5 * dx * np.sqrt(3.0)
    for t in range(len(tris)):
        a, b, c = verts[tris[t]]
        jlo = int(np.ceil((min(a[1], b[1], c[1]) - origin[1]) / dx))
        jhi = int(np.floor((max(a[1], b[1], c[1]) - origin[1]) / dx))
        klo = int(np.ceil((min(a[2], b[2], c[2]) - origin[2]) / dx))
        khi = int(np.floor((max(a[2], b[2], c[2]) - origin[2]) / dx))
        jlo, jhi = max(jlo, 0), min(jhi, nj - 1)
        klo, khi = max(klo, 0), min(khi, nk - 1)
        if jlo > jhi or klo > khi:
            continue
        yy, zz = np.meshgrid(ey[jlo:jhi + 1], ez[klo:khi + 1], indexing="ij")
        # 2D barycentric of the yz-projection
        d00 = (b[1] - a[1], b[2] - a[2])
        d11 = (c[1] - a[1], c[2] - a[2])
        det = d00[0] * d11[1] - d00[1] * d11[0]
        if abs(det) < 1e-30:
            continue
        py, pz = yy - a[1], zz - a[2]
        u = (py * d11[1] - pz * d11[0]) / det
        v = (pz * d00[0] - py * d00[1]) / det
        hit = (u >= 0) & (v >= 0) & (u + v <= 1)
        if not hit.any():
            continue
        x_int = a[0] + u * (b[0] - a[0]) + v * (c[0] - a[0])
        # first cell center strictly above the crossing
        ii = np.floor((x_int - origin[0]) / dx).astype(np.int64) + 1
        ii = np.clip(ii, 0, ni)
        jj, kk = np.meshgrid(np.arange(jlo, jhi + 1),
                             np.arange(klo, khi + 1), indexing="ij")
        np.add.at(cnt, (ii[hit], jj[hit], kk[hit]), 1)
    parity = np.cumsum(cnt[:ni], axis=0) % 2
    sd = np.where(parity == 1, -dist, dist)
    return sd, origin, dx


def obj_to_sdf_file(obj_path: str, sdf_path: str, dx: float,
                    padding: int = 3) -> None:
    """End to end, .obj -> .sdf."""
    from .sdf import write_sdf_file

    verts, tris = read_obj(obj_path)
    sd, origin, d = mesh_to_sdf(verts, tris, dx, padding)
    write_sdf_file(sdf_path, sd, origin, d)
