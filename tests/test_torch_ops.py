"""The port's SoA 3x3 math and FixedCorotated update against the JAX package
(inputs from numpy with a seed; the cases follow tests/test_math3d.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import claymore_tpu as cmt
from claymore_tpu.ops import soa3 as jsoa3
from claymore_tpu_torch.ops import soa3

from tests.torch_port_helpers import configs, fixed_corotated_pair, material_pair


def _both(a):
    """[N, 3, 3] numpy -> (JAX Mat3, torch Mat3)."""
    comps = [np.ascontiguousarray(a[:, i, j]) for i in range(3) for j in range(3)]
    return (tuple(jnp.asarray(c) for c in comps),
            tuple(torch.from_numpy(c) for c in comps))


def _close(tm, jm, rtol, atol):
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _random_f(rng, n, kind):
    if kind == "near_identity":
        return (np.eye(3) + 0.3 * rng.normal(size=(n, 3, 3))).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    p = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    if kind == "ill_conditioned":          # cond ~ 500, det ~ 0.05
        s = np.stack([np.full(n, 5.0), np.full(n, 1.0), np.full(n, 0.01)], axis=1)
    else:                                  # inverted: det < 0
        s = np.stack([np.full(n, 1.2), np.full(n, 0.9), np.full(n, -0.7)], axis=1)
    return np.einsum("nij,nj,nkj->nik", q, s, p).astype(np.float32)


def test_det_cofactor_match_jax():
    rng = np.random.default_rng(0)
    jm, tm = _both(rng.normal(size=(512, 3, 3)).astype(np.float32))
    # elementwise products and sums of the same operands: f32 roundoff
    np.testing.assert_allclose(soa3.det(tm).numpy(), np.asarray(jsoa3.det(jm)),
                               rtol=1e-5, atol=1e-6)
    _close(soa3.cofactor(tm), jsoa3.cofactor(jm), rtol=1e-5, atol=1e-6)
    _close(soa3.matmul_bt(tm, tm), jsoa3.matmul_bt(jm, jm), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["near_identity", "ill_conditioned", "inverted"])
def test_polar3_matches_jax(kind):
    rng = np.random.default_rng(1)
    jm, tm = _both(_random_f(rng, 256, kind))
    r = soa3.polar3(tm)
    # five Newton steps of the same arithmetic; exp/log may differ by an ulp
    # between the two libraries, which the converged iteration damps
    _close(r, jsoa3.polar3(jm), rtol=1e-5, atol=1e-6)
    # and R is orthogonal
    rr = np.stack([c.numpy() for c in soa3.matmul_bt(r, r)], axis=1)
    np.testing.assert_allclose(rr, np.tile(np.eye(3).reshape(1, 9), (256, 1)),
                               atol=1e-4)


def test_polar3_holds_degenerate_rows():
    z = np.zeros((4, 3, 3), np.float32)
    z[1] = np.diag([1.0, 1e-7, 1e-7])      # |det| underflows the epsilon floor
    jm, tm = _both(z)
    r = soa3.polar3(tm)
    _close(r, jsoa3.polar3(jm), rtol=0, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(r, tm))


def test_fixed_corotated_update_matches_jax():
    jcfg, _ = configs(domain_bits=6)
    jmat, mat = fixed_corotated_pair(jcfg, e=5e3, nu=0.4)
    rng = np.random.default_rng(2)
    n = 768
    f = np.concatenate([_random_f(rng, n // 3, k) for k in
                        ("near_identity", "ill_conditioned", "inverted")])
    f9 = np.ascontiguousarray(f.reshape(n, 9).T)
    a = rng.normal(scale=0.05, size=(9, n)).astype(np.float32)
    d_inv, dt = np.float32(jcfg.d_inv), np.float32(2e-4)
    jf, jc = jmat.update(jnp.asarray(d_inv), jnp.asarray(dt),
                         tuple(jnp.asarray(x) for x in a), {"F": jnp.asarray(f9)})
    tf, tc = mat.update(torch.tensor(d_inv), torch.tensor(dt),
                        tuple(torch.from_numpy(x) for x in a),
                        {"F": torch.from_numpy(f9)})
    np.testing.assert_allclose(tf["F"].numpy(), np.asarray(jf["F"]), rtol=1e-5,
                               atol=1e-6)
    # the stress scales like mu * volume ~ 1e-6: tolerance relative to it
    scale = max(float(np.max(np.abs(np.asarray(x)))) for x in jc)
    _close(tc, jc, rtol=1e-5, atol=1e-5 * scale)


def test_material_from_jax_rejects_unported():
    import dataclasses

    from claymore_tpu_torch.interop import material_from_jax

    with pytest.raises(ValueError):
        material_from_jax("plasticine", {})
    m = material_from_jax("fixed_corotated", {"e": 7e3, "nu": 0.35, "rho": 900.0,
                                              "volume": 1e-6, "name": "x"})
    jm = cmt.FixedCorotated(e=7e3, nu=0.35, rho=900.0, volume=1e-6)
    assert m.mass == jm.mass and m.lame == jm.lame
    # every material carries its parameters across
    for jm in (cmt.JFluid(rho=990.0, volume=2e-6, bulk=3e4, gamma=6.0),
               cmt.Sand(e=1e4, nu=0.3, rho=1500.0, volume=1e-6, cohesion=0.01),
               cmt.NACC(e=2e4, nu=0.35, beta=0.4, xi=0.7, volume=1e-6)):
        m = material_from_jax(jm.name, dataclasses.asdict(jm))
        assert type(m).__name__ == type(jm).__name__ and m.mass == jm.mass
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
        if hasattr(jm, "lame"):
            assert m.lame == jm.lame


def _svd_input(kind, n=192):
    rng = np.random.default_rng(5)
    if kind == "repeated":
        # F = I (every Jacobi pair small, every compare-swap a tie), and
        # pairs of equal singular values under a random rotation
        q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
        q *= np.sign(np.linalg.det(q))[:, None, None]
        s = np.tile([2.0, 2.0, 0.5], (n, 1))
        s[: n // 3] = 1.0
        s[n // 3: 2 * n // 3] = [1.5, 0.7, 0.7]
        a = np.einsum("nij,nj,nkj->nik", q, s, q)
        a[: n // 3] = np.eye(3)
        return a.astype(np.float32)
    return _random_f(rng, n, kind)


@pytest.mark.parametrize("kind", ["near_identity", "ill_conditioned", "inverted",
                                  "repeated"])
def test_svd3_matches_jax(kind):
    a = _svd_input(kind)
    jm, tm = _both(a)
    u, s, v = soa3.svd3(tm)
    ju, js, jv = jsoa3.svd3(jm)
    # singular vectors are not unique: compare s and U diag(s) V^T
    for t, j in zip(s, js):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    rec = soa3.u_diag_vt(u, *s, v)
    _close(rec, jsoa3.u_diag_vt(ju, *js, jv), rtol=1e-4, atol=2e-5)
    _close(rec, tuple(a[:, i, j] for i in range(3) for j in range(3)),
           rtol=1e-4, atol=2e-5)
    # U and V are rotations; s2 carries the sign of det A
    for m in (u, v):
        np.testing.assert_allclose(soa3.det(m).numpy(), 1.0, atol=1e-4)
    np.testing.assert_allclose((s[0] * s[1] * s[2]).numpy(), np.linalg.det(a),
                               rtol=1e-3, atol=1e-5)
    if kind == "repeated":
        n3 = a.shape[0] // 3
        assert all(torch.equal(c[:n3], e[:n3]) for c, e in
                   zip(u, soa3.identity_like(s[0])))


def test_svd3_diagonalises_exact_ties():
    """A^T A with b00 == b11 exactly and b01 != 0 (columns of equal norm, as
    F near identity reaches): the JAX package's sign(0) = 0 skips that
    Jacobi rotation and its U diag(s) V^T misses A; the port's rotation at
    tau = 0 is the 45-degree one and reconstructs A to roundoff."""
    rng = np.random.default_rng(6)
    a = (np.eye(3) + rng.normal(scale=0.01, size=(512, 3, 3))).astype(np.float32)
    a[:, :, 1] = a[:, [1, 0, 2], 0]          # column 1 = column 0, permuted
    jm, tm = _both(a)
    flat = tuple(a[:, i, j] for i in range(3) for j in range(3))
    u, s, v = soa3.svd3(tm)
    _close(soa3.u_diag_vt(u, *s, v), flat, rtol=0, atol=2e-6)
    ju, js, jv = jsoa3.svd3(jm)
    jerr = max(float(np.max(np.abs(np.asarray(r) - f)))
               for r, f in zip(jsoa3.u_diag_vt(ju, *js, jv), flat))
    assert jerr > 1e-3


@pytest.mark.parametrize("name", ["jfluid", "sand", "nacc"])
def test_material_update_matches_jax(name):
    jcfg, _ = configs(domain_bits=6)
    jmat, mat = material_pair(jcfg, name)
    rng = np.random.default_rng(3)
    n = 768
    d_inv, dt = np.float32(jcfg.d_inv), np.float32(2e-4)
    # moments large enough to push Sand and NACC onto every branch of their
    # return maps (inside, projected, tip; NACC hardening)
    a = rng.normal(scale=0.1 / (dt * d_inv), size=(9, n)).astype(np.float32)
    a[:, : n // 4] *= 1e-3
    fields = {}
    for key, shape in jmat.field_specs:
        if key == "F":
            f = np.concatenate([_random_f(rng, n // 3, k) for k in
                                ("near_identity", "ill_conditioned", "inverted")])
            fields[key] = np.ascontiguousarray(f.reshape(n, 9).T)
        elif key == "J":
            fields[key] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        else:
            fields[key] = rng.uniform(-0.3, 0.1, n).astype(np.float32)
    jf, jc = jmat.update(jnp.asarray(d_inv), jnp.asarray(dt),
                         tuple(jnp.asarray(x) for x in a),
                         {k: jnp.asarray(v) for k, v in fields.items()})
    tf, tc = mat.update(torch.tensor(d_inv), torch.tensor(dt),
                        tuple(torch.from_numpy(x) for x in a),
                        {k: torch.from_numpy(v) for k, v in fields.items()})
    assert set(tf) == set(jf)
    for k in jf:
        ref = np.asarray(jf[k])
        scale = max(1.0, float(np.max(np.abs(ref))))
        np.testing.assert_allclose(tf[k].numpy(), ref, rtol=1e-5, atol=1e-5 * scale)
    # the stress of the ill-conditioned rows (s_min = 0.01; the Hencky
    # stress goes as log(s)/s) carries the roundoff of the smallest singular
    # value, which the two libraries' last bits move by ~1e-4 of the scale
    scale = max(float(np.max(np.abs(np.asarray(x)))) for x in jc)
    _close(tc, jc, rtol=1e-4, atol=2e-4 * scale)
