"""The port's SoA 3x3 math and FixedCorotated update against the JAX package
(inputs from numpy with a seed; the cases follow tests/test_math3d.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import claymore_tpu as cmt
from claymore_tpu.ops import soa3 as jsoa3
from claymore_tpu_torch.ops import soa3

from tests.torch_port_helpers import configs, fixed_corotated_pair


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
    from claymore_tpu_torch.interop import material_from_jax

    with pytest.raises(NotImplementedError):
        material_from_jax("jfluid", {})
    m = material_from_jax("fixed_corotated", {"e": 7e3, "nu": 0.35, "rho": 900.0,
                                              "volume": 1e-6, "name": "x"})
    jm = cmt.FixedCorotated(e=7e3, nu=0.35, rho=900.0, volume=1e-6)
    assert m.mass == jm.mass and m.lame == jm.lame
