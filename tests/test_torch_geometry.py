"""Geometry of the port vs the JAX reference: quaternions, SE(3), the
closed-form 3×3 SVD and the rigid fits (Kabsch, Horn).

Inputs are numpy-seeded and go through both packages on the CPU. Both run
the same f32 formulas; only the libm and the reduction order differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pre3_tpu.data.synthetic import _rodrigues
from pre3_tpu.geometry import quaternion as jq
from pre3_tpu.geometry import se3 as jse3
from pre3_tpu.ops.svd3 import svd3 as jsvd3, sym3_eigvals as jsym3
from pre3_tpu.vo.rigid import horn_quaternion as jhorn, kabsch as jkabsch
from pre3_tpu_torch.geometry import quaternion as tq
from pre3_tpu_torch.geometry import se3 as tse3
from pre3_tpu_torch.ops.svd3 import svd3 as tsvd3, sym3_eigvals as tsym3
from pre3_tpu_torch.vo.rigid import horn_quaternion as thorn, kabsch as tkabsch

# f32 elementwise formulas with different libm/rounding: a few ulp of O(1)
ATOL = 2e-6


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotations(seed):
    """Random rotations plus the pivots of r2q: near-identity, and ~180°
    turns about x, y and z (w pivot loses to x, y, z)."""
    rng = np.random.default_rng(seed)
    vs = [rng.normal(size=3) for _ in range(16)] + [
        np.array([1e-4, 0, 0]), np.array([3.1, 0.01, 0]),
        np.array([0.01, 3.1, 0]), np.array([0, 0.01, 3.1])]
    return np.stack([_rodrigues(v) for v in vs]).astype(np.float32)


def _cmp(fj, ft, *arrays, atol=ATOL):
    out_j = fj(*(jnp.asarray(a) for a in arrays))
    out_t = ft(*(torch.as_tensor(a) for a in arrays))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=atol)


QUAT_CASES = {
    "qprod": lambda m: (m.qprod, _quats(32, 0), _quats(32, 1)),
    "qconj": lambda m: (m.qconj, _quats(32, 2)),
    "qnormalize": lambda m: (m.qnormalize, _quats(32, 3) * 3.0),
    "q2r": lambda m: (m.q2r, _quats(32, 4)),
    "qrotate": lambda m: (m.qrotate, _quats(32, 5),
                          np.random.default_rng(6).normal(size=(32, 3))
                          .astype(np.float32)),
    "qrotate_one_q_many_v": lambda m: (
        m.qrotate, _quats(1, 12)[0],
        np.random.default_rng(13).normal(size=(32, 3)).astype(np.float32)),
    "r2q": lambda m: (m.r2q, _rotations(7)),
    "v2q": lambda m: (m.v2q, np.concatenate([
        np.random.default_rng(8).normal(size=(16, 3)),
        np.zeros((1, 3)), np.full((1, 3), 1e-7)]).astype(np.float32)),
    "q2v": lambda m: (m.q2v, np.concatenate([
        _quats(16, 9), np.array([[1, 0, 0, 0], [-0.9, 0.1, 0.3, 0.3]])
    ]).astype(np.float32)),
    "e2q": lambda m: (m.e2q, np.random.default_rng(10).uniform(
        -3, 3, (32, 3)).astype(np.float32)),
    "q2e": lambda m: (m.q2e, _quats(32, 11)),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternion_matches_jax(name):
    fj, *arrays = QUAT_CASES[name](jq)
    ft, *_ = QUAT_CASES[name](tq)
    _cmp(fj, ft, *arrays)


def _pose_pair(seed):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(2, 8, 3)).astype(np.float32)
    q = _quats(16, seed + 1).reshape(2, 8, 4)
    return t, q


@pytest.mark.parametrize("op", ["compose", "inverse", "apply", "delta",
                                "to_matrix", "from_matrix", "log"])
def test_se3_matches_jax(op):
    t, q = _pose_pair(20)
    x = np.random.default_rng(21).normal(size=(8, 3)).astype(np.float32)

    def run(m, conv):
        a = m.Pose(t=conv(t[0]), q=conv(q[0]))
        b = m.Pose(t=conv(t[1]), q=conv(q[1]))
        out = {
            "compose": lambda: m.pose_compose(a, b),
            "inverse": lambda: m.pose_inverse(a),
            "apply": lambda: m.pose_apply(a, conv(x)),
            "delta": lambda: m.pose_delta(a, b),
            "to_matrix": lambda: m.pose_to_matrix(a),
            "from_matrix": lambda: m.pose_from_matrix(
                m.pose_to_matrix(a)),
            "log": lambda: m.pose_log(a),
        }[op]()
        return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                        else (out,))]

    for got, ref in zip(run(tse3, torch.as_tensor), run(jse3, jnp.asarray)):
        np.testing.assert_allclose(got, ref, atol=ATOL)


def test_pose_identity():
    p = tse3.pose_identity((2,))
    ref = jse3.pose_identity((2,))
    np.testing.assert_array_equal(p.t.numpy(), np.asarray(ref.t))
    np.testing.assert_array_equal(p.q.numpy(), np.asarray(ref.q))


def _svd_inputs(kind):
    rng = np.random.default_rng({"random": 0, "rank2": 2, "rank1": 3,
                                 "propto_identity": 4, "zero": 5}[kind])
    if kind == "random":
        a = rng.normal(size=(64, 3, 3))
    elif kind == "rank2":
        a = rng.normal(size=(16, 3, 2)) @ rng.normal(size=(16, 2, 3))
    elif kind == "rank1":
        a = rng.normal(size=(16, 3, 1)) @ rng.normal(size=(16, 1, 3))
    elif kind == "propto_identity":
        a = np.stack([np.eye(3) * s for s in (1.0, 3.0, 1e-3)]
                     + [np.diag([2.0, 2.0, 1.0])])
    else:
        a = np.zeros((4, 3, 3))
    return a.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "rank2", "rank1",
                                  "propto_identity", "zero"])
def test_svd3_matches_jax(kind):
    """Same closed form, same branch epsilons. Generic inputs: u, s, vt
    agree elementwise within 2e-5 (eigenvalues come through acos/cos of
    the characteristic cubic, a few ulp of libm, amplified by σ₁/gap).
    Rank-deficient and ∝I inputs: a singular value computed through AᵀA
    carries the f32 floor ~√eps·σ₁ ≈ 2e-2·σ₁ in both packages (the
    reference's documented contract, tests/test_svd3.py), and the
    singular vectors of repeated or null values are arbitrary; there the
    determined part must agree: s within that floor, and the leading
    rank-r part Σ_{i<r} s_i·u_i·v_iᵀ within 1e-3·σ₁ (it absorbs the
    floor error of the null value σ_r through u_r, v_r; seen ≤ 2.5e-4)."""
    a = _svd_inputs(kind)
    uj, sj, vj = (np.asarray(x) for x in jsvd3(jnp.asarray(a)))
    ut, st, vt = (x.numpy() for x in tsvd3(torch.as_tensor(a)))
    sigma1 = np.abs(sj[..., :1]) + 1e-9
    if kind == "random":
        np.testing.assert_allclose(st, sj, atol=2e-5)
        np.testing.assert_allclose(ut, uj, atol=2e-5)
        np.testing.assert_allclose(vt, vj, atol=2e-5)
        eye = np.broadcast_to(np.eye(3), ut.shape)
        np.testing.assert_allclose(ut @ np.swapaxes(ut, -1, -2), eye,
                                   atol=5e-4)
    else:
        assert np.all(np.abs(st - sj) <= 2e-2 * sigma1 + 1e-6)
        rank = {"rank2": 2, "rank1": 1, "propto_identity": 0, "zero": 0}[kind]

        def lead(u, s, v):
            return u[..., :, :rank] @ (s[..., :rank, None] * v[..., :rank, :])

        np.testing.assert_allclose(lead(ut, st, vt) / sigma1[..., None],
                                   lead(uj, sj, vj) / sigma1[..., None],
                                   atol=1e-3)
    # and it reconstructs a (the reference's own check_svd tolerance)
    rec_tol = max(5e-4, 2e-2 * float(np.abs(a).max()))
    assert np.abs(ut @ (st[..., None] * vt) - a).max() <= rec_tol


def test_sym3_eigvals_matches_jax():
    x = np.random.default_rng(6).normal(size=(64, 3, 3)).astype(np.float32)
    a = x @ np.swapaxes(x, -1, -2)
    _cmp(jsym3, tsym3, a, atol=2e-5)


def _rigid_problem(seed, n=30, kind="generic"):
    rng = np.random.default_rng(seed)
    r = _rodrigues(rng.normal(scale=0.3, size=3))
    q = rng.uniform(-1, 1, (4, n, 3))
    if kind == "coplanar":
        q[..., 2] *= 1e-7
    p = q @ r.T + rng.normal(scale=0.1, size=3) + rng.normal(
        scale=0.005, size=q.shape)
    w = (rng.uniform(size=(4, n)) > 0.3).astype(np.float32)
    if kind == "two_points":  # fewer than 3 positive weights: not ok
        w[:] = 0.0
        w[:, :2] = 1.0
    return p.astype(np.float32), q.astype(np.float32), w


@pytest.mark.parametrize("kind", ["generic", "coplanar", "two_points"])
@pytest.mark.parametrize("fit", ["kabsch", "horn_quaternion"])
def test_rigid_fit_matches_jax(fit, kind):
    """Batched weighted fits: R, t within 1e-4 (rotation from an SVD or a
    4×4 eigenvector, conditioned by the point spread), ok and the
    residual identical in meaning. Degenerate sets must be flagged by
    both."""
    fj, ft = {"kabsch": (jkabsch, tkabsch),
              "horn_quaternion": (jhorn, thorn)}[fit]
    p, q, w = _rigid_problem(30, kind=kind)
    ref = fj(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w))
    got = ft(torch.as_tensor(p), torch.as_tensor(q), torch.as_tensor(w))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    ok = np.asarray(ref.ok)
    if kind == "two_points":
        assert not ok.any()
        return
    assert ok.all()
    np.testing.assert_allclose(got.r.numpy(), np.asarray(ref.r), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse),
                               atol=1e-5)


def test_kabsch_unweighted_and_minimal_samples():
    """The RANSAC hypothesis shape: [B, 4, 3] minimal samples of a rigid
    motion with noise, no weights. ok agrees except where σ₂/σ₁ of the
    cross-covariance lies within svd3's f32 floor (2e-2, see
    test_svd3_matches_jax) of cond_eps = 1e-2, where either answer is
    right. R agrees within 1e-4 on well-conditioned samples
    (σ₂/σ₁ > 0.1); nearer degeneracy, f32 round-off moves a 4-point fit
    by up to σ-floor/σ₂ in both packages. t = c_p − R·c_q carries R's
    difference times |c_q| ≤ 3 m, hence 3e-4."""
    rng = np.random.default_rng(40)
    r = _rodrigues(np.array([0.05, -0.02, 0.03]))
    q = np.stack([rng.uniform(-1.5, 1.5, (256, 4)),
                  rng.uniform(-1.0, 1.0, (256, 4)),
                  rng.uniform(1.2, 3.5, (256, 4))], axis=-1)
    p = q @ r.T + 0.02 + rng.normal(scale=0.003, size=q.shape)
    p, q = p.astype(np.float32), q.astype(np.float32)
    ref = jax.jit(jkabsch)(jnp.asarray(p), jnp.asarray(q))
    got = tkabsch(torch.as_tensor(p), torch.as_tensor(q))
    qc = q - q.mean(-2, keepdims=True)
    pc = p - p.mean(-2, keepdims=True)
    sv = np.linalg.svd(np.swapaxes(qc, -1, -2).astype(np.float64) @ pc,
                       compute_uv=False)
    marginal = np.abs(sv[:, 1] / sv[:, 0] - 1e-2) < 2e-2
    ok_j, ok_t = np.asarray(ref.ok), got.ok.numpy()
    assert np.all((ok_j == ok_t) | marginal)
    both = ok_j & ok_t & (sv[:, 1] / sv[:, 0] > 0.1)
    assert both.mean() > 0.5
    np.testing.assert_allclose(got.r.numpy()[both], np.asarray(ref.r)[both],
                               atol=1e-4)
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both],
                               atol=3e-4)
